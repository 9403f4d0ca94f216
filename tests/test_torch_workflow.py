"""The CPR -> result2ann -> P2P workflow and the offline tile merge in the
port, against the JAX package and the repo's tools/result2ann.py.

- `result_to_annotation` of the port's tools/result2ann.py gives the same
  json and count as the root script on the same det json (with and
  without `--wh`, with points), and its CLI writes the same file;
- tests/test_cpr_workflow.py's stages through the port: point
  annotations to 8x8 pseudo boxes (`noise_kwargs`), CPR's refinement of
  them (a ResNet-18 of base 8 BasicLocator with a 1-conv GN(4) CPRHead,
  JAX's initial weights in both packages, its classifier redrawn so that
  points refine) through each package's `run_refine_test`, the join by
  ann_id, and the refined json loaded as a training set: rows and joined
  boxes within 1e-5 of the largest coordinate, the training samples'
  annotations equal;
- `run_test` of a point detector (the toy P2P of
  tests/test_torch_train_p2p.py) keeps its points, as JAX's does, so that
  the test CLI writes them into the results json;
- `merge_det_result` on a corner set (each tile's `corner` and `ori_id`
  as data/tiling.py writes them) gives JAX's merged json, and
  `CocoFmtDataset.evaluate` with `merge_after_infer_kwargs` JAX's
  metrics.
"""
import copy
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.coco import COCO as JaxCOCO
from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.engine.test import \
    run_refine_test as jax_refine_test
from pointtinybenchmark_tpu.engine.test import run_test as jax_run_test
from pointtinybenchmark_tpu.evaluation.merge import \
    merge_det_result as jax_merge
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.test import (run_refine_test,
                                                      run_test)
from pointtinybenchmark_tpu_torch.evaluation.merge import merge_det_result
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.tools import result2ann
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_cpr import _spread, head_cfg
from test_torch_data import CORNER, write_tinyperson_set
from test_torch_eval import FastJax
from test_torch_slice import _assert_dets_match, _dets
from test_torch_train_p2p import MODEL as P2P_MODEL
from test_torch_train_p2p import TEST_CFG as P2P_TEST_CFG
from test_torch_train_p2p import _spread as p2p_spread
from test_torch_train_p2p import _train_cfg as p2p_train_cfg

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools"))
import result2ann as root_result2ann  # noqa: E402

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
POINT_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", scale_factor=[1.0], keep_ratio=True),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
    dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels",
                               "gt_true_bboxes", "gt_anns_id"]),
]
CPR_MODEL = dict(
    type="BasicLocator",
    backbone=dict(type="ResNet", depth=18, base_channels=8),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=1,
              norm_cfg=dict(type="GN", num_groups=4)),
    bbox_head=dict(head_cfg(), stacked_convs=1, num_classes=1))
PSEUDO_WH = (8, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def point_set(tmp_path_factory):
    """tests/test_cpr_workflow.py's set: 3 images of 64x64, 3 boxes each
    (ids 1-9), each with a point a pixel inside its corner."""
    from PIL import Image
    root = tmp_path_factory.mktemp("workflow")
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(3):
        fn = f"img{i}.jpg"
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            root / fn)
        images.append(dict(id=i + 1, file_name=fn, width=64, height=64))
        for _ in range(3):
            x, y = rng.randint(5, 45), rng.randint(5, 45)
            w, h = rng.randint(6, 14), rng.randint(6, 14)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                             bbox=[float(x), float(y), float(w), float(h)],
                             area=float(w * h), iscrowd=0,
                             point=[x + 1.0, y + 1.0]))
    path = root / "train.json"
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=[dict(id=1, name="person")])))
    return root, path


def _det_json(seed=0, with_point=True):
    rng = np.random.RandomState(seed)
    dets = []
    for ann_id in (1, 2, 4, 5, 9):
        d = dict(image_id=(ann_id - 1) // 3 + 1, category_id=1,
                 bbox=[float(v) for v in np.round(rng.rand(4) * 30 + 2, 3)],
                 score=float(rng.rand()), ann_id=ann_id)
        if with_point:
            d["point"] = [float(v) for v in rng.rand(2) * 60]
        dets.append(d)
    dets.append(dict(image_id=1, category_id=1, bbox=[0, 0, 4, 4],
                     score=0.5))                      # no ann_id: skipped
    return dets


@pytest.mark.parametrize("wh,with_point", [((-1, -1), True),
                                           ((16, 16), True),
                                           ((16, 16), False)])
def test_result_to_annotation_equals_root_script(point_set, wh, with_point):
    _, ann_file = point_set
    dets = _det_json(1, with_point)
    got, n = result2ann.result_to_annotation(str(ann_file),
                                             copy.deepcopy(dets), wh)
    want, n_want = root_result2ann.result_to_annotation(
        str(ann_file), copy.deepcopy(dets), wh)
    assert n == n_want == 5 and got == want
    moved = {a["id"]: a for a in got["annotations"]}
    if wh[0] > 0:
        assert moved[1]["bbox"][2:] == [16, 16] and moved[1]["area"] == 256
    assert ("point" in moved[2]) and (moved[2]["point"] != [
        a for a in json.loads(ann_file.read_text())["annotations"]
        if a["id"] == 2][0]["point"]) == with_point


def test_result2ann_cli_and_image_check(point_set, tmp_path, capsys):
    """The CLI writes what the root script writes and prints the count; a
    detection of another image than its annotation's fails the check."""
    _, ann_file = point_set
    det_file = tmp_path / "dets.json"
    det_file.write_text(json.dumps(_det_json(2)))
    out = tmp_path / "out.json"
    assert result2ann.main(["--ori_ann", str(ann_file), "--det_file",
                            str(det_file), "--save_ann", str(out),
                            "--wh", "16"]) == 5
    assert "updated 5 annotations" in capsys.readouterr().out
    want, _ = root_result2ann.result_to_annotation(str(ann_file),
                                                   str(det_file), (16, 16))
    assert json.loads(out.read_text()) == want
    bad = _det_json(2)
    bad[0]["image_id"] = 3
    with pytest.raises(AssertionError):
        result2ann.result_to_annotation(str(ann_file), bad)


@pytest.fixture(scope="module")
def cpr_pair():
    jm = jax_build(dict(CPR_MODEL))
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables["params"]["bbox_head_m"] = _spread(
        variables["params"]["bbox_head_m"], seed=2)
    model = build_detector(dict(CPR_MODEL), device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jm, variables, model.eval()


def test_cpr_workflow_through_the_port(point_set, cpr_pair, tmp_path):
    """Stage 0 (pseudo boxes), stage 1 (refinement), the join and the
    refined json as a training set, each against the JAX package's."""
    root, ann_file = point_set
    jm, variables, model = cpr_pair
    cfg = dict(type="CocoFmtDataset", ann_file=str(ann_file),
               img_prefix=str(root), pipeline=POINT_PIPELINE,
               noise_kwargs=dict(pseudo_wh=PSEUDO_WH, noise_rg=0.25),
               test_mode=True)
    jds = jax_build_dataset(copy.deepcopy(cfg))
    ds = build_dataset(cfg)
    sample = ds[0]
    np.testing.assert_array_equal(sample["gt_bboxes"], jds[0]["gt_bboxes"])
    np.testing.assert_allclose(
        sample["gt_bboxes"][:, 2:] - sample["gt_bboxes"][:, :2], 8.0,
        atol=1e-4)

    want = jax_refine_test(jm, variables, jds,
                           JaxCollator(pad_shape=(64, 64), max_gt=10),
                           pseudo_wh=PSEUDO_WH)
    got = run_refine_test(model, ds, DetCollator(pad_shape=(64, 64),
                                                 max_gt=10),
                          pseudo_wh=PSEUDO_WH)
    assert len(got) == len(want) == 3
    moved = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["anns_id"], w["anns_id"])
        for k in ("bboxes", "points"):
            np.testing.assert_allclose(g[k], w[k],
                                       atol=1e-5 * np.abs(w[k]).max())
        moved += int((np.abs(g["points"][:, :2] - (
            g["bboxes"][:, :2] + 4)) > 1e-3).any(1).sum())
    det_json = ds.format_results(got)
    assert all("ann_id" in d and "point" in d for d in det_json)

    joined, n = result2ann.result_to_annotation(str(ann_file), det_json,
                                                (16, 16))
    jjoined, jn = root_result2ann.result_to_annotation(
        str(ann_file), jds.format_results(want), (16, 16))
    assert n == jn == 9
    for a, b in zip(joined["annotations"], jjoined["annotations"]):
        assert a["id"] == b["id"] and a["bbox"][2:] == [16, 16]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-4)
        np.testing.assert_allclose(a["point"], b["point"], atol=1e-4)

    refined = tmp_path / "refined.json"
    refined.write_text(json.dumps(joined))
    train_cfg = dict(type="CocoFmtDataset", ann_file=str(refined),
                     img_prefix=str(root), pipeline=POINT_PIPELINE[:2] + [
                         dict(type="Collect", keys=["img", "gt_bboxes",
                                                    "gt_labels"])])
    ds2 = build_dataset(train_cfg)
    jds2 = jax_build_dataset(copy.deepcopy(train_cfg))
    assert len(ds2) == len(jds2) == 3
    for i in range(3):
        np.testing.assert_array_equal(ds2[i]["gt_bboxes"],
                                      jds2[i]["gt_bboxes"])
        np.testing.assert_allclose(
            ds2[i]["gt_bboxes"][:, 2:] - ds2[i]["gt_bboxes"][:, :2], 16.0,
            atol=1e-4)


@pytest.fixture(scope="module")
def corner_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("merge")
    path = write_tinyperson_set(root, "test", 2, (128, 192), 7)
    cfg = dict(type="CocoFmtDataset", ann_file=str(path),
               img_prefix=str(root / "test"), test_mode=True,
               pipeline=[dict(type="LoadImageFromFile")],
               corner_kwargs=dict(CORNER))
    rng = np.random.RandomState(8)
    ds = build_dataset(copy.deepcopy(cfg))
    results = []
    for i in range(len(ds)):
        # each tile's gts, jittered, and as many random boxes
        gt = ds.get_ann_info(i)["bboxes"]
        xy = rng.rand(len(gt) + 2, 2) * [80, 50]
        noise = np.concatenate([xy, xy + rng.rand(len(gt) + 2, 2) * 14 + 2])
        box = np.concatenate([gt + rng.randn(*gt.shape) * 0.5,
                              noise.reshape(2, -1, 2).transpose(1, 0, 2)
                              .reshape(-1, 4)])
        box = np.concatenate([box, rng.rand(len(box), 1)], 1)
        results.append(dict(bboxes=box.astype(np.float32),
                            labels=np.zeros(len(box), np.int64)))
    return cfg, path, results


def test_merge_det_result_equals_jax(corner_set):
    cfg, path, results = corner_set
    ds = build_dataset(copy.deepcopy(cfg))
    det_json = ds.format_results(results)
    assert all("corner" in ds.coco.imgs[i] and "ori_id" in ds.coco.imgs[i]
               for i in ds.img_ids)
    got, gt = merge_det_result(copy.deepcopy(det_json), ds.coco, str(path),
                               nms_th=0.5)
    want, jgt = jax_merge(copy.deepcopy(det_json),
                          JaxCOCO(ds.ann_file), str(path), nms_th=0.5)
    assert got == want
    assert sorted(gt.imgs) == sorted(jgt.imgs) == [1, 2]
    assert {d["image_id"] for d in got} == {1, 2}
    assert len(det_json) > len(got) > 0


def test_evaluate_with_merge_after_infer_equals_jax(corner_set):
    cfg, path, results = corner_set
    cfg = dict(cfg, merge_after_infer_kwargs=dict(merge_gt_file=str(path),
                                                  merge_nms_th=0.5))
    ds = build_dataset(copy.deepcopy(cfg))
    jds = jax_build_dataset(copy.deepcopy(cfg))
    got = ds.evaluate(results, metric="bbox")
    want = jds.evaluate(results, metric="bbox")
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert got["AP50_all"] > 0.2


def test_run_test_keeps_a_point_detectors_points(tmp_path, monkeypatch):
    """P2P's simple_test gives (detections, points): run_test keeps the
    points as JAX's run_test does (they were once taken for mask crops),
    and format_results writes each detection's point."""
    jm = jax_build(dict(P2P_MODEL), p2p_train_cfg(), dict(P2P_TEST_CFG))
    variables = p2p_spread(jax.tree_util.tree_map(np.array, jax.jit(
        lambda r, x: jm.init(r, x))(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3), jnp.float32))))
    model = build_detector(dict(P2P_MODEL), p2p_train_cfg(),
                           dict(P2P_TEST_CFG), device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    ann = write_tinyperson_set(tmp_path, "test", 2, (128, 160), 3)
    cfg = dict(type="CocoFmtDataset", ann_file=str(ann),
               img_prefix=str(tmp_path / "test"), test_mode=True,
               pipeline=[dict(type="LoadImageFromFile"),
                         dict(type="MultiScaleFlipAug", scale_factor=[1.0],
                              flip=False, transforms=[
                                  dict(type="Resize", keep_ratio=True),
                                  dict(type="RandomFlip"),
                                  dict(type="Normalize", **NORM),
                                  dict(type="Pad", size_divisor=32),
                                  dict(type="Collect", keys=["img"])])])
    jds = jax_build_dataset(copy.deepcopy(cfg))
    ds = build_dataset(cfg)
    import pointtinybenchmark_tpu.engine.test as jtest
    monkeypatch.setattr(jtest, "jax", FastJax())
    want = jax_run_test(jm, variables, jds, JaxCollator(size_divisor=32))
    got = run_test(model.eval(), ds, DetCollator(size_divisor=32))
    for w, g in zip(want, got):
        assert set(g) == set(w) == {"bboxes", "labels", "points"}
        assert len(w["points"]) > 0
        _assert_dets_match(_dets(w), _dets(g))
        assert g["points"].shape == w["points"].shape
        centres = (g["bboxes"][:, :2] + g["bboxes"][:, 2:4]) / 2
        np.testing.assert_allclose(g["points"][:, :2], centres, atol=1e-4)
    rows = ds.format_results(got)
    assert rows and all(len(r["point"]) == 2 for r in rows)

"""VOC and proposal evaluation, the VOC datasets, the dataset wrappers and
the standalone RPN in the port, against the JAX package.

- `eval_map` in its 'area' and VOC07 '11points' modes, with area ranges
  and ignored boxes, and `eval_recalls`, on seeded detections: equal to
  JAX's;
- `VOCDataset` and `WIDERFaceDataset` on the same synthetic XML set
  (`difficult` objects, a box under `min_size`, portrait and landscape
  images): infos, annotations, `flag`, pipeline samples and `evaluate`
  (mAP in both modes, recall) equal to JAX's; a list `ann_file` (VOC
  07+12's form) is refused by both;
- ConcatDataset, RepeatDataset and ClassBalancedDataset: lengths, the
  samples behind each index, repeat factors and `flag`, and the
  aspect-grouped batch order the DataLoader draws from that flag;
- the standalone RPN (ResNet-50 of base 8, FPN 16) on the same weights:
  its proposals through `run_test` at tests/test_detector_golden.py:88's
  tolerances, and `proposal_fast` of both packages on them. JAX compiles
  without XLA's backend optimisations; torch runs on one thread.
"""
import copy
import importlib
import os.path as osp
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.data.loader import GroupSampler as JaxGroup
from pointtinybenchmark_tpu.evaluation.mean_ap import eval_map as jax_map
from pointtinybenchmark_tpu.evaluation.recall import \
    eval_recalls as jax_recalls
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data.loader import DetCollator, GroupSampler
from pointtinybenchmark_tpu_torch.engine.test import run_test
from pointtinybenchmark_tpu_torch.evaluation.mean_ap import eval_map
from pointtinybenchmark_tpu_torch.evaluation.recall import eval_recalls
from pointtinybenchmark_tpu_torch.models import build_detector
from test_torch_data import assert_same, write_tinyperson_set
from test_torch_eval import FastJax
from test_torch_slice import FRCNN_MODEL, _assert_dets_match, _dets

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools",
                            "model_converters"))
from torch2jax import convert_detector_state_dict  # noqa: E402

jtest = importlib.import_module("pointtinybenchmark_tpu.engine.test")

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
VOC_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=(150, 100), keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
    dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels"]),
]
NAMES = ("person", "car", "dog")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_voc(root, year, n, seed, names=NAMES, min_side=4):
    """root/VOC{year}/ with JPEGImages, Annotations and
    ImageSets/Main/test.txt: `n` images, portrait and landscape, 2-6
    objects each, ~25% `difficult`, one box `min_side` px wide (min_side
    + 1 as the dataset reads it: xmin and ymin are 1-based)."""
    rng = np.random.RandomState(seed)
    base = root / f"VOC{year}"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True, exist_ok=True)
    ids = []
    for i in range(n):
        img_id = f"{year}_{i:06d}"
        h, w = (96, 128) if i % 3 else (128, 96)
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            base / "JPEGImages" / f"{img_id}.jpg")
        objs = []
        for k in range(rng.randint(2, 7)):
            x1, y1 = rng.randint(1, w - 30), rng.randint(1, h - 30)
            bw = min_side if k == 0 else rng.randint(8, 28)
            objs.append(
                f"<object><name>{names[rng.randint(len(names))]}</name>"
                f"<difficult>{int(rng.rand() < 0.25)}</difficult><bndbox>"
                f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x1 + bw}</xmax>"
                f"<ymax>{y1 + rng.randint(8, 28)}</ymax></bndbox></object>")
        (base / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height>"
            f"<depth>3</depth></size>{''.join(objs)}</annotation>")
        ids.append(img_id)
    (base / "ImageSets/Main/test.txt").write_text("\n".join(ids) + "\n")
    return base


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    return dict(root=root, voc07=write_voc(root, 2007, 5, 0),
                voc12=write_voc(root, 2012, 4, 1),
                wider=write_voc(root, "WIDER", 3, 2, names=("face",)))


def voc_cfg(base, kind="VOCDataset", **kw):
    return dict(type=kind, ann_file=str(base / "ImageSets/Main/test.txt"),
                img_prefix=str(base) + "/", pipeline=VOC_PIPELINE, **kw)


def both(cfg):
    return jax_build_dataset(copy.deepcopy(cfg)), build_dataset(
        copy.deepcopy(cfg))


def _dets_for(ds, seed, n_classes):
    """Per image: its gts jittered with scores, plus random boxes."""
    rng = np.random.RandomState(seed)
    results = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        gt = np.vstack([ann["bboxes"], ann["bboxes_ignore"]])
        lab = np.concatenate([ann["labels"], np.zeros(len(
            ann["bboxes_ignore"]), np.int64)])
        rand = np.hstack([rng.rand(4, 2) * 60, 60 + rng.rand(4, 2) * 30])
        boxes = np.vstack([gt + rng.randn(*gt.shape), rand])
        results.append(dict(
            bboxes=np.hstack([boxes, rng.rand(len(boxes), 1)]).astype(
                np.float32),
            labels=np.concatenate([lab, rng.randint(0, n_classes, 4)])))
    return results


def _map_inputs(seed):
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(6):
        g = rng.randint(0, 6)
        xy = rng.rand(g, 2) * 80
        gt = np.hstack([xy, xy + 4 + rng.rand(g, 2) * 60]).astype(np.float32)
        labels = rng.randint(0, 3, g)
        ign = np.hstack([xy[:1], xy[:1] + 30]).astype(np.float32)
        anns.append(dict(bboxes=gt, labels=labels, bboxes_ignore=ign,
                         labels_ignore=np.zeros(len(ign), np.int64)))
        per = []
        for c in range(3):
            own = gt[labels == c] + rng.randn((labels == c).sum(), 4) * 3
            xy2 = rng.rand(3, 2) * 80
            rand = np.hstack([xy2, xy2 + 4 + rng.rand(3, 2) * 60])
            b = np.vstack([own, rand])
            per.append(np.hstack([b, rng.rand(len(b), 1)]).astype(np.float32))
        dets.append(per)
    return dets, anns


@pytest.mark.parametrize("dataset", [None, "voc07"])
@pytest.mark.parametrize("scale_ranges", [None, [(0, 32), (32, 1e5)]])
def test_eval_map_equals_jax(dataset, scale_ranges):
    dets, anns = _map_inputs(3)
    got_map, got = eval_map(dets, anns, scale_ranges, 0.5, dataset)
    want_map, want = jax_map(dets, anns, scale_ranges, 0.5, dataset)
    assert_same(np.asarray(got_map), np.asarray(want_map))
    assert 0 < np.min(got_map) < 1
    for g, w in zip(got, want):
        assert_same(g, w)


def test_eval_recalls_equals_jax():
    rng = np.random.RandomState(4)
    gts, props = [], []
    for _ in range(4):
        g = rng.rand(rng.randint(0, 5), 2) * 80
        gts.append(np.hstack([g, g + 10 + rng.rand(len(g), 2) * 30]))
        p = rng.rand(300, 2) * 80
        props.append(np.hstack([p, p + 10 + rng.rand(300, 2) * 30,
                                rng.rand(300, 1)]))
    args = ([1, 10, 100, 300], np.arange(0.5, 0.96, 0.05))
    got = eval_recalls(gts, props, *args)
    assert_same(got, jax_recalls(gts, props, *args))
    assert 0 < got.max() and got[0, 0] < got[-1, 0]


@pytest.mark.parametrize("which", ["voc07", "voc12", "wider"])
def test_voc_datasets_equal_jax(voc, which):
    kind = "WIDERFaceDataset" if which == "wider" else "VOCDataset"
    jds, ds = both(voc_cfg(voc[which], kind, min_size=6))
    assert ds.classes == jds.classes
    assert ds.data_infos == jds.data_infos
    assert_same(ds.flag, jds.flag)
    assert set(ds.flag.tolist()) == {0, 1}
    ignored = 0
    for i in range(len(ds)):
        a = ds.get_ann_info(i)
        assert_same(a, jds.get_ann_info(i), f"ann {i}")
        ignored += len(a["bboxes_ignore"])
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            assert_same(ds[i], jds[i], f"sample {i}")
    assert ignored >= len(ds)          # the narrow box of each image at least
    results = _dets_for(ds, 5, len(ds.classes))
    for metric in ("mAP", "recall"):
        got = ds.evaluate(results, metric=metric)
        assert got == jds.evaluate(results, metric=metric)
    assert 0 < got[f"recall@{100}"] <= 1
    got = ds.evaluate(results)
    assert got == jds.evaluate(results) and 0 < got["mAP"] < 1


def test_voc_list_ann_file_refused_as_in_jax(voc):
    cfg = voc_cfg(voc["voc07"])
    cfg["ann_file"] = [cfg["ann_file"], cfg["ann_file"]]
    with pytest.raises(TypeError):
        jax_build_dataset(copy.deepcopy(cfg))
    with pytest.raises(TypeError, match="cannot load a list either"):
        build_dataset(cfg)


@pytest.mark.parametrize("wrapper", ["concat", "repeat", "class_balanced"])
def test_dataset_wrappers_equal_jax(voc, wrapper):
    a, b = voc_cfg(voc["voc07"]), voc_cfg(voc["voc12"])
    cfg = {"concat": [a, b],
           "repeat": dict(type="RepeatDataset", times=3, dataset=a),
           "class_balanced": dict(type="ClassBalancedDataset",
                                  oversample_thr=0.6, dataset=a)}[wrapper]
    jds, ds = both(cfg)
    assert len(ds) == len(jds) > 5
    assert_same(ds.flag, jds.flag)
    if wrapper == "class_balanced":
        assert ds.repeat_indices == jds.repeat_indices
        assert len(ds) > len(ds.dataset)
    for i in range(len(ds)):
        assert_same(ds[i], jds[i], f"sample {i}")
    ds.set_epoch(1)
    jds.set_epoch(1)
    assert_same(ds[len(ds) - 1], jds[len(jds) - 1])
    for epoch in range(3):
        want = JaxGroup(jds.flag, 2, True, seed=7).indices(epoch)
        got = GroupSampler(ds.flag, 2, True, seed=7).indices(epoch)
        assert_same(got, want)
        pairs = got.reshape(-1, 2)
        assert (ds.flag[pairs[:, 0]] == ds.flag[pairs[:, 1]]).all()


RPN_TEXT = FRCNN_MODEL[:FRCNN_MODEL.index("    roi_head=dict(")].replace(
    'type="FasterRCNN"', 'type="RPN"') + ")\n"
RPN_TEST = dict(rpn=dict(nms_pre=1000, max_per_img=100,
                         nms=dict(type="nms", iou_threshold=0.7),
                         min_bbox_size=0))


@pytest.fixture(scope="module")
def rpn_pair():
    ns = {}
    exec(RPN_TEXT, ns)
    model = build_detector(dict(ns["model"]), None, RPN_TEST, device="cpu",
                           seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        w = model.rpn_head.rpn_cls.weight
        w.copy_(torch.from_numpy((rng.randn(*w.shape) * 0.3).astype(
            np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=50)
    assert not unmapped, unmapped
    jm = jax_build(dict(ns["model"]), None, RPN_TEST)
    return model.eval(), jm, dict(params=params, batch_stats=stats)


def test_rpn_proposals_and_proposal_fast_match_jax(rpn_pair, tmp_path,
                                                   monkeypatch):
    """run_test of both RPNs on two synthetic COCO-format frames (NoAug,
    native size): labels 0, the proposals at the golden tolerances; then
    each dataset's proposal_fast on its own package's proposals."""
    model, jm, variables = rpn_pair
    ann = write_tinyperson_set(tmp_path, "test", 2, (128, 192), 9,
                               persons=(10, 20))
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="NoAug", transforms=[
                    dict(type="Resize", keep_ratio=True),
                    dict(type="Normalize", **NORM),
                    dict(type="Pad", size_divisor=32),
                    dict(type="Collect", keys=["img"])])]
    cfg = dict(type="CocoFmtDataset", ann_file=str(ann),
               img_prefix=str(tmp_path / "test"), test_mode=True,
               pipeline=pipeline)
    jds, ds = both(cfg)
    monkeypatch.setattr(jtest, "jax", FastJax())
    want = jtest.run_test(jm, variables, jds, JaxCollator(pad_shape=(128,
                                                                     192)))
    got = run_test(model, ds, DetCollator(pad_shape=(128, 192)))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert len(w["bboxes"]) == 100 and not g["labels"].any()
        _assert_dets_match(_dets(w), _dets(g))
    kw = dict(metric="proposal_fast", proposal_nums=(10, 100))
    got_ar = ds.evaluate(got, **kw)
    want_ar = jds.evaluate(want, **kw)
    assert list(got_ar) == list(want_ar) == ["AR@10", "AR@100"]
    np.testing.assert_allclose(list(got_ar.values()),
                               list(want_ar.values()), atol=1e-6)
    assert ds.evaluate(want, **kw) == want_ar
    assert got_ar["AR@10"] <= got_ar["AR@100"] and got_ar["AR@100"] > 0

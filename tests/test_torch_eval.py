"""The port's evaluation and tiled test loop against the JAX package's.

- COCOExpandEval on a seeded scene (two classes, 2-60 px gts tagged
  ignore, uncertain or iscrowd, jittered and random detections): the
  stats equal JAX's (the same floats in the same key order) in the `tiny`
  standard with the TinyPerson options (ignore_uncertain, use_ignore_attr,
  IoD for ignore regions with a non-identity iod_th_of_iou_f) and in the
  `coco` standard, plain and class-agnostic; the per-class summary too;
  each with the native loop and with the Python reference loops;
- segm: polygon gts against RLE results, native and Python, equal to JAX;
- CocoFmtDataset.evaluate with the TinyPerson config's evaluation
  arguments, bbox and proposal metrics, equal to JAX's;
- `run_tiled_test` of a toy Faster R-CNN (ResNet-18 of base 8, FPN 16,
  2 FCs of 32; JAX's init carried across by `load_jax_variables`, the
  classifiers redrawn on both sides to spread the scores, as in
  tests/test_torch_slice.py) on CroppedTilesFlipAug samples: the merged
  detections match JAX's `run_tiled_test` within tests/
  test_detector_golden.py:88's tolerances, and the metrics within 1e-6;
  so do the port's `DeviceTiledInference` on the decoded frames, and
  `run_test` on NoAug samples against JAX's `run_test`.

JAX's forward is compiled without XLA's backend optimisations.
"""
import copy
import json

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

import pointtinybenchmark_tpu.engine.test as jtest
from pointtinybenchmark_tpu.data import DetCollator as JaxCollator
from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.coco import COCO as JaxCOCO
from pointtinybenchmark_tpu.evaluation.cocoeval import \
    COCOExpandEval as JaxEval
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data.coco import COCO
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.test import (DeviceTiledInference,
                                                      run_test,
                                                      run_tiled_test)
from pointtinybenchmark_tpu_torch.evaluation.cocoeval import COCOExpandEval
from pointtinybenchmark_tpu_torch.evaluation.mask_utils import rle_encode
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_data import TILED_TEST_PIPELINE, write_tinyperson_set
from test_torch_slice import FRCNN_MODEL, _assert_dets_match, _dets

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TINY = dict(ignore_uncertain=True, use_ignore_attr=True,
            use_iod_for_ignore=True, iod_th_of_iou_f="lambda iou: iou * 0.8",
            cocofmt_param=dict(evaluate_standard="tiny", maxDets=[1000]))
TINYPERSON_EVAL = dict(
    metric="bbox", iou_thrs=[0.25, 0.5, 0.75], proposal_nums=[1000],
    cocofmt_kwargs=dict(ignore_uncertain=True, use_ignore_attr=True,
                        use_iod_for_ignore=True,
                        iod_th_of_iou_f="lambda iou: iou",
                        cocofmt_param=dict(evaluate_standard="tiny")))
H, W = 120, 160


def scene(seed=0, n_img=3):
    """(gt json, det json) of a seeded scene; gts of both classes with
    polygon segmentations, dets jittered from them or drawn at random,
    with RLE masks of their boxes."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for i in range(1, n_img + 1):
        images.append(dict(id=i, file_name=f"{i}.jpg", width=W, height=H))
        for _ in range(rng.randint(8, 20)):
            s = float(np.exp(rng.uniform(np.log(2), np.log(60))))
            w, h = s * rng.uniform(0.6, 1.4), s * rng.uniform(0.6, 1.4)
            x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
            ann = dict(id=len(anns) + 1, image_id=i,
                       category_id=int(rng.randint(1, 3)),
                       bbox=[x, y, w, h], area=w * h, iscrowd=0,
                       segmentation=[[x, y, x + w, y, x + w, y + h, x,
                                      y + h]])
            kind = rng.rand()
            if kind < 0.15:
                ann["ignore"] = 1
            elif kind < 0.25:
                ann["uncertain"] = 1
            elif kind < 0.32:
                ann["iscrowd"] = 1
            anns.append(ann)
            if rng.rand() < 0.75:
                j = rng.randn(4) * 0.15 * s
                dets.append((i, ann["category_id"],
                             [x + j[0], y + j[1], max(w + j[2], 1.0),
                              max(h + j[3], 1.0)]))
        for _ in range(rng.randint(3, 10)):
            w, h = rng.uniform(2, 40, 2)
            dets.append((i, int(rng.randint(1, 3)),
                         [rng.uniform(0, W - w), rng.uniform(0, H - h), w,
                          h]))
    det_json = []
    for img_id, cat, b in dets:
        m = np.zeros((H, W), np.uint8)
        m[int(b[1]):int(np.ceil(b[1] + b[3])),
          int(b[0]):int(np.ceil(b[0] + b[2]))] = 1
        det_json.append(dict(image_id=img_id, category_id=cat,
                             bbox=[float(v) for v in b],
                             score=float(rng.rand()),
                             segmentation=rle_encode(m)))
    gt = dict(images=images, annotations=anns,
              categories=[dict(id=1, name="person"),
                          dict(id=2, name="crowd")])
    return gt, det_json


def run_eval(coco_cls, eval_cls, gt, dets, iou_type, use_cats, kwargs,
             **extra):
    gt_coco = coco_cls(copy.deepcopy(gt))
    if iou_type == "bbox":
        dets = [{k: v for k, v in d.items() if k != "segmentation"}
                for d in dets]
    ev = eval_cls(gt_coco, gt_coco.loadRes(copy.deepcopy(dets)), iou_type,
                  **copy.deepcopy(kwargs), **extra)
    ev.params.useCats = use_cats
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize()
    names = ["person", "crowd"]
    return stats, (ev.classwise_summary(names) if use_cats else None)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", ["tiny", "coco", "coco_agnostic", "segm"])
def test_cocoeval_equals_jax(case, native):
    gt, dets = scene()
    iou_type = "segm" if case == "segm" else "bbox"
    kwargs = (TINY if case == "tiny"
              else dict(cocofmt_param=dict(evaluate_standard="coco")))
    use_cats = int(case != "coco_agnostic")
    want = run_eval(JaxCOCO, JaxEval, gt, dets, iou_type, use_cats, kwargs)
    got = run_eval(COCO, COCOExpandEval, gt, dets, iou_type, use_cats,
                   kwargs, native=native)
    assert list(got[0].items()) == list(want[0].items())
    assert got[1] == want[1]
    assert 0 < got[0]["mAP_all"] < 1


def test_dataset_evaluate_equals_jax(tmp_path):
    path = write_tinyperson_set(tmp_path, "test", 3, (128, 192), 2)
    gt = json.loads(path.read_text())
    rng = np.random.RandomState(3)
    results = []
    for img in gt["images"]:
        boxes = [a["bbox"] for a in gt["annotations"]
                 if a["image_id"] == img["id"]]
        b = np.asarray(boxes, np.float32)
        b = b + rng.randn(*b.shape).astype(np.float32)
        b[:, 2:] = np.maximum(b[:, 2:], 1) + b[:, :2]
        results.append(dict(
            bboxes=np.hstack([b, rng.rand(len(b), 1)]).astype(np.float32),
            labels=np.zeros(len(b), np.int64)))
    cfg = dict(type="CocoFmtDataset", ann_file=str(path), test_mode=True,
               pipeline=[])
    for metric in ("bbox", ["bbox", "proposal"]):
        kw = dict(TINYPERSON_EVAL, metric=metric)
        want = jax_build_dataset(copy.deepcopy(cfg)).evaluate(
            results, **copy.deepcopy(kw))
        got = build_dataset(cfg).evaluate(results, **kw)
        assert list(got.items()) == list(want.items())
    assert got["bbox_AP50_tiny"] > 0.5


class FastJax:
    """`jax` for the JAX engine's module: jit compiles without XLA's
    backend optimisations."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        compiled = {}

        def call(*args):
            key = tuple((a.shape, str(a.dtype)) for a in args)
            if key not in compiled:
                compiled[key] = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
            return compiled[key](*args)

        return call


def toy_frcnn_text(ann_file, img_prefix):
    model = FRCNN_MODEL.replace(
        'depth=50, base_channels=8', 'depth=18, base_channels=8').replace(
        'in_channels=[32, 64, 128, 256]', 'in_channels=[8, 16, 32, 64]')
    model = model.replace("num_classes=2", "num_classes=1")
    return (f"img_norm = dict(mean=[123.675, 116.28, 103.53], "
            f"std=[58.395, 57.12, 57.375])\n"
            f"test_pipeline = {TILED_TEST_PIPELINE!r}\n"
            f"data = dict(test=dict(type='CocoFmtDataset', "
            f"ann_file=r'{ann_file}', img_prefix=r'{img_prefix}', "
            f"pipeline=test_pipeline))\n"
            f"loader = dict(pad_shape=(64, 96))\n" + model)


@pytest.fixture(scope="module")
def frcnn(tmp_path_factory):
    """The toy Faster R-CNN in both packages on the same weights, and a
    synthetic set of two 128x192 frames."""
    root = tmp_path_factory.mktemp("frcnn")
    path = write_tinyperson_set(root, "test", 2, (128, 192), 4)
    cfg_path = root / "cfg.py"
    cfg_path.write_text(toy_frcnn_text(path, root / "test"))
    cfg = JaxConfig.fromfile(str(cfg_path))
    jm = jax_build(dict(cfg.model), None, cfg.test_cfg)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32))
    init = jax.jit(lambda r, x: jm.init(r, x, train=False)).lower(
        *args).compile(FAST_COMPILE)
    variables = jax.tree_util.tree_map(np.array, init(*args))
    rng = np.random.RandomState(0)
    for scope, name in ((("rpn_head_m",), "rpn_cls"),
                        (("roi_head_m", "bbox_head_m"), "fc_cls")):
        tree = variables["params"]
        for key in scope:
            tree = tree[key]
        tree[name]["kernel"] = (rng.randn(*tree[name]["kernel"].shape)
                                * 0.3).astype(np.float32)
        tree[name]["bias"] = np.zeros_like(tree[name]["bias"])
    model = build_detector(dict(cfg.model), None, dict(cfg.test_cfg),
                           device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    model.eval()
    return dict(root=root, test=str(path), cfg=cfg, jm=jm,
                variables=variables, model=model)


def both_datasets(frcnn, pipeline, name="test"):
    cfg = dict(type="CocoFmtDataset", ann_file=frcnn[name],
               img_prefix=str(frcnn["root"] / name), test_mode=True,
               pipeline=pipeline)
    return jax_build_dataset(copy.deepcopy(cfg)), build_dataset(cfg)


def assert_results_match(want, got, jds, ds):
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert 0 < len(w["bboxes"]) < 1000
        _assert_dets_match(_dets(w), _dets(g))
    want_m = jds.evaluate(want, **copy.deepcopy(TINYPERSON_EVAL))
    got_m = ds.evaluate(got, **TINYPERSON_EVAL)
    assert list(got_m) == list(want_m)
    np.testing.assert_allclose(list(got_m.values()), list(want_m.values()),
                               rtol=0, atol=1e-6)


def test_run_tiled_test_matches_jax(frcnn, monkeypatch):
    """Tiled: JAX's run_tiled_test, and the port's own device protocol
    (DeviceTiledInference) on the decoded frames."""
    pipeline = copy.deepcopy(TILED_TEST_PIPELINE)
    pipeline[1]["flip"] = False
    jds, ds = both_datasets(frcnn, pipeline)
    monkeypatch.setattr(jtest, "jax", FastJax())
    want = jtest.run_tiled_test(frcnn["jm"], frcnn["variables"], jds,
                                JaxCollator(pad_shape=(64, 96)))
    got = run_tiled_test(frcnn["model"], ds, DetCollator(pad_shape=(64, 96)))
    assert_results_match(want, got, jds, ds)
    eng = DeviceTiledInference(frcnn["model"], (128, 192), (64, 96),
                               (16, 16))
    for i, info in enumerate(ds.data_infos):
        frame = np.array(Image.open(frcnn["root"] / "test"
                                      / info["file_name"]).convert("RGB"))
        _assert_dets_match(_dets(got[i]), _dets(eng(frame)[0]))


def test_run_test_matches_jax(frcnn, monkeypatch):
    """Untiled: `run_test` on CocoFmtDataset samples whose `views[0]` is
    the whole frame (NoAug); the RoI head's score_thr lowered to 0.05 in
    both packages (at 0.3 the toy keeps nothing of these frames)."""
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="NoAug", transforms=[
                    dict(type="Resize", keep_ratio=True),
                    dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                         std=[58.395, 57.12, 57.375]),
                    dict(type="Pad", size_divisor=32),
                    dict(type="Collect", keys=["img"])])]
    jds, ds = both_datasets(frcnn, pipeline)
    test_cfg = copy.deepcopy(dict(frcnn["cfg"].test_cfg))
    test_cfg["rcnn"]["score_thr"] = 0.05
    jm = jax_build(dict(frcnn["cfg"].model), None, test_cfg)
    model = build_detector(dict(frcnn["cfg"].model), None, test_cfg,
                           device="cpu")
    model.load_state_dict(frcnn["model"].state_dict())
    model.eval()
    monkeypatch.setattr(jtest, "jax", FastJax())
    want = jtest.run_test(jm, frcnn["variables"], jds,
                          JaxCollator(pad_shape=(128, 192)))
    got = run_test(model, ds, DetCollator(pad_shape=(128, 192)))
    assert_results_match(want, got, jds, ds)

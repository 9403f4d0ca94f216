"""Whole-image inference, test-time augmentation and drawing in the port,
against the JAX package on the same config, weights and images.

Two toy detectors on a ResNet-18 of base 8 (FPN 16): a RetinaNet and a
Faster R-CNN (2 FCs of 32), each written as a JAX `.ckpt` and loaded by
both packages' `init_detector`, their classifiers redrawn (the same
numbers on both sides) to spread the scores as tests/test_torch_slice.py
does. `inference_detector` (the config's test pipeline flattened to one
view, a sample with RandomState(0), DetCollator with max_gt 1, one
`simple_test` an image, boxes rescaled) on arrays, a list and an image
path; `async_inference_detector`; `run_tta_test` of the Faster R-CNN on
MultiScaleFlipAug views (two scales, horizontal and vertical flips);
`show_result`'s pixels and file. Detections are held at
tests/test_detector_golden.py:88's tolerances (`_assert_dets_match`).
JAX compiles without XLA's backend optimisations; torch runs on one
thread.
"""
import asyncio
import copy
import importlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.apis.inference import \
    inference_detector as jax_inference
from pointtinybenchmark_tpu.apis.inference import \
    init_detector as jax_init_detector
from pointtinybenchmark_tpu.apis.inference import show_result as jax_show
from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.engine.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu_torch.apis.inference import (
    async_inference_detector, inference_detector, init_detector, show_result)
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.test import (run_tta_test,
                                                      unflip_boxes)
from test_torch_data import write_tinyperson_set
from test_torch_eval import FAST_COMPILE, FastJax, toy_frcnn_text
from test_torch_slice import _assert_dets_match, _dets

jtest = importlib.import_module("pointtinybenchmark_tpu.engine.test")

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="MultiScaleFlipAug", img_scale=(192, 128), flip=False,
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip"),
                     dict(type="Normalize", **NORM),
                     dict(type="Pad", size_divisor=32),
                     dict(type="ImageToTensor", keys=["img"]),
                     dict(type="Collect", keys=["img"])]),
]
# no Pad: the JAX package flips a view back about its padded width
TTA_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="MultiScaleFlipAug", img_scale=[(192, 128), (144, 96)],
         flip=True, flip_direction=["horizontal", "vertical"],
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip"),
                     dict(type="Normalize", **NORM),
                     dict(type="Collect", keys=["img"])]),
]
RETINA_MODEL = """
model = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, base_channels=8),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(
        type="RetinaHead", num_classes=2, in_channels=16,
        feat_channels=16, stacked_convs=1,
        anchor_generator=dict(type="AnchorGenerator", octave_base_scale=2,
                              scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(target_means=[0, 0, 0, 0], target_stds=[1, 1, 1, 1]),
        loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                      alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0)))
test_cfg = dict(nms_pre=4000, score_thr=0.6,
                nms=dict(type="nms", iou_threshold=0.5), max_per_img=1000)
"""
DETECTORS = {
    "retinanet": (RETINA_MODEL, [(("bbox_head_m",), "retina_cls", 0.02)]),
    "faster_rcnn": (None, [(("rpn_head_m",), "rpn_cls", 0.3),
                           (("roi_head_m", "bbox_head_m"), "fc_cls", 0.3)]),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    ann = write_tinyperson_set(root, "test", 2, (128, 192), 5)
    return root, ann


@pytest.fixture(scope="module", params=sorted(DETECTORS))
def handles(request, frames, tmp_path_factory):
    """(name, JAX handle, port handle) on the same `.ckpt`."""
    name = request.param
    model_text, redraw = DETECTORS[name]
    root, ann = frames
    text = toy_frcnn_text(ann, root / "test")
    text = text[:text.index("test_pipeline")] + (
        f"test_pipeline = {TEST_PIPELINE!r}\n") + text[text.index("data ="):]
    text = text.replace("loader = dict(pad_shape=(64, 96))",
                        "loader = dict(size_divisor=32)")
    if model_text is not None:
        text = text[:text.index("model = dict(")] + model_text
    # at the RoI head's 0.3 the toy keeps nothing of these frames
    text = text.replace("rcnn=dict(score_thr=0.3", "rcnn=dict(score_thr=0.05")
    work = tmp_path_factory.mktemp(name)
    cfg_path = work / "cfg.py"
    cfg_path.write_text(text)
    cfg = JaxConfig.fromfile(str(cfg_path))
    jm = jax_build(dict(cfg.model), None, cfg.test_cfg)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda r, x: jm.init(r, x, train=False)).lower(*args).compile(
        FAST_COMPILE)(*args))
    rng = np.random.RandomState(0)
    for scope, layer, scale in redraw:
        tree = variables["params"]
        for key in scope:
            tree = tree[key]
        tree[layer]["kernel"] = (rng.randn(*tree[layer]["kernel"].shape)
                                 * scale).astype(np.float32)
        tree[layer]["bias"] = np.zeros_like(tree[layer]["bias"])
    ckpt = work / "weights.ckpt"
    jax_save_checkpoint(str(ckpt), dict(params=variables["params"],
                                        batch_stats=variables["batch_stats"]))
    jh = jax_init_detector(str(cfg_path), str(ckpt))
    fast = FastJax.jit(lambda img, shp, sf: jh.model.apply(
        jh.variables, img, shp, sf, True, method=jh.model.simple_test))
    jh._infer = fast
    th = init_detector(str(cfg_path), str(ckpt), device="cpu")
    return name, jh, th


def _images(frames):
    root, _ = frames
    return [np.asarray(Image.open(p).convert("RGB"), np.float32)
            for p in sorted((root / "test").glob("*.jpg"))]


def test_inference_detector_matches_jax(handles, frames):
    name, jh, th = handles
    imgs = _images(frames)
    want = jax_inference(jh, imgs)
    got = inference_detector(th, imgs)
    assert isinstance(got, list) and len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert len(w["bboxes"]) > 0, name
        _assert_dets_match(_dets(w), _dets(g))
    one = inference_detector(th, imgs[0])
    assert isinstance(one, dict)
    np.testing.assert_array_equal(one["bboxes"], got[0]["bboxes"])
    path = sorted((frames[0] / "test").glob("*.jpg"))[1]
    from_path = inference_detector(th, str(path))
    np.testing.assert_array_equal(from_path["bboxes"], got[1]["bboxes"])
    awaited = asyncio.run(async_inference_detector(th, imgs[0]))
    np.testing.assert_array_equal(awaited["bboxes"], one["bboxes"])


@pytest.mark.parametrize("handles", ["faster_rcnn"], indirect=True)
def test_run_tta_test_matches_jax(handles, frames, monkeypatch):
    """Two scales x (no flip, horizontal, vertical): six views an image
    through one batched simple_test, mapped back and merged (the
    two-stage path: K1 in the RPN, the RoI head and the merge, K2)."""
    name, jh, th = handles
    root, ann = frames
    cfg = dict(type="CocoFmtDataset", ann_file=str(ann),
               img_prefix=str(root / "test"), test_mode=True,
               pipeline=TTA_PIPELINE)
    jds = jax_build_dataset(copy.deepcopy(cfg))
    ds = build_dataset(cfg)
    assert len(ds[0]["views"]) == 6
    monkeypatch.setattr(jtest, "jax", FastJax())
    want = jtest.run_tta_test(jh.model, jh.variables, jds,
                              JaxCollator(size_divisor=32))
    got = run_tta_test(th.model.eval(), ds, DetCollator(size_divisor=32))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert 0 < len(w["bboxes"]) <= 100, name
        _assert_dets_match(_dets(w), _dets(g))


def test_unflip_uses_the_resized_extent():
    """A view padded from 150 to 160 columns (and 96 to 128 rows) flips
    back about its content, mmdet's bbox_flip; the JAX package's
    run_tta_test would use the padded 160 (ROADMAP.md queue 3)."""
    box = torch.tensor([[10.0, 5.0, 20.0, 15.0]])
    meta = dict(flip=True, flip_direction="horizontal",
                img_shape=(96, 150, 3))
    assert unflip_boxes(box, meta, (128, 160)).tolist() == [[130.0, 5.0,
                                                              140.0, 15.0]]
    meta["flip_direction"] = "vertical"
    assert unflip_boxes(box, meta, (128, 160)).tolist() == [[10.0, 81.0,
                                                              20.0, 91.0]]
    del meta["img_shape"]
    assert unflip_boxes(box, meta, (128, 160)).tolist() == [[10.0, 113.0,
                                                              20.0, 123.0]]
    assert unflip_boxes(box, dict(flip=False), (128, 160)) is box


def test_show_result_matches_jax(tmp_path):
    """The same pixels and the same file as the JAX package's
    visualization.py, with class names, a score threshold and a label
    outside the names."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    boxes = np.hstack([rng.rand(6, 2) * 40, 40 + rng.rand(6, 2) * 40,
                       rng.rand(6, 1)]).astype(np.float32)
    res = dict(bboxes=boxes, labels=np.asarray([0, 1, 2, 0, 1, 7]))
    classes = ("person", "car", "dog")
    got = show_result(img, res, classes, score_thr=0.3,
                      out_file=str(tmp_path / "port.png"))
    want = jax_show(img, res, classes, score_thr=0.3,
                    out_file=str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port.png")),
        np.asarray(Image.open(tmp_path / "jax.png")))

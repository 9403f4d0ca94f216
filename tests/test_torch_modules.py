"""Each ported module against its JAX counterpart, on the same numpy inputs
and, for the networks, the same JAX-initialized weights carried across by
`load_jax_variables`.

Tolerances: anchors, tiling and DevicePreprocessor are bit-exact. Network
forwards agree to rtol/atol 1e-4: XLA and oneDNN sum convolutions in a
different order. Detections use the tests/test_detector_golden.py:88
tolerances (box atol 2e-3, score atol 1e-4, same count and labels).
"""
import importlib
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.core import anchors as janchors
from pointtinybenchmark_tpu.core import bbox as jbbox
from pointtinybenchmark_tpu.data.device_pipeline import \
    DevicePreprocessor as JaxPre
from pointtinybenchmark_tpu.data.tiling import tile_grid as jax_tile_grid
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu_torch.core.anchors import AnchorGenerator
from pointtinybenchmark_tpu_torch.core.bbox import delta2bbox
from pointtinybenchmark_tpu_torch.core.post_processing import multiclass_nms
from pointtinybenchmark_tpu_torch.data.device_pipeline import \
    DevicePreprocessor
from pointtinybenchmark_tpu_torch.data.tiling import tile_grid
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.builder import build_module
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables

jpost = importlib.import_module("pointtinybenchmark_tpu.core.post_processing")

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
ADAP_ANCHOR = dict(type="AnchorGenerator", octave_base_scale=2,
                   scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                   strides=[4, 8, 16, 32, 64])
TEST_CFG = dict(nms_pre=100, score_thr=0.05,
                nms=dict(type="nms", iou_threshold=0.5), max_per_img=60)
MODEL_CFG = dict(
    type="SingleStageDetector",
    backbone=dict(type="ResNet", depth=50, base_channels=8,
                  frozen_stages=1, norm_eval=True),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(
        type="RetinaHead", num_classes=2, in_channels=16, feat_channels=16,
        stacked_convs=2, anchor_generator=ADAP_ANCHOR,
        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0, 0, 0, 0],
                        target_stds=[1.0, 1.0, 1.0, 1.0]),
        loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                      alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0)))
RETINA_CFG = "configs/tinyperson/retinanet_r50_fpns4_1x_tinyperson640_clipg.py"


def randomize_norm_and_bias(variables, seed):
    """flax initializes BN to identity and most biases to 0, under which a
    mis-mapped BN or bias leaf would go unseen: draw them from numpy."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
            elif k in ("bias", "mean"):
                out[k] = v + jnp.asarray(rng.randn(*v.shape) * 0.1, v.dtype)
            else:
                out[k] = v
        return out
    return walk(variables)


def _dets_np(dets, i):
    """(boxes+score, labels) of batch item i, valid rows, score-descending."""
    b, l, v = (np.asarray(x)[i] for x in dets)
    b, l = b[v], l[v]
    order = np.argsort(-b[:, 4], kind="stable")
    return b[order], l[order]


def assert_dets_match(ref, got, atol_box=2e-3, atol_score=1e-4):
    (rb, rl), (gb, gl) = ref, got
    assert rb.shape[0] == gb.shape[0], (rb.shape, gb.shape)
    np.testing.assert_allclose(gb[:, 4], rb[:, 4], atol=atol_score, rtol=1e-4)
    np.testing.assert_allclose(gb[:, :4], rb[:, :4], atol=atol_box, rtol=1e-4)
    np.testing.assert_array_equal(gl, rl)


# ------------------------------------------------------------ host numpy
@pytest.mark.parametrize("sizes,pad", [
    ([(128, 160), (64, 80), (32, 40), (16, 20), (8, 10)], (512, 640)),
    ([(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)], (60, 90)),
])
def test_anchors_bit_exact(sizes, pad):
    cfg = {k: v for k, v in ADAP_ANCHOR.items() if k != "type"}
    j = janchors.AnchorGenerator(**cfg)
    t = AnchorGenerator(**cfg)
    for a, b in zip(j.grid_anchors(sizes), t.grid_anchors(sizes)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j.valid_flags(sizes, pad), t.valid_flags(sizes, pad)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [(1920, 1080, 640, 512, 100, 100),
                                  (192, 128, 96, 64, 16, 16),
                                  (150, 100, 192, 128, 0, 0),
                                  (700, 500, 640, 512, 0, 0)])
def test_tile_grid_matches_jax(args):
    assert tile_grid(*args) == jax_tile_grid(*args)


def test_config_matches_jax():
    assert Config.fromfile(RETINA_CFG).to_dict() == \
        JaxConfig.fromfile(RETINA_CFG).to_dict()


# ---------------------------------------------------------------- device
@pytest.mark.parametrize("frames_shape,kw", [
    ((1080, 1920, 3), dict(tile_hw=(512, 640), tile_overlap=(100, 100))),
    ((2, 256, 384, 3), dict(tile_hw=(128, 192))),
    ((100, 150, 3), dict(tile_hw=(128, 192), pad_val=0.0)),
    ((500, 700, 3), dict(tile_hw=(256, 320), tile_overlap=(40, 30))),
])
def test_device_preprocessor_bit_exact(frames_shape, kw):
    frames = np.random.RandomState(0).randint(0, 256, frames_shape, np.uint8)
    hw = frames_shape[-3:-1]
    want = np.asarray(JaxPre(hw, MEAN, STD, **kw)(frames))
    pre = DevicePreprocessor(hw, MEAN, STD, device="cpu", **kw)
    got = pre(frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pre.tile_offsets,
                                  JaxPre(hw, MEAN, STD, **kw).tile_offsets)


def test_delta2bbox_matches_jax():
    rng = np.random.RandomState(1)
    rois = rng.uniform(0, 300, (500, 2)).astype(np.float32)
    rois = np.concatenate([rois, rois + rng.uniform(4, 60, (500, 2))], 1)
    deltas = (rng.randn(500, 4) * [0.5, 0.5, 3.0, 3.0]).astype(np.float32)
    kw = dict(means=(0.1, 0.0, 0.0, 0.2), stds=(0.5, 0.5, 1.0, 1.0),
              max_shape=(256, 320))
    want = np.asarray(jbbox.delta2bbox(jnp.asarray(rois),
                                       jnp.asarray(deltas), **kw))
    got = delta2bbox(torch.from_numpy(rois.astype(np.float32)),
                     torch.from_numpy(deltas), **kw).numpy()
    assert (np.abs(deltas[:, 2:]) > 4.14).any()       # wh_ratio_clip bites
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# --------------------------------------------------------------- networks
@pytest.fixture(scope="module")
def pair():
    """JAX detector + variables, and the port with those weights."""
    jm = jax_build(dict(MODEL_CFG), None, dict(TEST_CFG))
    img = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(img))
    variables = randomize_norm_and_bias(
        jax.tree_util.tree_map(np.asarray, variables), seed=3)
    tm = build_detector(dict(MODEL_CFG), None, dict(TEST_CFG), device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return jm, variables, tm, img


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("part", ["backbone", "neck", "head"])
def test_network_forward_matches_jax(pair, part):
    jm, variables, tm, img = pair
    x = torch.from_numpy(img)
    with torch.no_grad():
        if part == "backbone":
            got = tm.backbone(x.permute(0, 3, 1, 2))
            want = jm.apply(variables, jnp.asarray(img),
                            method=lambda m, i: m.backbone_m(i))
        elif part == "neck":
            got = tm.extract_feat(x)
            want = jm.apply(variables, jnp.asarray(img),
                            method=lambda m, i: m.extract_feat(i))
        else:
            cls, reg = tm(x)
            got = cls + reg
            jc, jr = jm.apply(variables, jnp.asarray(img))
            want = list(jc) + list(jr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_anchor_head_forward_matches_jax():
    """The plain AnchorHead (1x1 conv_cls / conv_reg), the base RetinaHead
    builds on."""
    from pointtinybenchmark_tpu.models.dense_heads.anchor_head import \
        AnchorHead as JaxAnchorHead
    from pointtinybenchmark_tpu_torch.models.dense_heads.anchor_head import \
        AnchorHead
    kw = dict(num_classes=2, in_channels=16, anchor_generator=ADAP_ANCHOR,
              loss_cls=dict(type="FocalLoss", use_sigmoid=True))
    feats = [np.random.RandomState(6).randn(2, h, w, 16).astype(np.float32)
             for h, w in [(16, 24), (8, 12)]]
    jhead = JaxAnchorHead(**kw)
    params = jax.tree_util.tree_map(np.asarray, jhead.init(
        jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats]))["params"]
    params = randomize_norm_and_bias(params, seed=7)
    want = jhead.apply({"params": params}, [jnp.asarray(f) for f in feats])
    head = AnchorHead(**kw)
    load_jax_variables(torch.nn.ModuleDict({"bbox_head": head}),
                       {"bbox_head_m": params})
    with torch.no_grad():
        got = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got[0] + got[1], list(want[0]) + list(want[1])):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_get_bboxes_matches_jax(pair):
    """Head post-processing (per-level top-nms_pre, decode, clip, batched
    multiclass NMS) on the same raw head outputs, drawn with numpy so that
    scores spread well apart and the top-k boundary is exercised."""
    jm, _, tm, _ = pair
    rng = np.random.RandomState(4)
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    cls = [(rng.randn(3, h, w, 18) * 2).astype(np.float32) for h, w in sizes]
    reg = [(rng.randn(3, h, w, 36) * 0.3).astype(np.float32) for h, w in sizes]
    shapes = np.asarray([[60, 90], [64, 96], [50, 70]], np.int32)
    from pointtinybenchmark_tpu.models.dense_heads.retina_head import \
        RetinaHead as JaxRetina
    hcfg = {k: v for k, v in MODEL_CFG["bbox_head"].items()
            if k not in ("type", "loss_bbox")}
    want, _ = JaxRetina(test_cfg=dict(TEST_CFG), **hcfg).get_bboxes(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        jnp.asarray(shapes), (64, 96))
    got = tm.bbox_head.get_bboxes(
        [torch.from_numpy(c).permute(0, 3, 1, 2) for c in cls],
        [torch.from_numpy(r).permute(0, 3, 1, 2) for r in reg],
        torch.from_numpy(shapes))
    for i in range(3):
        ref = _dets_np(want, i)
        assert ref[0].shape[0] > 0
        assert_dets_match(ref, _dets_np(got, i))


def test_multiclass_nms_cap_and_factors():
    """The max_per_img cap over class-specific (N, C*4) boxes with a
    validity mask, both functions with their defaults: no score factors and
    a pre-NMS cap of 20,000 that 1,200 candidates do not reach
    (tests/test_torch_mask.py binds the cap and adds factors)."""
    rng = np.random.RandomState(5)
    n, c = 400, 3
    ctr = rng.uniform(20, 200, (n, 1, 2))
    wh = rng.uniform(8, 30, (n, c, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).reshape(n, c * 4)
    boxes = boxes.astype(np.float32)
    scores = rng.rand(n, c + 1).astype(np.float32)
    valid = rng.rand(n) > 0.1
    want = jpost.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3,
                                0.5, 80, valid_mask=jnp.asarray(valid))
    got = multiclass_nms(torch.from_numpy(boxes)[None],
                         torch.from_numpy(scores)[None], 0.3, 0.5, 80,
                         valid_mask=torch.from_numpy(valid)[None])
    want = [np.asarray(x)[None] for x in want]
    assert int(want[2].sum()) == 80
    assert_dets_match(_dets_np(want, 0), _dets_np(got, 0))


# ------------------------------------------------------------ Faster R-CNN
FRCNN_CFG = dict(
    type="FasterRCNN",
    backbone=dict(type="ResNet", depth=50, base_channels=8,
                  frozen_stages=1, norm_eval=True),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              num_outs=5),
    rpn_head=dict(
        type="RPNHead", num_classes=1, in_channels=16, feat_channels=16,
        anchor_generator=dict(type="AnchorGenerator", scales=[2],
                              ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0, 0, 0, 0],
                        target_stds=[1.0, 1.0, 1.0, 1.0]),
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True)),
    roi_head=dict(
        type="StandardRoIHead",
        bbox_roi_extractor=dict(
            roi_layer=dict(type="RoIAlign", output_size=7, sampling_ratio=1),
            out_channels=16, featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(
            type="Shared2FCBBoxHead", num_classes=2, in_channels=16,
            fc_out_channels=32, roi_feat_size=7,
            bbox_coder=dict(type="DeltaXYWHBBoxCoder",
                            target_means=[0, 0, 0, 0],
                            target_stds=[0.1, 0.1, 0.2, 0.2]),
            loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False))))
RPN_CFG = dict(nms_pre=300, max_per_img=500,
               nms=dict(type="nms", iou_threshold=0.7), min_bbox_size=2.0)
FRCNN_TEST_CFG = dict(
    rpn=RPN_CFG,
    rcnn=dict(score_thr=0.05, nms=dict(type="nms", iou_threshold=0.5),
              max_per_img=500))
FRCNN_SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]


@pytest.fixture(scope="module")
def frcnn_pair():
    """JAX Faster R-CNN + variables (norms, biases and fc_cls redrawn from
    numpy), and the port with those weights."""
    jm = jax_build(dict(FRCNN_CFG), None, dict(FRCNN_TEST_CFG))
    img = np.random.RandomState(12).randn(2, 64, 96, 3).astype(np.float32)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(img))
    variables = randomize_norm_and_bias(
        jax.tree_util.tree_map(np.asarray, variables), seed=13)
    cls = variables["params"]["roi_head_m"]["bbox_head_m"]["fc_cls"]
    cls["kernel"] = jnp.asarray(np.random.RandomState(14).randn(
        *cls["kernel"].shape), jnp.float32)
    tm = build_detector(dict(FRCNN_CFG), None, dict(FRCNN_TEST_CFG),
                        device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return jm, variables, tm, img


def test_fpn_maxpool_extras_match_jax(frcnn_pair):
    """add_extra_convs=False (the JAX default): P6 is P5 subsampled by 2."""
    jm, variables, tm, img = frcnn_pair
    with torch.no_grad():
        got = tm.extract_feat(torch.from_numpy(img))
    want = jm.apply(variables, jnp.asarray(img),
                    method=lambda m, i: m.extract_feat(i))
    assert [tuple(g.shape[-2:]) for g in got] == FRCNN_SIZES
    assert not any(k.startswith("neck.fpn_convs.4") for k in tm.state_dict())
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_rpn_head_forward_matches_jax(frcnn_pair):
    jm, variables, tm, _ = frcnn_pair
    feats = [np.random.RandomState(15).randn(2, h, w, 16).astype(np.float32)
             for h, w in FRCNN_SIZES]
    with torch.no_grad():
        cls, reg = tm.rpn_head([torch.from_numpy(f).permute(0, 3, 1, 2)
                                for f in feats])
    jc, jr = jm.apply(variables, [jnp.asarray(f) for f in feats],
                      method=lambda m, f: m.rpn_head_m(f))
    for g, w in zip(cls + reg, list(jc) + list(jr)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_rpn_get_proposals_matches_jax(frcnn_pair):
    """Proposals from the same raw RPN outputs, drawn with numpy so scores
    spread: nms_pre cuts the first level, min_bbox_size drops small boxes,
    and the empty slots (filled with the first candidate, score 0) count."""
    jm, _, tm, _ = frcnn_pair
    rng = np.random.RandomState(16)
    cls = [(rng.randn(3, h, w, 3) * 2).astype(np.float32)
           for h, w in FRCNN_SIZES]
    reg = [(rng.randn(3, h, w, 12) * 0.5).astype(np.float32)
           for h, w in FRCNN_SIZES]
    shapes = np.asarray([[60, 90], [64, 96], [50, 70]], np.int32)
    from pointtinybenchmark_tpu.models.dense_heads.rpn_head import \
        RPNHead as JaxRPN
    hcfg = {k: v for k, v in FRCNN_CFG["rpn_head"].items() if k != "type"}
    want = JaxRPN(**hcfg).get_proposals(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        jnp.asarray(shapes), (64, 96), RPN_CFG)
    got = tm.rpn_head.get_proposals(
        [torch.from_numpy(c).permute(0, 3, 1, 2) for c in cls],
        [torch.from_numpy(r).permute(0, 3, 1, 2) for r in reg],
        torch.from_numpy(shapes), RPN_CFG)
    wb, ws, wv = (np.asarray(x) for x in want)
    gb, gs, gv = (x.numpy() for x in got)
    assert 100 < wv.sum(1).min() and (~wv).any()    # some slots stay empty
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gb, wb, atol=2e-3, rtol=1e-4)


def test_bbox_head_matches_jax(frcnn_pair):
    """Shared2FCBBoxHead on (R, C, 7, 7) features: the permuted
    shared_fc0 gives the JAX head's (h, w, c) flatten the same product."""
    jm, variables, tm, _ = frcnn_pair
    x = np.random.RandomState(17).randn(40, 7, 7, 16).astype(np.float32)
    with torch.no_grad():
        got = tm.roi_head.bbox_head(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = jm.apply(variables, jnp.asarray(x),
                    method=lambda m, r: m.roi_head_m.bbox_head_m(r))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_roi_head_simple_test_matches_jax(frcnn_pair):
    """RoIAlign over four levels, the 2-FC head, softmax, class-wise
    decode, clip and batched multiclass NMS, with invalid proposal slots."""
    jm, variables, tm, _ = frcnn_pair
    rng = np.random.RandomState(18)
    feats = [rng.randn(2, h, w, 16).astype(np.float32)
             for h, w in FRCNN_SIZES]
    ctr = rng.uniform(0, 96, (2, 150, 2)) * [1.0, 64 / 96]
    wh = np.exp(rng.uniform(np.log(4), np.log(90), (2, 150, 2)))
    props = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    props = np.clip(props, 0, [96, 64, 96, 64]).astype(np.float32)
    valid = rng.rand(2, 150) > 0.1
    shapes = np.asarray([[64, 96], [60, 90]], np.int32)
    want = jm.apply(variables, [jnp.asarray(f) for f in feats],
                    jnp.asarray(props), jnp.asarray(valid),
                    jnp.asarray(shapes),
                    method=lambda m, *a: m.roi_head_m.simple_test(*a))
    with torch.no_grad():
        got = tm.roi_head.simple_test(
            [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
            torch.from_numpy(props), torch.from_numpy(valid),
            torch.from_numpy(shapes))
    for i in range(2):
        ref = _dets_np(want, i)
        assert ref[0].shape[0] > 10 and len(np.unique(ref[1])) == 2
        assert_dets_match(ref, _dets_np(got, i))


# ------------------------------------------------------------ the builder
P2P_CFG = "configs/tinyperson/p2p_r50_fpns4_1x_tinyperson640.py"
CPR_CFG = ("configs/tinypersonv2/cpr/"
           "coarse_point_refine_r50_fpns4_1x_tinypersonv2_640.py")
PORT_CONFIGS = (RETINA_CFG,
                "configs/tinyperson/faster_rcnn_r50_fpn_1x_tinyperson640.py",
                "configs/coco/mask_rcnn_r50_fpn_1x_coco.py", P2P_CFG, CPR_CFG)
DCN_CFG = "configs/coco/faster_rcnn_r50_fpn_dconv_c3_c5_1x_coco.py"


_BUILT = {}


def _built(path):
    """init_detector(path) on the CPU, built once for the two tests that
    read it, on one thread (the seeded draw of a full-width model is the
    cost; its generator draws the same numbers on any number of threads,
    and other processes of a parallel run keep the cores)."""
    from pointtinybenchmark_tpu_torch.apis.inference import init_detector
    if path not in _BUILT:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _BUILT[path] = init_detector(path, device="cpu").model
        finally:
            torch.set_num_threads(n)
    return _BUILT[path]


@pytest.mark.parametrize("path", PORT_CONFIGS)
def test_port_configs_still_build(path):
    """Every config the port runs builds, with no key refused."""
    model = _built(path)
    assert sum(p.numel() for p in model.parameters()) > 2e7


@pytest.mark.parametrize("key", ["dcn", "stage_with_dcn"])
def test_build_module_refuses_structural_keys(key):
    """A key the port's class does not take raises and names itself and
    the class: the deformable-convolution config does not build as a
    network without DCN."""
    cfg = Config.fromfile(DCN_CFG)
    if key == "dcn":
        with pytest.raises(NotImplementedError, match=r"ResNet.*'dcn'"):
            build_detector(dict(cfg.model), cfg.get("train_cfg"),
                           cfg.get("test_cfg"), device="cpu")
    backbone = {k: v for k, v in dict(cfg.model["backbone"]).items()
                if k in ("type", "depth", key)}
    with pytest.raises(NotImplementedError, match=f"ResNet.*'{key}'"):
        build_module(backbone)


@pytest.mark.parametrize("path,head", [(P2P_CFG, "P2PHead"),
                                       (CPR_CFG, "CPRHead")])
def test_point_configs_init_detector(path, head):
    """The point configs through init_detector: a BasicLocator whose FPN
    took `norm_cfg` (GN) and, as the JAX package's, has no norm; the
    head's GN convs have no conv bias."""
    model = _built(path)
    assert type(model).__name__ == "BasicLocator"
    assert type(model.bbox_head).__name__ == head
    assert Config.fromfile(path).model["neck"]["norm_cfg"]["type"] == "GN"
    assert not any(isinstance(m, torch.nn.GroupNorm)
                   for m in model.neck.modules())
    assert model.bbox_head.cls_convs[0].gn.num_groups == 32
    assert model.bbox_head.cls_convs[0].conv.bias is None


def test_fpn_refuses_other_unknown_keys():
    """norm_cfg is the FPN's one taken-and-dropped key: any other key the
    port's FPN does not take still raises."""
    cfg = dict(Config.fromfile(P2P_CFG).model["neck"])
    build_module(dict(cfg))
    with pytest.raises(NotImplementedError, match=r"FPN.*'upsample_cfg'"):
        build_module(dict(cfg, upsample_cfg=dict(mode="nearest")))

"""Mask R-CNN inference of the port against the JAX package, on the CPU.

The detector is tiny: ResNet-50 at base_channels=8, FPN 16, 2 FCs of 32,
3 classes and an FCNMaskHead of 2 convolutions at 16 channels; its bbox and
mask extractors take the config's sampling_ratio=0, which both packages
turn into 2. JAX weights (the XLA RoIAlign, no `use_pallas`) are carried
into the port by `load_jax_variables`, with the classifiers that score each
stage (`rpn_cls`, `fc_cls`) redrawn to spread the scores, as in
tests/test_torch_slice.py, and norms and biases redrawn so that a
mis-mapped leaf shows. `conv_logits` is redrawn at std 0.5 (the JAX init's
std 0.001 puts every mask probability within ~1e-3 of 0.5, where the paste
threshold flips on rounding noise). Detections are compared at the
tests/test_detector_golden.py:88 tolerances (box atol 2e-3, score atol
1e-4), matched one to one; mask probabilities of matched slots at atol
1e-5; RLE masks must be equal strings.

Also here: `multiclass_nms` with the pre-NMS cap binding and with score
factors, and the host mask paste and RLE encoding, against the JAX
functions.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.engine.test import run_test as jax_run_test
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu_torch.apis.inference import _protocol_settings
from pointtinybenchmark_tpu_torch.core.post_processing import multiclass_nms
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.test import run_test
from pointtinybenchmark_tpu_torch.evaluation import mask_utils
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables

jpost = importlib.import_module("pointtinybenchmark_tpu.core.post_processing")
jmask = importlib.import_module("pointtinybenchmark_tpu.evaluation.mask_utils")

MASK_CFG = dict(
    type="MaskRCNN",
    backbone=dict(type="ResNet", depth=50, base_channels=8),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              num_outs=5),
    rpn_head=dict(
        type="RPNHead", num_classes=1, in_channels=16, feat_channels=16,
        anchor_generator=dict(type="AnchorGenerator", scales=[2],
                              ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64])),
    roi_head=dict(
        type="StandardRoIHead",
        bbox_roi_extractor=dict(
            roi_layer=dict(type="RoIAlign", output_size=7, sampling_ratio=0),
            featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(type="Shared2FCBBoxHead", num_classes=3,
                       in_channels=16, fc_out_channels=32, roi_feat_size=7),
        mask_roi_extractor=dict(
            type="SingleRoIExtractor",
            roi_layer=dict(type="RoIAlign", output_size=14, sampling_ratio=0),
            featmap_strides=[4, 8, 16, 32]),
        mask_head=dict(type="FCNMaskHead", num_convs=2, in_channels=16,
                       conv_out_channels=16, num_classes=3)))
TEST_CFG = dict(
    rpn=dict(nms_pre=1000, max_per_img=300, nms=dict(iou_threshold=0.7),
             min_bbox_size=0),
    rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5), max_per_img=50))
ATOL_MASK = 1e-5
COCO_CFG = "configs/coco/mask_rcnn_r50_fpn_1x_coco.py"


def _redraw(variables, seed):
    """Norms and biases perturbed, the scoring classifiers and conv_logits
    redrawn (module docstring)."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                tree[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
    walk(variables)
    params = variables["params"]
    for tree, name, std in ((params["rpn_head_m"], "rpn_cls", 0.3),
                            (params["roi_head_m"]["bbox_head_m"], "fc_cls",
                             0.3),
                            (params["roi_head_m"]["mask_head_m"],
                             "conv_logits", 0.5)):
        tree[name]["kernel"] = (rng.randn(*tree[name]["kernel"].shape)
                                * std).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def mask_pair():
    """JAX Mask R-CNN + its variables, and the port with those weights."""
    jm = jax_build(dict(MASK_CFG), None, dict(TEST_CFG))
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32))
    variables = _redraw(jax.tree_util.tree_map(np.array, variables), seed=27)
    tm = build_detector(dict(MASK_CFG), None, dict(TEST_CFG), device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return jm, variables, tm


def _match(ref, got, atol_box=2e-3, atol_score=1e-4):
    """tests/test_torch_slice.py's one-to-one matching of (bboxes (n, 5),
    labels (n,)); returns for each reference row the row of `got`."""
    (rb, rl), (gb, gl) = ref, got
    assert gb.shape == rb.shape, (gb.shape, rb.shape)
    used = np.zeros(len(gb), bool)
    rows = []
    for i in range(len(rb)):
        near = np.abs(gb[:, 4] - rb[i, 4]) <= atol_score + 1e-4 * abs(rb[i, 4])
        ok = (near & ~used & (gl == rl[i])
              & (np.abs(gb[:, :4] - rb[i, :4])
                 <= atol_box + 1e-4 * np.abs(rb[i, :4])).all(1))
        assert ok.any(), (i, rb[i], rl[i])
        rows.append(int(np.argmax(ok)))
        used[rows[-1]] = True
    return np.asarray(rows, np.int64)


def test_coco_mask_rcnn_config_matches_jax():
    """The COCO Mask R-CNN config's chain (its Faster R-CNN base, whose neck
    replaces the CARAFE base's with `_delete_`, three `_base_` files and
    coco_instance.py) loads as the JAX loader loads it, and the port builds
    it: 80 classes, a max-pooled P6, sampling_ratio 0 -> 2. Its test
    pipeline has no CroppedTilesFlipAug, so the tiled protocol takes the
    defaults: 512x640 tiles, 100 px overlap, the standard normalization."""
    cfg = Config.fromfile(COCO_CFG)
    assert cfg.to_dict() == JaxConfig.fromfile(COCO_CFG).to_dict()
    assert cfg.model.neck == dict(type="FPN", in_channels=[256, 512, 1024,
                                                           2048],
                                  out_channels=256, start_level=0, num_outs=5)
    model = build_detector(dict(cfg.model), None, cfg.test_cfg, device="cpu")
    head = model.roi_head
    assert (head.num_classes, head.mask_head.num_classes) == (80, 80)
    assert (head.bbox_extractor["output_size"],
            head.bbox_extractor["sampling_ratio"]) == (7, 2)
    assert (head.mask_extractor["output_size"],
            head.mask_extractor["sampling_ratio"]) == (14, 2)
    assert head.mask_head.upsample.weight.shape == (256, 256, 2, 2)
    assert type(model).__name__ == "MaskRCNN"
    assert _protocol_settings(cfg, None, None) == ((512, 640), (100, 100),
                                                   None)


# ------------------------------------------------------------ post-processing
@pytest.mark.parametrize("factors", [False, True])
def test_multiclass_nms_pre_nms_limit_and_score_factors(factors):
    """More valid candidates than `pre_nms_limit` (the cap binds, with ties
    on a 1e-3 grid at its boundary) and `max_per_img` above the cap, with
    and without score factors: keep sets, boxes, scores and labels
    identical to the JAX function's, and fewer kept than without the cap."""
    rng = np.random.RandomState(22)
    b, n, c, limit = 2, 300, 4, 500
    ctr = rng.uniform(20, 200, (b, n, 1, 2))
    wh = rng.uniform(8, 40, (b, n, c, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = boxes.reshape(b, n, c * 4).astype(np.float32)
    scores = (rng.randint(0, 1000, (b, n, c + 1)) / 1000).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    sf = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32) if factors else None
    assert ((scores[..., :c] > 0.05) & valid[..., None]).sum((1, 2)).min() \
        > limit
    kw = dict(valid_mask=torch.from_numpy(valid),
              score_factors=None if sf is None else torch.from_numpy(sf))
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.05, 0.5, 800, pre_nms_limit=limit, **kw)
    for i in range(b):
        want = jpost.multiclass_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.05, 0.5, 800,
            valid_mask=jnp.asarray(valid[i]), pre_nms_limit=limit,
            score_factors=None if sf is None else jnp.asarray(sf[i]))
        assert 100 < int(want.valid.sum()) <= limit
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    uncapped = multiclass_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores), 0.05, 0.5, 800, **kw)
    assert (uncapped.valid.sum(1) > got.valid.sum(1)).all()


# ------------------------------------------------------------------ mask head
def test_mask_head_matches_jax(mask_pair):
    """FCNMaskHead on (R, C, 14, 14) features with the JAX weights: the
    transposed convolution's flipped taps give the JAX logits; the same
    kernel carried across without the flip does not."""
    jm, variables, tm = mask_pair
    x = np.random.RandomState(23).randn(30, 14, 14, 16).astype(np.float32)
    head = tm.roi_head.mask_head
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(jm.apply(variables, jnp.asarray(x),
                               method=lambda m, r: m.roi_head_m.mask_head_m(r)))
    assert got.shape == (30, 3, 28, 28)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    kernel = variables["params"]["roi_head_m"]["mask_head_m"]["upsample"][
        "kernel"]
    saved = head.upsample.weight.detach().clone()
    with torch.no_grad():
        head.upsample.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        unflipped = head(torch.from_numpy(x).permute(0, 3, 1, 2))
        head.upsample.weight.copy_(saved)
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


# ------------------------------------------------------------- paste and RLE
def _paste_inputs(rng, m=40, h=100, w=150):
    crops = rng.rand(m, 28, 28).astype(np.float32)
    ctr = rng.uniform(0, 1, (m, 2)) * [w, h]
    wh = np.exp(rng.uniform(np.log(2), np.log(120), (m, 2)))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    boxes[:6] = [(-30, -20, 40, 30),            # off the top-left corner
                 (w - 10, h - 5, w + 40, h + 60),   # off the bottom-right
                 (20, 30, 20, 70),              # zero width
                 (50, 40, 90, 40),              # zero height
                 (80, 60, 70, 50),              # inverted
                 (-5.5, -3.25, w + 7.75, h + 0.5)]  # over the whole image
    boxes[6] = (w + 5, 10, w + 30, 40)          # wholly outside
    return crops, boxes.astype(np.float32), h, w


@pytest.mark.parametrize("budget", ["default", "small"])
def test_paste_masks_and_rle_equal_jax(monkeypatch, budget):
    """The pasted masks and their RLE strings equal the JAX package's bit for
    bit, boxes off the image, zero-area and inverted ones included; "small"
    shrinks the paste's workspace budget in both packages so that it runs
    in many chunks."""
    if budget == "small":
        monkeypatch.setattr(mask_utils, "_PASTE_CHUNK_BUDGET", 3000)
        monkeypatch.setattr(jmask, "_PASTE_CHUNK_BUDGET", 3000)
    crops, boxes, h, w = _paste_inputs(np.random.RandomState(24))
    got = mask_utils.paste_masks(crops, boxes, h, w)
    want = jmask.paste_masks(crops, boxes, h, w)
    np.testing.assert_array_equal(got, want)
    assert got[:2].any() and not got[2:5].any() and got[5].any()
    for g in got:
        assert mask_utils.rle_encode(g) == jmask.rle_encode(g)
    for special in (np.zeros((7, 5), bool), np.ones((7, 5), bool),
                    np.eye(6, 9, dtype=bool), np.zeros((0, 4), bool)):
        assert mask_utils.rle_encode(special) == jmask.rle_encode(special)


# ------------------------------------------------------------- the detector
def test_mask_rcnn_simple_test_matches_jax(mask_pair):
    """The whole network on three 64x96 tiles (one of them with a 60x90
    image shape): RPN, the bbox branch (RoIAlign at S=7, sr=2), 3-class NMS
    and the mask branch on every detection slot (RoIAlign at S=14, sr=2,
    the mask head, the label's channel, a sigmoid)."""
    jm, variables, tm = mask_pair
    img = np.random.RandomState(25).randn(3, 64, 96, 3).astype(np.float32)
    shapes = np.asarray([[64, 96], [60, 90], [64, 96]], np.int32)
    (jdets, jmasks), _ = jax.jit(lambda v, x, s: jm.apply(
        v, x, s, method=jm.simple_test))(variables, jnp.asarray(img),
                                         jnp.asarray(shapes))
    with torch.no_grad():
        dets, masks = tm.simple_test(torch.from_numpy(img),
                                     torch.from_numpy(shapes))
    jmasks = np.asarray(jmasks)
    assert masks.shape == jmasks.shape == (3, 50, 28, 28)
    # several labels, so that the label's channel is what picks the mask
    assert len(np.unique(np.asarray(jdets.labels)[np.asarray(
        jdets.valid)])) == 3
    for i in range(3):
        jv, gv = np.asarray(jdets.valid[i]), dets.valid[i].numpy()
        assert 10 < jv.sum()
        rows = _match((np.asarray(jdets.bboxes[i])[jv],
                       np.asarray(jdets.labels[i])[jv]),
                      (dets.bboxes[i].numpy()[gv], dets.labels[i].numpy()[gv]))
        np.testing.assert_allclose(masks[i].numpy()[gv][rows], jmasks[i][jv],
                                   rtol=0, atol=ATOL_MASK)
        # the empty slots are zero boxes of label 0 on both sides
        if (~jv).any() and (~gv).any():
            np.testing.assert_allclose(masks[i].numpy()[~gv][0],
                                       jmasks[i][~jv][0], rtol=0,
                                       atol=ATOL_MASK)
    assert 0.05 < float(jmasks.std())


def test_run_test_rescale_matches_jax(mask_pair):
    """Both packages' `run_test` over two preprocessed samples (60x90 and
    56x80, scale factors != 1, original shapes 75x120 and 70x100) with
    their own collators (pad to a multiple of 32) and rescale: boxes,
    labels and RLE masks in the original frames."""
    jm, variables, tm = mask_pair
    rng = np.random.RandomState(26)
    samples = []
    for (h, w), sf, ori in (((60, 90), (0.75, 0.8), (75, 120)),
                            ((56, 80), (0.8, 0.8), (70, 100))):
        samples.append(dict(
            img=rng.randn(h, w, 3).astype(np.float32),
            img_metas=dict(scale_factor=np.asarray(sf * 2, np.float32),
                           ori_shape=ori)))
    want = jax_run_test(jm, dict(params=variables["params"],
                                 batch_stats=variables["batch_stats"]),
                        samples, JaxCollator(), batch_size=2, rescale=True)
    got = run_test(tm, samples, DetCollator(), batch_size=2, rescale=True)
    assert len(got) == len(want) == 2
    for w, g, s in zip(want, got, samples):
        assert w["bboxes"].shape[0] > 10
        rows = _match((w["bboxes"], w["labels"]), (g["bboxes"], g["labels"]))
        ori = list(s["img_metas"]["ori_shape"])
        assert [m["size"] for m in g["masks"]] == [ori] * len(rows)
        assert [g["masks"][r] for r in rows] == w["masks"]
        assert any(jmask.rle_area(m) for m in w["masks"])

"""Mask R-CNN training: the port's mask targets, gt-mask collation and
train step against the JAX package's, on the same numpy inputs and the
same weights.

`mask_target` and the collated `gt_masks` are compared as arrays (equal).
The slice is one whole train step of the tiny Mask R-CNN of
tests/test_torch_mask.py (ResNet-50 at base_channels=8 with frozen_stages
1, FPN 16, 2 FCs of 32, 3 classes, an FCNMaskHead of 2 convolutions at 16
channels; both extractors take sampling_ratio=0, which becomes 2) on 2
images of 64x96 and 56x88 with an elliptical bitmask inside each gt box.
The port's weights go to JAX through tools/model_converters/torch2jax.py
(and the mask head by hand, tests/test_torch_weights.py), with `rpn_cls`
redrawn at std 0.3 so that the proposals stay off near-ties and
`conv_logits` at std 0.5 so that the mask loss's gradient is not ~1e-3 of
the rest. Both samplers get budgets of at least their candidate count
(tests/test_torch_train.py's TRAIN_CFG), so both sides sample every
candidate, and the mask branch's budget, num * pos_fraction, covers every
gathered roi: every positive is selected on both sides, in another order.
JAX runs its own make_train_step and build_optimizer behind a
transformation that keeps the raw gradients (one compile). Bars: every
loss, loss_mask included, within 1e-4 relative; each parameter's gradient
within 1e-4 of its max |grad|. Torch runs on one thread here.
"""
import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.engine.optimizer import \
    build_optimizer as jax_build_optimizer
from pointtinybenchmark_tpu.engine.train import \
    make_train_step as jax_make_train_step
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
from pointtinybenchmark_tpu_torch.engine.train import (
    batch_to_device, init_train_state, make_train_step)
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.roi_heads import standard_roi_head
from pointtinybenchmark_tpu_torch.models.roi_heads.mask_head import \
    mask_target
from pointtinybenchmark_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_torch_mask import MASK_CFG
from test_torch_train import (GT_BOXES, IGNORE, IMG_HW, IMG_SHAPES, MAX_GT,
                              MAX_IGNORE, OPTIMIZER, TRAIN_CFG)
from test_torch_weights import _mask_rcnn_to_jax

jmask = importlib.import_module(
    "pointtinybenchmark_tpu.models.roi_heads.mask_head")

# gt labels over the 3 classes
LABELS = ([0, 2, 1], [2, 0])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_cfg():
    cfg = copy.deepcopy(MASK_CFG)
    cfg["backbone"]["frozen_stages"] = 1
    cfg["rpn_head"].update(
        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0, 0, 0, 0],
                        target_stds=[1.0, 1.0, 1.0, 1.0]),
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0))
    cfg["roi_head"]["bbox_head"].update(
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0))
    return cfg


def ellipse_masks(boxes, hw):
    """(n, H, W) uint8: the ellipse inscribed in each box."""
    h, w = hw
    yy, xx = np.mgrid[:h, :w] + 0.5
    out = np.zeros((len(boxes), h, w), np.uint8)
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(boxes, np.float64)):
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        rx, ry = max((x2 - x1) / 2, 0.5), max((y2 - y1) / 2, 0.5)
        out[i] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
    return out


def _samples(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i, (h, w) in enumerate(IMG_SHAPES):
        boxes = np.asarray(GT_BOXES[i], np.float32)
        out.append(dict(img=rng.randn(h, w, 3).astype(np.float32),
                        gt_bboxes=boxes,
                        gt_labels=np.asarray(LABELS[i], np.int64),
                        gt_bboxes_ignore=np.asarray(IGNORE[i], np.float32),
                        gt_masks=ellipse_masks(boxes, (h, w))))
    return out


# ------------------------------------------------------------ the modules
@pytest.mark.parametrize("pad_shape,max_gt", [(None, 8), ((80, 128), 8),
                                              (None, 2)])
def test_collated_gt_masks_equal_jax(pad_shape, max_gt):
    """(B, max_gt, H_pad, W_pad) uint8, zero-padded, rows past max_gt cut:
    equal to the JAX collator's, with the size-divisor padding and a given
    pad shape."""
    samples = _samples()
    samples[1]["img"] = samples[1]["img"][:50, :70]
    samples[1]["gt_masks"] = samples[1]["gt_masks"][:, :50, :70]
    got = DetCollator(pad_shape, max_gt=max_gt)(samples)["gt_masks"]
    want = JaxCollator(pad_shape, max_gt=max_gt)(samples)["gt_masks"]
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_mask_target_equals_jax():
    """28x28 crops of gt bitmaps of 3 images x 4 gts into 60 rois near
    their gt, some off the image, thin, zero-area or inverted: equal to
    JAX's (0 or 1)."""
    rng = np.random.RandomState(5)
    b, g, h, w = 3, 4, 48, 64
    xy = rng.rand(b * g, 2) * [w - 20, h - 20]
    boxes = np.concatenate([xy, xy + 6 + rng.rand(b * g, 2) * 14], 1)
    gt_masks = ellipse_masks(boxes, (h, w)).reshape(b, g, h, w)
    # rois around their gt's box, as assigned proposals are
    r = 60
    bidx, inds = rng.randint(0, b, r), rng.randint(0, g, r)
    near = boxes[bidx * g + inds] + rng.uniform(-6, 6, (r, 4))
    rois = np.concatenate([bidx[:, None], near], 1).astype(np.float32)
    rois[0, 3] = rois[0, 1]                     # zero width
    rois[1, 3:5] = rois[1, 1:3] - 4             # inverted
    rois[2, 1:5] = [-20, -20, 90, 70]           # over every edge
    rois[3, 1:5] = [60, 2, 63.5, 46]            # thin, at the right edge
    want = np.asarray(jmask.mask_target(jnp.asarray(gt_masks),
                                        jnp.asarray(rois),
                                        jnp.asarray(inds), 28))
    got = mask_target(torch.from_numpy(gt_masks), torch.from_numpy(rois),
                      torch.from_numpy(inds), 28).numpy()
    assert got.dtype == np.float32 and got.shape == (r, 28, 28)
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def mask_pair():
    """(port model and its initial state_dict, the batch as numpy, JAX's
    first step: metrics and raw gradients as numpy)."""
    cfg = _model_cfg()
    model = build_detector(copy.deepcopy(cfg), TRAIN_CFG, None,
                           device="cpu", seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for m, std in ((model.rpn_head.rpn_cls, 0.3),
                       (model.roi_head.mask_head.conv_logits, 0.5)):
            m.weight.copy_(torch.from_numpy(
                (rng.randn(*m.weight.shape) * std).astype(np.float32)))
    params, stats = _mask_rcnn_to_jax(model)
    batch = DetCollator(IMG_HW, max_gt=MAX_GT,
                        max_gt_ignore=MAX_IGNORE)(_samples())
    jm = jax_build(copy.deepcopy(cfg), TRAIN_CFG, None)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    tx = optax.chain(keep, jax_build_optimizer(dict(OPTIMIZER), None, None,
                                               1, 1, by_epoch=False))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = dict(params=p,
                 batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                 opt_state=tx.init(p), step=jnp.int32(0),
                 nan_seen=jnp.bool_(False))
    jbatch = {k: jnp.asarray(batch[k]) for k in
              ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape",
               "gt_bboxes_ignore", "gt_ignore_valid", "gt_masks")}
    state, metrics = jax_make_train_step(jm, tx)(state, jbatch,
                                                 jax.random.PRNGKey(1))
    want = {k: float(v) for k, v in metrics.items()}
    grads = jax.tree_util.tree_map(np.asarray, state["opt_state"][0])
    return model, batch, want, grads


def test_train_step_losses_and_grads_match_jax(mask_pair, monkeypatch):
    """One step: every loss and metric within 1e-4 relative, every
    gradient within 1e-4 of its parameter's max |grad| (the mask head's
    and the frozen stem's included); the mask branch selects every
    positive on both sides."""
    model, batch, want, jgrads = mask_pair
    selected = []
    saved = standard_roi_head.StandardRoIHead._mask_loss

    def record(self, feats, boxes, labels, pos_w, *args):
        budget = args[-1]
        selected.append((pos_w.sum(1), min(budget, pos_w.shape[1])))
        return saved(self, feats, boxes, labels, pos_w, *args)
    monkeypatch.setattr(standard_roi_head.StandardRoIHead, "_mask_loss",
                        record)
    opt = build_optimizer(model, dict(OPTIMIZER), None, None, 1, 1,
                          frozen_stages=1, by_epoch=False)
    got = make_train_step(model, opt)(init_train_state("cpu"),
                                      batch_to_device(batch, "cpu"),
                                      torch.Generator().manual_seed(0))
    got = {k: float(v) for k, v in got.items()}
    assert set(got) == set(want) and "loss_mask" in got
    assert want["rpn_num_pos"] > 0 and want["rcnn_num_pos"] > 0
    # every positive within the mask branch's budget: per image on the
    # port's side, in all on JAX's (whose budget is the same)
    (pos_per_img, k), = selected
    assert (pos_per_img <= k).all() and want["rcnn_num_pos"] <= k
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    jg = jax_to_state_dict(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(jg) == set(grads)
    assert float(jg["roi_head.mask_head.convs.0.conv.weight"].abs().max()) > 0
    for name, g in grads.items():
        w = jg[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)

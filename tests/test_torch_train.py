"""Training: the port's modules and its train step against the JAX
package's, on the same numpy inputs and the same weights.

The modules (IoU, box encoding, MaxIoUAssigner, the losses, the anchor
head's targets, the lr schedule, `topk_mask`) are compared on the same
arrays. The samplers draw from different generators (torch.Generator vs
jax.random), so only their counts and budgets are held to JAX's rules.

The slice is one whole train step of the tiny Faster R-CNN of
tests/test_torch_slice.py (ResNet-50 at base_channels=8, FPN 16, 2 FCs of
32, frozen_stages=1) on 2 images of 64x96 with a few gts and one ignore
region, the port's weights carried to JAX by tools/model_converters/
torch2jax.py. Both samplers get budgets of at least their candidate count,
so both sides sample every candidate and the sampled sets are the same; the
RoI head's fixed-size gather then takes every roi, in an order that differs
(the sums run in another order). `rpn_cls` is redrawn (std 0.3, the same
numbers on both sides) so that the proposals stay off near-ties. JAX runs
its own engine/train.py::make_train_step with engine/optimizer.py::
build_optimizer and frozen_param_mask, behind a transformation that keeps
each step's raw gradients in the optimizer state. Tolerances: losses 1e-4
relative, each parameter's gradient within 1e-4 of that parameter's max
|grad|, each tensor's change over 3 steps within 1e-4 of the max |change|
of JAX's (plus an ulp of |p| a step); the frozen stem and layer1
bit-identical to their initial values. The clipped
trajectory takes JAX's gradients from the same compiled step and applies
build_optimizer's clipped chain to them with optax (one model compile per
module). Torch runs on one thread here: PyTorch's CPU scatter-add is then
deterministic, and small convolutions run far faster.
"""
import importlib
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pointtinybenchmark_tpu.engine.optimizer import \
    build_lr_schedule as jax_lr_schedule
from pointtinybenchmark_tpu.engine.optimizer import \
    build_optimizer as jax_build_optimizer
from pointtinybenchmark_tpu.engine.optimizer import frozen_param_mask
from pointtinybenchmark_tpu.engine.train import \
    make_train_step as jax_make_train_step
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.core.assigners import MaxIoUAssigner
from pointtinybenchmark_tpu_torch.core.bbox import bbox2delta
from pointtinybenchmark_tpu_torch.core.samplers import (RandomSampler,
                                                       topk_mask)
from pointtinybenchmark_tpu_torch.engine.checkpoint import load_checkpoint
from pointtinybenchmark_tpu_torch.engine.optimizer import (
    build_lr_schedule, build_optimizer, frozen_param_names)
from pointtinybenchmark_tpu_torch.engine.train import (
    batch_to_device, init_train_state, make_train_step, train_detector)
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.dense_heads.rpn_head import RPNHead
from pointtinybenchmark_tpu_torch.models.losses import (CrossEntropyLoss,
                                                        L1Loss, SmoothL1Loss)
from pointtinybenchmark_tpu_torch.models.roi_heads.standard_roi_head import \
    StandardRoIHead
from pointtinybenchmark_tpu_torch.ops.iou import bbox_overlaps
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_torch_slice import FRCNN_MODEL

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools",
                            "model_converters"))
from torch2jax import convert_detector_state_dict  # noqa: E402

jiou = importlib.import_module("pointtinybenchmark_tpu.ops.iou")
jbbox = importlib.import_module("pointtinybenchmark_tpu.core.bbox")
jassign = importlib.import_module("pointtinybenchmark_tpu.core.assigners")
jsamp = importlib.import_module("pointtinybenchmark_tpu.core.samplers")
jce = importlib.import_module(
    "pointtinybenchmark_tpu.models.losses.cross_entropy_loss")
jl1 = importlib.import_module(
    "pointtinybenchmark_tpu.models.losses.smooth_l1_loss")
janchor = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.anchor_head")

IMG_HW = (64, 96)
MAX_GT, MAX_IGNORE = 8, 2
PROPOSALS = 100                 # rpn_proposal max_per_img
# RPN: 3 anchors x 512 cells = 1,536 anchors an image, all within either
# budget of 2,048; RoI head: MAX_GT + PROPOSALS rois, all within 2 x that
TRAIN_CFG = dict(
    rpn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                           neg_iou_thr=0.3, min_pos_iou=0.3,
                           match_low_quality=True, ignore_iof_thr=0.5),
             sampler=dict(type="RandomSampler", num=4096, pos_fraction=0.5,
                          neg_pos_ub=-1, add_gt_as_proposals=False),
             allowed_border=-1, pos_weight=-1),
    rpn_proposal=dict(nms_pre=2000, max_per_img=PROPOSALS,
                      nms=dict(type="nms", iou_threshold=0.7),
                      min_bbox_size=0),
    rcnn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                            neg_iou_thr=0.5, min_pos_iou=0.5,
                            match_low_quality=False, ignore_iof_thr=-1),
              sampler=dict(type="RandomSampler",
                           num=2 * (MAX_GT + PROPOSALS), pos_fraction=0.5,
                           neg_pos_ub=-1, add_gt_as_proposals=True),
              pos_weight=-1))
OPTIMIZER = dict(type="SGD", lr=0.02, momentum=0.9, weight_decay=1e-4)
# the lr of steps 0, 1, 2: 0.002, 0.011, 0.002 (warmup, then the step)
LR_CONFIG = dict(policy="step", warmup="linear", warmup_iters=2,
                 warmup_ratio=0.1, step=[2])
GT_BOXES = ([[10.5, 8.0, 30.5, 36.0], [40.0, 20.0, 62.0, 52.0],
             [66.0, 4.0, 90.0, 26.0]],
            [[4.0, 30.0, 34.0, 58.0], [50.0, 6.0, 72.0, 30.0]])
GT_LABELS = ([0, 1, 0], [1, 0])
IGNORE = ([[70.0, 40.0, 90.0, 60.0]], [[0.0, 0.0, 16.0, 16.0]])
IMG_SHAPES = ((64, 96), (56, 88))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_cfg():
    ns = {}
    exec(FRCNN_MODEL, ns)
    cfg = ns["model"]
    cfg["backbone"]["frozen_stages"] = 1
    cfg["rpn_head"]["loss_bbox"] = dict(type="L1Loss", loss_weight=1.0)
    cfg["roi_head"]["bbox_head"]["loss_bbox"] = dict(type="L1Loss",
                                                     loss_weight=1.0)
    return cfg, ns["test_cfg"]


def _samples(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i, (h, w) in enumerate(IMG_SHAPES):
        out.append(dict(img=rng.randn(h, w, 3).astype(np.float32),
                        gt_bboxes=np.asarray(GT_BOXES[i], np.float32),
                        gt_labels=np.asarray(GT_LABELS[i], np.int64),
                        gt_bboxes_ignore=np.asarray(IGNORE[i], np.float32)))
    return out


def _batch():
    return DetCollator(IMG_HW, max_gt=MAX_GT, max_gt_ignore=MAX_IGNORE)(
        _samples())


def _to_jax(model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=50)
    assert not unmapped, unmapped
    return params, stats


# -------------------------------------------------------------- modules
def _boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * 40 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps_matches_jax(mode):
    """rtol 1e-6: the same operations, compiled by two frameworks."""
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[0] = b[0]                            # identical
    a[1] = [5, 5, 5, 9]                    # zero area
    b[2] = 0                               # padded row
    got = bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), mode)
    want = np.asarray(jiou.bbox_overlaps(jnp.asarray(a), jnp.asarray(b),
                                         mode))
    assert (want > 0.3).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_bbox2delta_matches_jax():
    rng = np.random.RandomState(1)
    p, g = _boxes(rng, 50), _boxes(rng, 50)
    p[0, 2] = p[0, 0]                      # zero width: floored at 1e-6
    args = ((0.0, 0.1, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2))
    got = bbox2delta(torch.from_numpy(p), torch.from_numpy(g), *args)
    want = np.asarray(jbbox.bbox2delta(jnp.asarray(p), jnp.asarray(g), *args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _iou_np(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter, inter / np.maximum(area(a)[:, None] + area(b)[None]
                                     - inter, 1e-6), area(a)


ASSIGNERS = {
    "rpn": dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                match_low_quality=True, ignore_iof_thr=0.5),
    "rcnn": dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                 match_low_quality=False, ignore_iof_thr=-1),
    "loose": dict(pos_iou_thr=0.6, neg_iou_thr=0.4, min_pos_iou=0.2,
                  match_low_quality=True, ignore_iof_thr=0.3),
}


@pytest.mark.parametrize("name", sorted(ASSIGNERS))
def test_max_iou_assigner_matches_jax(name):
    """Exactly equal assignments and labels, on boxes whose IoU with every
    gt and IoF with every ignore region lie at least 1e-3 from every
    threshold; padded gt rows, invalid boxes, low-quality matches."""
    cfg = ASSIGNERS[name]
    thrs = [cfg["pos_iou_thr"], cfg["min_pos_iou"], cfg["ignore_iof_thr"]]
    thrs.append(cfg["neg_iou_thr"])
    rng = np.random.RandomState(2)
    b, n = 2, 300
    gts = np.zeros((b, 6, 4), np.float32)
    gv = np.zeros((b, 6), bool)
    gts[:, :4] = _boxes(rng, 8).reshape(2, 4, 4)
    gv[0, :4], gv[1, :3] = True, True
    labels = rng.randint(0, 3, (b, 6)).astype(np.int32)
    ign = _boxes(rng, 2).reshape(2, 1, 4)
    boxes = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        cand = np.concatenate([_boxes(rng, 4000), gts[i, :2] + 0.5])
        _, iou, _ = _iou_np(cand, gts[i][gv[i]])
        inter, _, area = _iou_np(cand, ign[i])
        iof = inter / np.maximum(area[:, None], 1e-6)
        near = np.zeros(len(cand), bool)
        for t in thrs:
            near |= (np.abs(iou - t) < 1e-3).any(1)
            near |= (np.abs(iof - t) < 1e-3).any(1)
        keep = cand[~near]
        boxes[i] = np.concatenate([keep[-2:], keep[:n - 2]])
    valid = rng.rand(b, n) > 0.1
    got = MaxIoUAssigner(**cfg).assign(
        torch.from_numpy(boxes), torch.from_numpy(gts), torch.from_numpy(gv),
        torch.from_numpy(labels), torch.from_numpy(ign),
        torch.ones((b, 1), dtype=torch.bool), torch.from_numpy(valid))
    ja = jax.jit(jassign.MaxIoUAssigner(**cfg).assign)
    for i in range(b):
        want = ja(jnp.asarray(boxes[i]), jnp.asarray(gts[i]),
                  jnp.asarray(gv[i]), jnp.asarray(labels[i]),
                  jnp.asarray(ign[i]), jnp.ones((1,), bool),
                  jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
    a = got[0].numpy()
    assert (a > 0).sum() and (a == 0).sum() and (a == -1).sum()


@pytest.mark.parametrize("make", [
    lambda: MaxIoUAssigner(0.5, (0.1, 0.4)),
    lambda: MaxIoUAssigner(0.5, 0.4, gt_max_assign_all=False),
    lambda: RandomSampler(256, 0.5, neg_pos_ub=3),
    lambda: build_optimizer(torch.nn.Linear(2, 2), dict(
        type="SGD", lr=0.1, nesterov=True)),
])
def test_unported_options_raise(make):
    """Options no ported config sets raise instead of running another
    algorithm than the config asks for."""
    with pytest.raises(NotImplementedError):
        make()


def test_losses_match_jax():
    """Sigmoid (background label C = the all-zero row) and softmax
    cross-entropy, L1 and smooth L1, with weights and avg_factor; rtol
    1e-6."""
    rng = np.random.RandomState(3)
    pred = (rng.randn(50, 3) * 3).astype(np.float32)
    label = rng.randint(0, 4, 50)
    w = rng.rand(50).astype(np.float32)
    box = rng.randn(50, 4).astype(np.float32)
    tgt = rng.randn(50, 4).astype(np.float32)
    bw = (rng.rand(50, 1) > 0.5).astype(np.float32)
    t = torch.from_numpy
    cases = [
        (CrossEntropyLoss(use_sigmoid=True)(t(pred), t(label), t(w),
                                            avg_factor=17.0),
         jce.CrossEntropyLoss(use_sigmoid=True)(
             jnp.asarray(pred), jnp.asarray(label), jnp.asarray(w),
             avg_factor=17.0)),
        (CrossEntropyLoss()(t(pred), t(label % 3), t(w), avg_factor=9.0),
         jce.CrossEntropyLoss()(jnp.asarray(pred), jnp.asarray(label % 3),
                                jnp.asarray(w), avg_factor=9.0)),
        (L1Loss(loss_weight=2.0)(t(box), t(tgt), t(bw), avg_factor=5.0),
         jl1.L1Loss(loss_weight=2.0)(jnp.asarray(box), jnp.asarray(tgt),
                                     jnp.asarray(bw), avg_factor=5.0)),
        (SmoothL1Loss(beta=0.5)(t(box), t(tgt), t(bw), avg_factor=0.0),
         jl1.SmoothL1Loss(beta=0.5)(jnp.asarray(box), jnp.asarray(tgt),
                                    jnp.asarray(bw), avg_factor=0.0)),
        (L1Loss()(t(box), t(tgt)), jl1.L1Loss()(jnp.asarray(box),
                                                 jnp.asarray(tgt))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("allowed_border", [-1, 0])
def test_anchor_head_targets_match_jax(allowed_border):
    """The RPN's flat anchors, their validity and its targets (labels,
    label weights, encoded boxes, positives) at the tiny model's feature
    sizes, with padded gts and an ignore region, equal to JAX's."""
    model_cfg, _ = _model_cfg()
    head_cfg = dict(model_cfg["rpn_head"])
    head_cfg.pop("type")
    train_cfg = dict(TRAIN_CFG["rpn"], allowed_border=allowed_border)
    port = RPNHead(train_cfg=train_cfg, **head_cfg)
    jh = janchor.AnchorHead(train_cfg=train_cfg, **head_cfg)
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    pad = (60, 90)
    anchors, valid = port.flat_anchors(sizes, pad, torch.device("cpu"))
    ja, jv = jh.flat_anchors(sizes, pad)
    np.testing.assert_array_equal(anchors.numpy(), ja)
    np.testing.assert_array_equal(valid.numpy(), jv)
    batch = _batch()
    batch["gt_labels"] = np.zeros_like(batch["gt_labels"])
    tb = batch_to_device(batch, "cpu")
    got = port.get_targets(anchors, valid, tb)
    want = jax.jit(lambda b: jh.get_targets(ja, jv, b))(
        {k: jnp.asarray(v.numpy()) for k, v in tb.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert got[3].sum() > 0


@pytest.mark.parametrize("lr_config,by_epoch", [
    (dict(policy="step", warmup="linear", warmup_iters=500,
          warmup_ratio=0.001, step=[8, 11]), True),       # schedule_1x
    (dict(policy="step", warmup="constant", warmup_iters=50,
          warmup_ratio=0.3, step=[120, 400], gamma=0.5), False),
    (dict(policy="cosine", warmup="linear", warmup_iters=100,
          warmup_ratio=0.01, min_lr=1e-4), True),
    (None, True),
])
def test_lr_schedule_matches_jax(lr_config, by_epoch):
    """600 steps at 50 iterations an epoch, float32 both sides; rtol 1e-5
    (the two libraries' float32 cos differ in the last bits)."""
    args = (0.02, lr_config, 50, 12, by_epoch)
    steps = np.arange(600)
    got = build_lr_schedule(*args)(torch.from_numpy(steps)).numpy()
    want = np.asarray(jax_lr_schedule(*args)(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(np.unique(want)) > 2 or lr_config is None


def test_topk_mask_matches_jax_on_ties():
    """Priorities on a coarse grid (many ties), NaN and -inf, k from 0 to
    past the length: the same entries as JAX's, ties to the lower index,
    NaN and -inf taken last."""
    rng = np.random.RandomState(4)
    pr = (rng.randint(0, 8, 200) / 8.0).astype(np.float32)
    pr[::17] = np.nan
    pr[::23] = -np.inf
    for k in (0, 1, 5, 40, 100, 190, 200, 250):
        got = topk_mask(torch.from_numpy(pr), k).numpy()
        want = np.asarray(jsamp.topk_mask(jnp.asarray(pr), k))
        np.testing.assert_array_equal(got, want)
        if k <= np.isfinite(pr).sum():
            assert not got[~np.isfinite(pr)].any()


@pytest.mark.parametrize("n_pos,n_neg", [(300, 2000), (40, 2000), (40, 60),
                                         (0, 500)])
def test_sampler_budgets_follow_jax(n_pos, n_neg):
    """The counts of both samplers at the config's budgets. RandomSampler
    (RPN, 256 @ 0.5): min(positives, 128) positives and min(negatives,
    256 - 128) negatives, the static negative budget, whatever the
    positives (JAX samplers.py:92) - held against JAX's own sampler. The
    RoI head's (512 @ 0.25, gts prepended): min(positives, 128), then
    min(negatives, 512 - that) (standard_roi_head.py:150-158)."""
    rng = np.random.RandomState(5)
    a = np.concatenate([rng.randint(1, 4, n_pos), np.zeros(n_neg, int),
                        -np.ones(50, int)])
    a = np.stack([rng.permutation(a) for _ in range(2)])
    gen = torch.Generator().manual_seed(0)
    res = RandomSampler(256, 0.5).sample(gen, torch.from_numpy(a),
                                         torch.from_numpy(a))
    jsample = jax.jit(jsamp.RandomSampler(256, 0.5).sample)
    for i in range(2):
        jr = jsample(jax.random.PRNGKey(i), jnp.asarray(a[i]),
                     jnp.asarray(a[i]))
        for got, want, cand in ((res.pos_mask[i], jr.pos_mask, a[i] > 0),
                                (res.neg_mask[i], jr.neg_mask, a[i] == 0)):
            assert int(got.sum()) == int(np.asarray(want).sum()) == min(
                cand.sum(), 128)
            assert not (got.numpy() & ~cand).any()
    pos, neg = StandardRoIHead._sample(torch.from_numpy(a), 512, 128, gen)
    want_pos = min(n_pos, 128)
    assert pos.sum(1).tolist() == [want_pos] * 2
    assert neg.sum(1).tolist() == [min(n_neg, 512 - want_pos)] * 2
    assert not (pos & neg).any() and not (pos.numpy() & (a <= 0)).any()


# ------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def slice_pair():
    """(port model, its initial state_dict, JAX model, JAX params and
    batch stats as numpy, the batch as numpy, the compiled JAX step with
    its optimizer)."""
    model_cfg, test_cfg = _model_cfg()
    model = build_detector(dict(model_cfg), TRAIN_CFG, test_cfg,
                           device="cpu", seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        w = model.rpn_head.rpn_cls.weight
        w.copy_(torch.from_numpy((rng.randn(*w.shape) * 0.3)
                                 .astype(np.float32)))
    params, stats = _to_jax(model)
    jm = jax_build(dict(model_cfg), TRAIN_CFG, test_cfg)
    # keeps the step's raw gradients as its state
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    tx = optax.chain(keep, jax_build_optimizer(
        dict(OPTIMIZER), None, LR_CONFIG, 1, 3,
        param_mask=frozen_param_mask(params, 1), by_epoch=False))
    step = jax_make_train_step(jm, tx)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    return model, init, params, stats, _batch(), step, tx


def _jax_state(params, stats, tx):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    return dict(params=p, batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             stats),
                opt_state=tx.init(p), step=jnp.int32(0),
                nan_seen=jnp.bool_(False))


def _jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in
            ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape",
             "gt_bboxes_ignore", "gt_ignore_valid")}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_run(slice_pair, grad_clip, steps):
    """The port's steps from the initial weights: (metrics of each step,
    gradients of the first, the model)."""
    model, init, _, _, batch, _, _ = slice_pair
    model.load_state_dict(init)
    opt = build_optimizer(model, dict(OPTIMIZER),
                          dict(grad_clip=grad_clip) if grad_clip else None,
                          LR_CONFIG, 1, 3, frozen_stages=1, by_epoch=False)
    step = make_train_step(model, opt)
    state = init_train_state("cpu")
    gen = torch.Generator().manual_seed(0)
    tb = batch_to_device(batch, "cpu")
    metrics, grads = [], None
    for _ in range(steps):
        metrics.append({k: float(v) for k, v in step(state, tb, gen).items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert int(state["step"]) == steps and int(opt.count) == steps
    return metrics, grads, model


@pytest.fixture(scope="module")
def jax_no_clip(slice_pair):
    """JAX's make_train_step, 3 steps: (metrics of each step, gradients of
    the first, final params) as numpy."""
    _, init, params, stats, batch, step, tx = slice_pair
    state = _jax_state(params, stats, tx)
    metrics, grads = [], None
    for _ in range(3):
        state, m = step(state, _jax_batch(batch), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = _np_tree(state["opt_state"][0])
    return metrics, grads, _np_tree(state["params"])


def test_train_step_losses_and_grads_match_jax(slice_pair, jax_no_clip):
    want, jgrads, _ = jax_no_clip
    got, grads, model = _port_run(slice_pair, None, 1)
    want, got = want[0], got[0]
    assert set(got) == set(want)
    assert want["rpn_num_pos"] > 0 and want["rcnn_num_pos"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jg = jax_to_state_dict(jgrads)
    assert set(jg) == set(grads)
    for name, g in grads.items():
        w = jg[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)
    frozen = frozen_param_names(model, 1)
    assert any(np.abs(jg[n].numpy()).max() > 0 for n in frozen)


@pytest.mark.parametrize("clip", [False, True])
def test_three_steps_match_jax(slice_pair, jax_no_clip, clip):
    """Each tensor's change over 3 steps (warmup lr, momentum, weight decay
    and, in the second case, grad_clip max_norm=1, which binds: the
    gradients' global norm is above 1) within 1e-4 of the max |change| of
    JAX's plus an ulp of the tensor's max |value| a step (the float32
    rounding of p + update); a tensor JAX leaves as it was stays
    bit-identical. Weight decay moves a parameter by ~2.8e-6 |p| here, far
    below 1e-4 of its max |value| but not below this bar. The frozen stem
    and layer1
    bit-identical to their initial values, every other parameter
    changed."""
    _, init, params, stats, batch, step, tx = slice_pair
    if not clip:
        want_params = jax_no_clip[2]
    else:
        # JAX's gradients at each point of the clipped trajectory from the
        # compiled step, JAX's clipped optimizer applied to them
        tx_clip = jax_build_optimizer(
            dict(OPTIMIZER), dict(grad_clip=dict(max_norm=1.0)), LR_CONFIG,
            1, 3, param_mask=frozen_param_mask(params, 1), by_epoch=False)
        @jax.jit
        def update(g, s, q):
            upd, s = tx_clip.update(g, s, q)
            return optax.apply_updates(q, upd), s

        def apply(g, s, q):
            q, apply.state = update(g, s, jax.tree_util.tree_map(jnp.asarray,
                                                                 q))
            return q

        p = params
        opt_state = tx_clip.init(jax.tree_util.tree_map(jnp.asarray, p))
        for i in range(3):
            state, _ = step(_jax_state(p, stats, tx), _jax_batch(batch),
                            jax.random.PRNGKey(1))
            g = state["opt_state"][0]
            if i == 0:
                assert float(optax.global_norm(g)) > 1.0
            p = _np_tree(apply(g, opt_state, p))
            opt_state = apply.state
        want_params = p
    _, _, model = _port_run(slice_pair, dict(max_norm=1.0) if clip else None,
                            3)
    got = model.state_dict()
    want = jax_to_state_dict(want_params, stats)
    frozen = set(frozen_param_names(model, 1))
    for name, w in want.items():
        w = w.numpy()
        change = np.abs(w - init[name].numpy()).max()
        # plus the float32 rounding of p + update, an ulp of |p| a step
        ulps = 3 * np.spacing(np.abs(w).max()) if change else 0.0
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= 1e-4 * change + ulps, (name, err, change)
    for name, _ in model.named_parameters():
        if name in frozen:
            assert torch.equal(got[name], init[name]), name
        else:
            assert not torch.equal(got[name], init[name]), name


# ----------------------------------------------------- the training loop
def _loop_cfg(max_iters, shuffle=True):
    return dict(data=dict(samples_per_gpu=1, shuffle=shuffle),
                loader=dict(pad_shape=IMG_HW, max_gt=MAX_GT,
                            max_gt_ignore=MAX_IGNORE),
                runner=dict(type="IterBasedRunner", max_iters=max_iters),
                optimizer=dict(OPTIMIZER), optimizer_config=dict(),
                lr_config=dict(LR_CONFIG), log_config=dict(interval=1),
                checkpoint_config=dict(interval=1),
                check=dict(stop_while_nan=True))


def _fresh_model():
    model_cfg, test_cfg = _model_cfg()
    return build_detector(dict(model_cfg), TRAIN_CFG, test_cfg, device="cpu",
                          seed=0)


def test_train_detector_logs_checkpoints_and_resumes(tmp_path):
    """2 iterations of IterBasedRunner write log.json (one entry per step)
    and a checkpoint per iteration with the latest pointer; resume_from
    continues from the saved step, to the same parameters (within 1e-5 of
    each tensor's max: the RoI gather's order, hence the sums', differs)
    as 3 straight iterations."""
    data = _samples()
    straight = train_detector(_fresh_model(), data, _loop_cfg(3),
                              str(tmp_path / "straight"), device="cpu")
    work = tmp_path / "run"
    first = train_detector(_fresh_model(), data, _loop_cfg(2), str(work),
                           device="cpu")
    log = [json.loads(line) for line in open(work / "log.json")]
    assert [e["step"] for e in log] == [1, 2]
    assert all(np.isfinite(e["loss"]) and e["nan_seen"] == 0 for e in log)
    assert (work / "iter_1.pth").exists() and (work / "iter_2.pth").exists()
    latest = work / "latest.pth"
    assert osp.realpath(latest) == osp.realpath(work / "iter_2.pth")
    ck = load_checkpoint(str(latest))
    assert int(ck["state"]["step"]) == 2 and int(ck["optimizer"]["count"]) == 2
    assert ck["meta"] == dict(epoch=1, iter=2)
    assert int(first["state"]["step"]) == 2

    resumed = train_detector(_fresh_model(), data, _loop_cfg(3), str(work),
                             resume_from=str(latest), device="cpu")
    assert [e["step"] for e in resumed["history"]] == [3]
    assert int(resumed["state"]["step"]) == 3
    want = straight["model"].state_dict()
    for k, v in resumed["model"].state_dict().items():
        err = float((v - want[k]).abs().max())
        assert err <= 1e-5 * max(float(want[k].abs().max()), 1e-30), k


def test_train_detector_nan_exits_254_with_last_finite_params(tmp_path):
    """A NaN image makes the second step's loss NaN: under stop_while_nan
    the loop exits with 254, and the parameters are those after the first
    step (the update of the NaN step was skipped)."""
    data = _samples()
    data[1]["img"] = data[1]["img"].copy()
    data[1]["img"][5, 5, 0] = np.nan
    one = train_detector(_fresh_model(), data[:1], _loop_cfg(1, False),
                         str(tmp_path / "one"), device="cpu")
    model = _fresh_model()
    with pytest.raises(SystemExit) as e:
        train_detector(model, data, _loop_cfg(2, False), str(tmp_path / "nan"),
                       device="cpu")
    assert e.value.code == 254
    log = [json.loads(line) for line in open(tmp_path / "nan" / "log.json")]
    assert log[-1]["nan_seen"] == 1 and not np.isfinite(log[-1]["loss"])
    want = one["model"].state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k

"""Grid R-CNN and Libra R-CNN's two modules: the port against the JAX
package on the same numpy inputs and weights.

- `grid_targets` bit-equal on rois whose lattice points fall inside,
  outside and on the map's edges;
- `grid_refine_boxes` within 1e-5, on random maps and on maps with equal
  maxima (both take the first);
- `GridHead` (2 convs at 72 channels, GroupNorm of 36 groups, 8-channel
  point features) from the JAX init through utils/jax_weights.py:
  heat-map logits within 1e-4 of their max;
- the grid loss of the toy detector's train step below: the port's
  `grid_loss` fed the JAX head's FPN maps, sampled rois, positive weights
  and matched gts (recorded from JAX's own `forward_train` by a subclass
  registered under another name) and JAX's own draws (the jitter and
  priority keys JAX derives from the head's rng, drawn here with
  jax.random), loss within 1e-5 relative, the grid head's gradients within
  1e-4 of each parameter's max;
- one train step of a toy Grid R-CNN (ResNet-18 at base 8, FPN 16, 2 FCs
  of 32, the grid head above) on two 64x96 images, both samplers taking
  every candidate (as tests/test_torch_train.py) and `rpn_cls` redrawn
  (std 0.3) to keep the proposals off near-ties: the port's step through
  engine/train.py with each of its gathered rois given the jitter and
  priority JAX drew for the same roi (matched by image and box), every
  loss within 1e-4 relative, every gradient within 1e-4 of its
  parameter's max, and the grid rois carrying no gradient (the
  roi-coordinate kernel's path unused); at most 96 positives, so that
  the grid rois are chosen by the positive weights;
- the toy detector's tiled protocol on a 128x192 frame (9 tiles of 64x96):
  detections at tests/test_detector_golden.py:88's tolerances, `rpn_cls`
  and `fc_cls` redrawn (std 0.3 and 0.1, the same numbers on both sides)
  to spread the scores (0.02-0.33 on the first tile);
- the full-width config builds with the JAX model's parameter tree;
- BFP within 1e-5 on levels of a 64x96 input and of a 100x76 one, whose
  sizes do not halve evenly; BalancedL1Loss and its gradient at |x| = 0,
  at |x| = beta and elsewhere; Libra R-CNN's list neck refused by the
  port's `build_detector`, as the JAX package's fails on it.

The JAX functions are compiled once each, in module fixtures; those
whose gradients are compared with XLA's optimisations, the rest without
its backend optimisations (FAST_COMPILE). Torch runs on one thread.
"""
import copy
import importlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.engine.test import \
    DeviceTiledInference as JaxTiled
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu.utils.registry import HEADS as JAX_HEADS
from pointtinybenchmark_tpu_torch.apis.inference import (
    inference_detector_tiled, init_detector)
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
from pointtinybenchmark_tpu_torch.engine.train import (
    batch_to_device, init_train_state, make_train_step)
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.losses import BalancedL1Loss
from pointtinybenchmark_tpu_torch.models.necks.extra_necks import BFP
from pointtinybenchmark_tpu_torch.models.roi_heads import grid_roi_head
from pointtinybenchmark_tpu_torch.models.roi_heads.grid_roi_head import (
    GridHead, grid_refine_boxes, grid_targets)
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    _torch_key, jax_to_state_dict, load_jax_variables)
from test_torch_slice import _assert_dets_match, _dets

jgrid = importlib.import_module(
    "pointtinybenchmark_tpu.models.roi_heads.grid_roi_head")
jnecks = importlib.import_module(
    "pointtinybenchmark_tpu.models.necks.extra_necks")
jl1 = importlib.import_module(
    "pointtinybenchmark_tpu.models.losses.smooth_l1_loss")

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
C, HS = 16, 56                          # FPN width; heat map of 14 x 4
# 72 channels: GroupNorm of 36 groups (the configs' rule) of 2 channels.
# At 36 (groups of one channel) the init's near-constant BCE gradient,
# which the GroupNorms project out, leaves the convolutions' gradients as
# small differences whose float32 rounding is 4e-4 of their max in both
# packages against float64
GRID_HEAD = dict(type="GridHead", grid_points=9, num_convs=2, in_channels=C,
                 feat_channels=72, point_feat_channels=8)
EXTRACTOR = dict(roi_layer=dict(type="RoIAlign", output_size=7,
                                sampling_ratio=1),
                 out_channels=C, featmap_strides=[4, 8, 16, 32])
GRID_EXTRACTOR = dict(roi_layer=dict(type="RoIAlign", output_size=14,
                                     sampling_ratio=0),
                      out_channels=C, featmap_strides=[4, 8, 16, 32])
BBOX_HEAD = dict(type="Shared2FCBBoxHead", num_classes=1, in_channels=C,
                 fc_out_channels=32, roi_feat_size=7,
                 bbox_coder=dict(type="DeltaXYWHBBoxCoder",
                                 target_means=[0, 0, 0, 0],
                                 target_stds=[0.1, 0.1, 0.2, 0.2]),
                 loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False),
                 loss_bbox=dict(type="L1Loss", loss_weight=1.0))
MODEL = dict(
    type="GridRCNN",
    backbone=dict(type="ResNet", depth=18, base_channels=8, frozen_stages=1,
                  norm_eval=True),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=C,
              num_outs=5),
    rpn_head=dict(
        type="RPNHead", num_classes=1, in_channels=C, feat_channels=C,
        anchor_generator=dict(type="AnchorGenerator", scales=[2],
                              ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0, 0, 0, 0],
                        target_stds=[1.0, 1.0, 1.0, 1.0]),
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0)),
    roi_head=dict(type="GridRoIHead", bbox_roi_extractor=EXTRACTOR,
                  bbox_head=BBOX_HEAD, grid_roi_extractor=GRID_EXTRACTOR,
                  grid_head=GRID_HEAD))
IMG_HW = (64, 96)
MAX_GT = 8
PROPOSALS = 60
RCNN_TRAIN = dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                                neg_iou_thr=0.5, min_pos_iou=0.5,
                                match_low_quality=False, ignore_iof_thr=-1),
                  sampler=dict(type="RandomSampler",
                               num=2 * (MAX_GT + PROPOSALS),
                               pos_fraction=0.5, neg_pos_ub=-1,
                               add_gt_as_proposals=True),
                  pos_weight=-1)
# both samplers' budgets cover every candidate (tests/test_torch_train.py)
TRAIN_CFG = dict(
    rpn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                           neg_iou_thr=0.3, min_pos_iou=0.3,
                           match_low_quality=True, ignore_iof_thr=-1),
             sampler=dict(type="RandomSampler", num=4096, pos_fraction=0.5,
                          neg_pos_ub=-1, add_gt_as_proposals=False),
             allowed_border=-1, pos_weight=-1),
    rpn_proposal=dict(nms_pre=2000, max_per_img=PROPOSALS,
                      nms=dict(type="nms", iou_threshold=0.7),
                      min_bbox_size=0),
    rcnn=RCNN_TRAIN)
TEST_CFG = dict(
    rpn=dict(nms_pre=4000, max_per_img=200,
             nms=dict(type="nms", iou_threshold=0.7), min_bbox_size=0),
    rcnn=dict(score_thr=0.05, nms=dict(type="nms", iou_threshold=0.5),
              max_per_img=40))
GT_BOXES = ([[10.5, 8.0, 30.5, 36.0], [40.0, 20.0, 62.0, 52.0],
             [66.0, 4.0, 90.0, 26.0]],
            [[4.0, 30.0, 34.0, 58.0], [50.0, 6.0, 72.0, 30.0]])
LIBRA = "configs/tinyperson/libra_faster_rcnn_r50_fpn_1x_tinyperson640.py"
GRID = "configs/tinyperson/grid_rcnn_r50_fpn_1x_tinyperson640.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fast(fn, *args):
    """fn jitted and compiled once without XLA's backend optimisations."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def _exact(fn, *args):
    """fn jitted with XLA's optimisations: the gradients' reference. At
    FAST_COMPILE, JAX's float32 gradients of the grid head's convolutions
    lie up to 5e-4 of their max from float64 (the port's within 5e-6)."""
    return jax.jit(fn).lower(*args).compile()


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


class RecordingGridRoIHead(jgrid.GridRoIHead):
    """JAX's GridRoIHead, which also sows the sampled rois, their positive
    weights and matched gt indices (its `_last_sample`), the rng of its
    `forward_train` and the FPN maps it got into "intermediates"."""

    def forward_train(self, feats, proposals, prop_valid, batch, rng):
        out = super().forward_train(feats, proposals, prop_valid, batch, rng)
        self.sow("intermediates", "sample", self._last_sample + (rng,))
        self.sow("intermediates", "feats", tuple(feats))
        return out


JAX_HEADS.register_module(name="RecordingGridRoIHead",
                          module=RecordingGridRoIHead, force=True)


def _jax_draws(rng, n):
    """The jitter (n, 4) and priorities (n,) the JAX head draws from the
    rng its forward_train gets (grid_roi_head.py:140-157)."""
    _, key = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(key, (n, 4), minval=-0.15,
                                          maxval=0.15)),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 3), (n,))))


def _sub_state_dict(params, prefix):
    """A JAX subtree's tensors under the port's names, `prefix` dropped."""
    sd = jax_to_state_dict(params)
    return {k[len(prefix):]: v for k, v in sd.items()}


# ------------------------------------------------------ pure functions
def test_grid_targets_bit_equal():
    rng = np.random.RandomState(0)
    n = 40
    xy = rng.rand(n, 2) * 60
    wh = rng.rand(n, 2) * 30 + 1
    rois = np.concatenate([np.zeros((n, 1)), xy, xy + wh], 1)
    gts = rois[:, 1:] + rng.randn(n, 4) * wh.repeat(2, 0).reshape(n, 4) * 0.3
    gts[:5] = rois[:5, 1:]                       # the points on the edges
    gts[5:8] = rois[5:8, 1:] + 100               # every point outside
    rois[8, 3] = rois[8, 1]                      # zero width: floored
    rois, gts = rois.astype(np.float32), gts.astype(np.float32)
    want = np.asarray(jax.jit(jgrid.grid_targets, static_argnums=2)(
        jnp.asarray(rois), jnp.asarray(gts), HS))
    got = grid_targets(_t(rois), _t(gts), HS).permute(0, 2, 3, 1).numpy()
    assert want.sum() > 0 and not want[5:8].any()
    assert np.array_equal(got, want)


def test_grid_refine_boxes_matches_jax_with_ties():
    """Within 1e-5 (the edges' sums of three products); maps whose maximum
    is reached twice or on a whole row refine to the first maximum in
    y * W + x order, in both."""
    rng = np.random.RandomState(1)
    n = 12
    heat = rng.rand(n, HS, HS, 9).astype(np.float32)
    heat[0, 3, 40, 0] = heat[0, 20, 2, 0] = 2.0          # two maxima
    heat[1, 10, :, 4] = 3.0                              # a row of them
    heat[2, :, 7, 8] = 3.0                               # a column
    heat[3] = 0.5                                        # all equal
    xy = rng.rand(n, 2) * 100
    rois = np.concatenate([np.zeros((n, 1)), xy,
                           xy + rng.rand(n, 2) * 40 + 1], 1).astype(np.float32)
    want = np.asarray(jax.jit(jgrid.grid_refine_boxes)(jnp.asarray(rois),
                                                        jnp.asarray(heat)))
    got = grid_refine_boxes(_t(rois), _t(heat).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_head_forward_matches_jax():
    head = dict(GRID_HEAD)
    head.pop("type")
    jhead = jgrid.GridHead(**head)
    x = jnp.asarray(np.random.RandomState(2).randn(6, 14, 14, C).astype(
        np.float32))

    def init_apply(r, a):
        v = jhead.init(r, a)
        return v, jhead.apply(v, a)

    variables, want = _np(_fast(init_apply, jax.random.PRNGKey(0), x)(
        jax.random.PRNGKey(0), x))
    port = GridHead(**head)
    port.load_state_dict(_sub_state_dict(
        {"roi_head_m": {"grid_head_m": variables["params"]}},
        "roi_head.grid_head."))
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (6, HS, HS, 9)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ----------------------------------------------------- the detector
def _jax_model(roi_type="GridRoIHead", train=True):
    cfg = copy.deepcopy(MODEL)
    cfg["roi_head"]["type"] = roi_type
    return jax_build(cfg, TRAIN_CFG if train else None, TEST_CFG)


def _jax_tree(model, shapes):
    """The port model's weights as the JAX model's variables (`shapes`,
    from jax.eval_shape of its init): the inverse of
    utils/jax_weights.py's layouts, checked by loading them back into
    another seed's model with `load_jax_variables`."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    n_lat = len(model.neck.lateral_convs)
    s = model.roi_head.bbox_head.roi_feat_size

    def leaf(path, shape):
        path = tuple(str(getattr(k, "key", k)) for k in path)
        arr = sd[_torch_key(path, n_lat, basic=True)]
        if path[-1] == "kernel" and re.fullmatch(r"upsample|deconv[12]_\d+",
                                                 path[-2]):
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif path[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif path[-1] == "kernel" and path[-2] == "shared_fc0":
            o = arr.shape[0]
            arr = arr.reshape(o, -1, s, s).transpose(2, 3, 1, 0).reshape(-1, o)
        elif path[-1] == "kernel":
            arr = arr.T
        assert arr.shape == shape.shape, path
        return np.ascontiguousarray(arr)

    tree = {k: jax.tree_util.tree_map_with_path(leaf, shapes[k])
            for k in ("params", "batch_stats")}
    back = build_detector(copy.deepcopy(MODEL), device="cpu", seed=1)
    load_jax_variables(back, tree["params"], tree["batch_stats"])
    assert all(np.array_equal(v.numpy(), sd[k])
               for k, v in back.state_dict().items())
    return tree


@pytest.fixture(scope="module")
def detector_pair():
    """The port's seeded toy detector, `rpn_cls` and `fc_cls` redrawn, and
    the same weights as the JAX model's variables."""
    model = build_detector(copy.deepcopy(MODEL), TRAIN_CFG, TEST_CFG,
                           device="cpu", seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for m, std in ((model.rpn_head.rpn_cls, 0.3),
                       (model.roi_head.bbox_head.fc_cls, 0.1)):
            m.weight.copy_(_t(rng.randn(*m.weight.shape) * std))
            m.bias.zero_()
    shapes = jax.eval_shape(lambda r, x: _jax_model().init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1,) + IMG_HW + (3,), jnp.float32))
    return model, _jax_tree(model, shapes)


def _batch():
    rng = np.random.RandomState(4)
    samples = [dict(img=rng.randn(*IMG_HW, 3).astype(np.float32),
                    gt_bboxes=np.asarray(b, np.float32),
                    gt_labels=np.zeros(len(b), np.int64))
               for b in GT_BOXES]
    return DetCollator(IMG_HW, max_gt=MAX_GT)(samples)


def _match(rois, ref):
    """For each port roi the row of the JAX roi of the same image nearest
    to it (within 1e-3 px)."""
    out = np.empty(len(rois), np.int64)
    for i, r in enumerate(rois):
        d = np.abs(ref[:, 1:] - r[1:]).max(1) + 1e9 * (ref[:, 0] != r[0])
        out[i] = np.argmin(d)
        assert d[out[i]] <= 1e-3, (i, r, ref[out[i]])
    return out


@pytest.fixture(scope="module")
def jax_step(detector_pair):
    """JAX's losses and gradients of one step of the toy detector on
    `_batch()`, with the recorded sample and FPN maps."""
    _, variables = detector_pair
    batch = _batch()
    jm = _jax_model("RecordingGridRoIHead")
    jbatch = {k: jnp.asarray(batch[k]) for k in
              ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape")}

    def loss_fn(p, stats, b, r):
        losses, mut = jm.apply({"params": p, "batch_stats": stats}, b["img"],
                               b, method=jm.forward_train,
                               mutable=["batch_stats", "intermediates"],
                               rngs={"sampler": r})
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        return total, (losses, mut["intermediates"]["roi_head_m"])

    args = (variables["params"], variables["batch_stats"], jbatch,
            jax.random.PRNGKey(1))
    (_, (losses, inter)), grads = _exact(
        jax.value_and_grad(loss_fn, has_aux=True), *args)(*args)
    sample = _np(jax.tree_util.tree_leaves(inter["sample"][0]))
    assert 0 < sample[1].sum() <= 96 and float(losses["loss_grid"]) > 0
    return (batch, {k: float(v) for k, v in losses.items()}, sample,
            _np(inter["feats"][0]), jax_to_state_dict(_np(grads),
                                                      basic_blocks=True))


def test_grid_loss_with_jax_draws_matches_jax(detector_pair, jax_step):
    """The port's `grid_loss` on JAX's FPN maps, sample and draws: JAX's
    loss_grid within 1e-5 relative, and the grid head's gradients (which
    no other loss reaches) within 1e-4 of each parameter's max."""
    model, _ = detector_pair
    batch, want, (rois, pos_w, gt_idx, rng), feats, jg = jax_step
    jitter, priority = _jax_draws(rng, rois.shape[0])
    head = model.roi_head
    head.zero_grad()
    got = head.grid_loss([_t(f).permute(0, 3, 1, 2) for f in feats[:4]],
                         _t(rois), _t(pos_w), _t(gt_idx).long(),
                         _t(batch["gt_bboxes"]), _t(jitter), _t(priority))
    np.testing.assert_allclose(float(got.detach()), want["loss_grid"],
                               rtol=1e-5)
    got.backward()
    for name, p in head.grid_head.named_parameters():
        w = jg[f"roi_head.grid_head.{name}"].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * np.abs(w).max(), (name, err)
    head.zero_grad()


def test_train_step_matches_jax(detector_pair, jax_step, monkeypatch):
    model, _ = detector_pair
    batch, want, (jrois, jpos, _, jrng), _, jg = jax_step
    jitter, priority = _jax_draws(jrng, jrois.shape[0])

    orig = model.roi_head.grid_loss
    extract = grid_roi_head.single_roi_extract
    seen = []

    def grid_loss(feats, rois, pos_w, gt_idx, gt_bboxes, jit, prio):
        assert not rois.requires_grad
        rows = _match(rois.numpy(), jrois)
        assert np.array_equal(pos_w.numpy(), jpos[rows])
        return orig(feats, rois, pos_w, gt_idx, gt_bboxes,
                    _t(jitter[rows]), _t(priority[rows]))

    def recording_extract(feats, rois, *a, **k):
        seen.append(rois.requires_grad)
        return extract(feats, rois, *a, **k)

    monkeypatch.setattr(model.roi_head, "grid_loss", grid_loss)
    monkeypatch.setattr(grid_roi_head, "single_roi_extract",
                        recording_extract)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(model, dict(type="SGD", lr=0.01, momentum=0.9,
                                      weight_decay=1e-4), None, None, 1, 1,
                          frozen_stages=1, by_epoch=False)
    step = make_train_step(model, opt)
    got = {k: float(v) for k, v in step(
        init_train_state("cpu"), batch_to_device(batch, "cpu"),
        torch.Generator().manual_seed(0)).items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.load_state_dict(init)
    model.eval()
    assert seen == [False]
    assert set(got) == set(want) | {"loss", "nan_seen"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert set(jg) == set(grads)
    for name, g in grads.items():
        w = jg[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)
    assert np.abs(jg["roi_head.grid_head.conv0.weight"].numpy()).max() > 0


def test_tiled_protocol_matches_jax(detector_pair, tmp_path):
    model, variables = detector_pair
    text = open("tests/test_torch_slice.py").read()
    cfg_text = text[text.index('CFG_TEXT = """') + 14:]
    cfg_text = cfg_text[:cfg_text.index("model = dict(")]
    path = tmp_path / "grid.py"
    path.write_text(cfg_text + f"model = {MODEL!r}\ntest_cfg = {TEST_CFG!r}\n")
    th = init_detector(str(path), device="cpu")
    th.model.load_state_dict(model.state_dict())
    frame = np.random.RandomState(6).randint(0, 256, (128, 192, 3), np.uint8)
    cfg = JaxConfig.fromfile(str(path))
    eng = JaxTiled(_jax_model(train=False), variables, frame.shape[:2],
                   (64, 96), tuple(cfg.data["test"]["pipeline"][1][
                       "tile_overlap"]))
    eng._infer = eng._infer.lower(frame[None]).compile(FAST_COMPILE)
    ref = _dets(eng(frame)[0])
    assert ref[0].shape[0] > 0
    _assert_dets_match(ref, _dets(inference_detector_tiled(th, frame)))


def test_full_width_config_builds_with_the_jax_tree():
    """The config at full width: the port's detector builds, and its RoI
    head holds the JAX head's parameter tree (backbone, neck and RPN are
    Faster R-CNN's, held in tests/test_torch_init.py)."""
    cfg = Config.fromfile(GRID)
    n = torch.get_num_threads()
    torch.set_num_threads(4)            # the seeded draw of 50M weights
    try:
        model = build_detector(dict(cfg.model), cfg.get("train_cfg"),
                               cfg.get("test_cfg"), device="cpu", seed=0)
    finally:
        torch.set_num_threads(n)
    roi = dict(cfg.model["roi_head"], train_cfg=cfg.train_cfg["rcnn"])
    roi.pop("type")
    jroi = jgrid.GridRoIHead(**roi)
    feats = [jnp.zeros((1, 128 // s, 160 // s, 256)) for s in (4, 8, 16, 32)]
    batch = dict(gt_bboxes=jnp.zeros((1, 2, 4)),
                 gt_labels=jnp.zeros((1, 2), jnp.int32),
                 gt_valid=jnp.ones((1, 2), bool))
    shapes = jax.eval_shape(
        lambda r: jroi.init(r, feats, jnp.zeros((1, 8, 4)),
                            jnp.ones((1, 8), bool), batch, r,
                            method=jroi.forward_train),
        jax.random.PRNGKey(0))["params"]
    want = {k: tuple(v.shape) for k, v in jax_to_state_dict(
        jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                               {"roi_head_m": shapes})).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if k.startswith("roi_head.")}
    assert got == want
    head = model.roi_head.grid_head
    assert head.conv7.weight.shape == (576, 576, 3, 3)
    assert head.gn0.num_groups == 36
    assert model.roi_head.grid_extractor["output_size"] == 14
    assert model.roi_head.grid_extractor["sampling_ratio"] == 2


# ------------------------------------------------------------- Libra
@pytest.mark.parametrize("hw", [(64, 96), (100, 76)])
def test_bfp_matches_jax(hw):
    """Levels of strides 4-64 over an hw input (ceil division); at 100x76
    they are 25x19, 13x10, 7x5, 4x3 and 2x2."""
    rng = np.random.RandomState(7)
    sizes = [(-(-hw[0] // s), -(-hw[1] // s)) for s in (4, 8, 16, 32, 64)]
    feats = [jnp.asarray(rng.randn(2, h, w, C).astype(np.float32))
             for h, w in sizes]
    jbfp = jnecks.BFP(in_channels=C)
    variables = _np(_fast(jbfp.init, jax.random.PRNGKey(0), feats)(
        jax.random.PRNGKey(0), feats))
    want = _fast(jbfp.apply, variables, feats)(variables, feats)
    port = BFP(in_channels=C)
    k = variables["params"]["refine"]
    port.refine.weight.data = _t(k["kernel"].transpose(3, 2, 0, 1))
    port.refine.bias.data = _t(k["bias"])
    with torch.no_grad():
        got = port([_t(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_balanced_l1_loss_and_gradient_match_jax():
    """Values and gradients within 1e-6 relative, the differences at 0
    (where JAX's |x| has gradient +1), at beta (the second branch), just
    below beta and beyond; weighted and divided by max(avg_factor, 1).
    The targets are multiples of 1/64, so that target + diff is exact."""
    rng = np.random.RandomState(8)
    target = (np.round(rng.randn(3, 4) * 64) / 64).astype(np.float32)
    diff = np.array([[0.0, 1.0, -1.0, 0.5], [-0.5, 2.5, -3.0, 1e-4],
                     [0.2, -0.7, 1.0001, -0.0]], np.float32)
    pred = (target + diff).astype(np.float32)
    weight = rng.rand(3, 4).astype(np.float32)
    for kwargs, avg in ((dict(), None), (dict(alpha=0.3, gamma=2.0,
                                              beta=0.5, loss_weight=2.0),
                        0.5), (dict(), 7.0)):
        jloss = jl1.BalancedL1Loss(**kwargs)
        want, jg = jax.value_and_grad(
            lambda p: jloss(p, jnp.asarray(target), jnp.asarray(weight),
                            avg_factor=avg))(jnp.asarray(pred))
        p = _t(pred).requires_grad_(True)
        got = BalancedL1Loss(**kwargs)(p, _t(target), _t(weight),
                                       avg_factor=avg)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6, atol=1e-7)


def test_libra_list_neck_refused():
    """The JAX package cannot build Libra R-CNN (its list neck raises in
    TwoStageDetector.setup); the port's `build_detector` refuses it by
    name."""
    jcfg = JaxConfig.fromfile(LIBRA)
    jm = jax_build(dict(jcfg.model), jcfg.get("train_cfg"),
                   jcfg.get("test_cfg"))
    with pytest.raises(ValueError):
        jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                       jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3), jnp.float32))
    cfg = Config.fromfile(LIBRA)
    with pytest.raises(NotImplementedError, match="two_stage.py:37"):
        build_detector(dict(cfg.model), device="cpu")

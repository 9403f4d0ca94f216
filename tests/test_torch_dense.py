"""The dense TinyPerson baselines, FCOS, ATSS and RepPoints: the port's
pieces against the JAX package's on the same numpy inputs and weights.

- `bbox_overlaps_aligned`, IoULoss and GIoULoss (rtol 1e-6);
- `point_sample_pixel` with "zeros" padding, values and gradients (and
  "border" beside it);
- the assigners: FCOS's `get_targets`, `atss_assign` and `point_assign`
  equal exactly on scenes with padded gts, distance ties and gts smaller
  than the point assigner's scale;
- each head at toy width (16 channels, GroupNorm of 4 groups, 2 stacked
  convs) on seeded feature maps with the JAX head's init loaded through
  utils/jax_weights.py: its outputs, its losses within 1e-5 relative and
  every parameter's gradient within 1e-4 of that parameter's max |grad|
  (RepPoints with its initial points spread past the map's edge and a
  non-zero `moment_transfer`, so that the "zeros" padding, gradient_mul
  and moment_mul paths all carry gradient), and the detections of
  `get_bboxes`;
- SGD with FCOS's `paramwise_cfg` (bias lr x2, no bias decay; GroupNorm
  leaves are norm leaves) on the ResNet-18 twin of
  tests/train_parity_lib.py::make_jax_fcos: three steps of the port
  against the JAX package's `build_optimizer` on the same gradients,
  parameters within 1e-5 relative, and one bias leaf against a
  hand-computed update;
- the six other configs of the three families build at toy width with the
  JAX model's parameter tree and run a forward.

The JAX side of each head's step is compiled once, in a module fixture.
"""
import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import train_parity_lib as tp
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.builder import build_module
from pointtinybenchmark_tpu_torch.models.dense_heads.atss_head import \
    atss_assign
from pointtinybenchmark_tpu_torch.models.dense_heads.reppoints_head import \
    point_assign
from pointtinybenchmark_tpu_torch.models.losses import GIoULoss, IoULoss
from pointtinybenchmark_tpu_torch.ops.grid_sample import point_sample_pixel
from pointtinybenchmark_tpu_torch.ops.iou import bbox_overlaps_aligned
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)
from test_torch_init import toy

jiou = importlib.import_module("pointtinybenchmark_tpu.ops.iou")
jloss = importlib.import_module(
    "pointtinybenchmark_tpu.models.losses.iou_loss")
jgrid = importlib.import_module("pointtinybenchmark_tpu.ops.grid_sample")
jfcos = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.fcos_head")
jatss = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.atss_head")
jrep = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.reppoints_head")
jopt = importlib.import_module("pointtinybenchmark_tpu.engine.optimizer")

C, GN4 = 16, dict(type="GN", num_groups=4)
SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]     # a 64x96 input
STRIDES = [4, 8, 16, 32, 64]
TEST_CFG = dict(nms_pre=40, score_thr=0.05, nms=dict(type="nms",
                                                     iou_threshold=0.5),
                max_per_img=100)
HEADS = {
    "fcos": dict(type="FCOSHead", num_classes=1, in_channels=C,
                 feat_channels=C, stacked_convs=2, strides=STRIDES,
                 regress_ranges=tp.ADAP_RANGES, norm_cfg=GN4,
                 loss_cls=dict(tp.LOSS_CLS), loss_bbox=dict(tp.FCOS_LOSS_BBOX),
                 loss_centerness=dict(tp.FCOS_LOSS_CTR)),
    "atss": dict(type="ATSSHead", num_classes=1, in_channels=C,
                 feat_channels=C, stacked_convs=2, norm_cfg=GN4,
                 anchor_generator=dict(type="AnchorGenerator",
                                       octave_base_scale=4,
                                       scales_per_octave=1, ratios=[1.0],
                                       strides=STRIDES),
                 bbox_coder=dict(type="DeltaXYWHBBoxCoder",
                                 target_means=[0, 0, 0, 0],
                                 target_stds=[0.1, 0.1, 0.2, 0.2]),
                 loss_cls=dict(tp.LOSS_CLS),
                 loss_bbox=dict(type="GIoULoss", loss_weight=2.0),
                 train_cfg=dict(assigner=dict(type="ATSSAssigner", topk=9),
                                allowed_border=-1, pos_weight=-1)),
    "reppoints": dict(
        type="RepPointsHead", num_classes=1, in_channels=C, feat_channels=C,
        point_feat_channels=C, stacked_convs=2, num_points=9,
        gradient_mul=0.1, point_strides=STRIDES, point_base_scale=4,
        transform_method="moment", moment_mul=0.01, norm_cfg=GN4,
        loss_cls=dict(tp.LOSS_CLS),
        loss_bbox_init=dict(type="SmoothL1Loss", beta=0.11, loss_weight=0.5),
        loss_bbox_refine=dict(type="SmoothL1Loss", beta=0.11,
                              loss_weight=1.0),
        train_cfg=dict(
            init=dict(assigner=dict(type="PointAssigner", scale=4,
                                    pos_num=1)),
            refine=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                                      neg_iou_thr=0.4, min_pos_iou=0,
                                      ignore_iof_thr=-1)))),
}
JAX_HEADS = {"fcos": jfcos.FCOSHead, "atss": jatss.ATSSHead,
             "reppoints": jrep.RepPointsHead}
CLASSIFIER = {"fcos": "conv_cls", "atss": "atss_cls", "reppoints": "cls_out"}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
SECONDARY = (
    "tinyperson/fcos_r50_fpn_1x_tinyperson640.py",
    "tinypersonv2/fcos_r50_fpns4_1x_tinypersonv2_640.py",
    "tinyperson/reppoints_r50_fpn_1x_tinyperson640.py",
    "tinyperson/reppoints_r50_fpn_gn_neck_head_1x_tinyperson640.py",
    "tinyperson/reppoints_r50_fpns4_plain_1x_tinyperson640.py",
    "tinypersonv2/reppoints_r50_fpns4_1x_tinypersonv2_640.py",
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scene():
    """Two images of 64x96 padded to 5 gts: tiny gts (under the point
    assigner's scale), equal-area overlapping gts, gts centred between
    anchor centres (distance ties), a padded row with a real-looking box."""
    gt = np.zeros((2, 5, 4), np.float32)
    gt[0, :4] = [[6, 6, 18, 18], [30, 8, 58, 40], [32, 10, 60, 42],
                 [70, 20, 72, 23]]
    gt[0, 4] = [10, 10, 40, 40]                     # padded: never matched
    gt[1, :3] = [[2, 40, 10, 60], [44, 28, 60, 44], [80, 4, 92.5, 30.25]]
    valid = np.zeros((2, 5), bool)
    valid[0, :4] = True
    valid[1, :3] = True
    labels = np.zeros((2, 5), np.int32)
    return dict(gt_bboxes=gt, gt_labels=labels, gt_valid=valid)


def _jbatch(scene):
    return dict({k: jnp.asarray(v) for k, v in scene.items()},
                pad_shape=(64, 96))


def _tbatch(scene):
    return dict({k: _t(v) for k, v in scene.items()}, pad_shape=(64, 96))


# ------------------------------------------------------------ the losses
def _box_pairs(rng, n):
    xy = rng.rand(n, 2).astype(np.float32) * 50
    wh = rng.rand(n, 2).astype(np.float32) * 30
    a = np.concatenate([xy, xy + wh], -1)
    b = a + (rng.randn(n, 4) * 8).astype(np.float32)
    b[:5] = a[:5]                                        # identical
    b[5:10, :2] = a[5:10, 2:] + 3                        # disjoint
    b[5:10, 2:] = b[5:10, :2] + 4
    b[10:12, 2:] = b[10:12, :2]                          # zero-area
    return a, b


@pytest.mark.parametrize("mode", ["iou", "giou"])
def test_bbox_overlaps_aligned_matches_jax(mode):
    a, b = _box_pairs(np.random.RandomState(0), 300)
    want = np.asarray(jiou.bbox_overlaps_aligned(jnp.asarray(a),
                                                 jnp.asarray(b), mode=mode))
    got = bbox_overlaps_aligned(_t(a), _t(b), mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,weighted,avg_factor", [
    ("iou", None, None), ("iou", "rows", 17.5), ("iou", "boxes", None),
    ("giou", None, None), ("giou", "rows", 17.5), ("giou", "boxes", 3.0)])
def test_iou_losses_match_jax(kind, weighted, avg_factor):
    rng = np.random.RandomState(1)
    a, b = _box_pairs(rng, 200)
    weight = {None: None, "rows": rng.rand(200).astype(np.float32),
              "boxes": rng.rand(200, 4).astype(np.float32)}[weighted]
    jcls, tcls = ((jloss.IoULoss, IoULoss) if kind == "iou"
                  else (jloss.GIoULoss, GIoULoss))
    want = float(jcls(loss_weight=0.7)(
        jnp.asarray(a), jnp.asarray(b),
        None if weight is None else jnp.asarray(weight), avg_factor))
    got = float(tcls(loss_weight=0.7)(
        _t(a), _t(b), None if weight is None else _t(weight), avg_factor))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------- the sampling
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_point_sample_pixel_matches_jax(padding_mode):
    """Points inside, on and beyond every edge of a 7x9 map: values and
    the gradients in the map and the points within 1e-6 of JAX's."""
    rng = np.random.RandomState(2)
    feat = rng.randn(2, 7, 9, 5).astype(np.float32)
    pts = np.stack([rng.uniform(-2.5, 10.5, (2, 300)),
                    rng.uniform(-2.5, 8.5, (2, 300))], -1).astype(np.float32)
    pts[:, :8] = [[0, 0], [8, 6], [-1, 3], [9, 3], [4, -1], [4, 7],
                  [-0.5, -0.5], [8.5, 6.5]]
    cot = rng.randn(2, 300, 5).astype(np.float32)

    def jf(f, p):
        return jnp.sum(jgrid.point_sample_pixel(f, p, padding_mode) * cot)
    want = np.asarray(jgrid.point_sample_pixel(jnp.asarray(feat),
                                               jnp.asarray(pts),
                                               padding_mode))
    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(pts))
    f, p = _t(feat).requires_grad_(), _t(pts).requires_grad_()
    got = point_sample_pixel(f, p, padding_mode)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    for g, w in ((f.grad, jg[0]), (p.grad, jg[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # (-0.5, -0.5): a quarter of the corner cell, or the cell itself
    share = 0.25 if padding_mode == "zeros" else 1.0
    np.testing.assert_allclose(got.detach()[:, 6].numpy(),
                               share * feat[:, 0, 0], rtol=1e-6)


# --------------------------------------------------------- the assigners
def test_fcos_targets_equal_jax():
    scene = _scene()
    jhead = jfcos.FCOSHead(**{k: v for k, v in HEADS["fcos"].items()
                              if k != "type"})
    points, strides, ranges = jhead.flat_points(SIZES)
    want = _fast(lambda b: jhead.get_targets(points, strides, ranges, b),
                 {k: jnp.asarray(v) for k, v in scene.items()})
    head = build_module(HEADS["fcos"])
    pts, _, rr = head.flat_points(SIZES, torch.device("cpu"))
    np.testing.assert_array_equal(pts.numpy(), points)
    got = head.get_targets(pts, rr, _tbatch(scene))
    assert int(want[2].sum()) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_atss_assign_equals_jax():
    scene = _scene()
    head = build_module(HEADS["atss"])
    levels = head.level_anchors(SIZES, torch.device("cpu"))
    anchors = torch.cat(levels)
    sizes = [len(a) for a in levels]
    got = atss_assign(anchors, sizes, _t(scene["gt_bboxes"]),
                      _t(scene["gt_valid"]), topk=9).numpy()
    want = _fast(jax.vmap(lambda g, v: jatss.atss_assign(
        anchors.numpy(), sizes, g, v, topk=9)), scene["gt_bboxes"],
        scene["gt_valid"])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got > 0).sum() > 8 and not (got == 5).any()


@pytest.mark.parametrize("pos_num", [1, 3])
def test_point_assign_equals_jax(pos_num):
    scene = _scene()
    head = build_module(HEADS["reppoints"])
    centers, strides = head.flat_points(SIZES, torch.device("cpu"))
    got = point_assign(centers, strides, _t(scene["gt_bboxes"]),
                       _t(scene["gt_valid"]), 4.0, pos_num).numpy()
    want = _fast(jax.vmap(lambda g, v: jrep.point_assign(
        jnp.asarray(centers.numpy()), strides.numpy(), g, v, 4.0, pos_num)),
        scene["gt_bboxes"], scene["gt_valid"])
    np.testing.assert_array_equal(got, np.asarray(want))
    # every valid gt finds its points, the tiny one on the first level
    assert (got > 0).sum() >= 7 * pos_num and got[0, 0] == 0


# ------------------------------------------------------------- the heads
def _head_inputs():
    rng = np.random.RandomState(3)
    return [rng.randn(2, h, w, C).astype(np.float32) for h, w in SIZES]


def _total(losses):
    return sum(v for k, v in losses.items() if k.startswith("loss"))


@pytest.fixture(scope="module", params=["fcos", "atss", "reppoints"])
def head_run(request):
    """One head on seeded features and `_scene`: JAX's init (RepPoints'
    initial points spread, its moment_transfer set), outputs, losses,
    gradients and detections, and the port's head with those weights."""
    name = request.param
    args = {k: v for k, v in HEADS[name].items() if k != "type"}
    jhead = JAX_HEADS[name](test_cfg=dict(TEST_CFG), **args)
    feats = [jnp.asarray(f) for f in _head_inputs()]
    params = _np(_fast(lambda r: jhead.init(r, feats),
                       jax.random.PRNGKey(4))["params"])
    rng = np.random.RandomState(5)
    # the classifier spread and unbiased, so that detections pass
    # score_thr in an order that two frameworks agree on
    cls = params[CLASSIFIER[name]]
    cls["kernel"] = (rng.randn(*cls["kernel"].shape) * 0.3).astype(
        np.float32)
    cls["bias"] = np.zeros_like(cls["bias"])
    if name == "reppoints":
        out = params["pts_init_out"]
        out["kernel"] = (rng.randn(*out["kernel"].shape) * 0.4).astype(
            np.float32)
        params["moment_transfer"] = np.asarray([0.3, -0.2], np.float32)
    batch = _jbatch(_scene())

    def step(p):
        outs = jhead.apply({"params": p}, feats, train=True)
        losses = jhead.loss(*outs, batch)
        return _total(losses), (outs, losses)
    (_, (outs, losses)), grads = _fast(
        jax.value_and_grad(step, has_aux=True), params)
    img_shapes = jnp.asarray([[64, 96], [60, 90]], jnp.int32)
    dets = _fast(lambda p: jhead.get_bboxes(
        *jhead.apply({"params": p}, feats), img_shapes, (64, 96))[0], params)
    head = build_module(dict(HEADS[name], test_cfg=dict(TEST_CFG)))
    sd = {k[len("bbox_head."):]: v for k, v in
          jax_to_state_dict({"bbox_head_m": params}).items()}
    head.load_state_dict(sd)
    return dict(name=name, head=head, outs=_np(outs),
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_to_state_dict({"bbox_head_m": _np(grads)}),
                dets=_np(dets), img_shapes=np.asarray(img_shapes))


def _fast(fn, *args):
    """fn(*args), jitted and compiled without XLA's optimisations (the
    shapes are tiny; eager JAX would compile every operation alone)."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _port_feats():
    return [_t(f).permute(0, 3, 1, 2) for f in _head_inputs()]


def test_head_outputs_losses_and_grads_match_jax(head_run):
    head = head_run["head"]
    head.zero_grad()
    outs = head(_port_feats())
    losses = head.loss(*outs, _tbatch(_scene()))
    _total(losses).backward()
    # the outputs, NCHW against NHWC (moment_transfer is a parameter)
    for got_lv, want_lv in zip(outs[:3], head_run["outs"][:3]):
        for g, w in zip(got_lv, want_lv):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.detach().permute(0, 2, 3, 1).numpy(), w, rtol=1e-5,
                atol=1e-5 * np.abs(w).max())
    want = head_run["losses"]
    assert want["num_pos"] >= 3
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5,
                                   err_msg=k)
    grads = {"bbox_head." + n: p.grad for n, p in head.named_parameters()}
    assert set(grads) == set(head_run["grads"])
    for n, w in head_run["grads"].items():
        w = w.numpy()
        err = float(np.abs(grads[n].numpy() - w).max())
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (n, err)
    if head_run["name"] == "reppoints":
        # moment_mul's and gradient_mul's paths carry gradient
        for n in ("bbox_head.moment_transfer", "bbox_head.pts_init_out.weight",
                  "bbox_head.cls_dcn.weight"):
            assert float(head_run["grads"][n].abs().max()) > 0, n


def test_head_detections_match_jax(head_run):
    with torch.no_grad():
        dets = head_run["head"].get_bboxes(*head_run["head"](_port_feats()),
                                           _t(head_run["img_shapes"]))
    want = head_run["dets"]
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(want.valid))
    assert int(np.asarray(want.valid).sum()) > 0
    np.testing.assert_allclose(dets.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(dets.labels.numpy(),
                                  np.asarray(want.labels))


@pytest.mark.parametrize("name,key", [
    ("reppoints", dict(loss_centerness=dict(tp.FCOS_LOSS_CTR))),
    ("fcos", dict(dcn=dict(type="DCNv2"))),
    ("fcos", dict(center_sampling=True)),
    ("atss", dict(loss_centerness=dict(type="CrossEntropyLoss",
                                       use_sigmoid=True, loss_weight=2.0)))])
def test_heads_refuse_keys_they_would_drop(name, key):
    with pytest.raises(NotImplementedError):
        build_module(dict(HEADS[name], **key))


# ------------------------------------------------------- paramwise SGD
def test_fcos_paramwise_sgd_matches_jax():
    cfg = Config.fromfile(
        "configs/tinyperson/fcos_r50_fpns4_1x_tinyperson640.py")
    jm = tp.make_jax_fcos()
    # the twin's tree with seeded values (the optimizer does not care
    # where they come from)
    rng = np.random.RandomState(6)
    variables = jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape) * 0.05, np.float32),
        jax.eval_shape(lambda r, x: jm.init(r, x), jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3))))
    params = variables["params"]
    tx = jopt.build_optimizer(cfg.optimizer, cfg.optimizer_config,
                              cfg.lr_config, 1, 12,
                              param_mask=jopt.frozen_param_mask(params, 1))
    model = build_detector(_fcos_twin(), device="cpu")
    opt = build_optimizer(model, cfg.optimizer, cfg.optimizer_config,
                          cfg.lr_config, 1, 12, frozen_stages=1)
    # the hand-checked leaves: a conv bias and a GroupNorm bias at 1000,
    # where a decay of 1e-4 moves them by lr / 10
    head = params["bbox_head_m"]
    head["conv_reg"]["bias"] = np.full(4, 1000.0, np.float32)
    head["cls_conv0"]["GroupNorm_0"]["bias"] = np.full(C, 1000.0, np.float32)
    load_jax_variables(model, params, variables["batch_stats"])
    # step 1: a gradient of 1 on the two leaves only (under the clip norm);
    # step 2 is clipped, step 3 is not
    first = jax.tree_util.tree_map(np.zeros_like, params)
    first["bbox_head_m"]["conv_reg"]["bias"] = np.ones(4, np.float32)
    first["bbox_head_m"]["cls_conv0"]["GroupNorm_0"]["bias"] = np.ones(
        C, np.float32)
    grads = [first] + [jax.tree_util.tree_map(
        lambda p: np.asarray(rng.randn(*np.shape(p)) * s, np.float32),
        params) for s in (3.0, 0.01)]
    state = tx.init(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def jax_step(g, st, p):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st
    jax_step = jax.jit(jax_step).lower(grads[0], state, jp).compile(
        FAST_COMPILE)
    lr = 0.01 / 3                              # the constant warmup
    for t, g in enumerate(grads):
        jp, state = jax_step(g, state, jp)
        tg = jax_to_state_dict(g, basic_blocks=True)
        for n, p in model.named_parameters():
            p.grad = tg[n]
        opt.step(torch.tensor(True))
        if t == 0:
            # a bias takes 2 lr and no decay; a GroupNorm bias (a norm
            # leaf) 1 lr and the decay
            sd = model.state_dict()
            np.testing.assert_allclose(
                sd["bbox_head.conv_reg.bias"].numpy(), 1000 - 2 * lr,
                rtol=0, atol=1e-4)
            np.testing.assert_allclose(
                sd["bbox_head.cls_convs.0.gn.bias"].numpy(),
                1000 - lr * (1 + 1e-4 * 1000), rtol=0, atol=1e-4)
    want = jax_to_state_dict(_np(jp), basic_blocks=True)
    got = dict(model.named_parameters())
    frozen = [n for n in got if n.startswith(("backbone.conv1",
                                              "backbone.bn1",
                                              "backbone.layer1."))]
    assert frozen
    for n, w in want.items():
        err = float((got[n].detach() - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (n, err)
    for n in frozen:
        assert torch.equal(got[n].detach(), jax_to_state_dict(
            params, basic_blocks=True)[n]), n


def _fcos_twin():
    """make_jax_fcos's model dict."""
    chans = [8, 16, 32, 64]
    return dict(
        type="FCOS",
        backbone=dict(type="ResNet", depth=18, base_channels=8,
                      norm_eval=True, frozen_stages=-1),
        neck=dict(type="FPN", in_channels=chans, out_channels=C, num_outs=5,
                  start_level=0, add_extra_convs="on_input"),
        bbox_head=dict(HEADS["fcos"]))


# --------------------------------------------- the other configurations
@pytest.mark.parametrize("name", SECONDARY)
def test_secondary_configs_build_and_run(name):
    """Toy width: the port's parameters are the JAX model's tree (GN heads
    where `norm_cfg=None`, as JAX builds them), and a forward on a 64x96
    image gives finite detections."""
    cfg = Config.fromfile(f"configs/{name}")
    model_cfg = toy(cfg.model)
    jm = jax_build(copy.deepcopy(model_cfg), cfg.get("train_cfg"),
                   cfg.get("test_cfg"))
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 96, 3), jnp.float32))
    model = build_detector(copy.deepcopy(model_cfg), cfg.get("train_cfg"),
                           cfg.get("test_cfg"), device="cpu")
    # JAX's tree, each leaf filled with the port's seeded value, loads
    # back: the same leaves, paths and shapes
    sd = model.state_dict()
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    load_jax_variables(model, tree["params"], tree.get("batch_stats"))
    model.load_state_dict(sd)
    assert any(".gn." in n for n, _ in model.named_parameters())
    img = torch.from_numpy(np.random.RandomState(7).randn(
        2, 64, 96, 3).astype(np.float32))
    with torch.no_grad():
        dets = model.simple_test(img, torch.tensor([[64, 96]] * 2))
    assert bool(torch.isfinite(dets.bboxes).all())

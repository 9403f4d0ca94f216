"""FoveaBox and FreeAnchor, with the FPN's `on_output` and `on_lateral`
extras: the port's pieces against the JAX package's on the same numpy
inputs and weights.

- the FPN with each source of its extra convs, with and without
  `relu_before_extra_convs` (outputs within 1e-5 relative);
- FoveaHead's `get_targets`, equal exactly, on a scene with padded gts,
  point centres on shrunk-box edges, gt edges on scale-range bounds
  (matching two or three levels) and two candidate gts of equal area;
- FreeAnchor's bags and matched probability (`image_box_prob`), equal
  exactly, read out of the JAX loss's trace, on tiny gts and two gts of
  one label, with the config's bag of 50 and with a bag larger than the
  anchors the tiny gts overlap (IoU-0 ties fill the rest);
- each head at toy width (16 channels, 2 stacked convs, the TinyPerson
  configs' head settings) on seeded feature maps with the JAX head's init
  loaded through utils/jax_weights.py: its outputs, its losses within
  1e-5 relative, every parameter's gradient within 1e-4 of that
  parameter's max |grad|, and the detections of `get_bboxes` at
  tests/test_detector_golden.py:88's tolerances;
- the seven configurations of the two heads and of the widened FPN build
  at toy width with the JAX model's parameter tree and run a forward.

The JAX side of each head's step is compiled once, in a module fixture,
without XLA's backend optimisations.
"""
import contextlib
import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.builder import build_module
from pointtinybenchmark_tpu_torch.ops.iou import bbox_overlaps
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)
from test_torch_init import toy

jfpn = importlib.import_module("pointtinybenchmark_tpu.models.necks.fpn")
jfovea = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.fovea_head")
jfree = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.free_anchor_retina_head")

C = 16
SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]     # a 64x96 input
PAD = (64, 96)
TEST_CFG = dict(nms_pre=40, score_thr=0.05, nms=dict(type="nms",
                                                     iou_threshold=0.5),
                max_per_img=100)
FOCAL = dict(type="FocalLoss", use_sigmoid=True, gamma=1.5, alpha=0.4,
             loss_weight=1.0)
HEADS = {
    "fovea": dict(type="FoveaHead", num_classes=1, in_channels=C,
                  feat_channels=C, stacked_convs=2,
                  strides=[4, 8, 16, 32, 64],
                  base_edge_list=[8, 16, 32, 64, 128],
                  scale_ranges=((1, 32), (16, 64), (32, 128), (64, 256),
                                (128, 512)),
                  sigma=0.4, loss_cls=dict(FOCAL),
                  loss_bbox=dict(type="SmoothL1Loss", beta=0.11,
                                 loss_weight=1.0)),
    "free_anchor": dict(type="FreeAnchorRetinaHead", num_classes=3,
                        in_channels=C, feat_channels=C, stacked_convs=2,
                        anchor_generator=dict(type="AnchorGenerator",
                                              octave_base_scale=2,
                                              scales_per_octave=3,
                                              ratios=[0.5, 1.0, 2.0],
                                              strides=[4, 8, 16, 32, 64]),
                        bbox_coder=dict(target_means=[0, 0, 0, 0],
                                        target_stds=[1.0, 1.0, 1.0, 1.0])),
}
JAX_HEADS = {"fovea": jfovea.FoveaHead,
             "free_anchor": jfree.FreeAnchorRetinaHead}
CLASSIFIER = {"fovea": "conv_cls", "free_anchor": "retina_cls"}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CONFIGS = (
    "tinyperson/fovea_r50_fpns4_1x_tinyperson640.py",
    "tinyperson/free_anchor_r50_fpns4_1x_tinyperson640.py",
    "coco/fovea_r50_fpn_4x4_1x_coco.py",
    "coco/free_anchor_retinanet_r50_fpn_1x_coco.py",
    "coco/fcos_r50_caffe_fpn_gn_head_1x_coco.py",
    "coco/reppoints_moment_r50_fpn_1x_coco.py",
    "coco/reppoints_moment_r50_fpn_gn_neck_head_1x_coco.py",
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


def _fast(fn, *args):
    """fn(*args), jitted and compiled without XLA's optimisations (the
    shapes are tiny; eager JAX would compile every operation alone)."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _jbatch(scene):
    return dict({k: jnp.asarray(v) for k, v in scene.items()}, pad_shape=PAD)


def _tbatch(scene):
    return dict({k: _t(v) for k, v in scene.items()}, pad_shape=PAD)


def _total(losses):
    return sum(v for k, v in losses.items() if k.startswith("loss"))


# ------------------------------------------------------------ the FPN
@pytest.mark.parametrize("extra", ["on_input", "on_lateral", "on_output"])
@pytest.mark.parametrize("relu", [False, True])
def test_fpn_extra_convs_match_jax(extra, relu):
    """The COCO form: levels 1-3 of four inputs and two extra stride-2
    convs, so that the ReLU before the second one counts."""
    kw = dict(in_channels=[8, 16, 32, 64], out_channels=C, num_outs=5,
              start_level=1, add_extra_convs=extra,
              relu_before_extra_convs=relu)
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 32 // 2 ** i, 48 // 2 ** i, 8 * 2 ** i).astype(
        np.float32) for i in range(4)]
    jfeats = [jnp.asarray(f) for f in feats]
    jm = jfpn.FPN(**kw)
    params = _np(_fast(lambda r: jm.init(r, jfeats),
                       jax.random.PRNGKey(1))["params"])
    want = _fast(lambda p: jm.apply({"params": p}, jfeats), params)
    fpn = build_module(dict(type="FPN", **kw))
    fpn.load_state_dict({k[len("neck."):]: v for k, v in
                         jax_to_state_dict({"neck_m": params}).items()})
    with torch.no_grad():
        got = fpn([_t(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-5, atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------ FoveaHead targets
def _fovea_scene():
    """Two 64x96 images padded to 6 gts:
    - [0, 0, 20, 20] (edge 20): shrunk to [6, 14], so level-0 points at x
      and y 6 and 14 lie on its edges;
    - [40, 24, 72, 56] (edge 32, the bound of levels 0, 1 and 2) and
      [12, 36, 28, 52] (edge 16, the bound of levels 0 and 1), centred
      on points of their coarsest level;
    - [30, 8, 58, 40] and [32, 10, 60, 42], equal areas whose shrunk boxes
      share points;
    - a padded row with a real-looking box."""
    gt = np.zeros((2, 6, 4), np.float32)
    gt[0, :5] = [[0, 0, 20, 20], [40, 24, 72, 56], [12, 36, 28, 52],
                 [30, 8, 58, 40], [32, 10, 60, 42]]
    gt[0, 5] = [70, 30, 90, 50]                     # padded: never matched
    gt[1, :3] = [[2, 40, 10, 60], [44, 28, 60, 44], [80, 4, 92.5, 30.25]]
    valid = np.zeros((2, 6), bool)
    valid[0, :5] = True
    valid[1, :3] = True
    labels = np.zeros((2, 6), np.int32)
    return dict(gt_bboxes=gt, gt_labels=labels, gt_valid=valid)


def test_fovea_targets_equal_jax():
    scene = _fovea_scene()
    jhead = jfovea.FoveaHead(**{k: v for k, v in HEADS["fovea"].items()
                                if k != "type"})
    points, strides, bases, ranges = jhead.flat_points(SIZES)
    want = _fast(lambda b: jhead.get_targets(points, strides, bases, ranges,
                                             b),
                 {k: jnp.asarray(v) for k, v in scene.items()})
    head = build_module(HEADS["fovea"])
    pts, be, rr = head.flat_points(SIZES, torch.device("cpu"))
    for g, w in ((pts, points), (be, bases), (rr, ranges)):
        np.testing.assert_array_equal(g.numpy(), w)
    labels, tgt, pos = head.get_targets(pts, be, rr, _tbatch(scene))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[2]))
    # the log targets within one float32 step: XLA's CPU log is one step
    # off the correctly rounded value on ~6% of inputs, torch's on ~0.02%;
    # the distances and the clip before it are exact (another gt's would
    # move a target by far more)
    np.testing.assert_array_max_ulp(tgt.numpy(), np.asarray(want[1]), 1)
    # the cases the scene was built for
    pos0 = pos[0].numpy()
    p = pts.numpy()
    on_edge = (p[:, 0] == 6) & (p[:, 1] == 14) & (np.arange(len(p)) < 384)
    assert pos0[on_edge].all()
    # an edge on a range bound matches every level whose range it bounds:
    # the edge-32 gt on levels 0-2, the edge-16 gt on levels 0-1
    for (x0, x1, y0, y1), levels in (((49.6, 62.4, 33.6, 46.4), 3),
                                     ((16.8, 23.2, 40.8, 47.2), 2)):
        held = (p[:, 0] >= x0) & (p[:, 0] <= x1) & (p[:, 1] >= y0) & (
            p[:, 1] <= y1)
        for lo, hi in ((0, 384), (384, 480), (480, 504))[:levels]:
            assert held[lo:hi].any() and pos0[lo:hi][held[lo:hi]].all()
    # equal areas: the first gt wins where both shrunk boxes hold a point
    both = ((p[:, 0] >= 42) & (p[:, 0] <= 46) & (p[:, 1] >= 22)
            & (p[:, 1] <= 30) & (np.arange(len(p)) < 384))
    assert pos0[both].all()
    gb = scene["gt_bboxes"][0, 3]
    d = np.stack([p[both, 0] - gb[0], p[both, 1] - gb[1],
                  gb[2] - p[both, 0], gb[3] - p[both, 1]], -1)
    np.testing.assert_allclose(tgt[0].numpy()[both],
                               np.log(np.clip(d / 8, 1 / 16, 16)), rtol=1e-6)
    assert int(pos.sum()) > 20


# ------------------------------------------- FreeAnchor bags and P{a in A+}
def _free_anchor_scene():
    """Two 64x96 images padded to 6 gts of 3 classes: tiny gts (2x2 to
    4x6.5 px), two of label 2 in image 1; in image 0 two gts of label 1,
    one an anchor's box and one that box shifted by 4 px, each of IoU
    over `bbox_thr` with its best predictions; padded rows (label 0, as the
    loader pads) with real-looking boxes."""
    gt = np.zeros((2, 6, 4), np.float32)
    gt[0, :5] = [[10, 10, 12, 12], [30, 41, 33, 44], [32, 16, 48, 32],
                 [36, 20, 52, 36], [20, 40, 24, 46.5]]
    gt[0, 5] = [60, 8, 80, 30]                      # padded
    gt[1, :2] = [[5, 5, 9, 8], [70, 40, 74, 44]]
    gt[1, 2:] = [[10, 10, 30, 30], [40, 40, 50, 50], [1, 1, 3, 3],
                 [32, 16, 48, 32]]
    valid = np.zeros((2, 6), bool)
    valid[0, :5] = True
    valid[1, :2] = True
    labels = np.zeros((2, 6), np.int32)
    labels[0, :5] = [0, 2, 1, 1, 0]
    labels[1, :2] = [2, 2]
    return dict(gt_bboxes=gt, gt_labels=labels, gt_valid=valid)


@contextlib.contextmanager
def jax_internals(caught):
    """While a FreeAnchor loss is traced, `caught` gets its bags (every
    lax.top_k's indices) and the per-image `image_box_prob`, stacked: the
    loss's vmap is run as a loop over images, which returns what the JAX
    function computes per image."""
    real_vmap, real_top_k = jax.vmap, jax.lax.top_k

    def loop_vmap(fn):
        def run(*args):
            outs = [fn(*[a[i] for a in args]) for i in range(len(args[0]))]
            stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *outs)
            caught["image_box_prob"] = stacked[1]
            return stacked
        return run

    def top_k(x, k):
        vals, idx = real_top_k(x, k)
        caught.setdefault("bags", []).append(idx)
        return vals, idx
    jax.vmap, jax.lax.top_k = loop_vmap, top_k
    try:
        yield
    finally:
        jax.vmap, jax.lax.top_k = real_vmap, real_top_k


@pytest.mark.parametrize("topk", [50, 600])
def test_free_anchor_bags_and_matched_prob_equal_jax(topk):
    """On seeded head outputs: each gt's bag, in lax.top_k's order, and
    P{a in A+} equal JAX's exactly. At 600 every tiny gt's bag is larger
    than the anchors it overlaps, so IoU-0 ties fill it."""
    args = {k: v for k, v in HEADS["free_anchor"].items() if k != "type"}
    args["pre_anchor_topk"] = topk
    jhead = JAX_HEADS["free_anchor"](**args)
    head = build_module(dict(HEADS["free_anchor"], pre_anchor_topk=topk))
    rng = np.random.RandomState(8)
    a = head.num_base_anchors
    cls = [rng.randn(2, h, w, a * 3).astype(np.float32) for h, w in SIZES]
    reg = [(rng.randn(2, h, w, a * 4) * 0.05).astype(np.float32)
           for h, w in SIZES]
    scene = _free_anchor_scene()

    def jax_side(c, r, gts):
        caught = {}
        with jax_internals(caught):
            jhead.loss(c, r, dict(gts, pad_shape=PAD))
        return jnp.stack(caught["bags"]), caught["image_box_prob"]
    want_bags, want_prob = _fast(
        jax_side, [jnp.asarray(x) for x in cls],
        [jnp.asarray(x) for x in reg],
        {k: jnp.asarray(v) for k, v in scene.items()})
    batch = _tbatch(scene)
    anchors, _ = head.flat_anchors(SIZES, PAD, torch.device("cpu"))
    _, box_cat = head._flatten_preds(
        [_t(x).permute(0, 3, 1, 2) for x in cls],
        [_t(x).permute(0, 3, 1, 2) for x in reg])
    bags = head.bags(anchors, batch["gt_bboxes"])
    prob = head.matched_prob(anchors, box_cat, batch)
    np.testing.assert_array_equal(bags.numpy(), np.asarray(want_bags))
    np.testing.assert_array_equal(prob.numpy(), np.asarray(want_prob))
    # the scene's cases: five tiny gts overlap fewer anchors than a bag of
    # 600 holds; the two gts of label 1 reach P{a in A+} = 1 at their best
    # predictions and values between on others; the tiny gts' best IoU
    # stays under bbox_thr, so their classes keep 0
    n_over = (bbox_overlaps(batch["gt_bboxes"], anchors) > 0).sum(-1)
    assert int((batch["gt_valid"] & (n_over < 600)).sum()) == 5
    ones = prob[0, :, 1] == 1
    between = (prob[0, :, 1] > 0) & ~ones
    assert int(ones.sum()) >= 2 and int(between.sum()) >= 2
    assert prob[0, :, [0, 2]].max() == 0 and prob[1].max() == 0


# ------------------------------------------------------------- the heads
def _head_inputs():
    rng = np.random.RandomState(3)
    return [rng.randn(2, h, w, C).astype(np.float32) for h, w in SIZES]


def _port_feats():
    return [_t(f).permute(0, 3, 1, 2) for f in _head_inputs()]


SCENES = {"fovea": _fovea_scene, "free_anchor": _free_anchor_scene}


@pytest.fixture(scope="module", params=["fovea", "free_anchor"])
def head_run(request):
    """One head on seeded features and its scene: JAX's init, outputs,
    losses, gradients and detections, and the port's head with those
    weights."""
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
    batch = _jbatch(SCENES[name]())

    def step(p):
        outs = jhead.apply({"params": p}, feats, train=True)
        losses = jhead.loss(*outs, batch)
        return _total(losses), (outs, losses)
    (_, (outs, losses)), grads = _fast(
        jax.value_and_grad(step, has_aux=True), params)
    img_shapes = jnp.asarray([[64, 96], [60, 90]], jnp.int32)
    dets = _fast(lambda p: jhead.get_bboxes(
        *jhead.apply({"params": p}, feats), img_shapes, PAD)[0], params)
    head = build_module(dict(HEADS[name], test_cfg=dict(TEST_CFG)))
    sd = {k[len("bbox_head."):]: v for k, v in
          jax_to_state_dict({"bbox_head_m": params}).items()}
    head.load_state_dict(sd)
    return dict(name=name, head=head, outs=_np(outs),
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_to_state_dict({"bbox_head_m": _np(grads)}),
                dets=_np(dets), img_shapes=np.asarray(img_shapes))


def test_head_outputs_losses_and_grads_match_jax(head_run):
    head = head_run["head"]
    if head_run["name"] == "fovea":
        # norm_cfg=None: biased convs and no GroupNorm, as JAX builds them
        assert all(m.gn is None and m.conv.bias is not None
                   for m in list(head.cls_convs) + list(head.reg_convs))
    head.zero_grad()
    outs = head(_port_feats())
    losses = head.loss(*outs, _tbatch(SCENES[head_run["name"]]()))
    _total(losses).backward()
    for got_lv, want_lv in zip(outs, head_run["outs"]):
        for g, w in zip(got_lv, want_lv):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.detach().permute(0, 2, 3, 1).numpy(), w, rtol=1e-5,
                atol=1e-5 * np.abs(w).max())
    want = head_run["losses"]
    assert want["num_pos"] >= 3
    assert set(losses) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    grads = {"bbox_head." + n: p.grad for n, p in head.named_parameters()}
    assert set(grads) == set(head_run["grads"])
    for n, w in head_run["grads"].items():
        w = w.numpy()
        assert np.abs(w).max() > 0, n
        err = float(np.abs(grads[n].numpy() - w).max())
        assert err <= 1e-4 * np.abs(w).max(), (n, err)


def test_head_detections_match_jax(head_run):
    with torch.no_grad():
        dets = head_run["head"].get_bboxes(*head_run["head"](_port_feats()),
                                           _t(head_run["img_shapes"]))
    want = head_run["dets"]
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(want.valid))
    assert int(np.asarray(want.valid).sum()) > 0
    got_b, want_b = dets.bboxes.numpy(), np.asarray(want.bboxes)
    np.testing.assert_allclose(got_b[..., :4], want_b[..., :4], rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_allclose(got_b[..., 4], want_b[..., 4], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(dets.labels.numpy(),
                                  np.asarray(want.labels))


# --------------------------------------------------- the configurations
@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build_and_run(name):
    """Toy width: the port's parameters are the JAX model's tree, and a
    forward on a 64x96 image gives finite detections."""
    cfg = Config.fromfile(f"configs/{name}")
    model_cfg = toy(cfg.model)
    jm = jax_build(copy.deepcopy(model_cfg), cfg.get("train_cfg"),
                   cfg.get("test_cfg"))
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 96, 3), jnp.float32))
    model = build_detector(copy.deepcopy(model_cfg), cfg.get("train_cfg"),
                           cfg.get("test_cfg"), device="cpu")
    # JAX's tree, each leaf filled with zeros, loads back: the same
    # leaves, paths and shapes (then the seeded weights go back)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    load_jax_variables(model, tree["params"], tree.get("batch_stats"))
    model.load_state_dict(sd)
    img = torch.from_numpy(np.random.RandomState(7).randn(
        2, 64, 96, 3).astype(np.float32))
    with torch.no_grad():
        dets = model.simple_test(img, torch.tensor([[64, 96]] * 2))
    assert bool(torch.isfinite(dets.bboxes).all())

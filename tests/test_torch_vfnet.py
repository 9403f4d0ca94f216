"""VFNet: the port's VarifocalLoss and VFNetHead against the JAX package's
on the same numpy inputs and weights.

- VarifocalLoss with `iou_weighted` on and off, a weight and an
  avg_factor below and above 1: the value and the gradient in the logits
  within 1e-6, on logits of 0 against targets of 0.5 (sigmoid(x) == t,
  and x on the BCE's max(x, 0) kink) and of 0;
- the star gather (`star_gather`, the 9 taps at the initial box's
  corners, edge midpoints and centre, zeros outside the map) and its
  gradients in the box sides and the map, on sides in quarter cells, so
  that taps land on cell centres, on the map's last row and column and
  beyond every edge;
- the head at toy width (16 channels, 2 stacked GN(4) convs a branch, the
  TinyPerson config's settings) on seeded feature maps with the JAX
  head's init loaded through utils/jax_weights.py: its three outputs
  within 1e-5, its losses within 1e-5 relative, every parameter's
  gradient within 1e-4 of that parameter's max |grad| (padded gts in the
  batch), and the detections of `get_bboxes` at
  tests/test_detector_golden.py:88's tolerances;
- the tiled protocol of a toy VFNet (tests/test_torch_slice.py's frame,
  tiles and ResNet-18 of base 8) against JAX's `inference_detector_tiled`;
- both VFNet configurations at toy width: the port's parameters are the
  JAX model's tree (`scale_refine{i}` included), and each maps back to
  its flax path.

The JAX side of the head's step is compiled once, in a module fixture,
without XLA's backend optimisations.
"""
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
from pointtinybenchmark_tpu_torch.models.losses import VarifocalLoss
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_param_paths, jax_to_state_dict, load_jax_variables)
from test_torch_init import toy
from test_torch_slice import DENSE_NECK, DENSE_TEST, tiled_slice_matches_jax

jvfnet = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.vfnet_head")
jadvanced = importlib.import_module(
    "pointtinybenchmark_tpu.models.losses.advanced")

C = 16
SIZES = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]     # a 64x96 input
PAD = (64, 96)
TEST_CFG = dict(nms_pre=40, score_thr=0.05,
                nms=dict(type="nms", iou_threshold=0.6), max_per_img=100)
HEAD = dict(type="VFNetHead", num_classes=2, in_channels=C, feat_channels=C,
            stacked_convs=2, strides=[4, 8, 16, 32, 64], anchor_scale=8,
            atss_topk=9, norm_cfg=dict(type="GN", num_groups=4),
            loss_cls=dict(type="VarifocalLoss", use_sigmoid=True, alpha=0.75,
                          gamma=2.0, iou_weighted=True, loss_weight=1.0),
            loss_bbox=dict(type="GIoULoss", loss_weight=1.5),
            loss_bbox_refine=dict(type="GIoULoss", loss_weight=2.0))
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CONFIGS = ("tinyperson/vfnet_r50_fpns4_1x_tinyperson640.py",
           "coco/vfnet_r50_fpn_1x_coco.py")
VFNET_MODEL = """
model = dict(
    type="VFNet",""" + DENSE_NECK + """
    bbox_head=dict(
        type="VFNetHead", num_classes=2, in_channels=16, feat_channels=16,
        stacked_convs=1, strides=[4, 8, 16, 32, 64],
        norm_cfg=dict(type="GN", num_groups=4)))
""" + DENSE_TEST.format(thr=0.6)


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
    """fn(*args), jitted and compiled without XLA's optimisations."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _total(losses):
    return sum(v for k, v in losses.items() if k.startswith("loss"))


# ------------------------------------------------------------- the loss
@pytest.mark.parametrize("iou_weighted", [True, False])
@pytest.mark.parametrize("avg_factor", [0.5, 7.0])
def test_varifocal_loss_matches_jax(iou_weighted, avg_factor):
    rng = np.random.RandomState(0)
    pred = (rng.randn(64, 3) * 2).astype(np.float32)
    target = np.zeros((64, 3), np.float32)
    rows = rng.permutation(64)[:20]
    target[rows, rng.randint(0, 3, 20)] = rng.uniform(0.05, 1, 20)
    # ties: sigmoid(0) == 0.5 == t on positives, and logits of 0 on
    # negatives (the BCE's max(x, 0) at its kink)
    pred[:4, 0] = 0.0
    target[:2, 0] = 0.5
    target[2:4, 0] = 0.0
    weight = rng.uniform(0, 2, (64, 1)).astype(np.float32)
    kw = dict(use_sigmoid=True, alpha=0.75, gamma=2.0,
              iou_weighted=iou_weighted, loss_weight=1.5)
    jloss = jadvanced.VarifocalLoss(**kw)
    want, want_g = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(target), weight=jnp.asarray(weight),
                        avg_factor=avg_factor))(jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    got = VarifocalLoss(**kw)(p, _t(target), weight=_t(weight),
                              avg_factor=avg_factor)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6 * np.abs(want_g).max())
    # the BCE's kink: a logit of 0 takes half the max(x, 0) gradient, as
    # JAX's clip gives
    assert want_g[2, 0] != 0 and want_g[0, 0] != 0


# ------------------------------------------------------ the star gather
def _jax_star_gather(feat, ltrb_cells):
    """The JAX head's `star_gather` closure (vfnet_head.py:93-110) over
    its own _STAR and point_sample_pixel."""
    b, h, w, c = feat.shape
    gy = jnp.arange(h, dtype=feat.dtype)[None, :, None]
    gx = jnp.arange(w, dtype=feat.dtype)[None, None, :]
    l, t, r, bo = (ltrb_cells[..., 0], ltrb_cells[..., 1],
                   ltrb_cells[..., 2], ltrb_cells[..., 3])
    pts = []
    for sy, sx in jvfnet._STAR:
        dy = jnp.where(sy < 0, -t, jnp.where(sy > 0, bo, 0.0))
        dx = jnp.where(sx < 0, -l, jnp.where(sx > 0, r, 0.0))
        pts.append(jnp.stack([gx + dx, gy + dy], -1))
    p = jnp.stack(pts, 3).reshape(b, h * w * 9, 2)
    out = jvfnet.point_sample_pixel(feat, p, padding_mode="zeros")
    return out.reshape(b, h, w, 9 * c)


def test_star_gather_and_its_gradients_match_jax():
    rng = np.random.RandomState(1)
    b, h, w, c = 2, 6, 8, 4
    feat = rng.randn(b, h, w, c).astype(np.float32)
    # sides in quarter cells up to 9: taps on cell centres, on row h - 1
    # and column w - 1, between the last cell and the edge, and beyond
    ltrb = (rng.randint(0, 37, (b, h, w, 4)) / 4).astype(np.float32)
    ltrb[0, 0, 0] = [0.5, 2.0, 7.0, 5.0]        # left / top off the map
    ltrb[0, 5, 7] = [7.0, 5.0, 0.25, 0.5]       # right / bottom past it
    cot = rng.randn(b, h, w, 9 * c).astype(np.float32)
    want, vjp = jax.vjp(_jax_star_gather, jnp.asarray(feat),
                        jnp.asarray(ltrb))
    want_f, want_l = vjp(jnp.asarray(cot))
    head = build_module(dict(HEAD))
    f = _t(feat).permute(0, 3, 1, 2).requires_grad_()
    cells = _t(ltrb).permute(0, 3, 1, 2).requires_grad_()
    got = head.star_gather(f, cells)
    (got * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    for g, w_ in ((f.grad, want_f), (cells.grad, want_l)):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w_,
                                   rtol=1e-5, atol=1e-5 * np.abs(w_).max())
    # the cases the sides were drawn for
    x = np.arange(w)[None, None, :] + np.stack(
        [-ltrb[..., 0], ltrb[..., 2]])
    assert (x < -1).any() and (x > w).any() and (x == w - 1).any()
    assert ((x > w - 1) & (x < w)).any() and (x == 0).any()


# ------------------------------------------------------------- the head
def _scene():
    """Two 64x96 images padded to 6 gts of 2 classes, 6-64 px (the
    squares ATSS sees are 32 px at stride 4, 64 at stride 8, so that
    levels 0 and 1 hold positives), one touching the image's corner;
    padded rows (label 0) with real-looking boxes."""
    gt = np.zeros((2, 6, 4), np.float32)
    gt[0, :4] = [[0, 0, 14, 10], [30, 20, 58, 44], [60, 8, 68, 20],
                 [40, 40, 80, 62]]
    gt[0, 4:] = [[10, 30, 30, 50], [70, 2, 90, 12]]          # padded
    gt[1, :3] = [[4, 36, 10, 58.5], [16, 2, 80, 62], [78, 40, 95, 63]]
    gt[1, 3:] = [[40, 40, 50, 50], [1, 1, 3, 3], [30, 20, 58, 44]]
    valid = np.zeros((2, 6), bool)
    valid[0, :4] = True
    valid[1, :3] = True
    labels = np.zeros((2, 6), np.int32)
    labels[0, :4] = [0, 1, 1, 0]
    labels[1, :3] = [1, 0, 1]
    return dict(gt_bboxes=gt, gt_labels=labels, gt_valid=valid)


def _head_inputs():
    rng = np.random.RandomState(3)
    return [rng.randn(2, h, w, C).astype(np.float32) for h, w in SIZES]


def _port_feats():
    return [_t(f).permute(0, 3, 1, 2) for f in _head_inputs()]


@pytest.fixture(scope="module")
def head_run():
    """The head on seeded features and its scene: JAX's init, outputs,
    losses, gradients and detections, and the port's head with those
    weights."""
    args = {k: v for k, v in HEAD.items() if k != "type"}
    jhead = jvfnet.VFNetHead(test_cfg=dict(TEST_CFG), **args)
    feats = [jnp.asarray(f) for f in _head_inputs()]
    params = _np(_fast(lambda r: jhead.init(r, feats),
                       jax.random.PRNGKey(4))["params"])
    rng = np.random.RandomState(5)
    # the classifier spread and unbiased, so that detections pass
    # score_thr in an order that two frameworks agree on; the initial
    # regression larger, so that the star reaches past neighbouring cells
    cls = params["vfnet_cls"]
    cls["kernel"] = (rng.randn(*cls["kernel"].shape) * 0.3).astype(
        np.float32)
    cls["bias"] = np.zeros_like(cls["bias"])
    reg = params["vfnet_reg"]
    reg["kernel"] = (rng.randn(*reg["kernel"].shape) * 0.1).astype(
        np.float32)
    batch = dict({k: jnp.asarray(v) for k, v in _scene().items()},
                 pad_shape=PAD)

    def step(p):
        outs = jhead.apply({"params": p}, feats, train=True)
        losses = jhead.loss(*outs, batch)
        return _total(losses), (outs, losses)
    (_, (outs, losses)), grads = _fast(
        jax.value_and_grad(step, has_aux=True), params)
    img_shapes = jnp.asarray([[64, 96], [60, 90]], jnp.int32)
    dets = _fast(lambda p: jhead.get_bboxes(
        *jhead.apply({"params": p}, feats), img_shapes, PAD)[0], params)
    head = build_module(dict(HEAD, test_cfg=dict(TEST_CFG)))
    head.load_state_dict({k[len("bbox_head."):]: v for k, v in
                          jax_to_state_dict({"bbox_head_m": params}).items()})
    return dict(head=head, outs=_np(outs),
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_to_state_dict({"bbox_head_m": _np(grads)}),
                dets=_np(dets), img_shapes=np.asarray(img_shapes))


def test_head_outputs_losses_and_grads_match_jax(head_run):
    head = head_run["head"]
    head.zero_grad()
    outs = head(_port_feats())
    batch = dict({k: _t(v) for k, v in _scene().items()}, pad_shape=PAD)
    losses = head.loss(*outs, batch)
    _total(losses).backward()
    assert len(outs) == len(head_run["outs"]) == 3
    for got_lv, want_lv in zip(outs, head_run["outs"]):
        for g, w in zip(got_lv, want_lv):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.detach().permute(0, 2, 3, 1).numpy(), w, rtol=1e-5,
                atol=1e-5 * np.abs(w).max())
    want = head_run["losses"]
    assert want["num_pos"] >= 10
    assert set(losses) == set(want) == {"loss_cls", "loss_bbox",
                                        "loss_bbox_rf", "num_pos"}
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=1e-5,
                                   err_msg=k)
    grads = {"bbox_head." + n: p.grad for n, p in head.named_parameters()}
    assert set(grads) == set(head_run["grads"])
    # levels 2-4 (squares of 128 px and up on a 64x96 image) hold no
    # positive, so their refine scales take no gradient, in both packages
    zero = {f"bbox_head.scales_refine.{i}.scale" for i in (2, 3, 4)}
    for n, w in head_run["grads"].items():
        w = w.numpy()
        assert (np.abs(w).max() == 0) == (n in zero), n
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


# -------------------------------------------------- the tiled protocol
def test_tiled_vfnet_matches_jax(tmp_path):
    tiled_slice_matches_jax(tmp_path, "vfnet", VFNET_MODEL,
                            [(("bbox_head_m",), "vfnet_cls", 0.3)])


# --------------------------------------------------- the configurations
@pytest.mark.parametrize("name", CONFIGS)
def test_configs_load_the_jax_tree(name):
    """Toy width: the port's parameters are the JAX model's tree, each
    parameter's flax path maps back to its name, and a forward on a 64x96
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
    tree = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, np.float32),
                                  shapes)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    load_jax_variables(model, tree["params"], tree.get("batch_stats"))
    assert all(bool((p == 0.5).all()) for p in model.parameters())
    paths = jax_param_paths(model)
    assert paths["bbox_head.scales_refine.4.scale"] == \
        "bbox_head_m.scale_refine4.scale"
    assert paths["bbox_head.reg_refine_dcn.weight"] == \
        "bbox_head_m.reg_refine_dcn.kernel"
    model.load_state_dict(sd)
    img = torch.from_numpy(np.random.RandomState(7).randn(
        2, 64, 96, 3).astype(np.float32))
    with torch.no_grad():
        dets = model.simple_test(img, torch.tensor([[64, 96]] * 2))
    assert bool(torch.isfinite(dets.bboxes).all())

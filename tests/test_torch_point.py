"""The point stack's modules in the port against the JAX package's, on the
same seeded numpy inputs: PointGenerator, the GN ConvModule, the FPN with
the configs' `norm_cfg`, the match costs, the top-k auction, the bilinear
point sampling, the MIL loss, point AP, and Adam in the JAX chain. Each
test states its tolerance.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pointtinybenchmark_tpu.data.coco import COCO
from pointtinybenchmark_tpu.evaluation.location_eval import \
    LocationEvaluator as JaxLocationEvaluator
from pointtinybenchmark_tpu_torch.core import assigners
from pointtinybenchmark_tpu_torch.core.anchors import PointGenerator
from pointtinybenchmark_tpu_torch.core.assigners import (HungarianAssignerV2,
                                                         topk_auction_match)
from pointtinybenchmark_tpu_torch.core.match_costs import (DisCostV2,
                                                           FocalLossCost,
                                                           ZeroCost)
from pointtinybenchmark_tpu_torch.engine.optimizer import (Adam,
                                                           build_lr_schedule,
                                                           build_optimizer)
from pointtinybenchmark_tpu_torch.evaluation.location_eval import \
    LocationEvaluator
from pointtinybenchmark_tpu_torch.models.losses import MILLoss, accuracy
from pointtinybenchmark_tpu_torch.models.necks.fpn import FPN
from pointtinybenchmark_tpu_torch.models.utils import ConvModule
from pointtinybenchmark_tpu_torch.ops.grid_sample import point_sample_pixel

janchors = importlib.import_module("pointtinybenchmark_tpu.core.anchors")
jassign = importlib.import_module("pointtinybenchmark_tpu.core.assigners")
jcosts = importlib.import_module("pointtinybenchmark_tpu.core.match_costs")
jutils = importlib.import_module("pointtinybenchmark_tpu.models.utils")
jgrid = importlib.import_module("pointtinybenchmark_tpu.ops.grid_sample")
jmil = importlib.import_module("pointtinybenchmark_tpu.models.losses.mil_loss")
jlutils = importlib.import_module("pointtinybenchmark_tpu.models.losses.utils")
jbuild = importlib.import_module("pointtinybenchmark_tpu.models.builder")
jopt = importlib.import_module("pointtinybenchmark_tpu.engine.optimizer")


def _t(x):
    return torch.from_numpy(np.array(x))


def conv_w(k):
    """flax HWIO kernel -> torch OIHW weight."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1).copy())


# ---------------------------------------------------------------- anchors
@pytest.mark.parametrize("size,stride,valid", [
    ((16, 20), 4, (16, 20)), ((7, 9), 8, (5, 9)), ((3, 1), 16, (0, 1))])
def test_point_generator_bit_exact(size, stride, valid):
    j, p = janchors.PointGenerator(), PointGenerator()
    want, got = j.grid_points(size, stride), p.grid_points(size, stride)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(p.valid_flags(size, valid),
                          j.valid_flags(size, valid))


# ------------------------------------------------------------- GN, the FPN
@pytest.mark.parametrize("groups,cin,cout,act", [(4, 8, 16, True),
                                                 (32, 64, 64, False)])
def test_gn_conv_module_matches_jax(groups, cin, cout, act):
    """conv (no bias) -> GroupNorm(eps 1e-5, random scale and bias) ->
    relu: within 1e-5 of the largest output. flax computes the variance
    as E[x^2] - E[x]^2, torch as E[(x - mean)^2]; the difference found
    here is ~1e-6 of the largest output."""
    rng = np.random.RandomState(groups)
    x = rng.randn(2, 12, 10, cin).astype(np.float32) * 3 + 1
    jm = jutils.ConvModule(cout, 3, norm="GN", num_groups=groups, act=act)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["GroupNorm_0"]["scale"] = rng.rand(cout).astype(np.float32) + 0.5
    params["GroupNorm_0"]["bias"] = rng.randn(cout).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = ConvModule(cin, cout, 3, norm="GN", num_groups=groups, act=act)
    assert tm.conv.bias is None
    with torch.no_grad():
        tm.conv.weight.copy_(conv_w(params["Conv_0"]["kernel"]))
        tm.gn.weight.copy_(_t(params["GroupNorm_0"]["scale"]))
        tm.gn.bias.copy_(_t(params["GroupNorm_0"]["bias"]))
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_conv_module_refuses_bn():
    with pytest.raises(NotImplementedError, match="BN"):
        ConvModule(8, 8, norm="BN")


def test_fpn_with_norm_cfg_matches_jax_fpn_without_norm():
    """The point configs' FPN (num_outs 1, `norm_cfg` GN): the JAX builder
    drops `norm_cfg`, the port's FPN takes it and builds no norm; the
    stride-4 output within 1e-5 of the largest."""
    cfg = dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16,
               start_level=0, add_extra_convs="on_input", num_outs=1,
               norm_cfg=dict(type="GN", num_groups=4))
    jm = jbuild.build_neck(dict(cfg))
    rng = np.random.RandomState(0)
    ins = [rng.randn(1, 32 // 2 ** i, 40 // 2 ** i, c).astype(np.float32)
           for i, c in enumerate(cfg["in_channels"])]
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), [jnp.asarray(x) for x in ins])["params"])
    assert sorted(params) == ["fpn_conv0"] + [f"lateral_conv{i}"
                                              for i in range(4)]
    want = jm.apply({"params": params}, [jnp.asarray(x) for x in ins])
    args = {k: v for k, v in cfg.items() if k != "type"}
    tm = FPN(**args)
    assert not any(isinstance(m, torch.nn.GroupNorm) for m in tm.modules())
    with torch.no_grad():
        for i in range(4):
            tm.lateral_convs[i].conv.weight.copy_(conv_w(
                params[f"lateral_conv{i}"]["kernel"]))
            tm.lateral_convs[i].conv.bias.copy_(_t(
                params[f"lateral_conv{i}"]["bias"]))
        tm.fpn_convs[0].conv.weight.copy_(conv_w(params["fpn_conv0"]["kernel"]))
        tm.fpn_convs[0].conv.bias.copy_(_t(params["fpn_conv0"]["bias"]))
        got = tm([_t(x).permute(0, 3, 1, 2) for x in ins])
    assert len(got) == len(want) == 1
    w = np.asarray(want[0])
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), w,
                               atol=1e-5 * np.abs(w).max())


# ----------------------------------------------------------- match costs
def _cost_inputs(seed=0, b=2, n=300, g=7, c=3):
    rng = np.random.RandomState(seed)
    return dict(cls=(rng.randn(b, n, c) * 3).astype(np.float32),
                pred=(rng.rand(b, n, 2) * 200).astype(np.float32),
                gt=(rng.rand(b, g, 2) * 200).astype(np.float32),
                labels=rng.randint(0, c, (b, g)).astype(np.int32),
                valid=rng.rand(b, g) > 0.3,
                shape=np.asarray([[160, 200], [150, 190]], np.int32))


@pytest.mark.parametrize("cost", [
    dict(type="FocalLossCost", weight=2.0),
    dict(type="FocalLossCost", weight=1.0, alpha=0.5, gamma=1.0),
    dict(type="DisCostV2", weight=0.1, norm_with_img_wh=False),
    dict(type="DisCostV2", weight=1.0, norm_with_img_wh=True),
    dict(type="DisCostV2", weight=1.0, norm_with_img_wh=False, p=2),
    dict(type="DisCostV2", weight=1.0, norm_with_img_wh=False, p=3)])
def test_match_costs_match_jax(cost):
    """Each cost, batched, against the JAX cost per image: 1e-6 of the
    largest |cost|."""
    d = _cost_inputs()
    args = {k: v for k, v in cost.items() if k != "type"}
    port = {"FocalLossCost": FocalLossCost, "DisCostV2": DisCostV2}[
        cost["type"]](**args)
    jc = getattr(jcosts, cost["type"])(**args)
    if cost["type"] == "FocalLossCost":
        got = port(_t(d["cls"]), _t(d["labels"])).numpy()
        want = np.stack([np.asarray(jc(jnp.asarray(d["cls"][i]),
                                       jnp.asarray(d["labels"][i])))
                         for i in range(2)])
    else:
        got = port(_t(d["pred"]), _t(d["gt"]), _t(d["shape"])).numpy()
        want = np.stack([np.asarray(jc(
            jnp.asarray(d["pred"][i]), jnp.asarray(d["gt"][i]),
            {"img_shape": jnp.asarray(d["shape"][i])})) for i in range(2)])
    assert got.shape == want.shape == (2, 300, 7)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_assigner_cost_matrix_matches_jax():
    """HungarianAssignerV2.cost_matrix with the P2P config's costs (and a
    ZeroCost), padded gt columns at BIG: 1e-6 of the largest."""
    d = _cost_inputs(1)
    cfg = dict(cls_costs=[dict(type="FocalLossCost", weight=2.0)],
               reg_costs=[dict(type="DisCostV2", weight=0.1,
                               norm_with_img_wh=False),
                          dict(type="ZeroCost")], topk_k=5)
    assert ZeroCost()(1, 2) == 0.0
    ja = jassign.HungarianAssignerV2(**cfg)
    want = np.stack([np.asarray(ja.cost_matrix(
        jnp.asarray(d["pred"][i]), jnp.asarray(d["cls"][i]),
        jnp.asarray(d["gt"][i]), jnp.asarray(d["labels"][i]),
        {"img_shape": jnp.asarray(d["shape"][i])},
        jnp.asarray(d["valid"][i]))) for i in range(2)])
    got = HungarianAssignerV2(**cfg).cost_matrix(
        _t(d["pred"]), _t(d["cls"]), _t(d["gt"]), _t(d["labels"]),
        _t(d["shape"]), _t(d["valid"])).numpy()
    assert (got[~np.broadcast_to(d["valid"][:, None], got.shape)]
            == 1e8).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 200)


# ---------------------------------------------------------------- auction
def _p2p_cost(seed, b, n, g, n_valid, pad_preds=0):
    """A P2P cost matrix computed by JAX: focal x2 + distance x0.1 of
    predictions spread over a 64x80 map to gts, padded gts at BIG, the
    last `pad_preds` predictions invalid (1e8), as P2PHead.loss builds
    it."""
    rng = np.random.RandomState(seed)
    pred = (rng.rand(b, n, 2) * [320, 256]).astype(np.float32)
    cls = (rng.randn(b, n, 1) * 2).astype(np.float32)
    gt = (rng.rand(b, g, 2) * [320, 256]).astype(np.float32)
    valid = np.zeros((b, g), bool)
    for i, v in enumerate(n_valid):
        valid[i, :v] = True
    ja = jassign.HungarianAssignerV2(
        cls_costs=dict(type="FocalLossCost", weight=2.0),
        reg_costs=dict(type="DisCostV2", weight=0.1, norm_with_img_wh=False),
        topk_k=1)
    cost = np.stack([np.asarray(ja.cost_matrix(
        jnp.asarray(pred[i]), jnp.asarray(cls[i]), jnp.asarray(gt[i]),
        jnp.zeros((g,), jnp.int32), {"img_shape": jnp.asarray([256, 320])},
        jnp.asarray(valid[i]))) for i in range(b)])
    if pad_preds:
        cost[:, -pad_preds:] = 1e8
    return cost, valid


@pytest.fixture(autouse=True)
def _count_syncs():
    for k in assigners.auction_stats:
        assigners.auction_stats[k] = 0


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("case", ["p2p", "ties", "pad_preds"])
def test_auction_equals_jax(k, case):
    """The port's assignment equal to JAX's `topk_auction_match` on JAX's
    own cost matrix, padded gts (and an image with none) included: P2P
    costs, integer costs with ties, and invalid predictions at 1e8."""
    b, n, g = 3, 240, 12
    if case == "ties":
        rng = np.random.RandomState(k)
        cost = rng.randint(0, 6, (b, n, g)).astype(np.float32)
        valid = np.arange(g)[None] < np.asarray([12, 5, 0])[:, None]
    else:
        cost, valid = _p2p_cost(k, b, n, g, (12, 7, 0),
                                pad_preds=40 if case == "pad_preds" else 0)
    want = np.asarray(jassign.topk_auction_match(jnp.asarray(cost),
                                                 jnp.asarray(valid), k))
    got = topk_auction_match(_t(cost), _t(valid), k).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    counts = [np.bincount(got[i], minlength=g + 1)[1:] for i in range(b)]
    for i in range(b):
        assert (counts[i] == np.where(valid[i], k, 0)).all(), counts[i]
    assert assigners.auction_stats["rounds"] == k
    assert assigners.auction_stats["iterations"] > 0
    assert assigners.auction_stats["syncs"] >= k


def test_auction_k1_within_the_bound_of_scipy():
    """k=1: the assignment's total cost within G * eps_eff (0.5% of the
    cost range, + 1e-3) of scipy's optimum (tests/test_assigners_extra.py's
    bound), on P2P costs."""
    from scipy.optimize import linear_sum_assignment
    cost, valid = _p2p_cost(11, 4, 200, 10, (10, 10, 6, 3))
    got = topk_auction_match(_t(cost), _t(valid), 1).numpy()
    for i in range(4):
        c = cost[i][:, valid[i]]
        r, col = linear_sum_assignment(c)
        want = c[r, col].sum()
        rows = np.nonzero(got[i])[0]
        total = cost[i][rows, got[i][rows] - 1].sum()
        tol = float(c.max() - c.min()) * 5e-3 + 1e-3
        assert want - tol <= total <= want + tol, (i, total, want)


def test_auction_iteration_cap_completes_greedily():
    """At max_iters the unmatched valid gts take their best free
    prediction in gt order, as JAX's completion does: equal to JAX at a
    cap of 1 and 2 iterations."""
    cost, valid = _p2p_cost(5, 2, 60, 8, (8, 6))
    for cap in (1, 2):
        want = np.asarray(jassign.topk_auction_match(
            jnp.asarray(cost), jnp.asarray(valid), 2, max_iters=cap))
        got = topk_auction_match(_t(cost), _t(valid), 2,
                                 max_iters=cap).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- point sampling
@pytest.mark.parametrize("points", ["spread", "bags"])
def test_point_sample_pixel_and_grads_match_jax(points):
    """Values, and gradients with respect to the map and the points, of a
    weighted sum, with border padding (CPR's): 1e-6 of the largest.
    "spread": points inside, on cell centres, on the border and outside
    the map; "bags": CPR rings of radius 1-3 cells round points, several
    bags sharing cells."""
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 9, 11, 5).astype(np.float32)
    if points == "spread":
        pts = np.concatenate([
            rng.uniform(-2, 12, (2, 40, 2)),
            rng.randint(0, 9, (2, 6, 2)).astype(np.float64),
            np.asarray([[[0.0, 0.0], [10.0, 8.0], [10.0, 3.5],
                         [-0.25, 8.0]]] * 2)], 1).astype(np.float32)
    else:
        from pointtinybenchmark_tpu_torch.models.dense_heads.cpr_head import \
            circle_offsets
        centres = rng.uniform(0, [11, 9], (2, 5, 1, 2))
        pts = (centres + circle_offsets(3)).reshape(2, -1, 2).astype(
            np.float32)
    wts = rng.randn(2, pts.shape[1], 5).astype(np.float32)

    def jloss(f, p):
        return (jgrid.point_sample_pixel(f, p, "border") * wts).sum()
    want = np.asarray(jgrid.point_sample_pixel(jnp.asarray(feat),
                                               jnp.asarray(pts), "border"))
    jgf, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feat),
                                               jnp.asarray(pts))
    f = _t(feat).requires_grad_()
    p = _t(pts).requires_grad_()
    got = point_sample_pixel(f, p)
    (got * _t(wts)).sum().backward()
    for a, b_ in ((got.detach(), want), (f.grad, jgf), (p.grad, jgp)):
        b_ = np.asarray(b_)
        np.testing.assert_allclose(a.numpy(), b_,
                                   atol=1e-6 * np.abs(b_).max())


# --------------------------------------------------------------- losses
@pytest.mark.parametrize("valid_kind", ["mask", "weights", "per_class"])
def test_mil_loss_with_an_empty_bag_matches_jax(valid_kind):
    """Bags with padded points and one bag with no valid point: loss,
    accuracy and count within 1e-6, and the gradients within 1e-6 of the
    largest; the empty bag's gradient is 0 and every gradient finite.
    `valid` as CPR hands it: a 0/1 mask (B, N, 1), the mask times gt
    weights in (0, 1], or a per-class mask (B, N, C)."""
    rng = np.random.RandomState(4)
    b, n, c = 5, 9, 3
    prob = rng.rand(b, n, c).astype(np.float32)
    ins = rng.randn(b, n, c).astype(np.float32)
    labels = rng.randint(0, c, b).astype(np.int32)
    shape = (b, n, c) if valid_kind == "per_class" else (b, n, 1)
    valid = (rng.rand(*shape) > 0.3).astype(np.float32)
    if valid_kind == "weights":
        valid *= rng.uniform(0.2, 1.0, (b, 1, 1)).astype(np.float32)
    valid[2] = 0.0
    args = dict(loss_weight=0.25)

    def jf(p, i):
        return jmil.MILLoss(**args)(p, i, jnp.asarray(labels),
                                    jnp.asarray(valid))
    want = [float(v) for v in jf(jnp.asarray(prob), jnp.asarray(ins))]
    jgp, jgi = jax.grad(lambda p, i: jf(p, i)[0], argnums=(0, 1))(
        jnp.asarray(prob), jnp.asarray(ins))
    p, i = _t(prob).requires_grad_(), _t(ins).requires_grad_()
    got = MILLoss(**args)(p, i, _t(labels), _t(valid))
    got[0].backward()
    np.testing.assert_allclose([float(v.detach()) for v in got], want,
                               rtol=1e-6)
    for g, w in ((p.grad, jgp), (i.grad, jgi)):
        assert torch.isfinite(g).all()
        assert float(g[2].abs().max()) == 0.0
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-6 * np.abs(np.asarray(w)).max())


def test_accuracy_matches_jax():
    rng = np.random.RandomState(5)
    pred = rng.rand(50, 4).astype(np.float32)
    target = rng.randint(0, 4, 50)
    mask = rng.rand(50) > 0.4
    for m in (None, mask, np.zeros(50, bool)):
        want = float(jlutils.accuracy(jnp.asarray(pred), jnp.asarray(target),
                                      None if m is None else jnp.asarray(m)))
        got = float(accuracy(_t(pred), _t(target),
                             None if m is None else _t(m)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


# ------------------------------------------------------------- point AP
def test_location_evaluator_equals_jax():
    """The same detections and gts (boxes, explicit points, an ignored
    gt, two classes, two images): every AP and AR entry equal."""
    rng = np.random.RandomState(6)
    anns, dets = [], []
    for img in (1, 2):
        for j in range(12):
            x, y = rng.uniform(10, 180, 2)
            w, h = rng.uniform(4, 20, 2)
            a = dict(image_id=img, category_id=1 + j % 2, bbox=[x, y, w, h],
                     ignore=int(j == 5))
            if j % 3 == 0:
                a["point"] = [x + w * 0.3, y + h * 0.6]
            anns.append(a)
            for _ in range(2):
                dets.append(dict(image_id=img, category_id=1 + j % 2,
                                 point=[x + w / 2 + rng.randn() * w,
                                        y + h / 2 + rng.randn() * h],
                                 score=float(rng.rand())))
    gt = COCO(dict(
        images=[dict(id=i, width=200, height=200, file_name=f"{i}.jpg")
                for i in (1, 2)],
        annotations=[dict(id=j + 1, iscrowd=0, area=a["bbox"][2] * a["bbox"][3],
                          **a) for j, a in enumerate(anns)],
        categories=[dict(id=c, name=f"c{c}") for c in (1, 2)]))
    kw = dict(location_param=dict(matchThs=[0.5, 1.0, 2.0], maxDets=[5, 300],
                                  recThrs="np.linspace(.0, 1.00, 101)"))
    want = JaxLocationEvaluator(**kw)(dets, gt)
    got = LocationEvaluator(**kw)(dets, gt)
    assert want["AP"] > 0 and got == want


# ----------------------------------------------------------------- Adam
class _Tiny(torch.nn.Module):
    """Parameter names that frozen_param_names(model, 1) freezes
    (backbone.conv1, backbone.layer1.*) beside trained ones."""

    def __init__(self, shapes):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.conv1 = torch.nn.Conv2d(1, 1, 1, bias=False)
        self.backbone.layer1 = torch.nn.Linear(1, 1)
        self.head = torch.nn.Linear(1, 1)
        with torch.no_grad():
            for (name, shape), p in zip(shapes.items(), self.parameters()):
                p.set_(torch.zeros(shape))


def test_adam_step_matches_optax_chain():
    """Three updates of build_optimizer's Adam (grad_clip 35, linear
    warmup, frozen stage 1) against optax's chain clip -> adam(schedule)
    -> masked set_to_zero, from the same parameters and gradients, the
    second step's gradients non-finite and so skipped (parameters,
    moments and count unchanged on both sides): parameters within 1e-6 of
    each one's max."""
    rng = np.random.RandomState(8)
    shapes = {"backbone.conv1.weight": (1, 1, 3, 3),
              "backbone.layer1.weight": (4, 6), "backbone.layer1.bias": (4,),
              "head.weight": (5, 7), "head.bias": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 30).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    grads[1]["head.bias"][0] = np.nan
    opt_cfg = dict(type="Adam", lr=1e-2)
    clip = dict(grad_clip=dict(max_norm=35, norm_type=2))
    lr_cfg = dict(policy="step", warmup="linear", warmup_iters=2,
                  warmup_ratio=1.0 / 3, step=[8, 11])

    frozen = {k: k.startswith("backbone.") for k in shapes}
    tx = jopt.build_optimizer(dict(opt_cfg), clip, lr_cfg, 1, 12,
                              param_mask=lambda p: frozen, by_epoch=False)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, new_state = tx.update(jg, state, params)
        if all(np.isfinite(v).all() for v in g.values()):
            params, state = optax.apply_updates(params, upd), new_state

    model = _Tiny(shapes)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(_t(init[n]))
    opt = build_optimizer(model, dict(opt_cfg), clip, lr_cfg, 1, 12,
                          frozen_stages=1, by_epoch=False)
    assert isinstance(opt, Adam)
    for g in grads:
        for n, p in model.named_parameters():
            p.grad = _t(g[n])
        ok = torch.tensor(all(np.isfinite(v).all() for v in g.values()))
        opt.step(ok)
    assert int(opt.count) == 2
    for n, p in model.named_parameters():
        w = np.asarray(params[n])
        if frozen[n]:
            assert np.array_equal(p.detach().numpy(), init[n])
        assert not np.allclose(w, init[n]) or frozen[n]
        np.testing.assert_allclose(p.detach().numpy(), w,
                                   atol=1e-6 * np.abs(w).max())
    sched = build_lr_schedule(1e-2, lr_cfg, 1, 12, by_epoch=False)
    assert float(opt.lr()) == pytest.approx(float(sched(2)))


def test_adam_refuses_what_the_jax_chain_does_not_build():
    model = _Tiny({"backbone.conv1.weight": (1, 1, 1, 1),
                   "backbone.layer1.weight": (1, 1),
                   "backbone.layer1.bias": (1,), "head.weight": (1, 1),
                   "head.bias": (1,)})
    for cfg in (dict(type="Adam", lr=1e-3, weight_decay=1e-4),
                dict(type="Adam", lr=1e-3, betas=(0.8, 0.9)),
                dict(type="AdamW", lr=1e-3)):
        with pytest.raises(NotImplementedError):
            build_optimizer(model, cfg)


# ------------------------------------------------- K1 at P2P's threshold
@pytest.mark.parametrize("x_offset", [0, 79 * 641])
def test_square_threshold_ties_at_p2p_threshold(x_offset):
    """chip_smoke.square_tie_boxes: pairs of 16x16 boxes whose float32 IoU
    is 0.01 (P2P's NMS threshold) or one of its float neighbours, also
    moved right by class 79's offset; the plain bitmask (the reference the
    card's kernel is held to) suppresses exactly the pairs above 0.01."""
    from chip_smoke import square_tie_boxes
    from pointtinybenchmark_tpu_torch.ops import nms_cuda
    boxes, iou = square_tie_boxes(0.01, x_offset=x_offset)
    t = np.float32(0.01)
    assert sorted(set(iou.tolist())) == sorted({
        float(np.nextafter(t, np.float32(-1))), float(t),
        float(np.nextafter(t, np.float32(2)))})
    assert np.abs(boxes[:, 2:] - boxes[:, :2] - 16).max() < 1e-4
    mask = nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes)[None], 0.01)
    p = len(iou)
    want = np.zeros((2 * p, 2 * p), bool)
    for k in range(p):
        want[2 * k, 2 * k + 1] = iou[k] > t
    bits = (mask[0, :, 0, None] >> torch.arange(2 * p)) & 1
    np.testing.assert_array_equal(bits.numpy().astype(bool), want)


def test_unported_point_options_raise():
    """The options no config of the repo sets raise instead of building
    another network: CPR's fc layers, softmax probabilities and max
    scores, the MIL loss's binary instance branch, P2P's assignment on
    the anchors."""
    from pointtinybenchmark_tpu_torch.models.builder import build_module
    cpr = dict(type="CPRHead", num_classes=1, in_channels=8,
               feat_channels=8, stacked_convs=1,
               norm_cfg=dict(type="GN", num_groups=4))
    for extra in (dict(num_cls_fcs=1),
                  dict(normal_cfg=dict(prob_cls_type="softmax")),
                  dict(point_refiner=dict(return_score_type="max"))):
        with pytest.raises(NotImplementedError):
            build_module(dict(cpr, **extra))
    with pytest.raises(NotImplementedError):
        MILLoss(binary_ins=True)
    with pytest.raises(NotImplementedError):
        build_module(dict(type="P2PHead", num_classes=1, in_channels=8,
                          feat_channels=8, assign_before_pred=True))


def test_collator_point_keys_match_jax():
    """DetCollator's gt_true_bboxes (padded to max_gt) and gt_anns_id
    (int64, -1 in the empty rows) equal the JAX collator's."""
    from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    rng = np.random.RandomState(9)
    samples = []
    for n in (3, 0, 5):
        boxes = rng.rand(n, 4).astype(np.float32) * 50
        samples.append(dict(img=rng.rand(20, 30, 3).astype(np.float32),
                            gt_bboxes=boxes, gt_labels=np.zeros(n, np.int64),
                            gt_true_bboxes=boxes + 1.0,
                            gt_anns_id=np.arange(n) + 10 * n))
    want = JaxCollator(pad_shape=(32, 32), max_gt=4)(samples)
    got = DetCollator(pad_shape=(32, 32), max_gt=4)(samples)
    for k in ("gt_true_bboxes", "gt_anns_id", "gt_bboxes", "gt_valid"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

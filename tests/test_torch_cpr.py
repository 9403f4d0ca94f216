"""CPR in the port against the JAX package, on the same JAX-initialized
weights and the same seeded inputs.

The head alone, on seeded feature maps and gt points with two refine
points per gt (R=2) and padded gts, three classes, class-wise negatives,
at each `refine_bag_policy`, with a grid generator (Grid and GridEllipse)
and with CascadeCPRHead, and with the gt loss of the DOTA cascade config
(`gt_loss_type` "gt"): the bag outputs, the losses (the bag-point drop off, and on with
JAX's own keep mask injected), the gradients, and `refine`. Then the
whole slice, a ResNet-18 (base 8) BasicLocator with an FPN 16 and a
1-conv GN(4) CPRHead: a train step's losses and gradients, and
`run_refine_test` rows with both packages' collators. The cls_out
classifier is redrawn (the same numbers on both sides) so that bag
scores pass merge_th and points really refine. The CPR state dict round
trips through tools/model_converters/torch2jax.py.
"""
import importlib
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.test import run_refine_test
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.builder import build_module
from pointtinybenchmark_tpu_torch.models.dense_heads import cpr_head
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools",
                            "model_converters"))
from torch2jax import convert_detector_state_dict  # noqa: E402

jcpr = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.cpr_head")
jtest = importlib.import_module("pointtinybenchmark_tpu.engine.test")

C, G, R, HW, STRIDE = 3, 6, 2, (64, 80), 4


def head_cfg(policy="independent_with_gt_bag", pos="CirclePtFeatGenerator",
             cascade=False, gt_type="gt_refine", classify=True):
    pos_gen = dict(type=pos, radius=2)
    if pos == "GridEllipsePtFeatGenerator":
        pos_gen.update(a_minus_c=1.0)
    return dict(
        type="CascadeCPRHead" if cascade else "CPRHead",
        num_classes=C, in_channels=16, feat_channels=16, stacked_convs=2,
        num_cls_fcs=0, strides=[STRIDE],
        norm_cfg=dict(type="GN", num_groups=4),
        loss_mil=dict(type="MILLoss", binary_ins=False, loss_weight=0.25),
        loss_cfg=dict(with_neg=True, neg_loss_weight=0.75,
                      refine_bag_policy=policy, random_remove_rate=0.4,
                      with_gt_loss=True, gt_loss_weight=0.125,
                      gt_loss_type=gt_type, with_mil_loss=True),
        normal_cfg=dict(prob_cls_type="sigmoid", out_bg_cls=False),
        train_pts_extractor=dict(
            pos_generator=dict(pos_gen),
            neg_generator=dict(type="OutCirclePtFeatGenerator", radius=2,
                               class_wise=True)),
        refine_pts_extractor=dict(
            pos_generator=dict(pos_gen),
            neg_generator=dict(type="OutCirclePtFeatGenerator", radius=2,
                               keep_wh=True, class_wise=True)),
        point_refiner=dict(merge_th=0.1, refine_th=0.1,
                           classify_filter=classify, nearest_filter=True))


CASES = {
    "independent": dict(policy="independent_with_gt_bag"),
    "merge": dict(policy="merge_to_gt_bag"),
    "only_refine": dict(policy="only_refine_bag"),
    "grid": dict(pos="GridPtFeatGenerator"),
    "ellipse": dict(pos="GridEllipsePtFeatGenerator", classify=False),
    "cascade": dict(cascade=True),
    # the DOTA cascade config's gt loss on the first refine point only
    "gt_loss_gt": dict(gt_type="gt", policy="merge_to_gt_bag"),
}


def _head_inputs(seed=0):
    """feats (2, 16, 20, 16) NHWC; gts: 6 a padded image, 4 and 3 valid,
    two refine points each (some near the border), classes 0-2."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, HW[0] // STRIDE, HW[1] // STRIDE, 16).astype(
        np.float32)
    pts = rng.uniform(-2, [HW[1] + 2, HW[0] + 2], (2, G, 1, 2))
    pts = (pts + np.concatenate([np.zeros((2, G, 1, 2)),
                                 rng.randn(2, G, 1, 2) * 3], 2)).astype(
        np.float32)
    valid = np.arange(G)[None] < np.asarray([4, 3])[:, None]
    return feats, dict(gt_points=pts,
                       gt_labels=rng.randint(0, C, (2, G)).astype(np.int32),
                       gt_valid=valid,
                       img_shape=np.asarray([HW, (60, 70)], np.int32))


def _port_head(cfg, params):
    """The port's head with the JAX head's params (scope bbox_head_m)."""
    head = build_module(dict(cfg))
    sd = {k[len("bbox_head."):]: v
          for k, v in jax_to_state_dict({"bbox_head_m": params}).items()}
    head.load_state_dict(sd, strict=True)
    return head


def _spread(params, seed=1, scale=0.5):
    p = jax.tree_util.tree_map(np.array, params)
    k = p["cls_out"]["kernel"]
    p["cls_out"]["kernel"] = (np.random.RandomState(seed).randn(*k.shape)
                              * scale).astype(np.float32)
    p["cls_out"]["bias"] = np.zeros_like(p["cls_out"]["bias"])
    return p


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, cfg, JAX head, its params, the port's head, inputs)."""
    cfg = head_cfg(**CASES[request.param])
    args = {k: v for k, v in cfg.items() if k != "type"}
    jh = getattr(jcpr, cfg["type"])(**args)
    feats, batch = _head_inputs()
    if CASES[request.param].get("cascade"):
        # each stage re-extracts bags at one point per gt
        batch["gt_points"] = batch["gt_points"][:, :, :1]
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, pad_shape=HW)
    params = _spread(jh.init(jax.random.PRNGKey(0), [jnp.asarray(feats)], jb,
                             mode="train")["params"])
    return request.param, cfg, jh, params, _port_head(cfg, params), feats, \
        batch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_grads_close(got, want, rtol=1e-4):
    """Each gradient within rtol of its own max |grad|, that max floored at
    1e-6 of the largest gradient of all: the instance branch's bias has an
    exact gradient of 0 (the bag softmax does not change when a constant
    is added), so both frameworks give it only rounding noise."""
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for n, g in got.items():
        w = want[n]
        err = float(np.abs(g - w).max())
        assert err <= rtol * max(np.abs(w).max(), floor), (n, err)


def _tb(batch):
    return dict({k: torch.from_numpy(v) for k, v in batch.items()},
                pad_shape=HW)


def _tfeats(feats):
    return [torch.from_numpy(feats).permute(0, 3, 1, 2)]


def test_bag_outputs_match_jax(case):
    """Bag points and validity equal, the bags' class and instance outputs
    within 1e-5 of the largest, the grid's class outputs too."""
    _, _, jh, params, head, feats, batch = case
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, pad_shape=HW)
    want = jh.apply({"params": params}, [jnp.asarray(feats)], jb,
                    mode="train")
    with torch.no_grad():
        got = head(_tfeats(feats), _tb(batch), mode="train")
    assert got["feat_hw"] == tuple(want["feat_hw"])
    np.testing.assert_array_equal(got["bag_valid"].numpy(),
                                  np.asarray(want["bag_valid"]))
    assert got["bag_valid"].any()
    for k in ("bag_pts", "bag_cls_outs", "bag_ins_outs", "grid_cls_outs"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("drop", ["off", "jax_mask"])
def test_losses_and_grads_match_jax(case, drop, monkeypatch):
    """The losses within 1e-5 relative (bag_acc equal), and the gradients
    of their sum with respect to every parameter and the feature map
    within 1e-4 of each one's max |grad| (assert_grads_close). With the
    drop off JAX gets no rng and the port no generator; `jax_mask` runs the drop at 0.4 with
    JAX's keep mask of key 7 handed to the port."""
    _, cfg, jh, params, head, feats, batch = case
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, pad_shape=HW)
    rng = jax.random.PRNGKey(7) if drop == "jax_mask" else None

    def jloss(p, f):
        out = jh.apply({"params": p}, [f], jb, mode="train")
        losses = jh.loss(out, jb, rng=rng)
        return sum(v for k, v in losses.items() if k.startswith("loss")), \
            (losses, out["bag_valid"].shape)
    (_, (want, shape)), (gp, gf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(feats))
    gen = None
    if drop == "jax_mask":
        keep = np.asarray(jax.random.uniform(rng, shape) >= 0.4)
        monkeypatch.setattr(cpr_head, "bag_keep_mask",
                            lambda *a: torch.from_numpy(keep.copy()))
        gen = torch.Generator()
    f = _tfeats(feats)[0].requires_grad_()
    tb = _tb(batch)
    head.zero_grad(set_to_none=True)
    got = head.loss(head([f], tb, mode="train"), tb, gen)
    sum(v for k, v in got.items() if k.startswith("loss")).backward()
    assert set(got) == set(want) == {"loss_gt", "loss_pos", "bag_acc",
                                     "loss_neg"}
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    jg = {k[len("bbox_head."):]: v.numpy() for k, v in jax_to_state_dict(
        {"bbox_head_m": jax.tree_util.tree_map(np.asarray, gp)}).items()}
    grads = {n: p.grad.numpy() for n, p in head.named_parameters()}
    grads["feats"], jg["feats"] = f.grad.permute(0, 2, 3, 1).numpy(), \
        np.asarray(gf)
    assert set(grads) == set(jg)
    assert_grads_close(grads, jg)


def test_refine_matches_jax(case):
    """refine (and for the cascade, cascade_refine): refined points and
    scores within 1e-5 of the largest, not_refine equal, some points
    refined and some not."""
    name, _, jh, params, head, feats, batch = case
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()}, pad_shape=HW)
    mode = "cascade_refine" if name == "cascade" else "refine"
    out = jh.apply({"params": params}, [jnp.asarray(feats)], jb, mode=mode)
    want = out if mode == "cascade_refine" else jh.refine(out, jb)
    with torch.no_grad():
        out = head(_tfeats(feats), _tb(batch), mode=mode)
        got = out if mode == "cascade_refine" else head.refine(out,
                                                               _tb(batch))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    nr = np.asarray(want[2])[batch["gt_valid"]]
    assert not nr.all(), nr
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max())


# -------------------------------------------------------- the whole slice
SLICE_MODEL = dict(
    type="BasicLocator",
    backbone=dict(type="ResNet", depth=18, base_channels=8),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=1,
              norm_cfg=dict(type="GN", num_groups=4)),
    bbox_head=dict(head_cfg(), stacked_convs=1))


@pytest.fixture(scope="module")
def slice_pair():
    jm = jax_build(dict(SLICE_MODEL))
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables["params"]["bbox_head_m"] = _spread(
        variables["params"]["bbox_head_m"], seed=2)
    model = build_detector(dict(SLICE_MODEL), device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    rng = np.random.RandomState(3)
    samples = []
    for i, hw in enumerate([(60, 76), (64, 80), (50, 64)]):
        n = 3 + i
        c = rng.uniform(4, [hw[1] - 4, hw[0] - 4], (n, 2))
        samples.append(dict(
            img=rng.randn(*hw, 3).astype(np.float32),
            gt_bboxes=np.concatenate([c - 8, c + 8], 1).astype(np.float32),
            gt_labels=rng.randint(0, C, n),
            gt_anns_id=np.arange(n) + 100 * i,
            img_metas=dict(scale_factor=np.asarray([0.5, 0.5, 0.5, 0.5],
                                                   np.float32))))
    return jm, variables, model, samples


def test_slice_train_step_matches_jax(slice_pair):
    """forward_train of the whole model with the drop off (no rng, no
    generator): losses within 1e-5 relative, every parameter's gradient
    within 1e-4 of its max |grad| (assert_grads_close)."""
    jm, variables, model, samples = slice_pair
    batch = DetCollator(pad_shape=HW, max_gt=8)(samples[:2])
    keys = ("gt_bboxes", "gt_labels", "gt_valid", "img_shape")

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(batch["img"]),
                          {k: jnp.asarray(batch[k]) for k in keys},
                          method=jm.forward_train, mutable=["batch_stats"])
        return sum(v for k, v in out.items() if k.startswith("loss")), out
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.train()
    got = model.forward_train(torch.from_numpy(batch["img"]),
                              {k: torch.from_numpy(batch[k]) for k in keys},
                              None)
    sum(v for k, v in got.items() if k.startswith("loss")).backward()
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    jg = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                           basic_blocks=True)
    assert_grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                       {n: v.numpy() for n, v in jg.items()})


def test_run_refine_test_rows_match_jax(slice_pair):
    """run_refine_test of both packages, each with its own DetCollator
    (pad 64x80, max_gt 8, batches of 2): the same images and rows, labels
    and anns_id equal, boxes and points (rescaled by the 0.5 scale
    factor) within 1e-5 of the largest coordinate, scores within 1e-5."""
    jm, variables, model, samples = slice_pair
    want = jtest.run_refine_test(jm, variables, samples,
                                 JaxCollator(pad_shape=HW, max_gt=8), 2)
    model.eval()
    got = run_refine_test(model, samples, DetCollator(pad_shape=HW, max_gt=8),
                          2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"bboxes", "labels", "points", "anns_id"}
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["anns_id"], w["anns_id"])
        for k in ("bboxes", "points"):
            np.testing.assert_allclose(g[k], w[k],
                                       atol=1e-5 * np.abs(w[k]).max())


def test_cpr_state_dict_round_trip_through_torch2jax():
    """The port's CPR state dict (GN convs, the cls_out and ins_out dense
    layers) -> torch2jax -> load_jax_variables gives it back unchanged,
    every leaf consumed, and the tree is the JAX model's."""
    cfg = dict(SLICE_MODEL, bbox_head=head_cfg())
    src = build_detector(dict(cfg), device="cpu", seed=4)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=18)
    assert not unmapped, unmapped
    jm = jax_build(dict(cfg))
    shapes = jax.tree_util.tree_map(np.shape, jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 3), jnp.float32),
                        train=False))["params"])
    assert jax.tree_util.tree_map(np.shape, params) == shapes
    assert set(params["bbox_head_m"]) == {"cls_conv0", "cls_conv1",
                                          "cls_out", "ins_out"}
    dst = build_detector(dict(cfg), device="cpu", seed=5)
    load_jax_variables(dst, params, stats)
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k

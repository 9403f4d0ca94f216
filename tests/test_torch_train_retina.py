"""RetinaNet training: the port's focal loss, RetinaHead loss and train
step against the JAX package's, on the same numpy inputs and the same
weights.

The focal loss and the head's loss are compared on the same arrays. The
slice is the ResNet-18 twin of tests/train_parity_lib.py::make_jax_retina
(base_channels 8, FPN 16 from stride 4 with `on_input` extras, RetinaHead
with 2 stacked convs, the Adap anchors, focal loss and L1, 1 class): its
JAX init, loaded into the port's model by utils/jax_weights.py::
load_jax_variables (the basic blocks' downsample in the Conv_2 slot), then
40 steps on train_parity_lib's tiny synthetic scenes in its `batch_order`,
with its optimizer semantics (SGD momentum 0.9, weight decay 1e-4, warmup,
grad clip 35). JAX runs its own `train_jax` (the package's build_optimizer
and make_train_step); inside it the first step's metrics and raw gradients
are recorded by a wrapper around make_train_step and a transformation that
keeps each step's gradients in the optimizer state (one compile). The port
runs the same steps through its build_optimizer and make_train_step. Bars:
the first step's losses within 1e-4 relative and each parameter's gradient
within 1e-4 of that parameter's max |grad|; the trajectories at
tests/test_train_parity.py:45-48's bars (first step 1e-4, mean of 10-step
moving means 0.01, final window 0.02). Torch runs on one thread here.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import train_parity_lib as tp
from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
from pointtinybenchmark_tpu_torch.engine.train import (init_train_state,
                                                       make_train_step)
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.losses import FocalLoss
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)

jfocal = importlib.import_module(
    "pointtinybenchmark_tpu.models.losses.focal_loss")
jretina = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.retina_head")
jopt = importlib.import_module("pointtinybenchmark_tpu.engine.optimizer")
jtrain = importlib.import_module("pointtinybenchmark_tpu.engine.train")

STEPS, N_TRAIN, BATCH, HW = 40, 16, 2, (128, 160)
GMAX = 16                       # train_jax's gt padding
HEAD = dict(type="RetinaHead", num_classes=1, in_channels=16,
            feat_channels=16, stacked_convs=2,
            anchor_generator=dict(tp.ADAP_ANCHOR),
            bbox_coder=dict(tp.DELTA_CODER), loss_cls=dict(tp.LOSS_CLS),
            loss_bbox=dict(tp.LOSS_BBOX))
# make_jax_retina's model
MODEL = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, base_channels=8, norm_eval=True,
                  frozen_stages=-1),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16,
              num_outs=5, start_level=0, add_extra_convs="on_input"),
    bbox_head=HEAD)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the losses
@pytest.mark.parametrize("reduction,weighted,avg_factor", [
    ("mean", None, None), ("mean", "rows", None), ("mean", "rows", 37.0),
    ("mean", "elements", 11.5), ("sum", None, None), ("sum", "rows", None),
    ("none", None, None), ("none", "elements", 5.0)])
def test_focal_loss_matches_jax(reduction, weighted, avg_factor):
    """rtol 1e-6 (of the largest value for the elementwise form): the same
    operations, compiled by two frameworks; labels include the background
    (C), logits up to |9|."""
    rng = np.random.RandomState(0)
    pred = (rng.randn(400, 3) * 3).astype(np.float32)
    label = rng.randint(0, 4, 400)
    weight = {None: None,
              "rows": rng.rand(400).astype(np.float32),
              "elements": rng.rand(400, 3).astype(np.float32)}[weighted]
    args = dict(gamma=2.0, alpha=0.25, reduction=reduction, loss_weight=0.7)
    want = np.asarray(jfocal.FocalLoss(**args)(
        jnp.asarray(pred), jnp.asarray(label),
        None if weight is None else jnp.asarray(weight), avg_factor))
    got = FocalLoss(**args)(
        torch.from_numpy(pred), torch.from_numpy(label),
        None if weight is None else torch.from_numpy(weight),
        avg_factor).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_retina_head_loss_matches_jax():
    """RetinaHead.loss on the same head outputs and gts (2 images, 1-5 gts,
    an ignore region, a padded gt row): loss_cls and loss_bbox within 1e-5
    relative, num_pos equal."""
    rng = np.random.RandomState(3)
    sizes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    cls = [(rng.randn(2, h, w, 9) * 2).astype(np.float32) for h, w in sizes]
    reg = [(rng.randn(2, h, w, 36) * 0.3).astype(np.float32)
           for h, w in sizes]
    gts = [np.asarray([[10, 12, 20, 34], [40, 8, 47, 22], [30, 30, 60, 58]],
                      np.float32), np.asarray([[5, 5, 12, 18]], np.float32)]
    gt_b, gt_l, gt_v = tp.pad_gts(gts, [np.zeros(3), np.zeros(1)], 4)
    batch = dict(gt_bboxes=gt_b, gt_labels=gt_l, gt_valid=gt_v,
                 gt_bboxes_ignore=np.asarray([[[0, 40, 10, 60]],
                                              [[50, 0, 80, 10]]], np.float32),
                 gt_ignore_valid=np.asarray([[True], [False]]))
    head_args = {k: v for k, v in HEAD.items() if k != "type"}
    jhead = jretina.RetinaHead(train_cfg=dict(tp.RETINA_TRAIN), **head_args)
    want = jhead.loss([jnp.asarray(c) for c in cls],
                      [jnp.asarray(r) for r in reg],
                      dict({k: jnp.asarray(v) for k, v in batch.items()},
                           pad_shape=(64, 80)))
    thead = build_detector(dict(MODEL), dict(tp.RETINA_TRAIN), None,
                           device="cpu").bbox_head
    got = thead.loss([torch.from_numpy(c).permute(0, 3, 1, 2) for c in cls],
                     [torch.from_numpy(r).permute(0, 3, 1, 2) for r in reg],
                     dict({k: torch.from_numpy(v) for k, v in batch.items()},
                          pad_shape=(64, 80)), torch.Generator())
    assert float(want["num_pos"]) > 2
    assert float(got["num_pos"]) == float(want["num_pos"])
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------- the slice
def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's init of the twin (numpy), the data, the batch order, the lr
    steps, and train_jax's run: its losses, the first step's metrics and
    raw gradients."""
    jm = tp.make_jax_retina()
    variables = _np_tree(jax.jit(lambda r, x: jm.init(r, x))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    data = tp.make_tiny_dataset(N_TRAIN, hw=HW, seed=0)
    order = tp.batch_order(N_TRAIN, BATCH, STEPS)
    step_iters = [int(STEPS * 2 / 3), int(STEPS * 5 / 6)]
    # keeps the step's raw gradients as its state
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    build, make = jopt.build_optimizer, jtrain.make_train_step
    first = {}

    def recording(model, tx):
        step = make(model, tx)

        def run(state, batch, rng):
            state, metrics = step(state, batch, rng)
            if not first:
                first["metrics"] = {k: float(v) for k, v in metrics.items()}
                first["grads"] = _np_tree(state["opt_state"][0])
            return state, metrics
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt, "build_optimizer",
                   lambda *a, **k: optax.chain(keep, build(*a, **k)))
        mp.setattr(jtrain, "make_train_step", recording)
        losses, _ = tp.train_jax(jm, variables["params"],
                                 variables["batch_stats"], data, order,
                                 step_iters, gmax=GMAX)
    return dict(variables=variables, data=data, order=order,
                step_iters=step_iters, losses=losses, **first)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's model loaded from JAX's init, the same steps: its losses,
    the first step's metrics and gradients."""
    v = jax_run["variables"]
    model = build_detector(dict(MODEL), dict(tp.RETINA_TRAIN),
                           dict(tp.RETINA_TEST), device="cpu")
    load_jax_variables(model, v["params"], v["batch_stats"])
    opt = build_optimizer(
        model, dict(type="SGD", lr=tp.OPT["lr"], momentum=tp.OPT["momentum"],
                    weight_decay=tp.OPT["weight_decay"]),
        dict(grad_clip=dict(max_norm=tp.OPT["grad_clip"], norm_type=2)),
        dict(policy="step", warmup="linear",
             warmup_iters=tp.LR_CFG["warmup_iters"],
             warmup_ratio=tp.LR_CFG["warmup_ratio"],
             gamma=tp.LR_CFG["gamma"], step=list(jax_run["step_iters"])),
        1, 1, frozen_stages=-1, by_epoch=False)
    step = make_train_step(model, opt)
    state = init_train_state("cpu")
    gen = torch.Generator().manual_seed(0)
    data, h, w = jax_run["data"], *HW
    losses, first = [], {}
    for idxs in jax_run["order"]:
        gt_b, gt_l, gt_v = tp.pad_gts([data["gts"][i] for i in idxs],
                                      [data["labels"][i] for i in idxs],
                                      GMAX)
        batch = dict(img=torch.from_numpy(data["images"][idxs]),
                     gt_bboxes=torch.from_numpy(gt_b),
                     gt_labels=torch.from_numpy(gt_l),
                     gt_valid=torch.from_numpy(gt_v),
                     img_shape=torch.tensor([[h, w]] * len(idxs),
                                            dtype=torch.int32))
        metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if not first:
            first["metrics"] = {k: float(v) for k, v in metrics.items()}
            first["grads"] = {n: p.grad.clone()
                              for n, p in model.named_parameters()}
    assert not bool(state["nan_seen"])
    return dict(losses=np.asarray(losses), **first)


def test_first_step_losses_and_grads_match_jax(jax_run, port_run):
    """Losses 1e-4 relative; every parameter's gradient within 1e-4 of its
    max |grad|, the JAX tree mapped by the basic-block names; positives in
    the step."""
    want, got = jax_run["metrics"], port_run["metrics"]
    assert want["num_pos"] > BATCH
    for k in ("loss", "loss_cls", "loss_bbox", "num_pos"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jg = jax_to_state_dict(jax_run["grads"], basic_blocks=True)
    grads = port_run["grads"]
    assert set(jg) == set(grads)
    assert any(".downsample." in n for n in grads)
    for name, g in grads.items():
        w = jg[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)


def test_trajectory_matches_jax(jax_run, port_run):
    """40 steps: tests/test_train_parity.py's bars on the loss curves."""
    st = tp.trajectory_stats(port_run["losses"], jax_run["losses"])
    assert np.isfinite(port_run["losses"]).all()
    assert st["first_step_rel"] < 1e-4, st
    assert st["mean_rel"] < 0.01, st
    assert st["final_rel"] < 0.02, st

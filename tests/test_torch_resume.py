"""resume_from a JAX package `.ckpt`: the port continues the JAX run.

JAX trains the tiny Faster R-CNN of tests/test_torch_train.py (ResNet-50 of
base 8, FPN 16, frozen_stages=1, both samplers taking every candidate) for
K steps with its own build_optimizer chain on its own gradients and writes
the train state with its own engine/checkpoint.py::save_checkpoint; the
port's `train_detector(resume_from=...)` then takes N more steps through
its IterBasedRunner while JAX continues from the same state. Three
optimizers: SGD with momentum, weight decay and a binding grad_clip; SGD
with a `paramwise_cfg` (lr and decay mults, so the chain is optax.trace +
scale_by_learning_rate, not optax.sgd); Adam (the P2P configs' optimizer,
two counts in its chain). The loaded state (count, momentum traces or
moments, through the params' converter, the frozen stages' traces dropped)
equals JAX's exactly; after N steps the parameters are held as
test_torch_train.py::test_three_steps_match_jax holds them (each tensor's
change over the N steps within 1e-4 of JAX's max |change|, plus an ulp of
the tensor's max |value| a step), the traces and moments within 1e-4 of
their max, and the step, epoch, count and the learning rate of each step
equal. JAX's gradient step is compiled once, without XLA's backend
optimisations; torch runs on one thread.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from pointtinybenchmark_tpu.engine.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from pointtinybenchmark_tpu.engine.optimizer import \
    build_optimizer as jax_build_optimizer
from pointtinybenchmark_tpu.engine.optimizer import (build_lr_schedule,
                                                     frozen_param_mask)
from pointtinybenchmark_tpu.engine.train import \
    make_train_step as jax_make_train_step
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.engine.checkpoint import optax_slots
from pointtinybenchmark_tpu_torch.engine.optimizer import (build_optimizer,
                                                           frozen_param_names)
from pointtinybenchmark_tpu_torch.engine.train import (init_train_state,
                                                       resume_jax_checkpoint,
                                                       train_detector)
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_params_like, jax_to_state_dict)
from test_torch_train import (IMG_HW, LR_CONFIG, MAX_GT, MAX_IGNORE,
                              TRAIN_CFG, _batch, _jax_batch, _model_cfg,
                              _samples, _to_jax)

K, N = 3, 2
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
OPTIMIZERS = {
    "sgd": (dict(type="SGD", lr=0.02, momentum=0.9, weight_decay=1e-4),
            dict(grad_clip=dict(max_norm=1.0))),
    "sgd_paramwise": (dict(type="SGD", lr=0.02, momentum=0.9,
                           weight_decay=1e-4,
                           paramwise_cfg=dict(
                               bias_lr_mult=2.0, norm_decay_mult=0.0,
                               custom_keys={"neck": dict(lr_mult=0.5)})),
                      None),
    "adam": (dict(type="Adam", lr=1e-3), None),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_model():
    model_cfg, test_cfg = _model_cfg()
    return build_detector(dict(model_cfg), TRAIN_CFG, test_cfg, device="cpu",
                          seed=0)


@pytest.fixture(scope="module")
def jax_grads():
    """(params, batch_stats, grads_at): the port's seeded weights as JAX
    trees and JAX's gradient at given params (its own train step, behind a
    transformation that keeps the raw gradients and changes nothing)."""
    model_cfg, test_cfg = _model_cfg()
    params, stats = _to_jax(_fresh_model())
    jm = jax_build(dict(model_cfg), TRAIN_CFG, test_cfg)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))
    step = jax_make_train_step(jm, keep)
    batch = _jax_batch(_batch())

    def state_of(p, s):
        p = jax.tree_util.tree_map(jnp.asarray, p)
        return dict(params=p, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, s), opt_state=keep.init(p), step=jnp.int32(0),
            nan_seen=jnp.bool_(False))

    rng = jax.random.PRNGKey(1)
    compiled = step.lower(state_of(params, stats), batch, rng).compile(
        FAST_COMPILE)

    def grads_at(p, s):
        out, m = compiled(state_of(p, s), batch, rng)
        assert np.isfinite(float(m["loss"]))
        # numpy copies: the step donates its state's buffers
        return jax.tree_util.tree_map(np.array, (out["opt_state"],
                                                 out["batch_stats"]))

    return params, stats, grads_at


def _jax_optimizer(name, params):
    opt, opt_config = OPTIMIZERS[name]
    return jax_build_optimizer(dict(opt), opt_config, LR_CONFIG, 1, K + N,
                               param_mask=frozen_param_mask(params, 1),
                               by_epoch=False)


def _jax_run(jax_grads, name, steps, start=None):
    """JAX's steps from the seeded weights, or from `start`
    (params, batch_stats, opt_state, step)."""
    params, stats, grads_at = jax_grads
    tx = _jax_optimizer(name, params)
    p, s, o, k = start or (params, stats, tx.init(jax.tree_util.tree_map(
        jnp.asarray, params)), 0)
    update = jax.jit(tx.update)
    for _ in range(steps):
        g, s = grads_at(p, s)
        u, o = update(g, o, jax.tree_util.tree_map(jnp.asarray, p))
        p = jax.tree_util.tree_map(np.asarray, optax.apply_updates(p, u))
        k += 1
    return p, s, o, k


def _loop_cfg(name):
    opt, opt_config = OPTIMIZERS[name]
    return dict(data=dict(samples_per_gpu=2, shuffle=False),
                loader=dict(pad_shape=IMG_HW, max_gt=MAX_GT,
                            max_gt_ignore=MAX_IGNORE),
                runner=dict(type="IterBasedRunner", max_iters=K + N),
                optimizer=dict(opt), optimizer_config=opt_config or {},
                lr_config=dict(LR_CONFIG), log_config=dict(interval=1),
                checkpoint_config=dict(interval=100))


@pytest.fixture(scope="module")
def checkpoints(jax_grads, tmp_path_factory):
    """Per optimizer: the `.ckpt` JAX wrote after K steps (one iteration
    an epoch: meta epoch K, iter K) and JAX's state after N more."""
    out = {}
    for name in OPTIMIZERS:
        p, s, o, k = _jax_run(jax_grads, name, K)
        path = str(tmp_path_factory.mktemp(name) / f"iter_{K}.ckpt")
        jax_save_checkpoint(path, jax.device_get(dict(
            params=p, batch_stats=s, opt_state=o, step=jnp.int32(k),
            nan_seen=jnp.bool_(False))), meta=dict(epoch=K, iter=K))
        out[name] = path, (p, s, o, k), _jax_run(jax_grads, name, N,
                                                  (p, s, o, k))
    return out


def _slot_trees(name, opt_state):
    """JAX's trace (SGD) or mu and nu (Adam) trees, and its count."""
    slots = optax_slots(serialization.to_state_dict(
        jax.device_get(opt_state)))
    keys = ("mu", "nu") if name == "adam" else ("trace",)
    return {k: slots[k][0] for k in keys}, slots["count"][0]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_resume_loads_jax_state_exactly(checkpoints, jax_grads, name):
    """The loaded count, step and momentum state equal JAX's (traces of
    the frozen stem and layer1 dropped, Adam's moments kept for every
    parameter), and the next step's learning rate is JAX's schedule at
    the count."""
    path, (p, s, o, k), _ = checkpoints[name]
    model = _fresh_model()
    opt, opt_config = OPTIMIZERS[name]
    optimizer = build_optimizer(model, dict(opt), opt_config, LR_CONFIG, 1,
                                K + N, frozen_stages=1, by_epoch=False)
    state = init_train_state("cpu")
    meta = resume_jax_checkpoint(model, optimizer, state, path)
    assert meta == dict(epoch=K, iter=K)
    assert int(state["step"]) == K and not bool(state["nan_seen"])
    assert int(optimizer.count) == K
    want_lr = float(build_lr_schedule(opt["lr"], LR_CONFIG, 1, K + N,
                                      by_epoch=False)(K))
    assert float(optimizer.lr()) == pytest.approx(want_lr, rel=1e-6)
    for k_, v in jax_to_state_dict(p, s).items():
        assert torch.equal(model.state_dict()[k_], v), k_
    trees, count = _slot_trees(name, o)
    assert count == K
    frozen = set(frozen_param_names(model, 1))
    names = [n for n, _ in model.named_parameters()]
    if name == "adam":
        for key, own in (("mu", optimizer.mu), ("nu", optimizer.nu)):
            want = jax_params_like(model, trees[key])
            assert len(own) == len(names)
            for n, t in zip(names, own):
                assert torch.equal(t, want[n]), (key, n)
    else:
        want = jax_params_like(model, trees["trace"])
        own = [n for n in names if n not in frozen]
        assert len(optimizer.trace) == len(own) < len(names)
        for n, t in zip(own, optimizer.trace):
            assert torch.equal(t, want[n]), n
        assert any(float(want[n].abs().max()) > 0 for n in frozen)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_resumed_training_follows_jax(checkpoints, tmp_path, name):
    """N more steps of the port's train_detector from the JAX checkpoint
    against N more JAX steps from the same state."""
    path, (p0, s0, _, _), (p1, _, o1, k1) = checkpoints[name]
    res = train_detector(_fresh_model(), _samples(), _loop_cfg(name),
                         str(tmp_path), resume_from=path, device="cpu")
    assert [e["step"] for e in res["history"]] == list(range(K + 1,
                                                             K + N + 1))
    assert [e["epoch"] for e in res["history"]] == list(range(K + 1,
                                                              K + N + 1))
    opt = OPTIMIZERS[name][0]
    sched = build_lr_schedule(opt["lr"], LR_CONFIG, 1, K + N, by_epoch=False)
    # the logged lr is the next update's: JAX's schedule at count k + 1
    for e, c in zip(res["history"], range(K + 1, K + N + 1)):
        assert e["lr"] == pytest.approx(float(sched(c)), rel=1e-6)
    model, optimizer = res["model"], res["optimizer"]
    assert int(res["state"]["step"]) == k1 == K + N
    assert int(optimizer.count) == K + N

    got = model.state_dict()
    start = jax_to_state_dict(p0, s0)
    want = jax_to_state_dict(p1, s0)
    frozen = set(frozen_param_names(model, 1))
    for n, _ in model.named_parameters():
        w = want[n].numpy()
        change = np.abs(w - start[n].numpy()).max()
        ulps = N * np.spacing(np.abs(w).max()) if change else 0.0
        err = float(np.abs(got[n].numpy() - w).max())
        assert err <= 1e-4 * change + ulps, (n, err, change)
        if n in frozen:
            assert torch.equal(got[n], start[n]), n
        else:
            assert change > 0, n

    trees, count = _slot_trees(name, o1)
    assert count == K + N
    names = [n for n, _ in model.named_parameters()]
    if name == "adam":
        pairs = [(trees["mu"], names, optimizer.mu),
                 (trees["nu"], names, optimizer.nu)]
    else:
        pairs = [(trees["trace"], [n for n in names if n not in frozen],
                  optimizer.trace)]
    for tree, own, tensors in pairs:
        want = jax_params_like(model, tree)
        for n, t in zip(own, tensors):
            w = want[n].numpy()
            err = float(np.abs(t.numpy() - w).max())
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (n, err)


@pytest.mark.parametrize("opt_state,error", [
    ({"0": {"inner": np.zeros(3, np.float32)}}, "outside any"),
    ({"0": {"trace": {}}, "1": {"trace": {}}, "2": {"count": 3}},
     "one optax momentum trace"),
    ({"0": {"trace": {}}, "1": {"count": 3}, "2": {"count": 4}},
     "equal optax counts"),
    ({"0": {"count": 2, "mu": {}, "nu": {}}, "1": {"count": 2}},
     "one optax momentum trace"),
])
def test_unknown_optax_layout_raises(opt_state, error):
    """A state with a leaf outside the known fields, two traces, counts
    that disagree, or Adam's moments for an SGD run raise and name the
    layout found."""
    model = _fresh_model()
    optimizer = build_optimizer(model, dict(OPTIMIZERS["sgd"][0]))
    with pytest.raises(ValueError, match=error):
        optimizer.load_optax(optax_slots(opt_state),
                             lambda t: jax_params_like(model, t))


def test_adam_refuses_an_sgd_state():
    model = _fresh_model()
    optimizer = build_optimizer(model, dict(OPTIMIZERS["adam"][0]))
    with pytest.raises(ValueError, match="one optax mu and one nu"):
        optimizer.load_optax(optax_slots(
            {"0": {"0": {"trace": {}}, "1": {"count": 0}}}),
            lambda t: jax_params_like(model, t))


def test_resume_from_an_orbax_directory_raises(tmp_path):
    """An orbax checkpoint (a directory) stays refused with a clear
    error, as for load_from."""
    d = tmp_path / "iter_3.ckpt"
    d.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        train_detector(_fresh_model(), _samples(), _loop_cfg("sgd"),
                       str(tmp_path / "w"), resume_from=str(d), device="cpu")

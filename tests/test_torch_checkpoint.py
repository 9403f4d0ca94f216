"""The JAX package's msgpack checkpoints read by the port.

`engine/checkpoint.py::msgpack_restore` (the port's own reader of the part
of msgpack that flax writes) is held leaf for leaf against
flax.serialization.msgpack_restore: on a JAX `save_checkpoint` of a train
state (params, batch_stats, an optax SGD state with momentum traces, step,
nan_seen) and on numpy-seeded random trees of every kind of leaf the
format carries (arrays of every numpy dtype and shape, numpy scalars,
integers at msgpack's size boundaries, floats, strings and bytes of every
length class, lists, maps, None and bools). Equal leaves have the same
type, dtype, shape and bytes. The forms the reader refuses raise.

Then both packages' entry points read one `.ckpt` of the tiny RetinaNet of
tests/test_torch_slice.py (the port's seeded weights carried to JAX by
tools/model_converters/torch2jax.py, `retina_cls` redrawn there to spread
the scores): `init_detector` gives detections within tests/
test_detector_golden.py:88's tolerances of the JAX model's on the same
frame, and `train_detector(load_from=...)` starts from those weights.
"""
import os.path as osp
import sys

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pointtinybenchmark_tpu.apis.inference import \
    inference_detector_tiled as jax_tiled
from pointtinybenchmark_tpu.apis.inference import \
    init_detector as jax_init_detector
from pointtinybenchmark_tpu.engine.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from pointtinybenchmark_tpu.engine.optimizer import \
    build_optimizer as jax_build_optimizer
from pointtinybenchmark_tpu_torch.apis.inference import (
    inference_detector_tiled, init_detector)
from pointtinybenchmark_tpu_torch.engine.checkpoint import (
    load_jax_checkpoint, msgpack_restore)
from pointtinybenchmark_tpu_torch.engine.train import train_detector
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_torch_slice import CFG_TEXT, _assert_dets_match, _dets

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools",
                            "model_converters"))
from torch2jax import convert_detector_state_dict  # noqa: E402

TRAIN_CFG_TEXT = """
train_cfg = dict(
    assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                  min_pos_iou=0, ignore_iof_thr=-1),
    allowed_border=-1, pos_weight=-1)
"""
DTYPES = ("float16", "float32", "float64", "int8", "int16", "int32",
          "int64", "uint8", "uint16", "uint32", "uint64", "bool")
# integers at the edges of msgpack's fixint, int and uint forms
INTS = (0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 63 - 1, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2 ** 31, -2 ** 31 - 1, -2 ** 63)
# lengths at the edges of the fix, 8-, 16- and 32-bit length forms
LENGTHS = (0, 5, 31, 32, 255, 256, 65535, 65536)


def assert_same(got, want, path="/"):
    """Leaf for leaf: the same type, and for arrays and numpy scalars the
    same dtype, shape and bytes."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}{k}/")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}{i}/")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, float):
        assert got == want or (np.isnan(got) and np.isnan(want)), path
    else:
        assert got == want, path


def random_leaf(rng):
    kind = rng.randint(0, 8)
    if kind == 0:
        dtype = np.dtype(DTYPES[rng.randint(len(DTYPES))])
        shape = tuple(rng.randint(0, 5, rng.randint(0, 4)))
        if rng.rand() < 0.1:
            shape = (300, 60)                   # above 65,535 bytes
        raw = rng.randint(0, 256, int(np.prod(shape)) * dtype.itemsize)
        arr = np.frombuffer(raw.astype(np.uint8).tobytes(), dtype)
        if dtype == bool:
            arr = arr.astype(np.uint8) % 2 == 1
        return arr.reshape(shape)
    if kind == 1:
        return np.dtype(DTYPES[rng.randint(len(DTYPES))]).type(
            rng.randint(0, 100))
    if kind == 2:
        return INTS[rng.randint(len(INTS))]
    if kind == 3:
        return float(rng.choice([0.0, -0.0, 1.5, -3.25e300, 1e-310,
                                 np.inf, np.nan, rng.randn()]))
    if kind == 4:
        return "s" * LENGTHS[rng.randint(len(LENGTHS))]
    if kind == 5:
        return b"\x07" * LENGTHS[rng.randint(len(LENGTHS))]
    if kind == 6:
        return [random_leaf(rng) if rng.rand() < 0.5 else None
                for _ in range(rng.randint(0, 20))]
    return [None, True, False][rng.randint(3)]


def random_tree(rng, depth=0):
    """Maps of 1-19 string keys (fix and 16-bit map forms), nested up to 3
    deep; the top one also holds an array and a scalar of every dtype."""
    tree = {}
    if depth == 0:
        for name in DTYPES:
            arr = (rng.randn(2, 3) * 50).astype(name)
            tree[name] = dict(array=arr, scalar=arr[1, 2],
                              zero_d=np.asarray(arr[0, 0]))
    for i in range(rng.randint(1, 20)):
        key = f"k{i}" + "x" * LENGTHS[rng.randint(4)]
        tree[key] = (random_tree(rng, depth + 1)
                     if depth < 3 and rng.rand() < 0.2 else random_leaf(rng))
    return tree


@pytest.mark.parametrize("seed", range(6))
def test_decoder_matches_flax_on_random_trees(seed):
    tree = random_tree(np.random.RandomState(seed))
    data = serialization.msgpack_serialize(tree)
    assert_same(msgpack_restore(data), serialization.msgpack_restore(data))


def _chunked(monkeypatch):
    # flax chunks arrays above MAX_CHUNK_SIZE bytes (2**30 by default)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    return serialization.msgpack_serialize({"a": np.zeros(100, np.float32)})


UNSUPPORTED = {
    "complex scalar": lambda mp: serialization.msgpack_serialize(
        {"a": 1 + 2j}),
    "complex array": lambda mp: serialization.msgpack_serialize(
        {"a": np.ones(3, np.complex64)}),
    "bfloat16 array": lambda mp: serialization.msgpack_serialize(
        {"a": np.ones(3, jnp.bfloat16)}),
    "chunked array": _chunked,
    "unknown extension": lambda mp: msgpack.packb(
        {"a": msgpack.ExtType(5, b"xy")}),
    "byte 0xc1": lambda mp: b"\x81\xa1a\xc1",
    "trailing bytes": lambda mp: msgpack.packb({"a": 1}) + b"\x00",
}


@pytest.mark.parametrize("form", sorted(UNSUPPORTED))
def test_unsupported_forms_raise(form, monkeypatch):
    data = UNSUPPORTED[form](monkeypatch)
    with pytest.raises(ValueError):
        msgpack_restore(data)


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_jax_checkpoint(str(tmp_path))


# ------------------------------------------------------ one JAX checkpoint
@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """(config path, .ckpt path, the JAX params and batch stats): the tiny
    RetinaNet's port weights in JAX's tree, with an SGD state after one
    update, step and nan_seen, written by JAX's save_checkpoint."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    cfg_path = root / "cfg.py"
    cfg_path.write_text(CFG_TEXT + TRAIN_CFG_TEXT)
    cfg = Config.fromfile(str(cfg_path))
    model = build_detector(dict(cfg.model), cfg.train_cfg, cfg.test_cfg,
                           device="cpu", seed=2)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=50)
    assert not unmapped, unmapped
    rng = np.random.RandomState(0)
    cls = params["bbox_head_m"]["retina_cls"]
    cls["kernel"] = (rng.randn(*cls["kernel"].shape) * 0.02).astype(
        np.float32)
    cls["bias"] = np.zeros_like(cls["bias"])
    tx = jax_build_optimizer(dict(type="SGD", lr=0.01, momentum=0.9,
                                  weight_decay=1e-4), None, None, 1, 1,
                             by_epoch=False)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), p)
    _, opt_state = tx.update(grads, tx.init(p), p)
    state = dict(params=p, batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              stats),
                 opt_state=opt_state, step=jnp.int32(5),
                 nan_seen=jnp.bool_(False))
    ckpt = root / "epoch_2.ckpt"
    jax_save_checkpoint(str(ckpt), state, dict(epoch=2, iter=10))
    return str(cfg_path), str(ckpt), params, stats


def test_decoder_matches_flax_on_a_jax_checkpoint(jax_ckpt):
    """The train state's optax SGD state (string-keyed maps "0", "1", ...
    with momentum traces), 0-d step and bool nan_seen, and the meta."""
    _, ckpt, params, _ = jax_ckpt
    data = open(ckpt, "rb").read()
    want = serialization.msgpack_restore(data)
    assert_same(msgpack_restore(data), want)
    got = load_jax_checkpoint(ckpt)
    assert_same(got, {"state": want["state"], "meta": want["meta"]})
    assert got["meta"] == dict(epoch=2, iter=10)
    assert got["state"]["step"].shape == () and got["state"]["step"] == 5
    assert got["state"]["nan_seen"].dtype == bool
    # optax's chain: {"0": wd, "1": {"0": {"trace": ...}, "1": {"count"}}}
    sgd = got["state"]["opt_state"]["1"]
    assert list(got["state"]["opt_state"]) == ["0", "1"]
    trace = sgd["0"]["trace"]["bbox_head_m"]["retina_reg"]["kernel"]
    assert trace.dtype == np.float32 and np.abs(trace).max() > 0
    assert sgd["1"]["count"] == 1
    np.testing.assert_array_equal(
        got["state"]["params"]["bbox_head_m"]["retina_cls"]["kernel"],
        params["bbox_head_m"]["retina_cls"]["kernel"])


def test_init_detector_reads_jax_checkpoint(jax_ckpt):
    """Both packages' init_detector on the same .ckpt: the port's
    detections on a 128x192 frame at the golden tolerances of JAX's."""
    cfg_path, ckpt, _, _ = jax_ckpt
    frame = np.random.RandomState(6).randint(0, 256, (128, 192, 3), np.uint8)
    ref = _dets(jax_tiled(jax_init_detector(cfg_path, checkpoint=ckpt),
                          frame))
    assert ref[0].shape[0] > 0
    got = inference_detector_tiled(
        init_detector(cfg_path, checkpoint=ckpt, device="cpu"), frame)
    _assert_dets_match(ref, _dets(got))


def _loop_cfg(cfg_path, lr):
    cfg = Config.fromfile(cfg_path).to_dict()
    cfg.update(data=dict(samples_per_gpu=1, shuffle=False),
               runner=dict(type="IterBasedRunner", max_iters=1),
               optimizer=dict(type="SGD", lr=lr, momentum=0.9,
                              weight_decay=1e-4),
               optimizer_config=dict(), lr_config=None,
               log_config=dict(interval=1),
               checkpoint_config=dict(interval=1))
    return cfg


def test_train_detector_loads_from_jax_checkpoint(jax_ckpt, tmp_path):
    """train_detector(load_from=<.ckpt>) at lr 0: after one step the
    weights are the checkpoint's params and batch stats, bit for bit, not
    the seeded ones. resume_from the .ckpt takes its weights, step and
    optax state (one update) and restarts where JAX's loop would: at its
    meta's epoch 2, past this run's one iteration, so no step runs."""
    cfg_path, ckpt, params, stats = jax_ckpt
    cfg = Config.fromfile(cfg_path)
    data = [dict(img=np.random.RandomState(1).randn(64, 96, 3).astype(
        np.float32), gt_bboxes=np.asarray([[10, 8, 30, 40]], np.float32),
        gt_labels=np.asarray([1], np.int64))]

    def fresh():
        return build_detector(dict(cfg.model), cfg.train_cfg, cfg.test_cfg,
                              device="cpu", seed=0)
    result = train_detector(fresh(), data, _loop_cfg(cfg_path, 0.0),
                            str(tmp_path / "run"), load_from=ckpt,
                            device="cpu")
    assert np.isfinite(result["history"][-1]["loss"])
    want = jax_to_state_dict(params, stats)
    got = result["model"].state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    resumed = train_detector(fresh(), data, _loop_cfg(cfg_path, 0.0),
                             str(tmp_path / "resume"), resume_from=ckpt,
                             device="cpu")
    assert resumed["history"] == []
    assert int(resumed["state"]["step"]) == 5
    assert int(resumed["optimizer"].count) == 1
    got = resumed["model"].state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k

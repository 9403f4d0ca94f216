"""The port's NMS against the JAX package's ops/nms.py.

Inputs are made with numpy from a seed and handed to both. Keep sets must
be exactly equal: same indices, same pick order, same num_kept. On the CPU
the port runs the plain version of its kernel pair (the same bitmask, a
host greedy walk); tests/test_torch_cuda.py holds the CUDA kernels
against it on the card.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import plain_nms, synthetic_boxes
from pointtinybenchmark_tpu.ops.pallas_kernels import iou_suppression_matrix
from pointtinybenchmark_tpu_torch.ops import nms_cuda
from pointtinybenchmark_tpu_torch.ops import nms as tnms

# the JAX package's ops/__init__ re-exports the function `nms` over its module
jnms = importlib.import_module("pointtinybenchmark_tpu.ops.nms")


def _boxes(rng, n, n_classes=1):
    """One item of the smoke's synthetic input: boxes, scores, valid,
    labels."""
    return [x[0] for x in synthetic_boxes(rng, 1, n, n_classes)]


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_same(jax_out, torch_out):
    jk, jn = (np.asarray(x) for x in jax_out)
    tk, tn = (x.numpy() for x in torch_out)
    np.testing.assert_array_equal(tk, jk)
    assert int(tn) == int(jn)


@pytest.mark.parametrize("jax_fn", [jnms.nms, jnms.nms_fixpoint,
                                    jnms.nms_blocked, jnms.nms_vblocked])
@pytest.mark.parametrize("case", ["plain", "valid_mask", "score_threshold",
                                  "truncated"])
def test_nms_matches_every_jax_route(jax_fn, case):
    rng = np.random.RandomState(0)
    boxes, scores, valid, _ = _boxes(rng, 700)
    kw = {}
    max_out = 1000
    if case == "valid_mask":
        kw["valid_mask"] = valid
    elif case == "score_threshold":
        kw["score_threshold"] = 0.4
    elif case == "truncated":
        max_out = 25
    want = jax_fn(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out,
                  **{k: jnp.asarray(v) if k == "valid_mask" else v
                     for k, v in kw.items()})
    tb, ts = _t(boxes, scores)
    tkw = {k: torch.from_numpy(v) if k == "valid_mask" else v
           for k, v in kw.items()}
    got = tnms.nms(tb, ts, 0.5, max_out, **tkw)
    assert int(got[1]) > 0
    _assert_same(want, got)


@pytest.mark.parametrize("n", [300, 5000])
@pytest.mark.parametrize("jax_fn", [jnms.batched_nms, jnms.batched_nms_large])
def test_batched_nms_class_offsets(n, jax_fn):
    """Multi-class offsets, invalid rows, and N = 5000 above FIXPOINT_MAX_N
    (JAX then takes nms_vblocked / nms_blocked)."""
    rng = np.random.RandomState(n)
    boxes, scores, valid, labels = _boxes(rng, n, n_classes=3)
    want = jax_fn(jnp.asarray(boxes), jnp.asarray(scores),
                  jnp.asarray(labels), 0.5, 1000,
                  valid_mask=jnp.asarray(valid))
    got = tnms.batched_nms(*_t(boxes, scores, labels), 0.5, 1000,
                           valid_mask=torch.from_numpy(valid))
    assert int(got[1]) > 0
    _assert_same(want, got)


def test_batched_call_equals_per_item_jax():
    """One (B, N) call, as the per-tile NMS and the global merge make it,
    equals the JAX function run on each batch item."""
    b, s, v, labels = synthetic_boxes(np.random.RandomState(3), 3, 400, 2)
    keep, num = tnms.batched_nms(*_t(b, s, labels), 0.6, 150,
                                 valid_mask=torch.from_numpy(v))
    for i in range(3):
        want = jnms.batched_nms(jnp.asarray(b[i]), jnp.asarray(s[i]),
                                jnp.asarray(labels[i]), 0.6, 150,
                                valid_mask=jnp.asarray(v[i]))
        _assert_same(want, (keep[i], num[i]))


def _unpack(mask, n):
    words = mask.numpy().view(np.uint64)
    bits = (words[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(*mask.shape[:-1], -1)[..., :n].astype(bool)


def test_plain_bitmask_equals_pairwise_iou():
    """Bit j of row i is exactly `_pairwise_iou(b, b)[i, j] > thr` for
    j > i, and 0 elsewhere (division form, the main path's semantics)."""
    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 777)[0]
    got = _unpack(nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes)[None],
                                             0.5), 777)[0]
    iou = np.asarray(jnms._pairwise_iou(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    want = (iou > 0.5) & np.triu(np.ones((777, 777), bool), k=1)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_plain_bitmask_agrees_with_pallas_k1():
    """Against the TPU kernel itself (interpret mode) at N = 256. K1 tests
    inter > thr * union, the bitmask inter / union > thr: the two round
    differently at the threshold, so they must agree wherever
    |iou - thr| > 1e-6."""
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 256)[0]
    k1 = np.asarray(iou_suppression_matrix(jnp.asarray(boxes), 0.5,
                                           interpret=True))
    got = _unpack(nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes)[None],
                                             0.5), 256)[0]
    iou = np.asarray(jnms._pairwise_iou(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    upper = np.triu(np.ones((256, 256), bool), k=1)
    clear = upper & (np.abs(iou - 0.5) > 1e-6)
    assert (k1 & upper).sum() > 0
    np.testing.assert_array_equal(got[clear], k1[clear])


def test_device_without_kernel_raises():
    """A device with no kernel (here `meta`) raises instead of falling back
    to the plain version."""
    boxes = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(RuntimeError, match="no NMS kernel"):
        nms_cuda.iou_bitmask(boxes, 0.5)


def test_cuda_tensors_always_route_to_the_kernel():
    """The dispatch has no switch: a CUDA tensor goes to the kernel, also
    while the smoke's `plain_nms` swap is active (which rebinds the
    module's entry points from outside instead)."""
    on_card = SimpleNamespace(device=torch.device("cuda", 0))
    assert nms_cuda._route(on_card) == "kernel"
    kernels = nms_cuda.iou_bitmask, nms_cuda.greedy_reduce
    with plain_nms():
        assert nms_cuda._route(on_card) == "kernel"
        assert nms_cuda.iou_bitmask is nms_cuda.iou_bitmask_plain
        assert nms_cuda.greedy_reduce is nms_cuda.greedy_reduce_plain
    assert (nms_cuda.iou_bitmask, nms_cuda.greedy_reduce) == kernels

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

from chip_smoke import plain_nms, synthetic_boxes, threshold_tie_boxes
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
        nms_cuda.iou_bitmask(boxes, 0.5, torch.full((1,), 8, device="meta"))


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


@pytest.mark.parametrize("case", ["valid_mask", "score_threshold", "nan",
                                  "neg_inf", "all_invalid"])
def test_valid_rows_are_a_prefix_of_the_sorted_order(case):
    """The kernels skip every row and column at or past n_valid: that is
    exact only because `_sort` puts the rows that may be kept first."""
    rng = np.random.RandomState(6)
    boxes, scores, valid, _ = synthetic_boxes(rng, 3, 500)
    valid_mask, thr = None, float("-inf")
    if case == "valid_mask":
        valid_mask = torch.from_numpy(valid)
    elif case == "score_threshold":
        thr = 0.4
    elif case == "nan":
        scores[rng.rand(3, 500) < 0.2] = np.nan
    elif case == "neg_inf":
        scores[rng.rand(3, 500) < 0.2] = -np.inf
        scores[:, :5] = (-2e30, -1e30, np.inf, 0.0, -0.0)
    else:
        valid_mask = torch.zeros((3, 500), dtype=torch.bool)
    masked = tnms._masked_scores(torch.from_numpy(scores), valid_mask, thr)
    _, ok, order, n_valid = tnms._sort(torch.from_numpy(boxes), masked)
    assert n_valid.dtype == torch.int32
    for b in range(3):
        nv = int(n_valid[b])
        assert ok[b, :nv].all() and not ok[b, nv:].any()
        if case != "all_invalid":
            assert 0 < nv < 500
    # ok is the JAX package's notion of a live row, in sorted order
    want = np.take_along_axis(np.asarray(masked) > jnms.NEG_INF,
                              order.numpy(), 1)
    np.testing.assert_array_equal(ok.numpy(), want)


@pytest.mark.parametrize("n_valid", [0, 1, 130, 700, 777])
def test_defined_words_of_plain_mask_equal_pairwise_iou(n_valid):
    """The bits the kernel defines (rows and columns < n_valid, words from
    the row's diagonal word on) of the plain mask are the upper triangle of
    the JAX `_pairwise_iou > thr`; every other bit is cleared."""
    rng = np.random.RandomState(n_valid)
    boxes = _boxes(rng, 777)[0]
    nv = torch.tensor([n_valid], dtype=torch.int32)
    plain = nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes)[None], 0.5)
    got = _unpack(nms_cuda.defined_words(plain, nv), 777)[0]
    iou = np.asarray(jnms._pairwise_iou(jnp.asarray(boxes),
                                        jnp.asarray(boxes)))
    live = np.arange(777) < n_valid
    want = (iou > 0.5) & np.triu(np.ones((777, 777), bool), k=1) \
        & live[:, None] & live[None, :]
    np.testing.assert_array_equal(got, want)
    # on garbage, only the defined bits survive
    noise = torch.from_numpy(rng.randint(-2**62, 2**62, plain.shape,
                                         dtype=np.int64))
    bits = _unpack(nms_cuda.defined_words(noise, nv), 777)[0]
    rows, cols = np.nonzero(bits)
    assert (rows < n_valid).all() and (cols < n_valid).all()
    assert (cols // 64 >= rows // 64).all()
    if n_valid > 64:
        assert bits.sum() > 0


@pytest.mark.parametrize("n_valid", [(0, 0), (1, 2), (130, 700), (777, 5)])
def test_plain_mask_given_n_valid_keeps_the_defined_bits(n_valid):
    """Given n_valid, the plain mask computes only the rows and columns
    below the batch's largest n_valid: the bits the kernel defines equal
    the whole mask's, every bit past the largest is 0, and the NMS over
    the mask keeps what JAX's keeps."""
    rng = np.random.RandomState(sum(n_valid))
    boxes = np.stack([_boxes(rng, 777)[0] for _ in n_valid])
    nv = torch.tensor(n_valid, dtype=torch.int32)
    whole = nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes), 0.5)
    part = nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes), 0.5, nv)
    assert torch.equal(nms_cuda.defined_words(part, nv),
                       nms_cuda.defined_words(whole, nv))
    bits = _unpack(part, 777)
    top = max(n_valid)
    assert not bits[:, top:].any() and not bits[:, :, top:].any()
    if top > 64:
        assert bits.sum() > 0
    scores = rng.rand(len(n_valid), 777).astype(np.float32)
    valid = np.arange(777)[None] < np.asarray(n_valid)[:, None]
    keep, num = tnms.nms(*_t(boxes, scores), 0.5, 300,
                         valid_mask=torch.from_numpy(valid))
    for i in range(len(n_valid)):
        want = jnms.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5,
                        300, valid_mask=jnp.asarray(valid[i]))
        _assert_same(want, (keep[i], num[i]))


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_threshold_ties_match_jax_division(thr):
    """Pairs whose float32 IoU is exactly thr or one of its float
    neighbours: a bit is set iff the rounded quotient is above thr, as the
    JAX division form decides, and the keep sets agree with the JAX NMS."""
    boxes, iou = threshold_tie_boxes(thr)
    t = np.float32(thr)
    assert {(iou < t).sum(), (iou == t).sum(), (iou > t).sum()} == {4}
    n = boxes.shape[0]
    got = _unpack(nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes)[None],
                                             thr), n)[0]
    jiou = np.asarray(jnms._pairwise_iou(jnp.asarray(boxes),
                                         jnp.asarray(boxes)))
    np.testing.assert_array_equal(np.diag(jiou, 1)[::2], iou)
    want = (jiou > thr) & np.triu(np.ones((n, n), bool), k=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got, 1)[::2], iou > t)
    scores = np.linspace(1.0, 0.5, n, dtype=np.float32)
    _assert_same(jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, n),
                 tnms.nms(*_t(boxes, scores), thr, n))


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_threshold_ties_at_an_80_class_offset_match_jax_division(thr):
    """The threshold-tie pairs moved right by class 79's offset on a 640-px
    tile (79 x 641, where the float32 spacing of a coordinate is ~0.004):
    the same IoUs, bits and keep sets as the JAX division form."""
    boxes, iou = threshold_tie_boxes(thr, x_offset=79 * 641)
    assert boxes[:, 0].min() == 79 * 641
    n = boxes.shape[0]
    got = _unpack(nms_cuda.iou_bitmask_plain(torch.from_numpy(boxes)[None],
                                             thr), n)[0]
    jiou = np.asarray(jnms._pairwise_iou(jnp.asarray(boxes),
                                         jnp.asarray(boxes)))
    np.testing.assert_array_equal(np.diag(jiou, 1)[::2], iou)
    want = (jiou > thr) & np.triu(np.ones((n, n), bool), k=1)
    np.testing.assert_array_equal(got, want)
    scores = np.linspace(1.0, 0.5, n, dtype=np.float32)
    _assert_same(jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, n),
                 tnms.nms(*_t(boxes, scores), thr, n))


def test_batched_nms_80_classes_matches_jax():
    """Mask R-CNN's RoI-head NMS: 80 classes by coordinate offsets (up to
    ~79 x 681 on 640x512 boxes), invalid rows, the keep set of the JAX
    function."""
    rng = np.random.RandomState(80)
    boxes, scores, valid, labels = _boxes(rng, 3000, n_classes=80)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(labels), 0.5, 100,
                            valid_mask=jnp.asarray(valid))
    got = tnms.batched_nms(*_t(boxes, scores, labels), 0.5, 100,
                           valid_mask=torch.from_numpy(valid))
    assert int(got[1]) == 100 and len(np.unique(labels)) == 80
    _assert_same(want, got)


@pytest.mark.parametrize("thr", [-0.1, -1e-30, float("nan")])
def test_bitmask_refuses_negative_threshold(thr):
    """A pair that does not overlap skips the IoU as 0 > thr is false,
    which needs thr >= 0."""
    boxes = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="iou_threshold"):
        nms_cuda.iou_bitmask(boxes, thr, torch.full((1,), 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="iou_threshold"):
        tnms.nms(boxes[0], torch.ones(8), thr, 8)

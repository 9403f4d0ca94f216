"""The CUDA kernels (NMS pair, multilevel RoIAlign) against their plain
PyTorch versions, on the card.

These tests import no JAX, so they run where only the port is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which sets up JAX). Without a CUDA
card they skip: the kernels have no CPU mode.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (plain_nms, sorted_nms_inputs, synthetic_boxes,
                        synthetic_rois, threshold_tie_boxes)
from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
    map_roi_levels
from pointtinybenchmark_tpu_torch.ops import (nms, nms_cuda, roi_align,
                                              roi_align_cuda)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rng, b, n, n_classes, device):
    boxes, scores, valid, labels = synthetic_boxes(rng, b, n, n_classes)
    return [torch.from_numpy(x).to(device)
            for x in (boxes, scores, labels, valid)]


# every launch shape of both main paths: RetinaNet-c per tile, the global
# merge, the Faster R-CNN RPN (levels as classes) and RoI head
LAUNCH_SHAPES = [(24, 8720, 1, 0.5), (2, 12000, 3, 0.5), (24, 7200, 5, 0.7),
                 (24, 1000, 1, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_classes,thr,max_out", [
    (4, 3000, 2, 0.5, 1000),      # several batch items, class offsets
    (1, 1, 1, 0.5, 5),            # one box, output padded with -1
    (3, 130, 1, 0.5, 1000),       # N not a multiple of the 64-bit word
    (2, 2000, 3, 0.5, 17),        # truncated at max_out
] + [shape + (1000,) for shape in LAUNCH_SHAPES])
def test_kernels_match_plain(cuda, b, n, n_classes, thr, max_out):
    boxes, scores, labels, valid = _inputs(np.random.RandomState(n), b, n,
                                           n_classes, cuda)
    before = dict(nms_cuda.launches)
    got = nms.batched_nms(boxes, scores, labels, thr, max_out,
                          valid_mask=valid)
    assert nms_cuda.launches["iou_bitmask"] == before["iou_bitmask"] + 1
    assert nms_cuda.launches["greedy_reduce"] == before["greedy_reduce"] + 1
    with plain_nms():
        want = nms.batched_nms(boxes, scores, labels, thr, max_out,
                               valid_mask=valid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_classes,thr,valid_share", [
    (2, 1000, 1, 0.5, 0.95),
    (3, 130, 1, 0.5, 0.0),        # n_valid = 0: nothing defined, nothing kept
    (3, 700, 2, 0.5, 0.4),        # n_valid well under N
    (1, 1, 1, 0.5, 1.0),
    (2, 64, 1, 0.7, 1.0),         # exactly one word
] + [shape + (0.95,) for shape in LAUNCH_SHAPES])
def test_bitmask_kernel_matches_plain_bits(cuda, b, n, n_classes, thr,
                                           valid_share):
    """Kernel A against the plain mask on the bits it defines (rows and
    columns < n_valid, words from the row's diagonal word on), and kernel B
    on the kernel's mask against the plain walk on the plain mask."""
    rng = np.random.RandomState(b * n)
    boxes, scores, labels, valid = _inputs(rng, b, n, n_classes, cuda)
    valid &= torch.from_numpy(rng.rand(b, n) < valid_share).to(cuda)
    sboxes, ok, order, n_valid = sorted_nms_inputs(boxes, scores, labels,
                                                   valid)
    got = nms_cuda.iou_bitmask(sboxes, thr, n_valid)
    want = nms_cuda.iou_bitmask_plain(sboxes, thr)
    keep = nms_cuda.greedy_reduce(got, ok, order, 1000, n_valid)
    keep_plain = nms_cuda.greedy_reduce_plain(want, ok, order, 1000)
    torch.cuda.synchronize()
    assert torch.equal(nms_cuda.defined_words(got, n_valid),
                       nms_cuda.defined_words(want, n_valid))
    assert torch.equal(keep[0], keep_plain[0])
    assert torch.equal(keep[1], keep_plain[1])
    if valid_share == 0.0:
        assert int(n_valid.max()) == 0 and int(keep[1].max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_threshold_ties_kernel_matches_plain(cuda, thr):
    """IoUs of exactly thr and its float neighbours: only the one above
    suppresses, in the kernel as in the plain division form."""
    boxes, iou = threshold_tie_boxes(thr)
    tie = torch.from_numpy(boxes)[None].to(cuda)
    every = torch.tensor([tie.shape[1]], dtype=torch.int32, device=cuda)
    got = nms_cuda.defined_words(nms_cuda.iou_bitmask(tie, thr, every), every)
    want = nms_cuda.defined_words(nms_cuda.iou_bitmask_plain(tie, thr), every)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    bits = got[0].cpu().numpy().view(np.uint64)
    pair = [(bits[2 * p, 0] >> np.uint64(2 * p + 1)) & np.uint64(1)
            for p in range(len(iou))]
    np.testing.assert_array_equal(np.asarray(pair, bool),
                                  iou > np.float32(thr))
    scores = torch.linspace(1.0, 0.5, tie.shape[1], device=cuda)
    keep = nms.nms(tie[0], scores, thr, tie.shape[1])
    with plain_nms():
        keep_plain = nms.nms(tie[0], scores, thr, tie.shape[1])
    assert torch.equal(keep[0], keep_plain[0])


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 0.5])
def test_degenerate_boxes_match_plain(cuda, thr):
    """Boxes with a NaN or an infinite coordinate, inverted and empty boxes,
    among ordinary ones on a small integer grid (many equal coordinates):
    the kernel sets exactly the bits of the plain version, whose max and
    clamp propagate NaN."""
    rng = np.random.RandomState(11)
    boxes = rng.randint(-4, 5, (2, 300, 4)).astype(np.float32)
    special = rng.rand(2, 300, 4)
    boxes[special < 0.03] = np.nan
    boxes[(special >= 0.03) & (special < 0.06)] = np.inf
    boxes[(special >= 0.06) & (special < 0.09)] = -np.inf
    sboxes = torch.from_numpy(boxes).to(cuda)
    every = torch.full((2,), 300, dtype=torch.int32, device=cuda)
    got = nms_cuda.defined_words(nms_cuda.iou_bitmask(sboxes, thr, every),
                                 every)
    want = nms_cuda.defined_words(nms_cuda.iou_bitmask_plain(sboxes, thr),
                                  every)
    torch.cuda.synchronize()
    assert int(want.ne(0).sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("c,out,sr,aligned,channels_last,r", [
    (256, 7, 1, True, True, 3000),     # the Faster R-CNN extractor
    (256, 14, 2, True, True, 300),     # the Mask R-CNN mask extractor
    (40, 7, 2, False, False, 500),     # ragged channel chunk, NCHW maps
    (64, 7, 1, True, True, 0),         # no roi
])
def test_roi_align_kernel_matches_plain(cuda, c, out, sr, aligned,
                                        channels_last, r):
    levels = ((64, 80), (32, 40), (16, 20), (8, 10))
    gen = torch.Generator(device=cuda).manual_seed(c + r)
    feats = [torch.randn((3, h, w, c), generator=gen, device=cuda)
             .permute(0, 3, 1, 2) for h, w in levels]
    if not channels_last:
        feats = [f.contiguous() for f in feats]
    rois = torch.from_numpy(synthetic_rois(np.random.RandomState(r), 3, r,
                                           (256, 320))).to(cuda)
    lvls = map_roi_levels(rois, len(levels))
    before = roi_align_cuda.launches["roi_align"]
    got = roi_align.roi_align_multilevel(feats, rois, lvls, (4, 8, 16, 32),
                                         out, sr, aligned)
    # no roi, no launch: the wrapper counts only launches
    assert roi_align_cuda.launches["roi_align"] == before + (r > 0)
    want = roi_align.roi_align_multilevel_plain(feats, rois, lvls,
                                                (4, 8, 16, 32), out, sr,
                                                aligned)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (r, c, out, out)
    if r:
        tol = 1e-5 * max(float(f.abs().max()) for f in feats)
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_roi_align_kernel_out_of_range_rois_get_nan(cuda):
    """A batch index or level outside the maps gives NaN rows and reads
    nothing; the other rows are untouched."""
    feats = [torch.randn((2, h, w, 32), device=cuda).permute(0, 3, 1, 2)
             for h, w in ((32, 40), (16, 20))]
    rois = torch.tensor([[0, 10, 10, 40, 40], [2, 10, 10, 40, 40],
                         [-1, 10, 10, 40, 40], [1, 5, 5, 30, 20],
                         [1, 5, 5, 30, 20]], dtype=torch.float32,
                        device=cuda)
    lvls = torch.tensor([0, 0, 1, 1, 2], device=cuda)
    got = roi_align_cuda.roi_align_forward(feats, rois, lvls, (4, 8), 7, 1)
    want = roi_align.roi_align_multilevel_plain(feats, rois[[0, 3]],
                                                lvls[[0, 3]], (4, 8), 7, 1)
    torch.cuda.synchronize()
    assert torch.isnan(got[[1, 2, 4]]).all()
    assert torch.equal(got[[0, 3]], want)

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

from chip_smoke import (edge_rois, plain_nms, sorted_nms_inputs,
                        synthetic_boxes, synthetic_rois, threshold_tie_boxes)
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


# every launch shape of the main paths: RetinaNet-c per tile, the global
# merge, the Faster R-CNN RPN (levels as classes) and RoI head, the Mask
# R-CNN RPN, RoI head (80 classes by coordinate offsets, after the pre-NMS
# cap of 20,000) and global merge (80 classes)
LAUNCH_SHAPES = [(24, 8720, 1, 0.5), (2, 12000, 3, 0.5), (24, 7200, 5, 0.7),
                 (24, 1000, 1, 0.5), (24, 4200, 5, 0.7), (24, 20000, 80, 0.5),
                 (2, 1200, 80, 0.5)]


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
    _check_threshold_ties(cuda, thr, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_threshold_ties_at_an_80_class_offset_kernel_matches_plain(cuda, thr):
    """The same pairs moved right by class 79's offset on a 640-px tile,
    as Mask R-CNN's 80-class RoI-head NMS moves its boxes."""
    _check_threshold_ties(cuda, thr, 79 * 641)


def _check_threshold_ties(cuda, thr, x_offset):
    boxes, iou = threshold_tie_boxes(thr, x_offset=x_offset)
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


def _roi_case(case, c, r, channels_last, cuda):
    """(feats, rois, lvls) on the card: 256x320 tiles with four levels."""
    levels = ((64, 80), (32, 40), (16, 20), (8, 10))
    b = 8 if case == "shuffled" else 3
    gen = torch.Generator(device=cuda).manual_seed(c + r)
    feats = [torch.randn((b, h, w, c), generator=gen, device=cuda)
             .permute(0, 3, 1, 2) for h, w in levels]
    if not channels_last:
        feats = [f.contiguous() for f in feats]
    rng = np.random.RandomState(r)
    if case.startswith("edge"):
        rois = torch.from_numpy(edge_rois(b, (256, 320))).to(cuda)
    else:
        rois = synthetic_rois(rng, b, r, (256, 320))
        if case == "shuffled":
            rois = rois[np.argsort(rois[:, 0], kind="stable")]
            rois = rois[rng.permutation(r)]
        rois = torch.from_numpy(rois).to(cuda)
    lvls = map_roi_levels(rois, len(levels))
    if case == "edge_every_level":
        # each edge roi (the whole tile among them) at every level
        lvls = torch.arange(len(levels), device=cuda).repeat_interleave(
            rois.shape[0])
        rois = rois.repeat(len(levels), 1)
    return feats, rois, lvls


@pytest.mark.cuda
@pytest.mark.parametrize("case,c,out,sr,aligned,channels_last,r,path", [
    ("synthetic", 256, 7, 1, True, True, 3000, None),   # Faster R-CNN crops
    ("synthetic", 256, 14, 2, True, True, 300, None),   # Mask R-CNN crops
    ("synthetic", 256, 7, 2, True, True, 3000, None),   # its bbox crops
    ("synthetic", 40, 7, 2, False, False, 500, None),   # ragged chunk, NCHW
    ("synthetic", 42, 7, 1, True, True, 300, None),     # C % 4 != 0
    ("synthetic", 64, 7, 1, True, True, 0, None),       # no roi
    ("synthetic", 64, 7, 1, True, True, 1, None),       # R = 1
    ("shuffled", 64, 7, 1, True, True, 2000, None),     # 8 tiles, no order
    # whole-tile, 1:8, zero-area, inverted and off-edge rois: over the
    # window budget at S=7 (slots), in bands at S=14, sr=2, and on the
    # global path at S=28 (no room for staged cells beside the tiles)
    ("edge", 256, 7, 1, True, True, 0, None),
    ("edge", 64, 7, 2, False, True, 0, None),
    ("edge_every_level", 256, 7, 1, True, True, 0, None),
    ("edge_every_level", 256, 14, 2, True, True, 0, "bands"),
    ("edge_every_level", 256, 7, 2, True, True, 0, None),
    ("edge", 32, 28, 2, True, True, 0, "global"),
])
def test_roi_align_kernel_matches_plain(cuda, case, c, out, sr, aligned,
                                        channels_last, r, path):
    feats, rois, lvls = _roi_case(case, c, r, channels_last, cuda)
    n = rois.shape[0]
    before = roi_align_cuda.launches["roi_align"]
    got = roi_align.roi_align_multilevel(feats, rois, lvls, (4, 8, 16, 32),
                                         out, sr, aligned)
    # no roi, no launch: the wrapper counts only launches
    assert roi_align_cuda.launches["roi_align"] == before + (n > 0)
    want = roi_align.roi_align_multilevel_plain(feats, rois, lvls,
                                                (4, 8, 16, 32), out, sr,
                                                aligned)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, c, out, out)
    assert torch.equal(got, want)
    if path is not None:
        counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                             device=cuda)
        roi_align_cuda.roi_align_forward(feats, rois, lvls, (4, 8, 16, 32),
                                         out, sr, aligned, path_counts=counts)
        paths = dict(zip(roi_align_cuda.PATHS, counts.tolist()))
        assert paths[path] > 0 and sum(paths.values()) == n, paths


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

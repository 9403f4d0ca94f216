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

from chip_smoke import plain_nms, synthetic_boxes, synthetic_rois
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_classes,max_out", [
    (4, 3000, 2, 1000),      # several batch items, class offsets
    (1, 1, 1, 5),            # one box, output padded with -1
    (3, 130, 1, 1000),       # N not a multiple of the 64-bit word
    (2, 2000, 3, 17),        # truncated at max_out
])
def test_kernels_match_plain(cuda, b, n, n_classes, max_out):
    boxes, scores, labels, valid = _inputs(np.random.RandomState(n), b, n,
                                           n_classes, cuda)
    before = dict(nms_cuda.launches)
    got = nms.batched_nms(boxes, scores, labels, 0.5, max_out,
                          valid_mask=valid)
    assert nms_cuda.launches["iou_bitmask"] == before["iou_bitmask"] + 1
    assert nms_cuda.launches["greedy_reduce"] == before["greedy_reduce"] + 1
    with plain_nms():
        want = nms.batched_nms(boxes, scores, labels, 0.5, max_out,
                               valid_mask=valid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_bitmask_kernel_matches_plain_bits(cuda):
    boxes, _, _, _ = _inputs(np.random.RandomState(7), 2, 1000, 1, cuda)
    got = nms_cuda.iou_bitmask(boxes, 0.5)
    want = nms_cuda.iou_bitmask_plain(boxes, 0.5)
    torch.cuda.synchronize()
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

"""The CUDA NMS kernels against their plain PyTorch version, on the card.

These tests import no JAX, so they run where only the port is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which sets up JAX). Without a CUDA
card they skip: the kernels have no CPU mode.
"""
import numpy as np
import pytest
import torch

from chip_smoke import plain_nms, synthetic_boxes
from pointtinybenchmark_tpu_torch.ops import nms, nms_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernels have no CPU mode")
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

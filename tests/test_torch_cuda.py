"""The CUDA kernels (NMS pair, multilevel RoIAlign, its backward for the
maps and for the roi coordinates) against their plain PyTorch versions, on
the card; and train steps on the card: the RoIAlign kernels on a Mask
R-CNN step's own rois and a Grid R-CNN step's (the grid rois at S=14
sr=2), a RetinaNet-c step against the CPU's; FCOS, ATSS and RepPoints
(detections on a tile and a train step) against the CPU's.

These tests import no JAX, so they run where only the port is installed:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest skips tests/conftest.py, which sets up JAX). Without a CUDA
card they skip: the kernels have no CPU mode.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (CONFIG, GRAD_TOL, LOSS_TOL, MASK_CONFIG,
                        ROIS_BWD_TOL, bound_tie_rois, clustered_rois,
                        coco_train_samples,
                        compare_roi_align, compare_roi_align_backward,
                        double_step, edge_rois, grad_error, one_step,
                        plain_nms,
                        recorded, sorted_nms_inputs, square_tie_boxes,
                        synthetic_boxes, synthetic_rois, threshold_tie_boxes,
                        train_model,
                        train_samples)
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
    map_roi_levels
from pointtinybenchmark_tpu_torch.ops import (nms, nms_cuda, roi_align,
                                              roi_align_cuda)
from pointtinybenchmark_tpu_torch.utils.config import Config


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


@pytest.mark.cuda
@pytest.mark.parametrize("x_offset", [0, 79 * 641])
def test_square_threshold_ties_at_p2p_threshold_kernel_matches_plain(
        cuda, x_offset):
    """P2P's per-tile NMS threshold 0.01 on 16x16 pseudo boxes whose IoU is
    0.01 or a float neighbour, with and without a class offset."""
    _check_threshold_ties(cuda, 0.01, x_offset, square_tie_boxes)


def _check_threshold_ties(cuda, thr, x_offset, make=threshold_tie_boxes):
    boxes, iou = make(thr, x_offset=x_offset)
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


# ------------------------------------------------ RoIAlign backward (K2)
BWD_LEVELS = ((128, 160), (64, 80), (32, 40), (16, 20))   # a 512x640 image


def _bwd_inputs(cuda, r, c=256, b=2, channels_last=True, seed=0):
    """(feats, rois, lvls, upstream gradient) on the card: b images' level
    maps (B, C, H, W), r rois of the smoke's synthetic (TinyPerson-like)
    kind, and a seeded (R, C, S, S)-shaped gradient maker."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    feats = [torch.randn((b, h, w, c), generator=gen, device=cuda)
             .permute(0, 3, 1, 2) for h, w in BWD_LEVELS]
    if not channels_last:
        feats = [f.contiguous() for f in feats]
    rois = torch.from_numpy(synthetic_rois(np.random.RandomState(seed), b,
                                           r)).to(cuda)
    return feats, rois, map_roi_levels(rois, len(BWD_LEVELS)), gen


def _bwd(feats, rois, lvls, g, out, sr, plain=False):
    """The level maps' gradient for upstream g: through the public entry
    (the kernels), or by autograd through the plain version."""
    leaves = [f.detach().clone().requires_grad_() for f in feats]
    fn = (roi_align.roi_align_multilevel_plain if plain
          else roi_align.roi_align_multilevel)
    y = fn(leaves, rois, lvls, (4, 8, 16, 32), out, sr, True)
    y.backward(g)
    return [f.grad for f in leaves]


def _assert_grads_close(got, want):
    """Each level within 1e-5 of its max |gradient|: float atomics sum in
    no fixed order."""
    assert any(float(w.abs().max()) > 0 for w in want)
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()) + 1e-30, err


@pytest.mark.cuda
@pytest.mark.parametrize("r,out,sr,edge", [
    (1024, 7, 1, False),    # Faster R-CNN training: 512 rois an image
    (1024, 7, 2, False),    # Mask R-CNN training's bbox rois
    (256, 14, 2, False),    # its mask rois (128 positives an image)
    (0, 7, 1, True),        # edge_rois at S=7
    (0, 14, 2, True),       # and at S=14 sr=2
])
def test_roi_align_backward_matches_plain(cuda, r, out, sr, edge):
    feats, rois, lvls, gen = _bwd_inputs(cuda, r)
    if edge:
        rois = torch.from_numpy(edge_rois(2)).to(cuda)
        lvls = map_roi_levels(rois, len(BWD_LEVELS))
    g = torch.randn((rois.shape[0], 256, out, out), generator=gen,
                    device=cuda)
    before = dict(roi_align_cuda.launches)
    got = _bwd(feats, rois, lvls, g, out, sr)
    assert roi_align_cuda.launches["roi_align_backward"] == \
        before["roi_align_backward"] + 1
    assert roi_align_cuda.launches["roi_align"] == before["roi_align"] + 1
    want = _bwd(feats, rois, lvls, g, out, sr, plain=True)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)
    for x, f in zip(got, feats):       # the maps' channels-last layout
        assert x.stride() == f.stride()


@pytest.mark.cuda
def test_roi_align_backward_invalid_rois_write_nothing(cuda):
    """Rois with a batch index or level out of range add no gradient: the
    result is that of the valid rois alone."""
    feats, rois, lvls, gen = _bwd_inputs(cuda, 64)
    bad = rois[:4].clone()
    bad[0, 0], bad[1, 0], bad[2, 0] = 2.0, -1.0, float("nan")
    bad_lvls = torch.tensor([0, 1, 2, 7], device=cuda)
    g = torch.randn((68, 256, 7, 7), generator=gen, device=cuda)
    got = roi_align_cuda.roi_align_backward(
        g, torch.cat([rois, bad]), torch.cat([lvls, bad_lvls]),
        [tuple(f.shape) for f in feats], [True] * 4, (4, 8, 16, 32), 7, 1)
    want = roi_align_cuda.roi_align_backward(
        g[:64], rois, lvls, [tuple(f.shape) for f in feats], [True] * 4,
        (4, 8, 16, 32), 7, 1)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)


@pytest.mark.cuda
def test_roi_align_backward_no_rois_gives_zeros(cuda):
    feats, rois, lvls, _ = _bwd_inputs(cuda, 8)
    before = roi_align_cuda.launches["roi_align_backward"]
    got = roi_align_cuda.roi_align_backward(
        torch.zeros((0, 256, 7, 7), device=cuda), rois[:0], lvls[:0],
        [tuple(f.shape) for f in feats], [True, False, True, False],
        (4, 8, 16, 32), 7, 1)
    assert roi_align_cuda.launches["roi_align_backward"] == before
    for x, f in zip(got, feats):
        assert x.shape == f.shape and not x.any()


@pytest.mark.cuda
def test_roi_align_backward_layouts_agree(cuda):
    """Channels-last and NCHW-contiguous maps of the same values: the same
    gradient, each in its map's layout."""
    feats, rois, lvls, gen = _bwd_inputs(cuda, 512)
    g = torch.randn((512, 256, 7, 7), generator=gen, device=cuda)
    cl = _bwd(feats, rois, lvls, g, 7, 1)
    nchw_feats = [f.contiguous() for f in feats]
    nchw = _bwd(nchw_feats, rois, lvls, g, 7, 1)
    torch.cuda.synchronize()
    _assert_grads_close(nchw, cl)
    for x, f in zip(nchw, nchw_feats):
        assert x.is_contiguous() and x.stride() == f.stride()


@pytest.mark.cuda
def test_roi_align_backward_is_linear(cuda):
    """The gradient of 2 g is twice the gradient of g (a non-contiguous
    upstream gradient, as autograd may hand it)."""
    feats, rois, lvls, gen = _bwd_inputs(cuda, 512)
    g = torch.randn((256, 7, 7, 512), generator=gen,
                    device=cuda).permute(3, 0, 1, 2)
    shapes = [tuple(f.shape) for f in feats]
    one = roi_align_cuda.roi_align_backward(g, rois, lvls, shapes, [True] * 4,
                                            (4, 8, 16, 32), 7, 1)
    two = roi_align_cuda.roi_align_backward(2 * g, rois, lvls, shapes,
                                            [True] * 4, (4, 8, 16, 32), 7, 1)
    torch.cuda.synchronize()
    _assert_grads_close(two, [2 * x for x in one])


def _bwd_case(cuda, case):
    """(g, rois, lvls, level shapes, S, sr, the path every roi must take)
    for one case of the backward kernel's paths and flushes."""
    rng = np.random.RandomState(11)
    c, out, sr, path = 256, 7, 1, "whole"
    if case == "whole":
        rois = synthetic_rois(rng, 2, 512)
    elif case == "elongated":
        # the forward cuts these into bands (1:8 at level 0, S=14 sr=2); the
        # backward's grid lives in registers and takes them whole
        rois = np.asarray([(0, 10, 10, 34, 202), (1, 100, 20, 292, 44),
                           (0, 300, 200, 324, 392)], np.float32)
        out, sr = 14, 2
    elif case == "global":
        # S=24: one 32-channel chunk of the upstream gradient, twice, is over
        # the block's budget, so it is read from global memory
        rois = synthetic_rois(rng, 2, 64)
        out, path = 24, "global"
    elif case == "invalid":
        rois = synthetic_rois(rng, 2, 6)
        rois[0, 0], rois[1, 0], rois[2, 0] = 2.0, -1.0, float("nan")
        path = "invalid"
    elif case in ("c20", "c13"):      # C % 32 != 0; C % 4 != 0 (scalar flush)
        rois = synthetic_rois(rng, 2, 256)
        c, out, sr = int(case[1:]), 14, 2
    elif case == "identical":         # the worst flush contention
        rois = np.tile(np.asarray([[1, 200, 150, 230, 190]], np.float32),
                       (64, 1))
        out, sr = 14, 2
    elif case == "clustered":         # Mask R-CNN training's positives
        rois = clustered_rois(rng, 2, 128)
        out, sr = 14, 2
    rois = torch.from_numpy(rois).to(cuda)
    lvls = map_roi_levels(rois, len(BWD_LEVELS))
    if case == "invalid":
        lvls[3:] = torch.tensor([7, -1, 4], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    g = torch.randn((rois.shape[0], c, out, out), generator=gen, device=cuda)
    shapes = [(2, c, h, w) for h, w in BWD_LEVELS]
    return g, rois, lvls, shapes, out, sr, path


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole", "elongated", "global", "invalid",
                                  "c20", "c13", "identical", "clustered"])
def test_roi_align_backward_paths_match_plain(cuda, case):
    """Every roi takes the expected path of the backward kernel (its own
    counts, summing to R), and the gradient is the plain backward's within
    1e-5 of each level's max; out-of-range rois add nothing."""
    g, rois, lvls, shapes, out, sr, path = _bwd_case(cuda, case)
    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=cuda)
    cl = [True] * len(shapes)
    got = roi_align_cuda.roi_align_backward(g, rois, lvls, shapes, cl,
                                            (4, 8, 16, 32), out, sr,
                                            path_counts=counts)
    torch.cuda.synchronize()
    paths = dict(zip(roi_align_cuda.PATHS, counts.tolist()))
    assert paths[path] == rois.shape[0] == sum(paths.values()), paths
    if case == "invalid":
        assert not any(bool(x.any()) for x in got)
        return
    want = roi_align.roi_align_backward_plain(g, rois, lvls, shapes, cl,
                                              (4, 8, 16, 32), out, sr)
    torch.cuda.synchronize()
    _assert_grads_close(got, want)


# ---------------------------------------------------------- train steps
@pytest.fixture
def no_tf32(cuda):
    """f32 convolutions and products on the card, as on the CPU."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
def test_mask_rcnn_train_step_roi_align_matches_plain(cuda):
    """One step of the COCO Mask R-CNN config at full width on two 400x667
    images with masks: both RoIAlign launches (bbox rois S=7 sr=2, mask
    rois S=14 sr=2), forward torch.equal to plain and backward within 1e-5
    of each level's max, on the step's own features, rois and gradients."""
    cfg = Config.fromfile(str(MASK_CONFIG))
    model = train_model(cfg, device=cuda)
    samples = coco_train_samples(np.random.RandomState(12), 2, (400, 667))
    batch = batch_to_device(DetCollator(None, 32, max_gt=32)(samples), cuda)
    fwd, bwd = [], []
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd):
        metrics, _ = one_step(model, cfg, batch, seed=0, device=cuda)
    assert np.isfinite(metrics["loss_mask"]) and metrics["rcnn_num_pos"] > 0
    assert sorted(args[4:6] for args, _, _ in fwd) == [(7, 2), (14, 2)]
    assert sorted(args[0].shape[-1] for args, _, _ in bwd) == [7, 14]
    for (feats, rois, lvls, _, out, sr, *_), _, _ in fwd:
        feats = [f.detach() for f in feats]
        g = next(a[0] for a, _, _ in bwd if a[0].shape[-1] == out)
        compare_roi_align(feats, rois, lvls, out, sr)
        compare_roi_align_backward(g, rois, lvls,
                                   [tuple(f.shape) for f in feats], out, sr)


@pytest.mark.cuda
def test_grid_rcnn_train_step_roi_align_matches_plain(cuda):
    """One step of the Grid R-CNN config at full width on one 512x640
    image: both RoIAlign launches (bbox rois S=7 sr=1, the 96 jittered grid
    rois S=14 sr=2), forward torch.equal to plain and backward within 1e-5
    of each level's max, on the step's own features, rois and gradients;
    the roi-coordinate kernel not launched (the grid rois carry no
    gradient)."""
    from chip_smoke import GRID_CONFIG
    cfg = Config.fromfile(str(GRID_CONFIG))
    model = train_model(cfg, device=cuda)
    batch = batch_to_device(DetCollator((512, 640))(
        train_samples(np.random.RandomState(16), 1)), cuda)
    fwd, bwd = [], []
    before = roi_align_cuda.launches["roi_align_rois_backward"]
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd):
        metrics, _ = one_step(model, cfg, batch, seed=0, device=cuda)
    assert roi_align_cuda.launches["roi_align_rois_backward"] == before
    assert np.isfinite(metrics["loss_grid"]) and metrics["rcnn_num_pos"] > 0
    assert sorted(tuple(args[4:6]) for args, _, _ in fwd) == [(7, 1), (14, 2)]
    assert sorted(args[0].shape[-1] for args, _, _ in bwd) == [7, 14]
    for (feats, rois, lvls, _, out, sr, *_), _, _ in fwd:
        feats = [f.detach() for f in feats]
        g = next(a[0] for a, _, _ in bwd if a[0].shape[-1] == out)
        compare_roi_align(feats, rois, lvls, out, sr)
        compare_roi_align_backward(g, rois, lvls,
                                   [tuple(f.shape) for f in feats], out, sr)


@pytest.mark.cuda
def test_retinanet_c_train_step_matches_cpu(no_tf32):
    """One step of the Adap RetinaNet-c clipg config at full width on one
    512x640 image (the focal loss samples nothing): the card's float32
    losses within 1e-4 of the CPU's, and in float64 each gradient within
    1e-4 of its parameter's max (float32 rounding alone moves the
    full-width network's gradients by ~6e-3 of a parameter's max:
    chip_smoke phase 7 prints it)."""
    cfg = Config.fromfile(str(CONFIG))
    collated = DetCollator((512, 640))(
        train_samples(np.random.RandomState(13), 1))
    got, _ = one_step(train_model(cfg, device=no_tf32), cfg,
                      batch_to_device(collated, no_tf32), seed=0,
                      device=no_tf32)
    want, _ = one_step(train_model(cfg, device="cpu"), cfg,
                       batch_to_device(collated, "cpu"), seed=0,
                       device="cpu")
    assert want["num_pos"] > 1
    for k in ("loss", "loss_cls", "loss_bbox", "num_pos"):
        assert abs(got[k] - want[k]) <= LOSS_TOL * abs(want[k]), k
    _, got_g = double_step(cfg, collated, 0, no_tf32)
    _, want_g = double_step(cfg, collated, 0, "cpu")
    assert grad_error(got_g, want_g) <= GRAD_TOL


# ------------------------------------------------------- the point stack
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_auction_on_the_card_equals_the_cpu(cuda, k):
    """The top-k auction (P2P's matcher) on the card gives the CPU's
    assignment on the same cost matrix, padded gts included."""
    from pointtinybenchmark_tpu_torch.core.assigners import topk_auction_match
    rng = np.random.RandomState(k)
    cost = (rng.rand(2, 4000, 60) * 30).astype(np.float32)
    valid = np.arange(60)[None] < np.asarray([60, 17])[:, None]
    got = topk_auction_match(torch.from_numpy(cost).to(cuda),
                             torch.from_numpy(valid).to(cuda), k)
    want = topk_auction_match(torch.from_numpy(cost), torch.from_numpy(valid),
                              k)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_point_sample_pixel_on_the_card_matches_the_cpu(cuda):
    """CPR's bilinear point sampling: values, and the gradients with
    respect to the map (index_add_ atomics on the card) and the points,
    within 1e-6 of each one's max."""
    from pointtinybenchmark_tpu_torch.ops.grid_sample import \
        point_sample_pixel
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 40, 40, 32).astype(np.float32)
    pts = rng.uniform(-3, 43, (2, 3000, 2)).astype(np.float32)
    wts = rng.randn(2, 3000, 32).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        f = torch.from_numpy(feat).to(dev).requires_grad_()
        p = torch.from_numpy(pts).to(dev).requires_grad_()
        v = point_sample_pixel(f, p)
        (v * torch.from_numpy(wts).to(dev)).sum().backward()
        out.append([t.detach().cpu() for t in (v, f.grad, p.grad)])
    for want, got in zip(*out):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case,out,sr,aligned", [
    ("synthetic", 7, 2, True),     # P2BNet's and SSD-Det's S and sr
    ("synthetic", 7, 1, True),
    ("edge", 7, 2, True),          # edge_rois and samples on clamp bounds
    ("edge", 3, 3, False),         # the generic form, unaligned widths
    ("synthetic", 14, 2, True),    # a chunk of 32 channels
])
def test_roi_align_rois_backward_matches_plain(cuda, case, out, sr, aligned):
    """The roi-coordinate kernel against autograd through the plain forward
    (roi_align_rois_backward_plain): each coordinate column within
    ROIS_BWD_TOL of its max |gradient|; rois off the map get 0; the public
    entry launches it once a backward when the rois need a gradient, and
    gives the batch-index column none; a launch repeats bit for bit."""
    feats, rois, lvls, gen = _bwd_inputs(cuda, 600)
    if case == "edge":
        rng = np.random.RandomState(1)
        rois = torch.from_numpy(np.concatenate([
            edge_rois(2), bound_tie_rois(2, (512, 640), rng)])).to(cuda)
        lvls = map_roi_levels(rois, len(BWD_LEVELS))
    g = torch.randn((rois.shape[0], 256, out, out), generator=gen,
                    device=cuda)
    got = roi_align_cuda.roi_align_rois_backward(g, feats, rois, lvls,
                                                 (4, 8, 16, 32), out, sr,
                                                 aligned)
    again = roi_align_cuda.roi_align_rois_backward(g, feats, rois, lvls,
                                                   (4, 8, 16, 32), out, sr,
                                                   aligned)
    want = roi_align.roi_align_rois_backward_plain(g, feats, rois, lvls,
                                                   (4, 8, 16, 32), out, sr,
                                                   aligned)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    top = want.abs().amax(0)
    assert bool((top > 0).all())
    assert bool(((got - want).abs().amax(0) <= ROIS_BWD_TOL * top).all())
    if case == "edge":       # edge_rois' two rows wholly off each map
        off = [13 * i + k for i in range(2) for k in (11, 12)]
        assert bool((got[off] == 0).all())
    r = rois.clone().requires_grad_()
    before = dict(roi_align_cuda.launches)
    y = roi_align.roi_align_multilevel(feats, r, lvls, (4, 8, 16, 32), out,
                                       sr, aligned)
    y.backward(g)
    assert roi_align_cuda.launches["roi_align_rois_backward"] == \
        before["roi_align_rois_backward"] + 1
    assert torch.equal(r.grad[:, 1:], got) and bool((r.grad[:, 0] == 0).all())


@pytest.mark.cuda
def test_roi_align_rois_backward_only_when_the_rois_need_it(cuda):
    """Detached rois launch no roi-coordinate kernel; the maps' gradient is
    the same either way."""
    feats, rois, lvls, gen = _bwd_inputs(cuda, 300)
    g = torch.randn((300, 256, 7, 7), generator=gen, device=cuda)
    before = roi_align_cuda.launches["roi_align_rois_backward"]
    a = _bwd(feats, rois, lvls, g, 7, 2)
    assert roi_align_cuda.launches["roi_align_rois_backward"] == before
    b = _bwd(feats, rois.clone().requires_grad_(), lvls, g, 7, 2)
    assert roi_align_cuda.launches["roi_align_rois_backward"] == before + 1
    _assert_grads_close(a, b)


def _rois_case(cuda, case):
    """(feats, rois, lvls, g, S, sr, the path every roi must take) for one
    path of the roi-coordinate kernel at P2BNet's S=7: its grid staged
    whole (2-4 px rois at sr=2, also with C % 4 != 0), staged in bands
    (1-2 px wide, 40-60 px tall rois on level 0 at sr=2: the grid is over
    a buffer's cells, one output row's is not; the bins read each staged
    cell more than kRoisMinReuse times), read from global memory
    (whole-image rois on level 0 at sr=8: even one output row's grid is
    over a buffer), or out of range."""
    rng = np.random.RandomState(13)
    c, out, sr, path = 256, 7, 2, "whole"
    n = 24
    lo, hi = {"bands": ((1, 40), (2, 60)),
              "global": ((600, 600), (640, 640))}.get(case, ((2, 2), (4, 4)))
    size = rng.uniform(lo, hi, (n, 2)).clip(max=[640, 512])
    x1 = rng.uniform(0, 640 - size[:, 0])
    y1 = rng.uniform(0, 512 - size[:, 1])
    rois = np.stack([rng.randint(0, 2, n), x1, y1, x1 + size[:, 0],
                     y1 + size[:, 1]], 1).astype(np.float32)
    if case in ("bands", "global"):
        sr, path = (2 if case == "bands" else 8), case
    elif case == "invalid":
        rois = rois[:6]
        rois[0, 0], rois[1, 0], rois[2, 0] = 2.0, -1.0, float("nan")
        path = "invalid"
    elif case == "c13":
        c = 13
    gen = torch.Generator(device=cuda).manual_seed(14)
    feats = [torch.randn((2, h, w, c), generator=gen, device=cuda)
             .permute(0, 3, 1, 2) for h, w in BWD_LEVELS]
    rois = torch.from_numpy(rois).to(cuda)
    lvls = torch.zeros(rois.shape[0], dtype=torch.int64, device=cuda)
    if case == "invalid":
        lvls[3:] = torch.tensor([7, -1, 4], device=cuda)
    g = torch.randn((rois.shape[0], c, out, out), generator=gen, device=cuda)
    return feats, rois, lvls, g, out, sr, path


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole", "bands", "global", "invalid",
                                  "c13"])
def test_roi_align_rois_backward_paths_match_plain(cuda, case):
    """Every roi takes the expected path of the roi-coordinate kernel (its
    own counts, summing to R); the result is the plain version's within
    ROIS_BWD_TOL of each column's max |gradient|, and a second launch
    equals the first bit for bit; out-of-range rois get zeros."""
    feats, rois, lvls, g, out, sr, path = _rois_case(cuda, case)
    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=cuda)
    got = roi_align_cuda.roi_align_rois_backward(
        g, feats, rois, lvls, (4, 8, 16, 32), out, sr, path_counts=counts)
    again = roi_align_cuda.roi_align_rois_backward(
        g, feats, rois, lvls, (4, 8, 16, 32), out, sr)
    torch.cuda.synchronize()
    paths = dict(zip(roi_align_cuda.PATHS, counts.tolist()))
    assert paths[path] == rois.shape[0] == sum(paths.values()), paths
    assert torch.equal(got, again)
    if case == "invalid":
        assert bool((got == 0).all())
        return
    want = roi_align.roi_align_rois_backward_plain(g, feats, rois, lvls,
                                                   (4, 8, 16, 32), out, sr)
    torch.cuda.synchronize()
    top = want.abs().amax(0)
    assert bool((top > 0).all())
    assert bool(((got - want).abs().amax(0) <= ROIS_BWD_TOL * top).all())


# ------------------------------------------- the dense TinyPerson baselines
@pytest.mark.cuda
def test_point_sample_pixel_zeros_on_the_card_matches_the_cpu(cuda):
    """RepPoints' gather ("zeros" padding, points well past every edge):
    values and both gradients within 1e-6 of each one's max."""
    from pointtinybenchmark_tpu_torch.ops.grid_sample import \
        point_sample_pixel
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 32, 40, 16).astype(np.float32)
    pts = rng.uniform(-6, 46, (2, 4000, 2)).astype(np.float32)
    wts = rng.randn(2, 4000, 16).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        f = torch.from_numpy(feat).to(dev).requires_grad_()
        p = torch.from_numpy(pts).to(dev).requires_grad_()
        v = point_sample_pixel(f, p, padding_mode="zeros")
        (v * torch.from_numpy(wts).to(dev)).sum().backward()
        out.append([t.detach().cpu() for t in (v, f.grad, p.grad)])
    for want, got in zip(*out):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("family", [0, 1, 2], ids=["fcos", "atss",
                                                   "reppoints"])
def test_dense_baseline_on_the_card_matches_the_cpu(no_tf32, family):
    """The config at full width with seeded weights and its classifier's
    bias at 0: on one 512x640 tile the card's detections (through the NMS
    kernel pair, one launch each) match the CPU's at the golden
    tolerances; one train step on one image gives the CPU's losses within
    LOSS_TOL, with positives."""
    from chip_smoke import DENSE, dets_match, tile_dets
    _, config, cls_name = DENSE[family]
    cfg = Config.fromfile(str(config))
    img = torch.from_numpy(np.random.RandomState(2).randn(
        1, 512, 640, 3).astype(np.float32))
    dets = []
    for dev in ("cpu", no_tf32):
        model = train_model(cfg, device=dev)
        with torch.no_grad():
            getattr(model.bbox_head, cls_name).bias.zero_()
            before = dict(nms_cuda.launches)
            dets.append(tile_dets(model.simple_test(
                img.to(dev), torch.tensor([[512, 640]], device=dev))))
    assert nms_cuda.launches["iou_bitmask"] == before["iou_bitmask"] + 1
    assert dets_match(*dets) > 0
    collated = DetCollator((512, 640))(
        train_samples(np.random.RandomState(15), 1))
    got, _ = one_step(train_model(cfg, device=no_tf32), cfg,
                      batch_to_device(collated, no_tf32), seed=0,
                      device=no_tf32)
    want, _ = one_step(train_model(cfg, device="cpu"), cfg,
                       batch_to_device(collated, "cpu"), seed=0,
                       device="cpu")
    assert want["num_pos"] > 0
    for k in want:
        if k.startswith("loss") or k == "num_pos":
            assert abs(got[k] - want[k]) <= LOSS_TOL * abs(want[k]), k

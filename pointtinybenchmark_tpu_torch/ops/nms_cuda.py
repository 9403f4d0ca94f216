"""The NMS kernel pair (csrc/nms_kernel.cu), its plain PyTorch version, and
the dispatch between them.

`iou_bitmask` and `greedy_reduce` take a CUDA tensor to the hand-written
kernel and a CPU tensor to the plain version; any other device raises. The
library is compiled with nvcc at first use (`cuda_build`) and loaded with
ctypes. A failed build raises: there is no fallback.

`launches` counts kernel launches by name, so a run can show that it went
through the kernels. To hold a kernel against its plain version on the
card, call the `*_plain` functions directly; `defined_words` selects the
mask bits that the kernel defines, which are all that such a comparison may
look at.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build

__all__ = ["iou_bitmask", "greedy_reduce", "iou_bitmask_plain",
           "greedy_reduce_plain", "defined_words", "launches",
           "build_library", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "nms_kernel.cu"
WORD = 64                         # mask bits per uint64 word
PLAIN_ROW_CHUNK = 512             # rows of the plain IoU matrix per pass

launches = {"iou_bitmask": 0, "greedy_reduce": 0}

_lib = None
_lib_lock = threading.Lock()


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ptb_iou_bitmask.argtypes = [vp, vp, ci, ci, ctypes.c_float, vp,
                                        vp]
        lib.ptb_iou_bitmask.restype = ci
        lib.ptb_greedy_reduce.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp,
                                          vp]
        lib.ptb_greedy_reduce.restype = ci
        _lib = lib
        return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise RuntimeError(f"no NMS kernel for device {t.device}")


# ----------------------------------------------------------------- kernel A
def _check_n_valid(n_valid: torch.Tensor, b: int,
                   like: torch.Tensor) -> torch.Tensor:
    """n_valid as the kernel reads it: (B,) int32, contiguous, on the
    device of `like`. The caller holds it until the launch."""
    if n_valid.shape != (b,) or n_valid.dtype != torch.int32 \
            or n_valid.device != like.device:
        raise ValueError(f"expected n_valid ({b},) int32 on {like.device}, got "
                         f"{tuple(n_valid.shape)} {n_valid.dtype} "
                         f"{n_valid.device}")
    return n_valid.contiguous()


def iou_bitmask(boxes: torch.Tensor, iou_threshold: float,
                n_valid: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) f32 score-sorted boxes -> (B, N, ceil(N/64)) int64 words
    (uint64 bit patterns): bit j of row i set iff j > i and IoU > thr.

    n_valid (B,) int32, on the boxes' device, is the number of leading rows
    the reduce may keep (N for all). The kernel defines only the words
    that `greedy_reduce` reads: rows i < n_valid, words w >= i // 64, and in
    them the columns < n_valid (`defined_words`). The words left of a row's
    diagonal word and the rows and columns at or past n_valid are
    unspecified. The threshold must be >= 0: pairs that do not overlap skip
    the IoU, which is exact only because 0 > thr is then false."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"expected (B, N, 4) float32 boxes, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if not iou_threshold >= 0:
        raise ValueError(f"iou_threshold must be >= 0, got {iou_threshold}")
    if _route(boxes) == "plain":
        return iou_bitmask_plain(boxes, iou_threshold, n_valid)
    b, n, _ = boxes.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    n_valid = _check_n_valid(n_valid, b, boxes)
    boxes = boxes.contiguous()
    words = -(-n // WORD)
    mask = torch.empty((b, n, words), dtype=torch.int64, device=boxes.device)
    if b == 0 or n == 0:
        return mask
    lib = build_library()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    _check(lib.ptb_iou_bitmask(boxes.data_ptr(), n_valid.data_ptr(), b, n,
                               float(iou_threshold), mask.data_ptr(), stream),
           "iou_bitmask")
    launches["iou_bitmask"] += 1
    return mask


def defined_words(mask: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """`mask` with every bit that `iou_bitmask` leaves unspecified set to 0:
    what is left are rows i < n_valid, words w >= i // 64 and columns
    < n_valid. Two masks agree where the kernel is defined iff their
    `defined_words` are equal."""
    b, n, words = mask.shape
    dev = mask.device
    nv = n_valid.to(dev, torch.int64)
    rows = torch.arange(n, device=dev)
    w = torch.arange(words, device=dev)
    # columns < n_valid of each word, as a bit pattern (bit 63 is the sign)
    nbits = (nv[:, None] - w[None, :] * WORD).clamp(0, WORD)
    col_bits = torch.where(nbits >= WORD, torch.full_like(nbits, -1),
                           (torch.ones_like(nbits) << nbits.clamp(max=WORD - 1))
                           - 1)
    keep = ((rows[None, :, None] < nv[:, None, None])
            & (w[None, None, :] >= rows[None, :, None] // WORD))
    return torch.where(keep, mask & col_bits[:, None, :],
                       torch.zeros((), dtype=mask.dtype, device=dev))


def iou_bitmask_plain(boxes: torch.Tensor, iou_threshold: float,
                      n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel A, on the tensor's device: the IoU of
    ops/nms.py::_pairwise_iou in the same operation order, thresholded and
    packed 64 columns to a word, PLAIN_ROW_CHUNK rows at a time, each chunk
    from the word of its first row on (the words left of it hold no bit
    above the diagonal). Without `n_valid` it defines every bit (0 left of
    the diagonal); with it, the rows and columns below the batch's largest
    n_valid, which hold every bit the kernel defines, and 0 past them (a
    merge's padded slots cost nothing)."""
    b, n, _ = boxes.shape
    words = -(-n // WORD)
    dev = boxes.device
    out = torch.zeros((b, n, words), dtype=torch.int64, device=dev)
    m = n if n_valid is None or b == 0 else min(n, int(n_valid.max()))
    m_words = -(-m // WORD)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    cols = torch.arange(n, device=dev)
    shifts = torch.arange(WORD, dtype=torch.int64, device=dev)
    for r0 in range(0, m, PLAIN_ROW_CHUNK):
        r1 = min(r0 + PLAIN_ROW_CHUNK, m)
        sl = slice(r0, r1)
        w0 = r0 // WORD
        cs = slice(w0 * WORD, m)
        ix1 = torch.maximum(x1[:, sl, None], x1[:, None, cs])
        iy1 = torch.maximum(y1[:, sl, None], y1[:, None, cs])
        ix2 = torch.minimum(x2[:, sl, None], x2[:, None, cs])
        iy2 = torch.minimum(y2[:, sl, None], y2[:, None, cs])
        inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
        union = torch.clamp(area[:, sl, None] + area[:, None, cs] - inter,
                            min=1e-6)
        sup = (inter / union) > iou_threshold
        sup &= cols[None, None, cs] > torch.arange(r0, r1,
                                                   device=dev)[None, :, None]
        sup = torch.nn.functional.pad(sup, (0, m_words * WORD - m))
        # distinct powers of two: the sum is the OR, and bit 63 (the int64
        # sign) cannot overflow because the other bits sum below 2**63
        bits = (sup.view(b, r1 - r0, m_words - w0, WORD).to(torch.int64)
                << shifts)
        out[:, sl, w0:m_words] = bits.sum(-1)
    return out


# ----------------------------------------------------------------- kernel B
def greedy_reduce(mask: torch.Tensor, ok: torch.Tensor, order: torch.Tensor,
                  max_out: int, n_valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy walk of the sorted rows. mask (B, N, W) int64 from
    `iou_bitmask` with the same n_valid; ok (B, N) bool, row i may be kept;
    order (B, N) int32, original index of sorted row i; n_valid (B,) int32:
    ok must be False at rows >= n_valid, which the kernel never walks.
    Returns keep (B, max_out) int32 in pick order padded with -1, and
    num_kept (B,) int32."""
    b, n, words = mask.shape
    if ok.shape != (b, n) or order.shape != (b, n) or words != -(-n // WORD):
        raise ValueError(f"shape mismatch: mask {tuple(mask.shape)}, ok "
                         f"{tuple(ok.shape)}, order {tuple(order.shape)}")
    if mask.dtype != torch.int64 or ok.dtype != torch.bool \
            or order.dtype != torch.int32:
        raise ValueError("expected int64 mask, bool ok, int32 order")
    if _route(mask) == "plain":
        return greedy_reduce_plain(mask, ok, order, max_out, n_valid)
    # the removed bits and two 64-word diagonal slots, within the 48 KB a
    # block gets without opt-in; 1 KB is left for the kernel's static
    # shared memory
    smem = 8 * (words + 2 * WORD)
    if smem > 47 * 1024:
        raise ValueError(f"N={n} needs {smem} B of shared memory (limit "
                         f"{47 * 1024} without opt-in)")
    n_valid = _check_n_valid(n_valid, b, mask)
    dev = mask.device
    keep = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    num_kept = torch.zeros((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return keep, num_kept
    if max_out == 0 or n == 0:
        return keep.fill_(-1), num_kept
    mask, ok_u8, order = mask.contiguous(), ok.contiguous().view(torch.uint8), \
        order.contiguous()
    lib = build_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(lib.ptb_greedy_reduce(mask.data_ptr(), ok_u8.data_ptr(),
                                 order.data_ptr(), n_valid.data_ptr(), b, n,
                                 int(max_out),
                                 keep.data_ptr(), num_kept.data_ptr(), stream),
           "greedy_reduce")
    launches["greedy_reduce"] += 1
    return keep, num_kept


def greedy_reduce_plain(mask: torch.Tensor, ok: torch.Tensor,
                        order: torch.Tensor, max_out: int,
                        n_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B: the same walk in numpy on the host, one
    row at a time and vectorised over the batch. It walks every row, so
    `n_valid` changes nothing while ok is False past it."""
    b, n, _ = mask.shape
    m = mask.cpu().numpy().view(np.uint64)
    okn = ok.cpu().numpy()
    ordn = order.cpu().numpy()
    removed = np.zeros((b, m.shape[2]), np.uint64)
    keep = np.full((b, max_out), -1, np.int32)
    kept = np.zeros((b,), np.int64)
    rows = np.arange(b)
    for i in range(n):
        w, bit = divmod(i, WORD)
        free = ((removed[:, w] >> np.uint64(bit)) & np.uint64(1)) == 0
        live = rows[okn[:, i] & free & (kept < max_out)]
        if live.size == 0:
            continue
        keep[live, kept[live]] = ordn[live, i]
        kept[live] += 1
        removed[live] |= m[live, i]
    dev = mask.device
    return (torch.from_numpy(keep).to(dev),
            torch.from_numpy(kept.astype(np.int32)).to(dev))

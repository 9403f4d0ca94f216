"""The NMS kernel pair (csrc/nms_kernel.cu), its plain PyTorch version, and
the dispatch between them.

`iou_bitmask` and `greedy_reduce` take a CUDA tensor to the hand-written
kernel and a CPU tensor to the plain version; any other device raises. The
library is compiled with nvcc at first use into ``build/kernels/`` at the
repository root, under a name keyed by a hash of the source and the flags,
and loaded with ctypes. A failed build raises: there is no fallback.

`launches` counts kernel launches by name, so a run can show that it went
through the kernels. To hold a kernel against its plain version on the
card, call the `*_plain` functions directly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

__all__ = ["iou_bitmask", "greedy_reduce", "iou_bitmask_plain",
           "greedy_reduce_plain", "launches", "build_library", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "nms_kernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
WORD = 64                         # mask bits per uint64 word
PLAIN_ROW_CHUNK = 512             # rows of the plain IoU matrix per pass

launches = {"iou_bitmask": 0, "greedy_reduce": 0}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        key = hashlib.sha256(SOURCE.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"libptb_nms_{key}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            (BUILD_DIR / f"libptb_nms_{key}.log").write_text(
                proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ptb_iou_bitmask.argtypes = [vp, ci, ci, ctypes.c_float, vp, vp]
        lib.ptb_iou_bitmask.restype = ci
        lib.ptb_greedy_reduce.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp]
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
def iou_bitmask(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(B, N, 4) f32 score-sorted boxes -> (B, N, ceil(N/64)) int64 words
    (uint64 bit patterns): bit j of row i set iff j > i and IoU > thr."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"expected (B, N, 4) float32 boxes, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if _route(boxes) == "plain":
        return iou_bitmask_plain(boxes, iou_threshold)
    b, n, _ = boxes.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")
    boxes = boxes.contiguous()
    words = -(-n // WORD)
    mask = torch.empty((b, n, words), dtype=torch.int64, device=boxes.device)
    if b == 0 or n == 0:
        return mask
    lib = build_library()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    _check(lib.ptb_iou_bitmask(boxes.data_ptr(), b, n, float(iou_threshold),
                               mask.data_ptr(), stream), "iou_bitmask")
    launches["iou_bitmask"] += 1
    return mask


def iou_bitmask_plain(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain version of kernel A, on the tensor's device: the IoU of
    ops/nms.py::_pairwise_iou in the same operation order, thresholded and
    packed 64 columns to a word, PLAIN_ROW_CHUNK rows at a time."""
    b, n, _ = boxes.shape
    words = -(-n // WORD)
    dev = boxes.device
    out = torch.zeros((b, n, words), dtype=torch.int64, device=dev)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    cols = torch.arange(n, device=dev)
    shifts = torch.arange(WORD, dtype=torch.int64, device=dev)
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        r1 = min(r0 + PLAIN_ROW_CHUNK, n)
        sl = slice(r0, r1)
        ix1 = torch.maximum(x1[:, sl, None], x1[:, None, :])
        iy1 = torch.maximum(y1[:, sl, None], y1[:, None, :])
        ix2 = torch.minimum(x2[:, sl, None], x2[:, None, :])
        iy2 = torch.minimum(y2[:, sl, None], y2[:, None, :])
        inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
        union = torch.clamp(area[:, sl, None] + area[:, None, :] - inter,
                            min=1e-6)
        sup = (inter / union) > iou_threshold
        sup &= cols[None, None, :] > torch.arange(r0, r1, device=dev)[None, :, None]
        sup = torch.nn.functional.pad(sup, (0, words * WORD - n))
        # distinct powers of two: the sum is the OR, and bit 63 (the int64
        # sign) cannot overflow because the other bits sum below 2**63
        bits = sup.view(b, r1 - r0, words, WORD).to(torch.int64) << shifts
        out[:, sl] = bits.sum(-1)
    return out


# ----------------------------------------------------------------- kernel B
def greedy_reduce(mask: torch.Tensor, ok: torch.Tensor, order: torch.Tensor,
                  max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy walk of the sorted rows. mask (B, N, W) int64 from
    `iou_bitmask`; ok (B, N) bool, row i may be kept; order (B, N) int32,
    original index of sorted row i. Returns keep (B, max_out) int32 in pick
    order padded with -1, and num_kept (B,) int32."""
    b, n, words = mask.shape
    if ok.shape != (b, n) or order.shape != (b, n) or words != -(-n // WORD):
        raise ValueError(f"shape mismatch: mask {tuple(mask.shape)}, ok "
                         f"{tuple(ok.shape)}, order {tuple(order.shape)}")
    if mask.dtype != torch.int64 or ok.dtype != torch.bool \
            or order.dtype != torch.int32:
        raise ValueError("expected int64 mask, bool ok, int32 order")
    if _route(mask) == "plain":
        return greedy_reduce_plain(mask, ok, order, max_out)
    if words * 8 > 48 * 1024:
        raise ValueError(f"N={n} needs {words * 8} B of shared memory "
                         f"(limit 49152 without opt-in)")
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
                                 order.data_ptr(), b, n, int(max_out),
                                 keep.data_ptr(), num_kept.data_ptr(), stream),
           "greedy_reduce")
    launches["greedy_reduce"] += 1
    return keep, num_kept


def greedy_reduce_plain(mask: torch.Tensor, ok: torch.Tensor,
                        order: torch.Tensor, max_out: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B: the same walk in numpy on the host, one
    row at a time and vectorised over the batch."""
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

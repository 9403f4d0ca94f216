"""The multilevel RoIAlign kernel (csrc/roi_align_kernel.cu) and its launch.

`roi_align_forward` takes CUDA tensors only and launches the kernel; the
public `ops/roi_align.py::roi_align_multilevel` sends CPU tensors to the
plain PyTorch version instead. The library is compiled with nvcc at first
use (`cuda_build`) and loaded with ctypes; a failed build or launch raises.

`launches` counts kernel launches, so a run can show that it went through
the kernel. To hold the kernel against its plain version on the card, call
`ops/roi_align.py::roi_align_multilevel_plain` directly. `PATHS` names the
kernel's paths for a roi (taps staged whole or in bands of rows, read from
global memory, or an out-of-range roi); pass `path_counts` to count them.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import torch

from . import cuda_build

__all__ = ["roi_align_forward", "launches", "build_library", "SOURCE",
           "MAX_LEVELS", "PATHS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "roi_align_kernel.cu"
MAX_LEVELS = 8                    # kMaxLevels in the source
PATHS = ("whole", "bands", "global", "invalid")   # enum Path in the source

launches = {"roi_align": 0}

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
        lib.ptb_roi_align.argtypes = [
            ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(ci),
            ctypes.POINTER(ctypes.c_float), ci, ci, ci, vp, vp, ci, ci, ci, ci,
            vp, vp, vp]
        lib.ptb_roi_align.restype = ci
        _lib = lib
        return lib


def roi_align_forward(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      lvls: torch.Tensor, strides: Sequence[int],
                      output_size: int = 7, sampling_ratio: int = 2,
                      aligned: bool = True,
                      path_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel. feats: per-level (B, C, H_l, W_l) f32 on one CUDA
    device (channels-last in memory avoids a copy); rois (R, 5) f32; lvls
    (R,) integer level of each roi. Returns (R, C, S, S) f32; a roi whose
    batch index or level is out of range gets NaN (the kernel reads no
    memory outside the maps; checking on the host would wait for the
    card). `path_counts`, a (len(PATHS),) int32 tensor on the same device,
    gets one added per roi at the path the kernel took for it."""
    dev = rois.device
    if dev.type != "cuda":
        raise RuntimeError(f"the RoIAlign kernel takes CUDA tensors, got {dev}")
    n = len(feats)
    if not 1 <= n <= MAX_LEVELS or len(strides) != n:
        raise ValueError(f"{n} levels and {len(strides)} strides "
                         f"(1 to {MAX_LEVELS} levels)")
    b, c = feats[0].shape[:2]
    for f in feats:
        if f.dim() != 4 or tuple(f.shape[:2]) != (b, c) \
                or f.dtype != torch.float32 or f.device != dev:
            raise ValueError(f"level maps must be (B={b}, C={c}, H, W) "
                             f"float32 on {dev}, got {tuple(f.shape)} "
                             f"{f.dtype} on {f.device}")
    r = rois.shape[0]
    if rois.dim() != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32:
        raise ValueError(f"expected (R, 5) float32 rois, got "
                         f"{tuple(rois.shape)} {rois.dtype}")
    if tuple(lvls.shape) != (r,) or lvls.device != dev:
        raise ValueError(f"expected ({r},) levels on {dev}, got "
                         f"{tuple(lvls.shape)} on {lvls.device}")
    if output_size < 1 or sampling_ratio < 1:
        raise ValueError(f"output_size {output_size}, sampling_ratio "
                         f"{sampling_ratio}: both must be >= 1")
    if path_counts is not None and (
            path_counts.shape != (len(PATHS),) or path_counts.device != dev
            or path_counts.dtype != torch.int32):
        raise ValueError(f"path_counts must be ({len(PATHS)},) int32 on {dev}")
    out = torch.empty((r, c, output_size, output_size), dtype=torch.float32,
                      device=dev)
    if r == 0:
        return out
    # (B, H, W, C) memory; no copy when the map is channels-last already
    maps = [f.permute(0, 2, 3, 1).contiguous() for f in feats]
    rois = rois.contiguous()
    lvls = lvls.to(torch.int32).contiguous()
    lib = build_library()
    err = lib.ptb_roi_align(
        (ctypes.c_void_p * n)(*[m.data_ptr() for m in maps]),
        (ctypes.c_int * n)(*[f.shape[2] for f in feats]),
        (ctypes.c_int * n)(*[f.shape[3] for f in feats]),
        (ctypes.c_float * n)(*[float(s) for s in strides]),
        n, b, c, rois.data_ptr(), lvls.data_ptr(), r, int(output_size),
        int(sampling_ratio), int(bool(aligned)), out.data_ptr(),
        None if path_counts is None else path_counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align launch failed: cudaError {err}")
    launches["roi_align"] += 1
    return out

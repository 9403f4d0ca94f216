"""The multilevel RoIAlign kernels (csrc/roi_align_kernel.cu): the forward,
the backward for the level maps, the backward for the roi coordinates, and
their launches.

`roi_align_forward`, `roi_align_backward` and `roi_align_rois_backward`
take CUDA tensors only and launch the kernels; the public
`ops/roi_align.py::roi_align_multilevel` sends CPU tensors to the plain
PyTorch version instead, and wraps the launches in an autograd function
for CUDA tensors. The library is compiled
with nvcc at first use (`cuda_build`) and loaded with ctypes; a failed
build or launch raises.

`launches` counts kernel launches by name, so a run can show that it went
through the kernels. To hold a kernel against its plain version on the
card, call `ops/roi_align.py::roi_align_multilevel_plain`,
`roi_align_backward_plain` or `roi_align_rois_backward_plain` directly. `PATHS` names the kernels' paths for
a roi; pass `path_counts` to either launch to count them. The forward's:
taps staged whole or in bands of rows, read from global memory, or an
out-of-range roi. The backward's: the upstream gradient staged ("whole"),
read from global memory (when two copies of a 32-channel chunk and the
tables do not fit the block's shared memory: from S = 21 at sr = 1), or an
out-of-range roi; it has no bands.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence, Tuple

import torch

from . import cuda_build

__all__ = ["roi_align_forward", "roi_align_backward",
           "roi_align_rois_backward", "launches",
           "build_library", "SOURCE", "MAX_LEVELS", "PATHS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "roi_align_kernel.cu"
MAX_LEVELS = 8                    # kMaxLevels in the source
PATHS = ("whole", "bands", "global", "invalid")   # enum Path in the source

launches = {"roi_align": 0, "roi_align_backward": 0,
            "roi_align_rois_backward": 0}

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
        lib.ptb_roi_align_backward.argtypes = [
            vp, ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(ci),
            ctypes.POINTER(ctypes.c_float), ci, ci, ci, vp, vp, ci, ci, ci, ci,
            vp, vp]
        lib.ptb_roi_align_backward.restype = ci
        lib.ptb_roi_align_rois_backward.argtypes = [
            vp, ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(ci),
            ctypes.POINTER(ctypes.c_float), ci, ci, ci, vp, vp, ci, ci, ci, ci,
            vp, vp]
        lib.ptb_roi_align_rois_backward.restype = ci
        _lib = lib
        return lib


def _check_args(dev: torch.device, n: int, strides: Sequence[int],
                rois: torch.Tensor, lvls: torch.Tensor, output_size: int,
                sampling_ratio: int) -> None:
    if dev.type != "cuda":
        raise RuntimeError(f"the RoIAlign kernel takes CUDA tensors, got {dev}")
    if not 1 <= n <= MAX_LEVELS or len(strides) != n:
        raise ValueError(f"{n} levels and {len(strides)} strides "
                         f"(1 to {MAX_LEVELS} levels)")
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


def _check_counts(dev: torch.device,
                  path_counts: torch.Tensor | None) -> None:
    if path_counts is not None and (
            path_counts.shape != (len(PATHS),) or path_counts.device != dev
            or path_counts.dtype != torch.int32):
        raise ValueError(f"path_counts must be ({len(PATHS)},) int32 on {dev}")


def _check_maps(feats: Sequence[torch.Tensor], dev: torch.device) -> None:
    b, c = feats[0].shape[:2]
    for f in feats:
        if f.dim() != 4 or tuple(f.shape[:2]) != (b, c) \
                or f.dtype != torch.float32 or f.device != dev:
            raise ValueError(f"level maps must be (B={b}, C={c}, H, W) "
                             f"float32 on {dev}, got {tuple(f.shape)} "
                             f"{f.dtype} on {f.device}")


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
    _check_args(dev, len(feats), strides, rois, lvls, output_size,
                sampling_ratio)
    _check_maps(feats, dev)
    b, c = feats[0].shape[:2]
    r = rois.shape[0]
    _check_counts(dev, path_counts)
    out = torch.empty((r, c, output_size, output_size), dtype=torch.float32,
                      device=dev)
    if r == 0:
        return out
    # (B, H, W, C) memory; no copy when the map is channels-last already
    maps = [f.permute(0, 2, 3, 1).contiguous() for f in feats]
    rois = rois.contiguous()
    lvls = lvls.to(torch.int32).contiguous()
    lib = build_library()
    n = len(feats)
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


def roi_align_backward(grad_out: torch.Tensor, rois: torch.Tensor,
                       lvls: torch.Tensor,
                       shapes: Sequence[Tuple[int, int, int, int]],
                       channels_last: Sequence[bool],
                       strides: Sequence[int], output_size: int = 7,
                       sampling_ratio: int = 2, aligned: bool = True,
                       path_counts: torch.Tensor | None = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel: the gradient of `roi_align_forward` with
    respect to its level maps. grad_out (R, C, S, S) f32 on a CUDA device
    (any strides: it is made contiguous); rois, lvls as the forward took
    them; `shapes` the (B, C, H_l, W_l) of each level map. Returns one
    (B, C, H_l, W_l) f32 gradient per level, all views of one zeroed
    channels-last buffer: a level whose `channels_last` entry is False gets
    an NCHW-contiguous copy instead, the layout of its map. R = 0 gives
    zeros and launches nothing; a roi the forward gave NaN (batch index or
    level out of range) adds nothing. `path_counts` as for the forward."""
    dev = rois.device
    _check_args(dev, len(shapes), strides, rois, lvls, output_size,
                sampling_ratio)
    b, c = shapes[0][:2]
    r = rois.shape[0]
    if tuple(grad_out.shape) != (r, c, output_size, output_size) \
            or grad_out.dtype != torch.float32 or grad_out.device != dev:
        raise ValueError(f"expected ({r}, {c}, {output_size}, {output_size}) "
                         f"float32 grad_out on {dev}, got "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} on "
                         f"{grad_out.device}")
    if any(tuple(s[:2]) != (b, c) for s in shapes) \
            or len(channels_last) != len(shapes):
        raise ValueError(f"level shapes {shapes} must share (B={b}, C={c}), "
                         f"one channels_last flag each")
    _check_counts(dev, path_counts)
    sizes = [b * h * w * c for _, _, h, w in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    grads, start = [], 0
    for (_, _, h, w), size in zip(shapes, sizes):
        grads.append(flat[start:start + size].view(b, h, w, c))
        start += size
    if r:
        n = len(shapes)
        grad_out = grad_out.contiguous()
        rois = rois.contiguous()
        lvls = lvls.to(torch.int32).contiguous()
        lib = build_library()
        err = lib.ptb_roi_align_backward(
            grad_out.data_ptr(),
            (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads]),
            (ctypes.c_int * n)(*[s[2] for s in shapes]),
            (ctypes.c_int * n)(*[s[3] for s in shapes]),
            (ctypes.c_float * n)(*[float(s) for s in strides]),
            n, b, c, rois.data_ptr(), lvls.data_ptr(), r, int(output_size),
            int(sampling_ratio), int(bool(aligned)),
            None if path_counts is None else path_counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"roi_align_backward launch failed: "
                               f"cudaError {err}")
        launches["roi_align_backward"] += 1
    return tuple(g.permute(0, 3, 1, 2) if cl
                 else g.permute(0, 3, 1, 2).contiguous()
                 for g, cl in zip(grads, channels_last))


def roi_align_rois_backward(grad_out: torch.Tensor,
                            feats: Sequence[torch.Tensor], rois: torch.Tensor,
                            lvls: torch.Tensor, strides: Sequence[int],
                            output_size: int = 7, sampling_ratio: int = 2,
                            aligned: bool = True) -> torch.Tensor:
    """Launch the roi-coordinate kernel: the gradient of
    `roi_align_forward` with respect to the rois' x1, y1, x2, y2, as JAX's
    autodiff of its XLA RoIAlign gives it (the clamps' 0.5 at a bound, no
    gradient from samples outside the map). grad_out (R, C, S, S) f32
    (made contiguous); feats, rois and lvls as the forward took them.
    Returns (R, 4) f32; a roi whose batch index or level is out of range
    gets zeros. Each row is summed in one block in a fixed order (no
    atomics), so a launch repeats bit for bit."""
    dev = rois.device
    _check_args(dev, len(feats), strides, rois, lvls, output_size,
                sampling_ratio)
    _check_maps(feats, dev)
    b, c = feats[0].shape[:2]
    r = rois.shape[0]
    if tuple(grad_out.shape) != (r, c, output_size, output_size) \
            or grad_out.dtype != torch.float32 or grad_out.device != dev:
        raise ValueError(f"expected ({r}, {c}, {output_size}, {output_size}) "
                         f"float32 grad_out on {dev}, got "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} on "
                         f"{grad_out.device}")
    out = torch.empty((r, 4), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    maps = [f.permute(0, 2, 3, 1).contiguous() for f in feats]
    grad_out = grad_out.contiguous()
    rois = rois.detach().contiguous()
    lvls = lvls.to(torch.int32).contiguous()
    lib = build_library()
    n = len(feats)
    err = lib.ptb_roi_align_rois_backward(
        grad_out.data_ptr(),
        (ctypes.c_void_p * n)(*[m.data_ptr() for m in maps]),
        (ctypes.c_int * n)(*[f.shape[2] for f in feats]),
        (ctypes.c_int * n)(*[f.shape[3] for f in feats]),
        (ctypes.c_float * n)(*[float(s) for s in strides]),
        n, b, c, rois.data_ptr(), lvls.data_ptr(), r, int(output_size),
        int(sampling_ratio), int(bool(aligned)), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align_rois_backward launch failed: "
                           f"cudaError {err}")
    launches["roi_align_rois_backward"] += 1
    return out

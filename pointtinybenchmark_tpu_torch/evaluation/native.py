"""ctypes binding of the native evaluation loops (csrc/cocoeval_kernel.cpp).

Counterpart of pointtinybenchmark_tpu/evaluation/native.py: the greedy
det-to-gt matching of one evaluation cell at every IoU threshold, and the
mask IoU on run-length lists. The source is built with g++ at first use
into ``build/kernels/`` at the repository root, named by a hash of the
source and the flags, beside the CUDA kernels. A failed build raises:
there is no fallback (the Python loops of `cocoeval.py` are the reference
a caller asks for by name, `COCOExpandEval(native=False)`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["SOURCE", "get_lib", "greedy_match_native", "rle_iou_native"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "cocoeval_kernel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lib = None


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libptb_{SOURCE.stem}_{key}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp),
         str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) for "
                           f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        c_d = ctypes.POINTER(ctypes.c_double)
        c_u8 = ctypes.POINTER(ctypes.c_uint8)
        c_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.greedy_match.argtypes = [c_d, ctypes.c_int64, ctypes.c_int64,
                                     c_u8, c_u8, c_d, c_d, ctypes.c_int64,
                                     ctypes.c_int, c_i64, c_i64, c_u8]
        lib.rle_iou_matrix.argtypes = [c_i64, c_i64, ctypes.c_int64,
                                       c_i64, c_i64, ctypes.c_int64,
                                       c_u8, c_d]
        lib.greedy_match.restype = lib.rle_iou_matrix.restype = None
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def greedy_match_native(ious: np.ndarray, gt_ignore: np.ndarray,
                        crowd_like: np.ndarray, thrs: np.ndarray,
                        iod_thrs: np.ndarray, use_iod: bool
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ious (D, G) with the gts sorted ignored-last and the dets by score
    -> dtm (T, D) matched gt index + 1, gtm (T, G) matched det index + 1
    (0: none), dt_ig (T, D) uint8."""
    lib = get_lib()
    n_det, n_gt = ious.shape
    t = len(thrs)
    iou_c = np.ascontiguousarray(ious, np.float64)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    cl = np.ascontiguousarray(crowd_like, np.uint8)
    th = np.ascontiguousarray(thrs, np.float64)
    ith = np.ascontiguousarray(iod_thrs, np.float64)
    dtm = np.zeros((t, n_det), np.int64)
    gtm = np.zeros((t, n_gt), np.int64)
    dig = np.zeros((t, n_det), np.uint8)
    lib.greedy_match(_ptr(iou_c, ctypes.c_double), n_det, n_gt,
                     _ptr(gi, ctypes.c_uint8), _ptr(cl, ctypes.c_uint8),
                     _ptr(th, ctypes.c_double), _ptr(ith, ctypes.c_double),
                     t, int(use_iod),
                     _ptr(dtm, ctypes.c_int64), _ptr(gtm, ctypes.c_int64),
                     _ptr(dig, ctypes.c_uint8))
    return dtm, gtm, dig


def rle_iou_native(dt_counts: List[Sequence[int]],
                   gt_counts: List[Sequence[int]],
                   iscrowd: Sequence[int]) -> np.ndarray:
    """Mask IoU straight on the uncompressed run lists (pycocotools rleIou:
    a two-pointer merge per pair, no bitmaps); crowd columns over the
    det's area."""
    lib = get_lib()
    d_offs = np.zeros(len(dt_counts) + 1, np.int64)
    g_offs = np.zeros(len(gt_counts) + 1, np.int64)
    d_offs[1:] = np.cumsum([len(c) for c in dt_counts])
    g_offs[1:] = np.cumsum([len(c) for c in gt_counts])
    d_cnts = np.ascontiguousarray(np.concatenate(
        [np.asarray(c, np.int64) for c in dt_counts]))
    g_cnts = np.ascontiguousarray(np.concatenate(
        [np.asarray(c, np.int64) for c in gt_counts]))
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    out = np.zeros((len(dt_counts), len(gt_counts)), np.float64)
    lib.rle_iou_matrix(_ptr(d_cnts, ctypes.c_int64),
                       _ptr(d_offs, ctypes.c_int64), len(dt_counts),
                       _ptr(g_cnts, ctypes.c_int64),
                       _ptr(g_offs, ctypes.c_int64), len(gt_counts),
                       _ptr(crowd, ctypes.c_uint8),
                       _ptr(out, ctypes.c_double))
    return out

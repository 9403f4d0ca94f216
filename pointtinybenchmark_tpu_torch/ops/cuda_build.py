"""Build the hand-written CUDA kernels (csrc/*.cu) and load them with ctypes.

Each source compiles with nvcc for sm_90a into a shared library with a
plain C interface, under ``build/kernels/`` at the repository root, named
by a hash of the source and the flags: an edited source gets a new library
and an unchanged one is built once. `compile_sources` starts one nvcc per
missing library, all at once, and waits for all of them; `load` builds one
source if needed and opens it. A failed build raises: there is no fallback.
The compiler's report (`-Xptxas -v`: registers, shared memory, spills) is
kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterable

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "compile_sources", "library_path",
           "load"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    """build/kernels/libptb_<stem>_<hash of source + flags>.so"""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libptb_{source.stem}_{key}.so"


def compile_sources(sources: Iterable[Path]) -> None:
    """Compile every source whose library is missing, in parallel."""
    jobs = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(source)]
        jobs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {so.name}:\n"
                          f"{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    compile_sources([source])
    return ctypes.CDLL(str(library_path(source)))

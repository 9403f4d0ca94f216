"""Checkpoint save and load (mmcv CheckpointHook, resume_from / load_from).

Counterpart of pointtinybenchmark_tpu/engine/checkpoint.py for the port's
own checkpoints: one `torch.save` file holding the model's state_dict, the
optimizer's state (momentum traces and update count), the train state
(step, nan_seen) and a meta dict (epoch, iter), plus a `latest.pth`
pointer beside it, like mmcv's latest.pth link.

`load_jax_checkpoint` reads the JAX package's `.ckpt` files
(engine/checkpoint.py::save_checkpoint there: flax's msgpack serialization
of {"state": ..., "meta": ...}) with a reader of its own for the part of
msgpack that flax writes: nil, bools, integers, float32/64, strings, bytes,
arrays (as lists) and maps, and flax's extension types 1 (an ndarray
packed as its shape, dtype name and C-order bytes) and 3 (a numpy scalar,
packed the same way). The leaves come back as flax's `msgpack_restore`
gives them: numpy arrays and scalars, Python values. Anything else raises:
complex numbers and arrays, dtypes outside numpy's bool, integer and float
kinds (bfloat16), the chunked form in which flax stores an array above
2**30 bytes, orbax checkpoint directories.
"""
from __future__ import annotations

import os
import os.path as osp
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_jax_checkpoint",
           "msgpack_restore", "is_jax_checkpoint"]

LATEST = "latest.pth"


def save_checkpoint(path: str, model: torch.nn.Module, optimizer,
                    state: Dict[str, torch.Tensor],
                    meta: Optional[dict] = None) -> None:
    """Write `path` and point `latest.pth` in its directory at it. `state`
    is the train state of `engine/train.py` (0-d tensors)."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    torch.save({"state_dict": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "state": {k: v.detach().cpu() for k, v in state.items()},
                "meta": dict(meta or {})}, path)
    latest = osp.join(osp.dirname(osp.abspath(path)), LATEST)
    if osp.islink(latest) or osp.exists(latest):
        os.remove(latest)
    os.symlink(osp.basename(path), latest)


def load_checkpoint(path: str,
                    map_location: Optional[torch.device] = None
                    ) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote (tensors and plain values only)."""
    return torch.load(path, map_location=map_location, weights_only=True)


# msgpack's fixed-size formats: first byte -> (struct format, size)
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8),
            0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# first byte -> size of the length field of bin, str, array, map and ext
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack of (shape, dtype name, bytes)."""
    shape, name, buf = msgpack_restore(data)
    name = name.decode() if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    # bool, integers and floats: numpy's own kinds (an extension type such
    # as ml_dtypes' bfloat16 has kind "V")
    if dtype is None or dtype.kind not in "biuf":
        raise ValueError(f"array dtype {name!r} is not supported")
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        raise ValueError("complex numbers are not supported")
    raise ValueError(f"msgpack extension type {code} is not supported")


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    """The msgpack object at `pos` and the position after it."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    elif b in _SCALARS:
        fmt, size = _SCALARS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    elif b in _FIXEXT:
        kind, n = "ext", _FIXEXT[b]
    elif b in _SIZED:
        kind, size = _SIZED[b]
        n = int.from_bytes(buf[pos:pos + size], "big")
        pos += size
    else:
        raise ValueError(f"msgpack byte 0x{b:02x} at {pos - 1} is not "
                         f"supported")
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    if kind == "map":
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked arrays (flax's form for arrays above "
                             "2**30 bytes) are not supported")
        return out, pos
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        data = bytes(buf[pos + 1:pos + 1 + n])
        return _ext(code, data), pos + 1 + n
    data = bytes(buf[pos:pos + n])
    return (data.decode() if kind == "str" else data), pos + n


def msgpack_restore(data: bytes) -> Any:
    """The object that flax.serialization.msgpack_restore decodes from
    `data`, for the subset of msgpack flax writes (see the module note)."""
    out, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the msgpack object")
    return out


def is_jax_checkpoint(path: str) -> bool:
    """Whether `path` names a JAX package checkpoint (`.ckpt`)."""
    return str(path).endswith(".ckpt")


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX package `.ckpt` file: {"state": ..., "meta": ...} with numpy
    leaves (the state holds params, batch_stats, opt_state and step)."""
    if osp.isdir(path):
        raise ValueError(f"{path} is a directory: orbax checkpoints are not "
                         f"read")
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    if not isinstance(raw, dict) or "state" not in raw:
        raise ValueError(f"{path} holds no JAX train state")
    return {"state": raw["state"], "meta": raw.get("meta", {})}

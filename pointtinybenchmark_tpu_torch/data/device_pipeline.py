"""On-device test-time preprocessing: uint8 frames -> normalized, padded,
tiled float32 batches.

Counterpart of pointtinybenchmark_tpu/data/device_pipeline.py::
DevicePreprocessor, bit-exact with it and with the host pipeline: the frame
is cast to f32, then `(x - mean) * inv_std` with `inv_std` the f32
reciprocal computed in numpy (host Normalize order), then padded at the
bottom/right with `pad_val` in normalized space, then cut by static slices
on the clamped tile grid. The output is NHWC, image-major: frame i's tiles
are rows [i*V, (i+1)*V).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .tiling import tile_grid

__all__ = ["DevicePreprocessor"]


class DevicePreprocessor:
    """Args:
        frame_hw: (H, W) of the decoded input frames.
        mean / std: per-channel normalization.
        tile_hw: (tile_h, tile_w); the output is (N * n_views, tile_h,
            tile_w, 3) and `tile_offsets` holds each tile's (x, y) shift.
        tile_overlap: (overlap_w, overlap_h) of the grid.
        pad_val: fill value, in normalized space.
        device: where the work runs.
    """

    def __init__(self, frame_hw: Tuple[int, int],
                 mean: Sequence[float], std: Sequence[float],
                 tile_hw: Tuple[int, int],
                 tile_overlap: Tuple[int, int] = (0, 0),
                 pad_val: float = 0.0, *,
                 device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.frame_hw = (int(frame_hw[0]), int(frame_hw[1]))
        self._mean = torch.from_numpy(
            np.asarray(mean, np.float32)).to(self.device)
        self._inv_std = torch.from_numpy(
            (1.0 / np.asarray(std, np.float32)).astype(np.float32)
        ).to(self.device)
        self._pad_val = float(pad_val)
        h, w = self.frame_hw
        th, tw = int(tile_hw[0]), int(tile_hw[1])
        self.rects = tile_grid(w, h, tw, th, int(tile_overlap[0]),
                               int(tile_overlap[1]))
        self.tile_hw = (th, tw)
        self.tile_offsets = np.asarray(
            [(l, u) for (l, u, _, _) in self.rects], np.float32)
        self._pad_to = (max(h, th), max(w, tw))

    @property
    def n_views(self) -> int:
        return len(self.rects)

    def __call__(self, frames) -> torch.Tensor:
        """frames: (N, H, W, 3) or (H, W, 3), uint8 (or castable to f32),
        as a numpy array or a tensor. Returns the normalized f32 batch."""
        h, w = self.frame_hw
        x = torch.as_tensor(frames).to(self.device)
        if tuple(x.shape[-3:]) != (h, w, 3):
            raise ValueError(f"expected (..., {h}, {w}, 3) frames, got "
                             f"{tuple(x.shape)}")
        x = x.reshape(-1, h, w, 3).to(torch.float32)
        x = (x - self._mean) * self._inv_std
        ph, pw = self._pad_to
        if (ph, pw) != (h, w):
            x = F.pad(x, (0, 0, 0, pw - w, 0, ph - h), value=self._pad_val)
        th, tw = self.tile_hw
        x = torch.stack([x[:, u:u + th, l:l + tw]
                         for (l, u, _, _) in self.rects], dim=1)
        return x.reshape(-1, th, tw, 3)

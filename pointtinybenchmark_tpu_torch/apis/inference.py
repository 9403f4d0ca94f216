"""Inference API: build a detector from a config, run the tiled protocol.

Counterpart of pointtinybenchmark_tpu/apis/inference.py (`init_detector`,
`inference_detector_tiled`). Frames of one shape that arrive in one call go
through the engine together, as one batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..engine.checkpoint import is_jax_checkpoint, load_jax_checkpoint
from ..engine.test import DeviceTiledInference
from ..models.builder import build_detector
from ..utils.config import Config
from ..utils.jax_weights import load_jax_variables

__all__ = ["init_detector", "inference_detector_tiled", "DetectorHandle"]


class DetectorHandle:
    """A built model with its config, and the tiled engines built for it
    (one per frame shape and tile setting)."""

    def __init__(self, model, cfg):
        self.model = model
        self.cfg = cfg
        self.tiled_engines: Dict[tuple, DeviceTiledInference] = {}


def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  *, device: Union[str, torch.device] = "cuda",
                  seed: int = 0) -> DetectorHandle:
    """Build the config's detector on `device`, the card unless the caller
    asks for the CPU. Weights are drawn from `seed`, or loaded from
    `checkpoint`: a JAX package `.ckpt` (its params and batch_stats, as
    the JAX `init_detector` takes them), or else a `state_dict` of this
    package's model saved with `torch.save`."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_detector(dict(config.model),
                           config.get("train_cfg")
                           or config.model.get("train_cfg"),
                           config.get("test_cfg")
                           or config.model.get("test_cfg"),
                           device=device, seed=seed)
    if checkpoint is not None and is_jax_checkpoint(checkpoint):
        state = load_jax_checkpoint(checkpoint)["state"]
        load_jax_variables(model, state["params"], state.get("batch_stats"))
    elif checkpoint is not None:
        sd = torch.load(checkpoint, map_location=device, weights_only=True)
        model.load_state_dict(sd.get("state_dict", sd))
    return DetectorHandle(model, config)


def _protocol_settings(cfg, tile_hw, tile_overlap):
    norm = None
    for t in cfg.data["test"]["pipeline"]:
        if t["type"] == "CroppedTilesFlipAug":
            if tile_hw is None:
                tw, th = t["tile_shape"]                 # reference (w, h)
                tile_hw = (int(th), int(tw))
            if tile_overlap is None:
                tile_overlap = tuple(t.get("tile_overlap", (100, 100)))
            for s in t["transforms"]:
                if s["type"] == "Normalize":
                    norm = dict(mean=s["mean"], std=s["std"])
    return tile_hw or (512, 640), tile_overlap or (100, 100), norm


def inference_detector_tiled(handle: DetectorHandle,
                             imgs: Union[np.ndarray, str, List],
                             tile_hw=None, tile_overlap=None
                             ) -> Union[dict, List[dict]]:
    """Tiled protocol inference on uint8 RGB frames (or image paths). Tile
    shape, overlap and normalization default to the config's test pipeline
    (CroppedTilesFlipAug + Normalize). Returns one dict per frame, bboxes
    (n, 5) in frame coordinates and labels (n,); a single frame in gives a
    single dict out."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    tile_hw, tile_overlap, norm = _protocol_settings(handle.cfg, tile_hw,
                                                     tile_overlap)
    frames = []
    for img in imgs:
        if isinstance(img, str):
            from PIL import Image
            img = np.asarray(Image.open(img).convert("RGB"))
        frames.append(np.asarray(img))
    results: List[Optional[dict]] = [None] * len(frames)
    by_shape: Dict[Tuple[int, int], List[int]] = {}
    for i, f in enumerate(frames):
        by_shape.setdefault(tuple(f.shape[:2]), []).append(i)
    for hw, idx in by_shape.items():
        key = (hw, tuple(tile_hw), tuple(tile_overlap))
        eng = handle.tiled_engines.get(key)
        if eng is None:
            eng = handle.tiled_engines[key] = DeviceTiledInference(
                handle.model, hw, tile_hw, tile_overlap, img_norm=norm)
        out = eng(np.stack([frames[i] for i in idx]))
        for i, r in zip(idx, out):
            results[i] = r
    return results[0] if single else results

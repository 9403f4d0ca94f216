"""Inference API: build a detector from a config, run it on images whole
or by the tiled protocol, draw the detections.

Counterpart of pointtinybenchmark_tpu/apis/inference.py (`init_detector`,
`inference_detector`, `async_inference_detector`,
`inference_detector_tiled`, `show_result`). `inference_detector` runs the
config's test pipeline flattened to one view (the test-time wrappers
unwrapped, LoadImageFromFile and ImageToTensor dropped) on each image and
one `simple_test` per image, boxes in the image's own frame. In the tiled
protocol, frames of one shape that arrive in one call go through the
engine together, as one batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.post_processing import DetResult
from ..data.loader import DetCollator
from ..data.transforms import Compose
from ..engine.checkpoint import is_jax_checkpoint, load_jax_checkpoint
from ..engine.test import DeviceTiledInference
from ..models.builder import build_detector
from ..utils.config import Config
from ..utils.jax_weights import load_jax_variables

__all__ = ["init_detector", "inference_detector", "async_inference_detector",
           "inference_detector_tiled", "show_result", "DetectorHandle"]

WRAPPERS = ("CroppedTilesFlipAug", "MultiScaleFlipAug", "NoAug")


def single_view_pipeline(cfg) -> Compose:
    """The config's test pipeline as one view (JAX init_detector): the
    test-time wrappers' transforms in their place, LoadImageFromFile and
    ImageToTensor dropped."""
    flat = []
    for t in cfg.data["test"]["pipeline"]:
        t = dict(t)
        if t["type"] in WRAPPERS:
            flat.extend(dict(x) for x in t["transforms"])
        elif t["type"] != "LoadImageFromFile":
            flat.append(t)
    return Compose([t for t in flat if t["type"] != "ImageToTensor"])


class DetectorHandle:
    """A built model with its config, its single-view test pipeline (built
    at first use) and the tiled engines built for it (one per frame shape
    and tile setting)."""

    def __init__(self, model, cfg):
        self.model = model
        self.cfg = cfg
        self.tiled_engines: Dict[tuple, DeviceTiledInference] = {}
        self._pipeline: Optional[Compose] = None

    @property
    def pipeline(self) -> Compose:
        if self._pipeline is None:
            self._pipeline = single_view_pipeline(self.cfg)
        return self._pipeline


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


@torch.no_grad()
def inference_detector(handle: DetectorHandle,
                       imgs: Union[np.ndarray, str, List]
                       ) -> Union[dict, List[dict]]:
    """Detect on whole images: (H, W, 3) RGB arrays or image paths, one or
    a list. Each goes through the single-view pipeline (a sample with
    `_rng` = RandomState(0), as in JAX), is collated alone (DetCollator
    of the `loader` config, max_gt 1) and run through `simple_test` with
    the boxes rescaled to the image. Returns per image the valid
    detections: bboxes (n, 5) and labels (n,); a single image in gives a
    single dict out."""
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    loader_cfg = dict(handle.cfg.get("loader", {}) or {})
    collator = DetCollator(
        pad_shape=(tuple(loader_cfg["pad_shape"])
                   if loader_cfg.get("pad_shape") else None),
        size_divisor=int(loader_cfg.get("size_divisor", 32)), max_gt=1)
    model = handle.model.eval()
    device = next(model.parameters()).device
    results = []
    for img in imgs:
        if isinstance(img, str):
            from PIL import Image
            img = np.asarray(Image.open(img).convert("RGB"), np.float32)
        sample = dict(img=img.astype(np.float32), img_shape=img.shape,
                      ori_shape=img.shape, bbox_fields=[], scale=None,
                      _rng=np.random.RandomState(0))
        batch = collator([handle.pipeline(sample)])
        dets = model.simple_test(
            torch.from_numpy(batch["img"]).to(device),
            torch.from_numpy(batch["img_shape"]).to(device),
            torch.from_numpy(batch["scale_factor"]).to(device), True)
        if not isinstance(dets, DetResult):       # (detections, masks)
            dets = dets[0]
        keep = dets.valid[0].cpu().numpy()
        results.append(dict(bboxes=dets.bboxes[0].cpu().numpy()[keep],
                            labels=dets.labels[0].cpu().numpy()[keep]))
    return results[0] if single else results


async def async_inference_detector(handle: DetectorHandle, img):
    """mmdet's awaitable interface (apis/inference.py:212): the card's
    launches are already asynchronous to the host, so this is
    `inference_detector`, as in the JAX package."""
    return inference_detector(handle, img)


def show_result(img: np.ndarray, result: dict, classes=None,
                score_thr: float = 0.3, out_file: Optional[str] = None
                ) -> np.ndarray:
    """Draw one image's detections (visualization.py::imshow_det_bboxes):
    the image with the boxes and their class and score labels, saved to
    `out_file` if given."""
    from ..visualization import imshow_det_bboxes
    return imshow_det_bboxes(img, result["bboxes"], result["labels"],
                             class_names=classes, score_thr=score_thr,
                             out_file=out_file)


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

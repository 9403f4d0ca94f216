"""Build ported models from mmdet-style config dicts.

Counterpart of pointtinybenchmark_tpu/models/builder.py for the ported
types only. A dict maps each `type` to its class. As in the JAX builder,
config keys a class does not take (training-only switches such as
`frozen_stages`, `loss_bbox`, `style`) are dropped, so configs translate
unchanged.
"""
from __future__ import annotations

import inspect
import logging
from typing import Optional, Union

import torch
from torch import nn

from .backbones.resnet import ResNet
from .dense_heads.anchor_head import AnchorHead
from .dense_heads.retina_head import RetinaHead
from .detectors.single_stage import SingleStageDetector
from .necks.fpn import FPN

logger = logging.getLogger("ptb_torch")

__all__ = ["build_detector", "build_module", "MODULES"]

MODULES = {
    "ResNet": ResNet,
    "FPN": FPN,
    "AnchorHead": AnchorHead,
    "RetinaHead": RetinaHead,
}


def build_module(cfg: dict) -> nn.Module:
    args = dict(cfg)
    kind = args.pop("type")
    if kind not in MODULES:
        raise KeyError(f"{kind} is not ported: {sorted(MODULES)}")
    cls = MODULES[kind]
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
    dropped = sorted(set(args) - accepted)
    if dropped:
        logger.debug("build_module(%s): dropping config keys %s", kind, dropped)
    return cls(**{k: v for k, v in args.items() if k in accepted})


def build_detector(cfg: dict, train_cfg: Optional[dict] = None,
                   test_cfg: Optional[dict] = None, *,
                   device: Union[str, torch.device],
                   seed: int = 0) -> SingleStageDetector:
    """Build a detector with seeded random weights, in eval mode, on
    `device`. Weights are drawn on the CPU from `torch.Generator` seeded
    with `seed`, so a seed gives the same weights on every device."""
    del train_cfg  # inference only
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in ("SingleStageDetector", "RetinaNet"):
        raise KeyError(f"detector {kind} is not ported")
    head_cfg = dict(cfg["bbox_head"])
    head_cfg.setdefault("test_cfg", cfg.get("test_cfg") or test_cfg)
    model = SingleStageDetector(
        backbone=build_module(cfg["backbone"]),
        neck=build_module(cfg["neck"]) if cfg.get("neck") else None,
        bbox_head=build_module(head_cfg))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

"""Checkpoint save and load (mmcv CheckpointHook, resume_from / load_from).

Counterpart of pointtinybenchmark_tpu/engine/checkpoint.py for the port's
own checkpoints: one `torch.save` file holding the model's state_dict, the
optimizer's state (momentum traces and update count), the train state
(step, nan_seen) and a meta dict (epoch, iter), plus a `latest.pth`
pointer beside it, like mmcv's latest.pth link. Reading the JAX package's
msgpack `.ckpt` files is not ported.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

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

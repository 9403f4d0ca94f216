"""Losses of the ported heads (mmdet names and config keys)."""
from .cross_entropy_loss import CrossEntropyLoss
from .focal_loss import FocalLoss
from .smooth_l1_loss import L1Loss, SmoothL1Loss
from .utils import weight_reduce_loss

__all__ = ["CrossEntropyLoss", "FocalLoss", "L1Loss", "SmoothL1Loss",
           "build_loss", "weight_reduce_loss"]

LOSSES = {"CrossEntropyLoss": CrossEntropyLoss, "FocalLoss": FocalLoss,
          "L1Loss": L1Loss, "SmoothL1Loss": SmoothL1Loss}


def build_loss(cfg: dict):
    """A loss from its config dict (`type` and the class's arguments)."""
    args = dict(cfg)
    kind = args.pop("type")
    if kind not in LOSSES:
        raise KeyError(f"loss {kind} is not ported: {sorted(LOSSES)}")
    return LOSSES[kind](**args)

"""Losses of the ported heads (mmdet names and config keys)."""
from .advanced import GHMC, GHMR, SeesawLoss, VarifocalLoss
from .cross_entropy_loss import CrossEntropyLoss
from .focal_loss import FocalLoss
from .iou_loss import GIoULoss, IoULoss
from .mil_loss import MILLoss
from .smooth_l1_loss import BalancedL1Loss, L1Loss, SmoothL1Loss
from .utils import accuracy, weight_reduce_loss

__all__ = ["BalancedL1Loss", "CrossEntropyLoss", "FocalLoss", "GHMC", "GHMR",
           "GIoULoss", "IoULoss", "L1Loss", "MILLoss", "SeesawLoss",
           "SmoothL1Loss", "VarifocalLoss",
           "accuracy", "build_loss", "weight_reduce_loss"]

LOSSES = {"BalancedL1Loss": BalancedL1Loss,
          "CrossEntropyLoss": CrossEntropyLoss, "FocalLoss": FocalLoss,
          "GHMC": GHMC, "GHMR": GHMR,
          "GIoULoss": GIoULoss, "IoULoss": IoULoss, "L1Loss": L1Loss,
          "MILLoss": MILLoss, "SeesawLoss": SeesawLoss,
          "SmoothL1Loss": SmoothL1Loss,
          "VarifocalLoss": VarifocalLoss}


def build_loss(cfg: dict):
    """A loss from its config dict (`type` and the class's arguments)."""
    args = dict(cfg)
    kind = args.pop("type")
    if kind not in LOSSES:
        raise KeyError(f"loss {kind} is not ported: {sorted(LOSSES)}")
    return LOSSES[kind](**args)

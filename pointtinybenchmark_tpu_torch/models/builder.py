"""Build ported models from mmdet-style config dicts.

Counterpart of pointtinybenchmark_tpu/models/builder.py for the ported
types only. A dict maps each `type` to its class. A config key that a
class does not take raises `NotImplementedError`: the JAX builder drops
such keys silently, and a dropped structural key (`dcn`, `stage_with_dcn`)
would build another network than JAX's. The training keys
(`frozen_stages`, the heads' losses, `train_cfg`) are taken. The one
exception is the FPN's `norm_cfg`, which the point configs set: the port's
FPN takes it and, as the JAX package, builds no norm (see necks/fpn.py).
A list of necks (Libra R-CNN's [FPN, BFP]) is refused: the JAX package's
TwoStageDetector.setup calls `build_neck(dict(neck))` on it
(models/detectors/two_stage.py:37), which raises ValueError, so there is
no JAX network to match.
"""
from __future__ import annotations

import inspect
from typing import Optional, Union

import torch
from torch import nn

from .backbones.detectors_resnet import DetectoRS_ResNet, DetectoRS_ResNeXt
from .backbones.resnet import ResNet
from .dense_heads.anchor_head import AnchorHead
from .dense_heads.atss_head import ATSSHead
from .dense_heads.cpr_head import CascadeCPRHead, CPRHead
from .dense_heads.fcos_head import FCOSHead
from .dense_heads.fovea_head import FoveaHead
from .dense_heads.free_anchor_retina_head import FreeAnchorRetinaHead
from .dense_heads.p2b_head import P2BNetHead, SSDDetHead
from .dense_heads.p2p_head import P2PHead
from .dense_heads.reppoints_head import RepPointsHead
from .dense_heads.retina_head import RetinaHead
from .dense_heads.rpn_head import RPNHead
from .dense_heads.vfnet_head import VFNetHead
from .detectors.single_stage import (BasicLocator, P2BNet, SSDDet,
                                     SingleStageDetector)
from .detectors.two_stage import (RPN, SCNet, CascadeRCNN, DetectoRS,
                                  GridRCNN, HybridTaskCascade, MaskRCNN,
                                  TwoStageDetector)
from .necks.extra_necks import BFP
from .necks.fpn import FPN
from .necks.rfp import RFP
from .roi_heads.bbox_head import Shared2FCBBoxHead
from .roi_heads.cascade_roi_head import CascadeRoIHead
from .roi_heads.grid_roi_head import GridHead, GridRoIHead
from .roi_heads.htc_roi_head import (FusedSemanticHead, HTCMaskHead,
                                     HybridTaskCascadeRoIHead)
from .roi_heads.mask_head import FCNMaskHead
from .roi_heads.scnet_roi_head import GlobalContextHead, SCNetRoIHead
from .roi_heads.standard_roi_head import StandardRoIHead

__all__ = ["build_detector", "build_module", "MODULES"]

MODULES = {
    "ResNet": ResNet,
    "DetectoRS_ResNet": DetectoRS_ResNet,
    "DetectoRS_ResNeXt": DetectoRS_ResNeXt,
    "FPN": FPN,
    "RFP": RFP,
    "BFP": BFP,
    "AnchorHead": AnchorHead,
    "RetinaHead": RetinaHead,
    "RPNHead": RPNHead,
    "StandardRoIHead": StandardRoIHead,
    "CascadeRoIHead": CascadeRoIHead,
    "HybridTaskCascadeRoIHead": HybridTaskCascadeRoIHead,
    "SCNetRoIHead": SCNetRoIHead,
    "HTCMaskHead": HTCMaskHead,
    "FusedSemanticHead": FusedSemanticHead,
    "GlobalContextHead": GlobalContextHead,
    "GridRoIHead": GridRoIHead,
    "GridHead": GridHead,
    "Shared2FCBBoxHead": Shared2FCBBoxHead,
    "FCNMaskHead": FCNMaskHead,
    "P2PHead": P2PHead,
    "CPRHead": CPRHead,
    "CascadeCPRHead": CascadeCPRHead,
    "P2BNetHead": P2BNetHead,
    "SSDDetHead": SSDDetHead,
    "FCOSHead": FCOSHead,
    "ATSSHead": ATSSHead,
    "RepPointsHead": RepPointsHead,
    "FoveaHead": FoveaHead,
    "FreeAnchorRetinaHead": FreeAnchorRetinaHead,
    "VFNetHead": VFNetHead,
}
SINGLE_STAGE = {"SingleStageDetector": SingleStageDetector,
                "RetinaNet": SingleStageDetector, "FCOS": SingleStageDetector,
                "ATSS": SingleStageDetector,
                "RepPointsDetector": SingleStageDetector,
                "FoveaBox": SingleStageDetector, "VFNet": SingleStageDetector,
                "BasicLocator": BasicLocator, "P2BNet": P2BNet,
                "SSDDet": SSDDet}
TWO_STAGE = {"TwoStageDetector": TwoStageDetector,
             "FasterRCNN": TwoStageDetector, "MaskRCNN": MaskRCNN,
             "GridRCNN": GridRCNN, "CascadeRCNN": CascadeRCNN,
             "HybridTaskCascade": HybridTaskCascade, "SCNet": SCNet,
             "DetectoRS": DetectoRS}
HTC_HEADS = ("HybridTaskCascadeRoIHead", "SCNetRoIHead")
CASCADES = ("CascadeRoIHead",) + HTC_HEADS


def build_module(cfg: dict) -> nn.Module:
    args = dict(cfg)
    kind = args.pop("type")
    if kind not in MODULES:
        raise KeyError(f"{kind} is not ported: {sorted(MODULES)}")
    cls = MODULES[kind]
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
    unknown = sorted(set(args) - accepted)
    if unknown:
        raise NotImplementedError(
            f"{kind}: config keys {unknown} are not ported (the port's "
            f"{cls.__name__} takes {sorted(accepted)})")
    return cls(**args)


def _cascade_heads(roi_cfg: dict) -> list:
    """A cascade's bbox heads: one a stage, from its list of configs or one
    config for every stage; their box loss defaults to smooth L1 of beta
    1 (JAX cascade_roi_head.py:_stage_forward_train)."""
    heads = roi_cfg["bbox_head"]
    n = int(roi_cfg.get("num_stages", 3))
    if not isinstance(heads, (list, tuple)):
        heads = [heads] * n
    return [build_module(dict(dict(loss_bbox=dict(
        type="SmoothL1Loss", beta=1.0)), **h)) for h in heads]


def _htc_heads(roi_cfg: dict) -> None:
    """HTC's and SCNet's branch heads, built as the JAX RoI heads build
    them, their configs' `type` set aside (JAX htc_roi_head.py and
    scnet_roi_head.py `setup`): an HTCMaskHead a stage for HTC, with
    `conv_res` from stage 1 on under `mask_info_flow` (the heads the JAX
    head hands features), one for SCNet (the one it runs); the
    FusedSemanticHead; SCNet's GlobalContextHead, of the RoI head's
    classes unless set."""
    scnet = roi_cfg["type"] == "SCNetRoIHead"
    n = 1 if scnet else int(roi_cfg.get("num_stages", 3))
    flow = not scnet and bool(roi_cfg.get("mask_info_flow", True))
    masks = roi_cfg.get("mask_head")
    if masks:
        cfgs = masks if isinstance(masks, (list, tuple)) else [masks] * n
        roi_cfg["mask_head"] = [
            build_module(dict(cfgs[i], type="HTCMaskHead",
                              with_conv_res=flow and i > 0))
            for i in range(n)]
    if roi_cfg.get("semantic_head"):
        roi_cfg["semantic_head"] = build_module(
            dict(roi_cfg["semantic_head"], type="FusedSemanticHead"))
    if scnet and roi_cfg.get("glbctx_head"):
        cfg = dict(roi_cfg["glbctx_head"], type="GlobalContextHead")
        cfg.setdefault("num_classes", roi_cfg["bbox_head"][0].num_classes)
        roi_cfg["glbctx_head"] = build_module(cfg)


def build_detector(cfg: dict, train_cfg: Optional[dict] = None,
                   test_cfg: Optional[dict] = None, *,
                   device: Union[str, torch.device] = "cuda",
                   seed: int = 0) -> Union[SingleStageDetector,
                                           TwoStageDetector]:
    """Build a detector with seeded random weights, in eval mode, on
    `device` (the card unless the caller asks for the CPU). Weights are
    drawn on the CPU from `torch.Generator` seeded with `seed`, so a seed
    gives the same weights on every device, each parameter from the
    distribution its JAX twin's initialiser draws (flax's lecun_normal
    wherever the JAX module sets none); the two RNGs differ, so equal
    seeds give different numbers. A single-stage detector's head
    gets `train_cfg` and `test_cfg` (JAX single_stage.py:38-43); a
    two-stage detector's RPN gets `train_cfg["rpn"]` and
    `test_cfg["rpn"]`, its RoI head `train_cfg["rcnn"]` and
    `test_cfg["rcnn"]` and the built bbox head and, for Mask R-CNN, mask
    head (for Grid R-CNN, grid head; for Cascade R-CNN, HTC and SCNet a
    bbox head a stage, `train_cfg["rcnn"]` then a list of one config a
    stage, and HTC's and SCNet's branch heads by `_htc_heads`); the
    detector keeps
    `train_cfg["rpn_proposal"]` (JAX two_stage.py:38-45). The standalone
    RPN's head gets each config's "rpn" part, or the whole config where
    it has none (JAX two_stage.py::RPN.setup). An unported
    detector type and a list of necks (see the module note) raise before
    any layer is built."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in SINGLE_STAGE and kind not in TWO_STAGE and kind != "RPN":
        raise KeyError(f"detector {kind} is not ported")
    train_cfg = cfg.get("train_cfg") or train_cfg
    test_cfg = cfg.get("test_cfg") or test_cfg
    if isinstance(cfg.get("neck"), (list, tuple)):
        raise NotImplementedError(
            f"a list of necks ({[n.get('type') for n in cfg['neck']]}, "
            f"Libra R-CNN's form) is not ported: the JAX package's "
            f"TwoStageDetector.setup calls build_neck(dict(neck)) on it "
            f"(models/detectors/two_stage.py:37) and raises ValueError, so "
            f"there is no JAX network to match")
    backbone = build_module(cfg["backbone"])
    neck = build_module(cfg["neck"]) if cfg.get("neck") else None
    if kind == "RPN":
        # JAX two_stage.py::RPN.setup: the rpn part of each config, or the
        # whole config where it has none
        rpn_cfg = dict(cfg["rpn_head"])
        for key, c in (("train_cfg", train_cfg), ("test_cfg", test_cfg)):
            rpn_cfg.setdefault(key, (c or {}).get("rpn", c))
        model = RPN(backbone=backbone, neck=neck,
                    rpn_head=build_module(rpn_cfg))
    elif kind in SINGLE_STAGE:
        head_cfg = dict(cfg["bbox_head"])
        head_cfg.setdefault("train_cfg", train_cfg)
        head_cfg.setdefault("test_cfg", test_cfg)
        model = SINGLE_STAGE[kind](backbone=backbone, neck=neck,
                                   bbox_head=build_module(head_cfg))
    else:
        rpn_cfg = dict(cfg["rpn_head"])
        rpn_cfg.setdefault("train_cfg", (train_cfg or {}).get("rpn"))
        rpn_cfg.setdefault("test_cfg", (test_cfg or {}).get("rpn"))
        roi_cfg = dict(cfg["roi_head"])
        roi_cfg.setdefault("train_cfg", (train_cfg or {}).get("rcnn"))
        roi_cfg.setdefault("test_cfg", (test_cfg or {}).get("rcnn"))
        if roi_cfg.get("type") in CASCADES:
            roi_cfg["bbox_head"] = _cascade_heads(roi_cfg)
        else:
            roi_cfg["bbox_head"] = build_module(roi_cfg["bbox_head"])
        if roi_cfg.get("type") in HTC_HEADS:
            _htc_heads(roi_cfg)
        else:
            for key in ("mask_head", "grid_head"):
                if roi_cfg.get(key):
                    roi_cfg[key] = build_module(roi_cfg[key])
        model = TWO_STAGE[kind](backbone=backbone, neck=neck,
                                rpn_head=build_module(rpn_cfg),
                                roi_head=build_module(roi_cfg),
                                train_cfg=train_cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

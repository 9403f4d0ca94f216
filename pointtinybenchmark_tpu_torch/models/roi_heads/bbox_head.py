"""Shared2FCBBoxHead (mmdet bbox_heads/convfc_bbox_head.py).

Counterpart of pointtinybenchmark_tpu/models/roi_heads/bbox_head.py::
Shared2FCBBoxHead: RoI features flattened, two shared FC + ReLU layers, then
`fc_cls` (num_classes + 1 logits, background last) and `fc_reg` (class-wise
or agnostic deltas). The RoI features are (R, C, S, S) and flatten in
mmdet's (c, h, w) order; the JAX head's (R, S, S, C) flattens as (h, w, c),
which `utils/jax_weights.py` bridges by permuting the rows of `shared_fc0`.
The head keeps its `loss_cls` and `loss_bbox` configs (softmax
cross-entropy and L1 by default, as in JAX) for the RoI head's loss.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Shared2FCBBoxHead"]


class Shared2FCBBoxHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 num_shared_fcs: int = 2, reg_class_agnostic: bool = False,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None):
        super().__init__()
        self.loss_cls = dict(loss_cls or dict(type="CrossEntropyLoss"))
        self.loss_bbox = dict(loss_bbox or dict(type="L1Loss"))
        self.num_classes = num_classes
        self.roi_feat_size = roi_feat_size
        self.reg_class_agnostic = reg_class_agnostic
        self.bbox_coder = dict(bbox_coder or {})
        dims = ([in_channels * roi_feat_size * roi_feat_size]
                + [fc_out_channels] * num_shared_fcs)
        self.shared_fcs = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_shared_fcs))
        self.fc_cls = nn.Linear(dims[-1], num_classes + 1)
        self.fc_reg = nn.Linear(dims[-1],
                                4 if reg_class_agnostic else 4 * num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        for fc in self.shared_fcs:
            nn.init.xavier_uniform_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)
        for fc, std in ((self.fc_cls, 0.01), (self.fc_reg, 0.001)):
            nn.init.normal_(fc.weight, 0.0, std, generator=generator)
            nn.init.zeros_(fc.bias)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (R, C, S, S) -> cls logits (R, num_classes + 1),
        deltas (R, 4 or 4 * num_classes)."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)

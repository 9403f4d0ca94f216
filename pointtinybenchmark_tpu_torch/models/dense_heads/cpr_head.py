"""CPRHead: Coarse Point Refinement (CVPR 2022), and its cascade.

Counterpart of pointtinybenchmark_tpu/models/dense_heads/cpr_head.py
(`circle_offsets`, `grid_offsets`, CPRHead, CascadeCPRHead), batched with
gts padded to (B, G) and a validity mask, in the JAX operation order:

- network: `stacked_convs` 3x3 convs (GN in the configs) shared by the
  classification and instance branches; point features are sampled
  bilinearly at the bag points (ops/grid_sample.py::point_sample_pixel,
  cell centres at integer coordinates, border padding) and go through
  `cls_out` and the instance branch `ins_out` (nn.Linear);
- a positive bag is the rings of points round each annotated point
  (`circle_offsets`: radius r = i * stride with base_num_point * i points,
  the centre last) or the grid cells within a radius of the grid-snapped
  point (`grid_offsets`, the Grid*PtFeatGenerator variants; the ellipse
  variant keeps the cells of the ellipse over a pair of refine points);
- training (loss0): the MIL loss on the bags (`refine_bag_policy`), with
  `random_remove_rate` of the bag points dropped by a draw from the step's
  torch.Generator (`bag_keep_mask`; JAX's jax.random draw cannot be
  reproduced, and no generator means no drop), the generalized focal loss
  on every grid cell farther than radius * stride from every gt (of its
  class with `class_wise`) as a negative, and the gt-point loss;
- refinement (`refine`, the PointRefiner): each bag point must be nearest
  its own gt among the valid same-class gts, be classified as the gt's
  class (`classify_filter`), score above merge_th and gt_alpha times the
  gt point's own score, and lie in the image; the refined point is the
  score-weighted mean of those kept, or the coarse point where the mean
  score stays below refine_th (`not_refine`);
- CascadeCPRHead re-extracts the bags at each stage's refined points.

Big intermediates are kept in the JAX form: `_neg_valid` builds
(B, HW, G*R, classes) and the nearest filter (B, G*R*NC, G*R).

The options no config of the repo sets are not ported and raise: fc
layers before the classifiers (`num_cls_fcs`), separate instance convs
or a shared classifier, class probabilities other than the sigmoid, a
background class, and the max score of `return_score_type`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.grid_sample import point_sample_pixel
from ..losses import MILLoss
from ..utils import ConvModule, bias_init_with_prob, normal_init, one_hot

__all__ = ["CPRHead", "CascadeCPRHead", "circle_offsets", "grid_offsets",
           "bag_keep_mask"]

GRID_GENERATORS = ("GridPtFeatGenerator", "GridCirclesPtFeatGenerator",
                   "GridEllipsePtFeatGenerator")


def circle_offsets(radius: int, base_num_point: int = 8, stride: float = 1.0,
                   start_angle: float = 0.0,
                   same_num_all_radius: bool = False) -> np.ndarray:
    """(num_circle, 2) float32 ring offsets: ring i (1-based) of radius
    i * stride has base_num_point * i points (base_num_point with
    same_num_all_radius). The caller appends the centre."""
    pts = []
    for i in range(radius):
        r = (i + 1) * stride
        n = base_num_point if same_num_all_radius else base_num_point * (i + 1)
        angles = (np.arange(n) / n * 360.0 + start_angle) / 360.0 * 2 * np.pi
        pts.append(np.stack([r * np.cos(angles), r * np.sin(angles)], -1))
    return np.concatenate(pts).astype(np.float32)


def grid_offsets(radius: int, stride: float = 1.0) -> np.ndarray:
    """Offsets of the grid cells within `radius` cells of a point."""
    rng = np.arange(-radius, radius + 1, dtype=np.float32)
    dx, dy = np.meshgrid(rng, rng)
    keep = dx ** 2 + dy ** 2 <= radius ** 2 + 1e-6
    return (np.stack([dx[keep], dy[keep]], -1) * stride).astype(np.float32)


def bag_keep_mask(shape, rate: float, generator: torch.Generator,
                  device) -> torch.Tensor:
    """The bag points kept by random_remove: a uniform draw >= rate."""
    return torch.rand(shape, generator=generator, device=device) >= rate


class CPRHead(nn.Module):

    needs_gt_in_forward = True
    default_stages = 1          # refinement stages without cascade_stages

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_cls_fcs: int = 0, strides: Sequence[int] = (4,),
                 norm_cfg: Optional[dict] = None,
                 loss_mil: Optional[dict] = None, loss_type: int = 0,
                 loss_cfg: Optional[dict] = None,
                 normal_cfg: Optional[dict] = None,
                 train_pts_extractor: Optional[dict] = None,
                 refine_pts_extractor: Optional[dict] = None,
                 point_refiner: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 cascade_stages: Optional[int] = None):
        super().__init__()
        if len(strides) != 1:
            raise ValueError("CPR runs on a single FPN level")
        if loss_type != 0 or num_cls_fcs != 0:
            raise NotImplementedError(
                f"loss_type {loss_type}, num_cls_fcs {num_cls_fcs} (0 and 0 "
                f"are ported)")
        self.num_classes = num_classes
        self.strides = list(strides)
        self.loss_mil_cfg = dict(loss_mil or dict(type="MILLoss"))
        self.loss_mil_cfg.pop("type", None)
        self.loss_cfg = dict(with_neg=True, neg_loss_weight=1.0,
                             refine_bag_policy="independent_with_gt_bag",
                             random_remove_rate=0.4, with_gt_loss=False,
                             gt_loss_weight=1.0, with_mil_loss=True)
        self.loss_cfg.update(dict(loss_cfg or {}))
        normal = dict(prob_cls_type="sigmoid", out_bg_cls=False)
        normal.update(dict(normal_cfg or {}))
        if normal != dict(prob_cls_type="sigmoid", out_bg_cls=False):
            raise NotImplementedError(f"normal_cfg {normal} (sigmoid "
                                      f"probabilities, no background class)")
        self.train_pts_extractor = train_pts_extractor
        self.refine_pts_extractor = refine_pts_extractor
        self.point_refiner = dict(point_refiner or {})
        if self.point_refiner.get("return_score_type", "mean") != "mean":
            raise NotImplementedError("return_score_type (mean is ported)")
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.cascade_stages = (self.default_stages if cascade_stages is None
                               else cascade_stages)
        norm = (norm_cfg or {}).get("type")
        groups = (norm_cfg or {}).get("num_groups", 32)
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            ConvModule(chans[i], chans[i + 1], 3, norm=norm, num_groups=groups)
            for i in range(stacked_convs))
        self.cls_out = nn.Linear(chans[-1], num_classes)
        self.ins_out = nn.Linear(chans[-1], num_classes)

    # ------------------------------------------------------------ config
    @staticmethod
    def _pos_gen_cfg(extractor_cfg: Optional[dict]) -> dict:
        cfg = dict((extractor_cfg or {}).get(
            "pos_generator", dict(type="CirclePtFeatGenerator", radius=5)))
        cfg["_type"] = cfg.pop("type", "CirclePtFeatGenerator")
        for k, v in (("radius", 5), ("base_num_point", 8), ("start_angle", 0),
                     ("same_num_all_radius", False), ("append_center", True)):
            cfg.setdefault(k, v)
        return cfg

    @staticmethod
    def _neg_gen_cfg(extractor_cfg: Optional[dict]) -> dict:
        cfg = dict((extractor_cfg or {}).get(
            "neg_generator", dict(type="OutCirclePtFeatGenerator", radius=3)))
        cfg.pop("type", None)
        cfg.setdefault("radius", 3)
        cfg.setdefault("class_wise", False)
        return cfg

    def init_weights(self, generator: torch.Generator) -> None:
        """Convs and linears normal(0.01), biases 0, cls_out's bias the 0.01
        prior; GN's scale 1 and bias 0."""
        for m in self.cls_convs:
            normal_init(m.conv, 0.01, generator)
        normal_init(self.cls_out, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.ins_out, 0.01, generator)

    # ----------------------------------------------------------- network
    def forward(self, feats: Sequence[torch.Tensor], batch: Dict[str, Any],
                mode: str = "train"):
        """feats: one NCHW level. batch: gt_points (B, G, R, 2), gt_labels,
        gt_valid (B, G), img_shape (B, 2), pad_shape (static). Returns the
        bag outputs (and, in "train" mode, the grid's class outputs); in
        "cascade_refine" mode the refined points, scores and not_refine."""
        if len(feats) != 1:
            raise ValueError("CPR runs on a single FPN level")
        x = feats[0]
        cls_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        cls_nhwc = cls_feat.permute(0, 2, 3, 1)
        stride = float(self.strides[0])
        pad_shape = batch["pad_shape"]
        b, g, r, _ = batch["gt_points"].shape
        extractor = (self.train_pts_extractor if mode == "train"
                     else self.refine_pts_extractor)
        pos_cfg = self._pos_gen_cfg(extractor)
        gen_type = pos_cfg["_type"]
        grid_gen = gen_type in GRID_GENERATORS
        if grid_gen:
            offs = grid_offsets(int(pos_cfg["radius"]), stride)
        else:
            offs = circle_offsets(int(pos_cfg["radius"]),
                                  int(pos_cfg["base_num_point"]), stride,
                                  float(pos_cfg["start_angle"]),
                                  bool(pos_cfg["same_num_all_radius"]))
        if pos_cfg["append_center"]:
            offs = np.concatenate([offs, np.zeros((1, 2), np.float32)])
        nc = offs.shape[0]
        offs_t = torch.from_numpy(offs).to(x.device)

        def run_bags(gt_points):
            anchors = (torch.round(gt_points / stride) * stride
                       if grid_gen else gt_points)
            bag_pts = anchors[:, :, :, None, :] + offs_t
            in_shape = None
            if gen_type == "GridEllipsePtFeatGenerator" and \
                    gt_points.shape[2] >= 2:
                f1 = gt_points[:, :, 0, :]
                f2 = gt_points[:, :, 1, :]
                c = torch.linalg.vector_norm(f1 - f2, dim=-1) / 2
                amc = float(pos_cfg.get("a_minus_c", -1.0))
                adc = float(pos_cfg.get("a_divide_c", -1.0))
                a = amc * stride + c if amc >= 0 else adc * c
                d = (torch.linalg.vector_norm(
                        bag_pts - f1[:, :, None, None, :], dim=-1)
                     + torch.linalg.vector_norm(
                        bag_pts - f2[:, :, None, None, :], dim=-1))
                in_shape = d <= 2.0 * torch.clamp(a, min=stride)[
                    :, :, None, None]
            inside = ((bag_pts[..., 0] >= 0) & (bag_pts[..., 0] < pad_shape[1])
                      & (bag_pts[..., 1] >= 0)
                      & (bag_pts[..., 1] < pad_shape[0]))
            bag_valid = inside & batch["gt_valid"][:, :, None, None]
            if in_shape is not None:
                bag_valid = bag_valid & in_shape
            flat_pts = bag_pts.reshape(b, g * r * nc, 2) / stride
            bag_feats = point_sample_pixel(cls_nhwc, flat_pts).reshape(
                b, g, r, nc, -1)
            return dict(bag_pts=bag_pts, bag_valid=bag_valid,
                        bag_cls_outs=self.cls_out(bag_feats),
                        bag_ins_outs=self.ins_out(bag_feats))

        if mode == "cascade_refine":
            pts = batch["gt_points"][:, :, 0, :]
            not_refine = scores = None
            for _ in range(max(int(self.cascade_stages), 1)):
                hb = dict(batch, gt_points=pts[:, :, None, :])
                pts, scores, nr = self.refine(run_bags(hb["gt_points"]), hb)
                not_refine = nr if not_refine is None else (not_refine | nr)
            return pts, scores, not_refine

        out = run_bags(batch["gt_points"])
        if mode == "train":
            out["grid_cls_outs"] = self.cls_out(cls_nhwc)
            out["feat_hw"] = tuple(cls_feat.shape[-2:])
        return out

    @staticmethod
    def get_cls_prob(cls_out: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(cls_out)

    # ----------------------------------------------------------- helpers
    def _grid_centers(self, feat_hw: Tuple[int, int]) -> np.ndarray:
        h, w = feat_hw
        stride = float(self.strides[0])
        xx, yy = np.meshgrid((np.arange(w) + 0.5) * stride,
                             (np.arange(h) + 0.5) * stride)
        return np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32)

    def _neg_valid(self, grid_pts: torch.Tensor, gt_points: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   pad_shape, radius: float, class_wise: bool
                   ) -> torch.Tensor:
        """(B, HW, classes) mask of the negative grid points
        (OutCirclePtFeatGenerator)."""
        stride = float(self.strides[0])
        b, g, r, _ = gt_points.shape
        gts = gt_points.reshape(b, g * r, 2)
        gv = gt_valid.repeat_interleave(r, dim=1)
        d2 = ((grid_pts[None, :, None, :] - gts[:, None, :, :]) ** 2).sum(-1)
        d2 = torch.where(gv[:, None, :], d2, float("inf"))
        thr2 = (stride * radius) ** 2
        inside = ((grid_pts[:, 0] >= 0) & (grid_pts[:, 0] < pad_shape[1])
                  & (grid_pts[:, 1] >= 0) & (grid_pts[:, 1] < pad_shape[0]))
        if class_wise:
            gl = gt_labels.repeat_interleave(r, dim=1)
            cls_ids = torch.arange(self.num_classes, device=gl.device)
            same = gl[:, None, :, None] == cls_ids
            d2c = torch.where(same, d2[..., None], float("inf"))
            far = d2c.amin(2) >= thr2
        else:
            far = (d2.amin(2) >= thr2)[..., None].expand(
                -1, -1, self.num_classes)
        return far & inside[None, :, None]

    # -------------------------------------------------------------- loss
    def loss(self, outputs: Dict[str, Any], batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """loss0: the gt loss, the MIL bag loss and the negative loss, as
        the JAX head's; `generator` draws the bag-point drop (none without
        one)."""
        cfg = self.loss_cfg
        loss_mil = MILLoss(**self.loss_mil_cfg)
        gt_labels = batch["gt_labels"]
        gt_valid = batch["gt_valid"]
        gt_weights = batch.get("gt_weights")
        if gt_weights is None:
            gt_weights = gt_valid.to(torch.float32)
        bag_valid = outputs["bag_valid"]
        bag_cls_outs = outputs["bag_cls_outs"]
        bag_ins_outs = outputs["bag_ins_outs"]
        b, g, r, nc, c = bag_cls_outs.shape
        losses: Dict[str, torch.Tensor] = {}

        if cfg["with_gt_loss"]:
            gt_type = cfg.get("gt_loss_type", "gt_refine")
            gt_prob = self.get_cls_prob(bag_cls_outs[..., -1, :])
            if gt_type == "gt_refine":
                p = gt_prob.reshape(b * g * r, c)
                lbl = gt_labels.reshape(-1).repeat_interleave(r)
                w = (bag_valid[..., -1].reshape(b * g * r).to(torch.float32)
                     * gt_weights.reshape(-1).repeat_interleave(r))
            else:
                p = gt_prob[:, :, 0].reshape(b * g, c)
                lbl = gt_labels.reshape(-1)
                w = (bag_valid[:, :, 0, -1].reshape(-1).to(torch.float32)
                     * gt_weights.reshape(-1))
            num_pos_gt = (w > 0).sum().to(torch.float32).clamp(min=1.0)
            gt_loss = loss_mil.gfocal_loss(p, one_hot(lbl, c), w[:, None])
            losses["loss_gt"] = (cfg["gt_loss_weight"] * gt_loss.sum()
                                 / num_pos_gt)

        rrr = float(cfg["random_remove_rate"])
        bag_valid_mil = bag_valid
        if rrr > 0 and generator is not None:
            bag_valid_mil = bag_valid & bag_keep_mask(
                bag_valid.shape, rrr, generator, bag_valid.device)

        num_pos = torch.ones((), device=bag_cls_outs.device)
        if cfg["with_mil_loss"]:
            policy = cfg["refine_bag_policy"]
            if policy == "independent_with_gt_bag":
                cls_o = bag_cls_outs.reshape(b * g * r, nc, c)
                ins_o = bag_ins_outs.reshape(b * g * r, nc, -1)
                val = bag_valid_mil.reshape(b * g * r, nc, 1)
                lbl = gt_labels.reshape(-1).repeat_interleave(r)
                wts = gt_weights.reshape(-1).repeat_interleave(r)
            elif policy in ("merge_to_gt_bag", "only_refine_bag"):
                si = 1 if policy == "only_refine_bag" and r > 1 else 0
                cls_o = bag_cls_outs[:, :, si:].reshape(b * g, (r - si) * nc,
                                                        c)
                ins_o = bag_ins_outs[:, :, si:].reshape(b * g, (r - si) * nc,
                                                        -1)
                val = bag_valid_mil[:, :, si:].reshape(b * g, (r - si) * nc, 1)
                lbl = gt_labels.reshape(-1)
                wts = gt_weights.reshape(-1)
            else:
                raise ValueError(policy)
            val = val.to(torch.float32) * wts[:, None, None]
            pos_loss, bag_acc, num_pos = loss_mil(self.get_cls_prob(cls_o),
                                                  ins_o, lbl, val)
            losses["loss_pos"] = pos_loss
            losses["bag_acc"] = bag_acc

        if cfg["with_neg"]:
            grid_pts = torch.from_numpy(self._grid_centers(
                outputs["feat_hw"])).to(bag_cls_outs.device)
            neg_cfg = self._neg_gen_cfg(self.train_pts_extractor)
            neg_valid = self._neg_valid(
                grid_pts, outputs["bag_pts"][:, :, :, -1, :], gt_labels,
                gt_valid, batch["pad_shape"], float(neg_cfg["radius"]),
                bool(neg_cfg["class_wise"]))
            neg_prob = self.get_cls_prob(
                outputs["grid_cls_outs"].reshape(b, -1, self.num_classes))
            neg_loss = loss_mil.gfocal_loss(
                neg_prob.reshape(-1, self.num_classes),
                torch.zeros_like(neg_prob).reshape(-1, self.num_classes),
                neg_valid.reshape(-1, self.num_classes).to(torch.float32))
            losses["loss_neg"] = (cfg["neg_loss_weight"] * neg_loss.sum()
                                  / num_pos.clamp(min=1.0))
        return losses

    # ------------------------------------------------------------ refine
    def refine(self, outputs: Dict[str, Any], batch: Dict[str, Any]):
        """The PointRefiner, batched. Returns refined points (B, G, 2),
        scores (B, G) and not_refine (B, G)."""
        cfg = self.point_refiner
        gt_alpha = float(cfg.get("gt_alpha", 0.5))
        merge_th = float(cfg.get("merge_th", 0.05))
        refine_th = float(cfg.get("refine_th", 0.05))
        use_classify = bool(cfg.get("classify_filter", False))
        use_nearest = bool(cfg.get("nearest_filter", True))

        gt_labels = batch["gt_labels"].long()
        gt_valid = batch["gt_valid"]
        img_shape = batch["img_shape"]
        gt_points = batch["gt_points"]
        bag_pts = outputs["bag_pts"]
        prob_all = self.get_cls_prob(outputs["bag_cls_outs"])
        b, g, r, nc, c = prob_all.shape
        safe_lbl = gt_labels.clamp(0, c - 1)
        prob = prob_all.gather(-1, safe_lbl[:, :, None, None, None].expand(
            b, g, r, nc, 1))[..., 0]
        gt_prob = prob[..., -1]                      # the centre is last
        merge_valid = outputs["bag_valid"].reshape(b, g, r * nc)
        prob_flat = prob.reshape(b, g, r * nc)

        if use_nearest:
            pts = bag_pts.reshape(b, g * r * nc, 2)
            centers = gt_points.reshape(b, g * r, 2)
            d2 = ((pts[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
            gv = gt_valid.repeat_interleave(r, dim=1)
            lbl_r = gt_labels.repeat_interleave(r, dim=1)
            own = torch.arange(g * r, device=pts.device).repeat_interleave(nc)
            own_lbl = lbl_r.repeat_interleave(nc, dim=1)
            cand = gv[:, None, :] & (lbl_r[:, None, :] == own_lbl[:, :, None])
            d2 = torch.where(cand, d2, float("inf"))
            near_ok = (d2.argmin(-1) == own).reshape(b, g, r * nc)
            merge_valid = merge_valid & near_ok

        if use_classify:
            cls_ok = (prob_all.argmax(-1)
                      == safe_lbl[:, :, None, None]).reshape(b, g, r * nc)
            merge_valid = merge_valid & cls_ok

        gt_prob0 = gt_prob[:, :, 0:1]
        merge_valid = (merge_valid & (prob_flat > merge_th)
                       & (prob_flat > gt_prob0 * gt_alpha))
        pts_flat = bag_pts.reshape(b, g, r * nc, 2)
        w_img = img_shape[:, 1].to(prob.dtype)[:, None, None]
        h_img = img_shape[:, 0].to(prob.dtype)[:, None, None]
        inside = ((pts_flat[..., 0] >= 0) & (pts_flat[..., 0] < w_img)
                  & (pts_flat[..., 1] >= 0) & (pts_flat[..., 1] < h_img))
        merge_valid = merge_valid & inside

        weighted = prob_flat * merge_valid.to(prob.dtype)
        wsum = weighted.sum(-1, keepdim=True)
        weight = weighted / (wsum + 1e-8)
        refine_pts = (pts_flat * weight[..., None]).sum(2)
        count = (weighted > 0).to(prob.dtype).sum(-1)
        mean_score = weighted.sum(-1) / (count + 1e-8)
        not_refine = mean_score < refine_th
        refine_pts = torch.where(not_refine[..., None], gt_points[:, :, 0, :],
                                 refine_pts)
        return refine_pts, mean_score, not_refine

    @staticmethod
    def center_to_pseudo_bbox(centers: torch.Tensor,
                              pseudo_wh=(16, 16)) -> torch.Tensor:
        wh = torch.tensor(pseudo_wh, dtype=centers.dtype,
                          device=centers.device)
        return torch.cat([centers - wh / 2, centers + wh / 2], -1)


class CascadeCPRHead(CPRHead):
    """Iterative refinement (the CPR++ direction): each stage's refined
    points seed the next stage's bags; two stages by default."""

    default_stages = 2

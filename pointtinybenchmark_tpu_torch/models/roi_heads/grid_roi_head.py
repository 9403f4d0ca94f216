"""Grid R-CNN's RoI head: the bbox branch of Faster R-CNN and a grid branch
that places a 3x3 lattice of box points on heat maps.

Counterpart of pointtinybenchmark_tpu/models/roi_heads/grid_roi_head.py
(`GridHead`, `grid_targets`, `GridRoIHead`, `grid_refine_boxes`), NCHW.
`GridHead` has the JAX module's layers under their flax names: `num_convs`
3x3 convolutions (`conv{i}`, with a bias) each followed by GroupNorm
(`gn{i}`, flax's `GroupNorm_{i}`: 36 groups where the width divides by 36,
else the largest of 32, 16, ... that divides it; eps 1e-5) and ReLU; a 1x1
convolution per point (`point_feat{k}`); first-order fusion, point k's
features plus a 5x5 convolution (`fuse{j}_{k}`) of each lattice neighbour
j's; then per point a 2x2 stride-2 transposed convolution to the same
width with ReLU (`deconv1_{k}`) and one to a single map (`deconv2_{k}`,
bias -4.6). RoI features (R, C, S, S) give heat-map logits
(R, 9, 4S, 4S); the JAX head's are (R, 4S, 4S, 9), whose maps flatten to
y * 4S + x as these do.

Training (`forward_train`): the bbox branch's sampled rois (the gathered
rois of every image, image-major, with their positives and matched gt
indices, which the JAX head stashes from `_bbox_loss`) are jittered by up
to 0.15 of their width and height, the min(n, 96) rois of largest
positive weight plus 0.01 of a uniform priority are taken, their grid
extractor's RoIAlign features (S=14, sr=2 at the configs' setting: the
CUDA kernel on the card) go through the grid head, and the loss is the
stable binary cross-entropy against `grid_targets`, averaged over each
roi's maps and points, weighted by its positive weight, times 15 over
max(positives, 1). `grid_loss` takes the jitter and the priorities as
tensors; the head draws them from the step's generator (uniform in
[-0.15, 0.15) and [0, 1), as JAX's `jax.random.uniform` draws its own).
The proposals carry no gradient, so neither do the jittered rois.

Test time (`simple_test`): the bbox branch's detections (back in the
network's frame where they were rescaled) are refined by the sigmoid heat
maps' `grid_refine_boxes`. JAX refines every slot, the empty ones too;
here only the valid slots are: their RoIAlign runs once, and the grid
head on `chunk` rois at a time (its activations come to ~2.5 MB a roi at
the configs' widths). An empty slot keeps its box, which no output of the
tiled protocol reads.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...core.post_processing import DetResult
from ..losses.cross_entropy_loss import binary_cross_entropy_with_logits
from ..utils import lecun_normal_
from .bbox_head import Shared2FCBBoxHead
from .roi_extractor import single_roi_extract
from .standard_roi_head import StandardRoIHead, _extractor_cfg

__all__ = ["GridHead", "GridRoIHead", "grid_targets", "grid_refine_boxes",
           "grid_bce_loss", "NEIGHBORS"]

# the 3x3 lattice, row-major: (ix, iy) in {0, 0.5, 1}
GRID_XY = ((0.0, 0.0), (0.5, 0.0), (1.0, 0.0),
           (0.0, 0.5), (0.5, 0.5), (1.0, 0.5),
           (0.0, 1.0), (0.5, 1.0), (1.0, 1.0))
# the lattice's 4-connected neighbours, fused first-order
NEIGHBORS = {0: (1, 3), 1: (0, 2, 4), 2: (1, 5), 3: (0, 4, 6),
             4: (1, 3, 5, 7), 5: (2, 4, 8), 6: (3, 7), 7: (4, 6, 8),
             8: (5, 7)}
JITTER = 0.15                   # of a roi's width and height
MAX_GRID_ROIS = 96              # grid rois a train step
DECONV2_BIAS = -4.6


def _grid_xy(device: torch.device) -> torch.Tensor:
    return torch.tensor(GRID_XY, dtype=torch.float32, device=device)


class GridHead(nn.Module):

    def __init__(self, grid_points: int = 9, num_convs: int = 8,
                 in_channels: int = 256, feat_channels: int = 256,
                 point_feat_channels: int = 64):
        super().__init__()
        if grid_points != len(GRID_XY):
            raise NotImplementedError(
                f"grid_points={grid_points}: the JAX head's lattice and "
                f"fusion graph are 3x3")
        self.grid_points = grid_points
        self.num_convs = num_convs
        groups = 36 if feat_channels % 36 == 0 else max(
            g for g in (32, 16, 8, 4, 2, 1) if feat_channels % g == 0)
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else feat_channels, feat_channels, 3,
                padding=1))
            self.add_module(f"gn{i}", nn.GroupNorm(groups, feat_channels,
                                                   eps=1e-5))
        last = feat_channels if num_convs else in_channels
        pf = point_feat_channels
        for k in range(grid_points):
            self.add_module(f"point_feat{k}", nn.Conv2d(last, pf, 1))
        for k in range(grid_points):
            for j in NEIGHBORS[k]:
                self.add_module(f"fuse{j}_{k}", nn.Conv2d(pf, pf, 5,
                                                          padding=2))
        for k in range(grid_points):
            self.add_module(f"deconv1_{k}",
                            nn.ConvTranspose2d(pf, pf, 2, stride=2))
            self.add_module(f"deconv2_{k}",
                            nn.ConvTranspose2d(pf, 1, 2, stride=2))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default (`lecun_normal_`, bias 0) on every convolution
        and transposed convolution, deconv2's bias -4.6, GroupNorm's
        scale 1 and bias 0, as the JAX head's."""
        for name, m in self.named_children():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(m, generator)
            else:
                m.reset_parameters()
        for k in range(self.grid_points):
            nn.init.constant_(getattr(self, f"deconv2_{k}").bias,
                              DECONV2_BIAS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (R, C, S, S) -> heat-map logits (R, grid_points, 4S, 4S)."""
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"gn{i}")(
                getattr(self, f"conv{i}")(x)))
        feats = [getattr(self, f"point_feat{k}")(x)
                 for k in range(self.grid_points)]
        heat = []
        for k in range(self.grid_points):
            f = feats[k]
            for j in NEIGHBORS[k]:
                f = f + getattr(self, f"fuse{j}_{k}")(feats[j])
            y = torch.relu(getattr(self, f"deconv1_{k}")(f))
            heat.append(getattr(self, f"deconv2_{k}")(y)[:, 0])
        return torch.stack(heat, 1)


def grid_targets(rois: torch.Tensor, gt_boxes: torch.Tensor,
                 heat_size: int) -> torch.Tensor:
    """Cross-shaped binary targets of radius 1 around each lattice point of
    the matched gt on a heat_size map of its roi, zero for a point outside
    the roi. rois (N, 5), gt_boxes (N, 4) -> (N, 9, heat_size, heat_size)
    float32."""
    gxy = _grid_xy(rois.device)
    x1, y1 = rois[:, 1], rois[:, 2]
    w = (rois[:, 3] - x1).clamp(min=1e-3)
    h = (rois[:, 4] - y1).clamp(min=1e-3)
    gx = gt_boxes[:, 0:1] + (gt_boxes[:, 2:3] - gt_boxes[:, 0:1]) \
        * gxy[None, :, 0]
    gy = gt_boxes[:, 1:2] + (gt_boxes[:, 3:4] - gt_boxes[:, 1:2]) \
        * gxy[None, :, 1]
    px = (gx - x1[:, None]) / w[:, None] * heat_size
    py = (gy - y1[:, None]) / h[:, None] * heat_size
    ix = torch.floor(px).clamp(0, heat_size - 1)              # (N, 9)
    iy = torch.floor(py).clamp(0, heat_size - 1)
    inside = (px >= 0) & (px < heat_size) & (py >= 0) & (py < heat_size)
    xs = torch.arange(heat_size, dtype=torch.float32, device=rois.device)
    dx = (xs[None, None, :] - ix[:, :, None]).abs()            # (N, 9, W)
    dy = (xs[None, None, :] - iy[:, :, None]).abs()            # (N, 9, H)
    cross = (((dx[:, :, None, :] <= 1) & (dy[:, :, :, None] == 0))
             | ((dx[:, :, None, :] == 0) & (dy[:, :, :, None] <= 1)))
    return (cross & inside[:, :, None, None]).to(torch.float32)


def grid_refine_boxes(rois: torch.Tensor, heat: torch.Tensor) -> torch.Tensor:
    """Each point's first maximum on its (sigmoid) map, then each box edge
    as the confidence-weighted mean of its three lattice points' positions,
    xmax and ymax at least xmin and ymin. rois (N, 5), heat (N, 9, H, W)
    -> boxes (N, 4)."""
    n, _, hs, ws = heat.shape
    flat = heat.reshape(n, heat.shape[1], hs * ws)
    idx = flat.argmax(-1)                                      # (N, 9)
    score = flat.amax(-1)
    py = torch.div(idx, ws, rounding_mode="floor").to(torch.float32) + 0.5
    px = (idx % ws).to(torch.float32) + 0.5
    x1, y1 = rois[:, 1:2], rois[:, 2:3]
    w = (rois[:, 3:4] - x1).clamp(min=1e-3)
    h = (rois[:, 4:5] - y1).clamp(min=1e-3)
    ax = x1 + px / hs * w
    ay = y1 + py / hs * h
    gxy = _grid_xy(rois.device)

    def edge(vals, mask):
        m = mask.to(torch.float32)[None, :]
        msum = (score * m).sum(-1).clamp(min=1e-6)
        return (vals * score * m).sum(-1) / msum

    xmin = edge(ax, gxy[:, 0] == 0.0)
    xmax = edge(ax, gxy[:, 0] == 1.0)
    ymin = edge(ay, gxy[:, 1] == 0.0)
    ymax = edge(ay, gxy[:, 1] == 1.0)
    return torch.stack([xmin, ymin, torch.maximum(xmax, xmin),
                        torch.maximum(ymax, ymin)], -1)


def grid_bce_loss(heat: torch.Tensor, targets: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """The JAX head's loss: the stable sigmoid BCE of heat (N, 9, H, W)
    logits against targets, the mean over each roi's maps and points
    weighted by `weight` (N,), times 15 over max(sum of weights, 1)."""
    bce = binary_cross_entropy_with_logits(heat, targets)
    return 15.0 * (bce.mean((1, 2, 3)) * weight).sum() \
        / weight.sum().clamp(min=1.0)


class GridRoIHead(StandardRoIHead):

    # rois a pass of the grid head at test time
    chunk = 2048

    def __init__(self, bbox_head: Shared2FCBBoxHead,
                 bbox_roi_extractor: Optional[dict] = None,
                 grid_roi_extractor: Optional[dict] = None,
                 grid_head: Optional[GridHead] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__(bbox_head, bbox_roi_extractor, train_cfg=train_cfg,
                         test_cfg=test_cfg)
        # JAX's `_grid_extract` reads the sizes, sampling ratio and finest
        # scale, and always aligns
        self.grid_extractor = dict(_extractor_cfg(
            grid_roi_extractor or bbox_roi_extractor, 14), aligned=True)
        self.grid_head = grid_head if grid_head is not None else GridHead()

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        self.grid_head.init_weights(generator)

    def grid_extract(self, feats: Sequence[torch.Tensor],
                     rois: torch.Tensor) -> torch.Tensor:
        """rois (R, 5) -> the grid extractor's features (R, C, S, S): one
        RoIAlign call (the kernel on the card)."""
        cfg = self.grid_extractor
        return single_roi_extract(feats[:len(cfg["featmap_strides"])], rois,
                                  **cfg)

    # ---------------------------------------------------------------- train
    def forward_train(self, feats: Sequence[torch.Tensor],
                      proposals: torch.Tensor, prop_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The bbox branch's losses and `loss_grid` (see the module
        note)."""
        out, (boxes, pos_w, gt_idx) = self._forward_train(
            feats, proposals, prop_valid, batch, generator)
        n = boxes.shape[0] * boxes.shape[1]
        dev = boxes.device
        jitter = (torch.rand((n, 4), generator=generator, device=dev)
                  * (2 * JITTER) - JITTER)
        priority = torch.rand((n,), generator=generator, device=dev)
        out["loss_grid"] = self.grid_loss(feats, self._rois(boxes),
                                          pos_w.reshape(-1), gt_idx,
                                          batch["gt_bboxes"], jitter,
                                          priority)
        return out

    def grid_loss(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                  pos_w: torch.Tensor, gt_idx: torch.Tensor,
                  gt_bboxes: torch.Tensor, jitter: torch.Tensor,
                  priority: torch.Tensor) -> torch.Tensor:
        """The grid branch's loss on the sampled rois (n, 5), image-major,
        with their positive weights (n,) and matched gt indices (B, n / B)
        into gt_bboxes (B, G, 4); jitter (n, 4) in [-0.15, 0.15) of each
        roi's width and height (x1, y1, x2, y2), priority (n,) in [0, 1)."""
        boxes = rois[:, 1:5]
        wh = (boxes[:, 2:4] - boxes[:, 0:2]).clamp(min=1.0)
        jrois = torch.cat([rois[:, :1], boxes + jitter * wh.repeat(1, 2)], 1)
        n = jrois.shape[0]
        top = torch.topk(pos_w + priority * 0.01, min(n, MAX_GRID_ROIS))[1]
        sel = jrois[top]
        heat = self.grid_head(self.grid_extract(feats, sel))
        b = gt_bboxes.shape[0]
        img_idx = torch.arange(b, device=rois.device).repeat_interleave(
            n // b)[top]
        matched = gt_bboxes[img_idx, gt_idx.reshape(-1)[top]]
        return grid_bce_loss(heat, grid_targets(sel, matched, heat.shape[-1]),
                             pos_w[top])

    # ----------------------------------------------------------------- test
    @torch.no_grad()
    def grid_refine(self, feats: Sequence[torch.Tensor],
                    rois: torch.Tensor) -> torch.Tensor:
        """rois (R, 5) -> refined boxes (R, 4): one RoIAlign call, then
        the grid head `chunk` rois at a time."""
        crops = self.grid_extract(feats, rois)
        return torch.cat([
            grid_refine_boxes(rois[i:i + self.chunk], torch.sigmoid(
                self.grid_head(crops[i:i + self.chunk])))
            for i in range(0, rois.shape[0], self.chunk)]) \
            if rois.shape[0] else rois.new_zeros((0, 4))

    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False) -> DetResult:
        """The bbox branch's detections with each valid slot's box
        refined by the grid head."""
        dets = super().simple_test(feats, proposals, prop_valid, img_shapes,
                                   scale_factors, rescale)
        rescale = rescale and scale_factors is not None
        b, m = dets.valid.shape
        boxes = dets.bboxes[..., :4]
        if rescale:
            boxes = boxes * scale_factors[:, None, :]
        boxes = boxes.reshape(b * m, 4)
        slots = dets.valid.reshape(-1).nonzero()[:, 0]
        rois = self._rois(boxes.reshape(b, m, 4))[slots]
        refined = boxes.index_copy(0, slots, self.grid_refine(feats, rois))
        refined = refined.reshape(b, m, 4)
        if rescale:
            refined = refined / scale_factors[:, None, :]
        return dets._replace(bboxes=torch.cat([refined, dets.bboxes[..., 4:]],
                                              -1))

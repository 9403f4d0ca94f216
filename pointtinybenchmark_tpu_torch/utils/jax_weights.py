"""Load the JAX package's variables (numpy trees) into a ported model.

The inverse of tools/model_converters/torch2jax.py::
convert_detector_state_dict for the ported modules: flax's names become
mmdet's (`backbone_m/layer1_block0/Conv_0` -> `backbone.layer1.0.conv1`,
the downsample in the block's last Conv_/BatchNorm_ slot (3 in a
bottleneck, 2 in a basic block) -> `downsample.0/1`;
`neck_m/extra_conv{k}` -> `neck.fpn_convs.{n_lateral+k}`;
`bbox_head_m/cls_conv{i}/Conv_0` -> `bbox_head.cls_convs.{i}.conv`;
`rpn_head_m/rpn_conv` -> `rpn_head.rpn_conv`; `roi_head_m/bbox_head_m/
shared_fc{i}` -> `roi_head.bbox_head.shared_fcs.{i}`; `roi_head_m/
mask_head_m/conv{i}` -> `roi_head.mask_head.convs.{i}.conv`, `upsample` and
`conv_logits` keep their names), conv kernels go HWIO -> OIHW, dense
kernels (in, out) -> Linear weights (out, in), and BN (scale, bias, mean,
var) go to (weight, bias, running_mean, running_var). The mask head's
transposed convolution is the exception among the 4-d kernels: flax's
`ConvTranspose` kernel is (kh, kw, in, out) with its taps indexed in the
opposite order to `nn.ConvTranspose2d`'s (in, out, kh, kw), so it is
flipped in both spatial axes as well.
The first shared FC also has its input rows permuted: the JAX head
flattens (S, S, C) RoI features as (h, w, c), the port's (C, S, S) ones as
(c, h, w) (the inverse of tools/model_converters/torch2jax.py). Every leaf
of the trees must be used and every entry of the model's state_dict
filled; BN's `num_batches_tracked` has no JAX counterpart and is left as
it is.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.backbones.resnet import BasicBlock

__all__ = ["load_jax_variables", "jax_to_state_dict"]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _backbone_module(scope: Tuple[str, ...],
                     basic: bool = False) -> Optional[str]:
    """('Conv_0',) -> 'conv1'; ('layer2_block0', 'BatchNorm_3') ->
    'layer2.0.downsample.1' (`basic`: 'BatchNorm_2')."""
    if len(scope) == 1:
        m = re.fullmatch(r"(Conv|BatchNorm)_0", scope[0])
        return None if m is None else ("conv1" if m[1] == "Conv" else "bn1")
    if len(scope) != 2:
        return None
    blk = re.fullmatch(r"layer(\d+)_block(\d+)", scope[0])
    layer = re.fullmatch(r"(Conv|BatchNorm)_(\d)", scope[1])
    if blk is None or layer is None:
        return None
    k = int(layer[2])
    down = 2 if basic else 3
    base = f"layer{blk[1]}.{blk[2]}"
    if k < down:
        return f"{base}.{'conv' if layer[1] == 'Conv' else 'bn'}{k + 1}"
    if k == down:
        return f"{base}.downsample.{0 if layer[1] == 'Conv' else 1}"
    return None


def _torch_key(path: Tuple[str, ...], n_lateral: int,
               basic: bool = False) -> Optional[str]:
    top, *scope, leaf = path
    if top == "backbone_m":
        mod = _backbone_module(tuple(scope), basic)
        if mod is None:
            return None
        if leaf == "kernel":
            return f"backbone.{mod}.weight"
        return f"backbone.{mod}.{_BN[leaf]}" if leaf in _BN else None
    name = {"kernel": "weight", "bias": "bias"}.get(leaf)
    if name is None:
        return None
    if top == "neck_m" and len(scope) == 1:
        m = re.fullmatch(r"(lateral|fpn|extra)_conv(\d+)", scope[0])
        if m is None:
            return None
        i = int(m[2]) + (n_lateral if m[1] == "extra" else 0)
        group = "lateral_convs" if m[1] == "lateral" else "fpn_convs"
        return f"neck.{group}.{i}.conv.{name}"
    if top == "rpn_head_m" and len(scope) == 1 and scope[0] in (
            "rpn_conv", "rpn_cls", "rpn_reg"):
        return f"rpn_head.{scope[0]}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and scope[0] == "mask_head_m":
        m = re.fullmatch(r"conv(\d+)|upsample|conv_logits", scope[1])
        if m is None:
            return None
        mod = f"convs.{m[1]}.conv" if m[1] is not None else scope[1]
        return f"roi_head.mask_head.{mod}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and scope[0] == "bbox_head_m":
        m = re.fullmatch(r"shared_fc(\d+)|fc_cls|fc_reg", scope[1])
        if m is None:
            return None
        mod = f"shared_fcs.{m[1]}" if m[1] is not None else scope[1]
        return f"roi_head.bbox_head.{mod}.{name}"
    if top == "bbox_head_m":
        if len(scope) == 2 and scope[1] == "Conv_0":
            m = re.fullmatch(r"(cls|reg)_conv(\d+)", scope[0])
            return None if m is None else \
                f"bbox_head.{m[1]}_convs.{m[2]}.conv.{name}"
        if len(scope) == 1 and scope[0] in ("retina_cls", "retina_reg",
                                            "conv_cls", "conv_reg"):
            return f"bbox_head.{scope[0]}.{name}"
    return None


def jax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None,
                      roi_feat_size: int = 7,
                      basic_blocks: bool = False) -> Dict[str, torch.Tensor]:
    """Flax trees -> {mmdet name: tensor}. `roi_feat_size` is the RoI
    head's S (the first shared FC's input is S * S * C); `basic_blocks`
    says that the backbone is a ResNet-18/34. Raises on any leaf it cannot
    place."""
    n_lateral = sum(1 for k in params.get("neck_m", {})
                    if str(k).startswith("lateral_conv"))
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for tree in (params, batch_stats or {}):
        for path, val in _leaves(tree):
            key = _torch_key(path, n_lateral, basic_blocks)
            if key is None or key in out:
                unused.append("/".join(path))
                continue
            arr = np.array(val, np.float32)
            if path[-1] == "kernel" and path[-2] == "upsample":
                # flax ConvTranspose (kh, kw, in, out), taps the other way
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif path[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            elif path[-1] == "kernel" and path[-2] == "shared_fc0":
                s = roi_feat_size                        # rows (h, w, c)
                arr = arr.reshape(s, s, -1, arr.shape[1]).transpose(
                    3, 2, 0, 1).reshape(arr.shape[1], -1)  # (out, c*h*w)
            elif path[-1] == "kernel":
                arr = arr.T                              # (in, out) -> (out, in)
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if unused:
        raise KeyError(f"{len(unused)} JAX leaves not consumed: {unused[:8]}")
    return out


def load_jax_variables(model: torch.nn.Module, params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> None:
    """Copy JAX variables into `model` in place."""
    roi_head = getattr(model, "roi_head", None)
    sd = jax_to_state_dict(params, batch_stats,
                           roi_head.bbox_head.roi_feat_size if roi_head
                           is not None else 7,
                           any(isinstance(m, BasicBlock)
                               for m in model.modules()))
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=False)

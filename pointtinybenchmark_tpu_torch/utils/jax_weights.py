"""Load the JAX package's variables (numpy trees) into a ported model.

The inverse of tools/model_converters/torch2jax.py::
convert_detector_state_dict for the ported modules: flax's names become
mmdet's (`backbone_m/layer1_block0/Conv_0` -> `backbone.layer1.0.conv1`,
the downsample in the block's last Conv_/BatchNorm_ slot (3 in a
bottleneck, 2 in a basic block) -> `downsample.0/1`;
`neck_m/extra_conv{k}` -> `neck.fpn_convs.{n_lateral+k}`;
`bbox_head_m/cls_conv{i}/Conv_0` -> `bbox_head.cls_convs.{i}.conv` and its
`GroupNorm_0` (scale, bias) -> `bbox_head.cls_convs.{i}.gn` (weight, bias),
likewise `reg_conv{i}` (FoveaHead's, without a norm, have a biased
`Conv_0` only); the point heads' `cls_out`, `reg_out` (P2P's
convolutions) and `ins_out` (CPR's dense layers) keep their names;
P2BNet's `bbox_head_m/stage{s}_shared_fc{i}`, `stage{s}_cls` and
`stage{s}_ins` -> `bbox_head.stages.{s}.shared_fcs.{i}`, `.cls`, `.ins`;
the dense heads' output convs keep their names (FCOS's and FoveaHead's
`conv_cls`, `conv_reg`, FCOS's `conv_centerness`; RetinaHead's and
FreeAnchor's `retina_cls`, `retina_reg`; ATSS's `atss_cls`, `atss_reg`,
`atss_centerness`; RepPoints' `pts_init_conv`, `pts_init_out`, `cls_dcn`,
`cls_out`, `refine_dcn`, `pts_refine_out`, whose 1x1 `cls_dcn` /
`refine_dcn` kernels (1, 1, 9 C, out) read the gathered taps tap-major,
channel-minor, the port's order too; VFNet's `vfnet_reg`,
`reg_refine_dcn`, `vfnet_reg_refine`, `cls_dcn`, `vfnet_cls`, its 1x1
kernels in the same tap order), FCOS's `scale{i}/scale` ->
`bbox_head.scales.{i}.scale`, VFNet's `scale_refine{i}/scale` ->
`bbox_head.scales_refine.{i}.scale` and RepPoints' `moment_transfer` ->
`bbox_head.moment_transfer`;
`rpn_head_m/rpn_conv` -> `rpn_head.rpn_conv`; `roi_head_m/bbox_head_m/
shared_fc{i}` -> `roi_head.bbox_head.shared_fcs.{i}` (a cascade's
`roi_head_m/bbox_heads_{s}/shared_fc{i}`, `fc_cls`, `fc_reg` ->
`roi_head.bbox_head.{s}.shared_fcs.{i}`, ...); `roi_head_m/
mask_head_m/conv{i}` -> `roi_head.mask_head.convs.{i}.conv`, `upsample` and
`conv_logits` keep their names; `roi_head_m/grid_head_m/X` -> `roi_head.
grid_head.X` for every Grid R-CNN layer, `GroupNorm_{i}` (scale, bias) as
`gn{i}` (weight, bias)); HTC's and SCNet's `roi_head_m/mask_heads_{i}/
conv{k}` -> `roi_head.mask_head.{i}.convs.{k}.conv` (`conv_res`,
`upsample` and `conv_logits` keep their names), `semantic_head_m/
lateral{i}` and `conv{i}` -> `roi_head.semantic_head.lateral_convs.{i}`
and `.convs.{i}`, `glbctx_head_m/conv{i}` -> `roi_head.glbctx_head.
convs.{i}`, and `conv_embedding`, `conv_logits`, `fc`, `glbctx_proj`,
`relay_conv` keep theirs; a DetectoRS backbone's `stem_conv`, `stem_bn`
and `layer{i}_block{j}/X` -> `backbone.stem_conv`, ...,
`backbone.layer{i}.{j}.X` (SAC's `conv2_sac/weight`, `weight_gamma`,
`weight_beta`, `weight_diff` keep their names; gamma and beta (1, 1, 1, O)
become (O, 1, 1, 1)), and the RFP's `neck_m/fpn/X` -> `neck.fpn.` as an
FPN's, `rfp_weight`, `rfp_aspp/aspp{i}` and `rfp_backbone{k}/...` (a
DetectoRS backbone) under `neck.`; conv kernels go HWIO -> OIHW, dense
kernels (in, out) -> Linear weights (out, in), and BN (scale, bias, mean,
var) go to (weight, bias, running_mean, running_var). The transposed
convolutions (the mask head's `upsample`, the grid head's `deconv1_{k}`
and `deconv2_{k}`) are the exception among the 4-d kernels: flax's
`ConvTranspose` kernel is (kh, kw, in, out) with its taps indexed in the
opposite order to `nn.ConvTranspose2d`'s (in, out, kh, kw), so it is
flipped in both spatial axes as well.
The first shared FC (of the RoI head, and of each P2BNet stage) also has
its input rows permuted: the JAX heads flatten (S, S, C) RoI features as
(h, w, c), the port's (C, S, S) ones as (c, h, w) (the inverse of
tools/model_converters/torch2jax.py). Every leaf
of the trees must be used and every entry of the model's state_dict
filled; BN's `num_batches_tracked` has no JAX counterpart and is left as
it is. `jax_params_like` maps a tree of the params' layout (an optax
momentum trace or moment) the same way. `jax_param_paths` is the inverse
for a model's parameters: each one's flax path, held to give the
parameter's name back through the same map (the optimizer's
`paramwise_cfg` classifies parameters by it).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.backbones.detectors_resnet import DetectoRS_ResNet
from ..models.backbones.resnet import BasicBlock

__all__ = ["load_jax_variables", "jax_to_state_dict", "jax_param_paths",
           "jax_params_like", "roi_feat_size"]

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


_SAC_LEAVES = ("weight", "weight_gamma", "weight_beta", "weight_diff")
_DETECTORS_LAYER = re.compile(
    r"conv[123]|bn[123]|conv2_sac|downsample_(conv|bn)|rfp_conv")


def _detectors_module(scope: Tuple[str, ...]) -> Optional[str]:
    """A DetectoRS_ResNet's flax scope -> the port's module path:
    ('stem_bn',) -> 'stem_bn'; ('layer2_block0', 'conv2_sac', 'switch')
    -> 'layer2.0.conv2_sac.switch'."""
    if scope in (("stem_conv",), ("stem_bn",)):
        return scope[0]
    if len(scope) not in (2, 3):
        return None
    blk = re.fullmatch(r"layer(\d+)_block(\d+)", scope[0])
    if blk is None or not _DETECTORS_LAYER.fullmatch(scope[1]):
        return None
    if len(scope) == 3 and (scope[1] != "conv2_sac" or scope[2] not in (
            "pre_context", "switch", "post_context")):
        return None
    return ".".join((f"layer{blk[1]}.{blk[2]}",) + scope[1:])


def _detectors_key(prefix: str, scope: Tuple[str, ...],
                   leaf: str) -> Optional[str]:
    """A DetectoRS_ResNet leaf at `scope` -> its port name under
    `prefix`: BN's scale, bias, mean and var, a conv's kernel and bias,
    SAC's own weights under their names."""
    mod = _detectors_module(scope)
    if mod is None:
        return None
    if mod.endswith("conv2_sac"):
        name = leaf if leaf in _SAC_LEAVES else None
    elif leaf == "kernel":
        name = "weight"
    else:
        name = _BN.get(leaf)
    return None if name is None else f"{prefix}.{mod}.{name}"


def _torch_key(path: Tuple[str, ...], n_lateral: int,
               basic: bool = False) -> Optional[str]:
    top, *scope, leaf = path
    if top == "backbone_m":
        mod = _backbone_module(tuple(scope), basic)
        if mod is None:
            return _detectors_key("backbone", tuple(scope), leaf)
        if leaf == "kernel":
            return f"backbone.{mod}.weight"
        return f"backbone.{mod}.{_BN[leaf]}" if leaf in _BN else None
    if top == "neck_m" and scope and scope[0].startswith("rfp_backbone"):
        return _detectors_key(f"neck.{scope[0]}", tuple(scope[1:]), leaf)
    if top == "bbox_head_m" and not scope and leaf == "moment_transfer":
        return "bbox_head.moment_transfer"
    if top == "bbox_head_m" and len(scope) == 1 and leaf == "scale":
        m = re.fullmatch(r"scale(_refine)?(\d+)", scope[0])
        return None if m is None else \
            f"bbox_head.scales{m[1] or ''}.{m[2]}.scale"
    name = {"kernel": "weight", "bias": "bias", "scale": "weight"}.get(leaf)
    if name is None:
        return None
    if top == "roi_head_m" and len(scope) == 2 and scope[0] == "grid_head_m":
        m = re.fullmatch(r"GroupNorm_(\d+)", scope[1])
        if m is not None:
            return f"roi_head.grid_head.gn{m[1]}.{name}"
        if leaf == "scale" or not re.fullmatch(
                r"conv\d+|point_feat\d+|fuse\d+_\d+|deconv[12]_\d+",
                scope[1]):
            return None
        return f"roi_head.grid_head.{scope[1]}.{name}"
    if top == "bbox_head_m" and len(scope) == 2 and \
            scope[1] in ("Conv_0", "GroupNorm_0"):
        m = re.fullmatch(r"(cls|reg)_conv(\d+)", scope[0])
        leaves = ("kernel", "bias") if scope[1] == "Conv_0" else ("scale",
                                                                   "bias")
        if m is None or leaf not in leaves:
            return None
        mod = "conv" if scope[1] == "Conv_0" else "gn"
        return f"bbox_head.{m[1]}_convs.{m[2]}.{mod}.{name}"
    if leaf == "scale":
        return None
    if top == "neck_m" and (scope == ["rfp_weight"] or (
            len(scope) == 2 and scope[0] == "rfp_aspp"
            and re.fullmatch(r"aspp\d+", scope[1]))):
        return f"neck.{'.'.join(scope)}.{name}"
    neck = "neck"
    if top == "neck_m" and len(scope) == 2 and scope[0] == "fpn":
        neck, scope = "neck.fpn", scope[1:]         # RFP's shared FPN
    if top == "neck_m" and len(scope) == 1:
        m = re.fullmatch(r"(lateral|fpn|extra)_conv(\d+)", scope[0])
        if m is None:
            return None
        i = int(m[2]) + (n_lateral if m[1] == "extra" else 0)
        group = "lateral_convs" if m[1] == "lateral" else "fpn_convs"
        return f"{neck}.{group}.{i}.conv.{name}"
    if top == "rpn_head_m" and len(scope) == 1 and scope[0] in (
            "rpn_conv", "rpn_cls", "rpn_reg"):
        return f"rpn_head.{scope[0]}.{name}"
    if top == "roi_head_m" and scope in (["glbctx_proj"], ["relay_conv"]):
        return f"roi_head.{scope[0]}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and scope[0] in (
            "semantic_head_m", "glbctx_head_m"):
        m = re.fullmatch(r"(lateral|conv)(\d+)|conv_embedding|conv_logits|fc",
                         scope[1])
        if m is None:
            return None
        mod = (f"{'lateral_convs' if m[1] == 'lateral' else 'convs'}.{m[2]}"
               if m[1] is not None else scope[1])
        return f"roi_head.{scope[0][:-2]}.{mod}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and re.fullmatch(
            r"mask_heads_\d+", scope[0]):
        m = re.fullmatch(r"conv(\d+)|conv_res|upsample|conv_logits", scope[1])
        if m is None:
            return None
        mod = f"convs.{m[1]}.conv" if m[1] is not None else scope[1]
        return f"roi_head.mask_head.{scope[0][11:]}.{mod}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and scope[0] == "mask_head_m":
        m = re.fullmatch(r"conv(\d+)|upsample|conv_logits", scope[1])
        if m is None:
            return None
        mod = f"convs.{m[1]}.conv" if m[1] is not None else scope[1]
        return f"roi_head.mask_head.{mod}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and re.fullmatch(
            r"bbox_heads_\d+", scope[0]):
        m = re.fullmatch(r"shared_fc(\d+)|fc_cls|fc_reg", scope[1])
        if m is None:
            return None
        mod = f"shared_fcs.{m[1]}" if m[1] is not None else scope[1]
        return f"roi_head.bbox_head.{scope[0][11:]}.{mod}.{name}"
    if top == "roi_head_m" and len(scope) == 2 and scope[0] == "bbox_head_m":
        m = re.fullmatch(r"shared_fc(\d+)|fc_cls|fc_reg", scope[1])
        if m is None:
            return None
        mod = f"shared_fcs.{m[1]}" if m[1] is not None else scope[1]
        return f"roi_head.bbox_head.{mod}.{name}"
    if top == "bbox_head_m" and len(scope) == 1:
        m = re.fullmatch(r"stage(\d+)_(?:shared_fc(\d+)|(cls|ins))",
                         scope[0])
        if m is not None:
            mod = f"shared_fcs.{m[2]}" if m[2] is not None else m[3]
            return f"bbox_head.stages.{m[1]}.{mod}.{name}"
    if top == "bbox_head_m" and len(scope) == 1 and scope[0] in (
            "retina_cls", "retina_reg", "conv_cls", "conv_reg", "cls_out",
            "reg_out", "ins_out", "conv_centerness", "atss_cls", "atss_reg",
            "atss_centerness", "pts_init_conv", "pts_init_out", "cls_dcn",
            "refine_dcn", "pts_refine_out", "vfnet_reg", "reg_refine_dcn",
            "vfnet_reg_refine", "vfnet_cls"):
        return f"bbox_head.{scope[0]}.{name}"
    return None


def _detectors_scope(rest: List[str]) -> Tuple[str, ...]:
    """The inverse of `_detectors_module`."""
    if len(rest) == 1:
        return tuple(rest)
    return (f"{rest[0]}_block{rest[1]}",) + tuple(rest[2:])


def _jax_module(parts: List[str], n_lateral: int, basic: bool,
                detectors: bool = False) -> Optional[Tuple[str, ...]]:
    """The flax scope of a port module path (its name split at dots):
    the inverse of `_torch_key`'s module rules; `detectors` says that the
    backbone is a DetectoRS_ResNet."""
    top, rest = parts[0], parts[1:]
    if top == "backbone" and detectors:
        return ("backbone_m",) + _detectors_scope(rest)
    if top == "neck" and rest and rest[0].startswith("rfp_backbone"):
        return ("neck_m", rest[0]) + _detectors_scope(rest[1:])
    if top == "neck" and rest and rest[0] in ("rfp_weight", "rfp_aspp"):
        return ("neck_m",) + tuple(rest)
    if top == "neck" and rest and rest[0] == "fpn":
        scope = _jax_module(["neck"] + rest[1:], n_lateral, basic)
        return None if scope is None else ("neck_m", "fpn") + scope[1:]
    if top == "backbone":
        if rest in (["conv1"], ["bn1"]):
            return ("backbone_m",
                    "Conv_0" if rest[0] == "conv1" else "BatchNorm_0")
        if len(rest) < 3:
            return None
        blk = f"{rest[0]}_block{rest[1]}"
        m = re.fullmatch(r"(conv|bn)(\d)", rest[2])
        if m is not None and len(rest) == 3:
            kind = "Conv" if m[1] == "conv" else "BatchNorm"
            return ("backbone_m", blk, f"{kind}_{int(m[2]) - 1}")
        if rest[2] == "downsample" and len(rest) == 4:
            kind = "Conv" if rest[3] == "0" else "BatchNorm"
            return ("backbone_m", blk, f"{kind}_{2 if basic else 3}")
        return None
    if top == "neck" and len(rest) == 3 and rest[2] == "conv":
        i = int(rest[1])
        if rest[0] == "lateral_convs":
            return ("neck_m", f"lateral_conv{i}")
        return ("neck_m", f"fpn_conv{i}" if i < n_lateral
                else f"extra_conv{i - n_lateral}")
    if top == "bbox_head":
        if len(rest) == 3 and rest[0] in ("cls_convs", "reg_convs"):
            return ("bbox_head_m", f"{rest[0][:3]}_conv{rest[1]}",
                    "Conv_0" if rest[2] == "conv" else "GroupNorm_0")
        if len(rest) == 2 and rest[0] in ("scales", "scales_refine"):
            return ("bbox_head_m", f"scale{rest[0][6:]}{rest[1]}")
        if len(rest) >= 3 and rest[0] == "stages":
            sub = (f"shared_fc{rest[3]}" if rest[2] == "shared_fcs"
                   else rest[2])
            return ("bbox_head_m", f"stage{rest[1]}_{sub}")
        return ("bbox_head_m",) + tuple(rest)
    if top == "rpn_head":
        return ("rpn_head_m",) + tuple(rest)
    if top == "roi_head" and len(rest) == 2 and rest[0] == "grid_head":
        m = re.fullmatch(r"gn(\d+)", rest[1])
        return ("roi_head_m", "grid_head_m",
                f"GroupNorm_{m[1]}" if m is not None else rest[1])
    if top == "roi_head" and len(rest) >= 3 and rest[0] == "bbox_head" \
            and rest[1].isdigit():
        sub = f"shared_fc{rest[3]}" if rest[2] == "shared_fcs" else rest[2]
        return ("roi_head_m", f"bbox_heads_{rest[1]}", sub)
    if top == "roi_head" and len(rest) >= 3 and rest[0] == "mask_head" \
            and rest[1].isdigit():
        sub = f"conv{rest[3]}" if rest[2] == "convs" else rest[2]
        return ("roi_head_m", f"mask_heads_{rest[1]}", sub)
    if top == "roi_head" and len(rest) == 3 and rest[1] == "lateral_convs":
        return ("roi_head_m", rest[0] + "_m", f"lateral{rest[2]}")
    if top == "roi_head" and len(rest) == 1:
        return ("roi_head_m", rest[0])
    if top == "roi_head" and len(rest) >= 2:
        head = rest[0] + "_m"
        if rest[1] in ("shared_fcs", "convs"):
            stem = "shared_fc" if rest[1] == "shared_fcs" else "conv"
            return ("roi_head_m", head, f"{stem}{rest[2]}")
        return ("roi_head_m", head, rest[1])
    return None


def jax_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: its JAX twin's flax path, dot-joined}, e.g.
    `bbox_head.cls_convs.0.gn.bias` -> `bbox_head_m.cls_conv0.GroupNorm_0.
    bias`. Raises if a path does not map back to its name."""
    neck = getattr(model, "neck", None)
    fpn = getattr(neck, "fpn", neck)
    n_lateral = len(fpn.lateral_convs) if fpn is not None else 0
    basic = any(isinstance(m, BasicBlock) for m in model.modules())
    detectors = isinstance(getattr(model, "backbone", None),
                           DetectoRS_ResNet)
    out = {}
    for name, _ in model.named_parameters():
        *mod, leaf = name.split(".")
        if mod == ["bbox_head"] and leaf == "moment_transfer":
            path: Optional[Tuple[str, ...]] = ("bbox_head_m", leaf)
        else:
            scope = (_jax_module(mod, n_lateral, basic, detectors)
                     if mod else None)
            norm = scope is not None and re.fullmatch(
                r"(BatchNorm|GroupNorm)_\d+|(stem_|downsample_)?bn\d?",
                scope[-1]) is not None
            jleaf = {"weight": "scale" if norm else "kernel",
                     "bias": "bias", "scale": "scale"}.get(leaf)
            if scope is not None and scope[-1] == "conv2_sac":
                jleaf = leaf
            path = None if scope is None or jleaf is None else \
                scope + (jleaf,)
        if path is None or _torch_key(path, n_lateral, basic) != name:
            raise KeyError(f"{name}: no JAX path maps back to it ({path})")
        out[name] = ".".join(path)
    return out


def jax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None,
                      roi_feat_size: int = 7,
                      basic_blocks: bool = False) -> Dict[str, torch.Tensor]:
    """Flax trees -> {mmdet name: tensor}. `roi_feat_size` is the RoI
    head's S, or P2BNet's `roi_size` (the first shared FC's input is
    S * S * C); `basic_blocks`
    says that the backbone is a ResNet-18/34. Raises on any leaf it cannot
    place."""
    n_lateral = sum(1 for k in _fpn_scope(params.get("neck_m", {}))
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
            if path[-1] == "kernel" and re.fullmatch(
                    r"upsample|deconv[12]_\d+", path[-2]):
                # flax ConvTranspose (kh, kw, in, out), taps the other way
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif path[-1] in ("kernel",) + _SAC_LEAVES and arr.ndim == 4:
                # HWIO -> OIHW; SAC's gamma and beta (1, 1, 1, O) likewise
                arr = arr.transpose(3, 2, 0, 1)
            elif path[-1] == "kernel" and re.fullmatch(
                    r"(stage\d+_)?shared_fc0", path[-2]):
                s = roi_feat_size                        # rows (h, w, c)
                arr = arr.reshape(s, s, -1, arr.shape[1]).transpose(
                    3, 2, 0, 1).reshape(arr.shape[1], -1)  # (out, c*h*w)
            elif path[-1] == "kernel":
                arr = arr.T                              # (in, out) -> (out, in)
            out[key] = torch.from_numpy(np.array(arr, order="C"))  # keeps 0-d
    if unused:
        raise KeyError(f"{len(unused)} JAX leaves not consumed: {unused[:8]}")
    return out


def _fpn_scope(neck: Mapping) -> Mapping:
    """The neck's FPN scope: RFP's shared `fpn`, else the neck's own."""
    return neck.get("fpn", neck)


def roi_feat_size(model: torch.nn.Module) -> int:
    """The S of the model's RoI bbox head (every stage's, in a cascade),
    or P2BNet's `roi_size`: the first shared FC takes S * S * C."""
    roi_head = getattr(model, "roi_head", None)
    if roi_head is None:
        return getattr(getattr(model, "bbox_head", None), "roi_size", 7)
    return getattr(roi_head, "roi_feat_size", None) or \
        roi_head.bbox_head.roi_feat_size


def _model_state_dict(model: torch.nn.Module, params: Mapping,
                      batch_stats: Optional[Mapping]
                      ) -> Dict[str, torch.Tensor]:
    """`jax_to_state_dict` with the model's RoI size and block kind."""
    return jax_to_state_dict(params, batch_stats, roi_feat_size(model),
                             any(isinstance(m, BasicBlock)
                                 for m in model.modules()))


def _check_against(sd: Mapping[str, torch.Tensor],
                   own: Mapping[str, torch.Tensor]) -> None:
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")


def load_jax_variables(model: torch.nn.Module, params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> None:
    """Copy JAX variables into `model` in place."""
    sd = _model_state_dict(model, params, batch_stats)
    _check_against(sd, {k: v for k, v in model.state_dict().items()
                        if not k.endswith("num_batches_tracked")})
    model.load_state_dict(sd, strict=False)


def jax_params_like(model: torch.nn.Module, tree: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """A tree of the JAX params' layout (an optax momentum trace or
    moment) -> {parameter name: tensor in the parameter's layout}, through
    the same transposes and permutations as the params; every parameter
    of `model` must be filled."""
    sd = _model_state_dict(model, tree, None)
    _check_against(sd, dict(model.named_parameters()))
    return sd

"""Optimizer and learning-rate schedule from mmdet-style configs.

Counterpart of pointtinybenchmark_tpu/engine/optimizer.py
(`build_lr_schedule`, `build_optimizer` for SGD and Adam,
`frozen_param_mask`). The
JAX optimizer is an optax chain, and `SGD` here applies the same steps in
the same order, so that a run can be held against it:

1. with `grad_clip`, clip by the global norm of all the gradients, frozen
   parameters' included, in optax's form: g unchanged if the norm is below
   max_norm, else (g / norm) * max_norm (not `clip_grad_norm_`'s
   max_norm / (norm + 1e-6));
2. add weight decay, g + wd * p, to every parameter;
3. the momentum trace t = g + momentum * t;
4. the update -lr(count) * t, count being the number of updates applied so
   far (optax's step count, from 0);
5. frozen parameters (the backbone stem and stages 1..frozen_stages, by
   JAX's names: `frozen_param_names`) are not updated at all.

Frozen parameters therefore keep requires_grad=True: their gradients are
computed and count in the clipping norm, as in the JAX package (mmcv would
clip only the parameters that require grad). Everything runs on the
parameters' device with no host sync: `step(ok)` takes a 0-d bool tensor
and, where it is False, leaves parameters, traces and the count as they
were. `Adam` is optax.adam in the same chain (its class note).

SGD's `paramwise_cfg` (JAX `_build_paramwise` / `_paramwise_mults_fn`,
mmcv DefaultOptimizerConstructor's rules) gives each parameter an lr_mult
and a decay_mult: step 2 adds wd * decay_mult * p, and step 4 scales the
trace by lr_mult before the -lr(count). The rule reads the parameter's
JAX twin's flax path (`utils/jax_weights.py::jax_param_paths`), as the
JAX package does: the longest custom key that is a substring of it, else
a norm leaf (a path with "batchnorm", "groupnorm", "layernorm", ".norm"
or "_bn", lower-cased) gets norm_decay_mult, else a leaf ending in "bias"
gets the bias mults. So a GroupNorm's bias is a norm leaf and FCOS's
`Scale` neither. Nesterov momentum, AdamW, Adam's weight decay and Adam's
`paramwise_cfg` are not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..utils import jax_weights

__all__ = ["build_lr_schedule", "build_optimizer", "frozen_param_names",
           "paramwise_mults", "SGD", "Adam"]


def build_lr_schedule(base_lr: float, lr_config: Optional[dict],
                      iters_per_epoch: int, max_epochs: int,
                      by_epoch: bool = True
                      ) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """step -> lr, a float32 tensor on the step's device (mmcv's step and
    cosine policies, linear or constant warmup). With `by_epoch=False`
    (IterBasedRunner) the `step` boundaries are iterations."""
    lr_config = dict(lr_config or {})
    policy = lr_config.get("policy", "fixed")
    warmup = lr_config.get("warmup")
    warmup_iters = int(lr_config.get("warmup_iters", 500))
    warmup_ratio = float(lr_config.get("warmup_ratio", 0.1))
    gamma = float(lr_config.get("gamma", 0.1))
    steps: Sequence[int] = lr_config.get("step", [])
    min_lr = lr_config.get("min_lr")

    def schedule(step):
        step = torch.as_tensor(step)
        one = torch.ones((), dtype=torch.float32, device=step.device)
        if policy == "step":
            ref = (torch.div(step, max(iters_per_epoch, 1),
                             rounding_mode="floor") if by_epoch else step)
            mult = one
            for s in steps:
                mult = mult * torch.where(ref >= s, gamma, 1.0)
            lr = base_lr * mult
        elif policy in ("cosine", "CosineAnnealing"):
            total = max(iters_per_epoch * max_epochs, 1)
            frac = (step / total).clamp(0, 1)
            floor = min_lr if min_lr is not None else 0.0
            lr = floor + (base_lr - floor) * 0.5 * (1 + torch.cos(math.pi
                                                                  * frac))
        else:
            lr = base_lr * one
        if warmup == "linear":
            k = (step / max(warmup_iters, 1)).clamp(0, 1)
            warm = base_lr * (warmup_ratio + (1 - warmup_ratio) * k)
            lr = torch.where(step < warmup_iters, torch.minimum(warm, lr), lr)
        elif warmup == "constant":
            lr = torch.where(step < warmup_iters, base_lr * warmup_ratio * one,
                             lr)
        return lr

    return schedule


def frozen_param_names(model: nn.Module, frozen_stages: int) -> List[str]:
    """Names of the parameters `frozen_stages` freezes (mmdet
    ResNet._freeze_stages by the names JAX's `frozen_param_mask` reads):
    with frozen_stages >= 0 the ResNet's stem (`backbone.conv1`,
    `backbone.bn1`, JAX's `Conv_0` / `BatchNorm_0`), and the backbone's
    stages `backbone.layer1` .. `backbone.layer{frozen_stages}`. As in
    JAX, a DetectoRS backbone's `stem_conv` / `stem_bn` and the RFP's
    feedback backbone under the neck stay trainable."""
    if frozen_stages < 0:
        return []
    prefixes = ["backbone.conv1.", "backbone.bn1."] + [
        f"backbone.layer{s}." for s in range(1, frozen_stages + 1)]
    return [n for n, _ in model.named_parameters()
            if any(n.startswith(p) for p in prefixes)]


PARAMWISE_KEYS = ("custom_keys", "bias_lr_mult", "bias_decay_mult",
                  "norm_decay_mult")
NORM_TAGS = ("batchnorm", "groupnorm", "layernorm", ".norm", "_bn")


def paramwise_mults(model: nn.Module, paramwise_cfg: dict
                    ) -> Dict[str, Tuple[float, float]]:
    """{parameter name: (lr_mult, decay_mult)} by the JAX package's rule on
    each parameter's flax path (see the module note)."""
    unknown = sorted(set(paramwise_cfg) - set(PARAMWISE_KEYS))
    if unknown:
        raise NotImplementedError(f"paramwise_cfg keys {unknown} are not "
                                  f"ported (the port takes {PARAMWISE_KEYS})")
    custom = {k: dict(v) for k, v in
              (paramwise_cfg.get("custom_keys") or {}).items()}
    keys = sorted(custom, key=len, reverse=True)
    bias = (float(paramwise_cfg.get("bias_lr_mult", 1.0)),
            float(paramwise_cfg.get("bias_decay_mult", 1.0)))
    norm = (1.0, float(paramwise_cfg.get("norm_decay_mult", 1.0)))

    def mults(path: str) -> Tuple[float, float]:
        for k in keys:
            if k in path:
                return (float(custom[k].get("lr_mult", 1.0)),
                        float(custom[k].get("decay_mult", 1.0)))
        if any(t in path.lower() for t in NORM_TAGS):
            return norm
        return bias if path.endswith("bias") else (1.0, 1.0)
    return {n: mults(p) for n, p in jax_weights.jax_param_paths(model).items()}


class _ClippedOptimizer:
    """What SGD and Adam share: the parameters by name, the frozen ones,
    the schedule, the update count, and optax's global-norm clipping."""

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 max_norm: Optional[float], frozen: Sequence[str]):
        self.names = [n for n, _ in params]
        self.params = [p for _, p in params]
        frozen = set(frozen)
        unknown = frozen - set(self.names)
        if unknown:
            raise KeyError(f"frozen names not among the parameters: "
                           f"{sorted(unknown)[:4]}")
        self.is_frozen = [n in frozen for n, _ in params]
        self.trainable = [p for n, p in params if n not in frozen]
        self.schedule = schedule
        self.max_norm = max_norm
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)

    @staticmethod
    def _grads(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in params]

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm over every parameter's gradient,
        frozen ones included: g, or (g / norm) * max_norm above max_norm."""
        if self.max_norm is None:
            return grads
        norms = torch._foreach_norm(self._grads(self.params))
        norm = torch.stack(norms).square().sum().sqrt()
        under = norm < self.max_norm
        grads = torch._foreach_div(grads, torch.where(under, 1.0, norm))
        return torch._foreach_mul(grads, torch.where(
            under, 1.0, torch.full_like(norm, self.max_norm)))

    def lr(self) -> torch.Tensor:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def _load_count(self, slots: Dict[str, list], n: int) -> None:
        """The optax chain's `n` update counts, which must agree: the
        schedule's counts accepted updates only (a non-finite step keeps
        the old state), as `count` here does."""
        counts = slots["count"]
        if len(counts) != n or len(set(counts)) != 1:
            raise ValueError(f"{type(self).__name__} expects {n} equal optax "
                             f"counts, found {counts} (layout "
                             f"{slots['layout']})")
        self.count.fill_(counts[0])


class SGD(_ClippedOptimizer):
    """SGD with momentum and weight decay in optax's order (see the module
    note). `params` are (name, parameter) pairs; the gradients are read from
    each parameter's `.grad` (None counts as zero) and left untouched.
    `mults` gives a parameter's (lr_mult, decay_mult), 1 where it has
    none (`paramwise_mults`)."""

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 max_norm: Optional[float] = None,
                 frozen: Sequence[str] = (),
                 mults: Optional[Dict[str, Tuple[float, float]]] = None):
        super().__init__(params, schedule, max_norm, frozen)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trace = [torch.zeros_like(p) for p in self.trainable]
        mults = mults or {}
        own = [mults.get(n, (1.0, 1.0)) for n, f in
               zip(self.names, self.is_frozen) if not f]
        self.lr_mults = ([m[0] for m in own]
                         if any(m[0] != 1.0 for m in own) else None)
        self.decays = [weight_decay * m[1] for m in own]

    @torch.no_grad()
    def step(self, ok: torch.Tensor) -> None:
        """One update from the current gradients where `ok` (0-d bool) is
        True; nothing changes where it is False."""
        params = self.trainable
        grads = self._grads(params)
        if self.max_norm is not None:
            # the trainable parameters' gradients, scaled by the norm of all
            clipped = self._clip(self._grads(self.params))
            grads = [g for g, f in zip(clipped, self.is_frozen) if not f]
        if self.weight_decay:
            grads = torch._foreach_add(grads, torch._foreach_mul(
                params, self.decays))
        trace = torch._foreach_add(torch._foreach_mul(self.trace,
                                                      self.momentum), grads)
        upd = (trace if self.lr_mults is None
               else torch._foreach_mul(trace, self.lr_mults))
        upd = torch._foreach_mul(upd, -self.schedule(self.count))
        new = torch._foreach_add(params, upd)
        for p, q, t, u in zip(params, new, self.trace, trace):
            torch.where(ok, q, p, out=p)     # in place, one kernel each
            torch.where(ok, u, t, out=t)
        self.count += ok.to(torch.int64)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count.clone(),
                "trace": [t.clone() for t in self.trace]}

    def load_optax(self, slots: Dict[str, list],
                   like: Callable[[dict], Dict[str, torch.Tensor]]) -> None:
        """The state of the JAX package's optax SGD chain
        (`engine/checkpoint.py::optax_slots`): one momentum `trace` (none
        without momentum, where the trace is the gradient and needs no
        state) and one count. `like` maps a tree of the params' layout to
        {parameter name: tensor}. optax traces the frozen parameters too
        (optax.masked zeroes their updates after the chain); their traces
        are dropped."""
        traces = slots["trace"]
        if slots["mu"] or slots["nu"] or len(traces) > 1 or (
                not traces and self.momentum):
            raise ValueError(f"SGD expects one optax momentum trace, found "
                             f"the layout {slots['layout']}")
        self._load_count(slots, 1)
        if traces:
            named = like(traces[0])
            own = [n for n, f in zip(self.names, self.is_frozen) if not f]
            for n, t in zip(own, self.trace):
                t.copy_(named[n])

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if len(state["trace"]) != len(self.trace):
            raise ValueError(f"{len(state['trace'])} momentum traces for "
                             f"{len(self.trace)} trainable parameters")
        self.count.copy_(state["count"])
        for t, s in zip(self.trace, state["trace"]):
            t.copy_(s)


class Adam(_ClippedOptimizer):
    """optax.adam(schedule) in the JAX package's chain (see the module
    note): after the clipping, mu = (1 - b1) g + b1 mu and
    nu = (1 - b2) g g + b2 nu for every parameter, frozen ones included
    (optax.masked zeroes their updates after the chain, so their moments
    still accumulate); with t = count + 1, the update
    (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) times -lr(count);
    frozen parameters are not updated. Where `ok` is False, parameters,
    moments and the count keep their values."""

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_norm: Optional[float] = None,
                 frozen: Sequence[str] = ()):
        super().__init__(params, schedule, max_norm, frozen)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, ok: torch.Tensor) -> None:
        grads = self._clip(self._grads(self.params))
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1),
                                torch._foreach_mul(self.mu, self.b1))
        sq = torch._foreach_mul(grads, grads)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1 - self.b2),
                                torch._foreach_mul(self.nu, self.b2))
        t = (self.count + 1).to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        c1 = 1 - torch.pow(one * self.b1, t)
        c2 = 1 - torch.pow(one * self.b2, t)
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_mul(torch._foreach_div(mu_hat, denom),
                                 -self.schedule(self.count))
        for p, q, f in zip(self.params, upd, self.is_frozen):
            if not f:
                torch.where(ok, p + q, p, out=p)
        for old, new in zip(self.mu + self.nu, mu + nu):
            torch.where(ok, new, old, out=old)
        self.count += ok.to(torch.int64)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count.clone(),
                "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_optax(self, slots: Dict[str, list],
                   like: Callable[[dict], Dict[str, torch.Tensor]]) -> None:
        """The state of the JAX package's optax Adam chain: one `mu` and
        one `nu` over every parameter, frozen ones included, and two equal
        counts (ScaleByAdamState's and the schedule's)."""
        if slots["trace"] or len(slots["mu"]) != 1 or len(slots["nu"]) != 1:
            raise ValueError(f"Adam expects one optax mu and one nu, found "
                             f"the layout {slots['layout']}")
        self._load_count(slots, 2)
        for trees, own in ((slots["mu"], self.mu), (slots["nu"], self.nu)):
            named = like(trees[0])
            for n, t in zip(self.names, own):
                t.copy_(named[n])

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"{len(state['mu'])} moments for "
                             f"{len(self.mu)} parameters")
        self.count.copy_(state["count"])
        for t, s in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            t.copy_(s)


def build_optimizer(model: nn.Module, optimizer_cfg: dict,
                    optimizer_config: Optional[dict] = None,
                    lr_config: Optional[dict] = None,
                    iters_per_epoch: int = 1, max_epochs: int = 12,
                    frozen_stages: int = -1, by_epoch: bool = True
                    ) -> Union[SGD, Adam]:
    """The optimizer of a config (`optimizer`, `optimizer_config.grad_clip`,
    `lr_config`) over the model's parameters, the first `frozen_stages`
    stages frozen."""
    cfg = dict(optimizer_cfg)
    kind = cfg.pop("type", "SGD")
    if cfg.get("nesterov"):
        raise NotImplementedError("nesterov is not ported")
    paramwise_cfg = cfg.pop("paramwise_cfg", None)
    base_lr = float(cfg.pop("lr"))
    grad_clip = (optimizer_config or {}).get("grad_clip")
    schedule = build_lr_schedule(base_lr, lr_config, iters_per_epoch,
                                 max_epochs, by_epoch)
    max_norm = float(grad_clip["max_norm"]) if grad_clip else None
    frozen = frozen_param_names(model, frozen_stages)
    if kind == "SGD":
        return SGD(list(model.named_parameters()), schedule,
                   momentum=float(cfg.get("momentum", 0.0)),
                   weight_decay=float(cfg.get("weight_decay", 0.0)),
                   max_norm=max_norm, frozen=frozen,
                   mults=(paramwise_mults(model, dict(paramwise_cfg))
                          if paramwise_cfg else None))
    if kind == "Adam":
        # the JAX package builds optax.adam(schedule) with its defaults and
        # AdamW when there is weight decay
        unported = sorted(set(cfg) - {"weight_decay"})
        if paramwise_cfg:
            unported.append("paramwise_cfg")
        if float(cfg.get("weight_decay", 0.0)) or unported:
            raise NotImplementedError(
                f"Adam with {unported or 'weight_decay'} is not ported")
        return Adam(list(model.named_parameters()), schedule,
                    max_norm=max_norm, frozen=frozen)
    raise NotImplementedError(f"optimizer {kind} is not ported "
                              f"(SGD and Adam are)")

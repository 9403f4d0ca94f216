"""Training engine: the train step and the epoch / iteration loop with its
hooks.

Counterpart of pointtinybenchmark_tpu/engine/train.py (`make_train_step`,
`train_detector`; mmdet apis/train.py: EpochBasedRunner or IterBasedRunner,
optimizer, lr, checkpoint and log hooks, the eval hook with do_first_eval /
do_final_eval / exit_after_eval, LogNanStopHook).

The step runs on the model's device without waiting for it: the total loss
is the sum of the `loss*` outputs, and where the loss or any gradient is
not finite, or a non-finite loss was seen before, the optimizer changes
nothing (parameters, momentum and update count keep their values, decided
on the device); `nan_seen` is sticky and the step counter advances. The
loop reads the metrics back (one host sync) only every `log_interval`
iterations and at the end of an epoch, where it writes `log.json` and,
under `check.stop_while_nan`, exits with 254 once a non-finite loss was
seen: the parameters are those of the last finite step. Batches are copied
to the device from pinned memory without a sync. The port keeps the model
and the optimizer as objects (updated in place); the train state is the
step counter and `nan_seen`, two 0-d tensors on the device.
"""
from __future__ import annotations

import json
import logging
import os
import os.path as osp
import sys
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..data.loader import DataLoader, DetCollator
from ..utils import jax_weights
from .checkpoint import (is_jax_checkpoint, load_checkpoint,
                         load_jax_checkpoint, optax_slots, save_checkpoint)
from .optimizer import SGD, Adam, build_optimizer

__all__ = ["make_train_step", "init_train_state", "train_detector",
           "batch_to_device", "resume_jax_checkpoint", "BATCH_KEYS"]

logger = logging.getLogger("ptb_torch")

BATCH_KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape",
              "gt_bboxes_ignore", "gt_ignore_valid", "gt_true_bboxes",
              "gt_anns_id", "gt_masks")


def init_train_state(device: Union[str, torch.device]
                     ) -> Dict[str, torch.Tensor]:
    """The train state besides the model and the optimizer: the step
    counter and the sticky `nan_seen` flag, 0-d tensors on `device`."""
    return {"step": torch.zeros((), dtype=torch.int64, device=device),
            "nan_seen": torch.zeros((), dtype=torch.bool, device=device)}


def batch_to_device(batch: Dict[str, Any],
                    device: Union[str, torch.device]) -> Dict[str, Any]:
    """The collated batch's arrays of BATCH_KEYS as tensors on `device`;
    to a card they go from pinned memory without a host sync."""
    dev = torch.device(device)
    out = {}
    for k in BATCH_KEYS:
        if k in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t.to(dev)
    return out


def resume_jax_checkpoint(model: nn.Module, optimizer: Union[SGD, Adam],
                          state: Dict[str, torch.Tensor], path: str) -> dict:
    """Continue a JAX package `.ckpt` (its engine/train.py resume_from):
    its params and batch_stats into `model`, its optax state into
    `optimizer` (`load_optax`: the momentum trace or moments through the
    params' converter, the update count), its `step` and `nan_seen` into
    `state`. Returns its meta (epoch, and iter for an IterBasedRunner)."""
    ck = load_jax_checkpoint(path)
    st = ck["state"]
    jax_weights.load_jax_variables(model, st["params"],
                                   st.get("batch_stats"))
    optimizer.load_optax(optax_slots(st["opt_state"]),
                         lambda tree: jax_weights.jax_params_like(model,
                                                                  tree))
    state["step"].fill_(int(np.asarray(st["step"])))
    state["nan_seen"].fill_(bool(np.asarray(st.get("nan_seen", False))))
    return dict(ck["meta"])


def make_train_step(model: nn.Module,
                    optimizer: Union[SGD, Adam]) -> Callable:
    """The step: (state, batch, generator) -> metrics. `batch` holds the
    tensors of BATCH_KEYS on the model's device, `generator` (on that
    device) draws the samplers' priorities, `state` is `init_train_state`'s
    and is updated in place, like the model and the optimizer. The metrics
    are 0-d tensors on the device: every output of `forward_train`, the
    total `loss` and `nan_seen`."""

    def train_step(state: Dict[str, torch.Tensor], batch: Dict[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        for p in model.parameters():
            p.grad = None
        losses = model.forward_train(batch["img"], batch, generator)
        total = sum(v for k, v in losses.items()
                    if k.startswith("loss"))
        total.backward()
        loss_finite = torch.isfinite(total)
        # g * 0 is 0 for a finite g and NaN otherwise, with no overflow
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grads_finite = torch.isfinite(torch.stack(torch._foreach_norm(
            torch._foreach_mul(grads, 0.0)))).all()
        ok = loss_finite & grads_finite & ~state["nan_seen"]
        optimizer.step(ok)
        state["nan_seen"] |= ~loss_finite
        state["step"] += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["nan_seen"] = state["nan_seen"].clone()
        return metrics

    return train_step


def train_detector(model: nn.Module, dataset, cfg, work_dir: str,
                   validate: bool = False,
                   eval_fn: Optional[Callable[[nn.Module], dict]] = None,
                   resume_from: Optional[str] = None,
                   load_from: Optional[str] = None, seed: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, Any]:
    """The fit loop (mmdet apis/train.py::train_detector) on one device,
    the card unless the caller asks for the CPU. `model` is a built
    detector (moved to `device`); `dataset` any indexable of sample dicts
    (img (H, W, 3) float, gt_bboxes (n, 4), gt_labels (n,), optionally
    gt_bboxes_ignore (k, 4) and, for Mask R-CNN, gt_masks (n, H, W) uint8);
    `cfg` the config (data.samples_per_gpu, loader, runner, optimizer,
    optimizer_config, lr_config, log_config, checkpoint_config,
    evaluation, check). `eval_fn(model)` -> metrics is
    called as the evaluation config says. `resume_from` continues a
    checkpoint of the port's own (`engine/checkpoint.py`): its step,
    epoch, optimizer and train state; `load_from` takes the weights of one,
    or the params and batch_stats of a JAX package `.ckpt`. Returns
    the model, the optimizer, the train state, the logged history and the
    last evaluation's metrics (`metrics`, None when none ran)."""
    os.makedirs(work_dir, exist_ok=True)
    model.to(device)
    data_cfg = cfg.get("data", {})
    loader_cfg = cfg.get("loader", {})
    collator = DetCollator(
        pad_shape=(tuple(loader_cfg["pad_shape"])
                   if loader_cfg.get("pad_shape") else None),
        size_divisor=int(loader_cfg.get("size_divisor", 32)),
        max_gt=int(loader_cfg.get("max_gt", 200)),
        max_gt_ignore=int(loader_cfg.get("max_gt_ignore", 50)))
    shuffle = data_cfg.get("shuffle")
    loader = DataLoader(dataset, int(data_cfg.get("samples_per_gpu", 2)),
                        collator,
                        shuffle=True if shuffle is None else bool(shuffle),
                        seed=seed,
                        group_by_aspect=loader_cfg.get("pad_shape") is None,
                        num_workers=data_cfg.get("workers_per_gpu"))
    iters_per_epoch = len(loader)

    runner_cfg = cfg.get("runner", dict(type="EpochBasedRunner",
                                        max_epochs=12))
    iter_based = runner_cfg.get("type", "EpochBasedRunner") \
        == "IterBasedRunner"
    if iter_based:
        max_iters = int(runner_cfg["max_iters"])
        max_epochs = max(1, -(-max_iters // max(iters_per_epoch, 1)))
    else:
        max_iters = None
        max_epochs = int(runner_cfg.get("max_epochs", 12))

    optimizer = build_optimizer(
        model, cfg["optimizer"], cfg.get("optimizer_config"),
        cfg.get("lr_config"), iters_per_epoch, max_epochs,
        frozen_stages=getattr(model.backbone, "frozen_stages", -1),
        by_epoch=not iter_based)
    state = init_train_state(device)
    start_epoch, gstep = 0, 0
    if resume_from and is_jax_checkpoint(resume_from):
        meta = resume_jax_checkpoint(model, optimizer, state, resume_from)
        start_epoch = int(meta.get("epoch", 0))
        gstep = start_epoch * iters_per_epoch
        logger.info("resumed from %s (epoch %d)", resume_from, start_epoch)
    elif resume_from:
        ck = load_checkpoint(resume_from, map_location=device)
        model.load_state_dict(ck["state_dict"])
        optimizer.load_state_dict(ck["optimizer"])
        for k, v in ck["state"].items():
            state[k].copy_(v)
        start_epoch = int(ck["meta"].get("epoch", 0))
        gstep = int(state["step"])
        logger.info("resumed from %s (epoch %d)", resume_from, start_epoch)
    elif load_from:
        if is_jax_checkpoint(load_from):
            jax_state = load_jax_checkpoint(load_from)["state"]
            jax_weights.load_jax_variables(model, jax_state["params"],
                                           jax_state.get("batch_stats"))
        else:
            model.load_state_dict(load_checkpoint(
                load_from, map_location=device)["state_dict"])
        logger.info("loaded weights from %s", load_from)
    train_step = make_train_step(model, optimizer)

    log_interval = int(cfg.get("log_config", {}).get("interval", 50))
    ckpt_interval = int(dict(cfg.get("checkpoint_config") or {}).get(
        "interval", 1))
    eval_cfg = dict(cfg.get("evaluation") or {})
    eval_interval = int(eval_cfg.get("interval", 1))
    do_first_eval = bool(eval_cfg.get("do_first_eval", False))
    do_final_eval = bool(eval_cfg.get("do_final_eval", True))
    exit_after_eval = bool(eval_cfg.get("exit_after_eval", False))
    stop_while_nan = bool(cfg.get("check", {}).get("stop_while_nan", False))

    generator = torch.Generator(device=device).manual_seed(seed + 1)
    result = dict(model=model, optimizer=optimizer, state=state, history=[],
                  metrics=None)

    def evaluate(tag: str) -> None:
        model.eval()
        result["metrics"] = eval_fn(model)
        logger.info("eval (%s): %s", tag, result["metrics"])

    if do_first_eval and eval_fn is not None:
        evaluate("first")
        if exit_after_eval:
            return result

    def checkpoint(name: str, meta: dict) -> None:
        path = osp.join(work_dir, name)
        save_checkpoint(path, model, optimizer, state, meta)
        logger.info("saved %s", path)

    for epoch in range(start_epoch, max_epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        stop_now = False
        for it, batch in enumerate(loader):
            metrics = train_step(state, batch_to_device(batch, device),
                                 generator)
            gstep += 1
            if iter_based:
                if gstep % ckpt_interval == 0 or gstep == max_iters:
                    checkpoint(f"iter_{gstep}.pth",
                               dict(epoch=epoch + 1, iter=gstep))
                if (validate and eval_fn is not None
                        and gstep % eval_interval == 0
                        and gstep != max_iters):
                    evaluate(f"iter {gstep}")
                stop_now = gstep >= max_iters
            if (it + 1) % log_interval == 0 or it == iters_per_epoch - 1 \
                    or stop_now:
                vals = {k: float(v) for k, v in metrics.items()}
                dt = (time.perf_counter() - t0) / (it + 1)
                entry = dict(epoch=epoch + 1, iter=it + 1, step=gstep,
                             iter_time=dt, lr=float(optimizer.lr()), **vals)
                logger.info("epoch %d iter %d/%d %s", epoch + 1, it + 1,
                            iters_per_epoch, entry)
                result["history"].append(entry)
                with open(osp.join(work_dir, "log.json"), "a") as f:
                    f.write(json.dumps(entry) + "\n")
                if stop_while_nan and (vals["nan_seen"] > 0
                                       or not np.isfinite(vals["loss"])):
                    # LogNanStopHook (mmdet apis/train.py): the update of
                    # every non-finite step was skipped on the device
                    logger.error("loss went NaN: stopping (exit 254)")
                    sys.exit(254)
            if stop_now:
                break
        if stop_now:
            if validate and eval_fn is not None and do_final_eval:
                evaluate(f"final, iter {gstep}")
            break
        if not iter_based and ((epoch + 1) % ckpt_interval == 0
                               or epoch + 1 == max_epochs):
            checkpoint(f"epoch_{epoch + 1}.pth", dict(epoch=epoch + 1))
        is_last = epoch + 1 == max_epochs
        if not iter_based and validate and eval_fn is not None and (
                (epoch + 1) % eval_interval == 0
                or (is_last and do_final_eval)):
            evaluate(f"epoch {epoch + 1}")
            if exit_after_eval and not is_last:
                return result
    return result

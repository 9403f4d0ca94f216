#!/usr/bin/env python3
"""The first SGD steps of the P2BNet and SSD-Det COCO configs at full width,
in the JAX package and in the port, on the CPU: whether the configs'
schedule (SGD 0.02, momentum 0.9, linear warmup from 0.001 over 500
iterations, no grad_clip) keeps a step's losses finite from a random start.

    python3 p2b_config_steps.py [--kinds P2BNet SSDDet] [--steps 12]
                                [--hw 320 480] [--gts 16]

Each config's model as it stands (ResNet-50 with frozen_stages=1, FPN-256,
80 classes, two MIL stages of 2 FCs of 1,024 on S=7 sr=2 RoIAlign) takes
`--steps` steps on one batch of two synthetic `--hw` images (padded to 32)
of 5-30 COCO-sized objects, at most `--gts` a slot set: P2BNet's points
drawn by the port's data/noise.py with the config's noise_kwargs, SSD-Det's
boxes shifted by up to 40% of their size (chip_smoke.p2b_samples, as the
smoke's phase 11 draws them at 800x1333). The optimizer is built as
chip_smoke.time_step builds it (4 iterations an epoch, 12 epochs), so step
i runs at the lr of iteration i. Three trajectories a config:

- `jax`: the JAX package's jitted train step from its own model.init at
  PRNGKey(0);
- `port_from_jax`: the port's train step from those same weights
  (utils/jax_weights.py);
- `port_seeded`: the port's train step from its own seeded weights
  (build_detector(seed=0)), the smoke's start.

Prints one JSON line a step: the losses, the lr and `nan_seen`. The steps
repeat one batch, as the smoke's timed steps do; the data are synthetic.
"""
import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

CONFIGS = {"P2BNet": "configs/p2b/p2bnet_r50_fpn_1x_coco.py",
           "SSDDet": "configs/ssd_det/ssd_det_r50_fpn_1x_coco.py"}
KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape")
EPOCH_ITERS, EPOCHS = 4, 12


def batch_for(kind, cfg, hw, gts):
    """The collated numpy batch of two samples (`chip_smoke.p2b_samples`)."""
    import chip_smoke
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator

    nk = dict(cfg.data["train"]["noise_kwargs"])
    samples = chip_smoke.p2b_samples(
        np.random.RandomState(17), 2, nk if kind == "P2BNet" else None,
        kind="point" if kind == "P2BNet" else "box", hw=hw, gts=gts)
    return DetCollator(None, 32, max_gt=gts)(samples)


def line(kind, run, i, metrics, lr):
    print(json.dumps(dict(kind=kind, run=run, step=i, lr=lr, **{
        k: float(v) for k, v in metrics.items()})), flush=True)


def jax_run(kind, cfg, batch, steps):
    """The JAX package's steps; returns its initial variables (numpy)."""
    import jax
    import jax.numpy as jnp

    from pointtinybenchmark_tpu.engine.optimizer import (build_lr_schedule,
                                                         build_optimizer,
                                                         frozen_param_mask)
    from pointtinybenchmark_tpu.engine.train import make_train_step
    from pointtinybenchmark_tpu.models import build_detector

    model = build_detector(copy.deepcopy(dict(cfg.model)),
                           cfg.get("train_cfg"), cfg.get("test_cfg"))
    jb = {k: jnp.asarray(batch[k]) for k in KEYS}
    variables = jax.jit(lambda r, x, b: model.init(
        r, x, b, train=False, mode="train"))(jax.random.PRNGKey(0),
                                             jb["img"], jb)
    params, stats = variables["params"], variables.get("batch_stats", {})
    start = jax.tree_util.tree_map(np.array, (params, stats))
    tx = build_optimizer(dict(cfg.optimizer), cfg.get("optimizer_config"),
                         cfg.get("lr_config"), EPOCH_ITERS, EPOCHS,
                         param_mask=frozen_param_mask(params, 1))
    lr = build_lr_schedule(float(cfg.optimizer["lr"]), cfg.get("lr_config"),
                           EPOCH_ITERS, EPOCHS, True)
    state = dict(params=params, batch_stats=stats, opt_state=tx.init(params),
                 step=jnp.int32(0), nan_seen=jnp.bool_(False))
    step = make_train_step(model, tx)
    rng = jax.random.PRNGKey(0)
    for i in range(steps):
        rng, k = jax.random.split(rng)
        state, metrics = step(state, jb, k)
        line(kind, "jax", i, metrics, float(lr(i)))
    return start


def port_run(kind, cfg, batch, steps, run, start=None):
    """The port's steps from `start` (JAX variables) or its seeded init."""
    import torch

    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import (batch_to_device,
                                                           init_train_state,
                                                           make_train_step)
    from pointtinybenchmark_tpu_torch.models.builder import build_detector
    from pointtinybenchmark_tpu_torch.utils.jax_weights import \
        load_jax_variables

    model = build_detector(dict(cfg.model), cfg.get("train_cfg"),
                           cfg.get("test_cfg"), device="cpu", seed=0)
    if start is not None:
        load_jax_variables(model, *start)
    opt = build_optimizer(model, cfg.optimizer, cfg.get("optimizer_config"),
                          cfg.get("lr_config"), EPOCH_ITERS, EPOCHS,
                          model.backbone.frozen_stages)
    step = make_train_step(model, opt)
    state = init_train_state("cpu")
    tb = batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        lr = float(opt.lr())
        line(kind, run, i, step(state, tb, gen), lr)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kinds", nargs="+", choices=tuple(CONFIGS),
                    default=tuple(CONFIGS))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--hw", type=int, nargs=2, default=(320, 480))
    ap.add_argument("--gts", type=int, default=16)
    args = ap.parse_args()
    import torch

    from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
    from pointtinybenchmark_tpu_torch.utils.config import Config

    # torch's CPU backward of a channels-last ResNet can abort with several
    # threads (ROADMAP queue 3)
    torch.set_num_threads(1)
    for kind in args.kinds:
        path = str(HERE / CONFIGS[kind])
        cfg = Config.fromfile(path)
        batch = batch_for(kind, cfg, tuple(args.hw), args.gts)
        print(json.dumps(dict(kind=kind, config=CONFIGS[kind], hw=list(
            batch["img"].shape[1:3]), gts=int(batch["gt_valid"].sum(1).max()),
            slots=args.gts)), flush=True)
        start = jax_run(kind, JaxConfig.fromfile(path), batch, args.steps)
        port_run(kind, cfg, batch, args.steps, "port_from_jax", start)
        port_run(kind, cfg, batch, args.steps, "port_seeded")


if __name__ == "__main__":
    main()

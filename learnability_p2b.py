#!/usr/bin/env python3
"""The learnability scenarios of tests/test_models_p2b.py (P2BNet at :145,
SSD-Det at :241), through the port or through the JAX package.

    python3 learnability_p2b.py [--reps N] [--device cuda|cpu]
                                [--kinds P2BNet SSDDet] [--perturb EPS]
    python3 learnability_p2b.py --jax [--seeds S ...] [--kinds ...]
                                [--perturb EPS --reps N]
    python3 learnability_p2b.py --write-init

The scenes, models, batches and measures are this module's
(`learn_scene`, `learn_model`, `learn`, `learn_measures`): 16 64x64
images of a 3x3 grid of 8-px squares of two alternating classes, P2BNet
supervised by points and SSD-Det by boxes shifted by up to half their
size, ResNet-18 (base 16, BN in training mode), FPN 32 and the head at
128, 300 Adam steps of 8 images at 1e-3 (the JAX test's draws), then the
pseudo boxes' mean IoU with the true ones (P2BNet: also the share above
0.5 and stage 0's selection mass per scale; SSD-Det: the noisy boxes'
IoU beside it). chip_smoke.py's phase 11 (e) runs the default mode in
parallel processes and holds the runs to `learn_floors`.

The port (the default) starts from the JAX test's own initial weights
(model.init at PRNGKey(0), in LEARN_INIT), `--reps` times: on a card the
float atomics of the RoIAlign backward make runs differ, and on the CPU
torch runs on one thread. The other modes are evidence tools, run on the
CPU with the JAX package, whose numbers chip_smoke.LEARN_JAX and PERF.md
keep: `--jax` runs the JAX package's own train step from model.init at
PRNGKey(seed) for each of `--seeds` (the test uses 0); with `--perturb`
each parameter of the start is multiplied by 1 + EPS N(0, 1) (numpy's
generator at each run's index), in either package: how far
rounding-level changes move the outcome. `--write-init` writes
LEARN_INIT from JAX's PRNGKey(0) draw (P2BNet's and SSD-Det's parameter
trees are the same, and so are their draws). Prints one JSON line per
run, after the device (a card's name and power limit).
"""
import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

KINDS = ("P2BNet", "SSDDet")
# images, side, batch, Adam steps, and the JAX test's initial weights
# (model.init at PRNGKey(0), as the port's state_dict)
LEARN_IMAGES, LEARN_SIZE, LEARN_BATCH, LEARN_STEPS = 16, 64, 8, 300
LEARN_INIT = HERE / "tests" / "data" / "p2b_learn_init.npz"


def learn_scene(kind):
    """tests/test_models_p2b.py's scenes, drawn as there: 16 64x64 images
    of a 3x3 grid of 8-px squares of alternating classes (2 classes) on
    faint noise; P2BNet gets 8x8 pseudo boxes round points jittered by up
    to 1.5 px, SSD-Det the true boxes shifted by up to half their size.
    Returns (images, supervision boxes, true boxes, labels, valid)."""
    rng = np.random.RandomState(3 if kind == "P2BNet" else 5)
    n, size, max_g = LEARN_IMAGES, LEARN_SIZE, 9
    imgs = np.zeros((n, size, size, 3), np.float32)
    true = np.zeros((n, max_g, 4), np.float32)
    labels = np.zeros((n, max_g), np.int32)
    sup = np.zeros((n, max_g, 4), np.float32)
    valid = np.zeros((n, max_g), bool)
    for i in range(n):
        imgs[i] = rng.rand(size, size, 3) * 0.1
        ox, oy = rng.randint(4, 16, 2)
        g = 0
        for r in range(3):
            for c in range(3):
                x, y, w = ox + c * 12, oy + r * 12, 8
                cls = (r + c) % 2
                imgs[i, y:y + w, x:x + w, cls] = 1.0
                true[i, g] = (x, y, x + w, y + w)
                labels[i, g] = cls
                if kind == "P2BNet":
                    cx = x + w / 2 + rng.uniform(-1.5, 1.5)
                    cy = y + w / 2 + rng.uniform(-1.5, 1.5)
                    sup[i, g] = (cx - 4, cy - 4, cx + 4, cy + 4)
                else:
                    dx, dy = rng.uniform(-0.5, 0.5, 2) * w
                    sup[i, g] = (x + dx, y + dy, x + w + dx, y + w + dy)
                valid[i, g] = True
                g += 1
    return imgs, sup, true, labels, valid


def learn_model(kind):
    """The scenarios' models: ResNet-18 (base 16, BN in training mode),
    FPN 32, the head at 128 with the scenario's grids."""
    head = (dict(type="P2BNetHead", cbp_scales=[6, 12, 24], cbp_ratios=[1.0],
                 pbr_scale_jitter=[0.7, 1.0, 1.3],
                 pbr_offset_frac=[-0.15, 0.0, 0.15])
            if kind == "P2BNet" else
            dict(type="SSDDetHead", box_bag_scale_jitter=[0.8, 1.0, 1.25],
                 box_bag_offset_frac=[-0.5, -0.25, 0.0, 0.25, 0.5],
                 pbr_scale_jitter=[0.8, 1.0, 1.25],
                 pbr_offset_frac=[-0.15, 0.0, 0.15]))
    head.update(num_classes=2, in_channels=32, fc_channels=128,
                featmap_strides=[4, 8, 16, 32], merge_topk=3)
    return dict(type=kind,
                backbone=dict(type="ResNet", depth=18, base_channels=16,
                              norm_eval=False),
                neck=dict(type="FPN", in_channels=[16, 32, 64, 128],
                          out_channels=32, start_level=0, num_outs=4),
                bbox_head=head)


def box_iou_rows(a, b):
    """IoU of each row of a with the same row of b, numpy (n, 4) each."""
    wh = np.clip(np.minimum(a[:, 2:], b[:, 2:]) - np.maximum(a[:, :2],
                                                            b[:, :2]), 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area(a) + area(b) - inter)


def learn_measures(kind, boxes, sels, sup, true, valid, loss):
    """The scenario's measures: the pseudo boxes' (n, 4) mean IoU with the
    true boxes over the valid gts; P2BNet: the share above 0.5 and stage
    0's mean selection per scale (`sels`, rows of 3); SSD-Det: the noisy
    boxes' mean IoU."""
    v = valid.reshape(-1)
    iou = box_iou_rows(boxes.reshape(-1, 4), true.reshape(-1, 4))[v]
    res = dict(steps=LEARN_STEPS, final_loss=loss, mean_iou=float(iou.mean()))
    if kind == "P2BNet":
        res.update(above_half=float((iou > 0.5).mean()),
                   scale_mass=np.concatenate(sels).mean(0).tolist())
    else:
        res.update(noisy_iou=float(box_iou_rows(
            sup.reshape(-1, 4), true.reshape(-1, 4))[v].mean()))
    return res


def learn_floors(kind, r):
    """Whether `r` (one run's measures, or their means over runs) meets
    the JAX test's floors: P2BNet mean IoU > 0.45, more than 40% of the
    boxes above 0.5, the tightest CBP scale's selection mass above the
    widest's; SSD-Det refined IoU > noisy IoU + 0.15."""
    if kind == "P2BNet":
        return (r["mean_iou"] > 0.45 and r["above_half"] > 0.4
                and r["scale_mass"][0] > r["scale_mass"][2])
    return r["mean_iou"] > r["noisy_iou"] + 0.15


def learn(kind, device, perturb=0.0, rep=0):
    """One scenario through the port from the JAX test's initial weights
    (LEARN_INIT; with `perturb`, each parameter times 1 + perturb N(0, 1)
    from numpy's RandomState(rep)): `make_train_step` with Adam 1e-3 for
    LEARN_STEPS steps of LEARN_BATCH images (the JAX test's draws), then
    the refinement of all images (`learn_measures`). Returns the measures
    and the training's host seconds."""
    import torch

    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import (init_train_state,
                                                           make_train_step)
    from pointtinybenchmark_tpu_torch.models.builder import build_detector

    imgs, sup, true, labels, valid = learn_scene(kind)
    model = build_detector(learn_model(kind), device="cpu")
    noise = np.random.RandomState(rep)
    params = dict(model.named_parameters())
    with np.load(LEARN_INIT) as init:
        state = {k: init[k] for k in init.files}
    if perturb:
        state = {k: (v * (1 + perturb * noise.randn(*v.shape))).astype(
            np.float32) if k in params else v for k, v in state.items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.to(device)
    step = make_train_step(model, build_optimizer(model, dict(type="Adam",
                                                              lr=1e-3)))
    state = init_train_state(device)
    gen = torch.Generator(device=device).manual_seed(0)
    n, b, size = LEARN_IMAGES, LEARN_BATCH, LEARN_SIZE

    def batch(sel):
        t = lambda x: torch.from_numpy(x[sel]).to(device)
        return dict(img=t(imgs), gt_bboxes=t(sup), gt_labels=t(labels),
                    gt_valid=t(valid),
                    img_shape=torch.tensor([[size, size]] * len(sel),
                                           dtype=torch.int32, device=device))
    t0 = time.perf_counter()
    for i in range(LEARN_STEPS):
        sel = np.random.RandomState(i).choice(n, b, replace=False)
        metrics = step(state, batch(sel), gen)
    loss = float(metrics["loss"])
    wall = time.perf_counter() - t0
    model.eval()
    boxes, sels = [], []
    with torch.no_grad():
        for s in range(0, n, b):
            bb = batch(np.arange(s, s + b))
            out = model(bb["img"], bb, mode="refine")
            boxes.append(out["pseudo_boxes"].cpu().numpy())
            sels.append(out["stages"][0]["sel"].cpu().numpy().reshape(-1, 3)
                        if kind == "P2BNet" else None)
    return dict(learn_measures(kind, np.concatenate(boxes), sels, sup, true,
                               valid, loss), train_s=wall)


def jax_run(kind, seed, perturb=0.0, rep=0):
    """The JAX test's path from model.init at PRNGKey(seed), each parameter
    times 1 + perturb N(0, 1) from numpy's RandomState(rep)."""
    import jax
    import jax.numpy as jnp
    import optax

    from pointtinybenchmark_tpu.engine.train import init_model, make_train_step
    from pointtinybenchmark_tpu.models import build_detector

    model = build_detector(copy.deepcopy(learn_model(kind)), None, None)
    imgs, sup, true, labels, valid = learn_scene(kind)
    n, b, size = LEARN_IMAGES, LEARN_BATCH, LEARN_SIZE
    tx = optax.adam(1e-3)
    params, stats = init_model(model, dict(img=jnp.asarray(imgs[:b])), seed)
    if perturb:
        noise = np.random.RandomState(rep)
        params = jax.tree_util.tree_map(
            lambda x: x * (1 + perturb * noise.randn(*x.shape)).astype(
                np.float32), params)
    state = dict(params=params, batch_stats=stats, opt_state=tx.init(params),
                 step=jnp.int32(0))
    step = make_train_step(model, tx)

    def batch(sel):
        return dict(img=jnp.asarray(imgs[sel]), gt_bboxes=jnp.asarray(sup[sel]),
                    gt_labels=jnp.asarray(labels[sel]),
                    gt_valid=jnp.asarray(valid[sel]),
                    img_shape=jnp.tile(jnp.asarray([[size, size]], jnp.int32),
                                       (len(sel), 1)))
    rng = jax.random.PRNGKey(0)
    for i in range(LEARN_STEPS):
        sel = np.random.RandomState(i).choice(n, b, replace=False)
        rng, k = jax.random.split(rng)
        state, metrics = step(state, batch(sel), k)
    variables = {"params": state["params"],
                 "batch_stats": state["batch_stats"]}
    boxes, sels = [], []
    for s in range(0, n, b):
        out = model.apply(variables, jnp.asarray(imgs[s:s + b]),
                          batch(np.arange(s, s + b)), train=False,
                          mode="refine")
        boxes.append(np.asarray(out["pseudo_boxes"]))
        sels.append(np.asarray(out["stages"][0]["sel"]).reshape(-1, 3))
    return learn_measures(kind, np.concatenate(boxes), sels, sup, true,
                          valid, float(metrics["loss"]))


def write_init():
    """LEARN_INIT: JAX's PRNGKey(0) draw as the port's state_dict
    (utils/jax_weights.py's names and layouts)."""
    import jax
    import jax.numpy as jnp

    from pointtinybenchmark_tpu.engine.train import init_model
    from pointtinybenchmark_tpu.models import build_detector as jax_build
    from pointtinybenchmark_tpu_torch.models.builder import build_detector
    from pointtinybenchmark_tpu_torch.utils.jax_weights import \
        load_jax_variables

    cfg = learn_model("P2BNet")
    imgs = learn_scene("P2BNet")[0]
    params, stats = init_model(jax_build(copy.deepcopy(cfg)),
                               dict(img=jnp.asarray(imgs[:LEARN_BATCH])))
    model = build_detector(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    LEARN_INIT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(LEARN_INIT, **{
        k: v.numpy() for k, v in model.state_dict().items()})
    print(f"wrote {LEARN_INIT}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kinds", nargs="+", choices=KINDS, default=KINDS)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--write-init", action="store_true")
    args = ap.parse_args()
    if args.write_init:
        write_init()
        return
    if args.jax:
        print("JAX package on the CPU")
        for kind in args.kinds:
            for seed in args.seeds:
                for rep in range(args.reps):
                    print(json.dumps(dict(
                        framework="jax", kind=kind, seed=seed,
                        perturb=args.perturb, rep=rep,
                        **jax_run(kind, seed, args.perturb, rep))),
                        flush=True)
        return
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
    else:
        # torch's CPU backward of a channels-last ResNet-18 can abort with
        # several threads (ROADMAP queue 3)
        torch.set_num_threads(1)
        card = "cpu"
    print(card)
    for kind in args.kinds:
        for rep in range(args.reps):
            res = learn(kind, args.device, perturb=args.perturb, rep=rep)
            print(json.dumps(dict(framework="torch", kind=kind,
                                  perturb=args.perturb, rep=rep, **res)),
                  flush=True)


if __name__ == "__main__":
    main()

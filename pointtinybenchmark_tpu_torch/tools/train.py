"""Train a detector on a dataset, with validation by the config's protocol.

    python -m pointtinybenchmark_tpu_torch.tools.train <config>
        [--work-dir DIR] [--resume-from CKPT] [--load-from CKPT]
        [--no-validate] [--seed N] [--cfg-options key=value ...]
        [--device cpu]

The port's counterpart of the JAX package's tools/train.py (mmdet
tools/train.py:86-184): the config with its `--cfg-options` overrides, the
work dir (default ./work_dirs/<config name>) with a timestamped log, the
environment and the merged config written there, the detector drawn from
`--seed`, the `data.train` dataset and, unless `--no-validate`, the
`data.val` dataset in test mode, whose evaluation (`eval_fn(model)`) takes
CPR's refinement, the tiled protocol or the plain loop as tools/test.py
does; then `engine/train.py::train_detector`. The last line printed is the
last validation's metrics dict as JSON (null when none ran). The model
runs on the card unless `--device cpu` is given, in float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional

from ..data import build_dataset
from ..engine.train import train_detector
from ..models.builder import build_detector
from ..utils.logging import collect_env, get_root_logger
from .test import eval_settings, float32_on_card, infer_dataset, load_config

__all__ = ["main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", help="checkpoint to resume from")
    p.add_argument("--load-from", help="checkpoint to load weights from")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="override config entries: key=value (dotted keys)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, float]]:
    args = parse_args(argv)
    float32_on_card()
    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or cfg.get("work_dir") or osp.join(
        "./work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    logger = get_root_logger(osp.join(work_dir, f"{timestamp}.log"))
    logger.info("environment: %s", collect_env())
    cfg.dump(osp.join(work_dir, osp.basename(args.config)))

    model = build_detector(dict(cfg.model),
                           cfg.get("train_cfg") or cfg.model.get("train_cfg"),
                           cfg.get("test_cfg") or cfg.model.get("test_cfg"),
                           device=args.device, seed=args.seed)
    dataset = build_dataset(cfg.data["train"])

    eval_fn = None
    if not args.no_validate and "val" in cfg.data:
        val_cfg = dict(cfg.data["val"])
        val_cfg["test_mode"] = True
        val_dataset = build_dataset(val_cfg)
        eval_kwargs, tiled, collator = eval_settings(cfg)

        def eval_fn(m):
            results = infer_dataset(m, cfg, val_dataset, collator, tiled)
            return {k: float(v) for k, v in
                    val_dataset.evaluate(results, **eval_kwargs).items()}

    result = train_detector(model, dataset, cfg.to_dict(), work_dir,
                            validate=eval_fn is not None, eval_fn=eval_fn,
                            resume_from=(args.resume_from
                                         or cfg.get("resume_from")),
                            load_from=args.load_from or cfg.get("load_from"),
                            seed=args.seed, device=args.device)
    print(json.dumps(result["metrics"]))
    return result["metrics"]


if __name__ == "__main__":
    main()

"""Test a detector on a dataset: inference, the results json, the metrics.

    python -m pointtinybenchmark_tpu_torch.tools.test <config> <checkpoint>
        [--out results.json] [--eval bbox] [--split test]
        [--cfg-options key=value ...] [--device cpu]

The port's counterpart of the JAX package's tools/test.py (mmdet
tools/test.py:191-229): the config with its `--cfg-options` overrides, the
`data.<split>` dataset in test mode, the detector with the checkpoint's
weights (a `.ckpt` of the JAX package or a `.pth` of the port), then the
branch the config asks for: CPR's point refinement (`run_refine_test`),
the tiled protocol (`evaluation.tiled`, `run_tiled_test`) or the plain
loop (`run_test`); `--out` writes the COCO results json, and the last line
printed is the metrics dict as JSON. The model runs on the card unless
`--device cpu` is given, in float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..apis.inference import init_detector
from ..data import build_dataset
from ..data.loader import DetCollator
from ..engine.test import run_refine_test, run_test, run_tiled_test
from ..utils.config import (Config, import_modules_from_strings,
                            parse_cfg_option)
from ..utils.logging import get_root_logger

__all__ = ["main", "load_config", "eval_settings", "infer_dataset"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--out", help="output result file (json)")
    p.add_argument("--eval", nargs="+", default=["bbox"],
                   help="evaluation metrics")
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="override config entries: key=value (dotted keys)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def load_config(path: str, cfg_options: List[str]) -> Config:
    """The config file, its custom_imports imported, with the key=value
    overrides merged in."""
    cfg = Config.fromfile(path)
    if cfg.get("custom_imports"):
        import_modules_from_strings(**dict(cfg["custom_imports"]))
    if cfg_options:
        overrides = {}
        for kv in cfg_options:
            k, v = kv.split("=", 1)
            overrides[k] = parse_cfg_option(v)
        cfg.merge_from_dict(overrides)
    return cfg


def eval_settings(cfg: Config) -> Tuple[Dict[str, Any], bool, DetCollator]:
    """The `evaluation` config as `dataset.evaluate` arguments (the
    hooks' keys dropped), whether the tiled protocol is asked for, and the
    collator of the `loader` config."""
    eval_kwargs = dict(cfg.get("evaluation", {}) or {})
    for k in ("interval", "do_first_eval", "do_final_eval",
              "exit_after_eval"):
        eval_kwargs.pop(k, None)
    tiled = bool(eval_kwargs.pop("tiled", False))
    loader_cfg = dict(cfg.get("loader", {}) or {})
    collator = DetCollator(
        pad_shape=(tuple(loader_cfg["pad_shape"])
                   if loader_cfg.get("pad_shape") else None),
        size_divisor=int(loader_cfg.get("size_divisor", 32)),
        max_gt=int(loader_cfg.get("max_gt", 200)))
    return eval_kwargs, tiled, collator


def infer_dataset(model, cfg: Config, dataset, collator: DetCollator,
                  tiled: bool) -> List[dict]:
    """The detections of the branch the config asks for. (The JAX CLIs
    read `model.bbox_head` unguarded, which a two-stage config lacks.)"""
    if (dict(cfg.model).get("bbox_head") or {}).get("type") == "CPRHead":
        pseudo_wh = tuple((cfg.get("test_cfg") or {}).get("pseudo_wh",
                                                          (16, 16)))
        return run_refine_test(model, dataset, collator, pseudo_wh=pseudo_wh)
    if tiled:
        return run_tiled_test(model, dataset, collator)
    return run_test(model, dataset, collator)


def float32_on_card() -> None:
    """cuDNN would run the convolutions in TF32; the port is held to the
    JAX package in float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    float32_on_card()
    cfg = load_config(args.config, args.cfg_options)
    logger = get_root_logger()
    ds_cfg = dict(cfg.data[args.split])
    ds_cfg["test_mode"] = True
    dataset = build_dataset(ds_cfg)
    model = init_detector(cfg, args.checkpoint, device=args.device).model
    model.eval()
    eval_kwargs, tiled, collator = eval_settings(cfg)
    results = infer_dataset(model, cfg, dataset, collator, tiled)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dataset.format_results(results), f)
        logger.info("wrote %s", args.out)
    eval_kwargs["metric"] = args.eval
    metrics = {k: float(v) for k, v in
               dataset.evaluate(results, **eval_kwargs).items()}
    logger.info("metrics: %s", metrics)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()

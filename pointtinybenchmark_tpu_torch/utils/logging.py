"""The root logger and the environment report of the command-line tools.

Counterpart of pointtinybenchmark_tpu/utils/logging.py (`get_root_logger`,
`collect_env`; mmdet utils/logger.py and utils/collect_env.py). The
logger is the one the port's engines log to ("ptb_torch"); the first call
gives it a handler on standard output and, with `log_file`, one on that
file. `collect_env` reports Python, numpy, torch, CUDA and the card in
place of JAX's devices.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

__all__ = ["get_root_logger", "collect_env"]

LOGGER_NAME = "ptb_torch"
_initialized = False


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    global _initialized
    logger = logging.getLogger(LOGGER_NAME)
    if _initialized:
        return logger
    logger.setLevel(log_level)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    _initialized = True
    return logger


def collect_env() -> dict:
    import platform

    import numpy as np
    import torch

    env = {
        "sys.platform": sys.platform,
        "Python": sys.version.replace("\n", ""),
        "platform": platform.platform(),
        "numpy": np.__version__,
        "torch": torch.__version__,
        "torch.version.cuda": torch.version.cuda,
        "cuda available": torch.cuda.is_available(),
        "cudnn": torch.backends.cudnn.version(),
    }
    if torch.cuda.is_available():
        env["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
    return env

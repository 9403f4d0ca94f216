"""Python-file configs with `_base_` inheritance and deep merge.

Counterpart of pointtinybenchmark_tpu/utils/config.py (mmcv.Config
semantics: a config is a Python file whose top-level names become keys;
`_base_` files are merged first, later bases over earlier ones; a nested
dict carrying `_delete_=True` replaces the base value instead of merging),
kept in this package so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import copy
import os
import types
from typing import Any, Dict

__all__ = ["Config", "ConfigDict"]

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"


class ConfigDict(dict):
    """dict with attribute access (cfg.model.backbone.depth)."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _to_configdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_configdict(v) for v in obj)
    return obj


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename) as f:
        src = f.read()
    ns: Dict[str, Any] = {"__file__": filename}
    exec(compile(src, filename, "exec"), ns)
    return {k: v for k, v in ns.items()
            if k == BASE_KEY or not (k.startswith("__") or callable(v)
                                     or isinstance(v, types.ModuleType))}


def merge_dict(base: Dict, new: Dict) -> Dict:
    """Deep-merge `new` into a copy of `base` (new wins)."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict):
            v = dict(v)
            replace = v.pop(DELETE_KEY, False)
            if isinstance(out.get(k), dict) and not replace:
                out[k] = merge_dict(out[k], v)
                continue
        out[k] = copy.deepcopy(v)
    return out


class Config:
    """cfg = Config.fromfile("configs/tinyperson/retinanet_....py")"""

    def __init__(self, cfg_dict: Dict[str, Any], filename: str):
        self._cfg_dict = _to_configdict(cfg_dict)
        self.filename = filename

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(Config._load(os.path.abspath(filename)), filename)

    @staticmethod
    def _load(filename: str) -> Dict[str, Any]:
        cfg = _exec_pyfile(filename)
        bases = cfg.pop(BASE_KEY, [])
        merged: Dict[str, Any] = {}
        for bf in [bases] if isinstance(bases, str) else bases:
            merged = merge_dict(merged, Config._load(
                os.path.join(os.path.dirname(filename), bf)))
        return merge_dict(merged, cfg)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._cfg_dict[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __contains__(self, name) -> bool:
        return name in self._cfg_dict

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg_dict))

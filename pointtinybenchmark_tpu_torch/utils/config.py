"""Python-file configs with `_base_` inheritance and deep merge.

Counterpart of pointtinybenchmark_tpu/utils/config.py (mmcv.Config
semantics: a config is a Python file whose top-level names become keys;
`_base_` files are merged first, later bases over earlier ones; a nested
dict carrying `_delete_=True` replaces the base value instead of merging),
kept in this package so that it imports nothing of the JAX package. The
command-line tools use `Config.merge_from_dict` for `--cfg-options
a.b.c=value` (values parsed by `parse_cfg_option`), `Config.dump` and
`import_modules_from_strings` for a config's `custom_imports`.
"""
from __future__ import annotations

import ast
import copy
import importlib
import os
import pprint
import types
import warnings
from typing import Any, Dict

__all__ = ["Config", "ConfigDict", "import_modules_from_strings",
           "parse_cfg_option"]

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

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dotted-key options, {"model.bbox_head.num_classes": 1}
        (mmcv Config.merge_from_dict; a key through a list, such as
        `data.train.pipeline.2.x`, replaces the list, as in the JAX
        package)."""
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split(".")
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = v
        self._cfg_dict = _to_configdict(merge_dict(dict(self._cfg_dict),
                                                   option_cfg))

    def pretty_text(self) -> str:
        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("cfg = " + self.pretty_text() + "\n")


def import_modules_from_strings(imports, allow_failed_imports: bool = False):
    """A config's `custom_imports`: import the listed modules so that their
    registrations run before anything is built (mmcv utils/misc.py)."""
    if imports is None:
        return []
    if isinstance(imports, str):
        imports = [imports]
    imported = []
    for name in imports:
        try:
            imported.append(importlib.import_module(name))
        except ImportError:
            if not allow_failed_imports:
                raise
            warnings.warn(f"{name} failed to import and is ignored.",
                          UserWarning)
            imported.append(None)
    return imported


def parse_cfg_option(value: str) -> Any:
    """A `--cfg-options key=value` value, as mmcv's DictAction reads it:
    a Python literal, true / false / none in any case, a comma-separated
    tuple of those, or else the string itself."""
    def _parse_atom(s: str) -> Any:
        s = s.strip()
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            lowered = s.lower()
            if lowered in ("true", "false"):
                return lowered == "true"
            if lowered in ("none", "null"):
                return None
            return s

    if "," in value:
        parts = value.split(",")
        if parts and parts[-1] == "":
            parts = parts[:-1]
        return tuple(_parse_atom(p) for p in parts)
    return _parse_atom(value)

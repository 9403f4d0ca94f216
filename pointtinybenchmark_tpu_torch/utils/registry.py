"""Registries of the dataset path: config `type=` strings to classes.

Counterpart of pointtinybenchmark_tpu/utils/registry.py (mmcv Registry):
`DATASETS` holds the datasets, `PIPELINES` the pipeline transforms; `build`
pops `type` from a config dict and calls what it names with the rest.
The models have a builder of their own (`models/builder.py`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["Registry", "DATASETS", "PIPELINES"]


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None):
        """Decorator: ``@REG.register_module()``."""

        def _decorator(cls):
            key = name if name is not None else cls.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} is already registered in {self.name}")
            self._module_dict[key] = cls
            return cls

        return _decorator

    def build(self, cfg: Dict[str, Any]):
        if "type" not in cfg:
            raise KeyError(f"cfg must contain the key 'type': {cfg}")
        args = dict(cfg)
        obj_type = args.pop("type")
        obj_cls = self.get(obj_type) if isinstance(obj_type, str) else obj_type
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {self.name}. "
                           f"Available: {sorted(self._module_dict)}")
        return obj_cls(**args)


DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")

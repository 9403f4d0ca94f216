"""Dataset wrappers: Concat / Repeat / ClassBalanced.

The port's own copy of pointtinybenchmark_tpu/data/dataset_wrappers.py
(mmdet datasets/dataset_wrappers.py:14,128,172). A wrapper's `flag` is
its samples' aspect groups in its own index order, which the port's
DataLoader groups by as the JAX loader does.
"""
from __future__ import annotations

import bisect
import math
from collections import defaultdict
from typing import List, Sequence

import numpy as np

from ..utils.registry import DATASETS

__all__ = ["ConcatDataset", "RepeatDataset", "ClassBalancedDataset"]


@DATASETS.register_module()
class ConcatDataset:
    def __init__(self, datasets: Sequence):
        from . import build_dataset
        self.datasets = [build_dataset(d) if isinstance(d, dict) else d
                         for d in datasets]
        self.classes = self.datasets[0].classes
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()
        self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        d = bisect.bisect_right(self.cumulative_sizes, idx)
        base = 0 if d == 0 else self.cumulative_sizes[d - 1]
        return self.datasets[d][idx - base]

    def set_epoch(self, epoch):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)


@DATASETS.register_module()
class RepeatDataset:
    def __init__(self, dataset, times: int):
        from . import build_dataset
        self.dataset = (build_dataset(dataset) if isinstance(dataset, dict)
                        else dataset)
        self.times = times
        self.classes = self.dataset.classes
        self._len = len(self.dataset) * times
        self.flag = np.tile(self.dataset.flag, times)

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def set_epoch(self, epoch):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)


@DATASETS.register_module()
class ClassBalancedDataset:
    """Oversample images containing rare categories
    (mmdet dataset_wrappers.py:172, LVIS repeat-factor sampling)."""

    def __init__(self, dataset, oversample_thr: float):
        from . import build_dataset
        self.dataset = (build_dataset(dataset) if isinstance(dataset, dict)
                        else dataset)
        self.oversample_thr = oversample_thr
        self.classes = self.dataset.classes
        repeat_factors = self._get_repeat_factors(self.dataset,
                                                  oversample_thr)
        indices = []
        for i, rf in enumerate(repeat_factors):
            indices.extend([i] * int(math.ceil(rf)))
        self.repeat_indices = indices
        self.flag = np.asarray(
            [self.dataset.flag[i] for i in indices], np.uint8)

    def _get_repeat_factors(self, dataset, thr: float) -> List[float]:
        category_freq = defaultdict(float)
        n = len(dataset)
        cat_of_img = []
        for idx in range(n):
            ann = dataset.get_ann_info(idx)
            cats = set(int(c) for c in ann["labels"])
            cat_of_img.append(cats)
            for c in cats:
                category_freq[c] += 1
        for k in category_freq:
            category_freq[k] /= n
        category_repeat = {
            c: max(1.0, math.sqrt(thr / f)) for c, f in category_freq.items()}
        return [max((category_repeat[c] for c in cats), default=1.0)
                for cats in cat_of_img]

    def __len__(self):
        return len(self.repeat_indices)

    def __getitem__(self, idx):
        return self.dataset[self.repeat_indices[idx]]

    def set_epoch(self, epoch):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

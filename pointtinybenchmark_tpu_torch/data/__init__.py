"""On-device preprocessing, the protocol tile grid, batching (loader:
collation, samplers, the training DataLoader), the point workflow's
pseudo boxes (noise) and the dataset path: the COCO API, the host
pipeline transforms, Scale Match's resizing, the corner dataset and
test-time tilers, CocoFmtDataset, VOCDataset and WIDERFaceDataset, and
the dataset wrappers, built from a config by `build_dataset`."""
from ..utils.registry import DATASETS
# registers Scale Match's transforms and the test-time tilers
from . import scale_match, tiling  # noqa: F401
from .cocofmt import CocoFmtDataset
from .dataset_wrappers import (ClassBalancedDataset, ConcatDataset,
                               RepeatDataset)
from .voc import VOCDataset, WIDERFaceDataset

__all__ = ["build_dataset", "CocoFmtDataset", "VOCDataset",
           "WIDERFaceDataset", "ConcatDataset", "RepeatDataset",
           "ClassBalancedDataset"]


def build_dataset(cfg):
    """A dataset config (`type` and its arguments) -> the dataset; a list
    of configs -> their ConcatDataset (pointtinybenchmark_tpu/data/
    __init__.py::build_dataset, mmdet datasets/builder.py:53)."""
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset(list(cfg))
    return DATASETS.build(dict(cfg))

"""On-device preprocessing, the protocol tile grid, batching (loader:
collation, samplers, the training DataLoader), the point workflow's
pseudo boxes (noise) and the dataset path: the COCO API, the host
pipeline transforms, Scale Match's resizing, the corner dataset and
test-time tilers, and CocoFmtDataset, built from a config by
`build_dataset`."""
from ..utils.registry import DATASETS
# registers Scale Match's transforms and the test-time tilers
from . import scale_match, tiling  # noqa: F401
from .cocofmt import CocoFmtDataset

__all__ = ["build_dataset", "CocoFmtDataset"]


def build_dataset(cfg):
    """A dataset config (`type` and its arguments) -> the dataset
    (pointtinybenchmark_tpu/data/__init__.py::build_dataset). A list of
    configs, which the JAX package concatenates, is not ported yet."""
    if isinstance(cfg, (list, tuple)):
        raise NotImplementedError(
            "a list of dataset configs needs ConcatDataset "
            "(data/dataset_wrappers.py), which is not ported yet "
            "(ROADMAP.md queue 2, M7)")
    return DATASETS.build(dict(cfg))

"""Batching: static-shape padded collation and deterministic sampling.

Counterpart of pointtinybenchmark_tpu/data/loader.py (`DetCollator`,
`EpochSampler`, `GroupSampler`, `DataLoader`). Each sample's (H, W, 3)
float image is padded at the bottom and right to the batch's shape,
`pad_shape` or the largest image rounded up to a multiple of
`size_divisor`; the batch carries each image's content shape, its scale
factor (from `img_metas`, [1, 1, 1, 1] when absent) and the metas. For
training, the gt boxes are padded to `max_gt` rows (`gt_bboxes`,
`gt_valid`, `gt_labels`), the ignore regions to `max_gt_ignore`
(`gt_bboxes_ignore`, `gt_ignore_valid`), the point workflow's true boxes
to `max_gt` rows (`gt_true_bboxes`) and its annotation ids to (B, max_gt)
int64, -1 in the empty rows (`gt_anns_id`), and the gt bitmaps, each
sample's
(n, H, W) uint8 `gt_masks`, to (B, max_gt, H_pad, W_pad) uint8 with zeros
at the bottom and right and in the empty rows. Host numpy in, host numpy
out; the engines move the arrays to the model's device. The loader runs on
threads only (no worker processes).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["DetCollator", "EpochSampler", "GroupSampler", "DataLoader"]


class DetCollator:

    def __init__(self, pad_shape: Optional[Tuple[int, int]] = None,
                 size_divisor: int = 32, max_gt: int = 200,
                 max_gt_ignore: int = 50):
        self.pad_shape = pad_shape      # (H, W); None: largest, rounded up
        self.size_divisor = size_divisor
        self.max_gt = max_gt
        self.max_gt_ignore = max_gt_ignore

    @staticmethod
    def _pad_boxes(arrs: List[np.ndarray], max_n: int):
        out = np.zeros((len(arrs), max_n, 4), np.float32)
        valid = np.zeros((len(arrs), max_n), bool)
        for i, a in enumerate(arrs):
            n = min(len(a), max_n)
            if n:
                out[i, :n] = np.asarray(a)[:n, :4]
                valid[i, :n] = True
        return out, valid

    def __call__(self, samples: List[dict]) -> Dict[str, Any]:
        samples = [s for s in samples if s is not None]
        if not samples:
            raise ValueError("every sample of the batch was filtered out")
        imgs = [s["img"] for s in samples]
        if self.pad_shape is not None:
            th, tw = self.pad_shape
        else:
            d = self.size_divisor
            th = -(-max(im.shape[0] for im in imgs) // d) * d
            tw = -(-max(im.shape[1] for im in imgs) // d) * d
        img = np.zeros((len(imgs), th, tw, imgs[0].shape[2]), np.float32)
        img_shape = np.zeros((len(imgs), 2), np.int32)
        for i, im in enumerate(imgs):
            h, w = im.shape[:2]
            if h > th or w > tw:
                raise ValueError(f"image ({h}, {w}) exceeds the pad shape "
                                 f"({th}, {tw})")
            img[i, :h, :w] = im
            img_shape[i] = (h, w)
        metas = [s.get("img_metas", {}) for s in samples]
        scale_factor = np.stack([
            np.asarray(m.get("scale_factor", [1, 1, 1, 1]), np.float32)
            for m in metas])
        batch = {"img": img, "img_shape": img_shape,
                 "scale_factor": scale_factor, "img_metas": metas}
        if "gt_bboxes" in samples[0]:
            batch["gt_bboxes"], batch["gt_valid"] = self._pad_boxes(
                [s["gt_bboxes"] for s in samples], self.max_gt)
            labels = np.zeros((len(samples), self.max_gt), np.int32)
            for i, s in enumerate(samples):
                n = min(len(s["gt_labels"]), self.max_gt)
                labels[i, :n] = np.asarray(s["gt_labels"])[:n]
            batch["gt_labels"] = labels
        if "gt_bboxes_ignore" in samples[0]:
            batch["gt_bboxes_ignore"], batch["gt_ignore_valid"] = \
                self._pad_boxes([s["gt_bboxes_ignore"] for s in samples],
                                self.max_gt_ignore)
        if "gt_true_bboxes" in samples[0]:
            batch["gt_true_bboxes"], _ = self._pad_boxes(
                [s["gt_true_bboxes"] for s in samples], self.max_gt)
        if "gt_anns_id" in samples[0]:
            ids = np.full((len(samples), self.max_gt), -1, np.int64)
            for i, s in enumerate(samples):
                n = min(len(s["gt_anns_id"]), self.max_gt)
                ids[i, :n] = np.asarray(s["gt_anns_id"])[:n]
            batch["gt_anns_id"] = ids
        if "gt_masks" in samples[0]:
            gm = np.zeros((len(samples), self.max_gt, th, tw), np.uint8)
            for i, s in enumerate(samples):
                m = np.asarray(s["gt_masks"])
                n = min(len(m), self.max_gt)
                gm[i, :n, :m.shape[1], :m.shape[2]] = m[:n]
            batch["gt_masks"] = gm
        return batch


class EpochSampler:
    """A deterministic permutation per epoch (seed + epoch). The JAX
    package's sharding across hosts is not ported (one device)."""

    def __init__(self, dataset_len: int, shuffle: bool = True, seed: int = 0):
        self.n = dataset_len
        self.shuffle = shuffle
        self.seed = seed

    def indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            return np.random.RandomState(self.seed + epoch).permutation(self.n)
        return np.arange(self.n)


class GroupSampler(EpochSampler):
    """Aspect-ratio-grouped batching (mmdet GroupSampler): each batch comes
    from one group of `flags`, each group padded to whole batches by
    wrapping; deterministic per epoch."""

    def __init__(self, flags: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        super().__init__(len(flags), shuffle, seed)
        self.flags = np.asarray(flags)
        self.batch_size = batch_size

    def indices(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + epoch)
        chunks = []
        for g in np.unique(self.flags):
            idx = np.where(self.flags == g)[0]
            if self.shuffle:
                idx = idx[rng.permutation(len(idx))]
            extra = (-len(idx)) % self.batch_size
            if extra and len(idx):
                idx = np.concatenate([idx, idx[:extra]])
            chunks.append(idx.reshape(-1, self.batch_size))
        batches = (np.concatenate(chunks) if chunks
                   else np.zeros((0, self.batch_size), int))
        if self.shuffle:
            batches = batches[rng.permutation(len(batches))]
        return batches.reshape(-1)


class DataLoader:
    """Batches of a map-style dataset (any indexable of sample dicts; a
    None sample is replaced by the next one), in the sampler's order, the
    last incomplete batch dropped. One background thread prepares the next
    batch while the caller uses the current one, and the samples of a
    batch load on `num_workers` threads."""

    def __init__(self, dataset, batch_size: int, collator: DetCollator,
                 shuffle: bool = True, seed: int = 0,
                 group_by_aspect: bool = False,
                 num_workers: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.num_workers = max(1, num_workers or 1)
        if group_by_aspect and hasattr(dataset, "flag"):
            self.sampler = GroupSampler(dataset.flag, batch_size, shuffle,
                                        seed)
        else:
            self.sampler = EpochSampler(len(dataset), shuffle, seed)
        self.epoch = 0

    def _epoch_indices(self) -> np.ndarray:
        idx = self.sampler.indices(self.epoch)
        if len(idx) < self.batch_size:   # tiny dataset: one full batch
            reps = int(np.ceil(self.batch_size / max(len(idx), 1)))
            idx = np.tile(idx, reps)[:self.batch_size]
        return idx

    def __len__(self) -> int:
        return len(self._epoch_indices()) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _load_one(self, i) -> Optional[dict]:
        s = self.dataset[int(i)]
        tries = 0
        while s is None and tries < 10:  # filtered sample: take the next
            i = (int(i) + 1) % len(self.dataset)
            s = self.dataset[i]
            tries += 1
        return s

    def _load_batch(self, sel, pool: ThreadPoolExecutor) -> Dict[str, Any]:
        loaded = list(pool.map(self._load_one, sel))
        return self.collator([s for s in loaded if s is not None])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._epoch_indices()
        sels = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]
        with ThreadPoolExecutor(max_workers=1) as batch_pool, \
                ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            fut = (batch_pool.submit(self._load_batch, sels[0], pool)
                   if sels else None)
            for i in range(len(sels)):
                batch = fut.result()
                if i + 1 < len(sels):
                    fut = batch_pool.submit(self._load_batch, sels[i + 1],
                                            pool)
                yield batch

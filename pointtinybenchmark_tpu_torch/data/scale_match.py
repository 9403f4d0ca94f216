"""Scale Match (WACV2020, arXiv 1912.10664) training-time rescaling.

The port's own copy of pointtinybenchmark_tpu/data/scale_match.py (host
code, numpy and PIL; TOV_mmdetection/mmdet/datasets/pipelines/
scale_match.py:15-529), registered in the port's PIPELINES: TinyPerson's
COCO-to-TinyPerson pretraining resizes each training image so that its
objects' sizes follow the target dataset's distribution. Three strategies:

- ScaleMatch: per image, src_size = exp(mean(log box sizes)); dst_size
  sampled from the target dataset's size histogram (`get_distribute`:
  bins with except_rate head/tail outlier bins, optional log-domain
  bins); scale = dst / src with up to max_sample_try resamples into
  scale_range, then clip or the default scale.
- MonotonicityScaleMatch: a monotone quantile-to-quantile mapping: the
  source dataset's sizes bucketed to the target histogram's cumsum
  (`match_distribute`); each image's src_size maps piecewise-linearly to
  a target size.
- GaussianScaleMatch: MonotonicityScaleMatch against a Gaussian size
  distribution built from equal-area bins of standard-normal samples
  (100,000 from `np.random.RandomState(gaussian_seed)` unless a sample
  file is given), log-domain piecewise interpolation, per-image sizes.

Every draw comes from the sample's `results["_rng"]` (seeded from the
dataset's seed, epoch and index), so the same seed, epoch and index give
the JAX package's image sizes. `ReAspect` re-aspects an image towards a
target mean box aspect. PIL is imported where an image is resized, not
with the module.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import get_root_logger
from ..utils.registry import PIPELINES

__all__ = ["ScaleMatchResize", "ReAspect", "ScaleMatch",
           "MonotonicityScaleMatch", "GaussianScaleMatch", "get_distribute"]


def _filter_sizes(annotations) -> np.ndarray:
    annos = [a for a in annotations if not a.get("iscrowd", 0)]
    if annos and "ignore" in annos[0]:
        annos = [a for a in annos if not a.get("ignore", 0)]
    sizes = np.sqrt(np.asarray(
        [a["bbox"][2] * a["bbox"][3] for a in annos], float))
    return sizes[sizes > 0]


def get_distribute(annotations, bins: int = 100, except_rate: float = 0.1,
                   use_log_bins: bool = False, mu_sigma=(-1, -1)):
    """Histogram (probabilities c, bin edges s) of gt sizes
    (reference _get_distribute :117-150)."""
    sizes = _filter_sizes(annotations)
    if mu_sigma[0] > 0 and mu_sigma[1] > 0:
        sizes = (sizes - sizes.mean()) / sizes.std()
        sizes = np.clip(sizes * mu_sigma[1] + mu_sigma[0], 1, None)
    if use_log_bins:
        sizes = np.log(sizes)
    sizes = np.sort(sizes)
    n = len(sizes)
    hist_sizes = sizes[int(n * except_rate / 2): int(n * (1 - except_rate / 2))]
    if except_rate > 0:
        c, s = np.histogram(hist_sizes, bins=bins - 2)
        c = np.asarray([int(n * except_rate / 2)] + c.tolist()
                       + [n - int(n * (1 - except_rate / 2))])
        s = np.asarray([sizes[0]] + s.tolist() + [sizes[-1]])
    else:
        c, s = np.histogram(hist_sizes, bins=bins)
    c = c / len(sizes)
    if use_log_bins:
        s = np.exp(s)
    return c, s


class ScaleMatch:
    def __init__(self, distribute=None, sizes=None,
                 anno_file: Optional[str] = None, bins: int = 100,
                 except_rate: float = -1.0, scale_range=(0.0, 2.0),
                 default_scale: float = 1.0, max_sample_try: int = 5,
                 out_scale_deal: str = "clip", use_log_bins: bool = False,
                 mode: str = "bilinear"):
        assert anno_file is not None or (distribute is not None and sizes is not None)
        if anno_file is not None:
            if except_rate < 0:
                except_rate = 1.0 / bins * 2
            with open(anno_file) as f:
                distribute, sizes = get_distribute(
                    json.load(f)["annotations"], bins, except_rate,
                    use_log_bins)
        self.distri_cumsum = np.cumsum(distribute)
        self.sizes = np.asarray(sizes)
        self.scale_range = scale_range
        assert out_scale_deal in ("clip", "use_default_scale")
        self.out_scale_deal = out_scale_deal
        self.max_sample_try = max_sample_try
        self.default_scale = default_scale
        self.fail_time = 0

    def _sample_by_distribute(self, rng: np.random.RandomState) -> float:
        r = rng.uniform()
        idx = np.nonzero(r <= self.distri_cumsum + 1e-6)[0][0]
        mins, maxs = self.sizes[idx], self.sizes[idx + 1]
        return float((maxs - mins) * rng.uniform() + mins)

    def _default_size(self, image_hw) -> Tuple[int, int]:
        s = self.default_scale
        return (int(round(s * image_hw[0])), int(round(s * image_hw[1])))

    @staticmethod
    def _src_size(bboxes_xyxy: np.ndarray) -> float:
        w = bboxes_xyxy[:, 2] - bboxes_xyxy[:, 0]
        h = bboxes_xyxy[:, 3] - bboxes_xyxy[:, 1]
        sizes = np.sqrt(np.clip(w * h, 0, None))
        sizes = sizes[sizes > 0]
        return float(np.exp(np.log(sizes).mean()))

    def get_new_size(self, image_hw, bboxes_xyxy: np.ndarray,
                     rng: np.random.RandomState) -> Tuple[int, int]:
        if len(bboxes_xyxy) == 0:
            return self._default_size(image_hw)
        src_size = self._src_size(bboxes_xyxy)
        scale = self.default_scale
        _scale = scale
        for _ in range(self.max_sample_try):
            dst_size = self._sample_by_distribute(rng)
            _scale = dst_size / src_size
            if self.scale_range[0] < _scale < self.scale_range[1]:
                scale = _scale
                break
        if self.out_scale_deal == "clip":
            if _scale >= self.scale_range[1]:
                scale = self.scale_range[1]
            elif _scale <= self.scale_range[0]:
                scale = self.scale_range[0]
        size = (int(round(scale * image_hw[0])),
                int(round(scale * image_hw[1])))
        # NaN guard: would every box collapse below 2px? fall back
        sf = np.asarray([size[1] / image_hw[1], size[0] / image_hw[0]])
        w = (bboxes_xyxy[:, 2] - bboxes_xyxy[:, 0]) * sf[0]
        h = (bboxes_xyxy[:, 3] - bboxes_xyxy[:, 1]) * sf[1]
        if not np.any((w + 1 >= 2) & (h + 1 >= 2)):
            self.fail_time += 1
            get_root_logger().warning(
                "Scale Match failed %d times (all boxes < 2px at scale %.3f)",
                self.fail_time, scale)
            return self._default_size(image_hw)
        return size


class MonotonicityScaleMatch(ScaleMatch):
    def __init__(self, src_anno_file: str, dst_anno_file: str,
                 bins: int = 100, except_rate: float = -1.0,
                 scale_range=(0.0, 2.0), default_scale: float = 1.0,
                 out_scale_deal: str = "clip", use_log_bins: bool = False,
                 mode: str = "bilinear", mu_sigma=(-1, -1)):
        if except_rate < 0:
            except_rate = 1.0 / bins * 2
        with open(dst_anno_file) as f:
            dst_distri, dst_sizes = get_distribute(
                json.load(f)["annotations"], bins, except_rate,
                use_log_bins, mu_sigma)
        dst_cumsum = np.cumsum(dst_distri)
        with open(src_anno_file) as f:
            src_sizes = self.match_distribute(
                json.load(f)["annotations"], dst_cumsum)
        self.src_sizes = src_sizes
        self.dst_sizes = np.asarray(dst_sizes)
        self.scale_range = scale_range
        assert out_scale_deal in ("clip", "use_default_scale")
        self.out_scale_deal = out_scale_deal
        self.default_scale = default_scale
        self.fail_time = 0

    @staticmethod
    def match_distribute(src_annotations, dst_distri_cumsum) -> np.ndarray:
        sizes = np.sort(_filter_sizes(src_annotations))
        n = len(sizes)
        src_sizes = [sizes[0]]
        for p in dst_distri_cumsum:
            src_sizes.append(sizes[min(int(p * n), n - 1)])
        if src_sizes[-1] < sizes[-1]:
            src_sizes[-1] = sizes[-1]
        return np.asarray(src_sizes)

    def _map_size(self, src_size: float) -> float:
        hits = np.nonzero(src_size <= self.src_sizes[1:] + 1e-6)[0]
        bin_i = int(hits[0]) if len(hits) else len(self.src_sizes) - 2
        dst_d = self.dst_sizes[bin_i + 1] - self.dst_sizes[bin_i]
        src_d = max(self.src_sizes[bin_i + 1] - self.src_sizes[bin_i], 1e-12)
        return float((src_size - self.src_sizes[bin_i]) / src_d * dst_d
                     + self.dst_sizes[bin_i])

    def get_new_size(self, image_hw, bboxes_xyxy: np.ndarray,
                     rng: np.random.RandomState) -> Tuple[int, int]:
        if len(bboxes_xyxy) == 0:
            return self._default_size(image_hw)
        src_size = self._src_size(bboxes_xyxy)
        dst_size = self._map_size(src_size)
        scale = dst_size / src_size
        if self.out_scale_deal == "clip":
            scale = float(np.clip(scale, self.scale_range[0],
                                  self.scale_range[1]))
        elif not (self.scale_range[0] < scale < self.scale_range[1]):
            scale = self.default_scale
        size = (int(round(scale * image_hw[0])),
                int(round(scale * image_hw[1])))
        sf = np.asarray([size[1] / image_hw[1], size[0] / image_hw[0]])
        w = (bboxes_xyxy[:, 2] - bboxes_xyxy[:, 0]) * sf[0]
        h = (bboxes_xyxy[:, 3] - bboxes_xyxy[:, 1]) * sf[1]
        if not np.any((w + 1 >= 2) & (h + 1 >= 2)):
            self.fail_time += 1
            return self._default_size(image_hw)
        return size


class GaussianScaleMatch(MonotonicityScaleMatch):
    def __init__(self, src_anno_file: str, mu_sigma, bins: int = 100,
                 except_rate: float = -1.0, scale_range=(0.0, 2.0),
                 default_scale: float = 1.0, out_scale_deal: str = "clip",
                 use_log_bins: bool = True,
                 standard_gaussian_sample_file: Optional[str] = None,
                 use_size_in_image: bool = True, min_size: float = 0,
                 num_gaussian_samples: int = 100000, gaussian_seed: int = 0,
                 mode: str = "bilinear"):
        assert use_log_bins, "GaussianScaleMatch needs use_log_bins=True"
        assert except_rate <= 0
        if except_rate < 0:
            except_rate = 1.0 / bins * 2
        mu, sigma = mu_sigma
        if standard_gaussian_sample_file:
            x = np.load(standard_gaussian_sample_file)
        else:
            x = np.random.RandomState(gaussian_seed).randn(
                num_gaussian_samples)
        dst_distri, dst_sizes = self._gaussian_distribute(
            x, mu, sigma, bins, min_size)
        dst_cumsum = np.cumsum(dst_distri)
        with open(src_anno_file) as f:
            src_sizes = self.match_distribute_gaussian(
                json.load(f)["annotations"], dst_cumsum, use_size_in_image)
        self.src_sizes = src_sizes
        self.dst_sizes = np.asarray(dst_sizes)
        self.scale_range = scale_range
        self.out_scale_deal = out_scale_deal
        self.default_scale = default_scale
        self.fail_time = 0

    @staticmethod
    def _gaussian_distribute(x, mu, sigma, bins, min_size):
        """Equal-area bins over gaussian samples, log-domain edges
        (reference :425-454)."""
        from math import ceil
        sizes = x * sigma + mu
        if min_size >= 0:
            sizes = sizes[sizes > min_size]
        sizes = np.sort(sizes)
        n = len(sizes)
        step = int(ceil(n / bins))
        last_c = n - step * (bins - 1)
        s = np.asarray(sizes[::step].tolist() + [sizes[-1]])
        c = np.asarray([step] * (bins - 1) + [last_c], float)
        c = c / n
        return c, np.exp(s)

    @staticmethod
    def match_distribute_gaussian(src_annotations, dst_cumsum,
                                  use_size_in_image=True) -> np.ndarray:
        if use_size_in_image:
            # per-image log-mean sizes, not per-object (reference :469-480)
            im2annos = {}
            for a in src_annotations:
                im2annos.setdefault(a["image_id"], []).append(a)
            per_img = []
            for annos in im2annos.values():
                sizes = _filter_sizes(annos)
                if len(sizes):
                    per_img.append(np.exp(np.log(sizes).mean()))
            sizes = np.sort(np.asarray(per_img))
        else:
            sizes = np.sort(_filter_sizes(src_annotations))
        n = len(sizes)
        src_sizes = [sizes[0]]
        for p in dst_cumsum:
            src_sizes.append(sizes[min(int(p * n), n - 1)])
        if src_sizes[-1] < sizes[-1]:
            src_sizes[-1] = sizes[-1]
        return np.asarray(src_sizes)

    def _map_size(self, src_size: float) -> float:
        hits = np.nonzero(src_size <= self.src_sizes[1:] + 1e-6)[0]
        bin_i = int(hits[0]) if len(hits) else len(self.src_sizes) - 2
        dst_d = (np.log(self.dst_sizes[bin_i + 1])
                 - np.log(self.dst_sizes[bin_i]))
        src_d = max(np.log(self.src_sizes[bin_i + 1])
                    - np.log(self.src_sizes[bin_i]), 1e-12)
        return float(np.exp(
            (np.log(src_size) - np.log(self.src_sizes[bin_i])) / src_d * dst_d
            + np.log(self.dst_sizes[bin_i])))


@PIPELINES.register_module()
class ReAspect:
    """Randomly re-aspect the image so the mean box aspect matches a target
    (reference scale_match.py:354-374)."""

    def __init__(self, aspects):
        self.aspects = tuple(aspects)  # (h/w, ...)

    def __call__(self, results: dict) -> dict:
        rng: np.random.RandomState = results.get(
            "_rng", np.random.RandomState())
        boxes = results.get("gt_bboxes", np.zeros((0, 4)))
        if len(boxes) == 0:
            return results
        target_aspect = self.aspects[rng.randint(len(self.aspects))]
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        ok = (w > 0) & (h > 0)
        if not ok.any():
            return results
        mean_aspect = float(np.exp(np.log(h[ok] / w[ok]).mean()))
        s = (target_aspect / mean_aspect) ** 0.5
        img = results["img"]
        ih, iw = img.shape[:2]
        nw, nh = int(round(iw / s)), int(round(ih * s))
        from PIL import Image
        pil = Image.fromarray(img.astype(np.uint8))
        results["img"] = np.asarray(pil.resize((nw, nh), Image.BILINEAR),
                                    dtype=np.float32)
        results["img_shape"] = results["img"].shape
        sf = np.asarray([nw / iw, nh / ih, nw / iw, nh / ih], np.float32)
        for key in results.get("bbox_fields", []):
            results[key] = results[key] * sf
        return results


_SM_TYPES = {"ScaleMatch": ScaleMatch,
             "MonotonicityScaleMatch": MonotonicityScaleMatch,
             "GaussianScaleMatch": GaussianScaleMatch}


@PIPELINES.register_module()
class ScaleMatchResize:
    """Pipeline transform wrapping a scale-match strategy
    (reference ScaleMatchResize :15-77)."""

    def __init__(self, scale_match_type: str = "ScaleMatch",
                 filter_box_size_th: float = 2, backend: str = "pil",
                 **kwargs):
        if scale_match_type not in _SM_TYPES:
            raise ValueError(scale_match_type)
        self.scale_match = _SM_TYPES[scale_match_type](**kwargs)
        self.filter_box_size_th = filter_box_size_th

    def __call__(self, results: dict) -> dict:
        assert "scale_factor" not in results and results.get("scale") is None, \
            "ScaleMatchResize must run before any Resize"
        rng: np.random.RandomState = results.get(
            "_rng", np.random.RandomState())
        img = results["img"]
        h, w = img.shape[:2]
        new_h, new_w = self.scale_match.get_new_size(
            (h, w), results.get("gt_bboxes", np.zeros((0, 4))), rng)
        if (new_h, new_w) != (h, w):
            from PIL import Image
            pil = Image.fromarray(img.astype(np.uint8))
            img = np.asarray(pil.resize((new_w, new_h), Image.BILINEAR),
                             dtype=np.float32)
        w_scale, h_scale = new_w / w, new_h / h
        results["img"] = img.astype(np.float32)
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = np.asarray(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results["keep_ratio"] = True
        for key in results.get("bbox_fields", []):
            results[key] = results[key] * results["scale_factor"]
        # drop boxes that collapsed below the size threshold (:38-53)
        if "gt_bboxes" in results:
            b = results["gt_bboxes"]
            keep = ((b[:, 2] - b[:, 0] + 1) >= self.filter_box_size_th) & \
                   ((b[:, 3] - b[:, 1] + 1) >= self.filter_box_size_th)
            results["gt_bboxes"] = b[keep]
            results["gt_labels"] = results["gt_labels"][keep]
            if "gt_anns_id" in results:
                results["gt_anns_id"] = results["gt_anns_id"][keep]
            bi = results.get("gt_bboxes_ignore")
            if bi is not None and len(bi) > 0:
                keep_i = ((bi[:, 2] - bi[:, 0] + 1) >= self.filter_box_size_th) & \
                         ((bi[:, 3] - bi[:, 1] + 1) >= self.filter_box_size_th)
                results["gt_bboxes_ignore"] = bi[keep_i]
        return results

"""Point-annotation noise and pseudo boxes, the port's own copy.

Counterpart of pointtinybenchmark_tpu/data/noise.py (numpy and json only,
copied so that the port imports nothing of the JAX package): point
annotations become fixed-size pseudo boxes (`pseudo_wh`) round the
annotated point or, with `noise_rg`, round a point drawn uniformly in the
central region of the true box (noise_rg of its width and height about the
centre, clipped to the box), from numpy's RandomState of `seed`; the true
box is kept as `true_bbox` so that refined results join back by ann id.
P2BNet's COCO config draws its points so (pseudo_wh 16x16, noise_rg 0.25).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Optional

import numpy as np

__all__ = ["generate_pseudo_bbox_for_point",
           "generate_pseudo_bbox_for_noise_data"]


def _ann_point(ann: dict, rng: np.random.RandomState,
               noise_rg: Optional[float]) -> tuple:
    """The supervision point: annotated `point` if present, else the bbox
    center; with noise_rg, sample uniformly inside the central region of the
    true box (rg as a fraction of w/h around the center)."""
    x, y, w, h = ann["bbox"]
    if "point" in ann:
        px, py = ann["point"]
    else:
        px, py = x + w / 2, y + h / 2
    if noise_rg:
        px = x + w / 2 + (rng.rand() * 2 - 1) * noise_rg * w
        py = y + h / 2 + (rng.rand() * 2 - 1) * noise_rg * h
        px = min(max(px, x), x + w)
        py = min(max(py, y), y + h)
    return px, py


def generate_pseudo_bbox_for_point(dataset: dict, pseudo_wh,
                                   noise_rg: Optional[float] = None,
                                   seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    pw, ph = (pseudo_wh if isinstance(pseudo_wh, (tuple, list))
              else (pseudo_wh, pseudo_wh))
    out = dict(dataset)
    new_anns = []
    for ann in dataset.get("annotations", []):
        ann = dict(ann)
        ann["true_bbox"] = list(ann["bbox"])
        px, py = _ann_point(ann, rng, noise_rg)
        ann["point"] = [float(px), float(py)]
        ann["bbox"] = [float(px - pw / 2), float(py - ph / 2),
                       float(pw), float(ph)]
        ann["area"] = float(pw * ph)
        new_anns.append(ann)
    out["annotations"] = new_anns
    return out


def generate_pseudo_bbox_for_noise_data(ann_file: str,
                                        data_root: Optional[str],
                                        noise_kwargs: dict) -> str:
    """Materialize the noisy/pseudo-box json (reference cocofmt.py:46-60)."""
    pseudo_wh = noise_kwargs.get("pseudo_wh")
    if pseudo_wh is None:
        raise ValueError("noise_kwargs must provide pseudo_wh")
    noise_rg = noise_kwargs.get("noise_rg")
    seed = int(noise_kwargs.get("seed", 0))
    pw, ph = (pseudo_wh if isinstance(pseudo_wh, (tuple, list))
              else (pseudo_wh, pseudo_wh))
    base, ext = osp.splitext(ann_file)
    tag = f"_pseudo_w{pw}h{ph}" + (f"_rg{noise_rg}" if noise_rg else "")
    out_file = f"{base}{tag}{ext}"
    if not osp.isfile(out_file):
        with open(ann_file) as f:
            ds = json.load(f)
        new_ds = generate_pseudo_bbox_for_point(ds, pseudo_wh, noise_rg, seed)
        with open(out_file, "w") as f:
            json.dump(new_ds, f)
    return out_file

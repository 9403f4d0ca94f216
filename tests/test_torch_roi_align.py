"""RoIAlign and level routing: the port's plain versions against the JAX
package's, on the same numpy inputs.

The port's `roi_align_multilevel_plain` is held against the XLA form
`ops/roi_align.py::roi_align_multilevel` and against the Pallas kernel run
in interpret mode (as tests/test_ops.py runs it), at atol 1e-5: the two
frameworks average a bin's samples in different orders. The port works in
NCHW and returns (R, C, S, S); the JAX functions take NHWC and return
(R, S, S, C), so the comparison transposes. `map_roi_levels` must agree
exactly, on boxes kept away from the level boundaries (sqrt(area) =
56 * 2**k), where float32 log2 may round differently in the two frameworks.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointtinybenchmark_tpu.ops.roi_align_pallas import \
    roi_align_multilevel_pallas
from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import (
    map_roi_levels, single_roi_extract)
from pointtinybenchmark_tpu_torch.ops import roi_align as tra
from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

jext = importlib.import_module(
    "pointtinybenchmark_tpu.models.roi_heads.roi_extractor")
jra = importlib.import_module("pointtinybenchmark_tpu.ops.roi_align")
C = 8


def _case(name):
    """(level shapes, strides, rois (R, 5), lvls (R,)) as numpy."""
    rng = np.random.RandomState(0 if name == "off_edge" else 1)
    if name == "off_edge":
        # random rois over two levels, some starting or ending off the map
        shapes, strides, r = [(32, 40), (16, 20)], (4, 8), 24
        b = rng.randint(0, 2, r).astype(np.float32)
        x1 = rng.rand(r) * 150 - 12
        y1 = rng.rand(r) * 120 - 12
        w = rng.rand(r) * 80 + 2
        h = rng.rand(r) * 80 + 2
        rois = np.stack([b, x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
        lvl = np.clip(np.floor(np.log2(np.sqrt(w * h) / 56 + 1e-6)), 0, 1)
        return shapes, strides, rois, lvl.astype(np.int32)
    # spans beyond the Pallas kernel's 32-cell windows (its big variants),
    # and one wholly outside the map
    shapes, strides = [(72, 80), (36, 40)], (4, 8)
    rois = np.array([
        [0, 12.3, 40.1, 12.3 + 190.0, 40.1 + 45.0],
        [1, 30.7, 8.9, 30.7 + 205.5, 8.9 + 38.0],
        [0, 50.2, 15.4, 50.2 + 44.0, 15.4 + 198.7],
        [1, 8.1, 30.0, 8.1 + 40.0, 30.0 + 186.0],
        [0, 20.0, 20.0, 20.0 + 90.0, 20.0 + 90.0],
        [1, 100.0, 90.0, 160.0, 150.0],
        [0, -40.0, -30.0, -10.0, -6.0],
    ], np.float32)
    return shapes, strides, rois, np.array([0, 0, 0, 0, 0, 1, 0], np.int32)


def _feats(shapes, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, C).astype(np.float32) for h, w in shapes]


def _nchw(feats):
    return tuple(torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats)


def _nhwc(out):
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("sr", [1, 2])
@pytest.mark.parametrize("case", ["off_edge", "big_window"])
def test_multilevel_plain_matches_jax_and_pallas(case, sr):
    shapes, strides, rois, lvls = _case(case)
    feats = _feats(shapes)
    got = _nhwc(tra.roi_align_multilevel_plain(
        _nchw(feats), torch.from_numpy(rois), torch.from_numpy(lvls),
        strides, 7, sr, True))
    jf = tuple(jnp.asarray(f) for f in feats)
    args = (jnp.asarray(rois), jnp.asarray(lvls), strides, 7, sr, True)
    want = np.asarray(jra.roi_align_multilevel(jf, *args))
    pallas = np.asarray(roi_align_multilevel_pallas(jf, *args,
                                                    interpret=True))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sr", [1, 2])
def test_multilevel_plain_matches_jax_on_edge_rois(sr, aligned):
    """The rois the card tests feed the kernel's other paths: whole-level,
    1:8 and 8:1 at level 0, zero-area, zero-width and inverted (beyond the
    Pallas kernel's windows, so against the XLA form only)."""
    shapes, strides = [(72, 80), (36, 40)], (4, 8)
    rois = np.array([
        [0, 0.0, 0.0, 320.0, 288.0],      # the whole level-0 map
        [1, 0.0, 0.0, 320.0, 288.0],      # the whole level-1 map
        [0, 10.0, 10.0, 34.0, 202.0],     # 1:8
        [1, 100.0, 20.0, 292.0, 44.0],    # 8:1
        [0, 50.0, 50.0, 50.0, 50.0],      # zero area
        [1, 30.0, 40.0, 30.0, 90.0],      # zero width
        [1, 80.0, 90.0, 40.0, 30.0],      # inverted
    ], np.float32)
    lvls = np.array([0, 1, 0, 0, 0, 0, 1], np.int32)
    feats = _feats(shapes)
    got = _nhwc(tra.roi_align_multilevel_plain(
        _nchw(feats), torch.from_numpy(rois), torch.from_numpy(lvls),
        strides, 7, sr, aligned))
    want = np.asarray(jra.roi_align_multilevel(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
        jnp.asarray(lvls), strides, 7, sr, aligned))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("aligned,out,sr", [(True, 7, 2), (False, 7, 1),
                                            (True, 14, 2)])
def test_single_level_matches_jax(aligned, out, sr):
    shapes, _, rois, _ = _case("off_edge")
    feat = _feats(shapes[:1], seed=3)[0]
    got = _nhwc(tra.roi_align(_nchw([feat])[0], torch.from_numpy(rois), 0.25,
                              out, sr, aligned))
    want = np.asarray(jra.roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                    0.25, out, sr, aligned))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unaligned_multilevel_matches_jax():
    shapes, strides, rois, lvls = _case("off_edge")
    feats = _feats(shapes)
    got = _nhwc(tra.roi_align_multilevel_plain(
        _nchw(feats), torch.from_numpy(rois), torch.from_numpy(lvls),
        strides, 7, 2, False))
    want = np.asarray(jra.roi_align_multilevel(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
        jnp.asarray(lvls), strides, 7, 2, False))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _level_boxes(n, seed):
    """Boxes whose sqrt(area) lies at least 2% from every 56 * 2**k."""
    rng = np.random.RandomState(seed)
    scale = np.exp(rng.uniform(np.log(4.0), np.log(1200.0), 4 * n))
    t = np.log2(scale / 56.0)
    scale = scale[np.abs(t - np.round(t)) > 0.03][:n]
    aspect = np.exp(rng.uniform(-1.0, 1.0, n))
    w, h = scale * np.sqrt(aspect), scale / np.sqrt(aspect)
    x1, y1 = rng.uniform(-20, 600, n), rng.uniform(-20, 500, n)
    b = rng.randint(0, 3, n)
    return np.stack([b, x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


@pytest.mark.parametrize("num_levels", [4, 2])
def test_map_roi_levels_exact(num_levels):
    rois = _level_boxes(400, seed=num_levels)
    got = map_roi_levels(torch.from_numpy(rois), num_levels).numpy()
    want = np.asarray(jext.map_roi_levels(jnp.asarray(rois), num_levels))
    assert len(np.unique(want)) == num_levels
    np.testing.assert_array_equal(got, want)


def test_single_roi_extract_matches_jax():
    shapes = [(64, 80), (32, 40), (16, 20), (8, 10)]
    strides = (4, 8, 16, 32)
    feats = _feats(shapes, seed=5)
    rois = _level_boxes(60, seed=9)
    rois[:, 0] = np.random.RandomState(4).randint(0, 2, 60)
    got = _nhwc(single_roi_extract(_nchw(feats), torch.from_numpy(rois),
                                   strides, 7, 1))
    want = np.asarray(jext.single_roi_extract(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), strides,
        7, 1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_routing_cpu_plain_other_device_raises():
    """CPU tensors take the plain version and launch nothing; a device with
    no kernel (here `meta`) raises instead of falling back."""
    shapes, strides, rois, lvls = _case("big_window")
    feats = _nchw(_feats(shapes))
    before = dict(roi_align_cuda.launches)
    got = tra.roi_align_multilevel(feats, torch.from_numpy(rois),
                                   torch.from_numpy(lvls), strides, 7, 2)
    want = tra.roi_align_multilevel_plain(feats, torch.from_numpy(rois),
                                          torch.from_numpy(lvls), strides,
                                          7, 2)
    assert torch.equal(got, want) and got.shape == (7, C, 7, 7)
    assert roi_align_cuda.launches == before
    meta = torch.zeros((3, 5), device="meta")
    with pytest.raises(RuntimeError, match="no RoIAlign kernel"):
        tra.roi_align_multilevel(feats, meta, torch.zeros(3, device="meta"),
                                 strides)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        roi_align_cuda.roi_align_forward(feats, torch.from_numpy(rois),
                                         torch.from_numpy(lvls), strides)

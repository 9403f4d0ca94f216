"""The MMDet V1.x box coder and anchors, and the Seesaw and GHM losses: the
port against the JAX package on the same numpy inputs.

- `legacy_bbox2delta` / `legacy_delta2bbox` (with and without the clip to
  max_shape - 1) and `delta_coder_fns`' dispatch: within 1e-6 relative;
- `LegacyAnchorGenerator`'s base anchors and grids for the legacy Faster
  R-CNN's and RetinaNet's configs (scales, octave scales, centre offset
  0.5): equal;
- `GHMC`, `GHMR` and `SeesawLoss` (with and without `class_counts`,
  weight and avg_factor; background labels; logits of exactly 0): values
  within 1e-6 relative and gradients within 1e-6 of their max;
- the train step of the LVIS Seesaw config and of the GHM RetinaNet at toy
  width raises the TypeError that the JAX package's does, with its message
  (JAX raises while it traces the loss; the RoI head hands SeesawLoss its
  C + 1 columns, the anchor head calls GHMC with `weight=`). Inference of
  the Seesaw config runs.
"""
import copy
import importlib
import sys
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.core.anchors import LegacyAnchorGenerator
from pointtinybenchmark_tpu_torch.core.bbox import (delta_coder_fns,
                                                   legacy_bbox2delta,
                                                   legacy_delta2bbox)
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.losses import (GHMC, GHMR,
                                                        SeesawLoss,
                                                        build_loss)
from pointtinybenchmark_tpu_torch.utils.config import Config

sys.path.insert(0, osp.dirname(__file__))
from test_torch_init import toy  # noqa: E402

jbbox = importlib.import_module("pointtinybenchmark_tpu.core.bbox")
janchors = importlib.import_module("pointtinybenchmark_tpu.core.anchors")
jadv = importlib.import_module("pointtinybenchmark_tpu.models.losses.advanced")

IMG_HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * 40 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_legacy_coder_matches_jax():
    rng = np.random.RandomState(0)
    p, g = _boxes(rng, 60), _boxes(rng, 60)
    args = ((0.0, 0.1, 0.0, -0.1), (0.1, 0.1, 0.2, 0.2))
    got = legacy_bbox2delta(torch.from_numpy(p), torch.from_numpy(g), *args)
    want = np.asarray(jbbox.legacy_bbox2delta(jnp.asarray(p), jnp.asarray(g),
                                              *args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    d = (rng.randn(60, 4) * 2).astype(np.float32)      # some past the clip
    for shape in (None, (70, 90)):
        got = legacy_delta2bbox(torch.from_numpy(p), torch.from_numpy(d),
                                *args, max_shape=shape)
        want = np.asarray(jbbox.legacy_delta2bbox(
            jnp.asarray(p), jnp.asarray(d), *args, max_shape=shape))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    enc, dec = delta_coder_fns(dict(type="LegacyDeltaXYWHBBoxCoder"))
    assert (enc, dec) == (legacy_bbox2delta, legacy_delta2bbox)
    with pytest.raises(NotImplementedError):
        delta_coder_fns(dict(type="TBLRBBoxCoder"))


@pytest.mark.parametrize("name", ["legacy_1x/faster_rcnn_r50_fpn_1x_coco_v1.py",
                                  "legacy_1x/retinanet_r50_fpn_1x_coco_v1.py"])
def test_legacy_anchors_match_jax(name):
    model = Config.fromfile(f"configs/{name}").model
    head = model.get("rpn_head") or model["bbox_head"]
    cfg = dict(head["anchor_generator"])
    cfg.pop("type")
    mine, ref = LegacyAnchorGenerator(**cfg), \
        janchors.LegacyAnchorGenerator(**cfg)
    for a, b in zip(mine.base_anchors, ref.base_anchors):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert np.array_equal(a, np.round(a))
    sizes = [(25, 34), (13, 17), (7, 9), (4, 5), (2, 3)]
    for a, b in zip(mine.grid_anchors(sizes), ref.grid_anchors(sizes)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(mine.valid_flags(sizes, (100, 130)),
                    ref.valid_flags(sizes, (100, 130))):
        np.testing.assert_array_equal(a, np.asarray(b))


def _value_and_grad(jax_loss, port_loss, pred, *args, **kwargs):
    v, g = jax.value_and_grad(lambda x: jax_loss(
        x, *[jnp.asarray(a) for a in args],
        **{k: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for k, a in kwargs.items()}))(jnp.asarray(pred))
    x = torch.tensor(pred, requires_grad=True)
    out = port_loss(x, *[torch.from_numpy(a) for a in args],
                    **{k: torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a for k, a in kwargs.items()})
    out.backward()
    np.testing.assert_allclose(out.item(), float(v), rtol=1e-6)
    g = np.asarray(g)
    assert np.abs(x.grad.numpy() - g).max() <= 1e-6 * np.abs(g).max()


def test_ghmc_matches_jax():
    rng = np.random.RandomState(1)
    pred = (rng.randn(200, 5) * 3).astype(np.float32)
    pred[:4] = 0.0
    target = (rng.rand(200, 5) < 0.1).astype(np.float32)
    lw = (rng.rand(200, 5) < 0.9).astype(np.float32)
    kw = dict(bins=30, momentum=0.75, loss_weight=1.0)
    _value_and_grad(jadv.GHMC(**kw), GHMC(**kw), pred, target, lw)


def test_ghmr_matches_jax():
    rng = np.random.RandomState(2)
    pred = (rng.randn(2, 100, 4) * 0.1).astype(np.float32)
    target = (rng.randn(2, 100, 4) * 0.1).astype(np.float32)
    target[0, :3] = pred[0, :3]
    lw = (rng.rand(2, 100, 1) < 0.3).astype(np.float32)
    kw = dict(mu=0.02, bins=10, momentum=0.7, loss_weight=10.0)
    _value_and_grad(jadv.GHMR(**kw), GHMR(**kw), pred, target, lw)


@pytest.mark.parametrize("counts", [None, "given"])
def test_seesaw_matches_jax(counts):
    rng = np.random.RandomState(3)
    c = 12
    pred = (rng.randn(300, c) * 2).astype(np.float32)
    pred[:2] = 0.0
    # a long tail: class 0 common, most rare, some labels background (c)
    target = np.minimum(rng.geometric(0.35, 300) - 1, c).astype(np.int64)
    weight = rng.rand(300).astype(np.float32)
    cc = (None if counts is None
          else (rng.rand(c) * 50).astype(np.float32).tolist())
    kw = dict(p=0.8, q=2.0, num_classes=c, class_counts=cc)
    _value_and_grad(jadv.SeesawLoss(**kw), SeesawLoss(**kw), pred, target,
                    weight=weight, avg_factor=120.0)


def _batch():
    rng = np.random.RandomState(4)
    samples = [dict(img=rng.randn(*IMG_HW, 3).astype(np.float32),
                    gt_bboxes=np.asarray([[10, 8, 30, 36], [40, 20, 62, 52]],
                                         np.float32),
                    gt_labels=np.asarray([3, 7], np.int64))
               for _ in range(2)]
    return DetCollator(IMG_HW, max_gt=4)(samples)


def _jax_reason(model, train_cfg, test_cfg, batch):
    """The exception JAX's train forward raises on the batch (at trace
    time: nothing is compiled)."""
    jm = jax_build(copy.deepcopy(model), train_cfg, test_cfg)
    img = jnp.zeros((1,) + IMG_HW + (3,))
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img,
                                               train=False))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k in ("gt_bboxes", "gt_labels", "gt_valid", "img_shape")}
    with pytest.raises(TypeError) as err:
        jax.eval_shape(lambda v: jm.apply(
            v, jnp.asarray(batch["img"]), jb,
            method=jm.forward_train, rngs={"sampler": jax.random.PRNGKey(1)},
            mutable=["batch_stats"]), variables)
    return str(err.value)


@pytest.mark.parametrize("name,start", [
    ("coco/faster_rcnn_r50_fpn_seesaw_1x_lvis.py",
     "mul got incompatible shapes for broadcasting: (1024, 1204), "
     "(1024, 1203)."),
    ("coco/retinanet_ghm_r50_fpn_1x_coco.py",
     "GHMC.__call__() got an unexpected keyword argument 'weight'")])
def test_train_step_refuses_as_jax(name, start):
    cfg = Config.fromfile(f"configs/{name}")
    model = toy(cfg.model)
    train_cfg, test_cfg = (cfg.to_dict()["train_cfg"],
                           cfg.to_dict()["test_cfg"])
    batch = _batch()
    reason = _jax_reason(model, train_cfg, test_cfg, batch)
    assert reason == start, reason
    port = build_detector(copy.deepcopy(model), train_cfg, test_cfg,
                          device="cpu").train()
    tb = batch_to_device(batch, "cpu")
    with pytest.raises(TypeError) as err:
        port.forward_train(tb.pop("img"), tb,
                           torch.Generator().manual_seed(0))
    assert str(err.value) == reason
    if "seesaw" in name:
        # inference: 1,203 classes, softmax over 1,204 columns
        with torch.no_grad():
            dets = port.eval()(torch.from_numpy(batch["img"][:1]))
        assert dets.bboxes.shape[-1] == 5
    assert isinstance(build_loss(dict(model.get("bbox_head", {}).get(
        "loss_cls") or model["roi_head"]["bbox_head"]["loss_cls"])),
        (SeesawLoss, GHMC))

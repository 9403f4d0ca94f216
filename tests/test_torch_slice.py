"""The whole slice: the JAX package's `inference_detector_tiled` and the
port's, on the same config, the same JAX-initialized weights and the same
uint8 frame.

The detector is tests/test_device_pipeline.py's tiny one at depth 50
(base_channels=8) on a 128x192 frame cut into 64x96 tiles. Per-tile NMS,
the tile shift and the global merge all run. The focal-prior init keeps
every score near 0.01 and far too close together for two frameworks to
order them alike, so `retina_cls` is redrawn (the same numbers on both
sides) to spread the scores. nms_pre covers whole levels and max_per_img
every kept box, so no near-tie at a top-k boundary picks different
candidates. Detections are compared at the tests/test_detector_golden.py:88
tolerances.
"""
import numpy as np
import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.apis.inference import DetectorHandle
from pointtinybenchmark_tpu.apis.inference import \
    inference_detector_tiled as jax_tiled
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu_torch.apis.inference import (
    inference_detector_tiled, init_detector)
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables

CFG_TEXT = """
img_norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
test_pipeline = [
    dict(type="LoadImageFromFile"),
    dict(type="CroppedTilesFlipAug", tile_shape=(96, 64), tile_overlap=(16, 16),
         scale_factor=[1.0], flip=False,
         transforms=[
             dict(type="Resize", keep_ratio=True),
             dict(type="RandomFlip"),
             dict(type="Normalize", **img_norm),
             dict(type="Pad", size=(64, 96)),
             dict(type="Collect", keys=["img"]),
         ]),
]
data = dict(test=dict(type="CocoFmtDataset", ann_file="", img_prefix="",
                      pipeline=test_pipeline))
loader = dict(pad_shape=(64, 96))
model = dict(
    type="SingleStageDetector",
    backbone=dict(type="ResNet", depth=50, base_channels=8),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(
        type="RetinaHead", num_classes=2, in_channels=16,
        feat_channels=16, stacked_convs=1,
        anchor_generator=dict(type="AnchorGenerator", octave_base_scale=2,
                              scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(target_means=[0, 0, 0, 0], target_stds=[1, 1, 1, 1]),
        loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                      alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0)))
test_cfg = dict(nms_pre=4000, score_thr=0.65,
                nms=dict(type="nms", iou_threshold=0.5), max_per_img=1000)
"""


def _dets(res):
    order = np.argsort(-res["bboxes"][:, 4], kind="stable")
    return res["bboxes"][order], res["labels"][order]


def test_tiled_slice_matches_jax(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text(CFG_TEXT)
    cfg = JaxConfig.fromfile(str(path))
    jm = jax_build(dict(cfg.model), None, cfg.test_cfg)
    # init_detector's own init, jitted (eager init of ResNet-50 is slow)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.array, variables)
    cls = variables["params"]["bbox_head_m"]["retina_cls"]
    rng = np.random.RandomState(0)
    cls["kernel"] = (rng.randn(*cls["kernel"].shape) * 0.02).astype(np.float32)
    cls["bias"] = np.zeros_like(cls["bias"])
    jh = DetectorHandle(jm, jax.tree_util.tree_map(jnp.asarray, variables),
                        None, cfg, None)

    th = init_detector(str(path), device="cpu")
    load_jax_variables(th.model, variables["params"],
                       variables["batch_stats"])

    frame = np.random.RandomState(6).randint(0, 256, (128, 192, 3), np.uint8)
    (rb, rl), (gb, gl) = _dets(jax_tiled(jh, frame)), \
        _dets(inference_detector_tiled(th, frame))
    assert rb.shape[0] > 0
    assert gb.shape == rb.shape, (gb.shape, rb.shape)
    np.testing.assert_allclose(gb[:, 4], rb[:, 4], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gb[:, :4], rb[:, :4], atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(gl, rl)

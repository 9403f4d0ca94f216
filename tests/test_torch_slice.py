"""The whole slice: the JAX package's `inference_detector_tiled` and the
port's, on the same config, the same JAX-initialized weights and the same
uint8 frame.

The detectors are tiny: tests/test_device_pipeline.py's RetinaNet at depth
50 (base_channels=8), a Faster R-CNN of the same backbone, FPN 16 and 2 FCs
of 32, and a Mask R-CNN that adds a 1-convolution FCNMaskHead at 8 channels
and samples both RoIAligns with sampling_ratio=0 (which becomes 2), on a
128x192 frame cut into 64x96 tiles. Per-tile NMS (and for the two-stage
detectors the RPN's proposal NMS and the RoIAlign), the tile shift and the
global merge all run; the tiled engine merges detections only and drops
the mask probabilities, in both packages. Random init leaves the scores far too close
together for two frameworks to order them alike, so the classifier that
scores each stage (`retina_cls`; `rpn_cls` and `fc_cls`) is redrawn, the
same numbers on both sides, to spread them. nms_pre covers whole levels and
max_per_img every kept box, so no near-tie at a top-k boundary picks
different candidates. Detections are compared at the
tests/test_detector_golden.py:88 tolerances (same count, box atol 2e-3,
score atol 1e-4, same labels), one to one: two detections whose scores lie
closer than the score tolerance may come out in either order.
"""
import numpy as np
import pytest
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
FRCNN_MODEL = """
model = dict(
    type="FasterRCNN",
    backbone=dict(type="ResNet", depth=50, base_channels=8),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              num_outs=5),
    rpn_head=dict(
        type="RPNHead", num_classes=1, in_channels=16, feat_channels=16,
        anchor_generator=dict(type="AnchorGenerator", scales=[2],
                              ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0, 0, 0, 0],
                        target_stds=[1.0, 1.0, 1.0, 1.0]),
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True)),
    roi_head=dict(
        type="StandardRoIHead",
        bbox_roi_extractor=dict(
            roi_layer=dict(type="RoIAlign", output_size=7, sampling_ratio=1),
            out_channels=16, featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(
            type="Shared2FCBBoxHead", num_classes=2, in_channels=16,
            fc_out_channels=32, roi_feat_size=7,
            bbox_coder=dict(type="DeltaXYWHBBoxCoder",
                            target_means=[0, 0, 0, 0],
                            target_stds=[0.1, 0.1, 0.2, 0.2]),
            loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False))))
test_cfg = dict(
    rpn=dict(nms_pre=4000, max_per_img=2000,
             nms=dict(type="nms", iou_threshold=0.7), min_bbox_size=0),
    rcnn=dict(score_thr=0.3, nms=dict(type="nms", iou_threshold=0.5),
              max_per_img=3000))
"""
# Faster R-CNN's with sampling_ratio=0 and a mask branch
MASK_MODEL = FRCNN_MODEL.replace(
    'type="FasterRCNN"', 'type="MaskRCNN"').replace(
    "output_size=7, sampling_ratio=1", "output_size=7, sampling_ratio=0"
).replace("""            loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False))))""",
          """            loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=False)),
        mask_roi_extractor=dict(
            type="SingleRoIExtractor",
            roi_layer=dict(type="RoIAlign", output_size=14, sampling_ratio=0),
            out_channels=16, featmap_strides=[4, 8, 16, 32]),
        mask_head=dict(type="FCNMaskHead", num_convs=1, in_channels=16,
                       conv_out_channels=8, num_classes=2)))""")


def _dets(res):
    order = np.argsort(-res["bboxes"][:, 4], kind="stable")
    return res["bboxes"][order], res["labels"][order]


def _assert_dets_match(ref, got, atol_box=2e-3, atol_score=1e-4):
    """Each reference detection matched to its own detection of `got` with
    the same label, a score within atol_score and a box within atol_box
    (both rtol 1e-4). Rows are score-sorted, so candidates sit near."""
    (rb, rl), (gb, gl) = ref, got
    assert gb.shape == rb.shape, (gb.shape, rb.shape)
    used = np.zeros(len(gb), bool)
    for i in range(len(rb)):
        near = np.abs(gb[:, 4] - rb[i, 4]) <= atol_score + 1e-4 * abs(rb[i, 4])
        ok = (near & ~used & (gl == rl[i])
              & (np.abs(gb[:, :4] - rb[i, :4])
                 <= atol_box + 1e-4 * np.abs(rb[i, :4])).all(1))
        assert ok.any(), (i, rb[i], rl[i], gb[i], gl[i])
        used[np.argmax(ok)] = True


# per detector: the config's model part and (scope, classifier, scale) of
# each classifier redrawn to spread the scores
DETECTORS = {
    "retinanet": (None, [(("bbox_head_m",), "retina_cls", 0.02)]),
    "faster_rcnn": (FRCNN_MODEL, [(("rpn_head_m",), "rpn_cls", 0.3),
                                  (("roi_head_m", "bbox_head_m"), "fc_cls",
                                   0.3)]),
    "mask_rcnn": (MASK_MODEL, [(("rpn_head_m",), "rpn_cls", 0.3),
                               (("roi_head_m", "bbox_head_m"), "fc_cls",
                                0.3)]),
}


@pytest.mark.parametrize("detector", ["retinanet", "faster_rcnn",
                                      "mask_rcnn"])
def test_tiled_slice_matches_jax(tmp_path, detector):
    model_text, redraw = DETECTORS[detector]
    text = CFG_TEXT
    if model_text is not None:
        text = text[:text.index("model = dict(")] + model_text
    path = tmp_path / "cfg.py"
    path.write_text(text)
    cfg = JaxConfig.fromfile(str(path))
    jm = jax_build(dict(cfg.model), None, cfg.test_cfg)
    # init_detector's own init, jitted (eager init of ResNet-50 is slow)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.RandomState(0)
    for scope, name, scale in redraw:
        tree = variables["params"]
        for key in scope:
            tree = tree[key]
        tree[name]["kernel"] = (rng.randn(*tree[name]["kernel"].shape)
                                * scale).astype(np.float32)
        tree[name]["bias"] = np.zeros_like(tree[name]["bias"])
    jh = DetectorHandle(jm, jax.tree_util.tree_map(jnp.asarray, variables),
                        None, cfg, None)

    th = init_detector(str(path), device="cpu")
    load_jax_variables(th.model, variables["params"],
                       variables["batch_stats"])

    frame = np.random.RandomState(6).randint(0, 256, (128, 192, 3), np.uint8)
    ref = _dets(jax_tiled(jh, frame))
    assert ref[0].shape[0] > 0
    _assert_dets_match(ref, _dets(inference_detector_tiled(th, frame)))

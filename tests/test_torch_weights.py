"""Weight naming: the port's state_dict round-trips through the repo's
torch -> JAX converter and `load_jax_variables`, and the port imports no
JAX."""
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools",
                            "model_converters"))
from torch2jax import convert_detector_state_dict  # noqa: E402

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
MODEL_CFG = dict(
    type="SingleStageDetector",
    backbone=dict(type="ResNet", depth=50, base_channels=8),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(
        type="RetinaHead", num_classes=1, in_channels=16, feat_channels=16,
        stacked_convs=4,
        anchor_generator=dict(type="AnchorGenerator", octave_base_scale=2,
                              scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        loss_cls=dict(type="FocalLoss", use_sigmoid=True)))

FRCNN_CFG = dict(
    type="FasterRCNN",
    backbone=dict(type="ResNet", depth=50, base_channels=8),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              num_outs=5),
    rpn_head=dict(
        type="RPNHead", num_classes=1, in_channels=16, feat_channels=16,
        anchor_generator=dict(type="AnchorGenerator", scales=[2],
                              ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True)),
    roi_head=dict(
        type="StandardRoIHead",
        bbox_roi_extractor=dict(
            roi_layer=dict(type="RoIAlign", output_size=7, sampling_ratio=1),
            featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(type="Shared2FCBBoxHead", num_classes=1,
                       in_channels=16, fc_out_channels=32, roi_feat_size=7)))


def _to_jax(model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=50)
    assert not unmapped, unmapped
    return params, stats


def _randomize_buffers(model, seed):
    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if "running" in name:
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)


def test_state_dict_round_trip():
    src = build_detector(dict(MODEL_CFG), device="cpu", seed=1)
    _randomize_buffers(src, 2)
    dst = build_detector(dict(MODEL_CFG), device="cpu", seed=3)
    load_jax_variables(dst, *_to_jax(src))
    want, got = src.state_dict(), dst.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_converted_tree_is_the_jax_models_tree():
    """torch2jax of the port's state_dict gives exactly the leaves, paths
    and shapes that the JAX model itself declares."""
    params, stats = _to_jax(build_detector(dict(MODEL_CFG), device="cpu"))
    jm = jax_build(dict(MODEL_CFG))
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))

    def flat(tree):
        return {jax.tree_util.keystr(p): tuple(np.shape(v)) for p, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(params) == flat(shapes["params"])
    assert flat(stats) == flat(shapes["batch_stats"])


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf"])
def test_load_rejects_unconsumed_or_missing_leaves(fault):
    model = build_detector(dict(MODEL_CFG), device="cpu")
    params, stats = _to_jax(model)
    head = params["bbox_head_m"]
    if fault == "extra_leaf":
        head["retina_cls"]["scale"] = np.ones(3, np.float32)
    else:
        del head["retina_reg"]
    with pytest.raises(KeyError):
        load_jax_variables(model, params, stats)


def test_port_imports_no_jax():
    code = ("import sys, pointtinybenchmark_tpu_torch.apis.inference, "
            "pointtinybenchmark_tpu_torch.utils.jax_weights, "
            "pointtinybenchmark_tpu_torch.engine.train, "
            "pointtinybenchmark_tpu_torch.engine.optimizer, "
            "pointtinybenchmark_tpu_torch.engine.checkpoint, "
            "pointtinybenchmark_tpu_torch.core.assigners, "
            "pointtinybenchmark_tpu_torch.core.samplers, "
            "pointtinybenchmark_tpu_torch.ops.iou, "
            "pointtinybenchmark_tpu_torch.models.losses, "
            "pointtinybenchmark_tpu_torch.data.loader; "
            "assert not {'jax', 'flax', 'optax', 'msgpack'} & "
            "set(sys.modules); "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'pointtinybenchmark_tpu']")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _flat_shapes(tree):
    return {jax.tree_util.keystr(p): tuple(np.shape(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_faster_rcnn_state_dict_round_trip():
    """RPN and RoI-head weights, the row-permuted shared_fc0 included, go
    through torch2jax and back unchanged, every JAX leaf consumed."""
    src = build_detector(dict(FRCNN_CFG), device="cpu", seed=1)
    _randomize_buffers(src, 2)
    dst = build_detector(dict(FRCNN_CFG), device="cpu", seed=3)
    load_jax_variables(dst, *_to_jax(src))
    want, got = src.state_dict(), dst.state_dict()
    assert want.keys() == got.keys()
    assert "roi_head.bbox_head.shared_fcs.0.weight" in want
    assert "rpn_head.rpn_conv.weight" in want
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_faster_rcnn_tree_is_the_jax_models_tree():
    params, stats = _to_jax(build_detector(dict(FRCNN_CFG), device="cpu"))
    jm = jax_build(dict(FRCNN_CFG))
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    assert _flat_shapes(params) == _flat_shapes(shapes["params"])
    assert _flat_shapes(stats) == _flat_shapes(shapes["batch_stats"])


def test_shared_fc0_gives_the_jax_product():
    """The JAX head's first FC on (R, 7, 7, C) features flattened (h, w, c)
    equals the port's on the same features as (R, C, 7, 7), flattened
    (c, h, w), with the kernel carried across by `load_jax_variables`."""
    model = build_detector(dict(FRCNN_CFG), device="cpu")
    params, stats = _to_jax(model)
    rng = np.random.RandomState(4)
    fc0 = params["roi_head_m"]["bbox_head_m"]["shared_fc0"]
    fc0["kernel"] = rng.randn(*fc0["kernel"].shape).astype(np.float32)
    fc0["bias"] = rng.randn(*fc0["bias"].shape).astype(np.float32)
    load_jax_variables(model, params, stats)
    x = rng.randn(5, 7, 7, 16).astype(np.float32)
    want = x.reshape(5, -1) @ fc0["kernel"] + fc0["bias"]
    with torch.no_grad():
        got = model.roi_head.bbox_head.shared_fcs[0](
            torch.from_numpy(x).permute(0, 3, 1, 2).flatten(1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


MASK_CFG = dict(FRCNN_CFG, type="MaskRCNN", roi_head=dict(
    FRCNN_CFG["roi_head"],
    mask_roi_extractor=dict(
        roi_layer=dict(type="RoIAlign", output_size=14, sampling_ratio=0),
        featmap_strides=[4, 8, 16, 32]),
    mask_head=dict(type="FCNMaskHead", num_convs=2, in_channels=16,
                   conv_out_channels=16, num_classes=1)))


def _mask_rcnn_to_jax(model):
    """torch2jax for every module it knows; the mask head, which it does not
    convert, by hand: conv kernels OIHW -> HWIO, the transposed
    convolution's (in, out, kh, kw) -> flax's (kh, kw, in, out) with its
    taps flipped."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=50)
    assert sorted(unmapped) == sorted(
        k for k in sd if k.startswith("roi_head.mask_head."))
    head = params["roi_head_m"]["mask_head_m"] = {}
    for k in unmapped:
        mod, leaf = k[len("roi_head.mask_head."):].rsplit(".", 1)
        name = (mod if mod in ("upsample", "conv_logits")
                else f"conv{mod.split('.')[1]}")
        v = sd[k]
        if leaf == "weight" and name == "upsample":
            v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif leaf == "weight":
            v = v.transpose(2, 3, 1, 0)
        head.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = \
            np.ascontiguousarray(v)
    return params, stats


def test_mask_rcnn_state_dict_round_trip():
    """Every port entry, the mask head's included, goes to a JAX leaf and
    back unchanged: `load_jax_variables` consumes every leaf of the tree,
    which is the JAX Mask R-CNN's own, and fills every entry."""
    src = build_detector(dict(MASK_CFG), device="cpu", seed=1)
    _randomize_buffers(src, 2)
    params, stats = _mask_rcnn_to_jax(src)
    jm = jax_build(dict(MASK_CFG))
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    assert _flat_shapes(params) == _flat_shapes(shapes["params"])
    assert _flat_shapes(stats) == _flat_shapes(shapes["batch_stats"])
    dst = build_detector(dict(MASK_CFG), device="cpu", seed=3)
    load_jax_variables(dst, params, stats)
    want, got = src.state_dict(), dst.state_dict()
    assert want.keys() == got.keys()
    assert "roi_head.mask_head.upsample.weight" in want
    assert "roi_head.mask_head.convs.1.conv.weight" in want
    for k in want:
        assert torch.equal(want[k], got[k]), k

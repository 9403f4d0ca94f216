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
            "pointtinybenchmark_tpu_torch.utils.jax_weights; "
            "assert 'jax' not in sys.modules; "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'pointtinybenchmark_tpu']")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)

"""The port's seeded weights against the JAX package's initialisers.

For each of the fifteen configurations the port runs (PERF.md section 4),
cut to toy width (ResNet-18 at base_channels=8, FPN and heads at 16
channels, GroupNorm of 4 groups, FCs of 32; 32 channels where a head's
`norm_cfg=None` builds GroupNorm of 32 groups), `build_detector(seed=0)`
and the JAX twin's jitted `model.init` from its own key are paired
parameter by parameter through `utils/jax_weights.py`'s name map. The
two RNGs differ, so the values are compared as distributions:

- a parameter that JAX draws constant (biases, GN and BN scales and
  shifts, BN's running statistics, the 0.01 prior) is equal;
- a random kernel of at least 1,000 entries has the JAX kernel's shape,
  a standard deviation within 10% of the JAX draw's, a mean under 0.1 of
  it, and no entry beyond 2 sqrt(1 / fan_in) / 0.8796, the truncation of
  flax's lecun_normal, with fan_in from the JAX kernel's layout
  (kh * kw * in, or `in` for a dense layer).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (_leaves,
                                                            _torch_key,
                                                            jax_to_state_dict,
                                                            roi_feat_size)

CONFIGS = (
    "tinyperson/retinanet_r50_fpns4_1x_tinyperson640_clipg.py",
    "tinyperson/faster_rcnn_r50_fpn_1x_tinyperson640.py",
    "coco/mask_rcnn_r50_fpn_1x_coco.py",
    "tinyperson/p2p_r50_fpns4_1x_tinyperson640.py",
    "tinypersonv2/cpr/coarse_point_refine_r50_fpns4_1x_tinypersonv2_640.py",
    "p2b/p2bnet_r50_fpn_1x_coco.py",
    "ssd_det/ssd_det_r50_fpn_1x_coco.py",
    "tinyperson/fcos_r50_fpns4_1x_tinyperson640.py",
    "tinyperson/atss_r50_fpns4_1x_tinyperson640.py",
    "tinyperson/reppoints_r50_fpns4_1x_tinyperson640.py",
    "tinyperson/grid_rcnn_r50_fpn_1x_tinyperson640.py",
    "tinyperson/fovea_r50_fpns4_1x_tinyperson640.py",
    "tinyperson/free_anchor_r50_fpns4_1x_tinyperson640.py",
    "tinyperson/vfnet_r50_fpns4_1x_tinyperson640.py",
    "coco/cascade_rcnn_r50_fpn_1x_coco.py",
)
WIDTH, GROUPS, FC = 16, 4, 32
# heads whose `norm_cfg=None` builds GroupNorm of 32 groups (in both
# packages): at toy width they get 32 channels
GN32_HEADS = ("FCOSHead", "ATSSHead", "RepPointsHead", "VFNetHead")
TRUNC = 0.87962566103423978       # std of a standard normal cut at +-2


def toy(model: dict) -> dict:
    """The config's model at toy width: every structural key kept."""
    m = copy.deepcopy(model)
    head = m.get("bbox_head") or {}
    width = (32 if head.get("type") in GN32_HEADS
             and not head.get("norm_cfg") else WIDTH)
    m["backbone"].update(depth=18, base_channels=8)
    m["neck"]["in_channels"] = [8, 16, 32, 64]
    m["neck"]["out_channels"] = width
    heads = [m.get("bbox_head"), m.get("rpn_head"), m["neck"]]
    roi = m.get("roi_head")
    if roi:
        bbox = roi["bbox_head"]
        # a cascade's list of heads, one a stage
        heads += (list(bbox) if isinstance(bbox, (list, tuple)) else [bbox])
        heads += [roi.get("mask_head"), roi.get("grid_head")]
    for h in filter(None, heads):
        for k, v in (("in_channels", width), ("feat_channels", width),
                     ("point_feat_channels", width),
                     ("conv_out_channels", width), ("fc_out_channels", FC),
                     ("fc_channels", FC)):
            if k in h and h is not m["neck"]:
                h[k] = v
        if h.get("norm_cfg"):
            h["norm_cfg"] = dict(h["norm_cfg"], num_groups=GROUPS)
    return m


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_weights_follow_the_jax_initialisers(name):
    cfg = Config.fromfile(f"configs/{name}")
    model_cfg = toy(cfg.model)
    jm = jax_build(copy.deepcopy(model_cfg), cfg.get("train_cfg"),
                   cfg.get("test_cfg"))
    args = (jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    # the draw does not depend on XLA's optimisations; compiling without
    # them halves the file's time
    init = jax.jit(lambda r, x: jm.init(r, x, train=False)).lower(
        *args).compile({"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True})
    variables = jax.tree_util.tree_map(np.asarray, init(*args))
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    port = build_detector(copy.deepcopy(model_cfg), cfg.get("train_cfg"),
                          cfg.get("test_cfg"), device="cpu", seed=0)
    own = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = jax_to_state_dict(params, stats, roi_feat_size(port),
                             basic_blocks=True)
    assert set(want) == set(own)
    n_lateral = sum(1 for k in params["neck_m"]
                    if k.startswith("lateral_conv"))
    fan_in = {_torch_key(path, n_lateral, basic=True):
              int(np.prod(np.shape(v)[:-1]))
              for path, v in _leaves(params) if path[-1] == "kernel"}
    n_random, wrong = 0, []
    for key, w in want.items():
        p = own[key]
        assert tuple(p.shape) == tuple(w.shape), key
        if bool((w == w.reshape(-1)[0]).all()):
            if not torch.equal(p, w):
                wrong.append((key, "constant"))
            continue
        if w.numel() < 1000:
            continue
        n_random += 1
        std, got = float(w.std()), float(p.std())
        bound = 2 * np.sqrt(1.0 / fan_in[key]) / TRUNC
        assert float(w.abs().max()) <= bound, (key, "JAX", bound)
        if abs(got - std) > 0.1 * std:
            wrong.append((key, "std", got, std))
        elif abs(float(p.mean())) >= 0.1 * std:
            wrong.append((key, "mean", float(p.mean()), std))
        elif float(p.abs().max()) > bound:
            wrong.append((key, "max", float(p.abs().max()), bound))
    assert n_random >= 20, n_random
    assert not wrong, "\n".join(map(str, wrong))

"""DetectoRS: the switchable atrous convolution, the DetectoRS ResNet and
ResNeXt, the recursive feature pyramid and the whole detector, the port
against the JAX package on the same numpy inputs and the same weights.

- `SAConv2d` at stride 1 and 2 (and grouped), its `weight_diff`,
  `weight_beta`, switch and contexts redrawn away from their zero and
  constant inits: the output within 1e-5 and the gradients of a weighted
  sum with respect to the input and every parameter within 1e-4 of each
  tensor's max (the AWS standardisation's std has ddof 0, the switch's
  pool reads a reflect-padded input);
- `DetectoRS_ResNet` (ResNet-50 of base 8, SAC in stages 2-4) and
  `DetectoRS_ResNeXt` (2 groups of base width 32) given fed-back features
  through nonzero `rfp_conv`s, with BN statistics redrawn: every stage's
  output;
- `RFP` (the backbone above as its feedback copy, ASPP of 4) with a
  nonzero `rfp_weight`, the port in training mode with the feedback
  backbone's `norm_eval` off: the JAX detector runs its neck without
  `train`, so the feedback backbone normalises by its running statistics
  in both;
- coco/detectors_htc_r50_1x_coco.py at toy width (tests/test_torch_init.py
  ::toy: ResNet-50 of base 16, FPN 16, ASPP of 4) with 3 classes, `simple_test` on two 64x96 images: detections at
  tests/test_detector_golden.py:88's tolerances;
- the trainable set: the port's optimizer freezes exactly what JAX's
  `frozen_param_mask` does for `frozen_stages=1`: the backbone's
  `layer1_block*`, not its `stem_conv` / `stem_bn` (JAX's rule finds the
  stem by the anonymous names `Conv_0` / `BatchNorm_0`), nor anything of
  the feedback copy under the neck.

The JAX functions are compiled without XLA's backend optimisations
(FAST_COMPILE), but the SAC gradients, which are held to the optimised
compile. Weights go to the port through utils/jax_weights.py. Torch runs
on one thread.
"""
import copy
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.engine.optimizer import frozen_param_mask
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.models.backbones.detectors_resnet import (
    DetectoRS_ResNet as JaxDetectoRSResNet, DetectoRS_ResNeXt as JaxResNeXt,
    SAConv2d as JaxSAConv2d)
from pointtinybenchmark_tpu.models.necks.rfp import RFP as JaxRFP
from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.backbones.detectors_resnet import (
    DetectoRS_ResNet, DetectoRS_ResNeXt, SAConv2d)
from pointtinybenchmark_tpu_torch.models.necks.rfp import RFP
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_param_paths, jax_to_state_dict, load_jax_variables)

sys.path.insert(0, osp.dirname(__file__))
from test_torch_init import toy  # noqa: E402
from test_torch_slice import _assert_dets_match  # noqa: E402

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
IMG_HW = (64, 96)
IMG_SHAPES = np.asarray([[64, 96], [56, 88]], np.int32)
NC = 3
DETECTORS = "coco/detectors_htc_r50_1x_coco.py"
BACKBONE = dict(depth=50, base_channels=8, sac=dict(type="SAC"),
                stage_with_sac=(False, True, True, True))
RESNEXT = dict(BACKBONE, groups=2, base_width=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _redrawn(tree, rng, skip=()):
    """The tree with every leaf redrawn, normal around its own scale:
    zero and constant inits (SAC's diff, beta, switch and contexts, the
    RFP convs, BN's statistics) become values that matter. Leaves named
    in `skip` are kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redrawn(v, rng, skip)
            continue
        v = np.asarray(v, np.float32)
        if k in skip:
            out[k] = v
        elif k == "var":
            out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        else:
            scale = max(float(np.abs(v).std()), 0.1)
            out[k] = (v + rng.randn(*v.shape) * scale * 0.3).astype(
                np.float32)
    return out


def _port_state(tree, prefix, scope):
    """Flax params/batch_stats of a module that sits at `scope` under
    `prefix` ("backbone_m" or "neck_m") in a detector -> its port
    state_dict, through utils/jax_weights.py's map."""
    wrap = lambda t: {prefix: _nest(scope, t)} if t else None
    sd = jax_to_state_dict(wrap(tree["params"]),
                           wrap(tree.get("batch_stats")))
    head = {"backbone_m": "backbone.", "neck_m": "neck."}[prefix] + \
        "".join(f"{s}." for s in _port_scope(scope))
    return {k[len(head):]: v for k, v in sd.items()}


def _load(module, sd):
    """Load `sd` into `module`: every entry, BN's num_batches_tracked
    (which JAX has not) left as it is."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing


def _nest(scope, tree):
    for s in reversed(scope):
        tree = {s: tree}
    return tree


def _port_scope(scope):
    out = []
    for s in scope:
        out += s.replace("_block", ".").split(".")
    return out


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (2, 2)])
def test_saconv_matches_jax(stride, groups):
    rng = np.random.RandomState(10 * stride + groups)
    x = rng.randn(2, 13, 18, 8).astype(np.float32)
    mod = JaxSAConv2d(8, 12, stride=stride, groups=groups)
    params = _redrawn(jax.tree_util.tree_map(
        np.asarray, _compiled(mod.init, jax.random.PRNGKey(0), x)["params"]),
        rng, skip=("weight",))
    r = rng.randn(*mod.apply({"params": params}, x).shape).astype(
        np.float32)

    def loss(p, xx):
        out = mod.apply({"params": p}, xx)
        return (out * r).sum(), out

    (_, want), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)

    conv = SAConv2d(8, 12, stride=stride, groups=groups)
    scope = ("layer2_block0", "conv2_sac")
    conv.load_state_dict(_port_state({"params": params}, "backbone_m",
                                     scope))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = conv(tx)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(r.transpose(0, 3, 1, 2).copy())).sum().backward()
    want_g = _port_state({"params": jax.tree_util.tree_map(
        np.asarray, g_params)}, "backbone_m", scope)
    pairs = [(dict(conv.named_parameters())[k].grad.numpy(), w.numpy())
             for k, w in want_g.items()]
    pairs.append((tx.grad.numpy(), np.asarray(g_x).transpose(0, 3, 1, 2)))
    assert len(pairs) == 11
    for got, w in pairs:
        assert np.abs(got - w).max() / max(np.abs(w).max(), 1e-12) < 1e-4


def _fed_back(rng, c=16):
    """Fed-back features of a 64x96 image: levels 1-3 at strides 8-32."""
    return [None] + [rng.randn(2, IMG_HW[0] // s, IMG_HW[1] // s, c).astype(
        np.float32) for s in (8, 16, 32)]


@pytest.mark.parametrize("kind", ["resnet", "resnext"])
def test_detectors_backbone_matches_jax(kind):
    rng = np.random.RandomState(3)
    cfg = BACKBONE if kind == "resnet" else RESNEXT
    jcls, pcls = ((JaxDetectoRSResNet, DetectoRS_ResNet) if kind == "resnet"
                  else (JaxResNeXt, DetectoRS_ResNeXt))
    jbb = jcls(rfp_inplanes=16, **cfg)
    img = rng.randn(2, *IMG_HW, 3).astype(np.float32)
    feats = _fed_back(rng)
    variables = _compiled(lambda r, x, f: jbb.init(r, x, rfp_feats=f),
                          jax.random.PRNGKey(0), img, feats)
    variables = _redrawn(jax.tree_util.tree_map(np.asarray, variables), rng)
    want = _compiled(lambda v, x, f: jbb.apply(v, x, rfp_feats=f),
                     variables, img, feats)
    bb = pcls(rfp_inplanes=16, **cfg)
    _load(bb, _port_state(variables, "backbone_m", ()))
    assert float(bb.layer2[0].rfp_conv.weight.detach().abs().sum()) > 0
    with torch.no_grad():
        got = bb.eval()(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                        [None] + [torch.from_numpy(
                            f.transpose(0, 3, 1, 2).copy())
                            for f in feats[1:]])
    assert len(got) == 4
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_rfp_matches_jax():
    rng = np.random.RandomState(4)
    bb_cfg = dict(BACKBONE, norm_eval=False)
    kwargs = dict(in_channels=[32, 64, 128, 256], out_channels=16,
                  num_outs=5, rfp_steps=2, aspp_out_channels=4)
    jneck = JaxRFP(rfp_backbone=bb_cfg, **kwargs)
    inputs = [rng.randn(2, *IMG_HW, 3).astype(np.float32)] + [
        rng.randn(2, IMG_HW[0] // s, IMG_HW[1] // s, c).astype(np.float32)
        for s, c in zip((4, 8, 16, 32), (32, 64, 128, 256))]
    variables = _compiled(jneck.init, jax.random.PRNGKey(0), inputs)
    variables = _redrawn(jax.tree_util.tree_map(np.asarray, variables), rng)
    assert float(np.abs(variables["params"]["rfp_weight"]["kernel"]).sum())
    want = _compiled(jneck.apply, variables, inputs)
    neck = RFP(rfp_backbone=dict(bb_cfg, type="DetectoRS_ResNet"), **kwargs)
    _load(neck, _port_state(variables, "neck_m", ()))
    with torch.no_grad():
        got = neck.train()([torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()) for x in inputs])
    assert not any(m.training for m in neck.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    assert len(got) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.fixture(scope="module")
def detectors():
    """The toy DetectoRS (JAX and port, the same weights; `rpn_cls` and
    each stage's `fc_cls` redrawn as tests/test_torch_cascade.py's)."""
    cfg = Config.fromfile(f"configs/{DETECTORS}")
    model = toy(cfg.model)
    for h in model["roi_head"]["bbox_head"]:
        h["num_classes"] = NC
    train_cfg = cfg.to_dict()["train_cfg"]
    test_cfg = copy.deepcopy(cfg.to_dict()["test_cfg"])
    test_cfg["rpn"].update(nms_pre=1000, max_per_img=60)
    test_cfg["rcnn"].update(score_thr=0.0, max_per_img=300)
    jm = jax_build(copy.deepcopy(model), train_cfg, test_cfg)
    variables = _compiled(lambda r, x: jm.init(r, x, train=False),
                          jax.random.PRNGKey(0),
                          jnp.zeros((1,) + IMG_HW + (3,)))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.RandomState(7)
    params = variables["params"]
    k = params["rpn_head_m"]["rpn_cls"]["kernel"]
    params["rpn_head_m"]["rpn_cls"]["kernel"] = (
        rng.randn(*k.shape) * 0.3).astype(np.float32)
    for key in sorted(params["roi_head_m"]):
        k = params["roi_head_m"][key]["fc_cls"]["kernel"]
        params["roi_head_m"][key]["fc_cls"]["kernel"] = (
            rng.randn(*k.shape) * 0.5).astype(np.float32)
    # the RFP's fusion and feedback away from their zero inits
    neck = params["neck_m"]
    neck["rfp_weight"]["kernel"] = (rng.randn(
        *neck["rfp_weight"]["kernel"].shape) * 0.1).astype(np.float32)
    port = build_detector(copy.deepcopy(model), train_cfg, test_cfg,
                          device="cpu")
    load_jax_variables(port, params, variables["batch_stats"])
    return jm, variables, port.eval(), cfg


def test_detector_simple_test_matches_jax(detectors):
    jm, variables, port, _ = detectors
    rng = np.random.RandomState(3)
    img = rng.randn(2, *IMG_HW, 3).astype(np.float32)
    img[1, 56:] = 0.0
    img[1, :, 88:] = 0.0
    want = _compiled(lambda v, x, s: jm.apply(v, x, s, method=jm.simple_test),
                     variables, img, IMG_SHAPES)[0]
    with torch.no_grad():
        got = port.simple_test(torch.from_numpy(img),
                               torch.from_numpy(IMG_SHAPES))
    for i in range(2):
        jv, pv = np.asarray(want.valid)[i], got.valid[i].numpy()
        jb, jl = np.asarray(want.bboxes)[i][jv], np.asarray(want.labels)[i][jv]
        pb, pl = got.bboxes[i].numpy()[pv], got.labels[i].numpy()[pv]
        assert len(jb) > 20, len(jb)
        jo, po = np.argsort(-jb[:, 4], kind="stable"), \
            np.argsort(-pb[:, 4], kind="stable")
        _assert_dets_match((jb[jo], jl[jo]), (pb[po], pl[po]))


def test_trainable_set_is_jax(detectors):
    """The optimizer's frozen parameters, by their flax paths, are those
    JAX's frozen_param_mask marks (frozen_stages=1)."""
    _, variables, port, cfg = detectors
    assert port.backbone.frozen_stages == 1
    mask = frozen_param_mask(variables["params"], 1)
    want = {".".join(str(getattr(k, "key", k)) for k in path)
            for path, trainable in
            jax.tree_util.tree_flatten_with_path(mask)[0] if not trainable}
    opt = build_optimizer(port, cfg.optimizer, frozen_stages=1)
    paths = jax_param_paths(port)
    got = {paths[n] for n, f in zip(opt.names, opt.is_frozen) if f}
    assert got == want
    assert got and all(p.startswith("backbone_m.layer1_block") for p in got)
    trainable = {paths[n] for n, f in zip(opt.names, opt.is_frozen)
                 if not f}
    assert "backbone_m.stem_conv.kernel" in trainable
    assert "neck_m.rfp_backbone0.layer1_block0.conv1.kernel" in trainable

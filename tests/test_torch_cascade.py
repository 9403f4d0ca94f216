"""Cascade R-CNN and the MMDet V1.x legacy two-stage configs: the port
against the JAX package on the same numpy inputs and the same weights.

The toy detectors are the full configs cut to toy width by
tests/test_torch_init.py::toy (ResNet-18 of base 8, FPN 16, 2 FCs of 32
in every stage) with 3 classes; the JAX model's init carried to the port
through utils/jax_weights.py. Random init leaves every softmax score near
1 / 4, too close together for two frameworks to order alike, so `rpn_cls`
and each stage's `fc_cls` are redrawn (std 0.3 and 0.5, the same numbers
on both sides), and the RoI score threshold is 0.

- `CascadeRoIHead.simple_test` on the same FPN maps and proposals, and the
  whole `CascadeRCNN.simple_test` on two 64x96 images (the second padded
  from 56x88), for coco/cascade_rcnn_r50_fpn_1x_coco.py and
  legacy_1x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py (RoIAlign
  aligned=False, the legacy coder in every stage), and the legacy v1
  Faster R-CNN's: detections at tests/test_detector_golden.py:88's
  tolerances (the same count, labels, box atol 2e-3, score atol 1e-4).
- `forward_train`'s six stage losses (loss_s{i}_cls, loss_s{i}_bbox, with
  the stage weights) and s{i}_num_pos within 1e-5 relative, and their
  gradients with respect to every stage head's parameters and to the FPN
  maps within 1e-4 of each tensor's max. Every stage's sampler covers
  every candidate (num 4,096 >= proposals + 3 x gts, pos_fraction 1), as
  chip_smoke.py's `covering_budgets` does, so that neither side's random
  draw matters: the rois come in another order (their sums run in
  another order) but are the same set at every stage.
- a `mask_head` key is refused (JAX's cascade has no mask branch).

The JAX functions are compiled without XLA's backend optimisations
(FAST_COMPILE), but the gradients, which are held to the optimised
compile as tests/test_torch_grid.py's are. Torch runs on one thread.
"""
import copy
import sys
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import load_jax_variables

sys.path.insert(0, osp.dirname(__file__))
from test_torch_init import toy  # noqa: E402
from test_torch_slice import _assert_dets_match  # noqa: E402

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
IMG_HW = (64, 96)
IMG_SHAPES = np.asarray([[64, 96], [56, 88]], np.int32)
NC = 3
CASCADE = "coco/cascade_rcnn_r50_fpn_1x_coco.py"
LEGACY_CASCADE = "legacy_1x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py"
LEGACY_FRCNN = "legacy_1x/faster_rcnn_r50_fpn_1x_coco_v1.py"
PROPOSALS = 60
GT_BOXES = ([[10.5, 8.0, 30.5, 36.0], [40.0, 20.0, 62.0, 52.0],
             [66.0, 4.0, 90.0, 26.0]],
            [[4.0, 30.0, 34.0, 50.0], [50.0, 6.0, 72.0, 30.0]])
GT_LABELS = ([0, 1, 2], [1, 0])
MAX_GT = 4
COVERING = dict(type="RandomSampler", num=4096, pos_fraction=1.0,
                neg_pos_ub=-1, add_gt_as_proposals=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name):
    """The config's model at toy width with NC classes, its train and test
    configs; the RoI score threshold 0 and at most 300 detections."""
    cfg = Config.fromfile(f"configs/{name}")
    model = toy(cfg.model)
    roi = model["roi_head"]
    heads = roi["bbox_head"] if isinstance(roi["bbox_head"], list) \
        else [roi["bbox_head"]]
    for h in heads:
        h["num_classes"] = NC
    test_cfg = copy.deepcopy(cfg.to_dict()["test_cfg"])
    test_cfg["rpn"].update(nms_pre=1000, max_per_img=PROPOSALS)
    test_cfg["rcnn"].update(score_thr=0.0, max_per_img=300)
    return model, cfg.to_dict()["train_cfg"], test_cfg


def _models(name):
    """The JAX model and its variables (seeded, `rpn_cls` and each
    stage's `fc_cls` redrawn), and the port's model with them."""
    model, train_cfg, test_cfg = _config(name)
    jm = jax_build(copy.deepcopy(model), train_cfg, test_cfg)
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False)).lower(
        jax.random.PRNGKey(0), jnp.zeros((1,) + IMG_HW + (3,))).compile(
        FAST_COMPILE)(jax.random.PRNGKey(0), jnp.zeros((1,) + IMG_HW + (3,)))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rng = np.random.RandomState(7)
    cls = params["rpn_head_m"]["rpn_cls"]
    cls["kernel"] = (rng.randn(*cls["kernel"].shape) * 0.3).astype(
        np.float32)
    roi = params["roi_head_m"]
    for key in sorted(roi):
        if "fc_cls" in roi[key]:
            k = roi[key]["fc_cls"]["kernel"]
            roi[key]["fc_cls"]["kernel"] = (rng.randn(*k.shape) * 0.5
                                            ).astype(np.float32)
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(
                     np.array, variables["batch_stats"])}
    port = build_detector(copy.deepcopy(model), train_cfg, test_cfg,
                          device="cpu")
    load_jax_variables(port, variables["params"], variables["batch_stats"])
    return jm, variables, port.eval()


@pytest.fixture(scope="module")
def cascade():
    return _models(CASCADE)


def _images():
    rng = np.random.RandomState(3)
    img = rng.randn(2, *IMG_HW, 3).astype(np.float32)
    img[1, 56:] = 0.0
    img[1, :, 88:] = 0.0
    return img


def _dets(res, i):
    """Image i's valid detections of a DetResult (numpy, either side),
    score-sorted."""
    b = np.asarray(res.bboxes)[i]
    lab = np.asarray(res.labels)[i]
    v = np.asarray(res.valid)[i]
    b, lab = b[v], lab[v]
    order = np.argsort(-b[:, 4], kind="stable")
    return b[order], lab[order]


def _compare(jres, pres):
    for i in range(2):
        want = _dets(jres, i)
        got = _dets(jax.tree_util.tree_map(
            lambda t: t.detach().numpy(), pres), i)
        assert len(want[0]) > 20, len(want[0])
        _assert_dets_match(want, got)


def _jax_simple_test(jm, variables, img):
    fn = jax.jit(lambda v, x, s: jm.apply(v, x, s, method=jm.simple_test))
    return fn.lower(variables, img, IMG_SHAPES).compile(FAST_COMPILE)(
        variables, img, IMG_SHAPES)[0]


@pytest.mark.parametrize("name", [CASCADE, LEGACY_CASCADE, LEGACY_FRCNN])
def test_detector_simple_test_matches_jax(name, cascade):
    jm, variables, port = cascade if name == CASCADE else _models(name)
    img = _images()
    want = _jax_simple_test(jm, variables, jnp.asarray(img))
    with torch.no_grad():
        got = port.simple_test(torch.from_numpy(img),
                               torch.from_numpy(IMG_SHAPES))
    _compare(want, got)


def _feats(rng):
    """FPN maps (NHWC for JAX) of the toy's 4 RoI levels and 5th."""
    return [rng.randn(2, IMG_HW[0] // s, IMG_HW[1] // s, 16).astype(
        np.float32) for s in (4, 8, 16, 32, 64)]


def _proposals(rng):
    xy = rng.rand(2, PROPOSALS, 2) * [80, 50]
    wh = rng.rand(2, PROPOSALS, 2) * [30, 30] + 4
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((2, PROPOSALS), bool)
    valid[1, -7:] = False
    boxes[1, -7:] = 0.0
    return boxes, valid


def _nchw(feats):
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
            for f in feats]


def test_cascade_roi_head_simple_test_matches_jax(cascade):
    jm, variables, port = cascade
    rng = np.random.RandomState(11)
    feats = _feats(rng)
    boxes, valid = _proposals(rng)
    fn = jax.jit(lambda v, f, p, pv, s: jm.apply(
        v, f, p, pv, s,
        method=lambda m, *a: m.roi_head_m.simple_test(*a)))
    args = (variables, [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
            jnp.asarray(valid), jnp.asarray(IMG_SHAPES))
    want = fn.lower(*args).compile(FAST_COMPILE)(*args)
    with torch.no_grad():
        got = port.roi_head.simple_test(
            _nchw(feats), torch.from_numpy(boxes), torch.from_numpy(valid),
            torch.from_numpy(IMG_SHAPES))
    _compare(want, got)


def _train_batch():
    gtb = np.zeros((2, MAX_GT, 4), np.float32)
    gtl = np.zeros((2, MAX_GT), np.int32)
    gtv = np.zeros((2, MAX_GT), bool)
    for i in range(2):
        n = len(GT_BOXES[i])
        gtb[i, :n] = GT_BOXES[i]
        gtl[i, :n] = GT_LABELS[i]
        gtv[i, :n] = True
    return dict(gt_bboxes=gtb, gt_labels=gtl, gt_valid=gtv,
                img_shape=IMG_SHAPES)


def test_cascade_forward_train_matches_jax(cascade):
    """The six stage losses and the num_pos counts, and the gradients of
    their sum with respect to every stage head and the FPN maps."""
    jm, variables, _ = cascade
    model, train_cfg, test_cfg = _config(CASCADE)
    train_cfg = copy.deepcopy(train_cfg)
    for stage in train_cfg["rcnn"]:
        stage["sampler"] = dict(COVERING)
    jm = jax_build(copy.deepcopy(model), train_cfg, test_cfg)
    port = build_detector(copy.deepcopy(model), train_cfg, test_cfg,
                          device="cpu")
    load_jax_variables(port, variables["params"], variables["batch_stats"])
    rng = np.random.RandomState(12)
    feats = _feats(rng)
    boxes, valid = _proposals(rng)
    batch = _train_batch()

    def losses(roi_params, f):
        params = dict(variables["params"], roi_head_m=roi_params)
        out = jm.apply({"params": params}, f, jnp.asarray(boxes),
                       jnp.asarray(valid),
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(5),
                       method=lambda m, *a: m.roi_head_m.forward_train(*a))
        return sum(v for k, v in out.items() if k.startswith("loss")), out

    jf = [jnp.asarray(f) for f in feats]
    (_, want), (g_params, g_feats) = jax.jit(jax.value_and_grad(
        losses, argnums=(0, 1), has_aux=True))(
        variables["params"]["roi_head_m"], jf)

    head = port.roi_head.train()
    tf = [t.requires_grad_(True) for t in _nchw(feats)]
    got = head.forward_train(
        tf, torch.from_numpy(boxes), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    assert len([k for k in got if k.startswith("loss")]) == 6
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(got["s0_num_pos"]) > 5
    sum(v for k, v in got.items() if k.startswith("loss")).backward()

    for i in range(3):
        jh = g_params[f"bbox_heads_{i}"]
        ph = head.bbox_head[i]
        pairs = [(jh[f"shared_fc{j}"]["kernel"], ph.shared_fcs[j].weight)
                 for j in range(2)]
        pairs += [(jh[n]["kernel"], getattr(ph, n).weight)
                  for n in ("fc_cls", "fc_reg")]
        pairs += [(jh[n]["bias"], getattr(ph, n).bias)
                  for n in ("fc_cls", "fc_reg")]
        for j, (w, p) in enumerate(pairs):
            w = np.asarray(w)
            if j == 0:                       # rows (h, w, c) -> (c, h, w)
                w = w.reshape(7, 7, 16, -1).transpose(2, 0, 1, 3).reshape(
                    -1, w.shape[-1])
            w = w.T if w.ndim == 2 else w
            scale = max(np.abs(w).max(), 1e-12)
            err = np.abs(p.grad.numpy() - w).max() / scale
            assert err < 1e-4, (i, j, err)
    for f, g in zip(tf, g_feats):
        want_g = np.asarray(g).transpose(0, 3, 1, 2)
        scale = max(np.abs(want_g).max(), 1e-12)
        got_g = f.grad.numpy() if f.grad is not None else 0 * want_g
        assert np.abs(got_g - want_g).max() / scale < 1e-4


def test_cascade_refuses_a_mask_head():
    """JAX's cascade has no mask branch (its builder would drop the key):
    the port refuses it rather than build another network."""
    model, train_cfg, test_cfg = _config(CASCADE)
    model["roi_head"]["mask_head"] = dict(type="FCNMaskHead", num_classes=NC,
                                          in_channels=16)
    with pytest.raises(NotImplementedError) as err:
        build_detector(model, train_cfg, test_cfg, device="cpu")
    assert "CascadeRoIHead: config keys ['mask_head']" in str(err.value)

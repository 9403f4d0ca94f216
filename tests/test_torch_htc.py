"""Hybrid Task Cascade and SCNet: the port against the JAX package on the
same numpy inputs and the same weights.

The toy detectors are coco/htc_r50_fpn_1x_coco.py and
coco/scnet_r50_fpn_1x_coco.py cut to toy width by
tests/test_torch_init.py::toy (ResNet-18 of base 8, FPN 16, 2 FCs of 32
in each of the 3 stages), with 3 classes and one convolution in every mask,
semantic and context head; the JAX model's init carried to the port
through utils/jax_weights.py. As in tests/test_torch_cascade.py, `rpn_cls`
and each stage's `fc_cls` are redrawn (std 0.3 and 0.5) and the RoI score
threshold is 0; each mask head's `conv_logits` is redrawn at std 0.5 so
that the masks differ from 1/2 by more than float noise.

- the whole detector's `simple_test` on two 64x96 images, and the RoI
  head's on the same FPN maps and proposals: detections at
  tests/test_detector_golden.py:88's tolerances, each matched detection's
  14x14 mask within 1e-4;
- the RoI head's `forward_train` with every stage's sampler covering every
  candidate (num 4,096, pos_fraction 1, as chip_smoke.py's
  `covering_budgets`), so that neither side's random draw matters:
  loss_semantic_seg, loss_s{i}_cls / bbox / mask (HTC), loss_glbctx and
  loss_mask (SCNet) within 1e-5 relative, and the gradients of their sum
  with respect to every RoI head parameter and the FPN maps within 1e-4 of
  each tensor's max;
- `FusedSemanticHead` on levels that shrink and levels that grow to the
  fusion level (the antialias rule of `jax.image.resize`), and
  `_semantic_loss` on overlapping instances and on a `gt_semantic_seg`
  with a 255 region; torch's "nearest-exact" samples the pixels that
  `jax.image.resize(..., "nearest")` does.

The JAX functions, the gradients' too, are compiled without XLA's
backend optimisations (FAST_COMPILE). Torch runs on one thread.
"""
import copy
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.models.roi_heads.htc_roi_head import \
    FusedSemanticHead as JaxSemanticHead
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.roi_heads.htc_roi_head import \
    FusedSemanticHead
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)

sys.path.insert(0, osp.dirname(__file__))
from test_torch_init import toy  # noqa: E402

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
IMG_HW = (64, 96)
IMG_SHAPES = np.asarray([[64, 96], [56, 88]], np.int32)
NC = 3
HTC = "coco/htc_r50_fpn_1x_coco.py"
SCNET = "coco/scnet_r50_fpn_1x_coco.py"
PROPOSALS = 60
GT_BOXES = ([[10.5, 8.0, 30.5, 36.0], [40.0, 20.0, 62.0, 52.0],
             [66.0, 4.0, 90.0, 26.0]],
            [[4.0, 30.0, 34.0, 50.0], [50.0, 6.0, 72.0, 30.0]])
GT_LABELS = ([0, 1, 2], [1, 0])
MAX_GT = 4
COVERING = dict(type="RandomSampler", num=4096, pos_fraction=1.0,
                neg_pos_ub=-1, add_gt_as_proposals=True)
MASK_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name, covering=False):
    """The config's model at toy width with NC classes and one conv in
    each branch head, its train config (every stage's sampler covering,
    where asked) and test config (RoI score threshold 0)."""
    cfg = Config.fromfile(f"configs/{name}")
    model = toy(cfg.model)
    roi = model["roi_head"]
    for h in roi["bbox_head"]:
        h["num_classes"] = NC
    roi["mask_head"].update(num_classes=NC, num_convs=1)
    roi["semantic_head"]["num_convs"] = 1
    if "glbctx_head" in roi:
        roi["glbctx_head"]["num_convs"] = 1
    train_cfg = copy.deepcopy(cfg.to_dict()["train_cfg"])
    if covering:
        for stage in train_cfg["rcnn"]:
            stage["sampler"] = dict(COVERING)
    test_cfg = copy.deepcopy(cfg.to_dict()["test_cfg"])
    test_cfg["rpn"].update(nms_pre=1000, max_per_img=PROPOSALS)
    test_cfg["rcnn"].update(score_thr=0.0, max_per_img=300)
    return model, train_cfg, test_cfg


def _models(name):
    """The JAX model and its variables (seeded; `rpn_cls`, each stage's
    `fc_cls` and each mask head's `conv_logits` redrawn), and the port's
    model with them."""
    model, train_cfg, test_cfg = _config(name)
    jm = jax_build(copy.deepcopy(model), train_cfg, test_cfg)
    args = (jax.random.PRNGKey(0), jnp.zeros((1,) + IMG_HW + (3,)))
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False)).lower(
        *args).compile(FAST_COMPILE)(*args)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rng = np.random.RandomState(7)
    cls = params["rpn_head_m"]["rpn_cls"]
    cls["kernel"] = (rng.randn(*cls["kernel"].shape) * 0.3).astype(
        np.float32)
    roi = params["roi_head_m"]
    for key in sorted(roi):
        for leaf, std in (("fc_cls", 0.5), ("conv_logits", 0.5)):
            if key.startswith(("bbox_heads_", "mask_heads_")) \
                    and leaf in roi[key]:
                k = roi[key][leaf]["kernel"]
                roi[key][leaf]["kernel"] = (rng.randn(*k.shape) * std
                                            ).astype(np.float32)
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(
                     np.array, variables["batch_stats"])}
    port = build_detector(copy.deepcopy(model), train_cfg, test_cfg,
                          device="cpu")
    load_jax_variables(port, variables["params"], variables["batch_stats"])
    return jm, variables, port.eval()


@pytest.fixture(scope="module")
def models():
    return {HTC: _models(HTC), SCNET: _models(SCNET)}


def _images():
    rng = np.random.RandomState(3)
    img = rng.randn(2, *IMG_HW, 3).astype(np.float32)
    img[1, 56:] = 0.0
    img[1, :, 88:] = 0.0
    return img


def _feats(rng):
    """FPN maps (NHWC for JAX) of the toy's 5 levels."""
    return [rng.randn(2, IMG_HW[0] // s, IMG_HW[1] // s, 16).astype(
        np.float32) for s in (4, 8, 16, 32, 64)]


def _nchw(feats):
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
            for f in feats]


def _proposals(rng):
    xy = rng.rand(2, PROPOSALS, 2) * [80, 50]
    wh = rng.rand(2, PROPOSALS, 2) * [30, 30] + 4
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((2, PROPOSALS), bool)
    valid[1, -7:] = False
    boxes[1, -7:] = 0.0
    return boxes, valid


def _match(ref, got, atol_box=2e-3, atol_score=1e-4):
    """tests/test_torch_slice.py::_assert_dets_match on one image's valid
    detections (bboxes (n, 5), labels): returns the matched index of
    `got` for each row of `ref`."""
    (rb, rl), (gb, gl) = ref, got
    assert gb.shape == rb.shape, (gb.shape, rb.shape)
    used = np.zeros(len(gb), bool)
    pairs = []
    for i in range(len(rb)):
        near = np.abs(gb[:, 4] - rb[i, 4]) <= atol_score + 1e-4 * abs(
            rb[i, 4])
        ok = (near & ~used & (gl == rl[i])
              & (np.abs(gb[:, :4] - rb[i, :4])
                 <= atol_box + 1e-4 * np.abs(rb[i, :4])).all(1))
        assert ok.any(), (i, rb[i], rl[i])
        used[np.argmax(ok)] = True
        pairs.append(int(np.argmax(ok)))
    return pairs


def _compare(want, got):
    """JAX's (DetResult, masks) against the port's: every valid
    detection matched, its mask within MASK_TOL."""
    (jd, jm), (pd, pm) = want, got
    pd = jax.tree_util.tree_map(lambda t: t.detach().numpy(), pd)
    pm = pm.detach().numpy()
    for i in range(2):
        jv, pv = np.asarray(jd.valid)[i], pd.valid[i]
        jb, jl = np.asarray(jd.bboxes)[i][jv], np.asarray(jd.labels)[i][jv]
        pb, pl = pd.bboxes[i][pv], pd.labels[i][pv]
        assert len(jb) > 20, len(jb)
        pairs = _match((jb, jl), (pb, pl))
        jmask, pmask = np.asarray(jm)[i][jv], pm[i][pv][pairs]
        assert jmask.shape[1:] == (14, 14)
        assert np.abs(jmask - pmask).max() < MASK_TOL
        assert np.abs(jmask - 0.5).max() > 0.05       # masks, not noise


@pytest.mark.parametrize("name", [HTC, SCNET])
def test_detector_simple_test_matches_jax(name, models):
    jm, variables, port = models[name]
    img = _images()
    fn = jax.jit(lambda v, x, s: jm.apply(v, x, s, method=jm.simple_test))
    want = fn.lower(variables, img, IMG_SHAPES).compile(FAST_COMPILE)(
        variables, img, IMG_SHAPES)[0]
    with torch.no_grad():
        got = port.simple_test(torch.from_numpy(img),
                               torch.from_numpy(IMG_SHAPES))
    _compare(want, got)


@pytest.mark.parametrize("name", [HTC, SCNET])
def test_roi_head_simple_test_matches_jax(name, models):
    jm, variables, port = models[name]
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
    """The gts of GT_BOXES with their masks: each box's ellipse, two of
    them overlapping another's."""
    gtb = np.zeros((2, MAX_GT, 4), np.float32)
    gtl = np.zeros((2, MAX_GT), np.int32)
    gtv = np.zeros((2, MAX_GT), bool)
    masks = np.zeros((2, MAX_GT) + IMG_HW, np.uint8)
    yy, xx = np.mgrid[:IMG_HW[0], :IMG_HW[1]] + 0.5
    for i in range(2):
        n = len(GT_BOXES[i])
        gtb[i, :n] = GT_BOXES[i]
        gtl[i, :n] = GT_LABELS[i]
        gtv[i, :n] = True
        for g, (x1, y1, x2, y2) in enumerate(GT_BOXES[i]):
            cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, \
                (y2 - y1) / 2
            masks[i, g] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
    return dict(gt_bboxes=gtb, gt_labels=gtl, gt_valid=gtv,
                img_shape=IMG_SHAPES, gt_masks=masks)


@pytest.mark.parametrize("name", [HTC, SCNET])
def test_forward_train_matches_jax(name, models):
    """Every loss and num_pos, and the gradients of the losses' sum with
    respect to every RoI head parameter and the FPN maps."""
    _, variables, _ = models[name]
    model, train_cfg, test_cfg = _config(name, covering=True)
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
    args = (variables["params"]["roi_head_m"], jf)
    (_, want), (g_params, g_feats) = jax.jit(jax.value_and_grad(
        losses, argnums=(0, 1), has_aux=True)).lower(*args).compile(
        FAST_COMPILE)(*args)

    head = port.roi_head.train()
    tf = [t.requires_grad_(True) for t in _nchw(feats)]
    got = head.forward_train(
        tf, torch.from_numpy(boxes), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    n_mask = 3 if name == HTC else 1
    assert len([k for k in got if "mask" in k]) == n_mask
    assert "loss_semantic_seg" in got
    assert ("loss_glbctx" in got) == (name == SCNET)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(got["s0_num_pos"]) > 5
    sum(v for k, v in got.items() if k.startswith("loss")).backward()

    want_g = jax_to_state_dict(
        {"roi_head_m": jax.tree_util.tree_map(np.asarray, g_params)})
    own = dict(port.named_parameters())
    assert set(want_g) == {k for k in own if k.startswith("roi_head.")}
    for k, w in want_g.items():
        w = w.numpy()
        scale = max(np.abs(w).max(), 1e-12)
        g = own[k].grad
        g = g.numpy() if g is not None else np.zeros_like(w)
        assert np.abs(g - w).max() / scale < 1e-4, k
    for f, g in zip(tf, g_feats):
        wg = np.asarray(g).transpose(0, 3, 1, 2)
        scale = max(np.abs(wg).max(), 1e-12)
        gg = f.grad.numpy() if f.grad is not None else 0 * wg
        assert np.abs(gg - wg).max() / scale < 1e-4


# levels of a 200x336 input (strides 4..64): to fusion level 1 level 0
# shrinks and 2..4 grow, to level 2 levels 0 and 1 shrink; odd sizes, so
# no factor is a whole one
SEM_SIZES = [(50, 84), (25, 42), (13, 21), (7, 11), (4, 6)]


@pytest.mark.parametrize("fusion_level", [1, 2])
def test_fused_semantic_head_matches_jax(fusion_level):
    jhead = JaxSemanticHead(num_ins=5, fusion_level=fusion_level,
                            num_convs=1, in_channels=16,
                            conv_out_channels=16, num_classes=7)
    rng = np.random.RandomState(fusion_level)
    feats = [rng.randn(2, h, w, 16).astype(np.float32)
             for h, w in SEM_SIZES]
    jf = [jnp.asarray(f) for f in feats]
    init = jax.jit(jhead.init).lower(jax.random.PRNGKey(1), jf).compile(
        FAST_COMPILE)
    variables = init(jax.random.PRNGKey(1), jf)
    fwd = jax.jit(jhead.apply).lower(variables, jf).compile(FAST_COMPILE)
    want_logits, want_embed = fwd(variables, jf)

    head = FusedSemanticHead(num_ins=5, fusion_level=fusion_level,
                             num_convs=1, in_channels=16,
                             conv_out_channels=16, num_classes=7)
    sd = {}
    for name, p in variables["params"].items():
        m = name[len("lateral"):] if name.startswith("lateral") else None
        key = (f"lateral_convs.{m}" if m is not None
               else f"convs.{name[4:]}" if name[4:].isdigit() else name)
        sd[f"{key}.weight"] = torch.from_numpy(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy())
        sd[f"{key}.bias"] = torch.from_numpy(np.array(p["bias"]))
    head.load_state_dict(sd)
    with torch.no_grad():
        logits, embed = head(_nchw(feats))
    for got, want in ((logits, want_logits), (embed, want_embed)):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    # the shrinking levels need the antialias: without it, far off
    with torch.no_grad():
        lat = head.lateral_convs[0](_nchw(feats)[0])
    h, w = SEM_SIZES[fusion_level]
    plain = F.interpolate(lat, size=(h, w), mode="bilinear",
                          align_corners=False)
    aa = F.interpolate(lat, size=(h, w), mode="bilinear",
                       align_corners=False, antialias=True)
    assert float((plain - aa).abs().max()) > 0.1


def test_nearest_exact_samples_jax_nearest_pixels():
    """The pixel each output of torch's "nearest-exact" reads is the one
    `jax.image.resize(..., "nearest")` reads, at whole and odd factors."""
    for (h, w), (oh, ow) in (((800, 1344), (100, 168)),
                             ((64, 96), (8, 12)), ((250, 333), (31, 42)),
                             ((57, 91), (13, 21))):
        idx = np.arange(h * w, dtype=np.float32).reshape(h, w)
        want = np.asarray(jax.image.resize(jnp.asarray(idx), (oh, ow),
                                           method="nearest"))
        got = F.interpolate(torch.from_numpy(idx)[None, None], size=(oh, ow),
                            mode="nearest-exact")[0, 0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["painted", "gt_semantic_seg"])
def test_semantic_loss_matches_jax(kind, models):
    """`_semantic_loss` on the train batch's overlapping ellipses (painted
    by the max of label + 1), or on a given map with a 255 region."""
    jm, variables, port = models[HTC]
    rng = np.random.RandomState(21)
    logits = rng.randn(2, 8, 12, 183).astype(np.float32) * 2
    batch = _train_batch()
    # a fourth gt over the first two: the max of the labels wins
    batch["gt_masks"][0, 3, 4:40, 8:60] = 1
    batch["gt_valid"][0, 3] = True
    batch["gt_labels"][0, 3] = 1
    if kind == "gt_semantic_seg":
        seg = rng.randint(0, 183, (2,) + IMG_HW).astype(np.int32)
        seg[:, 10:40, 20:70] = 255
        batch["gt_semantic_seg"] = seg
    want = jm.apply(variables, jnp.asarray(logits),
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    method=lambda m, *a: m.roi_head_m._semantic_loss(*a))
    got = port.roi_head._semantic_loss(
        torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", [HTC, SCNET])
def test_branch_heads_as_jax_builds_them(name, models):
    """HTC: a mask head a stage, `conv_res` from stage 1 on (the heads
    JAX hands the previous features); SCNet: one mask head, no
    `conv_res`, a context head of the RoI head's classes."""
    _, variables, port = models[name]
    roi = variables["params"]["roi_head_m"]
    heads = sorted(k for k in roi if k.startswith("mask_heads_"))
    assert len(port.roi_head.mask_head) == len(heads)
    for i, head in enumerate(port.roi_head.mask_head):
        assert (head.conv_res is not None) == ("conv_res" in roi[heads[i]])
    if name == SCNET:
        assert heads == ["mask_heads_0"]
        assert port.roi_head.glbctx_head.num_classes == NC
    else:
        assert [("conv_res" in roi[h]) for h in heads] == [False, True, True]

"""P2BNet and SSD-Det in the port against the JAX package, on the same
JAX-initialized weights and the same seeded inputs.

- the bag geometry (`cbp_proposals`, `pbr_proposals`) and `merge_boxes`
  with tied scores, values and the merge's gradient;
- the plain RoIAlign's gradient with respect to the roi coordinates
  against `jax.grad` of JAX's `single_roi_extract` (the XLA RoIAlign the
  P2B head differentiates), on quarter-pixel rois whose samples fall on
  the clamp bounds (jnp.clip's 0.5 there) and rois off the map;
- each head alone on seeded FPN maps with padded gts: every stage's
  outputs, the negatives' logits, the losses, the gradients with respect
  to the head's parameters and the maps, and stage 0's gradient from
  `loss_neg` alone, which reaches it only through the roi coordinates;
- the toy slice (`tests/test_models_p2b.py::_p2b_model`'s sizes, P2BNet
  and SSDDet): one train step's losses and gradients, `refine_test` and
  `run_refine_test` rows against JAX's `run_refine_test`;
- a JAX P2BNet `.ckpt` read by `init_detector`; both configs built with
  every key; the port's `data/noise.py` equal to JAX's; BN in training
  mode (the learnability scenarios' `norm_eval=False`) against flax's, and
  the smoke's learnability start equal to the JAX test's draw.
"""
import copy
import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from pointtinybenchmark_tpu.data import noise as jnoise
from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu.engine.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.models.roi_heads.roi_extractor import \
    single_roi_extract as jax_extract
from pointtinybenchmark_tpu_torch.apis.inference import init_detector
from pointtinybenchmark_tpu_torch.data import noise
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.engine.test import run_refine_test
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.models.backbones.resnet import \
    FlaxBatchNorm2d
from pointtinybenchmark_tpu_torch.models.builder import build_module
from pointtinybenchmark_tpu_torch.models.dense_heads import p2b_head
from pointtinybenchmark_tpu_torch.models.detectors.single_stage import \
    SingleStageDetector
from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import (
    map_roi_levels, single_roi_extract)
from pointtinybenchmark_tpu_torch.ops import roi_align
from pointtinybenchmark_tpu_torch.utils.config import Config
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)

jp2b = importlib.import_module(
    "pointtinybenchmark_tpu.models.dense_heads.p2b_head")
jtest = importlib.import_module("pointtinybenchmark_tpu.engine.test")

STRIDES = (4, 8, 16, 32)
HW = (64, 96)
C, G, FEAT = 3, 6, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_grads_close(got, want, rtol=1e-4):
    """The same names; each gradient within rtol of its own max |grad|,
    except the instance branches' biases: their exact gradient is 0 (the
    bag softmax does not change when a constant is added to a class's
    logits), so both frameworks give them only rounding noise, held under
    1e-6 of the largest gradient of all on both sides."""
    assert set(got) == set(want)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for n, g in got.items():
        w = want[n]
        if n.endswith("ins.bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * largest, n
            continue
        err = float(np.abs(g - w).max())
        assert err <= rtol * np.abs(w).max(), (n, err)


# ------------------------------------------------------- bags and merge
def _tied_scores(rng, shape):
    """Scores on a coarse grid, so that many tie."""
    return (rng.randint(0, 4, shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize("fn", ["cbp", "pbr", "merge"])
def test_bag_geometry_and_merge_match_jax(fn):
    """cbp_proposals / pbr_proposals equal to 1e-6 of the largest
    coordinate; merge_boxes with tied scores: the same top-k choice (lax.top_k's
    order), merged boxes and top scores within 1e-6 relative, and the
    gradient of the merged boxes with respect to scores and boxes within
    1e-6 of its max."""
    rng = np.random.RandomState(0)
    if fn == "cbp":
        pts = rng.uniform(-5, 100, (2, 4, 2)).astype(np.float32)
        want = np.asarray(jp2b.cbp_proposals(jnp.asarray(pts), (8, 16, 32),
                                             (1 / 3, 0.5, 1.0, 2.0)))
        got = p2b_head.cbp_proposals(torch.from_numpy(pts), (8, 16, 32),
                                     (1 / 3, 0.5, 1.0, 2.0)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
        return
    if fn == "pbr":
        xy = rng.uniform(0, 80, (2, 4, 2))
        box = np.concatenate([xy, xy + rng.uniform(2, 40, (2, 4, 2))],
                             -1).astype(np.float32)
        want = np.asarray(jp2b.pbr_proposals(jnp.asarray(box),
                                             (0.8, 1.0, 1.2),
                                             (-0.2, 0.0, 0.2)))
        got = p2b_head.pbr_proposals(torch.from_numpy(box), (0.8, 1.0, 1.2),
                                     (-0.2, 0.0, 0.2)).numpy()
        assert got.shape == want.shape == (2, 4, 27, 4)
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
        return
    boxes = rng.uniform(0, 50, (3, 5, 9, 4)).astype(np.float32)
    scores = _tied_scores(rng, (3, 5, 9))
    scores[0, 0] = 0.0                    # every score tied
    up = rng.randn(3, 5, 4).astype(np.float32)

    def jf(s, b):
        m, top = jp2b.merge_boxes(b, s, 4)
        return (m * up).sum() + top.sum(), (m, top)
    (_, (wm, wt)), (gs, gb) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(scores),
                                           jnp.asarray(boxes))
    s = torch.from_numpy(scores).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    m, top = p2b_head.merge_boxes(b, s, 4)
    ((m * torch.from_numpy(up)).sum() + top.sum()).backward()
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(wm), rtol=1e-6)
    np.testing.assert_array_equal(top.detach().numpy(), np.asarray(wt))
    for a, w in ((s.grad, gs), (b.grad, gb)):
        w = np.asarray(w)
        # the same chosen indices: zero where JAX's gradient is zero
        np.testing.assert_array_equal(a.numpy() == 0, w == 0)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-6 * np.abs(w).max())


# ------------------------------------------- RoIAlign's gradient in rois
def _quarter_rois(rng, r, b, hw):
    """(r, 5) rois on a 1-px grid in image coordinates: at stride 4 their
    sample coordinates are multiples of 1/4 cell at sr = 2, so many fall
    exactly on 0, dim - 1, -1 and dim. The first rows are built to do so,
    one row lies wholly off the map."""
    h, w = hw
    xy = rng.randint(-12, w + 12, (r, 2)).astype(np.float64)
    wh = rng.randint(4, 120, (r, 2))
    rois = np.concatenate([rng.randint(0, b, (r, 1)), xy, xy + wh], 1)
    rois[0] = [0, -3, -3, 25, 25]                  # samples at -1, 0
    rois[1] = [1, w - 19, h - 19, w + 9, h + 9]    # samples at dim - 1, dim
    rois[2] = [0, -200, -200, -100, -150]          # off the map
    return rois.astype(np.float32)


def _bound_ties(rois, feats_t, s, sr, aligned):
    """How many sample coordinates lie exactly on 0 or dim - 1."""
    lv = map_roi_levels(rois, len(STRIDES))
    scale, hf, wf, _, _ = roi_align.level_tables(feats_t, rois, lv, STRIDES)
    off = 0.5 if aligned else 0.0
    n = 0
    for i, dim in ((1, wf), (2, hf)):
        lo = rois[:, i] * scale - off
        size = (rois[:, i + 2] * scale - off) - lo
        if not aligned:
            size = size.clamp(min=1.0)
        k = torch.arange(s * sr, dtype=torch.float32)
        frac = torch.div(k, sr, rounding_mode="floor") + ((k % sr) + 0.5) / sr
        x = lo[:, None] + frac[None] * (size[:, None] / s)
        n += int(((x == 0) | (x == dim[:, None] - 1)).sum())
    return n


@pytest.mark.parametrize("s,sr,aligned", [(7, 2, True), (7, 1, True),
                                          (3, 3, False)])
def test_roi_gradient_matches_jax(s, sr, aligned):
    """The gradient of the port's RoIAlign (plain, on the CPU) with respect
    to the rois equals `jax.grad` of JAX's single_roi_extract within 1e-5
    of each coordinate column's max |gradient| (the batch-index column 0
    in both); `roi_align_rois_backward_plain` gives the same; the roi off
    the map gets exactly 0."""
    rng = np.random.RandomState(s * 10 + sr)
    b, r = 2, 64
    feats = [rng.randn(b, HW[0] // st, HW[1] // st, 8).astype(np.float32)
             for st in STRIDES]
    rois = _quarter_rois(rng, r, b, HW)
    g = rng.randn(r, s, s, 8).astype(np.float32)

    def jf(x):
        out = jax_extract([jnp.asarray(f) for f in feats], x, STRIDES, s, sr,
                          aligned=aligned)
        return (out * g).sum()
    want = np.asarray(jax.grad(jf)(jnp.asarray(rois)))
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    tr = torch.from_numpy(rois).requires_grad_()
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    (single_roi_extract(tf, tr, STRIDES, s, sr, aligned=aligned)
     * gt).sum().backward()
    got = tr.grad.numpy()
    assert _bound_ties(torch.from_numpy(rois), tf, s, sr, aligned) > 0
    assert (want[:, 0] == 0).all() and (got[:, 0] == 0).all()
    assert (got[2] == 0).all() and (want[2] == 0).all()
    for j in range(1, 5):
        np.testing.assert_allclose(got[:, j], want[:, j],
                                   atol=1e-5 * np.abs(want[:, j]).max())
    lv = map_roi_levels(torch.from_numpy(rois), len(STRIDES))
    plain = roi_align.roi_align_rois_backward_plain(
        gt.contiguous(), tf, torch.from_numpy(rois), lv, STRIDES, s, sr,
        aligned)
    np.testing.assert_array_equal(plain.numpy(), got[:, 1:])


# ------------------------------------------------------- the heads alone
def head_cfg(kind):
    cfg = dict(type="P2BNetHead", num_classes=C, in_channels=FEAT,
               fc_channels=32, featmap_strides=list(STRIDES),
               cbp_scales=[8, 16, 32], cbp_ratios=[0.5, 1.0, 2.0],
               merge_topk=3)
    if kind == "ssd_det":
        cfg.update(type="SSDDetHead", box_bag_scale_jitter=[0.7, 1.0, 1.4],
                   box_bag_offset_frac=[-0.3, 0.0, 0.3])
    if kind == "p2b_two_pbr":
        cfg.update(pbr_stages=2)
    return cfg


def _head_inputs(seed=0):
    """FPN maps (2, H_l, W_l, 16) NHWC of a 64x96 image, gts padded to 6
    (4 and 3 valid, the padding's boxes all zero as the collator leaves
    them), point centres and noisy boxes."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, HW[0] // s, HW[1] // s, FEAT).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(0, [HW[1] - 20, HW[0] - 20], (2, G, 2))
    box = np.concatenate([xy, xy + rng.uniform(6, 24, (2, G, 2))], -1)
    valid = np.arange(G)[None] < np.asarray([4, 3])[:, None]
    box = np.where(valid[..., None], box, 0.0).astype(np.float32)
    ctr = (box[..., :2] + box[..., 2:]) / 2
    return feats, dict(gt_bboxes=box, gt_points=ctr[:, :, None, :],
                       gt_labels=rng.randint(0, C, (2, G)).astype(np.int32),
                       gt_valid=valid)


def _port_head(cfg, params):
    head = build_module(dict(cfg))
    sd = {k[len("bbox_head."):]: v for k, v in jax_to_state_dict(
        {"bbox_head_m": params}, roi_feat_size=7).items()}
    head.load_state_dict(sd, strict=True)
    return head


def _spread(params, seed=1, scale=0.5):
    """Each stage's cls and ins kernels redrawn wider, the same numbers for
    both packages, so that the bags' scores differ and the merge moves."""
    p = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(seed)
    for k in sorted(p):
        if k.endswith("_cls") or k.endswith("_ins"):
            p[k]["kernel"] = (rng.randn(*p[k]["kernel"].shape)
                              * scale).astype(np.float32)
    return p


@pytest.fixture(scope="module", params=["p2b", "ssd_det", "p2b_two_pbr"])
def head_case(request):
    cfg = head_cfg(request.param)
    jh = getattr(jp2b, cfg["type"])(**{k: v for k, v in cfg.items()
                                       if k != "type"})
    feats, batch = _head_inputs()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _spread(jax.jit(jh.init)(jax.random.PRNGKey(0),
                                      [jnp.asarray(f) for f in feats],
                                      jb)["params"])
    return cfg, jh, params, _port_head(cfg, params), feats, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_by_name(head, feats_t, gp, gf):
    got = {n: p.grad.numpy() for n, p in head.named_parameters()}
    want = {k[len("bbox_head."):]: v.numpy() for k, v in jax_to_state_dict(
        {"bbox_head_m": jax.tree_util.tree_map(np.asarray, gp)},
        roi_feat_size=7).items()}
    for i, (f, w) in enumerate(zip(feats_t, gf)):
        got[f"feat{i}"] = f.grad.permute(0, 2, 3, 1).numpy()
        want[f"feat{i}"] = np.asarray(w)
    return got, want


def test_head_matches_jax(head_case):
    """Every stage's boxes, cls, ins, sel, merged and score (a third stage's
    within 5e-5), the negatives' boxes and cls logits within 1e-5 of each
    one's max (built on the last stage: 5e-5 after a third); the losses (and
    bag accuracies) within 1e-5 relative; the gradients of their sum with
    respect to every parameter and every FPN map within 1e-4 of each one's
    max (assert_grads_close); and the gradient of loss_neg alone: within
    the same bar, and non-zero on stage 0's first FC in both packages
    (stage 0 reaches the negatives only through the merged boxes, that is
    through RoIAlign's gradient in the roi coordinates)."""
    cfg, jh, params, head, feats, batch = head_case
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jf = [jnp.asarray(f) for f in feats]

    def jloss(p, f):
        out = jh.apply({"params": p}, f, jb)
        losses = jh.loss(out, jb)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        return jnp.stack([total, losses["loss_neg"]]), (losses, out)
    # one compiled function: both rows' gradients, the sum's and loss_neg's
    (gp, gf), (want, wout) = jax.jit(jax.jacrev(
        jloss, argnums=(0, 1), has_aux=True))(params, jf)
    gp_neg = jax.tree_util.tree_map(lambda x: x[1], gp)
    gp, gf = jax.tree_util.tree_map(lambda x: x[0], (gp, gf))

    def run(only_neg):
        head.zero_grad(set_to_none=True)
        ft = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_()
              for f in feats]
        out = head(ft, _tb(batch), mode="train")
        losses = head.loss(out, _tb(batch))
        total = losses["loss_neg"] if only_neg else sum(
            v for k, v in losses.items() if k.startswith("loss"))
        total.backward()
        return out, losses, ft

    out, got, ft = run(False)
    n_stages = 2 + (cfg.get("pbr_stages", 1) - 1)
    assert len(out["stages"]) == len(wout["stages"]) == n_stages
    for si, (st, ws) in enumerate(zip(out["stages"], wout["stages"])):
        # a third stage's rois come out of two merges of float32 selection
        # scores: their last-bit differences reach 1.4e-5 of its logits
        tol = 1e-5 if si < 2 else 5e-5
        for k in ("boxes", "cls", "ins", "sel", "merged", "score"):
            w = np.asarray(ws[k])
            np.testing.assert_allclose(st[k].detach().numpy(), w,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"stage {si} {k}")
    for k in ("neg_boxes", "neg_cls", "pseudo_boxes", "pseudo_scores"):
        w = np.asarray(wout[k])
        np.testing.assert_allclose(out[k].detach().numpy(), w,
                                   atol=tol * np.abs(w).max(), err_msg=k)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_grads_close(*_grads_by_name(head, ft, gp, gf))

    run(True)
    got_neg = {n: p.grad.numpy() for n, p in head.named_parameters()
               if p.grad is not None}
    want_neg = {k[len("bbox_head."):]: v.numpy() for k, v in
                jax_to_state_dict({"bbox_head_m": jax.tree_util.tree_map(
                    np.asarray, gp_neg)}, roi_feat_size=7).items()}
    key = "stages.0.shared_fcs.0.weight"
    assert np.abs(want_neg[key]).max() > 0
    assert np.abs(got_neg[key]).max() > 0
    assert_grads_close(got_neg, want_neg)


def test_refine_mode_skips_the_negatives(head_case):
    """Outside training the head gives the stages and pseudo boxes of the
    train-mode pass and no negatives (JAX computes them and never reads
    them at refinement)."""
    _, _, _, head, feats, batch = head_case
    ft = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        ref = head(ft, _tb(batch), mode="refine")
        train = head(ft, _tb(batch), mode="train")
    assert "neg_cls" not in ref and "neg_cls" in train
    assert torch.equal(ref["pseudo_boxes"], train["pseudo_boxes"])
    assert torch.equal(ref["pseudo_scores"], train["pseudo_scores"])


# -------------------------------------------------------- the toy slice
def slice_model(kind):
    """tests/test_models_p2b.py::_p2b_model's sizes."""
    head = dict(type="P2BNetHead", num_classes=3, in_channels=16,
                fc_channels=64, featmap_strides=[4, 8, 16, 32],
                cbp_scales=[8, 16, 32], cbp_ratios=[0.5, 1.0, 2.0])
    if kind == "SSDDet":
        head.update(type="SSDDetHead", box_bag_scale_jitter=[0.8, 1.0, 1.25],
                    box_bag_offset_frac=[-0.25, 0.0, 0.25])
    return dict(type=kind,
                backbone=dict(type="ResNet", depth=18, base_channels=8),
                neck=dict(type="FPN", in_channels=[8, 16, 32, 64],
                          out_channels=16, start_level=0, num_outs=4),
                bbox_head=head)


def _samples(rng):
    """Three images of different sizes with 3-5 gts (16x16 point boxes
    for P2BNet: the model reads their centres), anns ids, scale 0.5."""
    out = []
    for i, hw in enumerate([(60, 76), (64, 80), (50, 64)]):
        n = 3 + i
        xy = rng.uniform(2, [hw[1] - 22, hw[0] - 22], (n, 2))
        box = np.concatenate([xy, xy + rng.uniform(8, 20, (n, 2))], 1)
        out.append(dict(
            img=rng.randn(*hw, 3).astype(np.float32),
            gt_bboxes=box.astype(np.float32),
            gt_labels=rng.randint(0, 3, n),
            gt_anns_id=np.arange(n) + 100 * i,
            img_metas=dict(scale_factor=np.asarray([0.5, 0.5, 0.5, 0.5],
                                                   np.float32))))
    return out


@pytest.fixture(scope="module")
def slice_init():
    """The samples, their first batch, and JAX P2BNet variables of the
    slice: SSDDet's tree is the same (its bags have P2BNet's P = 9)."""
    samples = _samples(np.random.RandomState(3))
    batch = DetCollator(pad_shape=(64, 80), max_gt=6)(samples[:2])
    jm = jax_build(slice_model("P2BNet"))
    jb = {k: jnp.asarray(batch[k]) for k in ("gt_bboxes", "gt_labels",
                                             "gt_valid", "img_shape")}
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda r, x, b: jm.init(r, x, b, train=False, mode="train"))(
        jax.random.PRNGKey(0), jnp.asarray(batch["img"]), jb))
    return samples, batch, variables


@pytest.fixture(scope="module", params=["P2BNet", "SSDDet"])
def slice_pair(request, slice_init):
    cfg = slice_model(request.param)
    jm = jax_build(copy.deepcopy(cfg))
    samples, batch, variables = slice_init
    variables = copy.deepcopy(variables)
    # classifiers drawn wide enough that the merge moves, and narrow
    # enough that no negative's class probability rounds to 1 - 1e-7: there
    # log(1 - p + 1e-6) of the focal term turns last-bit differences of p
    # into 6e-4 of loss_neg in either framework
    variables["params"]["bbox_head_m"] = _spread(
        variables["params"]["bbox_head_m"], seed=2, scale=0.05)
    model = build_detector(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return request.param, cfg, jm, variables, model, samples, batch


def test_slice_train_step_matches_jax(slice_pair):
    """forward_train of the whole model: losses within 1e-5 relative,
    every parameter's gradient within 1e-4 of its max (assert_grads_close),
    stage 0's first FC included."""
    _, _, jm, variables, model, _, batch = slice_pair
    keys = ("gt_bboxes", "gt_labels", "gt_valid", "img_shape")

    def jloss(params):
        out = jm.apply({"params": params,
                        "batch_stats": variables["batch_stats"]},
                       jnp.asarray(batch["img"]),
                       {k: jnp.asarray(batch[k]) for k in keys},
                       method=jm.forward_train)
        return sum(v for k, v in out.items() if k.startswith("loss")), out
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.train()
    model.zero_grad(set_to_none=True)
    got = model.forward_train(torch.from_numpy(batch["img"]),
                              {k: torch.from_numpy(batch[k]) for k in keys},
                              None)
    sum(v for k, v in got.items() if k.startswith("loss")).backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    jg = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                           basic_blocks=True)
    assert_grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                       {n: v.numpy() for n, v in jg.items()})


def test_slice_refine_and_run_refine_test_match_jax(slice_pair):
    """refine_test on the collated batch (centres, scores, boxes within
    1e-5 of the largest, not_refine equal), then run_refine_test of both
    packages, each with its own DetCollator (pad 64x80, max_gt 6, batches
    of 2): the same rows, labels and anns_id equal, boxes and points
    (rescaled by the 0.5 scale factor) within 1e-5 of the largest
    coordinate, scores within 1e-5."""
    _, _, jm, variables, model, samples, batch = slice_pair
    keys = ("gt_bboxes", "gt_labels", "gt_valid", "img_shape")
    want = jax.jit(lambda v, x, b: jm.apply(v, x, b, (16, 16),
                                            method=jm.refine_test))(
        variables, jnp.asarray(batch["img"]),
        {k: jnp.asarray(batch[k]) for k in keys})
    model.eval()
    with torch.no_grad():
        got = model.refine_test(torch.from_numpy(batch["img"]),
                                {k: torch.from_numpy(batch[k]) for k in keys})
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, w in zip(got[:3], want[:3]):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5 * np.abs(w).max())
    want_rows = jtest.run_refine_test(jm, variables, samples,
                                      JaxCollator(pad_shape=(64, 80),
                                                  max_gt=6), 2)
    got_rows = run_refine_test(model, samples,
                               DetCollator(pad_shape=(64, 80), max_gt=6), 2)
    assert len(got_rows) == len(want_rows) == 3
    for g, w in zip(got_rows, want_rows):
        assert set(g) == set(w) == {"bboxes", "labels", "points", "anns_id"}
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["anns_id"], w["anns_id"])
        for k in ("bboxes", "points"):
            np.testing.assert_allclose(g[k], w[k],
                                       atol=1e-5 * np.abs(w[k]).max())


def test_init_detector_reads_a_jax_p2bnet_checkpoint(slice_pair, tmp_path):
    """A JAX `.ckpt` of the slice (JAX's save_checkpoint) read by the
    port's init_detector: every tensor equal to the weights
    load_jax_variables gave the model the tests above hold to JAX (each
    stage's first FC with its rows permuted to (c, h, w))."""
    kind, cfg, _, variables, model, _, _ = slice_pair
    cfg_path = tmp_path / "p2b.py"
    cfg_path.write_text(f"model = {cfg!r}\n")
    ckpt = tmp_path / "epoch_1.ckpt"
    jax_save_checkpoint(str(ckpt), dict(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        step=jnp.int32(1)), dict(epoch=1))
    handle = init_detector(str(cfg_path), checkpoint=str(ckpt), device="cpu")
    got = handle.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert type(handle.model).__name__ == kind


# ------------------------------------------------- configs, noise, keys
@pytest.mark.parametrize("name", ["p2b/p2bnet_r50_fpn_1x_coco.py",
                                  "ssd_det/ssd_det_r50_fpn_1x_coco.py"])
def test_configs_build_with_every_key(name, monkeypatch):
    """Both configs build at full width with every key of their head taken
    (two stages of 2 FCs of 1,024 on 7x7x256, 81-way cls, 80-way ins);
    SSD-Det's dataset keeps P2BNet's pseudo_wh beside its noise_rg (the
    config merge, as the JAX Config gives it); an unknown head key
    raises. The seeded initialisation, which the shapes do not need, is
    skipped."""
    cfg = Config.fromfile(f"configs/{name}")
    monkeypatch.setattr(SingleStageDetector, "init_weights",
                        lambda self, generator: None)
    model = build_detector(dict(cfg.model), cfg.get("train_cfg"),
                           cfg.get("test_cfg"), device="cpu")
    head = model.bbox_head
    assert len(head.stages) == 2
    assert tuple(head.stages[0].shared_fcs[0].weight.shape) == (1024, 12544)
    assert head.stages[1].cls.out_features == 81
    assert head.stages[1].ins.out_features == 80
    ssd = name.startswith("ssd_det")
    assert head.bag_source == ("box" if ssd else "point")
    assert cfg.data["train"]["noise_kwargs"] == (
        {"pseudo_wh": (16, 16), "noise_rg": 0.4} if ssd
        else {"pseudo_wh": (16, 16), "noise_rg": 0.25})
    with pytest.raises(NotImplementedError, match="dtype"):
        build_module(dict(cfg.model["bbox_head"], dtype="float32"))


@pytest.mark.parametrize("case", ["rg", "no_rg", "points"])
def test_noise_matches_jax(case, tmp_path):
    """generate_pseudo_bbox_for_point and, through a json file,
    generate_pseudo_bbox_for_noise_data give JAX's annotations exactly."""
    rng = np.random.RandomState(4)
    anns = []
    for i in range(12):
        x, y = rng.uniform(0, 300, 2)
        w, h = rng.uniform(4, 80, 2)
        a = dict(id=i, image_id=i // 4, category_id=1,
                 bbox=[float(x), float(y), float(w), float(h)])
        if case == "points":
            a["point"] = [float(x + w / 3), float(y + h / 3)]
        anns.append(a)
    ds = dict(images=[dict(id=k) for k in range(3)], annotations=anns)
    kw = dict(pseudo_wh=(16, 16), noise_rg=None if case == "no_rg" else 0.25,
              seed=7)
    assert noise.generate_pseudo_bbox_for_point(
        ds, kw["pseudo_wh"], kw["noise_rg"], 7) == \
        jnoise.generate_pseudo_bbox_for_point(ds, kw["pseudo_wh"],
                                              kw["noise_rg"], 7)
    files = []
    for sub, mod in (("port", noise), ("jax", jnoise)):
        (tmp_path / sub).mkdir()
        ann = tmp_path / sub / "ann.json"
        ann.write_text(json.dumps(ds))
        files.append(mod.generate_pseudo_bbox_for_noise_data(str(ann), None,
                                                              kw))
    assert files[0].endswith(files[1][len(str(tmp_path / "jax")):])
    assert json.loads(open(files[0]).read()) == \
        json.loads(open(files[1]).read())


def test_batchnorm_training_mode_matches_flax():
    """FlaxBatchNorm2d in training mode against flax's BatchNorm (momentum
    0.99, eps 1e-5) on a seeded (8, 6, 6, 16) batch, three updates from
    non-trivial running statistics: outputs and the gradients with
    respect to the input, scale and bias within 1e-5 of their max, the
    running mean and (biased) variance within 1e-6 relative; in eval mode
    both use the running statistics."""
    rng = np.random.RandomState(5)
    xs = [(rng.randn(8, 6, 6, 16) * 2 + 1).astype(np.float32)
          for _ in range(3)]
    up = rng.randn(8, 6, 6, 16).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    stats = dict(mean=rng.randn(16).astype(np.float32),
                 var=rng.uniform(0.5, 2, 16).astype(np.float32))
    bn = nn.BatchNorm(use_running_average=False)
    variables = {"params": dict(scale=scale, bias=bias),
                 "batch_stats": dict(stats)}
    port = FlaxBatchNorm2d(16)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port.running_var.copy_(torch.from_numpy(stats["var"]))
    port.train()
    for x in xs:
        def f(params, x):
            y, new = bn.apply(dict(variables, params=params), x,
                              mutable=["batch_stats"])
            return (y * up).sum(), (y, new["batch_stats"])
        (_, (want, new)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
        variables["batch_stats"] = new
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        port.zero_grad()
        got = port(tx)
        (got * torch.from_numpy(up).permute(0, 3, 1, 2)).sum().backward()
        for a, w in ((got.detach().permute(0, 2, 3, 1), want),
                     (tx.grad.permute(0, 2, 3, 1), gx),
                     (port.weight.grad, gp["scale"]),
                     (port.bias.grad, gp["bias"])):
            w = np.asarray(w)
            np.testing.assert_allclose(a.numpy(), w,
                                       atol=1e-5 * np.abs(w).max())
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(new["mean"]), rtol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(new["var"]), rtol=1e-6)
    port.eval()
    x = jnp.asarray(xs[0])
    want = nn.BatchNorm(use_running_average=True).apply(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)


def test_learnability_start_is_the_jax_tests_draw():
    """learnability_p2b.LEARN_INIT, where the smoke's learnability runs
    start, is tests/test_models_p2b.py's model.init at PRNGKey(0) (its
    SSD-Det model has the same tree, and so the same draw) carried into
    the port's state_dict by utils/jax_weights.py: every tensor equal."""
    import learnability_p2b as lp
    from pointtinybenchmark_tpu.engine.train import init_model

    cfg = lp.learn_model("P2BNet")
    imgs = lp.learn_scene("P2BNet")[0]
    jm = jax_build(copy.deepcopy(cfg))
    params, stats = jax.jit(lambda x: init_model(jm, dict(img=x)))(
        jnp.asarray(imgs[:lp.LEARN_BATCH]))
    model = build_detector(copy.deepcopy(cfg), device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    with np.load(lp.LEARN_INIT) as init:
        assert set(init.files) == set(model.state_dict())
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(init[k], v.numpy(), err_msg=k)
    ssd = jax_build(copy.deepcopy(lp.learn_model("SSDDet")))
    assert jax.tree_util.tree_map(np.shape, jax.eval_shape(
        lambda x: ssd.init(jax.random.PRNGKey(0), x, train=False),
        jnp.asarray(imgs[:8]))["params"]) == jax.tree_util.tree_map(
        np.shape, params)

"""P2P in the port against the JAX package, on the same JAX-initialized
weights and the same seeded inputs.

The model is tests/train_parity_lib.py::make_jax_p2p (ResNet-18 of base 8,
FPN 16 with only the stride-4 output, P2PHead with 2 GN(4) convs a branch,
1 class, the P2P assigner at topk_k 1), its JAX init loaded into the port's
model by utils/jax_weights.py::load_jax_variables. The head's outputs,
its loss and gradients (at topk_k 5 too), `get_bboxes` and the tiled
protocol on a small frame are compared; then 40 steps through
train_parity_lib's `train_jax` (the JAX package's build_optimizer and
make_train_step) against the port's `train_detector` on the same batches,
and the point AP of both trained models on held-out scenes, each scored by
its own package's LocationEvaluator. The weights round trip through
tools/model_converters/torch2jax.py, and the port's `init_detector` reads
a JAX `.ckpt`. Torch runs on one thread here.
"""
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import train_parity_lib as tp
from pointtinybenchmark_tpu.apis.inference import DetectorHandle
from pointtinybenchmark_tpu.apis.inference import \
    inference_detector_tiled as jax_tiled
from pointtinybenchmark_tpu.data.coco import COCO
from pointtinybenchmark_tpu.engine.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu_torch.apis.inference import (
    inference_detector_tiled, init_detector)
from pointtinybenchmark_tpu_torch.core import assigners
from pointtinybenchmark_tpu_torch.engine.train import train_detector
from pointtinybenchmark_tpu_torch.evaluation.location_eval import \
    LocationEvaluator
from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.jax_weights import (
    jax_to_state_dict, load_jax_variables)
from test_torch_slice import _assert_dets_match, _dets

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", "tools",
                            "model_converters"))
from torch2jax import convert_detector_state_dict  # noqa: E402


STEPS, N_TRAIN, N_VAL, BATCH, HW = 40, 16, 4, 2, (128, 160)
GMAX = 16                       # train_jax's gt padding
# nms_pre covers the whole level (32 x 40 cells), so that no near-tie at a
# top-k boundary picks different candidates
TEST_CFG = dict(nms_pre=2000, score_thr=0.05, pseudo_wh=(16, 16),
                nms=dict(type="nms", iou_threshold=0.01), max_per_img=1000)


# train_parity_lib.make_jax_p2p's model
MODEL = dict(
    type="BasicLocator",
    backbone=dict(type="ResNet", depth=18, base_channels=8, norm_eval=True,
                  frozen_stages=-1),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16,
              num_outs=1, start_level=0, add_extra_convs="on_input"),
    bbox_head=dict(type="P2PHead", num_classes=1, in_channels=16,
                   feat_channels=16, stacked_convs=2, strides=[4],
                   point_anchor=[(0.0, 0.0)], pts_gamma=1.0, reg_norm=1.0,
                   norm_cfg=dict(tp.P2P_NORM), loss_cls=dict(tp.LOSS_CLS),
                   loss_reg=dict(tp.P2P_LOSS_REG)))


def _train_cfg(topk_k=1):
    cfg = dict(tp.P2P_TRAIN)
    cfg["assigner"] = dict(cfg["assigner"], topk_k=topk_k)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its init as numpy, the port's model with it loaded, the
    model config), test_cfg TEST_CFG."""
    jm = tp.make_jax_p2p()
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda r, x: jm.init(r, x))(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3), jnp.float32)))
    cfg = MODEL
    model = build_detector(dict(cfg), _train_cfg(), dict(TEST_CFG),
                           device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return jm, variables, model, cfg


def _spread(variables, seed=0, scale=0.05):
    """cls_out redrawn (the same numbers on both sides) so that scores
    spread above score_thr, as tests/test_torch_slice.py does."""
    v = jax.tree_util.tree_map(np.array, variables)
    head = v["params"]["bbox_head_m"]["cls_out"]
    head["kernel"] = (np.random.RandomState(seed).randn(*head["kernel"].shape)
                      * scale).astype(np.float32)
    head["bias"] = np.zeros_like(head["bias"])
    return v


def _batch(n=2, seed=0):
    data = tp.make_tiny_dataset(n, hw=HW, seed=seed)
    gt_b, gt_l, gt_v = tp.pad_gts(data["gts"], data["labels"], GMAX)
    return data["images"], dict(
        gt_bboxes=gt_b, gt_labels=gt_l, gt_valid=gt_v,
        img_shape=np.asarray([HW] * n, np.int32))


def test_head_outputs_match_jax(pair):
    """cls_out and reg_out of the whole network: 1e-5 of each output's
    largest value."""
    jm, variables, model, _ = pair
    img, _ = _batch()
    cls_j, pts_j = jax.jit(lambda x: jm.apply(variables, x))(jnp.asarray(img))
    with torch.no_grad():
        cls_t, pts_t = model(torch.from_numpy(img))
    for a, b in ((cls_t, cls_j), (pts_t, pts_j)):
        assert len(a) == len(b) == 1
        w = np.asarray(b[0])
        np.testing.assert_allclose(a[0].permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("topk_k", [1, 5])
def test_loss_and_grads_match_jax(pair, topk_k):
    """forward_train on two scenes with 4-12 gts, padded to 16: losses
    within 1e-5 relative, num_pos equal (topk_k x valid gts), every
    parameter's gradient within 1e-4 of its max |grad|."""
    jm, variables, _, cfg = pair
    jm = jax_build(dict(cfg), _train_cfg(topk_k), dict(TEST_CFG))
    model = build_detector(dict(cfg), _train_cfg(topk_k), dict(TEST_CFG),
                           device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    img, batch = _batch()

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(img),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          method=jm.forward_train, mutable=["batch_stats"])
        return sum(v for k, v in out.items() if k.startswith("loss")), out
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.train()
    got = model.forward_train(torch.from_numpy(img),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              torch.Generator())
    sum(v for k, v in got.items() if k.startswith("loss")).backward()
    assert float(got["num_pos"]) == topk_k * batch["gt_valid"].sum()
    for k in ("loss_cls", "loss_pts", "num_pos"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    jg = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                           basic_blocks=True)
    for name, p in model.named_parameters():
        w = jg[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)


def test_get_bboxes_matches_jax(pair):
    """simple_test on two scenes: the pseudo-box detections at the golden
    tolerances of tests/test_detector_golden.py:88, the points equal to
    the boxes' centres with the boxes' scores on both sides."""
    _, variables, model, cfg = pair
    jm = jax_build(dict(cfg), None, dict(TEST_CFG))
    v = _spread(variables)
    load_jax_variables(model, v["params"], v["batch_stats"])
    img, batch = _batch(seed=3)
    shapes = batch["img_shape"]
    dets_j, pts_j = jax.jit(lambda x, s: jm.apply(
        v, x, s, method=jm.simple_test))(jnp.asarray(img), jnp.asarray(shapes))
    with torch.no_grad():
        dets_t, pts_t = model.simple_test(torch.from_numpy(img),
                                          torch.from_numpy(shapes))
    for i in range(2):
        ok_j, ok_t = np.asarray(dets_j.valid[i]), dets_t.valid[i].numpy()
        ref = (np.asarray(dets_j.bboxes[i])[ok_j],
               np.asarray(dets_j.labels[i])[ok_j])
        got = (dets_t.bboxes[i].numpy()[ok_t], dets_t.labels[i].numpy()[ok_t])
        assert 5 < ref[0].shape[0] < 1000
        _assert_dets_match(_dets(dict(bboxes=ref[0], labels=ref[1])),
                           _dets(dict(bboxes=got[0], labels=got[1])))
        for pts, dets, ok in ((pts_t[i].numpy(), got[0], ok_t),
                              (np.asarray(pts_j[i]), ref[0], ok_j)):
            np.testing.assert_allclose(pts[ok][:, :2], (dets[:, :2]
                                                        + dets[:, 2:4]) / 2,
                                       rtol=1e-6)
            np.testing.assert_array_equal(pts[ok][:, 2], dets[:, 4])


TILED_CFG = """
img_norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
test_pipeline = [
    dict(type="LoadImageFromFile"),
    dict(type="CroppedTilesFlipAug", tile_shape=(96, 64), tile_overlap=(16, 16),
         scale_factor=[1.0], flip=False,
         transforms=[dict(type="Resize", keep_ratio=True),
                     dict(type="RandomFlip"),
                     dict(type="Normalize", **img_norm),
                     dict(type="Pad", size=(64, 96)),
                     dict(type="Collect", keys=["img"])]),
]
data = dict(test=dict(type="CocoFmtDataset", ann_file="", img_prefix="",
                      pipeline=test_pipeline))
"""


def test_tiled_protocol_matches_jax(pair, tmp_path):
    """inference_detector_tiled of both packages on a 128x192 frame cut
    into 64x96 tiles: per-tile pseudo-box NMS at IoU 0.01, the shift and
    the global merge; merged detections at the golden tolerances."""
    jm, variables, _, cfg = pair
    path = tmp_path / "p2p.py"
    path.write_text(TILED_CFG + f"model = {cfg!r}\ntest_cfg = {TEST_CFG!r}\n")
    v = _spread(variables, seed=1)
    jcfg = JaxConfig.fromfile(str(path))
    jh = DetectorHandle(jax_build(dict(jcfg.model), None, jcfg.test_cfg),
                        jax.tree_util.tree_map(jnp.asarray, v), None, jcfg,
                        None)
    th = init_detector(str(path), device="cpu")
    load_jax_variables(th.model, v["params"], v["batch_stats"])
    frame = np.random.RandomState(6).randint(0, 256, (128, 192, 3), np.uint8)
    ref = _dets(jax_tiled(jh, frame))
    assert ref[0].shape[0] > 5
    _assert_dets_match(ref, _dets(inference_detector_tiled(th, frame)))


# ---------------------------------------------------------- 40 steps
class _Batches:
    """The samples of train_parity_lib's batch order, in that order, for
    a loader that does not shuffle."""

    def __init__(self, data, order):
        self.data, self.flat = data, [i for b in order for i in b]

    def __len__(self):
        return len(self.flat)

    def __getitem__(self, k):
        i = self.flat[k]
        return dict(img=self.data["images"][i],
                    gt_bboxes=self.data["gts"][i],
                    gt_labels=self.data["labels"][i])


def _point_rows(dets, pts, image_id):
    rows = []
    ok = np.asarray(dets.valid[0])
    for p, lab in zip(np.asarray(pts[0])[ok], np.asarray(dets.labels[0])[ok]):
        rows.append(dict(image_id=image_id, category_id=int(lab) + 1,
                         point=[float(p[0]), float(p[1])], score=float(p[2])))
    return rows


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """train_jax's 40 steps and the port's train_detector on the same
    batches from the same init, and each one's point AP on held-out
    scenes."""
    jm, variables, _, cfg = pair
    data = tp.make_tiny_dataset(N_TRAIN, hw=HW, seed=0)
    val = tp.make_tiny_dataset(N_VAL, hw=HW, seed=1000)
    order = tp.batch_order(N_TRAIN, BATCH, STEPS)
    step_iters = [int(STEPS * 2 / 3), int(STEPS * 5 / 6)]
    j_losses, state = tp.train_jax(jm, variables["params"],
                                   variables["batch_stats"], data, order,
                                   step_iters, gmax=GMAX)
    ap_j = tp.eval_jax_point_ap(jm, state, val)

    model = build_detector(dict(cfg), _train_cfg(), dict(tp.P2P_TEST),
                           device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    train_cfg = dict(
        data=dict(samples_per_gpu=BATCH, shuffle=False),
        loader=dict(pad_shape=HW, max_gt=GMAX),
        runner=dict(type="IterBasedRunner", max_iters=STEPS),
        optimizer=dict(type="SGD", lr=tp.OPT["lr"],
                       momentum=tp.OPT["momentum"],
                       weight_decay=tp.OPT["weight_decay"]),
        optimizer_config=dict(grad_clip=dict(max_norm=tp.OPT["grad_clip"],
                                             norm_type=2)),
        lr_config=dict(policy="step", warmup="linear",
                       warmup_iters=tp.LR_CFG["warmup_iters"],
                       warmup_ratio=tp.LR_CFG["warmup_ratio"],
                       gamma=tp.LR_CFG["gamma"], step=step_iters),
        log_config=dict(interval=1), checkpoint_config=dict(interval=STEPS))
    for k in assigners.auction_stats:
        assigners.auction_stats[k] = 0
    out = train_detector(model, _Batches(data, order), train_cfg,
                         str(tmp_path_factory.mktemp("p2p_train")),
                         device="cpu")
    t_losses = np.asarray([h["loss"] for h in out["history"]])
    model.eval()
    rows = []
    with torch.no_grad():
        for i in range(N_VAL):
            dets, pts = model.simple_test(
                torch.from_numpy(val["images"][i:i + 1]),
                torch.tensor([HW], dtype=torch.int32))
            rows += _point_rows(dets, pts, i)
    ap_t = LocationEvaluator()(rows, COCO(tp._coco_gt(val)))
    return dict(j_losses=j_losses, t_losses=t_losses, ap_j=ap_j, ap_t=ap_t,
                stats=dict(assigners.auction_stats))


def test_trajectory_and_point_ap_match_jax(runs):
    """40 steps: tests/test_train_parity.py:61-65's bars (first step 1e-4,
    mean of 10-step moving means 0.01) and point AP within 0.02; the
    auction ran one round a step and read convergence back at least once a
    round."""
    assert len(runs["t_losses"]) == STEPS
    assert np.isfinite(runs["t_losses"]).all()
    st = tp.trajectory_stats(runs["t_losses"], runs["j_losses"])
    assert st["first_step_rel"] < 1e-4, st
    assert st["mean_rel"] < 0.01, st
    ap_t, ap_j = runs["ap_t"]["AP"], runs["ap_j"]["AP"]
    assert ap_j > 0.1, ap_j
    assert abs(ap_t - ap_j) < 0.02, (ap_t, ap_j)
    assert runs["stats"]["rounds"] == STEPS
    assert runs["stats"]["syncs"] >= 2 * STEPS


# ------------------------------------------------------------ weights
def test_state_dict_round_trip_through_torch2jax(pair):
    """The port's P2P state dict -> torch2jax -> load_jax_variables gives
    it back unchanged, every JAX leaf consumed, the GN scales and the
    cls_out / reg_out convolutions included; the tree is the JAX model's."""
    jm, variables, _, cfg = pair
    src = build_detector(dict(cfg), _train_cfg(), dict(TEST_CFG),
                         device="cpu", seed=4)
    with torch.no_grad():
        for n, p in src.named_parameters():
            if ".gn." in n:
                p.add_(torch.rand(p.shape, generator=torch.Generator()
                                  .manual_seed(len(n))))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    params, stats, unmapped = convert_detector_state_dict(sd, depth=18)
    assert not unmapped, unmapped
    shapes = jax.tree_util.tree_map(np.shape, variables["params"])
    assert jax.tree_util.tree_map(np.shape, params) == shapes
    dst = build_detector(dict(cfg), _train_cfg(), dict(TEST_CFG),
                         device="cpu", seed=5)
    load_jax_variables(dst, params, stats)
    assert "bbox_head.cls_convs.1.gn.weight" in sd
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k


def test_init_detector_reads_a_jax_p2p_checkpoint(pair, tmp_path):
    """A JAX save_checkpoint of the P2P params and batch stats read by the
    port's init_detector: every weight equal to load_jax_variables'."""
    jm, variables, model, cfg = pair
    path = tmp_path / "p2p.py"
    path.write_text(f"model = {cfg!r}\ntest_cfg = {TEST_CFG!r}\n")
    ckpt = str(tmp_path / "p2p.ckpt")
    jax_save_checkpoint(ckpt, dict(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        step=jnp.int32(3)), dict(epoch=1))
    got = init_detector(str(path), checkpoint=ckpt, device="cpu").model
    want = build_detector(dict(cfg), None, dict(TEST_CFG), device="cpu")
    load_jax_variables(want, variables["params"], variables["batch_stats"])
    for k, v in want.state_dict().items():
        assert torch.equal(v, got.state_dict()[k]), k

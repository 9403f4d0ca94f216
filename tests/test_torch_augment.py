"""Albu and InstaBoost: the port's transforms against the JAX package's on
the same sample and the same numpy RandomState seed.

Both packages run the same numpy and PIL code in the same draw order, so
the outputs (image, boxes, labels, masks) are equal, not close:
- `Albu` with the albu_example config's transform list, over 24 seeds,
  and with each transform type alone at p=1 (ShiftScaleRotate with a
  rotation, so boxes and masks move; RandomBrightnessContrast, RGBShift,
  HueSaturationValue, JpegCompression, ChannelShuffle, Blur, MedianBlur,
  both flips, OneOf), `filter_lost_elements` dropping boxes pushed out,
  on a float32 image (the dataset path's) and on a uint8 one; an
  unsupported type raises JAX's ValueError when the transform is built;
- `InstaBoost` with the instaboost configs' arguments over 24 seeds (about
  half augmented, as aug_ratio 0.5), and with aug_ratio 1 for the
  "normal", "horizontal" and "skip" actions, with wide shifts and
  rotations.
"""
import copy

import numpy as np
import pytest

from pointtinybenchmark_tpu.data import transforms as jax_transforms
from pointtinybenchmark_tpu_torch.data import transforms
from pointtinybenchmark_tpu_torch.utils.config import Config

H, W = 96, 128
ALBU_CONFIG = "configs/albu_example/mask_rcnn_r50_fpn_albu_1x_coco.py"
INSTABOOST_CONFIG = "configs/instaboost/mask_rcnn_r50_fpn_instaboost_4x_coco.py"
ONE_EACH = [
    dict(type="ShiftScaleRotate", shift_limit=0.1, scale_limit=0.2,
         rotate_limit=30, interpolation=1, p=1.0),
    dict(type="RandomBrightnessContrast", brightness_limit=[0.1, 0.3],
         contrast_limit=[0.1, 0.3], p=1.0),
    dict(type="RGBShift", r_shift_limit=10, g_shift_limit=10,
         b_shift_limit=10, p=1.0),
    dict(type="HueSaturationValue", hue_shift_limit=20, sat_shift_limit=30,
         val_shift_limit=20, p=1.0),
    dict(type="JpegCompression", quality_lower=85, quality_upper=95, p=1.0),
    dict(type="ChannelShuffle", p=1.0),
    dict(type="Blur", blur_limit=3, p=1.0),
    dict(type="MedianBlur", blur_limit=3, p=1.0),
    dict(type="HorizontalFlip", p=1.0),
    dict(type="VerticalFlip", p=1.0),
    dict(type="OneOf", p=1.0, transforms=[
        dict(type="RGBShift", p=1.0), dict(type="Blur", p=2.0)]),
    dict(type="ShiftScaleRotate", shift_limit=(0.4, 0.45), scale_limit=0.0,
         rotate_limit=0, p=1.0),
]


def sample(seed, dtype=np.float32):
    """A textured image with 6 instances (elliptical masks, some at the
    border), their boxes and labels, and the sample's RandomState."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (H, W, 3)).astype(dtype)
    yy, xx = np.mgrid[:H, :W]
    boxes, masks = [], []
    for _ in range(6):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        rx, ry = rng.uniform(5, 25, 2)
        m = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1)
        if not m.any():
            m[int(cy) % H, int(cx) % W] = True
        ys, xs = np.nonzero(m)
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        masks.append(m.astype(np.uint8))
        img[m] = rng.randint(0, 256, 3)
    return dict(img=img, gt_bboxes=np.asarray(boxes, np.float32),
                gt_labels=np.arange(6, dtype=np.int64),
                gt_masks=np.stack(masks), img_shape=img.shape,
                _rng=np.random.RandomState(seed + 1000))


def assert_same(got, want):
    for k in ("img", "gt_bboxes", "gt_labels", "gt_masks"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["_rng"].randint(1 << 30) == want["_rng"].randint(1 << 30)


def _run(port_t, jax_t, s):
    return port_t(copy.deepcopy(s)), jax_t(copy.deepcopy(s))


def _albu_kwargs():
    cfg = Config.fromfile(ALBU_CONFIG).to_dict()
    kw = dict(next(t for t in cfg["train_pipeline"] if t["type"] == "Albu"))
    kw.pop("type")
    return kw


def test_albu_config_matches_jax():
    kw = _albu_kwargs()
    port_t, jax_t = transforms.Albu(**kw), jax_transforms.Albu(**kw)
    changed = 0
    for seed in range(24):
        s = sample(seed)
        got, want = _run(port_t, jax_t, s)
        assert_same(got, want)
        changed += not np.array_equal(got["img"], s["img"])
    assert changed >= 12


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("i", range(len(ONE_EACH)))
def test_albu_each_transform_matches_jax(i, dtype):
    kw = dict(_albu_kwargs(), transforms=[ONE_EACH[i]])
    port_t, jax_t = transforms.Albu(**kw), jax_transforms.Albu(**kw)
    s = sample(50 + i, dtype)
    got, want = _run(port_t, jax_t, s)
    assert_same(got, want)
    assert not np.array_equal(got["img"], s["img"])
    if i == len(ONE_EACH) - 1:                 # shifted far: boxes lost
        assert 0 < len(got["gt_bboxes"]) < 6


def test_albu_refuses_as_jax():
    kw = dict(_albu_kwargs(), transforms=[dict(type="CLAHE", p=1.0)])
    with pytest.raises(ValueError) as err:
        transforms.Albu(**kw)
    with pytest.raises(ValueError) as jerr:
        jax_transforms.Albu(**kw)
    assert str(err.value) == str(jerr.value)


def _instaboost_kwargs(**over):
    cfg = Config.fromfile(INSTABOOST_CONFIG).to_dict()
    kw = dict(next(t for t in cfg["train_pipeline"]
                   if t["type"] == "InstaBoost"))
    kw.pop("type")
    return dict(kw, **over)


def test_instaboost_config_matches_jax():
    kw = _instaboost_kwargs()
    port_t = transforms.InstaBoost(**kw)
    jax_t = jax_transforms.InstaBoost(**kw)
    changed = 0
    for seed in range(24):
        s = sample(seed)
        got, want = _run(port_t, jax_t, s)
        assert_same(got, want)
        changed += not np.array_equal(got["img"], s["img"])
    assert 6 <= changed <= 18


@pytest.mark.parametrize("action", ["normal", "horizontal", "skip"])
def test_instaboost_actions_match_jax(action):
    prob = [float(a == action) for a in ("normal", "horizontal", "skip")]
    kw = _instaboost_kwargs(aug_ratio=1.0, action_prob=prob,
                            dx=40, dy=40, theta=(-20, 20), color_prob=1.0)
    port_t = transforms.InstaBoost(**kw)
    jax_t = jax_transforms.InstaBoost(**kw)
    for seed in range(6):
        s = sample(100 + seed)
        got, want = _run(port_t, jax_t, s)
        assert_same(got, want)
        if action == "skip":
            np.testing.assert_array_equal(got["img"], s["img"])
        else:
            assert not np.array_equal(got["img"], s["img"])

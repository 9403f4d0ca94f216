"""Scale Match: the port's data/scale_match.py against the JAX package's,
on the same synthetic annotation files and the same RandomStates.

- `get_distribute` (the target's size histogram) with and without the
  outlier bins, in log bins, and reshaped to a (mu, sigma): equal;
- the three strategies' `get_new_size` over 120 images each, one
  RandomState an image on both sides, with `clip` and
  `use_default_scale`: equal sizes and fail counts, the images covering
  empty gts, scales out of range and the fallback when every box would
  fall below 2 px;
- `ScaleMatchResize` and `ReAspect` on the same results: images bit for
  bit, boxes, labels, `gt_anns_id` and ignored boxes filtered alike;
- CocoFmtDataset with the sm and msm train pipelines of
  configs/tinyperson/scale_match/ (the files swapped for the synthetic
  ones) at epochs 0 and 1: equal sample for sample;
- the collator's pad shape: a portrait 480x640 image whose boxes clip the
  match's scale at its upper bound comes out taller than the configs'
  (512, 640), and both packages' DetCollator raise on it;
- the port's train CLI runs two iterations of the msm Faster R-CNN config
  at toy width on the CPU, the config's own train pipeline.

The JAX side is numpy here, so the file takes seconds.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import pointtinybenchmark_tpu.data.scale_match as jsm
from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.loader import DetCollator as JaxCollator
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data import scale_match as sm
from pointtinybenchmark_tpu_torch.data.loader import DetCollator
from pointtinybenchmark_tpu_torch.tools import train as train_cli
from pointtinybenchmark_tpu_torch.utils.config import Config
from test_torch_data import assert_same

REPO = Path(__file__).resolve().parents[1]
# COCO's 80 category ids
COCO_IDS = [i for i in range(1, 91) if i not in
            (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
SM_DIR = "configs/tinyperson/scale_match/"
MSM_FRCNN = SM_DIR + "faster_rcnn_r50_fpn_1x_coco_msm_tinyperson.py"
CONFIGS = {"sm": SM_DIR + "retinanet_r50_fpns4_1x_coco_sm_tinyperson.py",
           "msm": MSM_FRCNN}


def write_coco_set(img_dir, path, n, seed, hw=((96, 128), (128, 96)),
                   objects=(2, 16), sides=(4.0, 48.0)):
    """`n` JPEG images in `img_dir` alternating landscape and portrait
    `hw`, with `objects` boxes of `sides` px (log-uniform) of the 80 COCO
    categories, ~5% iscrowd; their COCO json at `path`."""
    rng = np.random.RandomState(seed)
    img_dir.mkdir(parents=True, exist_ok=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = hw[i % len(hw)]
        img = (rng.rand(h, w, 3) * 80).astype(np.uint8)
        for _ in range(rng.randint(*objects)):
            bw, bh = np.exp(rng.uniform(*np.log(sides), 2)).clip(1, [w, h])
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(
                120, 256, 3)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.choice(COCO_IDS)),
                             bbox=[round(float(v), 2) for v in (x, y, bw, bh)],
                             area=float(bw * bh),
                             iscrowd=int(rng.rand() < 0.05)))
        fn = f"{path.stem}_{i}.jpg"
        Image.fromarray(img).save(img_dir / fn, quality=90)
        images.append(dict(id=i + 1, file_name=fn, width=w, height=h))
    path.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=c, name=f"c{c}") for c in COCO_IDS])))
    return path


def write_target(path, n, seed):
    """A TinyPerson-like annotation json: `n` persons of 2-20 px over 20
    images, every one tagged `ignore` 0 or 1 (~10% 1)."""
    rng = np.random.RandomState(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    wh = rng.uniform(2, 20, (n, 2))
    anns = [dict(id=i + 1, image_id=i % 20 + 1, category_id=1,
                 bbox=[0.0, 0.0, float(w), float(h)], area=float(w * h),
                 iscrowd=0, ignore=int(rng.rand() < 0.1))
            for i, (w, h) in enumerate(wh)]
    path.write_text(json.dumps(dict(
        images=[dict(id=i + 1, file_name=f"t{i}.jpg", width=640, height=512)
                for i in range(20)],
        annotations=anns, categories=[dict(id=1, name="person")])))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The synthetic files where the scale_match configs name them,
    relative to `root`."""
    root = tmp_path_factory.mktemp("scale_match")
    return dict(
        root=root, images=root / "data/coco/images",
        coco=write_coco_set(
            root / "data/coco/images",
            root / "data/coco/annotations/instances_train2017.json", 6, 0),
        target=write_target(root / "data/tiny_set/mini_annotations/"
                            "tiny_set_train_all_erase.json", 600, 1))


def _strategies(files):
    coco, target = str(files["coco"]), str(files["target"])
    return {
        "ScaleMatch": dict(anno_file=target, bins=100, default_scale=0.25,
                           scale_range=(0.1, 1.0)),
        "MonotonicityScaleMatch": dict(src_anno_file=coco,
                                       dst_anno_file=target, bins=50,
                                       default_scale=0.25,
                                       scale_range=(0.1, 1.0)),
        "GaussianScaleMatch": dict(src_anno_file=coco,
                                   mu_sigma=(np.log(8.0), 0.6), bins=50,
                                   default_scale=0.5, scale_range=(0.2, 1.0)),
    }


# ----------------------------------------------------- the distribution
@pytest.mark.parametrize("except_rate,log_bins,mu_sigma", [
    (0.1, False, (-1, -1)), (0.0, False, (-1, -1)), (0.02, True, (-1, -1)),
    (0.02, False, (12.0, 4.0)), (0.04, True, (12.0, 4.0))])
def test_get_distribute_equals_jax(files, except_rate, log_bins, mu_sigma):
    anns = json.loads(files["target"].read_text())["annotations"]
    want = jsm.get_distribute(anns, 50, except_rate, log_bins, mu_sigma)
    got = sm.get_distribute(anns, 50, except_rate, log_bins, mu_sigma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() == pytest.approx(1.0) and len(got[1]) == 51


# --------------------------------------------------------- the strategies
def _images(n, seed):
    """(hw, boxes) of `n` images: empty ones, 1-20 boxes of 1-300 px, and
    thin ones (300 x 0.3 px) that every scale below 1 collapses."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        hw = (int(rng.randint(200, 700)), int(rng.randint(200, 700)))
        k = 0 if i % 10 == 0 else int(rng.randint(1, 21))
        wh = np.exp(rng.uniform(0, np.log(300), (k, 2)))
        if i % 10 == 5:
            wh[:] = [300.0, 0.3]
        xy = rng.uniform(0, 100, (k, 2))
        out.append((hw, np.concatenate([xy, xy + wh], 1)))
    return out


@pytest.mark.parametrize("deal", ["clip", "use_default_scale"])
@pytest.mark.parametrize("kind", ["ScaleMatch", "MonotonicityScaleMatch",
                                  "GaussianScaleMatch"])
def test_get_new_size_equals_jax(files, kind, deal):
    kw = dict(_strategies(files)[kind], out_scale_deal=deal)
    jm, m = getattr(jsm, kind)(**kw), getattr(sm, kind)(**kw)
    sizes, default = [], 0
    for i, (hw, boxes) in enumerate(_images(120, 2)):
        want = jm.get_new_size(hw, boxes, np.random.RandomState(i))
        got = m.get_new_size(hw, boxes, np.random.RandomState(i))
        assert got == want, (i, got, want)
        sizes.append(got[0] / hw[0])
        default += got == m._default_size(hw)
    assert m.fail_time == jm.fail_time >= 12       # the thin images
    assert default >= 24                            # and the empty ones
    assert len(set(np.round(sizes, 2))) >= 10


# ------------------------------------------------------- the transforms
def _results(seed):
    rng = np.random.RandomState(seed)
    h, w = 160, 120
    boxes = np.concatenate([rng.uniform(0, 60, (9, 2)), np.zeros((9, 2))], 1)
    boxes[:, 2:] = boxes[:, :2] + np.exp(rng.uniform(np.log(8), np.log(40),
                                                     (9, 2)))
    boxes[0, 2:] = boxes[0, :2] + 0.5              # filtered at any scale
    return dict(img=rng.randint(0, 256, (h, w, 3)).astype(np.float32),
                gt_bboxes=boxes.astype(np.float32),
                gt_labels=rng.randint(0, 80, 9).astype(np.int64),
                gt_anns_id=np.arange(1, 10, dtype=np.int64),
                gt_bboxes_ignore=np.asarray([[1, 1, 1.5, 1.5], [4, 4, 40, 30]],
                                            np.float32),
                bbox_fields=["gt_bboxes", "gt_bboxes_ignore"],
                _rng=np.random.RandomState(seed))


@pytest.mark.parametrize("kind", ["ScaleMatch", "MonotonicityScaleMatch",
                                  "GaussianScaleMatch", "ReAspect"])
def test_transforms_equal_jax(files, kind):
    if kind == "ReAspect":
        cfg = dict(type="ReAspect", aspects=[0.5, 1.0, 2.5])
    else:
        cfg = dict(type="ScaleMatchResize", scale_match_type=kind,
                   **_strategies(files)[kind])
    cfg = {k: v for k, v in cfg.items() if k != "type"}
    jt = getattr(jsm, "ReAspect" if kind == "ReAspect"
                 else "ScaleMatchResize")(**cfg)
    t = getattr(sm, "ReAspect" if kind == "ReAspect"
                else "ScaleMatchResize")(**cfg)
    dropped = resized = 0
    for seed in range(6):
        want, got = jt(_results(seed)), t(_results(seed))
        want.pop("_rng"), got.pop("_rng")
        assert_same(want, got, f"seed {seed}")
        dropped += 9 - len(got["gt_bboxes"])
        resized += got["img"].shape != (160, 120, 3)
    assert resized >= 3
    if kind != "ReAspect":
        assert dropped >= 6                # the 0.5 px box every time


# --------------------------------------------------------- the dataset
def _pipeline(kind, files):
    cfg = Config.fromfile(str(REPO / CONFIGS[kind]))
    pipeline = copy.deepcopy(cfg.data["train"]["pipeline"])
    smr = pipeline[2]
    assert smr["type"] == "ScaleMatchResize"
    for key in ("anno_file", "dst_anno_file"):
        if key in smr:
            smr[key] = str(files["target"])
    if "src_anno_file" in smr:
        smr["src_anno_file"] = str(files["coco"])
    return pipeline


@pytest.mark.parametrize("kind", ["sm", "msm"])
def test_dataset_samples_equal_jax(files, kind):
    cfg = dict(type="CocoFmtDataset", ann_file=str(files["coco"]),
               img_prefix=str(files["images"]), seed=3,
               pipeline=_pipeline(kind, files))
    jds, ds = jax_build_dataset(copy.deepcopy(cfg)), build_dataset(cfg)
    assert len(ds.classes) == len(jds.classes) == 80
    shapes = set()
    for epoch in range(2):
        jds.set_epoch(epoch)
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            want, got = jds[i], ds[i]
            assert_same(want, got, f"epoch {epoch} sample {i}")
            shapes.add(got["img_metas"]["img_shape"])
    assert len(shapes) >= 6            # the match drew other sizes


def test_pad_shape_overflow_raises_in_both(files, tmp_path):
    """MonotonicityScaleMatch at the configs' scale range (0.1, 1.0), from
    a source whose smallest objects are 1-2 px, as COCO's are: a portrait
    480x640 image whose boxes are as small as the source's smallest keeps
    a scale near 1, so it stays taller than 512."""
    rng = np.random.RandomState(4)
    sizes = np.exp(rng.normal(np.log(40), 1.2, 600)).clip(1, 600)
    src = tmp_path / "src.json"
    src.write_text(json.dumps(dict(annotations=[
        dict(id=i + 1, image_id=1, bbox=[0, 0, float(v), float(v)],
             iscrowd=0) for i, v in enumerate(sizes)])))
    kw = dict(_strategies(files)["MonotonicityScaleMatch"],
              src_anno_file=str(src))
    t = sm.ScaleMatchResize(scale_match_type="MonotonicityScaleMatch", **kw)
    jt = jsm.ScaleMatchResize(scale_match_type="MonotonicityScaleMatch",
                              **kw)
    side = float(t.scale_match.src_sizes[0])
    box = np.asarray([[100, 100, 100 + side, 100 + side]], np.float32)

    def results():
        return dict(img=np.zeros((640, 480, 3), np.float32), gt_bboxes=box,
                    gt_labels=np.zeros(1, np.int64), bbox_fields=["gt_bboxes"],
                    _rng=np.random.RandomState(0))
    got, want = t(results()), jt(results())
    assert got["img"].shape == want["img"].shape
    assert got["img"].shape[0] > 512, got["img"].shape
    with pytest.raises(ValueError, match="exceeds the pad shape"):
        DetCollator((512, 640))([got])
    with pytest.raises(AssertionError, match="exceeds pad shape"):
        JaxCollator((512, 640))([want])


# --------------------------------------------------------- the train CLI
TOY = ["model.backbone.base_channels=8",
       "model.neck.in_channels=32,64,128,256", "model.neck.out_channels=16",
       "model.rpn_head.in_channels=16", "model.rpn_head.feat_channels=16",
       "model.roi_head.bbox_roi_extractor.out_channels=16",
       "model.roi_head.bbox_head.in_channels=16",
       "model.roi_head.bbox_head.fc_out_channels=32"]


def test_train_cli_runs_the_msm_config(files, monkeypatch):
    """From the folder that holds the config's `data/` files: the config
    as written but for its widths, batch and pad shape (toy) and the
    runner's length (the list-valued pipeline cannot be changed by
    --cfg-options, in either package)."""
    monkeypatch.chdir(files["root"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        work = files["root"] / "work"
        metrics = train_cli.main([
            str(REPO / MSM_FRCNN), "--work-dir", str(work), "--device",
            "cpu", "--no-validate", "--cfg-options", *TOY,
            "data.samples_per_gpu=2", "loader.pad_shape=128,128",
            "runner.type=IterBasedRunner", "runner.max_iters=2",
            "checkpoint_config.interval=2", "log_config.interval=1"])
    finally:
        torch.set_num_threads(n)
    assert metrics is None
    log = [json.loads(line) for line in open(work / "log.json")]
    assert [e["step"] for e in log] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in log)
    assert (work / "iter_2.pth").exists()

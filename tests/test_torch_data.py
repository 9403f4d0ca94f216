"""The port's dataset path against the JAX package's, on the same files.

A seeded synthetic TinyPerson-format set (JPEG frames with 2-20 px
persons, some tagged `ignore`, `uncertain` or `iscrowd`) is read by both
packages' CocoFmtDataset:
- `generate_corner_dataset` gives the same corner json;
- train samples (the TinyPerson train pipeline on the corner set: corner
  crop on load, RandomFlip drawn from the sample's RandomState, Normalize,
  Pad) are equal array for array over two epochs: the image, gt_bboxes,
  gt_labels, gt_bboxes_ignore and img_metas; so are the datasets'
  img_ids, `flag` and each image's parsed annotations (anns_id,
  true_bboxes);
- the COCO base pipelines: train samples resized to img_scale (PIL's
  bilinear), and test samples under NoAug (which keeps the native
  resolution in both packages);
- test samples of CroppedTilesFlipAug with flip are equal view for view,
  tile_offset included;
- the dataset options: class discovery, `min_gt_size`, the corner and
  noise json written on the fly, a proposal file, and `format_results`;
- the registry refuses what it does not hold; the options that were
  refused before the dataset wrappers, the recall and the tile merge were
  ported now build and give JAX's results.

Both packages decode with PIL, so the images compare bit for bit.
"""
import copy
import json
import pickle

import numpy as np
import pytest
from PIL import Image

from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.tiling import \
    generate_corner_dataset as jax_corner
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data.tiling import generate_corner_dataset
from pointtinybenchmark_tpu_torch.utils.registry import PIPELINES

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
TRAIN_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", scale_factor=[1.0], keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
    dict(type="DefaultFormatBundle"),
    dict(type="Collect",
         keys=["img", "gt_bboxes", "gt_labels", "gt_bboxes_ignore"]),
]
TILED_TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="CroppedTilesFlipAug", tile_shape=(96, 64),
         tile_overlap=(16, 16), scale_factor=[1.0], flip=True,
         transforms=[
             dict(type="Resize", keep_ratio=True),
             dict(type="RandomFlip"),
             dict(type="Normalize", **NORM),
             dict(type="Pad", size_divisor=32),
             dict(type="ImageToTensor", keys=["img"]),
             dict(type="Collect", keys=["img"]),
         ]),
]
COCO_TRAIN_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="LoadAnnotations", with_bbox=True),
    dict(type="Resize", img_scale=(150, 100), keep_ratio=True),
    dict(type="RandomFlip", flip_ratio=0.5),
    dict(type="Normalize", **NORM),
    dict(type="Pad", size_divisor=32),
    dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels"]),
]
COCO_TEST_PIPELINE = [
    dict(type="LoadImageFromFile"),
    dict(type="NoAug", transforms=[
        dict(type="Resize", img_scale=(150, 100), keep_ratio=True),
        dict(type="Normalize", **NORM),
        dict(type="Pad", size_divisor=32),
        dict(type="Collect", keys=["img"]),
    ]),
]
CORNER = dict(sub_img_w=96, sub_img_h=64, overlap_w=16, overlap_h=16)
CELL = 24


def write_tinyperson_set(root, name, n, hw, seed, persons=(6, 16)):
    """`n` JPEG frames of (h, w) = `hw` under root/name/ and their COCO
    json root/name.json: 2-20 px persons in disjoint CELL x CELL cells
    (so that no two boxes overlap), ~10% tagged ignore, ~5% uncertain,
    ~5% iscrowd. Returns the json's path."""
    rng = np.random.RandomState(seed)
    (root / name).mkdir()
    h, w = hw
    cells = [(x, y) for y in range(0, h - CELL + 1, CELL)
             for x in range(0, w - CELL + 1, CELL)]
    images, anns = [], []
    for i in range(n):
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        for c in rng.permutation(len(cells))[:rng.randint(*persons)]:
            bw, bh = (float(v) for v in np.round(rng.uniform(2, 20, 2), 2))
            x = float(np.round(cells[c][0] + rng.uniform(0, CELL - bw), 2))
            y = float(np.round(cells[c][1] + rng.uniform(0, CELL - bh), 2))
            img[int(y):int(np.ceil(y + bh)), int(x):int(np.ceil(x + bw))] = \
                rng.randint(150, 256, 3)
            ann = dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                       bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0)
            kind = rng.rand()
            if kind < 0.10:
                ann["ignore"] = 1
            elif kind < 0.15:
                ann["uncertain"] = 1
            elif kind < 0.20:
                ann["iscrowd"] = 1
            anns.append(ann)
        fn = f"{name}_{i}.jpg"
        Image.fromarray(img).save(root / name / fn, quality=90)
        images.append(dict(id=i + 1, file_name=fn, width=w, height=h))
    path = root / f"{name}.json"
    path.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=1, name="person")])))
    return path


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("tinyperson")
    return dict(root=root,
                train=write_tinyperson_set(root, "train", 3, (160, 192), 0),
                test=write_tinyperson_set(root, "test", 2, (128, 192), 1))


def assert_same(a, b, path="sample"):
    """Equal nested samples: dicts key for key, arrays in dtype, shape and
    value, the rest by ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a.keys(),
                                                          b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def both(cfg):
    return jax_build_dataset(copy.deepcopy(cfg)), build_dataset(cfg)


def test_corner_dataset_equals_jax(tiny_set):
    got = generate_corner_dataset(str(tiny_set["train"]), CORNER)
    assert got == jax_corner(str(tiny_set["train"]), CORNER)
    assert len(got["images"]) == 3 * 9      # 3 x 3 tiles of 160x192
    assert any(a.get("ignore") and "ori_ann_id" in a
               for a in got["annotations"])


@pytest.mark.parametrize("pipeline", ["tinyperson", "coco"])
def test_train_samples_equal_jax(tiny_set, pipeline):
    cfg = dict(type="CocoFmtDataset", ann_file=str(tiny_set["train"]),
               img_prefix=str(tiny_set["root"] / "train"), seed=3)
    if pipeline == "tinyperson":
        cfg.update(pipeline=TRAIN_PIPELINE, corner_kwargs=dict(CORNER))
    else:
        cfg.update(pipeline=COCO_TRAIN_PIPELINE)
    jds, ds = both(cfg)
    assert ds.img_ids == jds.img_ids and ds.classes == jds.classes
    assert_same(jds.flag, ds.flag)
    flips = set()
    for epoch in range(2):
        jds.set_epoch(epoch)
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            assert_same(jds.get_ann_info(i), ds.get_ann_info(i), f"ann {i}")
            want, got = jds[i], ds[i]
            assert_same(want, got, f"epoch {epoch} sample {i}")
            flips.add(bool(got["img_metas"]["flip"]))
            if pipeline == "coco":     # 160x192 resized to 100x120, padded
                assert got["img"].shape == (128, 128, 3)
    assert flips == {False, True}


@pytest.mark.parametrize("pipeline", ["tiled", "coco"])
def test_test_views_equal_jax(tiny_set, pipeline):
    cfg = dict(type="CocoFmtDataset", ann_file=str(tiny_set["test"]),
               img_prefix=str(tiny_set["root"] / "test"), test_mode=True,
               pipeline=(TILED_TEST_PIPELINE if pipeline == "tiled"
                         else COCO_TEST_PIPELINE))
    jds, ds = both(cfg)
    assert_same(jds.flag, ds.flag)
    for i in range(len(ds)):
        want, got = jds[i], ds[i]
        assert_same(want, got, f"sample {i}")
    if pipeline == "tiled":     # 3 x 3 tiles of 96x64, each plain and flipped
        offs = [tuple(v["img_metas"]["tile_offset"]) for v in got["views"]]
        assert len(offs) == 18 and offs[0] == offs[1] == (0.0, 0.0)
        assert offs[-1] == (96.0, 64.0)
    else:   # NoAug sets the scale to None: native resolution, as in JAX
        assert got["views"][0]["img"].shape == (128, 192, 3)


@pytest.mark.parametrize("option", ["classes", "min_gt_size", "noise",
                                    "proposals", "format_results"])
def test_dataset_options_equal_jax(tiny_set, tmp_path, option):
    cfg = dict(type="CocoFmtDataset", ann_file=str(tiny_set["train"]),
               img_prefix=str(tiny_set["root"] / "train"),
               pipeline=TRAIN_PIPELINE)
    if option == "classes":
        cfg["classes"] = ["person"]
    elif option == "min_gt_size":
        cfg["min_gt_size"] = 12
    elif option == "noise":
        src = json.loads(tiny_set["train"].read_text())
        for a in src["annotations"]:
            a["point"] = [a["bbox"][0] + 1, a["bbox"][1] + 1]
        ann = tmp_path / "points.json"
        ann.write_text(json.dumps(src))
        cfg.update(ann_file=str(ann),
                   noise_kwargs=dict(pseudo_wh=(16, 16), noise_rg=0.3))
    elif option == "proposals":
        rng = np.random.RandomState(4)
        props = [np.hstack([rng.rand(5, 2) * 90, 90 + rng.rand(5, 2) * 90,
                            rng.rand(5, 1)]).astype(np.float32)
                 for _ in range(3)]
        with open(tmp_path / "props.pkl", "wb") as f:
            pickle.dump(props, f)
        cfg.update(proposal_file=str(tmp_path / "props.pkl"),
                   pipeline=[dict(type="LoadImageFromFile"),
                             dict(type="LoadProposals", num_max_proposals=3),
                             dict(type="LoadAnnotations", with_bbox=True),
                             dict(type="RandomFlip", flip_ratio=0.5),
                             dict(type="Collect", keys=["img", "proposals",
                                                        "gt_bboxes"])])
    jds, ds = both(cfg)
    assert ds.img_ids == jds.img_ids and ds.classes == jds.classes
    assert ds.ann_file == jds.ann_file
    for i in range(len(ds)):
        assert_same(jds.get_ann_info(i), ds.get_ann_info(i), f"ann {i}")
        assert_same(jds[i], ds[i], f"sample {i}")
    if option == "min_gt_size":
        assert 0 < len(ds) < 3
    if option == "noise":
        assert "true_bboxes" in ds.get_ann_info(0)
    if option == "format_results":
        rng = np.random.RandomState(5)
        results = [dict(bboxes=np.hstack([rng.rand(4, 2) * 50,
                                          50 + rng.rand(4, 2) * 50,
                                          rng.rand(4, 1)]).astype(np.float32),
                        labels=np.zeros(4, np.int64),
                        anns_id=np.arange(4) + 10 * i,
                        points=rng.rand(4, 3).astype(np.float32))
                   for i in range(len(ds))]
        assert ds.format_results(results) == jds.format_results(results)


def test_refused_and_not_ported(tiny_set):
    with pytest.raises(KeyError, match="not registered"):
        PIPELINES.build(dict(type="PhotoMetricDistortion"))
    cfg = dict(type="CocoFmtDataset", ann_file=str(tiny_set["test"]),
               pipeline=[], test_mode=True)
    merged = build_dataset(dict(cfg, merge_after_infer_kwargs=dict(
        merge_gt_file="x.json")))
    assert merged.merge_after_infer_kwargs == dict(merge_gt_file="x.json")
    jds, ds = both(cfg)
    results = [dict(bboxes=np.zeros((0, 5), np.float32),
                    labels=np.zeros(0, np.int64))] * len(ds)
    got = ds.evaluate(results, metric="proposal_fast")
    assert got == jds.evaluate(results, metric="proposal_fast")
    assert list(got) == ["AR@100", "AR@300", "AR@1000"]
    jcat, cat = jax_build_dataset([cfg, cfg]), build_dataset([cfg, cfg])
    assert len(cat) == len(jcat) == 2 * len(ds)
    assert_same(jcat.flag, cat.flag)

"""LVIS evaluation and the LVIS, Cityscapes and DeepFashion datasets: the
port against the JAX package on the same json files and detections.

The synthetic LVIS set has 9 classes of each frequency bin (r, c, f), 8
images with `coco_url` names (one named `COCO_val2014_...`), their
`neg_category_ids` (classes verified absent) and
`not_exhaustive_category_ids` (classes with gts whose other instances
were not all boxed). The detections are jittered gts, random boxes of the
image's gt classes, of its negative classes and of classes that are
neither (which the federated drop removes).

- `LVISExpandEval`'s stats (mAP, AP50, AP75, APs / APm / APl,
  APr / APc / APf, AR@300) equal JAX's, with the native matching and with
  the Python reference loops; the federated drop removes detections, the
  not-exhaustive ignore ignores some, and the stats differ from the plain
  COCO evaluation at maxDets 300;
- `LVISDataset`: the file names from `coco_url` (and a `COCO_` name's
  last part) equal JAX's, its `evaluate` (bbox) equals JAX's;
- `CityscapesDataset` and `DeepFashionDataset`: their classes and bbox
  metrics equal JAX's; `metric="cityscapes"` raises JAX's ImportError
  (the cityscapesscripts package is absent in both).
"""
import json

import numpy as np
import pytest

from pointtinybenchmark_tpu.data import build_dataset as jax_build_dataset
from pointtinybenchmark_tpu.data.coco import COCO as JaxCOCO
from pointtinybenchmark_tpu.evaluation.lvis_eval import \
    LVISExpandEval as JaxLVISEval
from pointtinybenchmark_tpu_torch.data import build_dataset
from pointtinybenchmark_tpu_torch.data.coco import COCO
from pointtinybenchmark_tpu_torch.evaluation.cocoeval import COCOExpandEval
from pointtinybenchmark_tpu_torch.evaluation.lvis_eval import LVISExpandEval

N_IMAGES = 8
N_CATS = 27


def lvis_set(seed=0):
    """The gt json (dict) and a detection list of a synthetic LVIS split."""
    rng = np.random.RandomState(seed)
    cats = [dict(id=c + 1, name=f"cat{c + 1}", frequency="rcf"[c % 3])
            for c in range(N_CATS)]
    images, anns, dets = [], [], []
    for i in range(N_IMAGES):
        h, w = (480, 640) if i % 2 else (640, 480)
        pos = rng.choice(N_CATS, 6, replace=False) + 1
        rest = [c for c in range(1, N_CATS + 1) if c not in pos]
        neg = rng.choice(rest, 5, replace=False)
        url = f"http://images.cocodataset.org/val2017/{i + 1:012d}.jpg"
        img = dict(id=i + 1, width=w, height=h, coco_url=url,
                   neg_category_ids=[int(c) for c in neg],
                   not_exhaustive_category_ids=[int(c) for c in pos[:2]])
        if i == 3:
            img["file_name"] = f"COCO_val2014_{i + 1:012d}.jpg"
        images.append(img)
        for c in pos:
            for _ in range(rng.randint(1, 4)):
                bw, bh = np.exp(rng.uniform(np.log(8), np.log(200), 2))
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                                 category_id=int(c), bbox=[x, y, bw, bh],
                                 area=float(bw * bh), iscrowd=0))
                if rng.rand() < 0.8:
                    j = rng.randn(4) * [3, 3, 4, 4]
                    dets.append(dict(image_id=i + 1, category_id=int(c),
                                     bbox=[x + j[0], y + j[1],
                                           max(bw + j[2], 1),
                                           max(bh + j[3], 1)],
                                     score=float(rng.rand())))
        for c in list(pos) * 2 + list(neg) + list(rng.choice(rest, 4)):
            bw, bh = np.exp(rng.uniform(np.log(8), np.log(200), 2))
            dets.append(dict(image_id=i + 1, category_id=int(c),
                             bbox=[float(rng.uniform(0, w - bw)),
                                   float(rng.uniform(0, h - bh)),
                                   float(bw), float(bh)],
                             score=float(rng.rand() * 0.7)))
    return dict(images=images, annotations=anns, categories=cats), dets


@pytest.fixture(scope="module")
def lvis_json(tmp_path_factory):
    gt, dets = lvis_set()
    path = tmp_path_factory.mktemp("lvis") / "lvis_v1_val.json"
    path.write_text(json.dumps(gt))
    return path, dets


def _stats(ev):
    ev.evaluate()
    ev.accumulate()
    return dict(ev.summarize())


@pytest.mark.parametrize("native", [True, False])
def test_lvis_eval_matches_jax(lvis_json, native):
    path, dets = lvis_json
    gt = COCO(str(path))
    mine = LVISExpandEval(gt, gt.loadRes(dets), native=native)
    got = _stats(mine)
    jgt = JaxCOCO(str(path))
    want = _stats(JaxLVISEval(jgt, jgt.loadRes(dets)))
    assert list(got) == list(want)
    assert got == want, (got, want)
    assert list(got)[-4:] == ["APr", "APc", "APf", "AR@300"]
    assert all(0.0 < got[k] < 1.0 for k in ("mAP", "APr", "APc", "APf"))
    # the federated drop and the not-exhaustive ignore both act
    kept = sum(len(v) for v in mine._dts.values())
    assert kept < len(dets)
    assert any(e is not None and e["category_id"] in mine._img_ne[
        e["image_id"]] and (e["dtIgnore"] & (e["dtMatches"] == 0)).any()
        for e in mine.evalImgs.values())
    plain = _stats(COCOExpandEval(gt, gt.loadRes(dets), native=native,
                                  cocofmt_param=dict(maxDets=[300])))
    assert plain["mAP_all"] != got["mAP"]


def _dataset(build, kind, path, **kw):
    return build(dict(type=kind, ann_file=str(path), img_prefix="data/",
                      pipeline=[], test_mode=True, **kw))


def _results(ds, rng):
    """Per image: each gt jittered, plus random boxes, labels in range."""
    out = []
    for info in ds.data_infos:
        ann = ds.get_ann_info(ds.data_infos.index(info))
        b = ann["bboxes"] + rng.randn(*ann["bboxes"].shape) * 2
        extra = rng.rand(5, 4) * 200
        extra[:, 2:] += extra[:, :2] + 8
        boxes = np.concatenate([b, extra]).astype(np.float32)
        scores = rng.rand(len(boxes), 1).astype(np.float32)
        labels = np.concatenate([ann["labels"], rng.randint(
            0, len(ds.cat_ids), 5)])
        out.append(dict(bboxes=np.concatenate([boxes, scores], 1),
                        labels=labels))
    return out


def test_lvis_dataset_matches_jax(lvis_json):
    path, _ = lvis_json
    mine = _dataset(build_dataset, "LVISDataset", path)
    ref = _dataset(jax_build_dataset, "LVISDataset", path)
    names = [i["filename"] for i in mine.data_infos]
    assert names == [i["filename"] for i in ref.data_infos]
    assert names[0] == "val2017/000000000001.jpg"
    assert names[3] == "000000000004.jpg"
    results = _results(mine, np.random.RandomState(1))
    got = mine.evaluate(results)
    assert got == ref.evaluate(results)
    assert got["mAP"] > 0


def _coco_set(path, n_cats, seed):
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(4):
        images.append(dict(id=i + 1, file_name=f"{i}.jpg", width=320,
                           height=240))
        for _ in range(rng.randint(2, 6)):
            bw, bh = rng.uniform(10, 100, 2)
            x, y = rng.uniform(0, 320 - bw), rng.uniform(0, 240 - bh)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.randint(1, n_cats + 1)),
                             bbox=[x, y, bw, bh], area=float(bw * bh),
                             iscrowd=0))
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=[dict(id=c + 1, name=f"c{c}")
                                                for c in range(n_cats)])))
    return path


@pytest.mark.parametrize("kind,n_cats", [("CityscapesDataset", 8),
                                         ("DeepFashionDataset", 15)])
def test_cityscapes_deepfashion_match_jax(tmp_path, kind, n_cats):
    path = _coco_set(tmp_path / "ann.json", n_cats, 2)
    gt = json.loads(path.read_text())
    mine = _dataset(build_dataset, kind, path)
    ref = _dataset(jax_build_dataset, kind, path)
    assert list(mine.classes) == list(ref.classes) == list(type(ref).CLASSES)
    assert len(mine.classes) == n_cats
    # the category names are the dataset's classes, in its json order
    for c, name in zip(gt["categories"], mine.classes):
        c["name"] = name
    path.write_text(json.dumps(gt))
    mine = _dataset(build_dataset, kind, path)
    ref = _dataset(jax_build_dataset, kind, path)
    results = _results(mine, np.random.RandomState(3))
    got = mine.evaluate(results, metric="bbox")
    assert got == ref.evaluate(results, metric="bbox")
    assert got["mAP_all"] > 0
    if kind == "CityscapesDataset":
        with pytest.raises(ImportError) as err:
            mine.evaluate(results, metric="cityscapes")
        with pytest.raises(ImportError) as jerr:
            ref.evaluate(results, metric="cityscapes")
        assert str(err.value) == str(jerr.value)
        assert str(err.value).startswith("metric='cityscapes' needs")

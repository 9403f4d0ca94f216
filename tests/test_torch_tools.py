"""The port's command-line tools against the JAX package's.

- The test CLI: one JAX `.ckpt` of a toy Adap RetinaNet (ResNet-50 of
  base 8, FPN 16 from stride 4, one stacked conv; JAX's seeded init saved
  with the JAX package's `save_checkpoint`, `retina_cls.bias` at 0 as
  chip_smoke.py sets it for random weights, so that detections exist) is
  tested by JAX's tools/test.py `main()` and by the port's
  `python -m pointtinybenchmark_tpu_torch.tools.test ... --device cpu` on
  a synthetic TinyPerson-format set through the tiled protocol and the
  tiny evaluation: both write detections, and their printed metrics agree
  within 1e-6, with AP50_tiny above 0.
- The train CLI on the CPU: two iterations of an IterBasedRunner on the
  corner tiles of the train set, then validation; its last printed line
  equals the metrics that the test CLI prints for its checkpoint.
- `--cfg-options` parsing and merging equal to the JAX package's, and the
  dumped config reads back.

JAX's forward is compiled without XLA's backend optimisations; torch runs
on one thread. (torch 2.13's CPU backward of the channels-last ResNet-18
of base 8 corrupts the heap even on one thread at 128x160 and up, so the
toy is a ResNet-50.)
"""
import copy
import importlib.util
import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pointtinybenchmark_tpu.engine.test as jtest
from pointtinybenchmark_tpu.engine.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from pointtinybenchmark_tpu.models import build_detector as jax_build
from pointtinybenchmark_tpu.utils.config import Config as JaxConfig
from pointtinybenchmark_tpu.utils.config import \
    parse_cfg_option as jax_parse_cfg_option
from pointtinybenchmark_tpu_torch.tools import test as test_cli
from pointtinybenchmark_tpu_torch.tools import train as train_cli
from pointtinybenchmark_tpu_torch.utils.config import (Config,
                                                       parse_cfg_option)
from test_torch_data import (CORNER, TILED_TEST_PIPELINE, TRAIN_PIPELINE,
                             write_tinyperson_set)
from test_torch_eval import FAST_COMPILE, TINYPERSON_EVAL, FastJax

MODEL = """
model = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=50, base_channels=8, frozen_stages=1,
                  norm_eval=True),
    neck=dict(type="FPN", in_channels=[32, 64, 128, 256], out_channels=16,
              start_level=0, add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(
        type="RetinaHead", num_classes=1, in_channels=16, feat_channels=16,
        stacked_convs=1,
        anchor_generator=dict(type="AnchorGenerator", octave_base_scale=2,
                              scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                              strides=[4, 8, 16, 32, 64]),
        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0, 0, 0, 0],
                        target_stds=[1.0, 1.0, 1.0, 1.0]),
        loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                      alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(type="L1Loss", loss_weight=1.0)))
train_cfg = dict(
    assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                  min_pos_iou=0, ignore_iof_thr=-1),
    allowed_border=-1, pos_weight=-1)
test_cfg = dict(nms_pre=1000, score_thr=0.05,
                nms=dict(type="nms", iou_threshold=0.5), max_per_img=100)
optimizer = dict(type="SGD", lr=0.001, momentum=0.9, weight_decay=0.0001)
optimizer_config = dict(grad_clip=dict(max_norm=1, norm_type=2))
lr_config = dict(policy="step", warmup=None, step=[100])
runner = dict(type="IterBasedRunner", max_iters=2)
checkpoint_config = dict(interval=2)
log_config = dict(interval=1)
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    train = write_tinyperson_set(root, "train", 2, (128, 192), 5)
    test = write_tinyperson_set(root, "test", 2, (128, 192), 6)
    pipeline = copy.deepcopy(TILED_TEST_PIPELINE)
    pipeline[1]["flip"] = False
    ds = f"dict(type='CocoFmtDataset', ann_file=r'{test}', " \
         f"img_prefix=r'{root / 'test'}', pipeline={pipeline!r})"
    text = (f"data = dict(samples_per_gpu=1, workers_per_gpu=1, "
            f"train=dict(type='CocoFmtDataset', ann_file=r'{train}', "
            f"img_prefix=r'{root / 'train'}', corner_kwargs={CORNER!r}, "
            f"pipeline={TRAIN_PIPELINE!r}), val={ds}, test={ds})\n"
            f"loader = dict(pad_shape=(64, 96), max_gt=50, "
            f"max_gt_ignore=20)\n"
            f"evaluation = dict(interval=100, tiled=True, "
            f"**{TINYPERSON_EVAL!r})\n" + MODEL)
    cfg = root / "toy_retinanet.py"
    cfg.write_text(text)

    jcfg = JaxConfig.fromfile(str(cfg))
    jm = jax_build(dict(jcfg.model), None, jcfg.test_cfg)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3), jnp.float32))
    init = jax.jit(lambda r, x: jm.init(r, x, train=False)).lower(
        *args).compile(FAST_COMPILE)
    variables = jax.tree_util.tree_map(np.array, init(*args))
    head = variables["params"]["bbox_head_m"]["retina_cls"]
    head["bias"] = np.zeros_like(head["bias"])
    ckpt = root / "toy.ckpt"
    jax_save_checkpoint(str(ckpt), dict(params=variables["params"],
                                        batch_stats=variables["batch_stats"]))
    return dict(root=root, cfg=str(cfg), ckpt=str(ckpt))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def printed_metrics(out):
    """The metrics dict printed last (JAX prints it indented)."""
    return json.loads(out[out.rindex("{"):out.rindex("}") + 1])


def test_test_cli_matches_jax(workspace, monkeypatch, capsys, one_thread):
    spec = importlib.util.spec_from_file_location(
        "jax_tools_test", osp.join(osp.dirname(__file__), "..", "tools",
                                   "test.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(jtest, "jax", FastJax())
    jax_out = str(workspace["root"] / "jax_results.json")
    monkeypatch.setattr("sys.argv", ["test.py", workspace["cfg"],
                                     workspace["ckpt"], "--out", jax_out])
    capsys.readouterr()
    jax_cli.main()
    want = printed_metrics(capsys.readouterr().out)

    out = str(workspace["root"] / "results.json")
    ret = test_cli.main([workspace["cfg"], workspace["ckpt"], "--out", out,
                         "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == ret
    assert list(ret) == list(want)
    np.testing.assert_allclose(list(ret.values()), list(want.values()),
                               rtol=0, atol=1e-6)
    with open(out) as f, open(jax_out) as g:
        dets, jax_dets = json.load(f), json.load(g)
    assert len(dets) == len(jax_dets) > 0
    assert ret["AP50_tiny"] > 0, ret


def test_train_cli_then_test_cli(workspace, tmp_path, capsys, one_thread):
    work = str(tmp_path / "work")
    metrics = train_cli.main([workspace["cfg"], "--work-dir", work,
                              "--device", "cpu", "--seed", "1",
                              "--load-from", workspace["ckpt"]])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == metrics
    log = [json.loads(line) for line in open(osp.join(work, "log.json"))]
    assert [e["step"] for e in log] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in log)
    assert osp.exists(osp.join(work, "toy_retinanet.py"))
    ckpt = osp.join(work, "iter_2.pth")
    got = test_cli.main([workspace["cfg"], ckpt, "--device", "cpu"])
    assert got == metrics and "AP50_tiny" in got


def test_cfg_options_equal_jax(tmp_path):
    for v in ("1", "0.5", "true", "None", "a,b", "1,2,", "[1, 2]", "x/y.json",
              "(512, 640)", "IterBasedRunner"):
        assert parse_cfg_option(v) == jax_parse_cfg_option(v), v
    path = tmp_path / "c.py"
    path.write_text(MODEL + "data = dict(train=dict(ann_file='a.json', "
                    "pipeline=[dict(type='A'), dict(type='B')]))\n")
    opts = {"runner.max_iters": 40, "data.train.ann_file": "b.json",
            "model.bbox_head.num_classes": 3, "new.key": (1, 2),
            "data.train.pipeline.1.type": "C"}
    cfg, jcfg = Config.fromfile(str(path)), JaxConfig.fromfile(str(path))
    cfg.merge_from_dict(opts)
    jcfg.merge_from_dict(copy.deepcopy(opts))
    assert cfg.to_dict() == jcfg.to_dict()
    cfg.dump(str(tmp_path / "dump.py"))
    ns = {}
    exec((tmp_path / "dump.py").read_text(), ns)
    assert ns["cfg"] == cfg.to_dict()

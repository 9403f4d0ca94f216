"""The config sweep: every model config under configs/ either builds in
the port at toy width on the CPU, or raises the refusal this file's table
lists for it (its exception type and the start of its message).

`tests/test_torch_init.py::toy` cuts a config to toy width (ResNet-18 of
base 8, DetectoRS's ResNet-50 of base 16, necks and heads at 16 or 32
channels). It cannot shrink the
configs without a neck or with a list of necks (Libra R-CNN): those
(FULL) go to `build_detector` at full width, which refuses them before it
builds a layer (an unported detector type or backbone, a list of necks).
It shrinks a cascade's list of RoI bbox heads, one a stage, and HTC's and
SCNet's branch heads. 68 of the 118 configs build.
"""
import copy
import glob

import pytest
import torch
from torch import nn

from pointtinybenchmark_tpu_torch.models import build_detector
from pointtinybenchmark_tpu_torch.utils.config import Config
from test_torch_init import toy

BUILDS = "builds"
FULL = "full width"
N_BUILD = 68
TABLE = {
    "albu_example/mask_rcnn_r50_fpn_albu_1x_coco.py": BUILDS,
    "cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py": BUILDS,
    "coco/atss_r50_fpn_1x_coco.py": BUILDS,
    "coco/autoassign_r50_fpn_8x2_1x_coco.py":
        (KeyError, "detector AutoAssign is not ported"),
    "coco/cascade_rcnn_r50_fpn_1x_coco.py": BUILDS,
    "coco/centernet_r18_1x_coco.py":
        (KeyError, "detector CenterNet is not ported"),
    "coco/centripetalnet_hourglass104_16x6_coco.py":
        (FULL, KeyError, "detector CentripetalNet is not ported"),
    "coco/cornernet_hourglass104_10x5_coco.py":
        (FULL, KeyError, "detector CornerNet is not ported"),
    "coco/crpn_faster_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "CascadeRPNHead is not ported"),
    "coco/deformable_detr_r50_16x2_50e_coco.py":
        (KeyError, "detector DeformableDETR is not ported"),
    "coco/detectors_htc_r50_1x_coco.py": BUILDS,
    "coco/detr_r50_8x2_150e_coco.py":
        (FULL, KeyError, "detector DETR is not ported"),
    "coco/double_heads_r50_fpn_1x_coco.py":
        (KeyError, "detector DoubleHeadRCNN is not ported"),
    "coco/dynamic_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "detector DynamicRCNN is not ported"),
    "coco/fast_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "detector FastRCNN is not ported"),
    "coco/faster_rcnn_hrnetv2p_w32_1x_coco.py":
        (KeyError, "HRNet is not ported"),
    "coco/faster_rcnn_r2_101_fpn_1x_coco.py":
        (KeyError, "Res2Net is not ported"),
    "coco/faster_rcnn_r50_fpg_1x_coco.py": (KeyError, "FPG is not ported"),
    "coco/faster_rcnn_r50_fpn_1x_coco.py": BUILDS,
    "coco/faster_rcnn_r50_fpn_1x_scratch_coco.py": BUILDS,
    "coco/faster_rcnn_r50_fpn_attention_1111_1x_coco.py":
        (NotImplementedError,
        "ResNet: config keys ['plugins'] are not ported"),
    "coco/faster_rcnn_r50_fpn_carafe_1x_coco.py":
        (KeyError, "FPN_CARAFE is not ported"),
    "coco/faster_rcnn_r50_fpn_dconv_c3_c5_1x_coco.py":
        (NotImplementedError,
        "ResNet: config keys ['dcn', 'stage_with_dcn'] are not ported"),
    "coco/faster_rcnn_r50_fpn_groie_1x_coco.py":
        (NotImplementedError, "GenericRoIExtractor is not ported"),
    "coco/faster_rcnn_r50_fpn_mstrain_90k_coco.py": BUILDS,
    "coco/faster_rcnn_r50_fpn_seesaw_1x_lvis.py": BUILDS,
    "coco/faster_rcnn_r50_pafpn_1x_coco.py": (KeyError, "PAFPN is not ported"),
    "coco/faster_rcnn_s50_fpn_1x_coco.py": (KeyError, "ResNeSt is not ported"),
    "coco/fcos_r50_caffe_fpn_gn_head_1x_coco.py": BUILDS,
    "coco/fovea_r50_fpn_4x4_1x_coco.py": BUILDS,
    "coco/free_anchor_retinanet_r50_fpn_1x_coco.py": BUILDS,
    "coco/fsaf_r50_fpn_1x_coco.py": (KeyError, "detector FSAF is not ported"),
    "coco/ga_retinanet_r50_fpn_1x_coco.py":
        (KeyError, "GARetinaHead is not ported"),
    "coco/gfl_r50_fpn_1x_coco.py": (KeyError, "detector GFL is not ported"),
    "coco/grid_rcnn_r50_fpn_gn_2x_coco.py": BUILDS,
    "coco/htc_r50_fpn_1x_coco.py": BUILDS,
    "coco/ld_r18_gflv1_r101_fpn_1x_coco.py":
        (KeyError,
        "detector KnowledgeDistillationSingleStageDetector is not ported"),
    "coco/libra_faster_rcnn_r50_fpn_1x_coco.py":
        (FULL, NotImplementedError,
        "a list of necks (['FPN', 'BFP'], Libra R-CNN's form) is not ported"),
    "coco/mask_rcnn_r50_fpn_1x_coco.py": BUILDS,
    "coco/mask_rcnn_r50_fpn_gcb_r4_1x_coco.py":
        (NotImplementedError,
        "ResNet: config keys ['plugins'] are not ported"),
    "coco/mask_rcnn_r50_fpn_gn_all_2x_coco.py":
        (NotImplementedError,
        "Shared2FCBBoxHead: config keys ['norm_cfg'] are not ported"),
    "coco/mask_rcnn_r50_fpn_gn_ws_2x_coco.py":
        (NotImplementedError,
        "ResNet: config keys ['conv_ws'] are not ported"),
    "coco/mask_rcnn_regnetx_3GF_fpn_1x_coco.py":
        (KeyError, "RegNet is not ported"),
    "coco/ms_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "detector MaskScoringRCNN is not ported"),
    "coco/nas_fcos_r50_fpn_1x_coco.py":
        (KeyError, "NASFCOS_FPN is not ported"),
    "coco/paa_r50_fpn_1x_coco.py": (KeyError, "PAAHead is not ported"),
    "coco/pisa_faster_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "PISARoIHead is not ported"),
    "coco/pisa_retinanet_r50_fpn_1x_coco.py":
        (KeyError, "PISARetinaHead is not ported"),
    "coco/pisa_ssd300_coco.py": (FULL, KeyError, "SSDVGG is not ported"),
    "coco/point_rend_r50_caffe_fpn_1x_coco.py":
        (KeyError, "detector PointRend is not ported"),
    "coco/reppoints_moment_r50_fpn_1x_coco.py": BUILDS,
    "coco/reppoints_moment_r50_fpn_gn_neck_head_1x_coco.py": BUILDS,
    "coco/retinanet_ghm_r50_fpn_1x_coco.py": BUILDS,
    "coco/retinanet_r50_fpn_1x_coco.py": BUILDS,
    "coco/retinanet_r50_fpn_bf16_1x_coco.py":
        (NotImplementedError, "ResNet: config keys ['dtype'] are not ported"),
    "coco/retinanet_r50_nasfpn_1x_coco.py": (KeyError, "NASFPN is not ported"),
    "coco/rpn_r50_fpn_1x_coco.py": BUILDS,
    "coco/sabl_faster_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "SABLHead is not ported"),
    "coco/sabl_retinanet_r50_fpn_1x_coco.py":
        (KeyError, "SABLRetinaHead is not ported"),
    "coco/scnet_r50_fpn_1x_coco.py": BUILDS,
    "coco/sparse_rcnn_r50_fpn_1x_coco.py":
        (KeyError, "detector SparseRCNN is not ported"),
    "coco/ssd300_coco.py": (FULL, KeyError, "detector SSD is not ported"),
    "coco/tridentnet_r50_caffe_1x_coco.py":
        (FULL, KeyError, "detector TridentFasterRCNN is not ported"),
    "coco/vfnet_r50_fpn_1x_coco.py": BUILDS,
    "coco/yolact_r50_1x8_coco.py": (KeyError, "detector YOLACT is not ported"),
    "coco/yolof_r50_c5_8x8_1x_coco.py":
        (KeyError, "detector YOLOF is not ported"),
    "coco/yolov3_d53_608_273e_coco.py":
        (KeyError, "detector YOLOV3 is not ported"),
    "cpr/coarse_point_refine_r101_fpn_1x_coco400.py": BUILDS,
    "cpr/coarse_point_refine_r50_fpns4_1x_coco.py": BUILDS,
    "deepfashion/mask_rcnn_r50_fpn_15e_deepfashion.py": BUILDS,
    "dota/cascade_coarse_point_refine_r50_fpns4_1x_dota_1024.py":
        (NotImplementedError,
        "CascadeCPRHead: config keys ['cascade_cfg'] are not ported"),
    "dota/coarse_point_refine_r50_fpns4_1x_dota.py": BUILDS,
    "dota/p2p/p2p_r50_fpn_1x_fl_sl1_dota_center.py": BUILDS,
    "dota/p2p/p2p_r50_fpn_1x_fl_sl1_dota_coarse.py": BUILDS,
    "instaboost/cascade_mask_rcnn_r50_fpn_instaboost_4x_coco.py": BUILDS,
    "instaboost/mask_rcnn_r50_fpn_instaboost_4x_coco.py": BUILDS,
    "legacy_1x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py": BUILDS,
    "legacy_1x/faster_rcnn_r50_fpn_1x_coco_v1.py": BUILDS,
    "legacy_1x/mask_rcnn_r50_fpn_1x_coco_v1.py": BUILDS,
    "legacy_1x/retinanet_r50_caffe_fpn_1x_coco_v1.py":
        (NotImplementedError, "ResNet: config keys ['style'] are not ported"),
    "legacy_1x/retinanet_r50_fpn_1x_coco_v1.py": BUILDS,
    "legacy_1x/ssd300_coco_v1.py":
        (FULL, KeyError, "detector SSD is not ported"),
    "p2b/p2bnet_r50_fpn_1x_coco.py": BUILDS,
    "p2p/p2p_r101_fpn_1x_fl_sl1_coco400_coarse.py": BUILDS,
    "p2p/p2p_r50_fpn_1x_fl_sl1_coco400_coarse.py": BUILDS,
    "p2p/p2p_r50_fpns4_1x_coco.py": BUILDS,
    "ssd_det/ssd_det_r50_fpn_1x_coco.py": BUILDS,
    "tinyperson/atss_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/faster_rcnn_r50_fpn_1x_tinyperson640.py": BUILDS,
    "tinyperson/fcos_r50_fpn_1x_tinyperson640.py": BUILDS,
    "tinyperson/fcos_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/fovea_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/free_anchor_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/grid_rcnn_r50_fpn_1x_tinyperson640.py": BUILDS,
    "tinyperson/libra_faster_rcnn_r50_fpn_1x_tinyperson640.py":
        (FULL, NotImplementedError,
        "a list of necks (['FPN', 'BFP'], Libra R-CNN's form) is not ported"),
    "tinyperson/p2p_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/reppoints_r50_fpn_1x_tinyperson640.py": BUILDS,
    "tinyperson/reppoints_r50_fpn_gn_neck_head_1x_tinyperson640.py": BUILDS,
    "tinyperson/reppoints_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/reppoints_r50_fpns4_plain_1x_tinyperson640.py": BUILDS,
    "tinyperson/retinanet_r50_fpn_1x_tinyperson640.py": BUILDS,
    "tinyperson/retinanet_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinyperson/retinanet_r50_fpns4_1x_tinyperson640_clipg.py": BUILDS,
    "tinyperson/scale_match/faster_rcnn_r50_fpn_1x_coco_msm_tinyperson.py":
        BUILDS,
    "tinyperson/scale_match/faster_rcnn_r50_fpn_1x_coco_sm_tinyperson.py":
        BUILDS,
    "tinyperson/scale_match/retinanet_r50_fpns4_1x_coco_msm_tinyperson.py":
        BUILDS,
    "tinyperson/scale_match/retinanet_r50_fpns4_1x_coco_sm_tinyperson.py":
        BUILDS,
    "tinyperson/vfnet_r50_fpns4_1x_tinyperson640.py": BUILDS,
    "tinypersonv2/cpr/coarse_point_refine_r50_fpns4_0.5x_tinypersonv2_640.py":
        BUILDS,
    "tinypersonv2/cpr/coarse_point_refine_r50_fpns4_1x_tinypersonv2_640.py":
        BUILDS,
    "tinypersonv2/faster_rcnn_r50_fpn_1x_tinypersonv2_640.py": BUILDS,
    "tinypersonv2/fcos_r50_fpns4_1x_tinypersonv2_640.py": BUILDS,
    "tinypersonv2/p2p/p2p_r50_fpns4_0.5x_fl_sl1_tinypersonv2_640.py": BUILDS,
    "tinypersonv2/p2p/p2p_r50_fpns4_1x_fl_sl1_tinypersonv2_640.py": BUILDS,
    "tinypersonv2/reppoints_r50_fpns4_1x_tinypersonv2_640.py": BUILDS,
    "tinypersonv2/retinanet_r50_fpns4_1x_tinypersonv2_640.py": BUILDS,
    "voc/faster_rcnn_r50_fpn_1x_voc0712.py": BUILDS,
    "wider_face/ssd300_wider_face.py":
        (FULL, KeyError, "detector SSD is not ported"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny layers: torch's thread pool costs more than it gives, most of
    all with the suite's other workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    return sorted(p[len("configs/"):] for p in glob.glob(
        "configs/**/*.py", recursive=True) if "/_base_/" not in p)


def test_table_lists_every_config():
    assert _configs() == sorted(TABLE)
    assert sum(v == BUILDS for v in TABLE.values()) == N_BUILD


@pytest.mark.parametrize("name", sorted(TABLE))
def test_config_builds_or_is_refused(name):
    cfg = Config.fromfile(f"configs/{name}")
    want = TABLE[name]
    if want[0] == FULL:
        with pytest.raises((KeyError, AttributeError, TypeError)):
            toy(cfg.model)
        model_cfg, want = copy.deepcopy(dict(cfg.model)), want[1:]
    else:
        model_cfg = toy(cfg.model)
    args = (model_cfg, cfg.get("train_cfg"), cfg.get("test_cfg"))
    if want == BUILDS:
        assert isinstance(build_detector(*args, device="cpu"), nn.Module)
        return
    kind, message = want
    with pytest.raises(kind) as err:
        build_detector(*args, device="cpu")
    assert err.type is kind
    assert str(err.value.args[0]).startswith(message), err.value.args[0]

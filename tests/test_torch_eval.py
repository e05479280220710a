"""The port's AP calculator (yolodl_torch/loss/average_precision.py) and
dataset evaluator (yolodl_torch/train/evaluation.py) against the
reference's.  The calculator must give the reference's numbers exactly on
the golden fixtures of test_ap_golden.py and on random detections.  The
evaluators run yolov4-tiny at 64² with the same weights on a CSV dataset at
mixed original sizes; every AP and AR of their reports must agree within
1e-6 absolute (f32 forwards that sum in another order)."""

import numpy as np
import pytest
import torch

from _torch_parity import REPO, coco_names, randomize_bn, rows_from_detections, write_csv_dataset
from test_ap_golden import DET_1, DET_2, GT_1, GT_2, parse_det, parse_gt
from yolodl_tpu.data import CsvDataset as JCsv
from yolodl_tpu.data import SanitizedDataset as JSanitized
from yolodl_tpu.data import make_decode_loader as j_loader
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.loss import average_precision as j_ap
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.train.evaluation import DatasetEvaluator as JEvaluator
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.data.cache import make_decode_loader as t_loader
from yolodl_torch.data.datasets import CsvDataset as TCsv
from yolodl_torch.data.datasets import SanitizedDataset as TSanitized
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.loss import average_precision as t_ap
from yolodl_torch.loss.inference import to_host_detections
from yolodl_torch.models import YoloModel
from yolodl_torch.train.evaluation import DatasetEvaluator as TEvaluator

torch.set_num_threads(2)
SIZE = 64
TOL = 1e-6


def objects(mod, dets, gts, image_id=0):
    return ([mod.Detection(image_id, d[6], d[5], (d[1], d[0], d[3], d[2])) for d in dets],
            [mod.GroundTruth(image_id, g[0], (g[2], g[1], g[4], g[3])) for g in gts])


def random_objects(mod, seed):
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for img in range(6):
        for _ in range(rng.integers(0, 8)):
            t, l = rng.uniform(0, 300, 2)
            h, w = rng.uniform(4, 200, 2)
            gts.append(mod.GroundTruth(img, int(rng.integers(5)), (t, l, t + h, l + w),
                                       area=float(h * w) if rng.random() < 0.5 else -1.0))
            for _ in range(rng.integers(0, 3)):  # near-duplicates of the box
                jt, jl, jh, jw = rng.normal(0, 8, 4)
                dets.append(mod.Detection(img, int(rng.integers(5)), float(rng.random()),
                                          (t + jt, l + jl, t + h + jh, l + w + jw)))
        for _ in range(rng.integers(0, 4)):  # false positives
            t, l = rng.uniform(0, 300, 2)
            dets.append(mod.Detection(img, int(rng.integers(5)), float(rng.random()),
                                      (t, l, t + 30, l + 40)))
    return dets, gts


def reports(mod, dets, gts, num_classes=None):
    return {
        "ap50": mod.average_precision(dets, gts, num_classes=num_classes),
        "ap75": mod.average_precision(dets, gts, iou_threshold=0.75),
        "coco_map": mod.coco_map_50_95(dets, gts, num_classes=num_classes),
        "summary": mod.coco_summary(dets, gts),
        "thresholds": mod.ap_at_thresholds(dets, gts, [0.3, 0.5, 0.9], num_points=11),
    }


@pytest.mark.parametrize("fixture", [(DET_1, GT_1), (DET_2, GT_2)], ids=["golden1", "golden2"])
def test_average_precision_golden(fixture):
    det_text, gt_text = fixture
    dets, gts = parse_det(det_text), parse_gt(gt_text)
    assert reports(t_ap, *objects(t_ap, dets, gts)) == reports(j_ap, *objects(j_ap, dets, gts))


@pytest.mark.parametrize("seed", range(4))
def test_average_precision_random(seed):
    port = reports(t_ap, *random_objects(t_ap, seed), num_classes=5)
    ref = reports(j_ap, *random_objects(j_ap, seed), num_classes=5)
    assert port == ref
    assert 0 < ref["ap50"]["mAP"] < 1


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """yolov4-tiny with the same random weights in both packages, and a
    12-image CSV dataset whose ground truth is partly the port's own
    detections (so that AP is neither 0 nor 1)."""
    root = str(tmp_path_factory.mktemp("eval"))
    path = f"{REPO}/cfg/darknet/yolov4-tiny.cfg"
    jm = JYoloModel(j_load(path), spd_stem="off")
    tm = YoloModel(t_load(path), device="cpu")
    # the port's seeded init, BN randomized, carried into both packages
    params, state = randomize_bn(*params_to_jax(tm.state_dict()), 0)
    params_from_jax(params, state, model=tm)
    images = write_csv_dataset(root, 12, seed=1)
    probe = TEvaluator(tm, [], None, num_classes=80, confidence_threshold=0.2)
    dets = []
    for start in range(0, len(images), 4):
        batch = [t_loader((SIZE, SIZE)).load(r).image
                 for r in csv_records(TCsv, TSanitized, root)[start:start + 4]]
        dets += to_host_detections(probe.infer(np.stack(batch)))
    write_csv_dataset(root, 12, seed=1, rows=rows_from_detections(images, dets, SIZE, seed=2))
    return root, jm, params, state, tm


def csv_records(csv, sanitized, root):
    ds = csv(f"{root}/images", f"{root}/label.csv", f"{root}/classes.txt")
    return sanitized(ds, out_of_bound_tolerance=1.0).records()


def flat_numbers(report, prefix=""):
    out = {}
    for k, v in report.items():
        if isinstance(v, dict):
            out.update(flat_numbers(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_dataset_evaluator_matches_reference(workspace, monkeypatch):
    """Batch 5 over 12 images: the last batch is padded."""
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    root, jm, params, state, tm = workspace
    assert len(coco_names()) == 80
    kw = dict(num_classes=80, batch_size=5, iou_threshold=0.45,
              confidence_threshold=0.005, nms_kind="greedy", extended=True)
    ref = JEvaluator(jm, csv_records(JCsv, JSanitized, root), j_loader((SIZE, SIZE)), **kw)(
        params, state)
    port = TEvaluator(tm, csv_records(TCsv, TSanitized, root), t_loader((SIZE, SIZE)), **kw)()
    for key in ("images", "detections", "ground_truths"):
        assert port[key] == ref[key], key
    assert ref["ground_truths"] > 12 and ref["detections"] > 100
    # mAP@0.5 averages over all 80 classes; the classes of the kept
    # detections score, the unmatched boxes' do not
    assert 0 < ref["mAP@0.5"] < 1.0
    assert sum(ap > 0.5 for ap in ref["per_class"].values()) >= 3
    ref_n, port_n = flat_numbers(ref), flat_numbers(port)
    assert sorted(port_n) == sorted(ref_n)
    for k in ref_n:
        assert abs(port_n[k] - ref_n[k]) <= TOL, (k, port_n[k], ref_n[k])


def test_evaluator_refuses_several_devices(workspace):
    """Several replicas are ported (ROADMAP A14a;
    test_torch_multi_device_infer.py): devices that do not divide the batch
    are refused, as in the reference (evaluation.py:66-70)."""
    tm = workspace[4]
    with pytest.raises(ValueError, match="eval batch_size 4 not divisible by devices 3"):
        TEvaluator(tm, [], None, num_classes=80, batch_size=4, devices=3)

"""The port's detect and eval CLIs on a NEWSLAB model, against the
reference's, in-process: the small graph of every NEWSLAB kind
(``_torch_parity.small_newslab_spec``: DarkCsp2D, SppCsp2D, DeconvBn2D,
pads, pools, sum, concat) at 16², from one checkpoint the reference wrote
with seeded weights, over a CSV set of 8 images at mixed original sizes.
``cfg/detect.json5``'s own model runs through ``detect_main`` on the card
(``chip_smoke.py`` phase ``train_main``); its forward is held to the
reference in ``test_torch_newslab_models2.py``.

Tolerances as in ``test_torch_cli.py``: detections matched per image and
class in score order, boxes within 1e-3 px of the 16² frame, scores within
1e-5; every number of the eval line within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import seeded_trees, small_newslab_spec, write_csv_dataset
from yolodl_tpu.cli import detect_main as j_detect
from yolodl_tpu.cli import eval_main as j_eval
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.loss import inference as j_inference
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.train import checkpoint as j_ckpt
from yolodl_torch.cli import detect_main, eval_main
from yolodl_torch.loss import inference as t_inference

torch.set_num_threads(2)
SIZE, N_IMAGES = 16, 8


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("newslab_cli"))
    spec = small_newslab_spec()
    with open(os.path.join(root, "model.json5"), "w") as f:
        json.dump(spec, f)
    jm = JYoloModel(JGraph.from_model(j_cfg.parse_model_dict(spec)), spd_stem="off")
    params, state = seeded_trees(jm.init, 41)
    ckpt = j_ckpt.save_checkpoint(os.path.join(root, "ckpt"), 5, 0.25, params, state)
    rng = np.random.default_rng(5)
    rows = {i: [(int(rng.integers(2)), 10.0, 12.0, 8.0, 9.0)] for i in range(N_IMAGES)}
    write_csv_dataset(root, N_IMAGES, seed=6, rows=rows)
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("person\nbicycle\n")

    def config(out, name):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            json.dump({"version": "0.1.0",
                       "model": {"cfg_file": "model.json5", "minibatch_size": 3},
                       "input": {"kind": {"type": "Csv", "image_size": SIZE,
                                          "image_dir": "images", "label_file": "label.csv",
                                          "classes_file": "classes.txt"}},
                       "preprocess": {"out_of_bound_tolerance": 1.0},
                       "output": {"output_dir": os.path.join(root, out),
                                  "nms_iou_thresh": 0.45, "nms_conf_thresh": 0.02}}, f)
        return path

    return root, config, ckpt


def captured(monkeypatch, module):
    seen = []
    real = module.to_host_detections

    def spy(out):
        seen.append(real(out))
        return seen[-1]

    monkeypatch.setattr(module, "to_host_detections", spy)
    return seen


def by_image_and_class(batches):
    out = {}
    for b, batch in enumerate(batches):
        for i, dets in enumerate(batch):
            for d in dets:
                out.setdefault((b, i, d["class"]), []).append(
                    (d["confidence"], np.asarray(d["tlbr"]) * SIZE))
    return {k: sorted(v, key=lambda e: -e[0]) for k, v in out.items()}


def test_newslab_detect_matches_reference(workspace, monkeypatch, capsys):
    root, config, ckpt = workspace
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    ref_seen = captured(monkeypatch, j_inference)
    port_seen = captured(monkeypatch, t_inference)
    j_detect.main(["--config-file", config("out_ref", "ref.json5"), "--checkpoint", ckpt])
    detect_main.main(["--config-file", config("out", "port.json5"), "--checkpoint", ckpt,
                      "--device", "cpu"])
    assert f"wrote {N_IMAGES} images" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(root, "out"))) == \
        sorted(os.listdir(os.path.join(root, "out_ref")))
    ref, port = by_image_and_class(ref_seen), by_image_and_class(port_seen)
    assert len(port_seen) == len(ref_seen) == 3
    assert sorted(port) == sorted(ref) and sum(len(v) for v in ref.values()) > N_IMAGES
    for key in ref:
        assert len(port[key]) == len(ref[key]), key
        for (ps, pb), (rs, rb) in zip(port[key], ref[key]):
            assert abs(ps - rs) <= 1e-5, key
            assert np.abs(pb - rb).max() <= 1e-3, key


def test_newslab_eval_matches_reference(workspace, monkeypatch, capsys):
    _, config, ckpt = workspace
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    path = config("out_eval", "eval.json5")
    ref = j_eval.main(["--config-file", path, "--checkpoint", ckpt, "--per-class"])
    capsys.readouterr()
    port = eval_main.main(["--config-file", path, "--checkpoint", ckpt, "--per-class",
                           "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == port
    assert port["images"] == ref["images"] == N_IMAGES
    assert port["ground_truths"] == ref["ground_truths"] == N_IMAGES
    assert port["detections"] == ref["detections"] > 0
    for k in ("mAP@0.5", "mAP@0.5:0.95"):
        assert abs(port[k] - ref[k]) <= 1e-6
    assert port["AP@0.5_per_class"].keys() == ref["AP@0.5_per_class"].keys()
    for k, v in ref["AP@0.5_per_class"].items():
        assert abs(port["AP@0.5_per_class"][k] - v) <= 1e-6

"""``detect_main --artifact`` in yolodl_torch, in-process on the CPU: an
artifact exported by ``tool_main export`` from the workspace's ``.weights``
gives the live detect's detections and COCO JSON exactly (the same f32
program), a serving artifact (uint8 NHWC, batch 2) gives the live model's on
the rounded pixels, and the reference's rejections hold.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import run_main, write_csv_dataset
from test_torch_cli import CFG, write_config
from yolodl_torch.bridge import params_to_jax
from yolodl_torch.cli import detect_main, tool_main
from yolodl_torch.config import darknet_cfg as dk
from yolodl_torch.config.app_config import DetectAppConfig
from yolodl_torch.data.cache import make_decode_loader
from yolodl_torch.data.datasets import SanitizedDataset
from yolodl_torch.loss import inference as t_inference
from yolodl_torch.loss import non_max_suppression, yolo_inference
from yolodl_torch.models import zoo
from yolodl_torch.models.weights import save_darknet_weights

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(root, config, weights, plain artifact, serving artifact, model)."""
    root = str(tmp_path_factory.mktemp("cli_artifact"))
    cfg = os.path.join(root, "tiny2.cfg")
    with open(cfg, "w") as f:
        f.write(CFG)
    model = zoo.load_darknet_model(cfg, device="cpu", seed=3)
    weights = os.path.join(root, "tiny2.weights")
    save_darknet_weights(dk.Darknet.load(cfg), *params_to_jax(model.state_dict()), weights)
    write_csv_dataset(root, 6, seed=2)
    arts = {}
    for name, extra in (("plain", ["--batch", "4"]), ("serving", ["--batch", "2", "--serving"])):
        arts[name] = os.path.join(root, name)
        with contextlib.redirect_stdout(io.StringIO()):
            tool_main.main(["export", cfg, arts[name], "--weights", weights, "--size", "64",
                            "--device", "cpu", *extra])
    return root, write_config(root), weights, arts["plain"], arts["serving"], model


def detect(monkeypatch, config, out_json, *args):
    """(batches of host detections, stdout lines, the COCO JSON)."""
    seen = []
    real = t_inference.to_host_detections
    monkeypatch.setattr(t_inference, "to_host_detections",
                        lambda out: seen.append(real(out)) or seen[-1])
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        run_main(detect_main, config, "--device", "cpu", "--save-json", out_json, *args)
    monkeypatch.setattr(t_inference, "to_host_detections", real)
    with open(out_json) as f:
        return seen, stdout.getvalue().splitlines(), json.load(f)


def test_artifact_detect_equals_live_detect(workspace, tmp_path, monkeypatch):
    root, config, weights, plain, _, _ = workspace
    live, live_lines, live_json = detect(monkeypatch, config, str(tmp_path / "live.json"),
                                         "--weights", weights)
    art, art_lines, art_json = detect(monkeypatch, config, str(tmp_path / "art.json"),
                                      "--artifact", plain)
    assert len(live) == len(art) == 2
    assert art == live
    assert art_json == live_json and len(art_json) > 0
    assert art_lines[-1] == live_lines[-1] == f"wrote 6 images to {os.path.join(root, 'out')}"


def test_serving_artifact_detect(workspace, tmp_path, monkeypatch):
    """A uint8 NHWC artifact of batch 2: the loader's [0,1] floats are
    rounded to pixels, and each batch equals the live model on them."""
    root, config, _, _, serving, model = workspace
    seen, lines, _ = detect(monkeypatch, config, str(tmp_path / "s.json"), "--artifact", serving)
    assert lines[0] == "artifact batch 2 overrides minibatch_size 4"
    assert len(seen) == 3
    cfg = DetectAppConfig.load(config)
    records = SanitizedDataset(cfg.dataset.open(root), out_of_bound_tolerance=1.0).records()
    loader = make_decode_loader((64, 64))
    images = torch.from_numpy(np.stack([loader.load(r).image for r in records[:2]]))
    u8 = torch.round(images * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
    with torch.no_grad():
        pred = model(u8.to(torch.bfloat16) / 255.0, data_format="NHWC")
        direct = t_inference.to_host_detections(yolo_inference(non_max_suppression(
            pred, iou_threshold=cfg.nms_iou_thresh, confidence_threshold=cfg.nms_conf_thresh,
            suppress_by_class=False, class_mode="argmax", kind="diou", beta=0.6),
            pred.num_flats))
    assert seen[0] == direct


@pytest.mark.parametrize("args,message", [
    (["--weights", "w.weights"], "--weights/--checkpoint/--devices do not apply"),
    (["--checkpoint", "c.ckpt"], "--weights/--checkpoint/--devices do not apply"),
    (["--devices", "2"], "--weights/--checkpoint/--devices do not apply"),
    (["--precision", "bf16"], "--precision does not apply"),
])
def test_artifact_rejections(workspace, args, message):
    config, plain = workspace[1], workspace[3]
    with pytest.raises(ValueError, match=message):
        run_main(detect_main, config, "--device", "cpu", "--artifact", plain, *args)


def test_artifact_size_must_match_config(workspace, tmp_path):
    root, config = workspace[0], workspace[1]
    small = str(tmp_path / "small")
    with contextlib.redirect_stdout(io.StringIO()):
        tool_main.main(["export", os.path.join(root, "tiny2.cfg"), small, "--size", "32",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="artifact expects 32px input but the config "
                                         "dataset is 64px"):
        run_main(detect_main, config, "--device", "cpu", "--artifact", small)

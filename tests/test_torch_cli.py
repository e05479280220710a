"""The port's inference CLIs (yolodl_torch/cli/) against the reference's,
called in-process through ``main(argv)`` on one workspace: a small darknet
cfg at 64² (80 classes, two [yolo] heads, DIoU NMS), a ``.weights`` file
written by the reference's saver, and a CSV dataset of 10 images at mixed
original sizes.

Tolerances:
- detections before rounding (what ``to_host_detections`` returns), matched
  per image and class in score order: boxes within 1e-3 px of the 64² frame,
  scores within 1e-5;
- the COCO JSON, which rounds boxes to 0.01 px and scores to 1e-5: within
  one unit of that rounding (0.01 px, 1e-5), since the two forwards sum in
  another order and a value near a rounding edge may round either way;
- the eval line: every number within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import randomize_bn, rows_from_detections, write_csv_dataset
from yolodl_tpu.cli import detect_main as j_detect
from yolodl_tpu.cli import eval_main as j_eval
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.loss import inference as j_inference
from yolodl_tpu.models.weights import save_darknet_weights as j_save_weights
from yolodl_tpu.train import checkpoint as j_ckpt
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.cli import detect_main, eval_main
from yolodl_torch.data.cache import make_decode_loader
from yolodl_torch.data.records import FileRecord
from yolodl_torch.loss import inference as t_inference
from yolodl_torch.models import zoo
from yolodl_torch.train.evaluation import DatasetEvaluator

torch.set_num_threads(2)
SIZE = 64
N_IMAGES = 10

YOLO = """[yolo]
mask = {mask}
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=80
num=6
scale_x_y = 1.05
ignore_thresh = .7
truth_thresh = 1
nms_kind=diounms
beta_nms=0.6
"""

CFG = """[net]
batch=1
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish

[maxpool]
size=2
stride=1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=255
activation=linear

""" + YOLO.format(mask="3,4,5") + """
[route]
layers = -3

[upsample]
stride=2

[route]
layers = -1, 1

[convolutional]
size=1
stride=1
pad=1
filters=255
activation=linear

""" + YOLO.format(mask="0,1,2")

DETECT_JSON5 = """// detect config of the CLI parity tests
{{
  version: '0.1.0',
  model: {{
    kind: 'Darknet',
    cfg_file: 'tiny2.cfg',
    minibatch_size: 4,
    devices: ['cuda(0)',],  /* one device */
  }},
  input: {{
    kind: {{type: 'Csv', image_size: {size}, image_dir: 'images',
            label_file: 'label.csv', classes_file: 'classes.txt',}},
  }},
  preprocess: {{out_of_bound_tolerance: 1.0,}},
  output: {{output_dir: '{out}', nms_iou_thresh: 0.45, nms_conf_thresh: 0.2,}},
}}
"""


def write_config(root, out="out", name="detect.json5"):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(DETECT_JSON5.format(size=SIZE, out=os.path.join(root, out)))
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(root, config path, weights path, reference trees).  The ground
    truth is partly the port's own detections, so AP is neither 0 nor 1."""
    root = str(tmp_path_factory.mktemp("cli"))
    cfg = os.path.join(root, "tiny2.cfg")
    with open(cfg, "w") as f:
        f.write(CFG)
    model = zoo.load_darknet_model(cfg, device="cpu")
    params, state = randomize_bn(*params_to_jax(model.state_dict()), 0)
    weights = os.path.join(root, "tiny2.weights")
    j_save_weights(j_dk.Darknet.load(cfg), params, state, weights)
    params_from_jax(params, state, model=model)
    images = write_csv_dataset(root, N_IMAGES, seed=3)
    probe = DatasetEvaluator(model, [], None, num_classes=80, confidence_threshold=0.2,
                             nms_kind="diou")
    loader = make_decode_loader((SIZE, SIZE))
    decoded = [loader.load(FileRecord(p, h, w, np.zeros((0, 4)), np.zeros(0))).image
               for p, h, w in images]
    dets = t_inference.to_host_detections(probe.infer(np.stack(decoded)))
    rows = rows_from_detections(images, dets, SIZE, seed=4)
    write_csv_dataset(root, N_IMAGES, seed=3, rows=rows)
    return root, write_config(root), weights, (params, state)


def capture_detections(monkeypatch, module):
    """Record every batch that ``module.to_host_detections`` unpacks."""
    seen = []
    real = module.to_host_detections

    def spy(out):
        seen.append(real(out))
        return seen[-1]

    monkeypatch.setattr(module, "to_host_detections", spy)
    return seen


def by_image_and_class(batches):
    """{(image, class): [(score, tlbr px), ...] in score order}."""
    out = {}
    for b, batch in enumerate(batches):
        for i, dets in enumerate(batch):
            for d in dets:
                out.setdefault((b, i, d["class"]), []).append(
                    (d["confidence"], np.asarray(d["tlbr"]) * SIZE))
    return {k: sorted(v, key=lambda e: -e[0]) for k, v in out.items()}


def test_detect_matches_reference(workspace, tmp_path, monkeypatch, capsys):
    root, config, weights, _ = workspace
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    ref_seen = capture_detections(monkeypatch, j_inference)
    port_seen = capture_detections(monkeypatch, t_inference)
    ref_cfg = write_config(root, "out_ref", "detect_ref.json5")
    j_detect.main(["--config-file", ref_cfg, "--weights", weights,
                   "--save-json", str(tmp_path / "ref.json")])
    ref_out = capsys.readouterr().out
    detect_main.main(["--config-file", config, "--weights", weights, "--device", "cpu",
                      "--save-json", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    assert f"wrote {N_IMAGES} images" in port_out
    assert [ln.split(" to ")[0] for ln in port_out.splitlines()] == \
        [ln.split(" to ")[0] for ln in ref_out.splitlines()]
    drawn = sorted(os.listdir(os.path.join(root, "out")))
    assert drawn == sorted(os.listdir(os.path.join(root, "out_ref")))
    assert len(drawn) == N_IMAGES

    assert len(port_seen) == len(ref_seen) == 3  # batches of 4, 4 and 2 (padded)
    ref, port = by_image_and_class(ref_seen), by_image_and_class(port_seen)
    assert sorted(port) == sorted(ref)
    assert sum(len(v) for v in ref.values()) > 2 * N_IMAGES
    for key in ref:
        assert len(port[key]) == len(ref[key]), key
        for (ps, pb), (rs, rb) in zip(port[key], ref[key]):
            assert abs(ps - rs) <= 1e-5, key
            assert np.abs(pb - rb).max() <= 1e-3, key

    with open(tmp_path / "ref.json") as f:
        ref_json = json.load(f)
    with open(tmp_path / "port.json") as f:
        port_json = json.load(f)
    assert len(port_json) == len(ref_json)
    order = lambda d: (d["image_id"], d["category_id"], -d["score"])  # noqa: E731
    for p, r in zip(sorted(port_json, key=order), sorted(ref_json, key=order)):
        assert (p["image_id"], p["file_name"], p["category_id"]) == \
            (r["image_id"], r["file_name"], r["category_id"])
        assert abs(p["score"] - r["score"]) <= 1e-5 + 1e-9
        assert np.abs(np.subtract(p["bbox"], r["bbox"])).max() <= 0.01 + 1e-9


def test_detect_bfloat16(workspace, tmp_path, monkeypatch, capsys):
    """--precision bfloat16 casts the images, as the reference does: the
    model then computes in bf16 and the detections differ a little."""
    root, config, weights, _ = workspace
    casts = []
    real_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        out = real_to(self, *args, **kwargs)
        casts.append(out.dtype)
        return out

    monkeypatch.setattr(torch.Tensor, "to", spy)
    detect_main.main(["--config-file", config, "--weights", weights, "--device", "cpu",
                      "--precision", "bf16", "--limit", "5",
                      "--save-json", str(tmp_path / "bf16.json")])
    monkeypatch.undo()
    assert torch.bfloat16 in casts
    assert "wrote 5 images" in capsys.readouterr().out
    with open(tmp_path / "bf16.json") as f:
        dets = json.load(f)
    assert dets and {d["image_id"] for d in dets} <= set(range(5))


def flat_numbers(report, prefix=""):
    out = {}
    for k, v in report.items():
        if isinstance(v, dict):
            out.update(flat_numbers(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def eval_lines(argv_ref, argv_port, capsys):
    j_eval.main(argv_ref)
    ref = json.loads(capsys.readouterr().out.splitlines()[-1])
    eval_main.main(argv_port + ["--device", "cpu"])
    port = json.loads(capsys.readouterr().out.splitlines()[-1])
    return ref, port


def assert_close_reports(port, ref):
    ref_n, port_n = flat_numbers(ref), flat_numbers(port)
    assert sorted(port_n) == sorted(ref_n)
    for k in ref_n:
        assert abs(port_n[k] - ref_n[k]) <= 1e-6, (k, port_n[k], ref_n[k])


def test_eval_matches_reference(workspace, monkeypatch, capsys):
    _, config, weights, _ = workspace
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    argv = ["--config-file", config, "--weights", weights, "--coco", "--per-class"]
    ref, port = eval_lines(argv, argv, capsys)
    assert_close_reports(port, ref)
    assert ref["images"] == N_IMAGES and 0 < ref["mAP@0.5"] < 1
    assert any(v > 0.5 for v in ref["AP@0.5_per_class"].values())


def test_eval_from_reference_checkpoint_with_ema(workspace, tmp_path, monkeypatch, capsys):
    """A checkpoint the reference wrote, evaluated with --ema: the EMA
    parameters (here the weights with every BN scale halved) load into the
    port as into the reference."""
    _, config, _, (params, state) = workspace
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    ema = {k: {**v, "bn": {**v["bn"], "scale": v["bn"]["scale"] * np.float32(0.5)}}
           if "bn" in v else v for k, v in params.items()}
    path = j_ckpt.save_checkpoint(str(tmp_path), 5, 0.5, params, state, ema_params=ema)
    argv = ["--config-file", config, "--checkpoint", path, "--ema", "--limit", "6"]
    ref, port = eval_lines(argv, argv, capsys)
    assert_close_reports(port, ref)
    assert ref["images"] == 6

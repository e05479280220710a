"""The port's bf16 detect against the reference's bf16 detect, on the CPU.

yolov4-tiny at 64² with the same weights (a ``.weights`` file written by
the reference's saver, BN statistics that keep activations near unit
scale), ten random images at mixed original sizes, ``detect_main
--precision bfloat16`` in both packages.  XLA and PyTorch round bf16 at
other places, so the detections are compared by overlap, not value: each
detection must have a partner of the same image and class on the other side
with IoU ≥ 0.9 (bf16 keeps 8 bits, a box corner moves by well under 1 %),
for at least 90 % of the detections of each side (measured: 94.1 % of 541
both ways; a score within bf16's rounding of the 0.2 threshold may be kept
on one side only, and of 80 nearly equal class logits of random weights
the argmax may differ).  The f32
detect is held to the reference value for value in ``test_torch_cli.py``.
"""

import os

import numpy as np
import torch

from _torch_parity import REPO, randomize_bn, write_csv_dataset
from yolodl_tpu.cli import detect_main as j_detect
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.loss import inference as j_inference
from yolodl_tpu.models.weights import save_darknet_weights as j_save_weights
from yolodl_torch.bridge import params_to_jax
from yolodl_torch.cli import detect_main
from yolodl_torch.loss import inference as t_inference
from yolodl_torch.models import zoo

torch.set_num_threads(2)
SIZE, N_IMAGES = 64, 10
CFG = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")


def detections(monkeypatch, module):
    seen = []
    real = module.to_host_detections

    def spy(out):
        seen.append(real(out))
        return seen[-1]

    monkeypatch.setattr(module, "to_host_detections", spy)
    return seen


def flat(batches):
    """[(image, class, tlbr)] over every batch."""
    out, image = [], 0
    for batch in batches:
        for dets in batch:
            out += [(image, d["class"], np.asarray(d["tlbr"], np.float64)) for d in dets]
            image += 1
    return out


def iou(a, b):
    t, l = max(a[0], b[0]), max(a[1], b[1])
    bot, r = min(a[2], b[2]), min(a[3], b[3])
    inter = max(bot - t, 0.0) * max(r - l, 0.0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def partnered(these, those, thr=0.9):
    """The share of ``these`` with a same-image, same-class box in ``those``
    at IoU ≥ thr."""
    hits = sum(any(i == j and c == k and iou(box, other) >= thr for j, k, other in those)
               for i, c, box in these)
    return hits / max(len(these), 1)


def test_bf16_detect_overlaps_reference(tmp_path, monkeypatch, capsys):
    root = str(tmp_path)
    model = zoo.load_darknet_model(CFG, device="cpu")
    params, state = randomize_bn(*params_to_jax(model.state_dict()), 2)
    weights = os.path.join(root, "tiny.weights")
    j_save_weights(j_dk.Darknet.load(CFG), params, state, weights)
    write_csv_dataset(root, N_IMAGES, seed=7)
    config = os.path.join(root, "detect.json5")
    with open(config, "w") as f:
        f.write(f"""{{version: '0.1.0',
  model: {{kind: 'Darknet', cfg_file: '{CFG}', minibatch_size: 5,}},
  input: {{kind: {{type: 'Csv', image_size: {SIZE}, image_dir: 'images',
                  label_file: 'label.csv', classes_file: 'classes.txt',}}}},
  preprocess: {{out_of_bound_tolerance: 1.0,}},
  output: {{output_dir: '{os.path.join(root, "out")}', nms_iou_thresh: 0.45,
           nms_conf_thresh: 0.2,}},
}}""")
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    ref_seen = detections(monkeypatch, j_inference)
    port_seen = detections(monkeypatch, t_inference)
    j_detect.main(["--config-file", config, "--weights", weights, "--precision", "bf16"])
    detect_main.main(["--config-file", config, "--weights", weights, "--precision", "bf16",
                      "--device", "cpu"])
    assert capsys.readouterr().out.count(f"wrote {N_IMAGES} images") == 2
    ref, port = flat(ref_seen), flat(port_seen)
    assert len(ref) > 2 * N_IMAGES
    assert partnered(port, ref) >= 0.9 and partnered(ref, port) >= 0.9, \
        (len(port), len(ref), partnered(port, ref), partnered(ref, port))

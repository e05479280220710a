"""yolodl_torch.cli.classify_main against yolodl_tpu.cli.classify_main on the
classify workspace of tests/test_cli.py (12 colour-coded 24² PNGs of 3
classes, a two-conv + [avgpool] + [connected] + [softmax] cfg, batch 6):

* the port trains 40 steps (``--device cpu``) and its ``--eval --topk 2``
  restores the checkpoint and prints top-1 > 0.9 and top-2 ≥ top-1, as
  the reference's test asserts of the reference;
* both packages' ``--eval`` on one checkpoint written by the reference's
  classify_main print the same counts, and the reference's ``--eval``
  reads the port's checkpoint (``opt/`` included) and prints the port's
  counts.  Seeded init differs between the packages, so training from
  scratch is not compared;
* an unknown class, too few records for a batch, and no card without
  ``--device cpu`` each end with one ``error:`` line and exit code 1.

The reference decodes with PIL here (``YDL_NO_NATIVE_DECODE=1``), as the
port does.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from yolodl_torch.cli import classify_main as t_main
from yolodl_tpu.cli import classify_main as j_main

torch.set_num_threads(2)

NET = """
[net]
height=24
width=24
channels=3
batch=1

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
activation=leaky

[avgpool]

[connected]
output=3
activation=linear

[softmax]
"""


def workspace(root, rows=None, batch_size=6):
    """The colour-coded set (seed 0) and a classify.json5 whose logs go to
    ``root/logs``; ``rows`` replaces the label file's rows."""
    rng = np.random.default_rng(0)
    img_dir = root / "images"
    img_dir.mkdir()
    names = ["red", "green", "blue"]
    lines = ["image_file,class_name"]
    for i in range(12):
        cls = i % 3
        arr = rng.uniform(0, 60, (24, 24, 3)).astype(np.uint8)
        arr[:, :, cls] = rng.uniform(180, 255, (24, 24)).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"i{i}.png")
        lines.append(f"i{i}.png,{names[cls]}")
    (root / "labels.csv").write_text("\n".join(rows or lines) + "\n")
    (root / "classes.txt").write_text("\n".join(names) + "\n")
    (root / "net.cfg").write_text(NET)
    cfg = {
        "version": "0.1.0",
        "model": {"kind": "Darknet", "cfg_file": "net.cfg"},
        "dataset": {"image_dir": "images", "label_file": "labels.csv",
                    "classes_file": "classes.txt"},
        "logging": {"dir": "logs"},
        "training": {"batch_size": batch_size, "save_checkpoint_steps": 20,
                     "optimizer": {"momentum": 0.9,
                                   "lr_schedule": {"type": "Constant", "lr": 0.005}}},
    }
    (root / "classify.json5").write_text(json.dumps(cfg))
    return str(root / "classify.json5")


def run(main, config, *args, capsys):
    main(["--config-file", config, *args])
    return capsys.readouterr().out


def counts(out):
    """The ``(correct/total)`` of each accuracy line."""
    return [line.split("(")[1] for line in out.splitlines() if "accuracy" in line]


@pytest.fixture()
def pil_decode(monkeypatch):
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")


def test_train_then_eval(tmp_path, capsys, pil_decode):
    config = workspace(tmp_path)
    out = run(t_main.main, config, "--max-steps", "40", "--device", "cpu", capsys=capsys)
    assert "step 40" in out and "acc" in out
    ckpts = glob.glob(str(tmp_path / "logs" / "*" / "checkpoints" / "*.ckpt"))
    assert len(ckpts) == 2  # step 20 (save_checkpoint_steps) and step 40
    with np.load(sorted(ckpts)[-1]) as data:
        assert any(k.startswith("opt/0/0/.mu/layer3/") for k in data.files)

    out = run(t_main.main, config, "--eval", "--topk", "2", "--device", "cpu", capsys=capsys)
    assert "restored checkpoint at step 40" in out
    acc = float(out.split("top-1 accuracy:")[1].split()[0])
    assert acc > 0.9, out
    acc2 = float(out.split("top-2 accuracy:")[1].split()[0])
    assert acc2 >= acc

    # the reference's eval on the port's checkpoint prints the same counts
    ref = run(j_main.main, config, "--eval", "--topk", "2", capsys=capsys)
    assert "restored checkpoint at step 40" in ref
    assert counts(ref) == counts(out) and len(counts(out)) == 2


def test_both_evals_on_a_reference_checkpoint(tmp_path, capsys, pil_decode):
    config = workspace(tmp_path, batch_size=5)  # a padded tail chunk (12 = 5 + 5 + 2)
    run(j_main.main, config, "--max-steps", "4", capsys=capsys)
    for k in (1, 2):
        ref = run(j_main.main, config, "--eval", "--topk", str(k), capsys=capsys)
        out = run(t_main.main, config, "--eval", "--topk", str(k), "--device", "cpu",
                  capsys=capsys)
        assert "restored checkpoint at step 4" in ref and "restored checkpoint at step 4" in out
        assert counts(out) == counts(ref) and len(counts(out)) == k


@pytest.mark.parametrize("case", ["unknown_class", "too_few_records", "no_card"])
def test_errors_are_one_line(tmp_path, capsys, monkeypatch, case):
    rows = None
    if case == "unknown_class":
        rows = ["image_file,class_name", "i0.png,red", "i1.png,purple"]
    elif case == "too_few_records":
        rows = ["image_file,class_name", "i0.png,red", "i1.png,green"]
    config = workspace(tmp_path, rows=rows)
    device = ["--device", "cpu"]
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        device = []
    monkeypatch.setattr("sys.argv", ["yolodl-classify", "--config-file", config,
                                     "--max-steps", "1", *device])
    with pytest.raises(SystemExit) as exc:
        t_main.cli()
    assert exc.value.code == 1
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("error:")]
    assert len(lines) == 1, err
    want = {"unknown_class": "unknown class 'purple'",
            "too_few_records": "dataset has 2 records < batch_size 6",
            "no_card": "no CUDA device"}[case]
    assert want in lines[0]
    assert not os.path.isdir(tmp_path / "logs") or case == "too_few_records"

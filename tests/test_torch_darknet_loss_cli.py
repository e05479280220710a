"""``training.loss.impl Darknet`` through ``yolodl_torch.cli.train_main``
on the CPU, against ``yolodl_tpu.cli.train_main``: a darknet cfg at 64²
(two BN convs, a one-class [yolo] head with ciou and iou_thresh 0.2) on
the tests/test_cli.py-style CSV set.

- Both CLIs start from one reference-written checkpoint (``FromFile``),
  see the same batches and take three steps: the logged
  ``loss/total_loss`` and the darknet telemetry on the benchmark panel
  (``num_matched`` exact, ``avg_iou``, ``no_obj``) within rel 1e-4, as in
  test_torch_train_cli.py (f32 forward and backward in another order).
- Multi-scale (sizes 64 and 96, interval 1): every step trains with head
  params whose ``net_w``/``net_h`` are its batch's size, one step built per
  size.
- The rejections exit with the reference's messages: a NEWSLAB model, a
  cfg without [yolo]/[Gaussian_yolo] heads, and a head option combination
  with no darknet semantics (layer named), and pipeline_parallel, which
  the port too rejects before it starts the ranks (the production loss
  trains the same workspace over two pipeline ranks).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import reference_native  # noqa: F401
from _torch_parity import run_main as run
from _torch_parity import write_darknet_train_workspace, write_train_workspace
from test_torch_train_cli import logged
from yolodl_tpu.cli import train_main as j_train
from yolodl_torch import train as t_train_pkg
from yolodl_torch.cli import train_main as t_train

torch.set_num_threads(2)

TAGS = ("loss/total_loss", "benchmark/num_matched", "benchmark/avg_iou", "benchmark/no_obj")


def test_port_cli_matches_reference_cli_from_one_checkpoint(tmp_path, monkeypatch, capsys,
                                                            reference_native):
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")  # both decode with PIL, jitter natively
    first = write_darknet_train_workspace(tmp_path / "first")
    run(j_train, first, "--max-steps", "1")
    (ckpt,) = glob.glob(str(tmp_path / "first" / "logs" / "*" / "checkpoints" / "*.ckpt"))
    results = {}
    for name, module, extra in (("ref", j_train, ()), ("port", t_train, ("--device", "cpu"))):
        config = write_darknet_train_workspace(
            tmp_path / name, load_checkpoint={"type": "FromFile", "file": ckpt})
        run(module, config, "--max-steps", "4", *extra)
        out = capsys.readouterr().out
        assert "restored checkpoint at step 1" in out
        assert "loss impl: darknet-exact (1 heads;" in out
        results[name] = {tag: logged(str(tmp_path / name / "logs"), tag)[0] for tag in TAGS}
    for tag in TAGS:
        ref, port = results["ref"][tag], results["port"][tag]
        assert [s for s, _ in port] == [s for s, _ in ref] == [2, 3, 4], tag
        if tag == "benchmark/num_matched":
            assert [v for _, v in port] == [v for _, v in ref]
            assert all(v > 0 for _, v in port)
        else:
            np.testing.assert_allclose([v for _, v in port], [v for _, v in ref], rtol=1e-4,
                                       err_msg=tag)


def test_multi_scale_builds_a_step_per_size(tmp_path, monkeypatch):
    built, calls = [], []
    real = t_train_pkg.make_train_step

    def recording(model, optimizer, config, *a, **k):
        net = {(p.net_w, p.net_h) for p in config.darknet_loss[1]}
        built.append(net)
        step = real(model, optimizer, config, *a, **k)

        def wrapped(ts, images, *rest):
            calls.append((int(images.shape[-1]), int(images.shape[-2]), net))
            return step(ts, images, *rest)

        return wrapped

    monkeypatch.setattr(t_train_pkg, "make_train_step", recording)
    config = write_darknet_train_workspace(
        tmp_path, multi_scale={"sizes": [64, 96], "interval": 1})
    run(t_train, config, "--max-steps", "4", "--device", "cpu")
    # the base step (the cfg's 64²) and one per multi-scale size
    assert built == [{(64, 64)}, {(64, 64)}, {(96, 96)}]
    assert [c[0] for c in calls] == [64, 96, 64, 96]
    assert all(net == {(w, h)} for w, h, net in calls)


def rejection(tmp_path, module, config, extra=()):
    with pytest.raises(SystemExit) as exc:
        run(module, config, "--max-steps", "1", *extra)
    return str(exc.value)


REGION_ONLY = """[net]
width=64
height=64
channels=3
[convolutional]
filters=30
size=1
stride=4
activation=linear
[region]
anchors=1,1.5, 2,3, 4,5, 6,7, 8,9
classes=1
num=5
"""
GAUSSIAN_NEW_COORDS = """[net]
width=64
height=64
channels=3
[convolutional]
filters=30
size=1
stride=4
activation=linear
[Gaussian_yolo]
mask=0,1,2
anchors=6,8, 10,14, 18,24
classes=1
num=3
new_coords=1
"""


@pytest.mark.parametrize("case", ["newslab", "region_only", "gaussian_new_coords"])
def test_rejections_match_reference(tmp_path, case):
    messages = []
    for name, module, extra in (("ref", j_train, ()), ("port", t_train, ("--device", "cpu"))):
        root = tmp_path / name
        if case == "newslab":
            config = write_train_workspace(root, loss={"impl": "Darknet"})
        else:
            cfg = REGION_ONLY if case == "region_only" else GAUSSIAN_NEW_COORDS
            config = write_darknet_train_workspace(root, cfg_text=cfg)
        messages.append(rejection(tmp_path, module, config, extra).replace(str(root), "ROOT"))
    assert messages[1] == messages[0]
    assert {"newslab": "needs a darknet model cfg",
            "region_only": "needs [yolo]/[Gaussian_yolo] heads",
            "gaussian_new_coords": "layer 1: [Gaussian_yolo] layer sets new_coords=1",
            }[case] in messages[1]


def test_pipeline_parallel_needs_devices_the_port_lacks(tmp_path, capfd):
    """The darknet loss under pipeline_parallel exits with the reference's
    message before any rank starts; with the production loss the same
    workspace starts its two pipeline ranks and trains."""
    devices = {"type": "MultiDevice", "devices": ["cuda:0", "cuda:1"]}
    ref = write_darknet_train_workspace(tmp_path / "ref", device_config=devices,
                                        pipeline_parallel=2)
    message = rejection(tmp_path, j_train, ref)
    assert "does not support pipeline_parallel" in message
    port = write_darknet_train_workspace(tmp_path / "port", device_config=devices,
                                         pipeline_parallel=2)
    assert rejection(tmp_path, t_train, port, ("--device", "cpu")) == message
    capfd.readouterr()
    production = write_darknet_train_workspace(tmp_path / "production", device_config=devices,
                                               pipeline_parallel=2, loss={"impl": "Production"})
    run(t_train, production, "--max-steps", "1", "--device", "cpu")
    out = capfd.readouterr().out
    assert "dp: starting 2 ranks" in out
    assert "pipeline: 2 stages (" in out and ") x dp=1, 1 microbatches/step" in out

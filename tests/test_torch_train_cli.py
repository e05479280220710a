"""``yolodl_torch.cli.train_main`` against ``yolodl_tpu.cli.train_main``.

Both CLIs run in this process (``--device cpu`` for the port) on the
``tests/test_cli.py``-style workspace: a CSV set of 48² PNGs with a red
square, a three-conv NEWSLAB model at 32², mosaic and colour jitter on,
ordered records.  The reference first trains one step from its own init
and writes a checkpoint with optimizer state; both CLIs then start from
that checkpoint (``FromFile``), see the same batches (the streams are
bit-identical, ``test_torch_pipeline.py``) and take three steps.

Tolerances: the logged ``loss/total_loss`` of each of the three steps
within rel 1e-4 (f32 forward and backward in another order; the Adam
moments restored from the checkpoint keep the updates from amplifying
rounding as a first step would); the two runs' last checkpoints hold the
same entries with the same dtypes and shapes.  The same comparison with
``preprocessor.pipeline.device`` on (the device augmentation, ROADMAP A13)
and the reference's two fallbacks to the CPU pipeline.  Also here: the
multi-scale resize against ``jax.image.resize``, a run with ``loss.impl
Darknet``, and the branches that raise naming their ROADMAP item.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_native  # noqa: F401
from _torch_parity import run_main as run
from _torch_parity import write_darknet_train_workspace
from _torch_parity import write_train_workspace as write_workspace
from yolodl_tpu.cli import train_main as j_train
from yolodl_torch.cli import train_main as t_train

torch.set_num_threads(2)


def logged(logs_dir, tag="loss/total_loss"):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (run_dir,) = glob.glob(os.path.join(logs_dir, "*"))
    acc = EventAccumulator(run_dir, size_guidance={"scalars": 0})
    acc.Reload()
    return [(e.step, e.value) for e in acc.Scalars(tag)], run_dir


def last_checkpoint(run_dir):
    with np.load(sorted(glob.glob(os.path.join(run_dir, "checkpoints", "*.ckpt")))[-1]) as f:
        return {k: (f[k].dtype, f[k].shape) for k in f.files if k != "__meta__"}


def test_port_cli_matches_reference_cli_from_one_checkpoint(tmp_path, monkeypatch, capsys,
                                                            reference_native):
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")  # both decode with PIL, jitter natively
    first = write_workspace(tmp_path / "first")
    run(j_train, first, "--max-steps", "1")
    (ckpt,) = glob.glob(str(tmp_path / "first" / "logs" / "*" / "checkpoints" / "*.ckpt"))
    results = {}
    for name, module, extra in (("ref", j_train, ()), ("port", t_train, ("--device", "cpu"))):
        config = write_workspace(tmp_path / name, load_checkpoint={
            "type": "FromFile", "file": ckpt})
        run(module, config, "--max-steps", "4", *extra)
        assert "restored checkpoint at step 1" in capsys.readouterr().out
        results[name] = logged(str(tmp_path / name / "logs"))
    (ref, ref_dir), (port, port_dir) = results["ref"], results["port"]
    assert [s for s, _ in port] == [s for s, _ in ref] == [2, 3, 4]
    np.testing.assert_allclose([v for _, v in port], [v for _, v in ref], rtol=1e-4)
    assert last_checkpoint(port_dir) == last_checkpoint(ref_dir)
    assert any(k.startswith("opt/0/0/.mu/") for k in last_checkpoint(port_dir))
    assert os.path.exists(os.path.join(port_dir, "train.json5"))


@pytest.mark.parametrize("src,dst", [(32, 24), (32, 13), (24, 40), (17, 32)])
def test_multi_scale_resize_matches_jax_image_resize(src, dst):
    """jax.image.resize "bilinear" antialiases when it shrinks; so does the
    port's F.interpolate(antialias=True).  rtol 1e-5, atol 1e-6."""
    x = np.random.default_rng(src * dst).uniform(0, 1, (2, 3, src, src)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, dst, dst), "bilinear")
    out = t_train.resize_images(torch.from_numpy(x), dst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("training,item", [
    # MultiDevice trains data-parallel since A14a (test_torch_dp_cli.py), with
    # ZeRO-1 or tensor parallelism since A14b (test_torch_tp_cli.py) and
    # pipeline-parallel since A14c (test_torch_pp_cli.py); MultiProcess keeps
    # the reference's config errors for these three
    ({"device_config": {"type": "MultiProcess"}, "pipeline_parallel": 2},
     "pipeline_parallel is single-controller only"),
    ({"device_config": {"type": "MultiProcess"}, "zero_optimizer": True},
     "zero_optimizer is single-controller only"),
    ({"device_config": {"type": "MultiProcess"}, "tensor_parallel": 2},
     "tensor_parallel is single-controller only"),
])
def test_unported_branches_name_their_item(tmp_path, training, item):
    config = write_workspace(tmp_path, **training)
    with pytest.raises((NotImplementedError, SystemExit, ValueError), match=item):
        run(t_train, config, "--max-steps", "1", "--device", "cpu")


def test_darknet_loss_trains_and_logs_telemetry(tmp_path, capsys):
    """training.loss.impl Darknet on a darknet cfg: the run trains, prints
    the loss impl line and logs darknet's telemetry on the benchmark panel.
    (Its parity with the reference CLI: test_torch_darknet_loss_cli.py.)"""
    config = write_darknet_train_workspace(tmp_path)
    run(t_train, config, "--max-steps", "2", "--device", "cpu")
    assert "loss impl: darknet-exact (1 heads;" in capsys.readouterr().out
    for tag in ("loss/total_loss", "loss/iou_loss", "benchmark/num_matched",
                "benchmark/avg_iou", "benchmark/recall50", "benchmark/no_obj"):
        values = [v for _, v in logged(str(tmp_path / "logs"), tag)[0]]
        assert len(values) == 2 and np.all(np.isfinite(values)), tag


def device_augmentation_workspace(root, device, **training):
    """The workspace with a rotating affine beside its mosaic and jitter,
    and ``preprocessor.pipeline.device`` set."""
    config = write_workspace(root, **training)
    raw = json.loads(open(config).read())
    raw["preprocessor"]["pipeline"] = {"device": device}
    raw["preprocessor"]["random_affine"] = {
        "affine_prob": 0.8, "rotate_prob": 0.5, "rotate_degrees": 10.0,
        "translation_prob": 0.5, "translation": 0.1, "scale_prob": 0.5,
        "scale": [0.9, 1.1], "horizontal_flip_prob": 0.5}
    with open(config, "w") as f:
        json.dump(raw, f)
    return config


def test_device_augmentation_names_a13(tmp_path, monkeypatch, capsys):
    """ROADMAP A13, device augmentation: the reference CLI with
    ``pipeline.device "tpu"`` and the port's with ``"cuda"`` (on the CPU:
    ``--device cpu``) train through their device augmentation from one
    checkpoint, on a rotating affine (the two-pass warp) with mosaic and
    jitter; their three logged losses agree within rel 1e-4, and neither
    falls back to the CPU pipeline."""
    from yolodl_torch.data import device_augment

    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")  # both decode with PIL
    first = write_workspace(tmp_path / "first")
    run(j_train, first, "--max-steps", "1")
    (ckpt,) = glob.glob(str(tmp_path / "first" / "logs" / "*" / "checkpoints" / "*.ckpt"))
    capsys.readouterr()
    calls = []
    real = device_augment.apply_device_augmentation

    def counting(*args, **kwargs):
        calls.append(args[2] if len(args) > 2 else kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(device_augment, "apply_device_augmentation", counting)
    results = {}
    for name, module, device, extra in (("ref", j_train, "tpu", ()),
                                        ("port", t_train, "cuda", ("--device", "cpu"))):
        config = device_augmentation_workspace(tmp_path / name, device, load_checkpoint={
            "type": "FromFile", "file": ckpt})
        run(module, config, "--max-steps", "4", *extra)
        said = capsys.readouterr()
        assert "restored checkpoint at step 1" in said.out
        assert "warning" not in said.err, said.err
        results[name] = logged(str(tmp_path / name / "logs"))[0]
    assert [str(d) for d in calls] == ["cpu"]
    assert [s for s, _ in results["port"]] == [s for s, _ in results["ref"]] == [2, 3, 4]
    np.testing.assert_allclose([v for _, v in results["port"]],
                               [v for _, v in results["ref"]], rtol=1e-4)


@pytest.mark.parametrize("change,warning", [
    ({"training": {"steps_per_call": 2}}, "requires single-process, non-scanned training"),
    ({"logging": {"enable_images": True}}, "logging.enable_images needs host-side pipeline"),
])
def test_device_augmentation_falls_back_with_the_reference_warning(
        tmp_path, monkeypatch, capsys, change, warning):
    """As the reference's tests/test_cli.py: a multi-step call and the
    pipeline's debug images keep the CPU pipeline, with a warning, and
    train."""
    from yolodl_torch.data import device_augment

    config = device_augmentation_workspace(tmp_path, "cuda")
    raw = json.loads(open(config).read())
    for section, entries in change.items():
        raw[section].update(entries)
    with open(config, "w") as f:
        json.dump(raw, f)
    monkeypatch.setattr(device_augment, "apply_device_augmentation", None)  # never reached
    run(t_train, config, "--max-steps", "2", "--device", "cpu")
    assert warning in capsys.readouterr().err
    values = [v for _, v in logged(str(tmp_path / "logs"))[0]]
    assert len(values) == 2 and np.all(np.isfinite(values))

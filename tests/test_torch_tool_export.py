"""``tool_main export`` in both packages on yolov4-tiny at 64² from the same
``.weights`` file: the port's artifact (a ``torch.export`` program, CPU)
against the reference's StableHLO artifact on the same images (atol 1e-5,
as tests/test_export.py), with the same ``meta.json`` fields; then the
port's ``--checkpoint`` and ``--serving`` exports and its rejections.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from _torch_parity import REPO, seeded_trees
from yolodl_tpu.cli import tool_main as j_tool
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.models.export import load_exported as j_load_exported
from yolodl_tpu.models.weights import save_darknet_weights as j_save
from yolodl_torch.bridge import params_to_jax
from yolodl_torch.cli import tool_main as t_tool
from yolodl_torch.models import zoo
from yolodl_torch.models.export import load_exported
from yolodl_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(2)

TINY = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")
FIELDS = ("cycxhw", "obj_logit", "class_logit")


def run(main, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(argv))
    return out.getvalue()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    d = j_dk.Darknet.load(TINY)
    params, state = seeded_trees(JYoloModel(j_graph(d), spd_stem="off").init, 4)
    path = root / "tiny.weights"
    j_save(d, params, state, path)
    return root, str(path)


def test_export_matches_reference_artifact(weights):
    root, path = weights
    port_dir, ref_dir = str(root / "port"), str(root / "ref")
    printed = run(t_tool.main, "export", TINY, port_dir, "--weights", path, "--batch", "2",
                  "--size", "64", "--device", "cpu")
    assert printed == f"wrote {port_dir}/model.pt2 + meta.json (batch 2, 64x64, float32, cpu)\n"
    run(j_tool.main, "export", TINY, ref_dir, "--weights", path, "--batch", "2", "--size", "64")
    infer, meta = load_exported(port_dir, device="cpu")
    j_infer, j_meta = j_load_exported(ref_dir)
    assert {k: v for k, v in meta.items() if k not in ("device", "torch_version")} == j_meta
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        ours = infer(torch.from_numpy(x))
    theirs = j_infer(x)
    for f in FIELDS:
        r = np.asarray(getattr(theirs, f))
        assert np.abs(r).max() > 0.05
        np.testing.assert_allclose(getattr(ours, f).numpy(), r, atol=1e-5)


def test_export_from_checkpoint_and_serving(weights):
    """``--checkpoint`` overlays the seeded init (no ``--weights``); the
    serving artifact runs the live model's bf16/255 ingest bit for bit."""
    root, path = weights
    model = zoo.load_darknet_model(TINY, path, device="cpu")
    ckpt = save_checkpoint(str(root / "ckpt"), 3, 0.5, *params_to_jax(model.state_dict()))
    out = str(root / "serving")
    printed = run(t_tool.main, "export", TINY, out, "--checkpoint", ckpt, "--batch", "2",
                  "--size", "64", "--serving", "--device", "cpu")
    assert printed.endswith("(batch 2, 64x64, serving u8-NHWC, cpu)\n")
    infer, meta = load_exported(out, device="cpu")
    assert meta["serving"] and meta["input_shape"] == [2, 64, 64, 3]
    u8 = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                                            dtype=np.uint8))
    with torch.no_grad():
        art = infer(u8)
        live = model(u8.to(torch.bfloat16) / 255.0, data_format="NHWC")
    for f in FIELDS:
        assert torch.equal(getattr(art, f), getattr(live, f)), f


def test_export_rejections(tmp_path, monkeypatch):
    newslab = os.path.join(REPO, "cfg", "model", "yolov4-csp-custom-64x64-2021-08-21.json5")
    with pytest.raises(SystemExit, match="--size is required"):
        t_tool.main(["export", newslab, str(tmp_path / "a"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tool.main(["export", TINY, str(tmp_path / "b")])
    assert not os.path.exists(tmp_path / "a") and not os.path.exists(tmp_path / "b")

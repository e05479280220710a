"""yolodl_torch's tool_main against yolodl_tpu's on the same files, both
called in-process: ``info`` (with ``--pipeline-stages``), ``make-dot-file``,
``anchors`` and ``fold-weights`` must print the same lines and write the
same files (``.weights`` byte for byte).  ``export`` is in
tests/test_torch_tool_export.py.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from _torch_parity import REPO, seeded_trees, write_csv_dataset
from yolodl_tpu.cli import tool_main as j_tool
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.models.weights import save_darknet_weights as j_save
from yolodl_torch.cli import tool_main as t_tool

torch.set_num_threads(2)

TINY = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")
NEWSLAB = os.path.join(REPO, "cfg", "model", "yolov4-csp-custom-64x64-2021-08-21.json5")


def run(main, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(argv))
    return out.getvalue()


@pytest.mark.parametrize("model,stages", [
    (TINY, 0), (TINY, 1), (TINY, 3), (NEWSLAB, 0),
    (os.path.join(REPO, "cfg", "darknet", "yolov2.cfg"), 2),
    (os.path.join(REPO, "cfg", "darknet", "darknet19.cfg"), 0),
])
def test_info_matches_reference(model, stages):
    args = ["info", model] + (["--pipeline-stages", str(stages)] if stages else [])
    ours = run(t_tool.main, *args)
    assert ours == run(j_tool.main, *args)
    assert ("pipeline plan" in ours) == bool(stages)


def test_info_rejects_negative_stages():
    with pytest.raises(ValueError, match="--pipeline-stages must be >= 1"):
        run(t_tool.main, "info", TINY, "--pipeline-stages", "-1")


@pytest.mark.parametrize("model", [TINY, NEWSLAB])
def test_dot_file_matches_reference(model, tmp_path):
    ours = run(t_tool.main, "make-dot-file", model, str(tmp_path / "port.dot"))
    theirs = run(j_tool.main, "make-dot-file", model, str(tmp_path / "ref.dot"))
    assert ours == f"wrote {tmp_path / 'port.dot'}\n"
    assert theirs == f"wrote {tmp_path / 'ref.dot'}\n"
    assert (tmp_path / "port.dot").read_text() == (tmp_path / "ref.dot").read_text()


def test_anchors_match_reference(tmp_path):
    rng = np.random.default_rng(6)
    rows = {i: [(int(rng.integers(80)), 40.0 + i, 50.0, float(rng.uniform(5, 60)),
                 float(rng.uniform(5, 60))) for _ in range(int(rng.integers(1, 5)))]
            for i in range(8)}
    write_csv_dataset(str(tmp_path), 8, seed=6, rows=rows)
    config = tmp_path / "train.json5"
    config.write_text("""// anchors over a CSV set
{
  dataset: {kind: {type: 'Csv', image_size: 64, image_dir: 'images',
                   label_file: 'label.csv', classes_file: 'classes.txt',},},
}
""")
    for num in ("3", "50"):
        args = ["anchors", "--config-file", str(config), "--num", num]
        ours = run(t_tool.main, *args)
        assert ours == run(j_tool.main, *args)
        assert "mean best-IoU fitness" in ours


def test_fold_weights_matches_reference(tmp_path):
    d = j_dk.Darknet.load(TINY)
    params, state = seeded_trees(JYoloModel(j_graph(d), spd_stem="off").init, 9)
    src_c, src_w = tmp_path / "tiny.cfg", tmp_path / "tiny.weights"
    src_c.write_text(j_dk.to_cfg_string(d))
    j_save(d, params, state, src_w)
    outs = {}
    for name, main in (("port", t_tool.main), ("ref", j_tool.main)):
        out_c, out_w = tmp_path / f"out_{name}.cfg", tmp_path / f"out_{name}.weights"
        printed = run(main, "fold-weights", str(src_c), str(src_w), "--out-cfg", str(out_c),
                      "--out-weights", str(out_w))
        outs[name] = (printed.replace(f"out_{name}", "out"), out_c.read_text(),
                      out_w.read_bytes())
    assert outs["port"] == outs["ref"]
    assert outs["port"][0].startswith("folded 19 conv BN layer(s)\n")
    # the default output names
    printed = run(t_tool.main, "fold-weights", str(src_c), str(src_w))
    assert (tmp_path / "tiny-folded.cfg").exists() and (tmp_path / "tiny-folded.weights").exists()
    assert f"wrote {tmp_path / 'tiny-folded.weights'}" in printed

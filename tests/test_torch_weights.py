"""The port's darknet ``.weights`` reader/writer (yolodl_torch/models/
weights.py, models/zoo.py) and checkpoints (yolodl_torch/train/
checkpoint.py) against the reference's: files written by either package
load into the other with identical arrays, and the port writes the same
bytes."""

import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import REPO, randomize_bn
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.models import weights as j_w
from yolodl_tpu.train import checkpoint as j_ckpt
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.models import weights as t_w
from yolodl_torch.models import zoo
from yolodl_torch.train import checkpoint as t_ckpt
from yolodl_torch.train.ema import ema_init

torch.set_num_threads(2)
CFGS = ["yolov4-tiny", "yolov4-tiny-3l"]


def cfg_path(name):
    return os.path.join(REPO, "cfg", "darknet", f"{name}.cfg")


def reference_trees(name, seed=0):
    """Numpy (params, state) of a JAX-initialised model, BN randomized."""
    jm = JYoloModel(j_load(cfg_path(name)), spd_stem="off")
    return randomize_bn(*jm.init(jax.random.PRNGKey(seed)), seed)


def assert_state_dict_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu()), k


def assert_trees_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CFGS)
def test_reference_weights_file_loads_into_port(name, tmp_path):
    params, state = reference_trees(name)
    path = tmp_path / "ref.weights"
    j_w.save_darknet_weights(j_dk.Darknet.load(cfg_path(name)), params, state, path, seen=1234)
    model = zoo.load_darknet_model(cfg_path(name), str(path), device="cpu")
    assert_state_dict_equal(model.state_dict(), params_from_jax(params, state))
    # the port's saver writes the file the reference wrote, byte for byte,
    # from the model and from the reference's own trees
    darknet = t_dk.Darknet.load(cfg_path(name))
    t_w.save_darknet_weights(darknet, *params_to_jax(model.state_dict()),
                             tmp_path / "port.weights", seen=1234)
    t_w.save_darknet_weights(darknet, params, state, tmp_path / "port2.weights", seen=1234)
    ref_bytes = path.read_bytes()
    assert (tmp_path / "port.weights").read_bytes() == ref_bytes
    assert (tmp_path / "port2.weights").read_bytes() == ref_bytes
    # and the readers agree on every array and on `seen`
    jp, js, jseen = j_w.load_darknet_weights(j_dk.Darknet.load(cfg_path(name)), path)
    tp, ts, tseen = t_w.load_darknet_weights(darknet, path)
    assert jseen == tseen == 1234
    assert_trees_equal(tp, jp)
    assert_trees_equal(ts, js)


def test_port_weights_round_trip_and_seed(tmp_path):
    model = zoo.load_darknet_model(cfg_path("yolov4-tiny"), device="cpu", seed=3)
    again = zoo.load_darknet_model(cfg_path("yolov4-tiny"), device="cpu", seed=3)
    other = zoo.load_darknet_model(cfg_path("yolov4-tiny"), device="cpu", seed=4)
    assert_state_dict_equal(model.state_dict(), again.state_dict())
    assert not torch.equal(model.state_dict()["layers.layer0.w"], other.state_dict()["layers.layer0.w"])
    darknet = t_dk.Darknet.load(cfg_path("yolov4-tiny"))
    t_w.save_darknet_weights(darknet, *params_to_jax(model.state_dict()), tmp_path / "w.weights")
    loaded = zoo.load_darknet_model(cfg_path("yolov4-tiny"), str(tmp_path / "w.weights"),
                                    device="cpu", seed=4)
    assert_state_dict_equal(loaded.state_dict(), model.state_dict())
    # a truncated file is a cfg/weights mismatch in both readers
    (tmp_path / "short.weights").write_bytes((tmp_path / "w.weights").read_bytes()[:-40])
    with pytest.raises(ValueError):
        j_w.load_darknet_weights(j_dk.Darknet.load(cfg_path("yolov4-tiny")), tmp_path / "short.weights")
    with pytest.raises(ValueError):
        t_w.load_darknet_weights(darknet, tmp_path / "short.weights")


def test_merge_into_model_tree_partial_overlay():
    """Layers absent from the loaded trees keep their init; extra layers
    are dropped; a shape mismatch raises — as in the reference."""
    params, state = reference_trees("yolov4-tiny", seed=1)
    init_p, init_s = reference_trees("yolov4-tiny", seed=2)
    last = max(params, key=lambda k: int(k[len("layer"):]))
    loaded_p = {k: params[k] for k in ("layer0", "layer2", last)}
    loaded_p["layer999"] = params["layer0"]
    loaded_s = {k: state[k] for k in ("layer0", "layer2")}
    jp, js = j_w.merge_into_model_tree(loaded_p, loaded_s, init_p, init_s)
    tp, ts = t_w.merge_into_model_tree(loaded_p, loaded_s, init_p, init_s)
    assert_trees_equal(tp, jax.tree_util.tree_map(np.asarray, jp))
    assert_trees_equal(ts, jax.tree_util.tree_map(np.asarray, js))
    np.testing.assert_array_equal(tp["layer0"]["w"], params["layer0"]["w"])
    np.testing.assert_array_equal(tp["layer1"]["w"], init_p["layer1"]["w"])
    bad = {"layer0": {"w": np.zeros((1, 1, 3, 32), np.float32)}}
    for merge in (j_w.merge_into_model_tree, t_w.merge_into_model_tree):
        with pytest.raises(ValueError, match="layer0.w: shape"):
            merge(bad, {}, init_p, init_s)


@pytest.fixture()
def trees():
    params, state = reference_trees("yolov4-tiny", seed=5)
    ema = jax.tree_util.tree_map(lambda a: a * np.float32(0.5), params)
    return params, state, ema


def test_reference_checkpoint_loads_into_port(trees, tmp_path):
    params, state, ema = trees
    opt = {"mu": params, "count": np.asarray(3, np.int32)}
    path = j_ckpt.save_checkpoint(str(tmp_path), 12, 0.5, params, state, opt_state=opt,
                                  extra={"k": 1}, ema_params=ema)
    model = zoo.load_darknet_model(cfg_path("yolov4-tiny"), device="cpu")
    tp, ts = params_to_jax(model.state_dict())
    p, s, opt_out, meta = t_ckpt.load_checkpoint(path, tp, ts)
    assert opt_out is None  # opt/ entries are skipped
    assert_trees_equal(p, params)
    assert_trees_equal(s, state)
    assert_trees_equal(meta.pop("ema"), ema)
    assert meta == {"step": 12, "loss": 0.5, "has_opt": True, "has_ema": True, "extra": {"k": 1}}
    params_from_jax(p, s, model=model)
    assert_state_dict_equal(model.state_dict(), params_from_jax(params, state))
    # with a template, the optimizer state is read too
    _, _, opt_out, _ = t_ckpt.load_checkpoint(
        path, tp, ts, opt_template={"mu": tp, "count": np.zeros((), np.int32)})
    assert_trees_equal(opt_out["mu"], params)
    assert opt_out["count"].dtype == np.int32 and int(opt_out["count"]) == 3


def test_port_checkpoint_loads_into_reference(trees, tmp_path):
    params, state, _ = trees
    model = zoo.load_darknet_model(cfg_path("yolov4-tiny"), device="cpu")
    params_from_jax(params, state, model=model)
    ema = ema_init(dict(model.named_parameters()))
    for t in ema.values():
        t.mul_(0.25)
    tp, ts = params_to_jax(model.state_dict())
    path = t_ckpt.save_checkpoint(str(tmp_path), 7, 1.25, tp, ts, extra={"run": "a"},
                                  ema_params=params_to_jax(ema)[0])
    assert os.path.basename(path).endswith("_000007_01.25000.ckpt")
    jm = JYoloModel(j_load(cfg_path("yolov4-tiny")), spd_stem="off")
    jp0, js0 = jm.init(jax.random.PRNGKey(9))
    p, s, _, meta = j_ckpt.load_checkpoint(path, jp0, js0)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, p), params)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, s), state)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, meta.pop("ema")),
                       jax.tree_util.tree_map(lambda a: a * np.float32(0.25), params))
    assert meta == {"step": 7, "loss": 1.25, "has_opt": False, "has_ema": True,
                    "extra": {"run": "a"}}
    # the same entries, under the same names, as the reference writes
    ref_path = j_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, 1.25, params, state,
                                      extra={"run": "a"}, ema_params=params_to_jax(ema)[0])
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # optimizer state written by the port is read by the reference
    opt_path = t_ckpt.save_checkpoint(str(tmp_path / "opt"), 2, 0.0, tp, ts,
                                      opt_state={"mu": tp, "count": np.asarray(2, np.int32)})
    _, _, opt_out, meta = j_ckpt.load_checkpoint(
        opt_path, jp0, js0, {"mu": jp0, "count": np.zeros((), np.int32)})
    assert meta["has_opt"]
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, opt_out["mu"]), params)
    assert int(opt_out["count"]) == 2


def test_partial_checkpoint_load(trees, tmp_path):
    params, state, _ = trees
    small = {k: v for k, v in params.items() if k in ("layer0", "layer1")}
    path = j_ckpt.save_checkpoint(str(tmp_path), 1, 0.0, small, {})
    init_p, init_s = reference_trees("yolov4-tiny", seed=6)
    jp, js, jmeta, jskipped = j_ckpt.load_checkpoint_partial(path, init_p, init_s)
    tp, ts, tmeta, tskipped = t_ckpt.load_checkpoint_partial(path, init_p, init_s)
    assert sorted(tskipped) == sorted(jskipped) and len(tskipped) > 10
    assert tmeta == jmeta
    assert_trees_equal(tp, jax.tree_util.tree_map(np.asarray, jp))
    assert_trees_equal(ts, jax.tree_util.tree_map(np.asarray, js))
    with pytest.raises(KeyError, match="checkpoint missing tensor 'params/layer10"):
        t_ckpt.load_checkpoint(path, init_p, init_s)


def test_find_recent_checkpoint_orders_as_reference(tmp_path):
    names = ["2024-01-02-03-04-05_000010_00.50000.ckpt",
             "2024-01-02-03-04-06_000009_00nan.ckpt",
             "2024-01-02-03-04-06_1000000_0inf.ckpt",
             "2023-12-31-23-59-59_999999_01.00000.ckpt",
             "2025-01-01-00-00-00_12_01.0.ckpt",        # step too short: ignored
             "notes.txt", "2025-01-01-00-00-00_000001_1.0.ckpt.tmp"]
    runs = {"run_a": names[:2], "run_b": names[2:4], "run_c": names[4:]}
    for run, files in runs.items():
        d = tmp_path / "logs" / run / "checkpoints"
        d.mkdir(parents=True)
        for n in files:
            (d / n).write_bytes(b"")
    for run in runs:
        d = str(tmp_path / "logs" / run / "checkpoints")
        assert t_ckpt.find_recent_checkpoint(d) == j_ckpt.find_recent_checkpoint(d)
    logs = str(tmp_path / "logs")
    assert t_ckpt.find_recent_checkpoint_in_runs(logs) == j_ckpt.find_recent_checkpoint_in_runs(logs)
    assert t_ckpt.find_recent_checkpoint_in_runs(logs).endswith(names[2])
    assert t_ckpt.find_recent_checkpoint(str(tmp_path / "none")) is None
    assert t_ckpt.find_recent_checkpoint_in_runs(str(tmp_path / "none")) is None


def test_load_recent_and_async_checkpointer(trees, tmp_path):
    params, state, ema = trees
    model = zoo.load_darknet_model(cfg_path("yolov4-tiny"), device="cpu")
    params_from_jax(params, state, model=model)
    tp, ts = params_to_jax(model.state_dict())
    live = {k: {kk: vv for kk, vv in v.items()} for k, v in params.items()}
    live["layer0"] = {**live["layer0"], "w": torch.from_numpy(params["layer0"]["w"].copy())}
    ckpt = t_ckpt.AsyncCheckpointer()
    ckpt.save(str(tmp_path / "logs" / "r1" / "checkpoints"), 3, 0.25, live, state,
              ema_params=ema)
    live["layer0"]["w"].add_(1.0)  # an in-place update after save() is not saved
    ckpt.flush()
    out = t_ckpt.load_recent_checkpoint_in_runs(str(tmp_path / "logs"), tp, ts)
    assert out is not None
    p, s, _, meta = out
    assert_trees_equal(p, params)
    assert_trees_equal(meta["ema"], ema)
    assert t_ckpt.load_recent_checkpoint(str(tmp_path / "empty"), tp, ts) is None
    # the optimizer state is snapshotted on the caller too
    moment = torch.from_numpy(params["layer0"]["w"].copy())
    ckpt.save(str(tmp_path / "logs" / "r2" / "checkpoints"), 4, 0.5, tp, ts,
              opt_state={"mu": {"layer0": {"w": moment}}})
    moment.add_(1.0)
    ckpt.flush()
    _, _, opt_out, meta = t_ckpt.load_recent_checkpoint_in_runs(
        str(tmp_path / "logs"), tp, ts, {"mu": {"layer0": {"w": tp["layer0"]["w"]}}})
    assert meta["step"] == 4 and meta["has_opt"]
    np.testing.assert_array_equal(opt_out["mu"]["layer0"]["w"], params["layer0"]["w"])
    # a failed write surfaces at the next flush
    (tmp_path / "a_file").write_text("")
    bad = t_ckpt.AsyncCheckpointer()
    bad.save(str(tmp_path / "a_file" / "checkpoints"), 1, 0.0, tp, ts)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        bad.flush()

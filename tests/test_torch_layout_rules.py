"""When the port's model takes a layout rewrite, and when it runs the nodes
one by one: the reference's rules, and the port's own where the
reference could not run the rewrite.

- yolov4-tiny (a stride-2 first conv) has no stem pair, in either package.
- A pipeline stage whose ``node_subset`` holds the stem trio and the deep
  quintet keeps both (stage 0 of ``plan_stages(model, 2)``), and matches
  the reference's ``apply(node_subset=..., output_keys=...)`` within rtol
  1e-4 + atol 1e-4 · max|ref|; the fold is skipped under any
  ``node_subset``, as in the reference; the next stage takes nothing.
- ``node_overrides`` skip the stem; a node of a rewrite with a
  tensor-parallel ``shard`` (``parallel/tp.py`` ``shard_model`` on a 1×1
  mesh, whose ``LayerShard``s compute as no shard does) skips it: bit for
  bit the model with every knob off.
- ``output_keys`` naming a node inside the trio or quintet other than its
  last skips that rewrite (the reference has no output for it); a region
  node named there is unfolded for the caller.
- An odd height or width skips the stem; an odd half skips the quintet
  only; a width that is no multiple of 4 at the region runs it
  canonically (test_torch_fold_region.py).
- ``remat="blocks"`` recomputes the SPD functions in the backward and
  writes their BN statistics once: bit for bit the model without remat.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import MINI_CFG, REPO, count_rewrites, layout_models
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.graph.from_darknet import graph_from_darknet
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.models import YoloModel
from yolodl_torch.models.builder import GraphModel
from yolodl_torch.parallel.mesh import (destroy_process_group, free_port, init_process_group,
                                        make_tp_mesh)
from yolodl_torch.parallel.pipeline import plan_stages
from yolodl_torch.parallel.tp import shard_model
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel

torch.set_num_threads(2)

FIELDS = ("cycxhw", "obj_logit", "class_logit")


def image(seed=2, size=64, batch=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 1, (batch, 3, size, size)).astype(np.float32))


def same_detections(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


def test_tiny_has_no_stem_pair():
    path = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")
    for knob in ("auto", "deep"):
        tm = YoloModel(t_load(path), device="cpu", spd_stem=knob, fold_region="on")
        jm = JYoloModel(j_load(path), spd_stem=knob, fold_region="on")
        assert tm._spd_pair is None and jm._spd_pair is None
        assert tm._spd_res is None and set(tm._fold_keys) == set(jm._fold_keys)


def test_pipeline_stage_keeps_the_rewrite(monkeypatch):
    jm, params, state, tm = layout_models(dict(spd_stem="deep", fold_region="on"))
    first, second = plan_stages(tm, 2)
    assert {0, 1, 2, 3, 4, 5} <= set(first.keys)
    x = image()
    counts = count_rewrites(monkeypatch)
    with torch.no_grad():
        out = tm(x, node_overrides={}, node_subset=frozenset(first.keys),
                 output_keys=first.out_keys)
    assert counts == dict(spd_stem_apply=1, spd_res_block_apply=1, fold_conv_bn_apply=0,
                          fold_w=0, unfold_w=0)
    ref, _ = jax.jit(lambda p, s, xx: jm.apply(
        p, s, xx, node_subset=frozenset(first.keys), output_keys=first.out_keys))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x.numpy()))
    for k in first.out_keys:
        close(out[k].permute(0, 2, 3, 1).numpy(), ref[k], f"stage 0 output {k}")
    with torch.no_grad():
        last = tm(None, node_overrides={k: out[k] for k in second.in_keys},
                  node_subset=frozenset(second.keys))
    assert counts["spd_stem_apply"] == 1 and counts["fold_conv_bn_apply"] == 0
    assert torch.isfinite(last.cycxhw).all()


def test_node_overrides_skip_the_stem(monkeypatch):
    *_, off = layout_models({})
    auto = YoloModel(off.graph, device="cpu", spd_stem="deep")
    auto.load_state_dict(off.state_dict())
    x = image()
    key = off.graph.order[12]
    with torch.no_grad():
        override = {key: off(x, output_keys=(key,))[key] + 0.25}
        counts = count_rewrites(monkeypatch)
        same_detections(auto(x, node_overrides=override), off(x, node_overrides=override))
    assert set(counts.values()) == {0}


@pytest.fixture
def tp_1x1():
    init_process_group("cpu", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                       world_size=1)
    try:
        yield make_tp_mesh(1, 1)
    finally:
        destroy_process_group()


@pytest.mark.parametrize("train", [False, True])
def test_tensor_parallel_shards_skip_the_rewrites(tp_1x1, train, monkeypatch):
    *_, off = layout_models({})
    every = YoloModel(off.graph, device="cpu", spd_stem="deep", fold_region="on")
    every.load_state_dict(off.state_dict())
    for m in (off, every):
        assert shard_model(tp_1x1, m)
    x = image()
    counts = count_rewrites(monkeypatch)
    with torch.no_grad():
        same_detections(every(x, train=train), off(x, train=train))
    assert set(counts.values()) == {0}
    assert all(torch.equal(a, b) for a, b in zip(every.state_dict().values(),
                                                  off.state_dict().values()))


def test_output_keys(monkeypatch):
    *_, off = layout_models({})
    every = YoloModel(off.graph, device="cpu", spd_stem="deep", fold_region="on")
    every.load_state_dict(off.state_dict())
    k_in, k0, k1 = every._spd_pair
    k2, k3, k4 = every._spd_res
    x = image()
    counts = count_rewrites(monkeypatch)
    with torch.no_grad():
        # the stem's inner conv: nothing packed, the value is the plain one
        assert torch.equal(every(x, output_keys=(k0,))[k0], off(x, output_keys=(k0,))[k0])
        assert counts["spd_stem_apply"] == 0
        # the quintet's inner conv: the stem packed, the quintet not
        got = every(x, output_keys=(k1, k3))
        want = off(x, output_keys=(k1, k3))
        assert counts["spd_stem_apply"] == 1 and counts["spd_res_block_apply"] == 0
        for k in (k1, k3):
            close(got[k].numpy(), want[k].numpy(), f"node {k}")
        # both packed; a node after the region
        got = every(x, output_keys=(k4, 5, 7))
        want = off(x, output_keys=(k4, 5, 7))
        assert counts["spd_res_block_apply"] == 1
        for k in (k4, 5, 7):
            close(got[k].numpy(), want[k].numpy(), f"node {k}")
    fold = YoloModel(off.graph, device="cpu", fold_region="on")
    fold.load_state_dict(off.state_dict())
    counts.update(fold_conv_bn_apply=0, unfold_w=0)
    with torch.no_grad():
        got = fold(x, output_keys=(3, 4))
        want = off(x, output_keys=(3, 4))
    assert counts["fold_conv_bn_apply"] == 2 and counts["unfold_w"] == 2
    for k in (3, 4):
        close(got[k].numpy(), want[k].numpy(), f"region node {k}")


def test_odd_sizes_skip_the_packing(monkeypatch):
    graph = graph_from_darknet(t_dk.Darknet.from_str(MINI_CFG))
    off = GraphModel(graph, device="cpu")
    deep = GraphModel(graph, device="cpu", spd_stem="deep")
    deep.load_state_dict(off.state_dict())
    assert deep._spd_pair == (0, 1, 2) and deep._spd_res == (3, 4, 5)
    counts = count_rewrites(monkeypatch)
    with torch.no_grad():
        for size, stem, quintet in ((24, 1, 1), (22, 1, 0), (23, 0, 0)):
            x = image(size=size)
            got, want = deep(x), off(x)
            assert (counts["spd_stem_apply"], counts["spd_res_block_apply"]) == (stem, quintet)
            counts.update(spd_stem_apply=0, spd_res_block_apply=0)
            if stem:
                close(got.numpy(), want.numpy(), f"{size}²")
            else:
                assert torch.equal(got, want)


def test_remat_recomputes_and_writes_state_once(monkeypatch):
    graph = graph_from_darknet(t_dk.Darknet.from_str(MINI_CFG))
    plain = GraphModel(graph, device="cpu", spd_stem="deep")
    remat = GraphModel(graph, device="cpu", spd_stem="deep", remat="blocks")
    remat.load_state_dict(plain.state_dict())
    counts = count_rewrites(monkeypatch)
    x = image(size=24)
    outs = []
    for m in (plain, remat):
        y = m(x, train=True)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        outs.append(y.detach())
    # the plain model once; the remat model once and again in its backward
    assert (counts["spd_stem_apply"], counts["spd_res_block_apply"]) == (3, 3)
    assert torch.equal(outs[0], outs[1])
    for (name, a), b in zip(plain.state_dict().items(), remat.state_dict().values()):
        assert torch.equal(a, b), name
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), name

"""``yolodl_torch.parallel`` GPipe over 4 stages of yolov4-csp: the case
where a boundary tensor passes through a stage.

The planner cuts yolov4-csp into 4 stages with ``layer131`` (a ``/8``
route) crossing two cuts: stage 2 receives it and sends it on unchanged,
so its gradient there is the sum of what stage 3 sends back and what
stage 2's own nodes give it.  The cfg keeps the flagship's topology at
64² with 3 classes and every conv's filters cut to an eighth (0.83 M
parameters); its plan of 28/45/56/48 nodes passes ``layer131`` through
stage 2 as the full-width cfg's plan of 31/44/55/47 does.  Four
gloo ranks (``PP_RANK_SCRIPT`` of tests/_torch_parity.py) take two SGD
steps (momentum 0.9, lr 1e-3) of 2 micro-batches on two seeded batches of
4 images, against the port's single-process ``make_train_step(accum=2)``
with the reference test's limits (loss 1e-5, parameters 3e-6, BN
statistics 1e-5) and against the reference's accumulation step: losses
within test_torch_train.py's rel 1e-4, every tensor within 1e-3 · max|ref|.
That is more than test_torch_train.py's 3e-4: through this deeper, narrow
model two steps at lr 1e-3 carry f32 rounding further, and the port's own
single-process step differs from the reference by 4.1e-4 · max|ref| (at
``layer172/bn/mean``) as the 4 stages do (measured on this sandbox's CPU).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (REPO, assert_trees_close, flat_leaves, port_single, random_targets,
                           seeded_trees, start_pp_ranks, state_trees, wait_ranks)
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.train import loop as j_loop
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models import YoloModel
from yolodl_torch.parallel import plan_stages
from yolodl_torch.train import loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig

torch.set_num_threads(2)


def narrow_csp(path):
    """yolov4-csp at 64², 3 classes, each conv's filters divided by 8."""
    text = open(f"{REPO}/cfg/darknet/yolov4-csp.cfg").read()
    text = re.sub(r"(?m)^width=\d+", "width=64", text)
    text = re.sub(r"(?m)^height=\d+", "height=64", text)
    text = text.replace("classes=80", "classes=3").replace("filters=255", "filters=24")
    text = re.sub(r"(?m)^filters=(\d+)",
                  lambda m: m.group(0) if m.group(1) == "24" else f"filters={int(m.group(1)) // 8}",
                  text)
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_csp")
    path = narrow_csp(tmp / "csp64.cfg")
    jm = JYoloModel(j_load(path), spd_stem="off")
    params, state = seeded_trees(jm.init, 0)
    tm = YoloModel(load_darknet_graph(path), device="cpu")
    params_from_jax(params, state, model=tm)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    rng = np.random.default_rng(5)
    data = [(rng.uniform(0, 1, (4, 3, 64, 64)).astype(np.float32),
             *random_targets(4, 4, 20 + i, num_classes=3)) for i in range(2)]
    procs, prefix = start_pp_ranks(tmp, {"csp": {
        "model": path, "init": init, "config": dict(optimizer="sgd", momentum=0.9, lr=1e-3),
        "stages": 4, "accum": 2, "steps": 2}}, data, 4)
    t_cfg = loop.TrainConfig(lr=LrScheduleConfig(kind="constant", lr=1e-3), optimizer="sgd",
                             momentum=0.9)
    single = port_single(tm, t_cfg, data, accum=2)
    config = j_loop.TrainConfig(optimizer="sgd", momentum=0.9)
    opt = j_loop.make_optimizer(config)
    p, s = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state))
    ts = j_loop.TrainState(p, s, opt.init(p), jnp.zeros((), jnp.int32), None)
    step = j_loop.make_train_step(jm, opt, config, accum=2)
    ref_losses = []
    for b in data:
        ts, m = step(ts, *map(jnp.asarray, b))
        ref_losses.append(float(m["total_loss"]))
    ref = (ref_losses, flat_leaves(jax.device_get(ts.params)),
           flat_leaves(jax.device_get(ts.state)))
    wait_ranks(procs, timeout=300)
    return tm, single, ref, dict(np.load(f"{prefix}.r0.npz"))


def test_plan_passes_layer131_through_stage_2(runs):
    tm = runs[0]
    plans = plan_stages(tm, 4)
    through = [[tm._pname[k] for k in set(p.in_keys) & set(p.out_keys)] for p in plans]
    assert through == [[], [], ["layer131"], []]
    assert [len(p.keys) for p in plans] == [28, 45, 56, 48]


def test_four_stages_match_the_accumulation_steps(runs):
    _, (first, final, losses), (ref_losses, r_params, r_state), rank0 = runs
    got = [float(rank0[f"csp/step{i}/total_loss"]) for i in range(2)]
    np.testing.assert_allclose(got, losses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref_losses, rtol=1e-4)
    for which, single in (("first", first), ("final", final)):
        params, state = ({k[len(p):]: v for k, v in rank0.items() if k.startswith(p)}
                         for p in (f"csp/{which}/params/", f"csp/{which}/state/"))
        s_params, s_state = state_trees(single)
        assert_trees_close(params, s_params, 3e-6)
        assert_trees_close(state, s_state, 1e-5)
    assert_trees_close(params, r_params, 1e-3, rel=True)
    assert_trees_close(state, r_state, 1e-3, rel=True)

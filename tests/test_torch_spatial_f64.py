"""``make_spatial_train_step`` in float64 against the port's single-process
``make_train_step`` in float64: the arithmetic of the spatial step, held
far below what an f32 comparison can see.

yolov4-tiny at 96² with 3 classes (``pp_tiny``), one SGD step (momentum
0.937, lr 1e-2) on the reference test's batch at 96² (2 seeded images
duplicated over the data axis), on a 2 × 2 mesh and on a 1 × 2 mesh
(four and two ranks over gloo, ``SPATIAL_RANK_SCRIPT``); at 96² over 2
shards the planner shards 26 of the 40 nodes, so the tail holds 7 convs (5
with BN) and the gather's gradient reaches both.  Every parameter's
gradient, every parameter's update and every BN statistic must be within
1e-9 · max|single| of the single process's, per tensor.  A prefix gradient
off by the space axis's factor, a halo row whose gradient is not returned,
or prefix BN statistics written a second time by the tail's walk each miss
by far more.

What cannot run in float64: ``yolo_loss`` computes in f32 whatever the
network's dtype (loss/yolo_loss.py:151), so the heads' outputs are rounded
to f32 before the loss in both runs alike; the worst gradient difference
measured on a CPU is still 2.5e-14 · max.  One difference is by design: on
2 × 2 a tail BN normalizes with its data replica's 2 images, and its
running variance takes the unbiased factor of that count, n / (n − 1),
where the single process takes that of 4 images (the reference's step does
the same, ``spatial_model.py:338``); those statistics are held against the
single process's with that factor put right.
"""

import numpy as np
import pytest
import torch

from _torch_parity import pp_tiny, spatial_batch, start_spatial_ranks, wait_ranks
from yolodl_torch.config import newslab as cfg
from yolodl_torch.ops.norm import DEFAULT_MOMENTUM
from yolodl_torch.parallel.spatial_model import plan_spatial_prefix
from yolodl_torch.train import loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", lr=1e-2)
SIZE, TOL = 96, 1e-9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_f64")
    path, _, _, _, tm, init = pp_tiny(tmp, SIZE)
    batch = spatial_batch(size=SIZE)
    arrays = {f"{k}0": v for k, v in zip(("images", "boxes", "classes", "mask"), batch)}
    case = {"mode": "step", "model": path, "init": init, "config": SGD, "dtype": "float64"}
    procs, outs = {}, {}
    for shape in ((2, 2), (1, 2)):
        where = tmp / f"{shape[0]}x{shape[1]}"
        where.mkdir()
        procs[shape], outs[shape] = start_spatial_ranks(
            where, {"step": {**case, "mesh": list(shape)}}, arrays, shape[0] * shape[1])
    tm = tm.to(torch.float64)
    tm.load_state_dict(init)
    t_cfg = loop.TrainConfig(lr=LrScheduleConfig(kind="constant", lr=SGD["lr"]),
                             optimizer="sgd")
    ts, opt = loop.train_init(tm, t_cfg)
    images = torch.from_numpy(batch[0]).to(torch.float64)
    _, metrics = loop.make_train_step(tm, opt, t_cfg)(ts, images,
                                                      *map(torch.from_numpy, batch[1:]))
    single = {"state": {k: v.numpy().copy() for k, v in tm.state_dict().items()},
              "grad": {k: p.grad.numpy().copy() for k, p in tm.named_parameters()},
              "loss": float(metrics["total_loss"]), "matched": int(metrics["num_matched"])}
    sharded, _ = plan_spatial_prefix(tm, 2)
    graph = tm.graph
    tail_bn = {f"layers.{tm._pname[k]}.bn.var": graph.nodes[k].output_shape.tensor_shape()
               for k in graph.order if k not in sharded
               and isinstance(graph.nodes[k].config, cfg.ConvBn2D)
               and graph.nodes[k].config.bn.enabled}
    ranks = {}
    for shape in procs:
        wait_ranks(procs[shape])
        ranks[shape] = dict(np.load(f"{outs[shape]}.r0.npz"))
    init = {k: v.numpy().astype(np.float64) for k, v in init.items()}
    return single, ranks, init, tail_bn


def per_replica_var(single_var, v0, shape, rows, n_data):
    """The running variance a tail BN writes when each of ``n_data`` data
    replicas normalizes ``rows / n_data`` images, from the single process's
    (the same biased variance, the unbiased factor of the smaller count)."""
    n = rows * shape[2].size * shape[3].size
    m = n // n_data
    moved = (single_var - (1 - DEFAULT_MOMENTUM) * v0) / (n / (n - 1))
    return (1 - DEFAULT_MOMENTUM) * v0 + moved * (m / (m - 1))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_float64_step_equals_the_single_process(runs, shape):
    single, ranks, init, tail_bn = runs
    rank = ranks[shape]
    assert abs(float(rank["step/metrics/total_loss"]) - single["loss"]) <= 1e-12 * single["loss"]
    # a sum over the data replicas of each one's count
    assert int(rank["step/metrics/num_matched"]) == single["matched"] > 0
    grads = {k[len("step/grad/"):]: v for k, v in rank.items() if k.startswith("step/grad/")}
    assert grads.keys() == single["grad"].keys()
    for k, ref in single["grad"].items():
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(grads[k], ref, rtol=0, atol=TOL * np.abs(ref).max(),
                                   err_msg=f"gradient of {k}")
    state = {k[len("step/state/"):]: v for k, v in rank.items() if k.startswith("step/state/")}
    assert state.keys() == single["state"].keys()
    assert tail_bn and all(k in state for k in tail_bn)
    for k, ref in single["state"].items():
        got = state[k]
        if k in tail_bn and shape[0] > 1:
            ref = per_replica_var(ref, init[k], tail_bn[k], 4, shape[0])
        if k.endswith((".mean", ".var")):  # BN statistics
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max(), err_msg=k)
        else:  # a parameter: its update
            want = ref - init[k]
            np.testing.assert_allclose(got - init[k], want, rtol=0,
                                       atol=TOL * np.abs(want).max(), err_msg=f"update of {k}")

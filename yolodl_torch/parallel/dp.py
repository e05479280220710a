"""The data-parallel training step, one process per rank.

Counterpart of ``yolodl_tpu/parallel/dp.py``.  The reference compiles one
``shard_map`` program: parameters replicated, the batch sharded over the
``data`` axis, gradients ``pmean``-averaged over the replicas.  Here each
rank is a process that runs the single-device step of ``train/loop.py`` on
its own rows, with three collectives between the backward and the update
(``make_train_step``'s ``reduce`` hook, :class:`DPHooks`):

- one all-reduce of every gradient as one flat buffer, divided by the
  world size (the reference's ``pmean(grads)``);
- one all-reduce of the BN running statistics, divided likewise: each
  rank normalizes with its own rows' batch statistics, and the running
  statistics are averaged after the step (``dp.py:1-17``, ``:103-105``).
  ``DistributedDataParallel`` would let rank 0's statistics win instead;
- one all-reduce of the stacked metrics: ``num_matched`` summed, every
  other metric averaged (``:118-121``).

Clipping, the ``log_weights_and_grads`` maxima, the optimizer, the BN
variance clamp and the EMA then run on the reduced values in the
single-device step's order, so the replicas never diverge.  The all-reduce
does not overlap the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models.builder import YoloModel
from ..train.loop import StepHooks, TrainConfig, TrainState, make_train_step
from .mesh import DataMesh


def shard_batch(mesh: DataMesh, batch: Any) -> Any:
    """This rank's rows of a global batch: the ``rank``-th of ``world_size``
    equal slices of every array's leading axis (the reference's device
    order)."""
    rows = batch[0].shape[0]
    if rows % mesh.world_size:
        raise ValueError(f"batch {rows} is not divisible by {mesh.world_size} ranks")
    part = rows // mesh.world_size
    return tuple(x[mesh.rank * part:(mesh.rank + 1) * part] for x in batch)


def shard_batch_multiprocess(mesh: DataMesh, batch: Any) -> Any:
    """The multi-controller variant: each rank passes its local rows as they
    are (rank ``i`` streams records ``[i::world_size]``); checked to share
    one leading size."""
    sizes = {int(x.shape[0]) for x in batch}
    if len(sizes) != 1:
        raise ValueError(f"local batch arrays disagree on their leading size: {sorted(sizes)}")
    return batch


@torch.no_grad()
def _mean_over_ranks(mesh: DataMesh, tensors, divide: bool = True) -> None:
    """Average ``tensors`` over the ranks in place, as one flat buffer (sum
    them when ``divide`` is false)."""
    tensors = list(tensors)
    if not tensors or mesh.world_size == 1 and not divide:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.all_reduce_(flat)
    if divide:
        flat.div_(mesh.world_size)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def reduce_metrics(mesh: DataMesh, metrics: dict) -> dict:
    """``num_matched`` summed over the ranks, every other metric averaged;
    one all-reduce of the stacked scalars (in f64, so that counts and
    means come back exact before they return to their dtypes)."""
    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].to(torch.float64).reshape(()) for k in keys])
    mesh.all_reduce_(stacked)
    return {k: (stacked[i] if k == "num_matched" else stacked[i] / mesh.world_size)
            .to(metrics[k].dtype) for i, k in enumerate(keys)}


def make_dp_train_step(
    model: YoloModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    mesh: DataMesh,
    data_format: str = "NCHW",
    accum: int = 1,
) -> Callable:
    """Data-parallel train step over ``mesh``: (TrainState, local images,
    boxes, classes, mask) → (TrainState, metrics), every rank calling it
    with its own rows.

    ``accum > 1`` splits each rank's rows into ``accum`` sequential
    micro-batches (``train.loop.make_batch_grads``), so the logical batch
    is ``world_size × accum`` micro-batches.  ``obj_sample`` is per-rank
    data and is never returned (``dp.py:82-85``).
    """
    config = dataclasses.replace(config, return_obj_sample=False)
    return make_train_step(model, optimizer, config, data_format, accum,
                           hooks=DPHooks(mesh, model))


class DPHooks(StepHooks):
    """The data-parallel step's ``reduce``: gradients and BN running
    statistics averaged over the ranks, the metrics reduced."""

    def __init__(self, mesh: DataMesh, model: YoloModel):
        self.mesh, self.model = mesh, model

    def reduce(self, metrics: dict) -> dict:
        _mean_over_ranks(self.mesh, [p.grad for p in self.model.parameters()])
        mean_buffers(self.mesh, self.model)
        return reduce_metrics(self.mesh, metrics)


def mean_buffers(mesh: DataMesh, model: YoloModel) -> None:
    """The BN running statistics averaged over the ranks, in place."""
    _mean_over_ranks(mesh, [b for b in model.buffers() if b.is_floating_point()])


@torch.no_grad()
def replicate_state(mesh: DataMesh, ts: TrainState) -> TrainState:
    """Rank 0's state on every rank: parameters, BN statistics, optimizer
    state, EMA and step, broadcast in place."""
    model, optimizer = ts.model, ts.optimizer
    for t in [*model.parameters(), *model.buffers()]:
        mesh.broadcast_(t)
    for p in model.parameters():
        state = optimizer.state.get(p, {})
        for key in sorted(state):
            if isinstance(state[key], torch.Tensor):
                mesh.broadcast_(state[key])
    if ts.ema_params is not None:
        for key in sorted(ts.ema_params):
            mesh.broadcast_(ts.ema_params[key])
    step = mesh.broadcast_(torch.tensor([ts.step], dtype=torch.int64))
    ts.step = int(step.item())
    return ts

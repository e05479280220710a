"""ZeRO-1: the optimizer state sharded over the data axis.

Counterpart of ``yolodl_tpu/parallel/zero.py``.  Plain data parallelism
(``dp.py``) keeps the parameters and the optimizer state on every rank, so
Adam costs three times the model per rank.  ZeRO-1 keeps the forward and
backward replicated and cuts the optimizer over the ranks:

    reduce-scatter(grads) / n → each rank holds 1/n of the mean gradient
    optimizer step            → on that slice only (Adam's moments are 1/n)
    all-gather(slice)         → the replicas' parameters stay identical

The parameters are raveled as the reference ravels its params tree (its
leaf order and layouts) and padded to ``n · per_shard``
(:func:`flat_geometry`, the reference's ``_flat_geometry`` :42); rank r
updates elements ``[r·per_shard, (r+1)·per_shard)`` with one
``torch.optim`` optimizer over a flat f32 vector (:class:`FlatShard`).
Any elementwise optimizer (Adam, AdamW, SGD, clip-by-value) updates a
slice as it would the whole vector, so the step is the data-parallel one.  ``clip_grad_norm`` needs the global norm and is
rejected (:func:`zero_init`).  The BN running statistics and the metrics
are reduced as in ``dp.py``.

The reduce-scatter takes ``reduce_scatter_tensor`` where the backend has it
(``mesh.py`` :func:`reduce_scatter_route`, printed at start-up).

A checkpoint holds the reference's layout of this state: ``opt/…/.mu`` and
``.nu`` (or ``.trace``) as flat ``[n · per_shard]`` vectors, gathered onto
rank 0 (:func:`zero_optimizer_state_tree`), so a ZeRO checkpoint of either
package resumes in the other's ZeRO run at the same world size.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.builder import YoloModel
from ..train.ema import ema_init
from ..train.loop import (_MOMENTS, StepHooks, TrainConfig, TrainState, _nest, _optax_layout,
                          make_optimizer, make_train_step)
from .dp import _mean_over_ranks, mean_buffers, reduce_metrics
from .mesh import DataMesh


def flat_geometry(params: Sequence[torch.Tensor], n: int) -> Tuple[int, int]:
    """(padded total, per-shard length) of the raveled ``params`` over
    ``n`` ranks."""
    total = sum(p.numel() for p in params)
    per_shard = -(-total // n)
    return per_shard * n, per_shard


def _reference_path(key: str) -> tuple:
    """A parameter's ``state_dict`` key as the reference's tree path."""
    parts = key[len("layers."):].split(".")
    return (parts[0].replace("/", "."), *parts[1:])


def _to_reference(t: torch.Tensor) -> torch.Tensor:
    """A parameter-shaped tensor in the reference's layout: a conv kernel
    HWIO, a dense weight ``[in, out]`` (``bridge.py``)."""
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if t.dim() == 2 else t


class FlatShard:
    """This rank's slice of the raveled, padded parameter vector over
    ``axis``: ``param`` (a flat f32 leaf of ``per_shard`` elements, the
    one parameter of the rank's optimizer), filled from the parameters by
    :meth:`load`, given its gradient by :meth:`scatter` and written back
    to every rank's parameters by :meth:`gather`.

    The vector is the reference's ``ravel_pytree`` of its params tree: the
    leaves in the order of their tree paths, each raveled in the
    reference's layout, so that a flat optimizer state is one vector in
    both packages."""

    def __init__(self, model: YoloModel, axis: DataMesh, param=None):
        named = sorted((_reference_path(k), k, p) for k, p in model.named_parameters())
        self.names = [k for _, k, _ in named]
        self.params = [p for _, _, p in named]
        self.axis = axis
        self.total = sum(p.numel() for p in self.params)
        self.padded, self.per_shard = flat_geometry(self.params, axis.world_size)
        self.offset = axis.rank * self.per_shard
        if param is None:
            param = nn.Parameter(torch.zeros(self.per_shard, dtype=torch.float32,
                                             device=self.params[0].device))
        if param.shape != (self.per_shard,):
            raise ValueError(f"a ZeRO slice of {self.per_shard} elements, got {tuple(param.shape)}")
        self.param = param

    def flat(self, tensors) -> torch.Tensor:
        """Parameter-shaped ``tensors`` (in :attr:`params` order) as one
        padded f32 vector."""
        flat = torch.cat([_to_reference(t).reshape(-1).to(torch.float32) for t in tensors])
        return nn.functional.pad(flat, (0, self.padded - self.total))

    def split(self, flat: torch.Tensor):
        """The inverse of :meth:`flat`: views of ``flat`` shaped like the
        parameters, in :attr:`params` order."""
        out, offset = [], 0
        for p in self.params:
            chunk = flat[offset:offset + p.numel()].view(_to_reference(p).shape)
            offset += p.numel()
            out.append(chunk.permute(3, 2, 0, 1) if p.dim() == 4
                       else chunk.t() if p.dim() == 2 else chunk)
        return out

    def local(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.offset:self.offset + self.per_shard]

    @torch.no_grad()
    def load(self) -> None:
        """This rank's slice of the current parameters into ``param``."""
        self.param.copy_(self.local(self.flat(self.params)))

    @torch.no_grad()
    def scatter(self, scale: float) -> None:
        """``param.grad`` = this rank's slice of the sum over the ranks of
        the parameters' gradients, times ``scale``."""
        local = self.axis.reduce_scatter(self.flat([p.grad for p in self.params]))
        self.param.grad = local.mul_(scale)

    @torch.no_grad()
    def gather(self) -> None:
        """Every rank's updated slice, written back into the parameters."""
        full = self.axis.all_gather(self.param.detach())
        for p, value in zip(self.params, self.split(full)):
            p.copy_(value)

    def mask(self, cut) -> torch.Tensor:
        """A bool mask over ``param``: true where the element belongs to a
        parameter whose ``id`` is in ``cut``."""
        full = torch.cat([torch.full((p.numel(),), id(p) in cut, dtype=torch.bool)
                          for p in self.params])
        full = nn.functional.pad(full, (0, self.padded - self.total))
        return self.local(full).to(self.param.device)


def zero_init(model: YoloModel, config: TrainConfig, mesh: DataMesh,
              seed=None) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Like ``train_init``, but the optimizer is built over this rank's
    flat slice (:class:`FlatShard`), its state ``per_shard`` long.  Raises
    the reference's ``ValueError`` for ``clip_grad_norm``."""
    if config.clip_grad_norm is not None:
        raise ValueError(
            "ZeRO-1 shards the optimizer elementwise; clip_grad_norm needs "
            "the global gradient norm — use clip_grad_value or plain DP")
    if seed is not None:
        model.init(torch.Generator().manual_seed(seed))
    params = list(model.parameters())
    for p in params:
        p.grad = torch.zeros_like(p)
    shard = FlatShard(model, mesh)
    optimizer = make_optimizer(config, [shard.param])
    ema = ema_init(dict(model.named_parameters())) if config.use_ema else None
    return TrainState(model=model, optimizer=optimizer, step=0, ema_params=ema), optimizer


def _slice_param(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    (param,) = optimizer.param_groups[0]["params"]
    return param


@torch.no_grad()
def place_zero_state(mesh: DataMesh, ts: TrainState) -> TrainState:
    """Rank 0's parameters, BN statistics, EMA and step on every rank
    (broadcast in place), and this rank's part of any optimizer state that
    holds the whole ``[n · per_shard]`` vector (a restored checkpoint)."""
    model, param = ts.model, _slice_param(ts.optimizer)
    for t in [*model.parameters(), *model.buffers()]:
        mesh.broadcast_(t)
    if ts.ema_params is not None:
        for key in sorted(ts.ema_params):
            mesh.broadcast_(ts.ema_params[key])
    ts.step = int(mesh.broadcast_(torch.tensor([ts.step], dtype=torch.int64)).item())
    shard = FlatShard(model, mesh, param)
    state = ts.optimizer.state.get(param, {})
    for key, value in state.items():
        if isinstance(value, torch.Tensor) and value.shape == (shard.padded,):
            state[key] = shard.local(value).clone()
    return ts


class ZeroHooks(StepHooks):
    """ZeRO-1's step: ``reduce`` averages the BN statistics and reduces the
    metrics as ``dp.py`` does (and, for ``log_weights_and_grads``, averages
    the gradients too, a collective for the telemetry only, as the
    reference's ``pmean(grads)``); ``update`` reduce-scatters the gradients
    into this rank's slice, clips it by value, steps the slice's optimizer
    and all-gathers the parameters."""

    def __init__(self, mesh: DataMesh, model: YoloModel, shard: FlatShard, config: TrainConfig):
        self.mesh, self.model, self.shard = mesh, model, shard
        self.averaged = config.log_weights_and_grads

    def reduce(self, metrics: dict) -> dict:
        mean_buffers(self.mesh, self.model)
        if self.averaged:
            _mean_over_ranks(self.mesh, [p.grad for p in self.model.parameters()])
        return reduce_metrics(self.mesh, metrics)

    def scale(self) -> float:
        """The factor of the scattered sum: the mean over the ranks (whose
        gradients are already that mean when ``reduce`` averaged them)."""
        return 1.0 / self.mesh.world_size

    def update(self, optimizer, params, config, lr) -> None:
        self.shard.load()
        self.shard.scatter(self.scale())
        super().update(optimizer, [self.shard.param], config, lr)
        self.shard.gather()


def make_zero_train_step(
    model: YoloModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    mesh: DataMesh,
    data_format: str = "NCHW",
    accum: int = 1,
) -> Callable:
    """ZeRO-1 train step over ``mesh`` (the optimizer from
    :func:`zero_init`): (TrainState, local images, boxes, classes, mask) →
    (TrainState, metrics), every rank calling it with its own rows.  The
    numbers are the data-parallel step's: an elementwise update on a slice
    is the update of the whole vector."""
    config = dataclasses.replace(config, return_obj_sample=False)
    shard = FlatShard(model, mesh, _slice_param(optimizer))
    return make_train_step(model, optimizer, config, data_format, accum,
                           hooks=ZeroHooks(mesh, model, shard, config))


def zero_optimizer_state_tree(ts: TrainState, config: TrainConfig, mesh: DataMesh) -> Dict:
    """The optimizer state as the reference's ZeRO optax tree: the moments
    flat ``[n · per_shard]`` vectors, every rank's slice gathered (every
    rank calls it; each gets the tree), ``.count`` int32 ``ts.step``."""
    param = _slice_param(ts.optimizer)
    moments_at, count_at = _optax_layout(config)
    count = np.asarray(ts.step, np.int32)
    tree: Dict = {}
    moments = _nest(tree, moments_at)
    state = ts.optimizer.state.get(param, {})
    for field, torch_key in _MOMENTS[config.optimizer]:
        local = state.get(torch_key)
        local = torch.zeros_like(param) if local is None else local
        moments[field] = mesh.all_gather(local.detach()).cpu().numpy()
    if config.optimizer == "adam":
        moments[".count"] = count
    _nest(tree, count_at)[".count"] = count
    return tree


@torch.no_grad()
def load_zero_optimizer_state_tree(ts: TrainState, config: TrainConfig, tree: Dict) -> None:
    """Set the slice optimizer's state from a reference ZeRO optax tree:
    the whole flat vectors, which :func:`place_zero_state` then cuts to
    this rank's part."""
    param = _slice_param(ts.optimizer)
    moments_at, _ = _optax_layout(config)
    moments = tree
    for key in moments_at.split("/"):
        moments = moments[key]
    state = {torch_key: torch.as_tensor(np.asarray(moments[field]), dtype=torch.float32,
                                        device=param.device)
             for field, torch_key in _MOMENTS[config.optimizer]}
    if config.optimizer == "adam":
        state["step"] = torch.tensor(float(np.asarray(moments[".count"])))
    ts.optimizer.state[param] = state

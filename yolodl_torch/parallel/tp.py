"""Tensor (channel) parallelism on a 2-D ``data × model`` mesh, and TP × ZeRO-1.

Counterpart of ``yolodl_tpu/parallel/tp.py``.  The reference annotates the
parameters, the optimizer state and the EMA with channel shardings and
compiles the single-device step under GSPMD, which inserts every
collective and keeps global-array semantics (:16-26).  Here the same step
is written out by hand, one process per rank of a ``parallel/mesh.py``
:class:`TPMesh`, and its numbers are the single-device step's:

- **The leaf rule** (:func:`leaf_spec`, the reference's ``_leaf_spec`` :74
  in the port's layouts): a conv kernel ``[O, I, k, k]``, a dense weight
  ``[out, in]`` and every per-channel vector ``[O]`` (bias, BN scale, bias,
  mean and var, and their moments and EMA) are cut on O when ``O % n_model
  == 0`` and ``O >= n_model``; anything else stays replicated.  It is
  applied per layer (every leaf of a layer shares O) to ConvBn2D, Conv2D,
  DeconvBn2D, the sub-convs of DarkCsp2D and SppCsp2D, and Linear.  A
  grouped conv is cut only when its groups divide over the model axis
  (each rank then holds whole groups); the recurrent kinds stay
  replicated.
- **A sharded layer** runs Megatron's f/g on rank (d, m): ``copy_to_model``
  of the full input (its backward sums the partial input gradients over
  the model axis), the conv or dense product with the local weight, BN on
  the local channels, the activation in the layer's order, then
  ``gather_channels`` (all-gather; its backward keeps this rank's slice).
  Everything after it (route, shortcut, pooling, upsampling, the heads)
  runs replicated on full tensors (:class:`LayerShard`).
- **The data axis.**  Every train-mode BN averages its statistics over the
  data axis (``ops/norm.py`` ``batch_norm_apply_sync``); the head outputs
  and the targets are gathered over it before the loss
  (``gather_rows``), so the production or darknet loss, the matcher and
  the metrics are computed over the global batch on every rank; the
  gradients are then **summed** over the data axis (the loss is already
  the global one).  With ``accum > 1`` each micro-batch is a part of the
  global batch (:func:`shard_batch_tp`).
- **Clipping and maxima.**  The squared global norm sums the sharded
  gradients over the model axis and adds the replicated ones once; the
  ``weights_max``/``grads_max`` scalars of a sharded leaf are maxima over
  the model axis.  The optimizer, ``clamp_running_vars`` and the EMA then
  run on the local shards, in ``make_train_step``'s order.

**TP × ZeRO-1** (:func:`make_tp_zero_train_step`): on top of TP, each rank's
TP-shard gradient is reduce-scattered over the data axis (``zero.py``
:class:`FlatShard`): the rank updates ``1/n_data`` of it and all-gathers
it back.  The reference cuts each moment's input-channel axis instead
(``_zero_leaf_spec`` :146); one flat slice a rank gives the same numbers,
since the update is elementwise.

**State at the edges.**  :func:`place_tp_state` and
:func:`place_tp_zero_state` cut a full ``TrainState`` into this rank's
shards; :func:`gather_train_state` rebuilds the full one on rank 0 (every
rank joins), for checkpoints in the standard layout and for the
evaluation, which rank 0 runs on a full single-device model.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import newslab as cfg
from ..models.builder import YoloModel
from ..ops.norm import batch_norm_apply_sync
from ..train.loop import (StepHooks, TrainConfig, TrainState, _tree_name, make_optimizer,
                          make_train_step)
from .dp import _mean_over_ranks
from .mesh import TPMesh, copy_to_model, gather_channels, gather_rows
from .zero import FlatShard

# node kinds with a recurrent time loop: replicated, and their BN is per
# rank (ops/recurrent.py calls batch_norm_apply itself)
_RECURRENT = (cfg.DarknetRnn, cfg.DarknetGru, cfg.DarknetLstm, cfg.DarknetCrnn)


def leaf_spec(shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dimension a leaf of ``shape`` is cut on over a model axis of
    ``n_model`` ranks (0: a conv kernel's or dense weight's output channels,
    or a per-channel vector), or None when it stays replicated."""
    shape = tuple(shape)
    if len(shape) in (1, 2, 4) and shape[0] % n_model == 0 and shape[0] >= n_model:
        return 0
    return None


class LayerShard:
    """How one layer runs under tensor parallelism on this rank: cut on its
    output channels over ``mesh``'s model axis (``sharded``) or replicated;
    either way its train-mode BN averages over the data axis.  The layer's
    apply function (``ops/conv.py`` ``conv_bn_apply``) calls :meth:`enter`
    on its input, :meth:`batch_norm` for BN and :meth:`leave` on its
    output."""

    def __init__(self, mesh: TPMesh, sharded: bool):
        self.mesh, self.sharded = mesh, sharded

    def enter(self, x: torch.Tensor, groups: int):
        """(input, conv groups) of the local conv: the full input through
        ``copy_to_model``; a grouped conv reads its whole groups' input
        channels."""
        if not self.sharded:
            return x, groups
        x = copy_to_model(x, self.mesh.model)
        if groups > 1:
            part = x.shape[1] // self.mesh.n_model
            x = x.narrow(1, self.mesh.model_index * part, part)
            groups //= self.mesh.n_model
        return x, groups

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        return gather_channels(y, self.mesh.model) if self.sharded else y

    def batch_norm(self, params, state, x, train):
        return batch_norm_apply_sync(params, state, x, train, self.mesh.data)


def _tp_layers(model: YoloModel):
    """(module, conv groups) of every layer the leaf rule may cut, in graph
    order."""
    for key in model.graph.order:
        layer = model.graph.nodes[key].config
        if isinstance(layer, (cfg.ConvBn2D, cfg.Conv2D, cfg.DeconvBn2D)):
            yield model._node(key), layer.g
        elif isinstance(layer, (cfg.DarkCsp2D, cfg.SppCsp2D)):
            for sub in model._node(key).values():
                yield sub, 1
        elif isinstance(layer, cfg.Linear):
            yield model._node(key), 1


def _is_cut(module, groups: int, n_model: int) -> bool:
    return (leaf_spec(module.w.shape, n_model) == 0
            and (groups == 1 or groups % n_model == 0))


def tp_shardings(mesh, model: YoloModel) -> Dict[str, Optional[int]]:
    """The plan of the leaf rule for ``model`` on ``mesh`` (whose
    ``n_model`` is read): every ``state_dict`` key → the dimension its
    tensor is cut on (0), or None when it stays replicated."""
    cut = set()
    for module, groups in _tp_layers(model):
        if _is_cut(module, groups, mesh.n_model):
            cut.update(id(t) for t in (*module.parameters(), *module.buffers()))
    return {k: (0 if id(v) in cut else None)
            for k, v in model.state_dict(keep_vars=True).items()}


def _cut(t: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    part = t.shape[0] // mesh.n_model
    return t.narrow(0, mesh.model_index * part, part).clone()


@torch.no_grad()
def shard_model(mesh: TPMesh, model: YoloModel) -> List[str]:
    """Cut ``model``'s parameters and BN statistics to this rank's output
    channels per :func:`tp_shardings`, and give every layer its
    :class:`LayerShard` → the ``state_dict`` keys that were cut.  Raises
    when the data axis has several ranks and a recurrent layer normalizes
    (its BN would keep per-rank statistics)."""
    if mesh.n_data > 1:
        for key in model.graph.order:
            layer = model.graph.nodes[key].config
            if isinstance(layer, _RECURRENT) and layer.bn:
                raise ValueError(
                    f"tensor parallelism over {mesh.n_data} data ranks: the recurrent "
                    f"layer {model._pname[key]} normalizes per rank (its BN statistics "
                    "are not synchronized); use one data rank")
    plan = tp_shardings(mesh, model)
    for module, groups in _tp_layers(model):
        module.shard = LayerShard(mesh, _is_cut(module, groups, mesh.n_model))
    tensors = model.state_dict(keep_vars=True)
    for key, dim in plan.items():
        if dim is not None:
            t = tensors[key]
            t.data = _cut(t.data, mesh)
            if t.grad is not None:
                t.grad = torch.zeros_like(t)
    return [k for k, dim in plan.items() if dim is not None]


@torch.no_grad()
def place_tp_state(mesh: TPMesh, ts: TrainState) -> TrainState:
    """Cut a full TrainState (the same on every rank) into this rank's
    shards, in place: parameters, BN statistics, the optimizer's moments
    and the EMA of every layer the rule cuts."""
    model = ts.model
    full = {k: v.shape for k, v in model.state_dict().items()}
    cut = set(shard_model(mesh, model))
    for name, p in model.named_parameters():
        if name not in cut:
            continue
        state = ts.optimizer.state.get(p, {})
        for key, value in state.items():
            if isinstance(value, torch.Tensor) and value.shape == full[name]:
                state[key] = _cut(value, mesh)
        if ts.ema_params is not None:
            ts.ema_params[name] = _cut(ts.ema_params[name], mesh)
    return ts


def shard_batch_tp(mesh: TPMesh, batch: Any, accum: int = 1) -> Any:
    """This rank's rows of a global batch: for each of ``accum``
    micro-batches of ``b / accum`` rows, the ``data_index``-th of
    ``n_data`` equal parts of it, so that the step's micro-batch ``i`` is
    the ``i``-th part of the global batch on every data rank (the
    reference splits the global batch into micro-batches).  The ranks of
    one model group get the same rows."""
    rows = batch[0].shape[0]
    if rows % (mesh.n_data * accum):
        raise ValueError(f"batch {rows} is not divisible by {mesh.n_data} data ranks x "
                         f"{accum} micro-batches")
    mb, part = rows // accum, rows // accum // mesh.n_data
    starts = [i * mb + mesh.data_index * part for i in range(accum)]
    return tuple(torch.cat([x[s:s + part] for s in starts]) if accum > 1
                 else x[starts[0]:starts[0] + part] for x in batch)


def check_model_group_batch(mesh: TPMesh, batch: Any) -> None:
    """Raise unless every rank of this rank's model group holds the same
    batch (a sha256 over its arrays' bytes): they compute one data rank's
    part of the step and must stream the same records."""
    h = hashlib.sha256()
    for x in batch:
        h.update(np.ascontiguousarray(torch.as_tensor(x).detach().cpu().numpy()).tobytes())
    mine = torch.tensor(np.frombuffer(h.digest(), dtype=np.int64).copy())
    every = mesh.model.all_gather(mine).view(mesh.n_model, -1)
    if not bool((every == every[0]).all()):
        raise RuntimeError(
            f"tensor parallel: the {mesh.n_model} ranks of data index {mesh.data_index} "
            "hold different batches; they must stream the same records (an ordered "
            "pipeline with the same seed)")


class TPHooks(StepHooks):
    """The tensor-parallel step's changes to ``make_train_step`` (see the
    module's doc)."""

    def __init__(self, mesh: TPMesh, model: YoloModel):
        self.mesh, self.model = mesh, model
        cut = {id(t) for t in _cut_tensors(model)}
        self.flags = [id(p) in cut for p in model.parameters()]
        self.cut_names = {_tree_name(n) for n, p in model.named_parameters() if id(p) in cut}

    def gather(self, outputs, gt_boxes, gt_classes, gt_mask):
        axis = self.mesh.data
        if axis.world_size == 1:
            return outputs, gt_boxes, gt_classes, gt_mask
        if isinstance(outputs, tuple):
            outputs = tuple(gather_rows(t, axis) for t in outputs)
        else:
            outputs = dataclasses.replace(outputs, **{
                f.name: gather_rows(getattr(outputs, f.name), axis)
                for f in dataclasses.fields(outputs)
                if isinstance(getattr(outputs, f.name), torch.Tensor)})
        mask = axis.all_gather(gt_mask.to(torch.uint8)).to(torch.bool)
        return outputs, axis.all_gather(gt_boxes), axis.all_gather(gt_classes), mask

    def reduce(self, metrics: dict) -> dict:
        _mean_over_ranks(self.mesh.data, [p.grad for p in self.model.parameters()],
                         divide=False)
        return metrics

    def _split_sq(self, sq_cut: torch.Tensor, sq_rest: torch.Tensor) -> torch.Tensor:
        return self.mesh.model.all_reduce_(sq_cut) + sq_rest

    def grad_sq_norm(self, grads) -> torch.Tensor:
        """``grads`` are the model's, in ``parameters()`` order."""
        zero = torch.zeros((), device=grads[0].device)
        cut = sum((torch.sum(torch.square(g)) for g, f in zip(grads, self.flags) if f), zero)
        rest = sum((torch.sum(torch.square(g)) for g, f in zip(grads, self.flags) if not f), zero)
        return self._split_sq(cut.reshape(1), rest)[0]

    def maxima(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = [k for k in values if k.split("/", 1)[1] in self.cut_names]
        if keys and self.mesh.n_model > 1:
            stacked = self.mesh.model.all_reduce_(torch.stack([values[k] for k in keys]), "max")
            values = {**values, **dict(zip(keys, stacked))}
        return values


def make_tp_train_step(
    model: YoloModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    mesh: TPMesh,
    data_format: str = "NCHW",
    accum: int = 1,
) -> Callable:
    """Channel-sharded (× data-parallel) train step: (TrainState, this
    rank's rows, boxes, classes, mask) → (TrainState, metrics), with the
    state placed by :func:`place_tp_state` and the rows by
    :func:`shard_batch_tp`.  Its numbers are the single-device step's on
    the global batch (global-batch BN, the loss and matcher over the
    global batch); the metrics are the global ones on every rank."""
    return make_train_step(model, optimizer, config, data_format, accum,
                           hooks=TPHooks(mesh, model))


def tp_zero_shardings(mesh: TPMesh, model: YoloModel):
    """(the TP plan of :func:`tp_shardings`, (padded, per_shard) of each
    rank's flat optimizer slice over the data axis): the layout of
    :func:`place_tp_zero_state`.  Call it on the full model."""
    plan = tp_shardings(mesh, model)
    sizes = [p.numel() // (mesh.n_model if plan[n] is not None else 1)
             for n, p in model.named_parameters()]
    total = sum(sizes)
    per_shard = -(-total // mesh.n_data)
    return plan, (per_shard * mesh.n_data, per_shard)


@torch.no_grad()
def place_tp_zero_state(mesh: TPMesh, ts: TrainState, config: TrainConfig) -> TrainState:
    """:func:`place_tp_state`, then the optimizer replaced by one over this
    rank's flat slice of its TP shards over the data axis (``config``
    builds it; the reference keeps its optax transform), with this rank's
    slice of the cut moments."""
    place_tp_state(mesh, ts)
    shard = FlatShard(ts.model, mesh.data)
    optimizer = make_optimizer(config, [shard.param])
    states = [ts.optimizer.state.get(p, {}) for p in shard.params]
    keys = {k for s in states for k, v in s.items() if isinstance(v, torch.Tensor) and v.dim()}
    new = {}
    for key in sorted(keys):
        flat = shard.flat([s.get(key, torch.zeros_like(p)) for s, p in zip(states, shard.params)])
        new[key] = shard.local(flat).clone()
    if new and "step" in states[0]:
        new["step"] = states[0]["step"].clone()
    if new:
        optimizer.state[shard.param] = new
    ts.optimizer = optimizer
    return ts


class TPZeroHooks(TPHooks):
    """TP × ZeRO-1: the TP step, with the update of ``zero.py``'s
    :class:`ZeroHooks` over the data axis.  The gradient is summed over the
    data axis by the reduce-scatter itself; ``reduce`` sums it in place
    only for ``log_weights_and_grads`` (the ``grads_max`` scalars read it),
    and the scatter then takes the mean of the identical copies."""

    def __init__(self, mesh: TPMesh, model: YoloModel, shard: FlatShard, config: TrainConfig):
        super().__init__(mesh, model)
        self.shard, self.summed = shard, config.log_weights_and_grads
        self.mask = shard.mask({id(t) for t in _cut_tensors(model)})

    def reduce(self, metrics: dict) -> dict:
        return super().reduce(metrics) if self.summed else metrics

    def grad_sq_norm(self, grads) -> torch.Tensor:
        """``grads`` is this rank's slice's gradient."""
        (g,) = grads
        sq = torch.square(g)
        both = torch.stack([torch.sum(sq[self.mask]), torch.sum(sq[~self.mask])])
        both = self.mesh.data.all_reduce_(both)
        return self._split_sq(both[:1], both[1])[0]

    def update(self, optimizer, params, config, lr) -> None:
        self.shard.load()
        self.shard.scatter(1.0 / self.mesh.n_data if self.summed else 1.0)
        StepHooks.update(self, optimizer, [self.shard.param], config, lr)
        self.shard.gather()


def make_tp_zero_train_step(
    model: YoloModel,
    optimizer: torch.optim.Optimizer,
    config: TrainConfig,
    mesh: TPMesh,
    data_format: str = "NCHW",
    accum: int = 1,
) -> Callable:
    """TP × ZeRO-1 train step (the optimizer of :func:`place_tp_zero_state`,
    ``ts.optimizer``): :func:`make_tp_train_step`'s numbers, with each
    rank's optimizer state ``1/(n_data · n_model)`` of the full one."""
    (param,) = optimizer.param_groups[0]["params"]
    shard = FlatShard(model, mesh.data, param)
    return make_train_step(model, optimizer, config, data_format, accum,
                           hooks=TPZeroHooks(mesh, model, shard, config))


def make_tp_infer(model: YoloModel, mesh: TPMesh, data_format: str = "NCHW") -> Callable:
    """``images`` (this rank's rows, see :func:`shard_batch_tp`) →
    MergedDetection of those rows, eval mode, with ``model`` cut by
    :func:`shard_model` or :func:`place_tp_state`.  Every rank of a model
    group calls it with the same rows."""
    del mesh  # the model's LayerShards hold it

    @torch.no_grad()
    def infer(images):
        return model(images, data_format, train=False)

    return infer


def _gather_cut(mesh: TPMesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The full tensors of cut ones (f32, on dim 0), one all-gather over
    the model axis."""
    if not tensors:
        return []
    n = mesh.n_model
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    every = mesh.model.all_gather(flat).view(n, -1)
    out, offset = [], 0
    for t in tensors:
        k = t.numel()
        out.append(every[:, offset:offset + k].reshape(n * t.shape[0], *t.shape[1:]))
        offset += k
    return out


@torch.no_grad()
def gather_train_state(mesh: TPMesh, ts: TrainState, config: TrainConfig,
                       into: Optional[TrainState] = None) -> Optional[TrainState]:
    """The full TrainState of a TP (or TP × ZeRO-1) one, on rank 0: every
    rank joins the gathers (over the model axis, and for TP × ZeRO-1 the
    optimizer's slices over the data axis first).  Rank 0 gets ``into``
    filled (its model and optimizer single-device ones of the same graph),
    or a new model and optimizer when it is None; the others get None."""
    model, opt = ts.model, ts.optimizer
    ids = {id(t) for t in _cut_tensors(model)}
    cut = {k for k, v in model.state_dict(keep_vars=True).items() if id(v) in ids}
    named = dict(model.named_parameters())
    params = list(named.values())
    moments = {}  # torch state key → {name: local moment}
    step = None
    slice_opt = len(opt.param_groups[0]["params"]) == 1 and \
        opt.param_groups[0]["params"][0] is not params[0]
    if slice_opt:
        (param,) = opt.param_groups[0]["params"]
        shard = FlatShard(model, mesh.data, param)
        state = opt.state.get(param, {})
        for key, value in sorted(state.items()):
            if isinstance(value, torch.Tensor) and value.dim():
                whole = mesh.data.all_gather(value.detach())
                moments[key] = dict(zip(shard.names, shard.split(whole)))
        step = state.get("step")
    else:
        for name, p in named.items():
            for key, value in opt.state.get(p, {}).items():
                if isinstance(value, torch.Tensor) and value.dim():
                    moments.setdefault(key, {})[name] = value
                elif key == "step":
                    step = value
    local = dict(model.state_dict())
    entries = [("sd", k, v) for k, v in local.items()]
    entries += [("opt/" + key, n, v) for key, per in sorted(moments.items())
                for n, v in per.items()]
    if ts.ema_params is not None:
        entries += [("ema", n, v) for n, v in ts.ema_params.items()]
    cut_entries = [e for e in entries if e[1] in cut]
    full_cut = dict(zip([(w, n) for w, n, _ in cut_entries],
                        _gather_cut(mesh, [v for _, _, v in cut_entries])))
    if not mesh.is_chief:
        return None
    whole = {(w, n): full_cut.get((w, n), v) for w, n, v in entries}
    if into is None:
        full_model = type(model)(model.graph, device=next(model.parameters()).device,
                                 remat="blocks" if model.remat else "off")
        into = TrainState(full_model, make_optimizer(config, list(full_model.parameters())))
    into.model.load_state_dict({k: whole[("sd", k)] for k in local})
    into.optimizer.state.clear()
    for name, p in into.model.named_parameters():
        state = {key: whole[("opt/" + key, name)].clone() for key in moments}
        if state and step is not None:
            state["step"] = step.clone()
        if state:
            into.optimizer.state[p] = state
    into.step = ts.step
    into.ema_params = (None if ts.ema_params is None else
                       {n: whole[("ema", n)].clone() for n in ts.ema_params})
    return into


def _cut_tensors(model: YoloModel):
    for module, _ in _tp_layers(model):
        if module.shard is not None and module.shard.sharded:
            yield from module.parameters()
            yield from module.buffers()

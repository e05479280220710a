"""Ranks, process groups and device lists for data parallelism.

Counterpart of ``yolodl_tpu/parallel/mesh.py``.  The reference is
single-controller: one process sees every device and ``shard_map`` runs one
SPMD program over a 1-D ``Mesh``.  The port runs one process per rank with
``torch.distributed``:

- ``initialize_multi_host`` (:21) becomes :func:`init_process_group`: join
  a group from the environment (``env://``, the variables torchrun sets)
  or from an explicit ``tcp://`` coordinator, rank and world size.
- ``make_mesh`` (:45) becomes :class:`DataMesh` (this rank, the world size,
  this rank's device, the group), given by :func:`make_mesh` once the group
  is joined.
- ``make_dp_shardings`` (:60) becomes :func:`replica_devices` and
  :class:`ModelReplicas`: inference keeps one process and one model
  replica per device.
- :func:`launch_ranks` starts the ranks of a MultiDevice run; the
  reference needs nothing of the kind.
- ``tp.py``'s ``make_tp_mesh`` (:54) becomes :func:`make_tp_mesh`, a
  :class:`TPMesh` of two axes over the joined group, each a
  :class:`DataMesh` on a group of its own; the collectives with a
  gradient that tensor parallelism and the synchronized batch norm need
  (:func:`copy_to_model`, :func:`gather_channels`, :func:`gather_rows`,
  :func:`all_reduce_mean`, and :func:`gather_rows_summed` for a
  recurrent node's rows) live here, beside ZeRO-1's reduce-scatter and
  all-gather (:meth:`DataMesh.reduce_scatter`, :meth:`DataMesh.all_gather`).
- ``spatial.py``'s ``make_space_mesh`` (:104) and ``spatial_model.py``'s
  ``make_data_space_mesh`` (:306) become :func:`make_space_mesh` and
  :func:`make_data_space_mesh`, a :class:`SpaceMesh` of a data and a space
  axis; the halo rows' point-to-point exchange between neighbouring space
  ranks (:func:`neighbour_exchange`, with its backward) and the height's
  gather (:func:`gather_height`, whose backward is a reduce-scatter) live
  here too.

**Backend.**  NCCL when every rank has a card of its own; gloo when the
ranks run on the CPU or share a card (NCCL refuses two ranks on one
device).  The group is first joined over gloo, the ranks exchange where
they run, and an NCCL group is made only if the rule says so.  The choice
is a rule, printed at start-up, not a fallback.  Under gloo a card's
tensors travel through host memory.

**Timeout.**  30 minutes for every collective: while rank 0 evaluates or
writes a checkpoint, the other ranks wait in their next collective.
"""

from __future__ import annotations

import copy
import contextlib
import dataclasses
import datetime
import json
import os
import re
import signal
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import torch

TIMEOUT = datetime.timedelta(minutes=30)
ERROR_FILE_ENV = "YDL_RANK_ERROR_FILE"
RENDEZVOUS_ENV = "YDL_RENDEZVOUS"


class RankFailed(RuntimeError):
    """A rank of a MultiDevice run exited with an error; the others were
    stopped."""


@dataclasses.dataclass
class DataMesh:
    """This process's place in a 1-D data-parallel group: its ``rank`` of
    ``world_size``, its ``device``, the ``backend`` and ``group`` its
    collectives run on, and the ``reason`` for that backend."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object
    reason: str
    # the members' ranks in the joined group, in this axis's order (None:
    # the joined group itself); point-to-point transfers address them
    members: Optional[List[int]] = None

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def global_rank(self, index: int) -> int:
        """The joined group's rank of this axis's member ``index``."""
        return index if self.members is None else self.members[index]

    def _wire(self, t: torch.Tensor):
        """``t`` on the device the backend takes (NCCL: the card; gloo: the
        host) → (wire tensor, whether it is a copy)."""
        where = self.device if self.backend == "nccl" else torch.device("cpu")
        if t.device == where:
            return t, False
        return t.to(where), True

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the ranks in place (``op`` sum or max)."""
        import torch.distributed as dist

        wire, copied = self._wire(t)
        dist.all_reduce(wire, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        if copied:
            t.copy_(wire)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        import torch.distributed as dist

        wire, copied = self._wire(t)
        dist.broadcast(wire, src=src, group=self.group)
        if copied:
            t.copy_(wire)
        return t

    def agree(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (an all-reduce
        MAX): the ranks stop at one step, and none waits in a collective
        the others never reach."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        return bool(self.all_reduce_(t, "max").item())

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all), concatenated along ``dim``
        in rank order, on ``t``'s device."""
        import torch.distributed as dist

        wire, _ = self._wire(t.contiguous())
        out = torch.empty((self.world_size * wire.shape[0],) + tuple(wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        dist.all_gather_into_tensor(out, wire, group=self.group)
        out = out.to(t.device)
        if dim == 0:
            return out
        shape = list(t.shape)
        shape[dim] *= self.world_size
        return out.view(self.world_size, *t.shape).movedim(0, dim).reshape(shape)

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's ``1/world_size`` part of the sum over the ranks of the
        flat ``flat`` (its length divisible by the world size), by the route
        :func:`reduce_scatter_route` names for the backend."""
        import torch.distributed as dist

        part = flat.shape[0] // self.world_size
        wire, _ = self._wire(flat.contiguous())
        if reduce_scatter_route(self.backend) == "reduce_scatter_tensor":
            out = torch.empty(part, dtype=wire.dtype, device=wire.device)
            dist.reduce_scatter_tensor(out, wire, group=self.group)
        else:
            wire = wire.clone()
            dist.all_reduce(wire, group=self.group)
            out = wire[self.rank * part:(self.rank + 1) * part]
        return out.to(flat.device)


# torch versions whose gloo backend has reduce_scatter_tensor (checked on
# 2.11 and 2.13 with f32 and bf16); NCCL has had it throughout
_GLOO_REDUCE_SCATTER_SINCE = (2, 11)


def reduce_scatter_route(backend: str) -> str:
    """How :meth:`DataMesh.reduce_scatter` reduces: ``reduce_scatter_tensor``
    on NCCL, and on gloo from torch 2.11; else ``all_reduce + slice`` (the
    whole sum on every rank, then this rank's part).  A rule on the backend
    and the version, printed at start-up, not a fallback on failure."""
    if backend == "nccl":
        return "reduce_scatter_tensor"
    version = tuple(int(x) for x in re.findall(r"\d+", torch.__version__)[:2])
    if version >= _GLOO_REDUCE_SCATTER_SINCE:
        return "reduce_scatter_tensor"
    return "all_reduce + slice"


@dataclasses.dataclass
class TPMesh:
    """This process's place on a 2-D ``data × model`` mesh (the reference's
    ``make_tp_mesh``): rank ``r`` has data index ``r // n_model`` and model
    index ``r % n_model``, so each data replica is one contiguous block of
    ranks.  ``data`` is this rank's data axis (the ``n_data`` ranks of its
    model index), ``model`` its model axis (the ``n_model`` ranks of its data
    index); each is a :class:`DataMesh` whose ``rank`` is this rank's index
    on that axis."""

    rank: int
    world_size: int
    n_data: int
    n_model: int
    device: torch.device
    backend: str
    reason: str
    data: DataMesh
    model: DataMesh

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


_MESH: Optional[DataMesh] = None
# every mesh made here: destroy_process_group drops their group handles
_MESHES: List[DataMesh] = []


def choose_backend(where: Sequence) -> tuple:
    """(backend, reason) for ranks at ``where``: one (host, device string)
    per rank."""
    devices = [torch.device(d) for _, d in where]
    if any(d.type != "cuda" for d in devices):
        return "gloo", "ranks run on the CPU"
    seen = {}
    for (host, _), d in zip(where, devices):
        if (host, d.index) in seen:
            return "gloo", f"ranks share {d}"
        seen[(host, d.index)] = True
    return "nccl", "each rank has a card of its own"


def init_process_group(device, init_method: str = "env://", rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> DataMesh:
    """Join the data-parallel group and return this rank's :class:`DataMesh`.

    ``init_method`` ``env://`` reads RANK and WORLD_SIZE, and meets the
    other ranks through the file that YDL_RENDEZVOUS names (``file://…``,
    set by :func:`launch_ranks`) or else at MASTER_ADDR and MASTER_PORT
    (torchrun's variables); ``tcp://host:port`` takes ``rank`` and
    ``world_size``.  ``device`` is this rank's device; a card becomes the
    process's current device.
    """
    global _MESH
    import torch.distributed as dist

    from .._device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if init_method == "env://" and os.environ.get(RENDEZVOUS_ENV):
        init_method = os.environ[RENDEZVOUS_ENV]
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kwargs = {} if rank is None else dict(rank=rank, world_size=world_size)
    dist.init_process_group("gloo", init_method=init_method, timeout=TIMEOUT, **kwargs)
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(), str(device)))
    backend, reason = choose_backend(where)
    group = dist.group.WORLD
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("every rank has a card of its own, but this PyTorch has no NCCL")
        group = dist.new_group(backend="nccl", timeout=TIMEOUT)
    _MESH = DataMesh(dist.get_rank(), dist.get_world_size(), device, backend, group, reason)
    _MESHES.append(_MESH)
    return _MESH


def destroy_process_group() -> None:
    """Leave the group :func:`init_process_group` joined, and drop every
    mesh's handle of its process groups, so that they are torn down here:
    a gloo group still referenced when the interpreter exits is torn down
    then, and that can abort the process ("terminate called without an
    active exception")."""
    global _MESH
    import gc

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    for mesh in _MESHES:
        mesh.group = None
    _MESHES.clear()
    _MESH = None
    gc.collect()


def make_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """The joined group's :class:`DataMesh`, checked to span ``n_devices``
    ranks; raises like the reference when fewer exist."""
    if _MESH is None:
        raise RuntimeError("make_mesh needs a process group: call init_process_group first")
    if n_devices is not None:
        if _MESH.world_size < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {_MESH.world_size} available")
        if _MESH.world_size > n_devices:
            raise ValueError(
                f"requested {n_devices} devices but the group has {_MESH.world_size} "
                "ranks; a rank is one device")
    return _MESH


def _axis(base: DataMesh, members: List[List[int]]) -> DataMesh:
    """One group per list of ranks, made by every rank in one order with
    the backend of the group's rule → this rank's, as a :class:`DataMesh`
    whose ``rank`` is this rank's index in its list."""
    import torch.distributed as dist

    mine = None
    for ranks in members:
        group = dist.new_group(ranks, backend=base.backend, timeout=TIMEOUT)
        if base.rank in ranks:
            mine = DataMesh(ranks.index(base.rank), len(ranks), base.device, base.backend,
                            group, base.reason, list(ranks))
    _MESHES.append(mine)
    return mine


def make_tp_mesh(n_data: int, n_model: int) -> TPMesh:
    """The joined group as an ``n_data × n_model`` :class:`TPMesh`; raises
    like the reference when the group has fewer ranks (a rank is one
    device, so it raises when it has more, too)."""
    base = make_mesh()
    need = n_data * n_model
    if base.world_size != need:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"have {base.world_size}")
    model = _axis(base, [list(range(d * n_model, (d + 1) * n_model)) for d in range(n_data)])
    data = _axis(base, [list(range(i, need, n_model)) for i in range(n_model)])
    return TPMesh(base.rank, base.world_size, n_data, n_model, base.device, base.backend,
                  base.reason, data, model)


def transfer_route(backend: str) -> str:
    """How a rank's tensors travel to another rank: a rule on the backend
    (NCCL keeps them on the card; gloo stages a card's through the host)."""
    if backend == "nccl":
        return "nccl, tensors on the card"
    return "gloo, staged through host memory"


@dataclasses.dataclass
class PPMesh:
    """This process's place in an ``n_stages × n_data`` pipeline (the
    reference's device grouping, ``pipeline.py:205``): rank ``r`` holds
    stage ``r // n_data`` at data index ``r % n_data``, so each stage's
    data group is one contiguous block of ranks.  ``data`` is that group as
    a :class:`DataMesh` (its ``rank`` is this rank's data index), the axis
    the synchronized batch norm and :func:`gather_rows` take; ``base`` is
    the whole group, whose backend carries the boundary tensors between
    stages (:func:`send_tensors`, :func:`recv_tensors`)."""

    n_stages: int
    n_data: int
    base: DataMesh
    data: DataMesh

    @property
    def rank(self) -> int:
        return self.base.rank

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def stage(self) -> int:
        return self.base.rank // self.n_data

    @property
    def data_index(self) -> int:
        return self.base.rank % self.n_data

    @property
    def is_chief(self) -> bool:
        return self.base.rank == 0

    def rank_of(self, stage: int) -> int:
        """The rank of ``stage`` at this rank's data index."""
        return stage * self.n_data + self.data_index

    @property
    def route(self) -> str:
        """How boundary tensors travel between stages, printed at start-up."""
        return transfer_route(self.base.backend)


def make_pp_mesh(n_stages: int, n_data: int = 1) -> PPMesh:
    """The joined group as an ``n_stages × n_data`` :class:`PPMesh`; raises
    like the reference when the group has fewer ranks (and, a rank being
    one device, when it has more)."""
    base = make_mesh()
    need = n_stages * n_data
    if base.world_size != need:
        raise ValueError(f"{n_stages} stages x dp={n_data} need {need} devices, "
                         f"have {base.world_size}")
    data = _axis(base, [list(range(s * n_data, (s + 1) * n_data)) for s in range(n_stages)])
    return PPMesh(n_stages, n_data, base, data)


@dataclasses.dataclass
class SpaceMesh:
    """This process's place on a 2-D ``data × space`` mesh (the reference's
    ``make_data_space_mesh``, ``spatial_model.py:306-313``): rank ``r`` has
    data index ``r // n_space`` and space index ``r % n_space``, so the
    height shards of one data replica are one contiguous block of ranks.
    ``space`` is this rank's space axis (the ``n_space`` ranks of its data
    index, in height order), ``data`` its data axis, ``base`` the whole
    group (both axes: the prefix's batch norm averages over it); each is a
    :class:`DataMesh` whose ``rank`` is this rank's index on it."""

    n_data: int
    n_space: int
    base: DataMesh
    data: DataMesh
    space: DataMesh

    @property
    def rank(self) -> int:
        return self.base.rank

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def data_index(self) -> int:
        return self.base.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.base.rank % self.n_space

    @property
    def is_chief(self) -> bool:
        return self.base.rank == 0

    @property
    def route(self) -> str:
        """How the halo rows and the gathered tensors travel, printed at
        start-up."""
        return transfer_route(self.base.backend)


def make_data_space_mesh(n_data: int, n_space: int) -> SpaceMesh:
    """The joined group as an ``n_data × n_space`` :class:`SpaceMesh`;
    raises like :func:`make_tp_mesh` when the group has another number of
    ranks (a rank is one device)."""
    base = make_mesh()
    need = n_data * n_space
    if base.world_size != need:
        raise ValueError(f"data x space mesh {n_data}x{n_space} needs {need} devices, "
                         f"have {base.world_size}")
    space = _axis(base, [list(range(d * n_space, (d + 1) * n_space)) for d in range(n_data)])
    data = _axis(base, [list(range(i, need, n_space)) for i in range(n_space)])
    mesh = SpaceMesh(n_data, n_space, base, data, space)
    if mesh.is_chief:
        print(f"spatial: mesh data={n_data} x space={n_space}, halo rows and gathered "
              f"tensors over {mesh.route} ({base.reason})", flush=True)
    return mesh


def make_space_mesh(n_devices: int) -> SpaceMesh:
    """The joined group as a space mesh of ``n_devices`` height shards (a
    :class:`SpaceMesh` with one data index); raises when the group has
    another number of ranks."""
    base = make_mesh()
    if base.world_size != n_devices:
        raise ValueError(f"space mesh of {n_devices} needs {n_devices} devices, "
                         f"have {base.world_size}")
    return make_data_space_mesh(1, n_devices)


def send_tensors(mesh: DataMesh, tensors: Sequence[torch.Tensor], dst: int) -> None:
    """Send ``tensors`` to rank ``dst`` of ``mesh``'s group, in order, and
    wait until they are sent: on the card under NCCL, through a host copy
    under gloo."""
    import torch.distributed as dist

    wires = [mesh._wire(t.detach().contiguous())[0] for t in tensors]
    for work in [dist.isend(w, dst, group=mesh.group) for w in wires]:
        work.wait()


def recv_tensors(mesh: DataMesh, specs: Sequence[tuple], src: int) -> List[torch.Tensor]:
    """Receive one tensor per ``(shape, dtype)`` of ``specs`` from rank
    ``src``, in order, into tensors allocated here → on ``mesh.device``."""
    import torch.distributed as dist

    where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    wires = [torch.empty(shape, dtype=dtype, device=where) for shape, dtype in specs]
    for work in [dist.irecv(w, src, group=mesh.group) for w in wires]:
        work.wait()
    return [w.to(mesh.device) for w in wires]


# -- collectives with a gradient, for the tensor-parallel step (parallel/tp.py)
# and the synchronized batch norm (ops/norm.py).  Each takes an axis (a
# DataMesh) and is the identity on an axis of one rank.

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.contiguous().clone()), None


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.part, ctx.index, ctx.dim = x.shape[dim], axis.rank, dim
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.part, ctx.part).contiguous(), None, None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_(x.clone()).div_(axis.world_size)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        return axis.all_reduce_(grad.contiguous().clone()).div_(axis.world_size), None


def _single(axis) -> bool:
    return axis is None or axis.world_size == 1


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's f: the identity forward; the backward sums the gradient
    over ``axis`` (each model rank's output slice gives only a partial
    gradient of the shared input)."""
    return x if _single(axis) else _CopyToModel.apply(x, axis)


def gather_channels(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's g: every rank's channels (dim 1) of ``x`` concatenated in
    rank order; the backward keeps this rank's slice of the gradient, with
    no sum (the code after it is replicated, so each rank's gradient is
    already the full one)."""
    return x if _single(axis) else _GatherAxis.apply(x, axis, 1)


def gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's rows (dim 0) of ``x`` concatenated in rank order; the
    backward keeps this rank's rows of the gradient, with no sum (the loss
    after it is computed whole on every rank)."""
    return x if _single(axis) else _GatherAxis.apply(x, axis, 0)


class _GatherRowsSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        part = axis.reduce_scatter(grad.contiguous().reshape(-1))
        return part.view(grad.shape[0] // axis.world_size, *grad.shape[1:]), None


def gather_rows_summed(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's rows (dim 0) of ``x`` concatenated in ``axis`` order,
    for code that runs on all the rows and then keeps this rank's block (a
    recurrent node's time loop over a micro-batch's global rows,
    ``parallel/tp.py`` :class:`SequenceShard`).  The backward is
    :func:`gather_height`'s rule on dim 0, a reduce-scatter: each rank's
    gradient of the gathered rows holds only what its own block of the
    output reads, so the sum over the axis is the whole gradient, and each
    rank gets its rows of it (:func:`gather_rows` would keep this rank's
    rows of its own partial gradient).  No mean follows, unlike the
    spatial tail: the gradients each data rank computes for the
    parameters, too, come from its own output rows only, and the
    tensor-parallel and pipeline steps already sum those over the data
    axis, so the total is exact."""
    return x if _single(axis) else _GatherRowsSummed.apply(x, axis)


def all_reduce_mean(x: torch.Tensor, axis) -> torch.Tensor:
    """The mean of ``x`` over ``axis``; the backward is the mean of the
    gradients (every rank's normalization reads the mean)."""
    return x if _single(axis) else _AllReduceMean.apply(x, axis)


def neighbour_exchange(axis: DataMesh, to_prev: Optional[torch.Tensor],
                       to_next: Optional[torch.Tensor]) -> tuple:
    """Send ``to_prev`` to member ``rank - 1`` of ``axis`` and ``to_next``
    to member ``rank + 1`` (None at the axis's ends, where no member is),
    and receive what those neighbours send this way → ``(from_prev,
    from_next)``, each of the shape of the tensors sent (None at the ends).
    Every send and receive is posted before any is waited on
    (``batch_isend_irecv``: one NCCL group, or gloo's pairs in flight), so
    two neighbours never wait on each other's send."""
    import torch.distributed as dist

    s, n = axis.rank, axis.world_size
    like = to_next if to_next is not None else to_prev
    where = axis.device if axis.backend == "nccl" else torch.device("cpu")
    ops, got = [], {}
    for side, index, out in (("prev", s - 1, to_prev), ("next", s + 1, to_next)):
        if not 0 <= index < n:
            continue
        peer = axis.global_rank(index)
        wire = axis._wire(out.detach().contiguous())[0]
        got[side] = torch.empty(like.shape, dtype=like.dtype, device=where)
        ops.append(dist.P2POp(dist.isend, wire, peer, axis.group))
        ops.append(dist.P2POp(dist.irecv, got[side], peer, axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(got[k].to(like.device) if k in got else None for k in ("prev", "next"))


class _HaloRows(torch.autograd.Function):
    """A height-sharded NCHW block (``spatial.py`` ``halo_exchange``) with
    ``halo`` rows of each neighbour on ``axis`` above and below it, and
    ``fill`` rows at the axis's ends."""

    @staticmethod
    def forward(ctx, x, halo, axis, fill):
        ctx.halo, ctx.axis = halo, axis
        s, n = axis.rank, axis.world_size
        from_prev, from_next = neighbour_exchange(
            axis, x[:, :, :halo] if s else None, x[:, :, -halo:] if s < n - 1 else None)
        edge = x.new_full(x[:, :, :halo].shape, fill)
        return torch.cat([edge if from_prev is None else from_prev, x,
                          edge if from_next is None else from_next], dim=2)

    @staticmethod
    def backward(ctx, grad):
        halo, axis = ctx.halo, ctx.axis
        s, n = axis.rank, axis.world_size
        # the gradient of each received halo goes back to the rank it came
        # from, which adds it to its boundary rows; the fill's is dropped
        back_prev, back_next = neighbour_exchange(
            axis, grad[:, :, :halo] if s else None, grad[:, :, -halo:] if s < n - 1 else None)
        out = grad[:, :, halo:-halo].clone()
        if back_prev is not None:
            out[:, :, :halo] += back_prev
        if back_next is not None:
            out[:, :, -halo:] += back_next
        return out, None, None, None


class _GatherHeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather(x, 2)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        rows = grad.movedim(2, 0)
        part = axis.reduce_scatter(rows.reshape(-1))
        return (part.view(rows.shape[0] // axis.world_size, *rows.shape[1:])
                .movedim(0, 2).contiguous(), None)


def gather_height(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's rows (dim 2) of ``x`` concatenated in ``axis`` order.
    The backward is a reduce-scatter: the sum over the axis of the ranks'
    gradients, this rank's rows of it.  Where the code after the gather
    runs whole on every rank of the axis, each rank's gradient of its rows
    is then ``world_size`` times their share, and a mean over the axis
    makes it exact (the reference's ``all_gather(tiled=True)`` and
    ``pmean``, ``spatial_model.py:370``, ``:385``)."""
    return x if _single(axis) else _GatherHeight.apply(x, axis)


def parse_device(spec, device="cuda") -> torch.device:
    """A config's device entry (``"cuda:1"``, ``"cuda(1)"``, ``1``, or a
    NonUniformMultiDevice ``{"device": …}``) as a torch device; every entry
    is the CPU when ``device`` (``--device``) is ``cpu``."""
    if isinstance(spec, dict):
        spec = spec.get("device", spec.get("name", 0))
    if isinstance(spec, (int, float)):
        parsed = torch.device("cuda", int(spec))
    else:
        text = str(spec).strip().lower()
        m = re.fullmatch(r"cuda(?:[:(](\d+)\)?)?", text)
        if m:
            parsed = torch.device("cuda", int(m.group(1) or 0))
        elif text == "cpu":
            parsed = torch.device("cpu")
        else:
            raise ValueError(f"device entry {spec!r}: expected cuda:N, cuda(N), N or cpu")
    return torch.device("cpu") if torch.device(device).type == "cpu" else parsed


def replica_devices(device="cuda", n: int = 1) -> List[torch.device]:
    """The devices of ``n`` inference replicas: ``n`` CPU replicas for
    ``"cpu"``; for ``"cuda"`` the cards ``cuda:0 … cuda:n-1`` (from the
    index, if one is given), raising when the machine has fewer.  A list
    names each replica's device itself, so that two replicas may share a
    card."""
    from .._device import resolve_device

    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
        if n not in (0, 1, len(devices)):
            raise ValueError(f"{len(devices)} devices listed for {n} replicas")
        return devices
    dev = resolve_device(device)
    n = max(int(n), 1)
    if dev.type == "cpu":
        return [dev] * n
    first = dev.index or 0
    available = torch.cuda.device_count()
    if first + n > available:
        raise ValueError(f"requested {n} devices but only {available - first} available")
    return [torch.device("cuda", first + i) for i in range(n)]


def device_guard(device: torch.device):
    """The card's context (the current device of this thread, where a
    kernel launched through ctypes runs); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ModelReplicas:
    """One copy of ``model`` per device, for inference in one process.

    :meth:`map` splits a batch into equal parts, one per replica, and runs
    ``fn(i, *part)`` for replica ``i`` (``models[i]`` on ``devices[i]``) in
    order from this thread, each under its card's context; on cards the
    work is queued asynchronously, so the devices overlap.  The first
    replica is ``model`` itself when it lives on the first device.
    """

    def __init__(self, model, devices: Sequence[torch.device]):
        self.devices = list(devices)
        first = next(model.parameters()).device
        self.models = []
        for i, d in enumerate(self.devices):
            same = i == 0 and first == d
            self.models.append(model if same else copy.deepcopy(model).to(d))
        self.source = model

    def __len__(self) -> int:
        return len(self.devices)

    @torch.no_grad()
    def refresh(self) -> None:
        """Copy the source model's parameters and buffers into every replica
        (the model may have trained since)."""
        state = self.source.state_dict()
        for m in self.models:
            if m is not self.source:
                m.load_state_dict(state)

    def map(self, fn, *batch) -> list:
        n = len(self.devices)
        rows = batch[0].shape[0]
        if rows % n:
            raise ValueError(f"batch {rows} not divisible by devices {n}")
        part = rows // n
        outs = []
        for i, d in enumerate(self.devices):
            with device_guard(d):
                outs.append(fn(i, *(x[i * part:(i + 1) * part] for x in batch)))
        return outs


def join_outputs(outs: list):
    """Per-replica outputs (dataclasses of batch-first tensors) → one, in
    order, on the host; a single output is returned as it is."""
    if len(outs) == 1:
        return outs[0]
    return dataclasses.replace(outs[0], **{
        f.name: torch.cat([getattr(o, f.name).to("cpu") for o in outs])
        for f in dataclasses.fields(outs[0])})


# -- MultiDevice: N ranks started by one parent process

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In a rank, before exec: SIGKILL when the parent dies (Linux), so that
    no rank outlives a parent that was killed."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except OSError:
        pass


def write_rank_error(message: str) -> bool:
    """In a rank started by :func:`launch_ranks`: hand the one-line error to
    the parent, which prints it once for the run.  False elsewhere."""
    path = os.environ.get(ERROR_FILE_ENV)
    if not path:
        return False
    with open(path, "w") as f:
        json.dump({"time": time.time(), "message": message}, f)
    return True


def launch_ranks(cmd: Sequence[str], world_size: int, env: Optional[dict] = None,
                 cwd: Optional[str] = None, timeout: Optional[float] = None,
                 poll_s: float = 0.05) -> int:
    """Run ``cmd`` as ranks 0 … world_size-1 of one group and wait for all.

    Each rank gets torchrun's RANK, WORLD_SIZE and LOCAL_RANK, and in
    YDL_RENDEZVOUS a rendezvous file of this launch (a port picked here
    could be taken by another process before rank 0 binds it), and runs in
    a session of its own: SIGINT and SIGTERM sent to this process are passed on to
    every rank, once each.  When a rank exits with an error, the others
    are killed and :class:`RankFailed` carries the first rank's error line;
    so it does when ``timeout`` seconds pass first.  Returns 0 when every
    rank exits 0; no rank is left running.
    """
    errors = tempfile.mkdtemp(prefix="ydl-ranks-")
    base = dict(os.environ if env is None else env)
    procs = []
    signals = []

    def forward(signum, frame):
        signals.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    for s in saved:
        signal.signal(s, forward)
    try:
        for rank in range(world_size):
            rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(world_size),
                            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
            rank_env[RENDEZVOUS_ENV] = "file://" + os.path.join(errors, "rendezvous")
            rank_env[ERROR_FILE_ENV] = os.path.join(errors, f"rank{rank}.json")
            procs.append(subprocess.Popen(list(cmd), env=rank_env, cwd=cwd,
                                          start_new_session=True,
                                          preexec_fn=_die_with_parent))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                break
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailed(f"the ranks did not finish within {timeout} s")
            time.sleep(poll_s)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if len(signals) > 1:
            raise KeyboardInterrupt
        raise RankFailed(_first_error(errors, failed, [p.returncode for p in procs]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for s, handler in saved.items():
            signal.signal(s, handler)
        for name in os.listdir(errors):
            os.unlink(os.path.join(errors, name))
        os.rmdir(errors)


def _first_error(errors: str, failed: List[int], codes: List[int]) -> str:
    """The error line of the rank that failed first (by the time it wrote
    it), else the exit code of the first rank seen failing."""
    written = []
    for name in os.listdir(errors):
        if not re.fullmatch(r"rank\d+\.json", name):  # the rendezvous file
            continue
        with open(os.path.join(errors, name)) as f:
            entry = json.load(f)
        written.append((entry["time"], int(name[4:-5]), entry["message"]))
    if written:
        _, rank, message = min(written)
        return f"rank {rank}: {message}"
    rank = failed[0]
    return f"rank {rank} exited with code {codes[rank]} (its traceback is above)"


def rank_environment() -> Optional[tuple]:
    """(rank, world size) when this process was started as a rank
    (torchrun's RANK and WORLD_SIZE), else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None

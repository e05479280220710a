"""Full-model spatially-sharded inference and training: the height over ranks.

Counterpart of ``yolodl_tpu/parallel/spatial_model.py``.  The reference
runs a whole detection graph with the image HEIGHT cut over the devices:
a planner finds the longest prefix of nodes that runs on height shards
exactly, the prefix runs inside ``shard_map`` with halo exchange, the live
tensors are ``all_gather``-ed along H where the prefix stops (by then the
network has downsampled 8-32×), and the stock model runs the tail from
them.  This is how inputs larger than one device holds (1216² satellite
tiles) are served: the memory-dominant high-resolution stages never exist
unsharded anywhere.  The reference trains the same way on a 2-D
``data × space`` mesh.

Here each shard is a rank of a ``parallel/mesh.py`` :class:`SpaceMesh`
(rank ``r``: data index ``r // n_space``, space index ``r % n_space``), and
the tensors are NCHW, so the height is dim 2:

- :func:`plan_spatial_prefix` is the reference's planner on the graph's
  static heights; :func:`_run_prefix` runs the sharded nodes on this
  rank's rows (convolutions and SPP max pools with their boundary rows from
  the neighbouring ranks, :func:`spatial.halo_exchange`; the usual
  padding in W only).
- The tail runs as one walk of the stock graph,
  ``GraphModel.forward(node_subset=<the nodes not sharded>,
  node_overrides=<the gathered cut tensors>)``: in eager PyTorch the prefix
  nodes would otherwise run again on the local rows (the reference's jit
  drops them as dead code) and write their BN statistics from them.

**The gradient through the gather** (the reference's rule).  The cut
tensors are gathered with ``mesh.py`` :func:`gather_height`, whose
backward is a reduce-scatter: each space rank receives the sum over the
space axis of the ranks' cotangents of its rows.  The tail's loss is
computed whole on every space rank, so those cotangents are ``n_space``
identical copies, and each rank's prefix gradient is ``n_space`` times its
rows' true share.  The step then averages every gradient over the space
axis, which makes the prefix's exact (the sum of the shares) and leaves
the tail's, identical over space, as they are; then over the data axis
(``spatial_model.py:370``, ``:385``).

**Batch norm.**  A prefix BN averages its statistics over both axes, the
whole group (``ops/norm.py`` ``batch_norm_apply_sync``; the shards are
equal, so the mean of the ranks' means is exact); a tail BN normalizes
with its data index's rows.  After the step the running buffers are
averaged over space, then over data (``:386-387``).

The step is ``train/loop.py``'s ``make_train_step`` with
:class:`SpatialHooks`: the spatial forward, then the reduction above, the
metrics reduced (``num_matched`` a sum over data of the mean over space,
every other metric a mean over both, ``:401-419``); the optimizer, the BN
variance clamp, the EMA and the ``log_weights_and_grads`` maxima are the
single-device step's.  As the reference's, the step always uses
``yolo_loss`` and has no accumulation; ``remat`` does not reach the prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch
import torch.nn.functional as F

from .. import activations
from ..config import newslab as cfg
from ..models.builder import YoloModel
from ..ops import simple
from ..ops.norm import batch_norm_apply, batch_norm_apply_sync
from ..train.loop import StepHooks, TrainConfig, make_train_step
from .dp import _mean_over_ranks, reduce_metrics
from .mesh import SpaceMesh, gather_height, make_data_space_mesh  # noqa: F401
from .spatial import SPACE_AXIS, halo_exchange  # noqa: F401

Tensor = torch.Tensor


# ----------------------------------------------------------------------
# planning


def _static_h(node) -> Optional[int]:
    out = node.output_shape
    if not out.is_tensor:
        return None
    dims = out.tensor_shape()
    if len(dims) != 4 or not dims[2].is_known:  # logical NCHW
        return None
    return dims[2].size


def _conv_shardable(layer: cfg.ConvBn2D, in_h: int, n: int) -> bool:
    if in_h % n:
        return False
    lh = in_h // n
    if layer.d != 1:
        return False
    # exact cases: "same"-family pad (k-1)//2 via halo, or zero padding
    # with k ≤ s (aligned non-overlapping windows; k > s pad 0 would lose
    # k−1 rows per shard boundary)
    pad_ok = (layer.padding == (layer.k - 1) // 2
              or (layer.padding == 0 and layer.k <= layer.s))
    return pad_ok and lh % layer.s == 0 and lh >= max(1, layer.padding)


def _pool_shardable(layer: cfg.MaxPool, in_h: int, n: int) -> bool:
    if in_h % n:
        return False
    lh = in_h // n
    tp = layer.total_padding if layer.total_padding is not None else 0
    if layer.maxpool_depth:
        return False
    if (layer.stride_y == layer.size == layer.stride_x and tp // 2 == 0
            and (layer.total_padding is not None or layer.padding == 0)
            and lh % layer.size == 0):
        # aligned non-overlapping windows; darknet's default tp=size−1
        # puts all padding at the hi edge (lo = tp//2 = 0), which only the
        # last shard can read — and on size-aligned heights it never does.
        # (torch-style symmetric `padding` would pad every shard edge.)
        return True
    if (layer.pool_kind == "max"
            and layer.stride_y == 1 and layer.stride_x == 1
            and layer.size % 2 == 1 and tp == layer.size - 1):
        # SPP window with symmetric halo (-inf fill is max-specific; an
        # avg pool here would need count-aware halos)
        return lh >= layer.size // 2
    return False


def plan_spatial_prefix(model, n_shards: int) -> Tuple[Set[int], List[int]]:
    """(sharded node keys, cut keys to gather) for ``n_shards`` height
    shards, from the graph's static heights (``model.graph``).

    A node is sharded when every input is sharded and the op is exact on
    height shards at the graph's static sizes.  Cut keys are sharded nodes
    consumed by any unsharded node.
    """
    graph = model.graph
    sharded: Set[int] = set()
    for key in graph.order:
        node = graph.nodes[key]
        layer = node.config
        ik = node.input_keys
        if isinstance(layer, cfg.Input):
            h = _static_h(node)
            if ik.kind == "placeholder" and h and h % n_shards == 0:
                sharded.add(key)
            continue
        in_keys = list(ik.iter_keys())
        if not in_keys or not all(k in sharded for k in in_keys):
            continue
        in_h = _static_h(graph.nodes[in_keys[0]])
        if in_h is None:
            continue
        ok = False
        if isinstance(layer, cfg.ConvBn2D):
            ok = _conv_shardable(layer, in_h, n_shards)
        elif isinstance(layer, cfg.MaxPool):
            ok = _pool_shardable(layer, in_h, n_shards)
        elif isinstance(layer, cfg.UpSample2D):
            if layer.stride is not None and layer.reverse:
                ok = (in_h // n_shards) % layer.stride == 0
            else:
                # nearest-upsample is local only for integral scales
                ok = float(layer.scale).is_integer() and layer.scale >= 1
        elif isinstance(layer, (cfg.Concat2D, cfg.Sum2D, cfg.DarknetRoute, cfg.DarknetSam,
                                cfg.DarknetShortcut)):
            # equal heights only (a shortcut adds only equal-H maps here)
            hs = {_static_h(graph.nodes[k]) for k in in_keys}
            ok = len(hs) == 1 and None not in hs
        if ok:
            sharded.add(key)

    consumers: Dict[int, List[int]] = {}
    for key in graph.order:
        for k2 in graph.nodes[key].input_keys.iter_keys():
            consumers.setdefault(k2, []).append(key)
    cut = [k for k in graph.order if k in sharded
           and any(c not in sharded for c in consumers.get(k, []))]
    return sharded, cut


# ----------------------------------------------------------------------
# sharded prefix execution


def _run_prefix(model: YoloModel, x_local: Tensor, sharded: Set[int], axis,
                train: bool = False, bn_group=None) -> Dict[int, Tensor]:
    """Execute the sharded prefix on this rank's rows ``x_local`` (NCHW)
    with the halo rows from its neighbours on ``axis`` (a space axis) →
    the node outputs.  In training mode each BN normalizes with statistics
    averaged over ``bn_group`` (so that sharded normalization equals the
    unsharded batch's) and writes its new running statistics into its
    buffers, as ``GraphModel.forward(train=True)`` does."""
    graph = model.graph
    outputs: Dict[int, Tensor] = {}

    def _bn(m, out):
        if train:
            out, bn_s = batch_norm_apply_sync(m.bn.params(), m.bn.state(), out, True, bn_group)
            m.write_state({"bn": bn_s})
            return out
        out, _ = batch_norm_apply(m.bn.params(), m.bn.state(), out, False)
        return out

    for key in graph.order:
        if key not in sharded:
            continue
        node = graph.nodes[key]
        layer = node.config
        ik = node.input_keys

        if isinstance(layer, cfg.Input):
            outputs[key] = x_local
        elif isinstance(layer, cfg.ConvBn2D):
            m = model._node(key)
            xe = halo_exchange(outputs[ik.single_key], layer.padding, axis, 0.0)
            out = F.conv2d(xe, m.w.to(xe.dtype), None, stride=layer.s,
                           padding=(0, layer.padding), groups=layer.g)
            if m.b is not None:
                out = out + m.b.to(out.dtype).view(1, -1, 1, 1)
            if layer.order == "act_bn":
                out = activations.apply(layer.act, out)
                if m.bn is not None:
                    out = _bn(m, out)
            else:
                if m.bn is not None:
                    out = _bn(m, out)
                out = activations.apply(layer.act, out)
            outputs[key] = out
        elif isinstance(layer, cfg.MaxPool):
            xin = outputs[ik.single_key]
            if layer.stride_y == layer.size:
                # aligned windows, lo pad 0 — per-shard == global
                outputs[key] = simple.max_pool2d(
                    xin, layer.size, layer.stride_y, layer.stride_x,
                    layer.padding, layer.total_padding, layer.pool_kind)
            else:  # stride-1 SPP window
                halo = layer.size // 2
                xe = halo_exchange(xin, halo, axis, float("-inf"))
                xe = F.pad(xe, (halo, halo, 0, 0), value=float("-inf"))
                outputs[key] = F.max_pool2d(xe, kernel_size=layer.size, stride=1)
        elif isinstance(layer, cfg.UpSample2D):
            xin = outputs[ik.single_key]
            if layer.stride is not None and layer.reverse:
                outputs[key] = simple.downsample2d(xin, layer.stride)
            else:
                outputs[key] = simple.upsample2d(xin, layer.scale)
        elif isinstance(layer, cfg.Concat2D):
            outputs[key] = simple.concat2d([outputs[k] for k in ik.iter_keys()])
        elif isinstance(layer, cfg.Sum2D):
            outputs[key] = simple.sum2d([outputs[k] for k in ik.iter_keys()])
        elif isinstance(layer, cfg.DarknetRoute):
            ins = [outputs[k] for k in ik.iter_keys()]
            ng = layer.num_groups
            if ng > 1:
                ins = [t[:, layer.group_id * (t.shape[1] // ng):
                          (layer.group_id + 1) * (t.shape[1] // ng)]
                       for t in ins]
            outputs[key] = ins[0] if len(ins) == 1 else simple.concat2d(ins)
        elif isinstance(layer, cfg.DarknetSam):
            a, b = (outputs[k] for k in ik.iter_keys())
            outputs[key] = a * b
        elif isinstance(layer, cfg.DarknetShortcut):
            ins = [outputs[k] for k in ik.iter_keys()]
            out = ins[0]
            for other in ins[1:]:
                # only the shared channel prefix is added
                c = min(out.shape[1], other.shape[1])
                if c < out.shape[1]:
                    out = torch.cat([out[:, :c] + other[:, :c], out[:, c:]], dim=1)
                else:
                    out = out + other[:, :c]
            outputs[key] = activations.apply(layer.act, out)
        else:  # pragma: no cover - the planner admits only the kinds above
            raise AssertionError(f"unplanned sharded op {type(layer)}")

        if key in model._sg_keys:
            # darknet stopbackward/onlyforward and training.freeze: the
            # stop-gradient GraphModel.forward puts at these nodes' outputs
            # (the gathered cut nodes skip its write site there)
            outputs[key] = outputs[key].detach()
    return outputs


def _tail(model: YoloModel, sharded: Set[int]) -> frozenset:
    return frozenset(k for k in model.graph.order if k not in sharded)


def _rows(x: Tensor, space) -> Tensor:
    """This rank's rows of the full NCHW ``x``: the ``space.rank``-th of
    ``space.world_size`` equal parts of the height."""
    h = x.shape[2]
    if h % space.world_size:
        raise ValueError(f"height {h} is not divisible by {space.world_size} shards")
    part = h // space.world_size
    return x[:, :, space.rank * part:(space.rank + 1) * part]


def make_spatial_infer(model: YoloModel, mesh: SpaceMesh) -> Callable:
    """``x_nchw`` (the full batch, the same on every rank) → the
    MergedDetection of the unsharded eval-mode forward, on every rank, with
    the height cut over ``mesh``'s space axis for the prefix of the
    network that admits exact halo execution."""
    n = mesh.n_space
    sharded, cut = plan_spatial_prefix(model, n)
    if not cut:
        raise ValueError("no shardable prefix (input height not divisible "
                         f"by {n}?)")
    tail = _tail(model, sharded)

    @torch.no_grad()
    def infer(x_nchw: Tensor):
        prefix = _run_prefix(model, _rows(x_nchw, mesh.space), sharded, mesh.space)
        gathered = {k: gather_height(prefix[k], mesh.space) for k in cut}
        return model(None, train=False, node_overrides=gathered, node_subset=tail)

    return infer


# ----------------------------------------------------------------------
# 2-D (data × space) training


def shard_batch_2d(mesh: SpaceMesh, batch: Any) -> Any:
    """This rank's part of a global ``(images_nchw, boxes, classes, mask)``
    batch: the images of its data index's rows (the ``data_index``-th of
    ``n_data`` equal parts of the batch) and its space index's part of their
    height; the targets of those rows only."""
    images, boxes, classes, mask = batch
    rows = images.shape[0]
    if rows % mesh.n_data:
        raise ValueError(f"batch {rows} is not divisible by {mesh.n_data} data ranks")
    part = rows // mesh.n_data
    lo = mesh.data_index * part

    def mine(x):
        return x[lo:lo + part]

    return (_rows(mine(images), mesh.space), mine(boxes), mine(classes), mine(mask))


class SpatialHooks(StepHooks):
    """The data × space step's changes to ``make_train_step`` (see the
    module's doc): the spatial forward, and the means over space, then
    data, of the gradients and the BN running statistics."""

    def __init__(self, mesh: SpaceMesh, model: YoloModel, sharded: Set[int], cut: List[int]):
        self.mesh, self.model, self.sharded, self.cut = mesh, model, sharded, cut
        self.tail = _tail(model, sharded)

    def forward(self, model, images, data_format, **kw):
        del data_format  # the step takes NCHW rows (shard_batch_2d)
        mesh = self.mesh
        prefix = _run_prefix(model, images, self.sharded, mesh.space, train=True,
                             bn_group=mesh.base)
        gathered = {k: gather_height(prefix[k], mesh.space) for k in self.cut}
        return model(None, train=True, node_overrides=gathered, node_subset=self.tail, **kw)

    def reduce(self, metrics: dict) -> dict:
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        buffers = [b for b in self.model.buffers() if b.is_floating_point()]
        for axis in (self.mesh.space, self.mesh.data):
            _mean_over_ranks(axis, grads)
            _mean_over_ranks(axis, buffers)
        # every metric a mean over space (the copies agree), then
        # num_matched summed and the rest averaged over data
        keys = sorted(metrics)
        stacked = torch.stack([metrics[k].to(torch.float64).reshape(()) for k in keys])
        stacked = self.mesh.space.all_reduce_(stacked) / self.mesh.n_space
        return reduce_metrics(self.mesh.data, {k: stacked[i].to(metrics[k].dtype)
                                               for i, k in enumerate(keys)})


def make_spatial_train_step(model: YoloModel, optimizer: torch.optim.Optimizer,
                            config: TrainConfig, mesh: SpaceMesh) -> Callable:
    """Train step over a 2-D ``data × space`` mesh: the batch data-parallel
    AND the image height spatially sharded: (TrainState, this rank's images,
    boxes, classes, mask) → (TrainState, metrics), the inputs cut by
    :func:`shard_batch_2d` and the state the same on every rank
    (``dp.py`` ``replicate_state``).  Raises for a darknet-loss config: the
    reference's step always runs ``yolo_loss``."""
    if config.darknet_loss is not None:
        raise ValueError("the spatial train step runs yolo_loss; darknet_loss is not supported")
    sharded, cut = plan_spatial_prefix(model, mesh.n_space)
    if not cut:
        raise ValueError("no shardable prefix for this mesh/input size")
    config = dataclasses.replace(config, return_obj_sample=False)
    return make_train_step(model, optimizer, config,
                           hooks=SpatialHooks(mesh, model, sharded, cut))

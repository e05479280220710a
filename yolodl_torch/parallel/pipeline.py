"""Pipeline (stage) parallelism: GPipe over one process per rank.

Counterpart of ``yolodl_tpu/parallel/pipeline.py``.  The planner
(``_node_cost``, ``StagePlan``, :func:`plan_stages`) is the reference's, and
``tool_main info --pipeline-stages`` prints its plan.  The reference runs
every stage from one controller, each a jitted program pinned to its device
group, and lets asynchronous dispatch form the wavefront.  The port runs
one process per rank on a ``parallel/mesh.py`` :class:`PPMesh`: rank ``r``
holds stage ``s = r // dp`` at data index ``d = r % dp``, and once
:class:`PipelineModel` has cut the model, only stage ``s``'s parameters,
BN statistics and optimizer state.  The boundary tensors (``StagePlan``
``in_keys``/``out_keys``) travel between the ranks of one data index by
point-to-point sends: on the card under NCCL, staged through host memory
under gloo (:func:`mesh.send_tensors`).

A receiver allocates each boundary tensor from static shapes: the graph's
shape of the key at the step's input size (``Graph.shapes_at``), the
micro-batch's rows on this data index and the compute dtype.  The sender
checks its tensors against the same shapes and raises naming the key.

**The order of one step's transfers** (every rank runs exactly these, in
this order; ``M`` micro-batches, ``S`` stages, all at data index ``d``):

1. *Targets.*  Stage 0 sends the layout (shapes and dtypes) of its rows'
   boxes, classes and mask, then the tensors, to stage ``S-1``, which
   receives the layout, raises naming the target that differs from the
   shapes its own arguments give, and receives the tensors.
2. *Forward wavefront*, for ``m = 0 … M-1``: stage ``s > 0`` receives the
   ``in_keys`` of micro-batch ``m`` from stage ``s-1``; stage ``s < S-1``
   sends its ``out_keys`` to stage ``s+1``.
3. *Backward wavefront*, for ``m = 0 … M-1``: stage ``S-1`` sends the
   gradients of its ``in_keys`` to stage ``S-2``; a middle stage receives
   the gradients of its ``out_keys`` and sends those of its ``in_keys``;
   stage 0 receives.
4. *Metrics.*  Stage ``S-1`` of data index 0 sends its metrics to rank 0
   (one pickled dict over the gloo group); with ``log_weights_and_grads``
   every other stage of data index 0 sends its ``weights_max``/``grads_max``
   scalars too.

Between any two ranks the transfers thus run in one order on both sides,
and none waits on a transfer that the other posts later: the last stage
keeps the gradients it computes in phase 2 until phase 3.

**The GPipe step** (:class:`PipelineTrainStep`, the reference's :514-605):
in phase 2 a stage keeps each micro-batch's received inputs (no graph) and
a copy of its BN statistics before the micro-batch, and runs its forward
under ``no_grad``; the last stage runs forward, ``yolo_loss`` and backward
at once.  In phase 3 a stage puts back the statistics as they were before
``m``, recomputes its forward from the kept inputs, backpropagates the
received gradients and puts back the statistics after the last
micro-batch: the recompute does not update them a second time (the
reference drops its ``new_state``).  Only the boundary tensors live per
micro-batch in flight.  Then each stage divides its summed gradients by
``M``, sums them over its data group, and updates its parameters at the
scheduled lr, then clamps its BN variances.

**Data parallel within a stage** (``dp > 1``): every train-mode BN of the
stage averages its statistics over the stage's data group
(``tp.LayerShard``, ``ops/norm.py`` ``batch_norm_apply_sync``), the last
stage gathers the head outputs and targets over it and computes the loss
whole (``tp.gather_batch``), so the numbers are the single-device
accumulation step's on the global batch; micro-batch ``m`` of data index
``d`` is the ``d``-th part of the global rows of ``m``
(``tp.shard_batch_tp``).  A recurrent node of the stage runs its time loop
over the global rows of the micro-batch (``tp.SequenceShard``): it gathers
them over the data group, and its sub-layers' BN does not average again.
That gather is a collective of the data group, which the forward
wavefront and the recompute both run (a recurrent node is not under
``remat="blocks"``'s checkpoint); the ranks of a group run the same
micro-batches in the same order, so they meet in it in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import newslab as cfg
from ..loss import yolo_loss
from ..models.builder import module_key
from ..train.loop import (StepHooks, TrainConfig, TrainState, _maxima, collect_step_metrics,
                          combine_micro_batches, param_maxima, train_init)
from ..train.lr_schedule import make_schedule_fn
from .dp import _mean_over_ranks
from .mesh import PPMesh, recv_tensors, send_tensors
from .tp import LayerShard, _tp_layers, gather_batch, shard_sequences


def _node_cost(model, key: int) -> float:
    """Rough per-node FLOP estimate for stage balancing (conv-dominated)."""
    node = model.graph.nodes[key]
    layer = node.config
    out = node.output_shape
    if not out.is_tensor:
        return 0.0
    dims = out.tensor_shape()
    known = [d.size for d in dims if d.is_known]
    elems = 1.0
    for v in known:
        elems *= v
    if len(dims) == 4 and all(d.is_known for d in list(dims)[1:]):
        c_out, h, w = dims[1].size, dims[2].size, dims[3].size
        in_c = model._in_c.get(key, c_out)
        if isinstance(layer, (cfg.ConvBn2D, cfg.Conv2D)):
            g = getattr(layer, "g", 1) or 1
            return 2.0 * h * w * c_out * in_c * layer.k * layer.k / g
        if isinstance(layer, cfg.DarkCsp2D):
            r = getattr(layer, "repeat", 1) or 1
            return h * w * c_out * c_out * (1.5 + 2.5 * r)
        if isinstance(layer, cfg.SppCsp2D):
            return 8.0 * h * w * c_out * c_out
        if isinstance(layer, cfg.DeconvBn2D):
            return 2.0 * h * w * c_out * in_c * layer.k * layer.k
    return elems  # elementwise-ish


@dataclasses.dataclass(frozen=True)
class StagePlan:
    keys: Tuple[int, ...]      # node keys executed by this stage
    in_keys: Tuple[int, ...]   # boundary tensors consumed (earlier stages)
    out_keys: Tuple[int, ...]  # boundary tensors produced/passed downstream
    cost: float                # planner FLOP estimate


def plan_stages(model, n_stages: int, max_cross: int = 4) -> List[StagePlan]:
    """Cut the topo order into ``n_stages`` contiguous, balanced stages.

    A cut position is feasible when every live value crossing it is a
    plain tensor (no Detect2D/MergeDetect2D structures) and at most
    ``max_cross`` tensors cross (skip links ride along as pass-through
    boundary tensors).  Among feasible cuts, dynamic programming picks
    the placement minimizing the maximum per-stage FLOP estimate.
    ``model`` is a ``GraphModel`` (its ``graph`` and ``_in_c``).
    """
    graph = model.graph
    order = list(graph.order)
    n = len(order)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    pos = {k: i for i, k in enumerate(order)}
    # last position each node's output is consumed at
    last_use = {k: pos[k] for k in order}
    for k in order:
        for src in graph.nodes[k].input_keys.iter_keys():
            last_use[src] = max(last_use[src], pos[k])

    def crossing(i: int) -> List[int]:
        return [k for k in order[:i] if last_use[k] >= i]

    feasible = []
    for i in range(1, n):
        cross = crossing(i)
        if len(cross) > max_cross:
            continue
        if all(graph.nodes[k].output_shape.is_tensor for k in cross):
            feasible.append(i)
    costs = [_node_cost(model, k) for k in order]
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    # DP over cut positions: best[s][p] = minimal max-stage-cost splitting
    # order[:p] into s stages, p ∈ {feasible cuts} ∪ {n}
    points = feasible + [n]
    best: List[Dict[int, Tuple[float, Optional[int]]]] = [
        {} for _ in range(n_stages + 1)
    ]
    best[0][0] = (0.0, None)
    for s in range(1, n_stages + 1):
        ends = points if s < n_stages else [n]
        for p in ends:
            cand = None
            for q, (v, _) in best[s - 1].items():
                if q >= p:
                    continue
                seg = prefix[p] - prefix[q]
                m = max(v, seg)
                if cand is None or m < cand[0]:
                    cand = (m, q)
            if cand is not None:
                best[s][p] = cand
    if n not in best[n_stages]:
        raise ValueError(
            f"graph admits no {n_stages}-stage split with <= {max_cross} "
            f"crossing tensors ({len(feasible)} feasible cut points)")
    cuts = []
    p = n
    for s in range(n_stages, 0, -1):
        _, q = best[s][p]
        cuts.append(p)
        p = q
    bounds = [0] + list(reversed(cuts))  # [0, c1, ..., n]

    plans = []
    for s in range(n_stages):
        a, b = bounds[s], bounds[s + 1]
        keys = tuple(order[a:b])
        in_keys = tuple(crossing(a)) if a else ()
        out_keys = tuple(crossing(b)) if b < n else ()
        plans.append(StagePlan(keys, in_keys, out_keys,
                               prefix[b] - prefix[a]))
    return plans


# ----------------------------------------------------------------------
# model


def _is_node_keyed(tree, names) -> bool:
    """A dict keyed by node paths (Adam's mu/nu, SGD's trace, params)."""
    return isinstance(tree, dict) and (not tree or set(tree) <= names)


def _filter_tree(tree, names, keep):
    """``tree`` with every node-keyed dict cut to the nodes of ``keep``."""
    if _is_node_keyed(tree, names):
        return {k: v for k, v in tree.items() if k in keep}
    if isinstance(tree, dict):
        return {k: _filter_tree(v, names, keep) for k, v in tree.items()}
    return tree


def _merge_trees(trees, names):
    """Per-stage trees → one: node-keyed dicts joined, any other leaf the
    first stage's (the stages advance such a leaf, e.g. the step count,
    alike)."""
    first = trees[0]
    if _is_node_keyed(first, names):
        return {k: v for t in trees for k, v in t.items()}
    if isinstance(first, dict):
        return {k: _merge_trees([t[k] for t in trees], names) for k in first}
    return first


class PipelineModel:
    """A GraphModel cut into ``mesh.n_stages`` stages, this rank's stage
    kept.

    Construction plans the stages on the whole graph (:func:`plan_stages`)
    and removes every other stage's nodes from ``model``, so that the rank
    holds only its stage's parameters and BN statistics.  Cut a model
    before it has optimizer state or a checkpoint is restored into it
    (:meth:`PipelineTrainStep.init_opt`): then only drawing the whole
    model's parameters, from the one seed, takes more than the stage.  With
    ``dp > 1`` every layer of the stage normalizes over the stage's data
    group in training, and every recurrent node runs over the group's
    rows of the micro-batch.

    ``split_params``/``split_state``/``split_opt_state`` cut a tree in the
    reference's layout (``bridge.params_to_jax``, ``train.loop.
    optimizer_state_tree``) to this stage's nodes; :meth:`gather` brings
    each stage's trees to rank 0 (every rank calls it; the ranks of data
    index 0 contribute), where ``merge_params``/``merge_state``/
    ``merge_opt_state`` join them, so that checkpoints keep the
    single-device layout.
    """

    def __init__(self, model, mesh: PPMesh):
        self.model = model
        self.mesh = mesh
        self.n_stages, self.dp = mesh.n_stages, mesh.n_data
        self.stages = plan_stages(model, self.n_stages)
        self.plan = self.stages[mesh.stage]
        self._subset = frozenset(self.plan.keys)
        self._all_names = {model._pname[k] for k in model.graph.order}
        self._names = {model._pname[k] for k in self.plan.keys}
        self._shapes: Dict[Tuple[int, int], Dict] = {}
        keep = {module_key(n) for n in self._names}
        for key in [k for k in model.layers if k not in keep]:
            del model.layers[key]
        if self.dp > 1:
            shard = LayerShard(mesh, sharded=False)
            for module, _, recurrent in _tp_layers(model, self.plan.keys):
                # a recurrent sub-layer normalizes rows already gathered
                module.shard = None if recurrent else shard
            shard_sequences(model, mesh.data, self.plan.keys)

    @property
    def is_first(self) -> bool:
        return self.mesh.stage == 0

    @property
    def is_last(self) -> bool:
        return self.mesh.stage == self.n_stages - 1

    # -- parameter layout --------------------------------------------------

    def split_params(self, params: Dict) -> Dict:
        """A tree keyed by node paths → this stage's entries."""
        return {n: v for n, v in params.items() if n in self._names}

    split_state = split_params

    def split_opt_state(self, opt_state: Dict) -> Dict:
        """An optimizer state tree (``optimizer_state_tree``) → this stage's
        part: every node-keyed dict cut to the stage's nodes, any other
        leaf kept."""
        return _filter_tree(opt_state, self._all_names, self._names)

    def gather(self, trees) -> Optional[List]:
        """Each stage's ``trees`` on rank 0, in stage order, in one
        collective; None on the other ranks.  Only data index 0's count,
        so the other ranks may pass None."""
        import torch.distributed as dist

        every = [None] * self.mesh.base.world_size if self.mesh.is_chief else None
        dist.gather_object(trees if self.mesh.data_index == 0 else None, every, dst=0)
        if every is None:
            return None
        return [every[s * self.dp] for s in range(self.n_stages)]

    @staticmethod
    def merge_params(every: Sequence[Dict]) -> Dict:
        """The stages' trees keyed by node paths (:meth:`gather`) → one."""
        return {n: v for t in every for n, v in t.items()}

    merge_state = merge_params

    def merge_opt_state(self, every: Sequence[Dict]) -> Dict:
        """The stages' optimizer state trees (:meth:`gather`) → one."""
        return _merge_trees(list(every), self._all_names)

    # -- boundary tensors --------------------------------------------------

    def specs(self, keys: Sequence[int], rows: int, height: int, width: int,
              dtype: torch.dtype) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each boundary tensor of ``keys`` for ``rows``
        rows of an input of ``height × width``."""
        shapes = self._shapes.get((height, width))
        if shapes is None:
            graph = self.model.graph
            at = graph.shapes_at(1, height, width)
            shapes = self._shapes[(height, width)] = {
                k: tuple(d.size for d in at[k].tensor_shape())[1:]
                for p in self.stages for k in p.in_keys}
        return [((rows,) + shapes[k], dtype) for k in keys]

    def send(self, keys, tensors, specs, stage: int) -> None:
        """The boundary tensors of ``keys`` to ``stage`` at this data index,
        each checked against its spec."""
        for k, t, (shape, dtype) in zip(keys, tensors, specs):
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise RuntimeError(
                    f"pipeline: the boundary tensor {self.model._pname[k]} (node {k}) is "
                    f"{tuple(t.shape)} {t.dtype}; the plan gives {shape} {dtype}")
        send_tensors(self.mesh.base, tensors, self.mesh.rank_of(stage))

    def recv(self, specs, stage: int) -> List[torch.Tensor]:
        return recv_tensors(self.mesh.base, specs, self.mesh.rank_of(stage))

    # -- forward -----------------------------------------------------------

    def run(self, inputs: Sequence[torch.Tensor], x: Optional[torch.Tensor], train: bool):
        """This stage's forward from its boundary ``inputs`` (and the images
        ``x`` on stage 0) → its ``out_keys``' tensors, or the graph output
        on the last stage."""
        out = self.model(x, train=train, node_overrides=dict(zip(self.plan.in_keys, inputs)),
                         node_subset=self._subset,
                         output_keys=None if self.is_last else self.plan.out_keys)
        return out if self.is_last else [out[k] for k in self.plan.out_keys]

    @torch.no_grad()
    def forward(self, x: torch.Tensor, train: bool = False):
        """The pipelined forward of this data index's rows (the reference's
        ``apply``): ``x`` holds them on stage 0 and their shape elsewhere
        (a tensor on the ``meta`` device will do).  → the graph output on
        the last stage, None on the others.  ``train=True`` writes each
        stage's new BN statistics."""
        s, (h, w) = self.mesh.stage, x.shape[-2:]
        inputs = [] if self.is_first else self.recv(
            self.specs(self.plan.in_keys, x.shape[0], h, w, x.dtype), s - 1)
        out = self.run(inputs, x if self.is_first else None, train)
        if self.is_last:
            return out
        self.send(self.plan.out_keys, out,
                  self.specs(self.plan.out_keys, x.shape[0], h, w, x.dtype), s + 1)
        return None


@dataclasses.dataclass
class PipelineTrainState(TrainState):
    """The TrainState of this rank's stage: ``model`` holds only the
    stage's nodes and ``optimizer`` only their parameters (``train_init``
    of the model that :class:`PipelineModel` has cut; a checkpoint restored
    into it reads only the stage's tensors).  The reference's merged views
    (``params``, ``state``, ``opt_state``) gather from every stage, so here
    they are :meth:`merged`, which every rank calls."""

    def merged(self, pp: PipelineModel, config: TrainConfig) -> Optional[tuple]:
        """(params, state, optimizer state) trees of the whole model in the
        standard layout on rank 0, None elsewhere; every rank joins."""
        from ..bridge import params_to_jax
        from ..train.loop import optimizer_state_tree

        mine = None
        if pp.mesh.data_index == 0:
            mine = (*params_to_jax(self.model.state_dict()), optimizer_state_tree(self, config))
        every = pp.gather(mine)
        if every is None:
            return None
        params, state, opt = zip(*every)
        return pp.merge_params(params), pp.merge_state(state), pp.merge_opt_state(opt)


# ----------------------------------------------------------------------
# GPipe training

TARGETS = ("gt_boxes", "gt_classes", "gt_mask")
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


def _layout(tensors) -> torch.Tensor:
    """Each tensor's rank, dtype (an index of ``_DTYPES``, -1 for another)
    and shape, padded to 3 dims, as a row of an ``[n, 5]`` int64 tensor."""
    return torch.tensor([[t.dim(), _DTYPES.index(t.dtype) if t.dtype in _DTYPES else -1,
                          *(tuple(t.shape[:3]) + (0,) * (3 - min(t.dim(), 3)))]
                         for t in tensors], dtype=torch.int64)


def _described(row: torch.Tensor) -> str:
    rank, code, *dims = row.tolist()
    return f"{tuple(dims[:rank])} {_DTYPES[code] if 0 <= code < len(_DTYPES) else 'another dtype'}"


class PipelineTrainStep:
    """GPipe micro-batch training of this rank's stage (see the module's
    doc): one call is one optimizer step on a logical batch of ``n_micro``
    micro-batches, with the numbers of ``make_train_step(accum=n_micro)`` on
    the global batch.  ``clip_grad_norm`` needs a global norm across the
    stages and EMA is not supported; both are rejected, as in the
    reference.  No Dropout generator is taken (the reference passes no
    ``rng``): Dropout is the identity."""

    def __init__(self, pp: PipelineModel, config: TrainConfig, n_micro: int):
        if config.clip_grad_norm is not None:
            raise ValueError(
                "clip_grad_norm requires a cross-stage global norm and is "
                "not supported under pipeline parallelism")
        if config.use_ema:
            raise ValueError("EMA is not supported under pipeline "
                             "parallelism yet")
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        if config.darknet_loss is not None:
            raise ValueError("training.loss.impl Darknet does not support "
                             "pipeline_parallel")
        self.pp, self.config, self.n_micro = pp, config, n_micro
        self.schedule = make_schedule_fn(config.lr)
        self.dtype = (getattr(torch, config.compute_dtype)
                      if config.compute_dtype is not None else None)

    def init_opt(self) -> PipelineTrainState:
        """This stage's state at step 0: ``train_init`` of the cut model,
        so that the optimizer holds the stage's parameters only."""
        ts, _ = train_init(self.pp.model, self.config)
        return PipelineTrainState(model=ts.model, optimizer=ts.optimizer, step=0)

    def step_fn(self) -> Callable:
        """(PipelineTrainState, images, boxes, classes, mask) →
        (PipelineTrainState, metrics), the step counted: the train CLI's
        step interface."""

        def fn(ts, images, gt_boxes, gt_classes, gt_mask):
            metrics = self(ts, images, gt_boxes, gt_classes, gt_mask)
            ts.step += 1
            return ts, metrics

        return fn

    def _targets(self, gt_boxes, gt_classes, gt_mask):
        """Stage 0's targets of this data index on the last stage: sent by
        the one after their layout, received by the other into tensors of
        the shapes and dtypes its arguments give, once the layout agrees
        (else it raises, naming the target)."""
        pp, mesh = self.pp, self.pp.mesh
        targets = (gt_boxes, gt_classes, gt_mask)
        if pp.n_stages == 1:
            return targets
        if pp.is_first:
            send_tensors(mesh.base, [_layout(targets), *targets], mesh.rank_of(pp.n_stages - 1))
        elif pp.is_last:
            sent, = recv_tensors(mesh.base, [((len(targets), 5), torch.int64)], mesh.rank_of(0))
            for name, got, want in zip(TARGETS, sent.cpu(), _layout(targets)):
                if not torch.equal(got, want):
                    raise RuntimeError(f"pipeline: the target {name} from stage 0 is "
                                       f"{_described(got)}; this stage expects {_described(want)}")
            return tuple(recv_tensors(mesh.base, [(t.shape, t.dtype) for t in targets],
                                      mesh.rank_of(0)))
        return targets

    def __call__(self, ts: PipelineTrainState, images, gt_boxes, gt_classes,
                 gt_mask) -> Dict[str, torch.Tensor]:
        """One pipelined optimizer step, in place on ``ts``'s stage →
        metrics: on the last stage and on rank 0 (rank 0 gets the last
        stage's), with the ``*_max`` scalars of every stage on rank 0 under
        ``log_weights_and_grads``; ``{}`` or only the stage's own scalars on
        the other ranks.

        Each argument is this data index's rows of the global batch (the
        micro-batches one after another, ``tp.shard_batch_tp``); stage 0
        reads the images and the targets, the last stage the targets' shapes
        and every stage the images' shape (a ``meta`` tensor will do)."""
        pp, config, mesh = self.pp, self.config, self.pp.mesh
        model, M, s = pp.model, self.n_micro, mesh.stage
        batch = images.shape[0] * pp.dp
        if batch % M:
            raise ValueError(f"batch size {batch} not divisible by n_micro {M}")
        mb = batch // M
        if mb % pp.dp:
            raise ValueError(
                f"microbatch size {mb} not divisible by the per-stage "
                f"data-parallel degree dp={pp.dp}")
        rows, (h, w) = mb // pp.dp, images.shape[-2:]
        dtype = self.dtype or images.dtype
        if pp.is_first and self.dtype is not None:
            images = images.to(self.dtype)
        in_specs = pp.specs(pp.plan.in_keys, rows, h, w, dtype)
        out_specs = pp.specs(pp.plan.out_keys, rows, h, w, dtype)
        params = list(model.parameters())
        torch._foreach_zero_([p.grad for p in params if p.grad is not None])
        buffers = [b for b in model.buffers() if b.is_floating_point()]
        gt_boxes, gt_classes, gt_mask = self._targets(gt_boxes, gt_classes, gt_mask)

        def micro(t, m):
            return t[m * rows:(m + 1) * rows]

        def leaves(inputs):
            return [t.requires_grad_() if t.is_floating_point() else t for t in inputs]

        def grads_of(inputs):
            return [torch.zeros_like(t) if t.grad is None else t.grad for t in inputs]

        # forward wavefront; the last stage folds in the loss and backward
        kept: List[Any] = [None] * M
        gys: List[Any] = [None] * M
        per_micro = []
        for m in range(M):
            x_m = micro(images, m) if pp.is_first else None
            inputs = [] if pp.is_first else pp.recv(in_specs, s - 1)
            if pp.is_last:
                inputs = leaves(inputs)
                pred = pp.run(inputs, x_m, train=True)
                pred, boxes, classes, mask = gather_batch(
                    mesh.data, pred, *(micro(t, m) for t in (gt_boxes, gt_classes, gt_mask)))
                out, aux = yolo_loss(pred, boxes, classes, mask, config.loss)
                out.total_loss.backward()
                per_micro.append(collect_step_metrics(config, out, aux, pred))
                gys[m] = grads_of(inputs)
            else:
                kept[m] = (inputs, x_m, [b.clone() for b in buffers])
                with torch.no_grad():
                    outs = pp.run(inputs, x_m, train=True)
                pp.send(pp.plan.out_keys, outs, out_specs, s + 1)

        # backward wavefront: recompute from the kept inputs and statistics
        after = [b.clone() for b in buffers]
        for m in range(M):
            if pp.is_last:
                if not pp.is_first:
                    pp.send(pp.plan.in_keys, gys[m], in_specs, s - 1)
                    gys[m] = None
                continue
            gy = pp.recv(out_specs, s + 1)
            inputs, x_m, before = kept[m]
            kept[m] = None
            with torch.no_grad():
                torch._foreach_copy_(buffers, before)
            inputs = leaves(inputs)
            outs = pp.run(inputs, x_m, train=True)
            pairs = [(o, g) for o, g in zip(outs, gy) if o.requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
            if not pp.is_first:
                pp.send(pp.plan.in_keys, grads_of(inputs), in_specs, s - 1)
        with torch.no_grad():
            torch._foreach_copy_(buffers, after)

        # this stage's update: the mean over the micro-batches, the sum
        # over the data group (the loss is the global one), then
        # make_train_step's order
        with torch.no_grad():
            grads = [p.grad for p in params if p.grad is not None]
            torch._foreach_div_(grads, M)
        _mean_over_ranks(mesh.data, grads, divide=False)
        metrics = combine_micro_batches(per_micro) if per_micro else {}
        if config.log_weights_and_grads:
            grad_maxima = _maxima("grads_max", ((k, p.grad) for k, p in model.named_parameters()))
        StepHooks().update(ts.optimizer, params, config, self.schedule(ts.step))
        model.clamp_running_vars()
        if config.log_weights_and_grads:
            metrics.update(param_maxima(model))
            metrics.update(grad_maxima)
        return self._to_chief(metrics)

    def _to_chief(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Rank 0's metrics: its own and those the stages of data index 0
        send it (the last stage's losses, every stage's maxima)."""
        import torch.distributed as dist

        pp, mesh = self.pp, self.pp.mesh
        senders = ([pp.n_stages - 1] if not self.config.log_weights_and_grads
                   else list(range(1, pp.n_stages)))
        senders = [stage * pp.dp for stage in senders if stage > 0]
        if mesh.rank in senders:
            dist.send_object_list([{k: v.detach().cpu() for k, v in metrics.items()}], dst=0)
        elif mesh.is_chief:
            metrics = dict(metrics)
            for src in senders:
                box = [None]
                dist.recv_object_list(box, src=src)
                metrics.update(box[0])
        return metrics

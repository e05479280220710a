"""The pipeline-parallel stage planner.

Counterpart of the planning half of ``yolodl_tpu/parallel/pipeline.py``
(``_node_cost``, ``StagePlan``, ``plan_stages``), which needs no framework:
it cuts a model graph's topological order into contiguous stages where few
plain tensors cross, balancing a per-node FLOP estimate.  ``tool_main info
--pipeline-stages`` prints its plan.  The pipeline model that runs the
stages on several devices is ROADMAP A14c.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..config import newslab as cfg


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

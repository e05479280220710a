"""Flat DAG IR with static shape inference.

Equivalent capability to the reference's ``model-graph`` crate:
``model-graph/src/graph.rs:6-62`` (Graph/Node/InputKeys), and the NEWSLABv1
flattening pass ``model-graph/src/newslab_v1.rs:10-414``: recursive GroupRef
expansion, dotted-path resolution (``init.output``), implicit previous-layer
inputs, topological sort with cycle detection, and per-node output-shape
inference.

The IR is the single source of truth the model builder turns into one
``nn.Module`` — shape inference happens **here, once**, not per forward,
so the builder can pre-compute channel counts when it allocates parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..config import newslab as cfg
from ..shapes import Dim, Shape

# Non-tensor output markers (model-config ShapeOutput::{Detect2D, MergeDetect2D}).
DETECT_2D = "detect2d"
MERGE_DETECT_2D = "merge_detect2d"


@dataclasses.dataclass(frozen=True)
class ShapeOut:
    """Either a tensor shape or a detection-structure marker."""

    kind: str  # "tensor" | DETECT_2D | MERGE_DETECT_2D
    shape: Optional[Shape] = None

    @staticmethod
    def tensor(shape: Shape) -> "ShapeOut":
        return ShapeOut("tensor", shape)

    @property
    def is_tensor(self) -> bool:
        return self.kind == "tensor"

    def tensor_shape(self) -> Shape:
        if not self.is_tensor:
            raise ValueError(f"expected tensor shape, got {self.kind}")
        assert self.shape is not None
        return self.shape

    def __repr__(self) -> str:
        return repr(self.shape) if self.is_tensor else f"<{self.kind}>"


@dataclasses.dataclass(frozen=True)
class InputKeys:
    """Input edge spec: none, placeholder, single key, or an ordered list."""

    kind: str  # "none" | "placeholder" | "single" | "indexed"
    keys: Tuple[int, ...] = ()


    @staticmethod
    def none() -> "InputKeys":
        return InputKeys("none")

    @staticmethod
    def placeholder() -> "InputKeys":
        return InputKeys("placeholder")

    @staticmethod
    def single(key: int) -> "InputKeys":
        return InputKeys("single", (key,))

    @staticmethod
    def indexed(keys: Sequence[int]) -> "InputKeys":
        return InputKeys("indexed", tuple(keys))

    def iter_keys(self) -> Tuple[int, ...]:
        return self.keys

    @property
    def single_key(self) -> int:
        if self.kind != "single":
            raise ValueError(f"expected single input, got {self.kind}")
        return self.keys[0]


@dataclasses.dataclass(frozen=True)
class Node:
    key: int
    config: cfg.ModuleCfg
    input_keys: InputKeys
    output_shape: ShapeOut
    path: Optional[str]  # dotted path for named nodes, e.g. "init.output"

    @property
    def kind(self) -> str:
        return self.config.kind


class Graph:
    """Topologically-ordered DAG of layer nodes."""

    def __init__(self, nodes: Sequence[Node]):
        self.nodes: Dict[int, Node] = {n.key: n for n in nodes}
        self.order: Tuple[int, ...] = tuple(n.key for n in nodes)
        self.by_path: Dict[str, int] = {
            n.path: n.key for n in nodes if n.path is not None
        }
        # node paths whose outputs are gradient-stopped during training
        # (darknet stopbackward/onlyforward, network.c:362-363 — set by
        # graph_from_darknet; models/builder.py consumes it)
        self.stop_gradient_paths: frozenset = frozenset()
        # per-detect-head objectness thresholds from darknet [yolo]
        # sections, head-merge order (set by graph_from_darknet; the train
        # CLI resolves LossConfig.ignore_thresh="auto" from these)
        self.detect_ignore_thresh: Optional[Tuple[float, ...]] = None
        self.detect_truth_thresh: Optional[Tuple[float, ...]] = None
        # darknet [yolo] training options the production loss can adopt
        # (LossConfig iou_thresh/objectness_smooth/max_delta="auto"):
        # per-head multi-anchor match threshold (yolo_layer.c:640-656),
        # objectness smoothing flag, and delta-clip bound (None entries =
        # no clipping for that head)
        self.detect_iou_thresh: Optional[Tuple[float, ...]] = None
        self.detect_objectness_smooth: Optional[Tuple[bool, ...]] = None
        self.detect_max_delta: Optional[Tuple[Optional[float], ...]] = None

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_model(model: cfg.Model) -> "Graph":
        return _flatten(model)

    @staticmethod
    def load_newslab_v1_json(path) -> "Graph":
        return Graph.from_model(cfg.load_model(path))

    # -- queries ------------------------------------------------------------

    def input_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if isinstance(n.config, cfg.Input)]

    def ancestor_paths(self, path: str) -> frozenset:
        """The node at ``path`` plus every transitive input's path — the
        freeze set for frozen-prefix fine-tuning (training.freeze_through;
        the NEWSLAB-side generalization of darknet's stopbackward prefix,
        network.c:362)."""
        key = self.resolve_path(path)
        seen: set = set()
        stack = [key]
        while stack:
            k = stack.pop()
            if k in seen:
                continue
            seen.add(k)
            stack.extend(self.nodes[k].input_keys.iter_keys())
        # unnamed nodes use the builder's node{key} fallback naming so the
        # freeze set covers them too
        return frozenset(
            self.nodes[k].path if self.nodes[k].path is not None else f"node{k}"
            for k in seen
        )

    def resolve_path(self, path: str) -> int:
        """Node key for a dotted path, accepting the ``node{key}`` fallback
        naming of unnamed nodes (models/builder.py param names)."""
        if path in self.by_path:
            return self.by_path[path]
        if path.startswith("node") and path[4:].isdigit():
            key = int(path[4:])
            if key in self.nodes and self.nodes[key].path is None:
                return key
        known = ", ".join(
            n.path if n.path is not None else f"node{n.key}"
            for n in self.nodes.values())
        raise ValueError(f"unknown node path {path!r} (nodes: {known})")

    def detect_head_input_keys(self):
        """Node keys of the raw head-conv outputs feeding each Detect2D,
        in merge order — the inputs the darknet-exact training loss
        consumes (the decode/merge tail is not needed by that loss)."""
        out = self.output_node()
        if not isinstance(out.config, cfg.MergeDetect2D):
            raise ValueError("graph output is not a MergeDetect2D head")
        keys = []
        for det_key in out.input_keys.iter_keys():
            det = self.nodes[det_key]
            ins = list(det.input_keys.iter_keys())
            if not isinstance(det.config, cfg.Detect2D) or len(ins) != 1:
                raise ValueError(f"node {det_key} is not a 1-input Detect2D")
            keys.append(ins[0])
        return tuple(keys)

    def output_node(self) -> Node:
        """The unique sink node (no other node consumes it)."""
        consumed = {k for n in self.nodes.values() for k in n.input_keys.iter_keys()}
        sinks = [n for n in self.nodes.values() if n.key not in consumed]
        if len(sinks) != 1:
            raise ValueError(
                f"expected exactly one output node, found {[s.path or s.key for s in sinks]}"
            )
        return sinks[0]

    # -- reports ------------------------------------------------------------

    def info_table(self) -> str:
        """Per-node table like `yolo-tool info` (yolo-tool/src/main.rs:38-60),
        plus per-node params and forward GFLOPs (darknet's BF column)."""
        from .cost import graph_cost, node_cost

        def gf(f) -> str:
            return "-" if f is None else f"{f / 1e9:.3f}"

        rows = [("key", "kind", "path", "inputs", "output shape",
                 "params", "GFLOPs")]
        for key in self.order:
            n = self.nodes[key]
            p, f = node_cost(self, n)
            rows.append(
                (
                    str(key),
                    n.kind,
                    n.path or "",
                    ",".join(map(str, n.input_keys.iter_keys())),
                    repr(n.output_shape),
                    str(p) if p else "",
                    gf(f) if (p or f) else "",
                )
            )
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        table = "\n".join(
            "  ".join(col.ljust(w) for col, w in zip(row, widths)) for row in rows
        )
        total_p, total_f = graph_cost(self)
        return (f"{table}\ntotal: {total_p:,} params, "
                f"{gf(total_f)} GFLOPs/sample (fwd)")

    def to_dot(self) -> str:
        """Graphviz DOT export (model-graph/src/graphviz.rs equivalent)."""
        lines = ["digraph model {", "  rankdir=TB;", "  node [shape=box];"]
        for key in self.order:
            n = self.nodes[key]
            label = f"{key}: {n.kind}"
            if n.path:
                label += f"\\n{n.path}"
            label += f"\\n{n.output_shape!r}"
            lines.append(f'  n{key} [label="{label}"];')
        for key in self.order:
            n = self.nodes[key]
            for src in n.input_keys.iter_keys():
                lines.append(f"  n{src} -> n{key};")
        lines.append("}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# flattening (newslab_v1.rs:10-414)


@dataclasses.dataclass
class _PendingNode:
    key: int
    config: cfg.ModuleCfg
    path: Optional[str]


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _flatten(model: cfg.Model) -> Graph:
    nodes: List[_PendingNode] = []
    # edges as (dst, spec) where dst is key or unresolved path, and spec is
    # ("none"|"placeholder"|"single"|"indexed", payload of keys-or-paths)
    edges: List[Tuple[Union[int, str], Tuple[str, list]]] = []
    counter = iter(range(1 << 31))

    def traverse(group_name: str, prefix: str, depth: int) -> None:
        if depth > 64:
            raise ValueError("group nesting too deep (cycle in GroupRef?)")
        try:
            layers = model.groups[group_name]
        except KeyError:
            raise ValueError(f"the group {group_name!r} does not exist") from None

        prev_key: Optional[int] = None
        for layer in layers:
            if isinstance(layer, cfg.GroupRef):
                group_prefix = _join(prefix, layer.name)
                traverse(layer.group, group_prefix, depth + 1)
                for dst_name, src_path in layer.from_.items():
                    if src_path.split(".")[0] == layer.name:
                        raise ValueError(
                            f"GroupRef {layer.name!r} cannot reference itself"
                        )
                    edges.append(
                        (
                            _join(group_prefix, dst_name),
                            ("single", [_join(prefix, src_path)]),
                        )
                    )
                # GroupRef breaks the implicit previous-layer chain
                # (newslab_v1.rs:107 `saved_prev_key = None`).
                prev_key = None
                continue

            key = next(counter)
            path = _join(prefix, layer.name) if layer.name is not None else None
            infer_prev, prev_key = prev_key, key
            nodes.append(_PendingNode(key, layer, path))

            if isinstance(layer, cfg.Input):
                if prefix == "":
                    edges.append((key, ("placeholder", [])))
                # nested Input: edge added by the enclosing GroupRef
            elif isinstance(
                layer,
                (cfg.Concat2D, cfg.Sum2D, cfg.MergeDetect2D, cfg.DarknetRoute,
                 cfg.DarknetShortcut, cfg.DarknetSam, cfg.DarknetScaleChannels),
            ):
                edges.append(
                    (key, ("indexed", [_join(prefix, p) for p in layer.from_]))
                )
            else:
                frm = getattr(layer, "from_", None)
                if frm is None:
                    if infer_prev is None:
                        raise ValueError(
                            f"layer {path or layer.kind} has no 'from' and no previous layer"
                        )
                    edges.append((key, ("single", [infer_prev])))
                else:
                    edges.append((key, ("single", [_join(prefix, frm)])))

    traverse(model.main_group, "", 0)

    path_key = {n.path: n.key for n in nodes if n.path is not None}

    def resolve(ref: Union[int, str]) -> int:
        if isinstance(ref, int):
            return ref
        if ref not in path_key:
            raise ValueError(f"cannot resolve '{ref}'")
        return path_key[ref]

    input_keys_map: Dict[int, InputKeys] = {}
    for dst, (kind, payload) in edges:
        dst_key = resolve(dst)
        if kind == "none":
            ik = InputKeys.none()
        elif kind == "placeholder":
            ik = InputKeys.placeholder()
        elif kind == "single":
            ik = InputKeys.single(resolve(payload[0]))
        else:
            ik = InputKeys.indexed([resolve(p) for p in payload])
        if dst_key in input_keys_map:
            raise ValueError(f"node {dst} has multiple input specs")
        input_keys_map[dst_key] = ik

    for n in nodes:
        if n.key not in input_keys_map:
            if isinstance(n.config, cfg.Input):
                raise ValueError(
                    f"nested input {n.path!r} is not wired by its GroupRef"
                )
            raise ValueError(f"node {n.path or n.key} has no input spec")

    order = _toposort(nodes, input_keys_map)

    # shape inference in topological order
    node_map = {n.key: n for n in nodes}
    shapes: Dict[int, ShapeOut] = {}
    final: List[Node] = []
    for key in order:
        pending = node_map[key]
        ik = input_keys_map[key]
        out = _infer_shape(pending.config, ik, shapes, pending.path)
        shapes[key] = out
        final.append(Node(key, pending.config, ik, out, pending.path))

    return Graph(final)


def _toposort(nodes: List[_PendingNode], input_keys_map: Dict[int, InputKeys]) -> List[int]:
    """Kahn toposort preserving declaration order among ready nodes; raises on cycles."""
    indeg = {n.key: 0 for n in nodes}
    succs: Dict[int, List[int]] = {n.key: [] for n in nodes}
    for dst, ik in input_keys_map.items():
        for src in ik.iter_keys():
            if src not in indeg:
                raise ValueError(f"edge from unknown node {src}")
            indeg[dst] += 1
            succs[src].append(dst)

    declared = [n.key for n in nodes]
    ready = [k for k in declared if indeg[k] == 0]
    order: List[int] = []
    while ready:
        key = ready.pop(0)
        order.append(key)
        for nxt in succs[key]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
    if len(order) != len(nodes):
        raise ValueError("cycle detected in model graph")
    return order


# ---------------------------------------------------------------------------
# shape rules (model-config/src/module/*.rs output_shape impls)


def _single_tensor(ik: InputKeys, shapes: Mapping[int, ShapeOut]) -> Shape:
    if ik.kind != "single":
        raise ValueError(f"expected a single input, got {ik.kind}")
    return shapes[ik.single_key].tensor_shape()


def _conv_hw(d: Dim, k: int, s: int, p: int, dil: int) -> Dim:
    return d.map(lambda v: (v + 2 * p - dil * (k - 1) - 1) // s + 1)


def _infer_shape(
    layer: cfg.ModuleCfg,
    ik: InputKeys,
    shapes: Mapping[int, ShapeOut],
    path: Optional[str],
) -> ShapeOut:
    if isinstance(layer, cfg.Input):
        if ik.kind == "placeholder":
            return ShapeOut.tensor(layer.shape)
        # nested input: check compatibility with the wired source
        src = _single_tensor(ik, shapes)
        return ShapeOut.tensor(src.unify(layer.shape))

    if isinstance(layer, (cfg.ConvBn2D, cfg.Conv2D)):
        b, _, h, w = _single_tensor(ik, shapes)
        p = layer.padding
        return ShapeOut.tensor(
            Shape([b, layer.c, _conv_hw(h, layer.k, layer.s, p, layer.d),
                   _conv_hw(w, layer.k, layer.s, p, layer.d)])
        )

    if isinstance(layer, cfg.DeconvBn2D):
        b, _, h, w = _single_tensor(ik, shapes)
        p = layer.padding

        def deconv(v: int) -> int:
            return (v - 1) * layer.s - 2 * p + layer.d * (layer.k - 1) + layer.op + 1

        return ShapeOut.tensor(Shape([b, layer.c, h.map(deconv), w.map(deconv)]))

    if isinstance(layer, (cfg.DarkCsp2D, cfg.SppCsp2D)):
        b, _, h, w = _single_tensor(ik, shapes)
        return ShapeOut.tensor(Shape([b, layer.c, h, w]))

    if isinstance(layer, cfg.UpSample2D):
        b, c, h, w = _single_tensor(ik, shapes)
        if layer.stride is not None and layer.reverse:
            stride = layer.stride
            return ShapeOut.tensor(
                Shape([b, c, h.map(lambda v: v // stride), w.map(lambda v: v // stride)])
            )
        scale = layer.scale
        return ShapeOut.tensor(
            Shape([b, c, h.map(lambda v: int(v * scale)), w.map(lambda v: int(v * scale))])
        )

    if isinstance(layer, cfg.Concat2D):
        ins = [shapes[k].tensor_shape() for k in ik.iter_keys()]
        if len(ins) < 1:
            raise ValueError("Concat2D needs at least one input")
        b, c, h, w = ins[0]
        for s2 in ins[1:]:
            b = b.unify(s2[0])
            c = c + s2[1]
            h = h.unify(s2[2])
            w = w.unify(s2[3])
        return ShapeOut.tensor(Shape([b, c, h, w]))

    if isinstance(layer, cfg.Sum2D):
        ins = [shapes[k].tensor_shape() for k in ik.iter_keys()]
        out = ins[0]
        for s2 in ins[1:]:
            out = out.unify(s2)
        return ShapeOut.tensor(out)

    if isinstance(layer, cfg.Detect2D):
        shape = _single_tensor(ik, shapes)
        _, c, _, _ = shape
        entries = (9 if layer.gaussian else 5) + layer.classes
        expect_c = len(layer.anchors) * entries
        if c.is_known and c.size != expect_c:
            raise ValueError(
                f"Detect2D {path or ''}: input channels {c.size} != "
                f"anchors*entries = {expect_c}"
            )
        return ShapeOut(DETECT_2D)

    if isinstance(layer, cfg.MergeDetect2D):
        for k in ik.iter_keys():
            if shapes[k].kind != DETECT_2D:
                raise ValueError("MergeDetect2D inputs must be Detect2D outputs")
        return ShapeOut(MERGE_DETECT_2D)

    if isinstance(layer, cfg.MaxPool):
        b, c, h, w = _single_tensor(ik, shapes)
        k = layer.size
        if layer.total_padding is not None:
            tp = layer.total_padding

            def pool(v: int, s: int) -> int:
                return (v + tp - k) // s + 1

        else:
            p = layer.padding

            def pool(v: int, s: int) -> int:
                return (v + 2 * p - k) // s + 1

        return ShapeOut.tensor(
            Shape([b, c, h.map(lambda v: pool(v, layer.stride_y)),
                   w.map(lambda v: pool(v, layer.stride_x))])
        )

    if isinstance(layer, cfg.DynamicPad2D):
        b, c, h, w = _single_tensor(ik, shapes)
        return ShapeOut.tensor(
            Shape([b, c, h + (layer.t + layer.b), w + (layer.l + layer.r)])
        )

    if isinstance(layer, cfg.Linear):
        shape = _single_tensor(ik, shapes)
        return ShapeOut.tensor(Shape([shape[0], layer.out]))

    if isinstance(layer, (cfg.DarknetRnn, cfg.DarknetGru, cfg.DarknetLstm)):
        shape = _single_tensor(ik, shapes)
        return ShapeOut.tensor(Shape([shape[0], layer.out]))

    if isinstance(layer, cfg.DarknetCrnn):
        shape = _single_tensor(ik, shapes)
        if len(shape) == 2:  # after a connected layer: 1×1 spatial
            b = shape[0]
            h = w = Dim(1)
        else:
            b, _, h, w = shape
        k, p, d = layer.k, layer.p, layer.d
        # stride-1 conv with dilation: v + 2p − d·(k−1) — the builder
        # passes d through to the real sub-convs (from_darknet.py), so the
        # rule must match or planner cuts / crnn_apply's h+self add trace
        # against a shape the IR never produces
        return ShapeOut.tensor(
            Shape([b, layer.out,
                   h.map(lambda v: v + 2 * p - d * (k - 1)),
                   w.map(lambda v: v + 2 * p - d * (k - 1))])
        )

    if isinstance(layer, cfg.GlobalAvgPool2D):
        b, c, _, _ = _single_tensor(ik, shapes)
        return ShapeOut.tensor(Shape([b, c, 1, 1]))

    if isinstance(layer, cfg.Yolov1Detection):
        # the builder flattens (CHW-major for conv-fed inputs) to 2-D
        shape = _single_tensor(ik, shapes)
        if len(shape) == 2:
            return ShapeOut.tensor(shape)
        b, c, h, w = shape
        return ShapeOut.tensor(Shape([b, c * h * w]))

    if isinstance(layer, (cfg.Dropout, cfg.Softmax, cfg.Identity)):
        return ShapeOut.tensor(_single_tensor(ik, shapes))

    if isinstance(layer, cfg.DarknetRoute):
        ins = [shapes[k].tensor_shape() for k in ik.iter_keys()]
        n = layer.num_groups
        b, c, h, w = ins[0]
        c = c.map(lambda v: v // n)
        for s2 in ins[1:]:
            b = b.unify(s2[0])
            c = c + s2[1].map(lambda v: v // n)
            h = h.unify(s2[2])
            w = w.unify(s2[3])
        return ShapeOut.tensor(Shape([b, c, h, w]))

    if isinstance(layer, cfg.DarknetShortcut):
        # darknet shortcut samples/strides mismatched spatial sizes
        # (blas.c shortcut_cpu), so the output is simply the first (previous
        # layer) input's shape
        ins = [shapes[k].tensor_shape() for k in ik.iter_keys()]
        return ShapeOut.tensor(ins[0])

    if isinstance(layer, cfg.DarknetSam):
        ins = [shapes[k].tensor_shape() for k in ik.iter_keys()]
        return ShapeOut.tensor(ins[0].unify(ins[1]))

    if isinstance(layer, cfg.DarknetScaleChannels):
        ins = [shapes[k].tensor_shape() for k in ik.iter_keys()]
        return ShapeOut.tensor(ins[1])  # referenced layer's shape

    if isinstance(layer, cfg.Reorg2D):
        b, c, h, w = _single_tensor(ik, shapes)
        st = layer.stride
        if layer.reverse:
            return ShapeOut.tensor(
                Shape([b, c.map(lambda v: v // (st * st)),
                       h.map(lambda v: v * st), w.map(lambda v: v * st)])
            )
        return ShapeOut.tensor(
            Shape([b, c.map(lambda v: v * st * st),
                   h.map(lambda v: v // st), w.map(lambda v: v // st)])
        )

    raise ValueError(f"no shape rule for module kind {layer.kind!r}")

"""Static per-node parameter and FLOP counts over the graph IR.

Analogue of darknet's per-layer ``BF`` column in its network printout
(darknet convolutional_layer.c:l.bflops) generalized to every
parameterized kind; the reference's `yolo-tool info` prints neither
(yolo-tool/src/main.rs:38-60), so this is a superset.

Counting conventions:

- **params** mirrors the builder's init path exactly (models/builder.py
  ``init``): conv weight + optional bias + BN scale/bias when affine;
  dense layers always carry a bias and a scale-only BN when enabled
  (darknet connected semantics, ops/recurrent.py dense_init).
  ``tests/test_cost.py`` asserts the analytic count equals the size of
  the actual initialized pytree for darknet and NEWSLAB models.
- **flops** is the forward multiply-add count x2 per *single sample*
  (batch axis excluded; for time-major recurrent nodes, per token).
  Only matrix-unit ops are counted — convs and matmuls; elementwise,
  pooling, and resampling ops count 0, like darknet's BFLOPs column.
  ``None`` when the spatial extent is unknown ("_" dims).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..config import newslab as cfg
from . import ir


def _hw(shape) -> Optional[int]:
    """h*w of a logical-NCHW shape, or None if unknown."""
    if shape is None or len(shape) != 4:
        return None
    h, w = shape[2], shape[3]
    if not (h.is_known and w.is_known):
        return None
    return h.size * w.size


def _conv_cost(k: int, in_c: int, out_c: int, g: int, bias: bool,
               bn: Optional[cfg.BatchNormConfig], out_hw: Optional[int]):
    p = k * k * (in_c // g) * out_c
    if bias:
        p += out_c
    if bn is not None and bn.enabled and bn.affine:
        p += 2 * out_c
    f = None if out_hw is None else 2 * k * k * (in_c // g) * out_c * out_hw
    return p, f


def _dense_cost(in_f: int, out_f: int, bn: bool):
    """darknet connected layer (ops/recurrent.py dense_init): w + b, and a
    scale-only BN when enabled."""
    p = in_f * out_f + out_f + (out_f if bn else 0)
    return p, 2 * in_f * out_f


def _add(costs) -> Tuple[int, Optional[int]]:
    p_total, f_total = 0, 0
    for p, f in costs:
        p_total += p
        if f_total is not None:
            f_total = None if f is None else f_total + f
    return p_total, f_total


def node_cost(graph: "ir.Graph", node: "ir.Node") -> Tuple[int, Optional[int]]:
    """(n_params, forward_flops_per_sample) for one node; (0, 0) for
    parameter-free kinds."""
    layer = node.config
    ik = node.input_keys

    in_shape = None
    if ik.kind == "single":
        src = graph.nodes[ik.single_key].output_shape
        if src.is_tensor:
            in_shape = src.tensor_shape()

    out_shape = (node.output_shape.tensor_shape()
                 if node.output_shape.is_tensor else None)

    def in_c() -> int:
        if in_shape is None or len(in_shape) < 2 or not in_shape[1].is_known:
            raise ValueError(
                f"node {node.path or node.key}: unknown input channels")
        return in_shape[1].size

    def in_features() -> int:
        if in_shape is None or not all(d.is_known for d in in_shape[1:]):
            raise ValueError(
                f"node {node.path or node.key}: unknown input features")
        feat = 1
        for d in in_shape[1:]:
            feat *= d.size
        return feat

    if isinstance(layer, cfg.ConvBn2D):
        return _conv_cost(layer.k, in_c(), layer.c, layer.g, layer.bias,
                          layer.bn, _hw(out_shape))

    if isinstance(layer, cfg.Conv2D):
        return _conv_cost(layer.k, in_c(), layer.c, layer.g, layer.bias,
                          None, _hw(out_shape))

    if isinstance(layer, cfg.DeconvBn2D):
        # transposed conv: every *input* position fires a k x k stencil
        return _conv_cost(layer.k, in_c(), layer.c, layer.g, layer.bias,
                          layer.bn, _hw(in_shape))

    if isinstance(layer, cfg.DarkCsp2D):
        # blocks.py dark_csp_init; all sub-convs run at the block's spatial
        c, mid = in_c(), int(in_c() * layer.c_mul)
        hw = _hw(out_shape)
        subs = [
            _conv_cost(1, c, mid, 1, True, layer.bn, hw),       # skip
            _conv_cost(1, 2 * mid, layer.c, 1, True, layer.bn, hw),  # merge
            _conv_cost(1, c, mid, 1, True, layer.bn, hw),       # before
            _conv_cost(1, mid, mid, 1, True, layer.bn, hw),     # after
        ]
        for _ in range(layer.repeat):
            subs.append(_conv_cost(1, mid, mid, 1, True, layer.bn, hw))
            subs.append(_conv_cost(3, mid, mid, 1, True, layer.bn, hw))
        return _add(subs)

    if isinstance(layer, cfg.SppCsp2D):
        # blocks.py spp_csp_init: first/last/skip + 5 spp convs, all mid->mid
        # except first (c->mid) and last (2mid->c)
        c, mid = in_c(), int(in_c() * layer.c_mul)
        hw = _hw(out_shape)
        subs = [
            _conv_cost(1, c, mid, 1, True, layer.bn, hw),
            _conv_cost(1, 2 * mid, layer.c, 1, True, layer.bn, hw),
            _conv_cost(1, mid, mid, 1, True, layer.bn, hw),     # skip
        ]
        for k in (1, 3, 1, 1, 3):
            subs.append(_conv_cost(k, mid, mid, 1, True, layer.bn, hw))
        return _add(subs)

    if isinstance(layer, cfg.Linear):
        return _dense_cost(in_features(), layer.out, layer.bn.enabled)

    if isinstance(layer, cfg.DarknetRnn):
        f, h = in_features(), layer.hidden
        return _add([
            _dense_cost(f, h, layer.bn),
            _dense_cost(h, h, layer.bn),
            _dense_cost(h, layer.out, layer.bn),
        ])

    if isinstance(layer, cfg.DarknetGru):
        f, o = in_features(), layer.out
        return _add([_dense_cost(f, o, layer.bn)] * 3
                    + [_dense_cost(o, o, layer.bn)] * 3)

    if isinstance(layer, cfg.DarknetLstm):
        f, o = in_features(), layer.out
        return _add([_dense_cost(f, o, layer.bn)] * 4
                    + [_dense_cost(o, o, layer.bn)] * 4)

    if isinstance(layer, cfg.DarknetCrnn):
        # builder._crnn_sub_cfgs: bias = not bn, BN per layer.bn, stride 1
        c, h = in_c(), layer.hidden
        hw = _hw(out_shape)
        bn = cfg.BatchNormConfig(enabled=layer.bn)
        return _add([
            _conv_cost(layer.k, c, h, layer.g, not layer.bn, bn, hw),
            _conv_cost(layer.k, h, h, layer.g, not layer.bn, bn, hw),
            _conv_cost(layer.k, h, layer.out, layer.g, not layer.bn, bn, hw),
        ])

    return 0, 0


def graph_cost(graph: "ir.Graph") -> Tuple[int, Optional[int]]:
    """(total params, total forward FLOPs per sample) over the graph."""
    return _add(node_cost(graph, graph.nodes[k]) for k in graph.order)

"""Graph IR → ``nn.Module``.

Counterpart of ``yolodl_tpu/models/builder.py``: every IR node becomes
parameters plus a compute step, run in topological order.  Parameter names
are the graph node paths (``layer0``, ``layer1``, …), so a reference
checkpoint maps one to one through ``bridge.py``.  A ``ModuleDict`` key
cannot hold ``.``, so a path's dots are written as ``/`` there
(:func:`module_key`).

Compute is NCHW.  ``forward(x, data_format=..., train=...)`` takes NCHW or
NHWC input, as the reference's ``apply`` does, and returns a
:class:`MergedDetection` whose fields keep the reference's ``[B, N, ...]``
layout.  ``train=True`` is the reference's ``apply(train=True)``: BN
normalizes with batch statistics, and the new running statistics, which the
reference returns as ``new_state``, are written into the BN buffers in
place.  The mode is that keyword, never ``nn.Module.training``.

This slice ports the node kinds that the darknet YOLO cfgs of the serving
path use: Input, ConvBn2D, Conv2D, DarknetRoute, DarknetShortcut, MaxPool,
UpSample2D, Detect2D and MergeDetect2D.  Building a graph with any other
kind raises ``NotImplementedError`` naming its ROADMAP item.  The
reference's layout rewrites (``spd_stem``, ``fold_region``) and ``remat``
are not ported: the port computes as the reference does with
``spd_stem="off"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import activations
from .._device import resolve_device
from ..config import newslab as cfg
from ..graph import Graph
from ..graph.ir import MERGE_DETECT_2D
from ..ops import conv, detect, norm, simple

Tensor = torch.Tensor

# node kinds this slice does not run yet → the ROADMAP item that ports them
_NOT_PORTED = {
    cfg.DeconvBn2D: "A2 (deconv)",
    cfg.DarkCsp2D: "A2 (NEWSLAB blocks)",
    cfg.SppCsp2D: "A2 (NEWSLAB blocks)",
    cfg.Sum2D: "A2 (NEWSLAB plumbing)",
    cfg.Concat2D: "A2 (NEWSLAB plumbing)",
    cfg.DynamicPad2D: "A2 (NEWSLAB plumbing)",
    cfg.Linear: "A12 (other workloads)",
    cfg.DarknetRnn: "A12 (other workloads)",
    cfg.DarknetGru: "A12 (other workloads)",
    cfg.DarknetLstm: "A12 (other workloads)",
    cfg.DarknetCrnn: "A12 (other workloads)",
}

_PORTED = (cfg.Input, cfg.ConvBn2D, cfg.Conv2D, cfg.DarknetRoute,
           cfg.DarknetShortcut, cfg.MaxPool, cfg.UpSample2D, cfg.Detect2D,
           cfg.MergeDetect2D)


def _detach(out):
    """``stop_gradient`` of a node output: a tensor or a detection dataclass."""
    if isinstance(out, Tensor):
        return out.detach()
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name).detach() for f in dataclasses.fields(out)
        if isinstance(getattr(out, f.name), Tensor)})


def module_key(path: str) -> str:
    """ModuleDict key of a node path (a key cannot hold ``.``)."""
    return path.replace(".", "/")


class DarkBatchNorm(nn.Module):
    """BN parameters (``scale``, ``bias`` when affine) and running stats
    (``mean``, ``var`` buffers) of one conv; the math is ``ops/norm.py``."""

    def __init__(self, channels: int, affine: bool, device):
        super().__init__()
        if affine:
            self.scale = nn.Parameter(torch.ones(channels, device=device))
            self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def params(self) -> Dict[str, Tensor]:
        return {k: v for k, v in (("scale", getattr(self, "scale", None)),
                                   ("bias", getattr(self, "bias", None)))
                if v is not None}

    def state(self) -> Dict[str, Tensor]:
        return {"mean": self.mean, "var": self.var}


class ConvNode(nn.Module):
    """Weights of a ConvBn2D or Conv2D node: ``w`` OIHW, ``b`` when the
    layer has a bias, ``bn`` when it is batch-normalized."""

    def __init__(self, in_c: int, out_c: int, k: int, groups: int, bias: bool,
                 bn: Optional[cfg.BatchNormConfig], device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(out_c, in_c // groups, k, k, device=device))
        self.b = nn.Parameter(torch.empty(out_c, device=device)) if bias else None
        self.bn = (DarkBatchNorm(out_c, bn.affine, device)
                   if bn is not None and bn.enabled else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Torch's conv defaults, as ``ops/initializers.py`` draws them:
        uniform in ±1/√fan_in for the kernel and the bias; BN scale 1,
        bias 0, mean 0, var 1.  Drawn on the CPU so a seed gives the same
        weights on every device."""
        out_c, in_pg, kh, kw = self.w.shape
        fan_in = kh * kw * in_pg
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        self.w.copy_(torch.empty(self.w.shape).uniform_(-bound, bound, generator=generator))
        if self.b is not None:
            self.b.copy_(torch.empty(out_c).uniform_(-bound, bound, generator=generator))
        if self.bn is not None:
            for name, value in (("scale", 1.0), ("bias", 0.0)):
                if hasattr(self.bn, name):
                    getattr(self.bn, name).fill_(value)
            self.bn.mean.zero_()
            self.bn.var.fill_(1.0)

    def params(self) -> Dict:
        p: Dict = {"w": self.w}
        if self.b is not None:
            p["b"] = self.b
        if self.bn is not None:
            p["bn"] = self.bn.params()
        return p

    def state(self) -> Dict:
        return {"bn": self.bn.state()} if self.bn is not None else {}


class GraphModel(nn.Module):
    """Any graph of the ported node kinds as one module."""

    def __init__(self, graph: Graph, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """``device`` defaults to ``"cuda"`` and raises without a card;
        ``generator`` seeds :meth:`init` (a CPU generator seeded 0 when
        omitted)."""
        super().__init__()
        device = resolve_device(device)
        self.graph = graph
        self.output_key = graph.output_node().key
        self._pname: Dict[int, str] = {
            key: node.path if node.path is not None else f"node{key}"
            for key, node in graph.nodes.items()
        }
        # darknet stopbackward/onlyforward (set by graph_from_darknet): these
        # nodes' outputs are detached, so their parameters get no gradient
        # and nothing flows upstream through them; BN running stats still
        # update in the training forward, as darknet's forward does
        sg_paths = getattr(graph, "stop_gradient_paths", frozenset()) or frozenset()
        self._sg_keys = {key for key, name in self._pname.items() if name in sg_paths}

        self.layers = nn.ModuleDict()
        for key in graph.order:
            node = graph.nodes[key]
            layer = node.config
            if not isinstance(layer, _PORTED):
                item = _NOT_PORTED.get(type(layer), "A4 (model node kinds)")
                raise NotImplementedError(
                    f"{layer.kind} is not ported to yolodl_torch yet "
                    f"(ROADMAP {item})")
            if isinstance(layer, (cfg.ConvBn2D, cfg.Conv2D)):
                src = graph.nodes[node.input_keys.single_key].output_shape
                in_c = src.tensor_shape()[1].size
                bn = layer.bn if isinstance(layer, cfg.ConvBn2D) else None
                self.layers[module_key(self._pname[key])] = ConvNode(
                    in_c, layer.c, layer.k, layer.g, layer.bias, bn, device)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.init(generator)

    def init(self, generator: torch.Generator) -> None:
        """(Re)draw every parameter from ``generator``, node by node in
        graph order."""
        for m in self.layers.values():
            m.reset_parameters(generator)

    def _node(self, key: int) -> ConvNode:
        return self.layers[module_key(self._pname[key])]

    def forward(self, x: Tensor, data_format: str = "NCHW", *, train: bool = False):
        """Forward → the graph output, a MergedDetection for YOLO.

        ``train=False`` normalizes BN with the running statistics.
        ``train=True`` normalizes with the batch statistics and writes the
        updated running mean/var into each ``DarkBatchNorm``'s buffers in
        place, under ``torch.no_grad()`` — the port's form of the
        reference's returned ``new_state``.  Successive calls (micro-batches)
        therefore thread the state sequentially, as the reference's
        ``lax.scan`` over micro-batches does.
        """
        if data_format == "NHWC":
            x = x.permute(0, 3, 1, 2)
        elif data_format != "NCHW":
            raise ValueError(f"unknown data_format {data_format!r}")

        outputs: Dict[int, object] = {}
        for key in self.graph.order:
            node = self.graph.nodes[key]
            layer = node.config
            ik = node.input_keys

            if isinstance(layer, cfg.Input):
                if ik.kind == "placeholder":
                    expect_c = layer.shape[1]
                    if expect_c.is_known and x.shape[1] != expect_c.size:
                        raise ValueError(
                            f"input channels {x.shape[1]} != declared {expect_c.size}")
                    outputs[key] = x
                else:
                    outputs[key] = outputs[ik.single_key]
            elif isinstance(layer, cfg.ConvBn2D):
                m = self._node(key)
                outputs[key], new_state = conv.conv_bn_apply(
                    m.params(), m.state(), outputs[ik.single_key], layer, train)
                if train and m.bn is not None:
                    with torch.no_grad():
                        m.bn.mean.copy_(new_state["bn"]["mean"])
                        m.bn.var.copy_(new_state["bn"]["var"])
            elif isinstance(layer, cfg.Conv2D):
                m = self._node(key)
                outputs[key] = conv.conv2d_apply(
                    outputs[ik.single_key], m.w, m.b, stride=layer.s,
                    padding=layer.padding, dilation=layer.d, groups=layer.g)
            elif isinstance(layer, cfg.UpSample2D):
                if layer.stride is not None and layer.reverse:
                    outputs[key] = simple.downsample2d(outputs[ik.single_key], layer.stride)
                else:
                    outputs[key] = simple.upsample2d(outputs[ik.single_key], layer.scale)
            elif isinstance(layer, cfg.MaxPool):
                outputs[key] = simple.max_pool2d(
                    outputs[ik.single_key], layer.size, layer.stride_y,
                    layer.stride_x, layer.padding, layer.total_padding,
                    layer.pool_kind)
            elif isinstance(layer, cfg.Detect2D):
                outputs[key] = detect.detect_decode(
                    outputs[ik.single_key], layer.anchors, layer.classes,
                    order=layer.channel_order, variant=layer.variant,
                    scale_xy=layer.scale_xy, entry_layout=layer.entry_layout,
                    gaussian=layer.gaussian,
                    class_activation=layer.class_activation)
            elif isinstance(layer, cfg.DarknetRoute):
                ins = [outputs[k] for k in ik.iter_keys()]
                n = layer.num_groups
                if n > 1:
                    ins = [t[:, layer.group_id * (t.shape[1] // n):
                              (layer.group_id + 1) * (t.shape[1] // n)]
                           for t in ins]
                outputs[key] = ins[0] if len(ins) == 1 else simple.concat2d(ins)
            elif isinstance(layer, cfg.DarknetShortcut):
                ins = [outputs[k] for k in ik.iter_keys()]
                out = ins[0]
                oh, ow = out.shape[2], out.shape[3]
                for other in ins[1:]:
                    # darknet shortcut_cpu: stride-sample larger maps,
                    # nearest-repeat smaller ones
                    fh, fw = other.shape[2], other.shape[3]
                    if fh > oh:
                        other = other[:, :, :: fh // oh, :: fw // ow]
                    elif fh < oh:
                        other = other.repeat_interleave(oh // fh, dim=2) \
                                     .repeat_interleave(ow // fw, dim=3)
                    # only the shared channel prefix is added
                    c = min(out.shape[1], other.shape[1])
                    if c < out.shape[1]:
                        out = torch.cat([out[:, :c] + other[:, :c], out[:, c:]], dim=1)
                    else:
                        out = out + other[:, :c]
                outputs[key] = activations.apply(layer.act, out)
            elif isinstance(layer, cfg.MergeDetect2D):
                outputs[key] = detect.merge_detections(
                    [outputs[k] for k in ik.iter_keys()])
            else:  # pragma: no cover - __init__ rejects every other kind
                raise NotImplementedError(layer.kind)

            if key in self._sg_keys:
                outputs[key] = _detach(outputs[key])
        return outputs[self.output_key]

    @torch.no_grad()
    def clamp_running_vars(self) -> None:
        """Clamp every BN running variance to its node's var_min/var_max, in
        place (model.rs:412-422 → dark_batch_norm.rs:148-172).  Called after
        each optimizer step."""
        for key in self.graph.order:
            layer = self.graph.nodes[key].config
            if not isinstance(layer, cfg.ConvBn2D):
                continue
            bn_cfg = layer.bn
            if bn_cfg.var_min is None and bn_cfg.var_max is None:
                continue
            m = self._node(key)
            if m.bn is not None:
                m.bn.var.copy_(norm.clamp_running_var(
                    m.bn.state(), bn_cfg.var_min, bn_cfg.var_max)["var"])


class YoloModel(GraphModel):
    """A detection model: validates the MergeDetect2D sink and a uniform
    class count (model.rs:330-353)."""

    def __init__(self, graph: Graph, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        out = graph.nodes[graph.output_node().key]
        if out.output_shape.kind != MERGE_DETECT_2D:
            raise ValueError(
                "model output must be a MergeDetect2D node (model.rs:330-353)")
        det_nodes = [n for n in graph.nodes.values()
                     if isinstance(n.config, cfg.Detect2D)]
        if not det_nodes:
            raise ValueError("model has no Detect2D heads")
        classes = {n.config.classes for n in det_nodes}
        if len(classes) != 1:
            raise ValueError(f"Detect2D heads disagree on num_classes: {classes}")
        super().__init__(graph, device=device, generator=generator)
        self.num_classes: int = classes.pop()
        self.anchors: Tuple = tuple(n.config.anchors for n in det_nodes)

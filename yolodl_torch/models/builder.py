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

Every node kind of the reference is ported: Input, ConvBn2D, Conv2D,
DeconvBn2D, DarkCsp2D, SppCsp2D, DarknetRoute, DarknetShortcut,
DarknetSam, DarknetScaleChannels, Reorg2D (plain, reverse and old),
MaxPool (max and avg), GlobalAvgPool2D, UpSample2D, Sum2D, Concat2D,
DynamicPad2D, Identity, Dropout, Softmax, Detect2D, MergeDetect2D,
Yolov1Detection, and the dense and recurrent kinds of ``ops/recurrent.py``:
Linear, DarknetRnn, DarknetGru, DarknetLstm and DarknetCrnn.  The
reference's layout rewrites (``spd_stem``, ``fold_region``) are not
ported: the port computes as the reference does with ``spd_stem="off"``.

Every reshape of the reference reads NHWC; the port's NCHW forms keep the
same element order: Softmax and GlobalAvgPool2D reduce dim 1 and dims 2-3,
a scale_channels scale is ``[b, c, 1, 1]`` (SE) or ``[b, 1, h, w]``
(scale_wh), Yolov1Detection flattens CHW without a transpose, and Reorg2D
is ``ops/simple.py`` ``space_to_depth``/``depth_to_space`` (REORG_OLD
reinterprets the NCHW buffer, which the port already holds), and Linear
and the dense recurrent kinds flatten a map as NHWC
(``recurrent.flatten_nhwc``), so a dense weight is the reference's,
transposed to ``[out, in]``.  Dropout
draws its mask from the ``generator`` given to ``forward`` (the reference's
``rng``), node by node in graph order; without one it is the identity.

``remat="blocks"`` is the reference's: every ConvBn2D, DeconvBn2D,
DarkCsp2D and SppCsp2D node runs under ``torch.utils.checkpoint`` (non
reentrant), so the backward recomputes what lies inside the node from its
input.  The checkpointed function returns the node's new BN statistics and
the writes into the buffers stay outside it: a write inside would run
again at the recompute and apply the momentum twice.

Under tensor parallelism (``parallel/tp.py``) a conv or Linear node holds
this rank's output channels and its ``shard`` (a ``LayerShard``), which
the node's apply function calls around the conv and for BN; the graph
walk is the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import activations
from .._device import resolve_device
from ..config import newslab as cfg
from ..graph import Graph
from ..graph.ir import MERGE_DETECT_2D
from ..ops import blocks, conv, detect, norm, recurrent, simple

Tensor = torch.Tensor

# node kinds with parameters whose apply returns (output, new BN state)
_BN_KINDS = (cfg.ConvBn2D, cfg.DeconvBn2D, cfg.DarkCsp2D, cfg.SppCsp2D)
# the dense and recurrent kinds (ops/recurrent.py): parameters, and BN
# statistics when the layer normalizes
_DENSE_KINDS = (cfg.Linear, cfg.DarknetRnn, cfg.DarknetGru, cfg.DarknetLstm,
                cfg.DarknetCrnn)


def _detach(out):
    """``stop_gradient`` of a node output: a tensor or a detection dataclass."""
    if isinstance(out, Tensor):
        return out.detach()
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name).detach() for f in dataclasses.fields(out)
        if isinstance(getattr(out, f.name), Tensor)})


def _reorg(x: Tensor, layer) -> Tensor:
    """darknet reorg on NCHW.  REORG_OLD reinterprets the NCHW buffer as
    ``[c/s², h·s, w·s]``, applies space-to-depth and reinterprets the result
    as ``[c·s², h/s, w/s]`` (blas.c reorg_cpu with the input's dims), so it
    reshapes the port's NCHW tensor directly."""
    s = layer.stride
    b, c, h, w = x.shape
    if layer.old and not layer.reverse:
        out = simple.space_to_depth(x.reshape(b, c // (s * s), h * s, w * s), s)
        return out.reshape(b, c * s * s, h // s, w // s)
    if layer.reverse:
        return simple.depth_to_space(x, s)
    return simple.space_to_depth(x, s)


def _yolov1_detection(h: Tensor, layer) -> Tensor:
    """darknet [detection]: the CHW-flat activation (NCHW flattens to it
    as it is), with an optional per-cell softmax over the leading S²·C class
    block (detection_layer.c:9-17); confidences and boxes are untouched."""
    h = h.reshape(h.shape[0], -1)
    if layer.softmax:
        n_cls = layer.side * layer.side * layer.classes
        cls = torch.softmax(h[:, :n_cls].reshape(h.shape[0], -1, layer.classes), dim=-1)
        h = torch.cat([cls.reshape(h.shape[0], n_cls), h[:, n_cls:]], dim=-1)
    return h


def module_key(path: str) -> str:
    """ModuleDict key of a node path (a key cannot hold ``.``)."""
    return path.replace(".", "/")


class DarkBatchNorm(nn.Module):
    """BN parameters (``scale``, ``bias`` when affine) and running stats
    (``mean``, ``var`` buffers) of one conv; the math is ``ops/norm.py``.
    ``shift=False`` leaves the bias out: a darknet connected layer's BN has
    a scale only, and its layer bias is added after it."""

    def __init__(self, channels: int, affine: bool, device, shift: bool = True):
        super().__init__()
        if affine:
            self.scale = nn.Parameter(torch.ones(channels, device=device))
            if shift:
                self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def params(self) -> Dict[str, Tensor]:
        return {k: v for k, v in (("scale", getattr(self, "scale", None)),
                                   ("bias", getattr(self, "bias", None)))
                if v is not None}

    def state(self) -> Dict[str, Tensor]:
        return {"mean": self.mean, "var": self.var}


class _NormedNode(nn.Module):
    """A layer whose ``bn`` attribute is a DarkBatchNorm or None.  Under
    tensor parallelism ``shard`` is its ``parallel/tp.py`` ``LayerShard``
    (set by ``place_tp_state``), and the layer holds this rank's output
    channels only."""

    shard = None

    def state(self) -> Dict:
        return {"bn": self.bn.state()} if self.bn is not None else {}

    @torch.no_grad()
    def write_state(self, new_state: Dict) -> None:
        """Copy the new running statistics of a training forward into the
        BN buffers."""
        if self.bn is not None:
            self.bn.mean.copy_(new_state["bn"]["mean"])
            self.bn.var.copy_(new_state["bn"]["var"])


class ConvNode(_NormedNode):
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

    @torch.no_grad()
    def clamp_running_var(self, var_min: Optional[float], var_max: Optional[float]) -> None:
        if self.bn is not None:
            self.bn.var.copy_(norm.clamp_running_var(self.bn.state(), var_min, var_max)["var"])


class DenseNode(_NormedNode):
    """Weights of a darknet connected (sub-)layer: ``w`` ``[out, in]`` as
    ``nn.Linear`` keeps it, ``b``, and ``bn`` with a scale only when the
    layer is batch-normalized (``ops/recurrent.py`` ``dense_apply``)."""

    def __init__(self, in_f: int, out_f: int, bn: bool, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(out_f, in_f, device=device))
        self.b = nn.Parameter(torch.empty(out_f, device=device))
        self.bn = DarkBatchNorm(out_f, True, device, shift=False) if bn else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform in ±1/√in for the weight and the bias, as
        ``ops/initializers.py`` ``linear_weight``/``conv_bias`` draw them;
        BN scale 1, mean 0, var 1.  Drawn on the CPU, as a conv's."""
        out_f, in_f = self.w.shape
        bound = 1.0 / math.sqrt(in_f) if in_f > 0 else 0.0
        self.w.copy_(torch.empty(self.w.shape).uniform_(-bound, bound, generator=generator))
        self.b.copy_(torch.empty(out_f).uniform_(-bound, bound, generator=generator))
        if self.bn is not None:
            self.bn.scale.fill_(1.0)
            self.bn.mean.zero_()
            self.bn.var.fill_(1.0)

    def params(self) -> Dict:
        p: Dict = {"w": self.w, "b": self.b}
        if self.bn is not None:
            p["bn"] = self.bn.params()
        return p


class SubLayers(nn.ModuleDict):
    """The named sub-layers of one node (the sub-convs of a DarkCsp2D or
    SppCsp2D block, the connected sub-layers of [rnn]/[gru]/[lstm], the
    sub-convs of [crnn]); ``params()``/``state()`` give the nested trees
    that the node's apply function takes.  The node is never sharded as a
    whole (``shard`` None); under tensor parallelism its sub-layers are."""

    shard = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.values():
            m.reset_parameters(generator)

    def params(self) -> Dict:
        return {name: m.params() for name, m in self.items()}

    def state(self) -> Dict:
        return {name: m.state() for name, m in self.items() if m.bn is not None}

    def write_state(self, new_state: Dict) -> None:
        for name, s in new_state.items():
            self[name].write_state(s)

    def clamp_running_var(self, var_min: Optional[float], var_max: Optional[float]) -> None:
        for m in self.values():
            m.clamp_running_var(var_min, var_max)


def _block_node(convs, bn: cfg.BatchNormConfig, device) -> SubLayers:
    """The sub-convs of a DarkCsp2D or SppCsp2D node, keyed by the
    reference's sub-layer names (``ops/blocks.py``)."""
    bias = cfg.ConvBn2D(bn=bn).bias  # a sub-conv is a default ConvBn2D
    return SubLayers({name: ConvNode(ci, co, k, 1, bias, bn, device)
                      for name, ci, co, k in convs})


def crnn_sub_cfgs(layer: cfg.DarknetCrnn) -> Dict[str, cfg.ConvBn2D]:
    """The three conv sub-layer geometries of a [crnn] node
    (crnn_layer.c:54-64: input c→hidden, self hidden→hidden, output
    hidden→out, all sharing size/pad/act/BN, darknet order); the
    reference's ``GraphModel._crnn_sub_cfgs``."""
    def sub(out_c: int) -> cfg.ConvBn2D:
        return cfg.ConvBn2D(
            c=out_c, k=layer.k, s=1, p=layer.p, d=layer.d, g=layer.g,
            bias=not layer.bn, act=layer.act,
            bn=cfg.BatchNormConfig(enabled=layer.bn), order="bn_act")
    return {"input": sub(layer.hidden), "self": sub(layer.hidden),
            "output": sub(layer.out)}


def _dense_node(layer, src_shape, device) -> nn.Module:
    """The module of a Linear or recurrent node whose input has the logical
    NCHW shape ``src_shape`` (``[N, C]`` or ``[N, C, H, W]``)."""
    dims = [d.size for d in src_shape[1:]]
    in_f = math.prod(dims)
    if isinstance(layer, cfg.Linear):
        return DenseNode(in_f, layer.out, layer.bn.enabled, device)
    if isinstance(layer, cfg.DarknetCrnn):
        in_c = {"input": dims[0], "self": layer.hidden, "output": layer.hidden}
        return SubLayers({
            name: ConvNode(in_c[name], c.c, c.k, c.g, c.bias, c.bn, device)
            for name, c in crnn_sub_cfgs(layer).items()})
    if isinstance(layer, cfg.DarknetRnn):
        subs = (("input", in_f, layer.hidden), ("self", layer.hidden, layer.hidden),
                ("output", layer.hidden, layer.out))
    elif isinstance(layer, cfg.DarknetGru):
        subs = tuple((name, in_f if name.startswith("i") else layer.out, layer.out)
                     for name in recurrent.GRU_SUBS)
    else:  # DarknetLstm: w* read the hidden state, u* the input (lstm_layer.c:44-86)
        subs = tuple((name, layer.out if name.startswith("w") else in_f, layer.out)
                     for name in recurrent.LSTM_SUBS)
    return SubLayers({name: DenseNode(i, o, layer.bn, device) for name, i, o in subs})


class GraphModel(nn.Module):
    """Any graph of the ported node kinds as one module."""

    def __init__(self, graph: Graph, *, device="cuda",
                 generator: Optional[torch.Generator] = None, remat: str = "off"):
        """``device`` defaults to ``"cuda"`` and raises without a card;
        ``generator`` seeds :meth:`init` (a CPU generator seeded 0 when
        omitted); ``remat`` is "off" or "blocks" (see the module's doc)."""
        super().__init__()
        if remat not in ("off", "blocks"):
            raise ValueError(f"remat must be off|blocks, got {remat!r}")
        device = resolve_device(device)
        self.remat = remat == "blocks"
        self.graph = graph
        self._node_sets: Dict[Tuple, frozenset] = {}
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
        self._in_c: Dict[int, int] = {}
        for key in graph.order:
            node = graph.nodes[key]
            layer = node.config
            if not isinstance(layer, (cfg.Conv2D,) + _BN_KINDS + _DENSE_KINDS):
                continue
            src = graph.nodes[node.input_keys.single_key].output_shape.tensor_shape()
            in_c = self._in_c[key] = src[1].size
            if isinstance(layer, _DENSE_KINDS):
                m = _dense_node(layer, src, device)
            elif isinstance(layer, cfg.DarkCsp2D):
                m = _block_node(blocks.dark_csp_convs(layer, in_c), layer.bn, device)
            elif isinstance(layer, cfg.SppCsp2D):
                m = _block_node(blocks.spp_csp_convs(layer, in_c), layer.bn, device)
            else:
                # a DeconvBn2D kernel is kept [out, in, k, k] like a conv's
                # (ops/conv.py); the reference rejects a grouped deconv
                bn = None if isinstance(layer, cfg.Conv2D) else layer.bn
                m = ConvNode(in_c, layer.c, layer.k, layer.g, layer.bias, bn, device)
            self.layers[module_key(self._pname[key])] = m

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.init(generator)

    def init(self, generator: torch.Generator) -> None:
        """(Re)draw every parameter from ``generator``, node by node in
        graph order."""
        for m in self.layers.values():
            m.reset_parameters(generator)

    def _node(self, key: int):
        return self.layers[module_key(self._pname[key])]

    def _apply_bn_node(self, key: int, layer, x: Tensor, train: bool) -> Tensor:
        """A node of ``_BN_KINDS``: its apply function, under checkpoint with
        ``remat="blocks"``; in training, the new running statistics it
        returns are written into the buffers here, outside the checkpoint."""
        m = self._node(key)
        if isinstance(layer, cfg.ConvBn2D):
            fn = conv.conv_bn_apply
        elif isinstance(layer, cfg.DeconvBn2D):
            fn = conv.deconv_bn_apply
        else:
            block = (blocks.dark_csp_apply if isinstance(layer, cfg.DarkCsp2D)
                     else blocks.spp_csp_apply)
            in_c = self._in_c[key]
            shards = {name: sub.shard for name, sub in m.items()}

            def fn(params, state, inp, layer, train, shard):
                return block(params, state, inp, layer, in_c, train, shards)

        def run(inp):
            return fn(m.params(), m.state(), inp, layer, train, shard=m.shard)

        if self.remat and torch.is_grad_enabled():
            out, new_state = checkpoint(run, x, use_reentrant=False)
        else:
            out, new_state = run(x)
        if train:
            m.write_state(new_state)
        return out

    def _apply_dense_node(self, key: int, layer, x: Tensor, train: bool) -> Tensor:
        """A Linear or recurrent node (``ops/recurrent.py``); in training,
        the running statistics after its last time step are written into
        the buffers."""
        m = self._node(key)
        params, state = m.params(), m.state()
        if isinstance(layer, cfg.Linear):
            out, new_state = recurrent.dense_apply(
                params, state, recurrent.flatten_nhwc(x), layer.act, train, shard=m.shard)
        elif isinstance(layer, cfg.DarknetRnn):
            out, new_state = recurrent.rnn_apply(
                params, state, x, hidden=layer.hidden, act=layer.act,
                self_act=layer.self_act, shortcut=layer.shortcut,
                time_steps=layer.time_steps, train=train)
        elif isinstance(layer, cfg.DarknetGru):
            out, new_state = recurrent.gru_apply(
                params, state, x, out_f=layer.out, time_steps=layer.time_steps, train=train)
        elif isinstance(layer, cfg.DarknetLstm):
            out, new_state = recurrent.lstm_apply(
                params, state, x, out_f=layer.out, time_steps=layer.time_steps, train=train)
        else:
            out, new_state = recurrent.crnn_apply(
                params, state, x, sub_cfgs=crnn_sub_cfgs(layer), hidden=layer.hidden,
                shortcut=layer.shortcut, time_steps=layer.time_steps, train=train)
        if train:
            m.write_state(new_state)
        return out

    def _nodes_for(self, output_keys: Tuple[int, ...], train: bool) -> frozenset:
        """The nodes a forward for ``output_keys`` runs: their ancestors, and
        in training also every node with BN statistics and its ancestors
        (the reference's ``new_state`` updates them whether or not its
        output is requested)."""
        cache_key = (output_keys, train)
        nodes = self._node_sets.get(cache_key)
        if nodes is None:
            roots = list(output_keys)
            if train:
                roots += [k for k in self.graph.order
                          if isinstance(self.graph.nodes[k].config, _BN_KINDS + _DENSE_KINDS)]
            seen = set()
            while roots:
                key = roots.pop()
                if key not in seen:
                    seen.add(key)
                    roots.extend(self.graph.nodes[key].input_keys.iter_keys())
            nodes = self._node_sets[cache_key] = frozenset(seen)
        return nodes

    def forward(self, x: Tensor, data_format: str = "NCHW", *, train: bool = False,
                output_keys: Optional[Tuple[int, ...]] = None,
                generator: Optional[torch.Generator] = None):
        """Forward → the graph output, a MergedDetection for YOLO.

        ``train=False`` normalizes BN with the running statistics.
        ``train=True`` normalizes with the batch statistics and writes the
        updated running mean/var into each ``DarkBatchNorm``'s buffers in
        place, under ``torch.no_grad()`` — the port's form of the
        reference's returned ``new_state``.  Successive calls (micro-batches)
        therefore thread the state sequentially, as the reference's
        ``lax.scan`` over micro-batches does.

        ``output_keys`` (the reference's ``apply(output_keys=...)``) returns
        ``{key: output}`` for those nodes instead, and runs only what they
        need (:meth:`_nodes_for`): given the raw head convs
        (``graph.detect_head_input_keys()``), the decode and merge tail is
        skipped, as the reference's jit drops it as dead code.

        ``generator`` (the reference's ``rng``) draws the Dropout masks when
        ``train=True``; without it Dropout passes its input through.
        """
        run = None if output_keys is None else self._nodes_for(tuple(output_keys), train)
        if data_format == "NHWC":
            x = x.permute(0, 3, 1, 2)
        elif data_format != "NCHW":
            raise ValueError(f"unknown data_format {data_format!r}")

        outputs: Dict[int, object] = {}
        for key in self.graph.order:
            if run is not None and key not in run:
                continue
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
            elif isinstance(layer, _BN_KINDS):
                outputs[key] = self._apply_bn_node(key, layer, outputs[ik.single_key], train)
            elif isinstance(layer, cfg.Conv2D):
                m = self._node(key)
                h, groups = outputs[ik.single_key], layer.g
                if m.shard is not None:
                    h, groups = m.shard.enter(h, groups)
                h = conv.conv2d_apply(h, m.w, m.b, stride=layer.s, padding=layer.padding,
                                      dilation=layer.d, groups=groups)
                outputs[key] = h if m.shard is None else m.shard.leave(h)
            elif isinstance(layer, cfg.UpSample2D):
                if layer.stride is not None and layer.reverse:
                    outputs[key] = simple.downsample2d(outputs[ik.single_key], layer.stride)
                else:
                    outputs[key] = simple.upsample2d(outputs[ik.single_key], layer.scale)
            elif isinstance(layer, cfg.DynamicPad2D):
                outputs[key] = simple.dynamic_pad2d(
                    outputs[ik.single_key], layer.t, layer.b, layer.l, layer.r,
                    layer.pad_kind)
            elif isinstance(layer, cfg.Sum2D):
                outputs[key] = simple.sum2d([outputs[k] for k in ik.iter_keys()])
            elif isinstance(layer, cfg.Concat2D):
                outputs[key] = simple.concat2d([outputs[k] for k in ik.iter_keys()])
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
            elif isinstance(layer, cfg.DarknetSam):
                a, b = (outputs[k] for k in ik.iter_keys())
                outputs[key] = a * b
            elif isinstance(layer, cfg.DarknetScaleChannels):
                # scale is [b, c, 1, 1] (SE) or [b, 1, h, w] (scale_wh)
                scale, target = (outputs[k] for k in ik.iter_keys())
                outputs[key] = scale * target
            elif isinstance(layer, cfg.Reorg2D):
                outputs[key] = _reorg(outputs[ik.single_key], layer)
            elif isinstance(layer, _DENSE_KINDS):
                outputs[key] = self._apply_dense_node(key, layer, outputs[ik.single_key], train)
            elif isinstance(layer, cfg.GlobalAvgPool2D):
                # darknet avgpool keeps a 1x1 map
                outputs[key] = torch.mean(outputs[ik.single_key], dim=(2, 3), keepdim=True)
            elif isinstance(layer, cfg.Identity):
                outputs[key] = outputs[ik.single_key]
            elif isinstance(layer, cfg.Dropout):
                h = outputs[ik.single_key]
                if train and generator is not None:
                    keep = 1.0 - layer.probability
                    mask = torch.rand(h.shape, generator=generator,
                                      device=generator.device).to(h.device) < keep
                    h = torch.where(mask, h / keep, torch.zeros_like(h))
                outputs[key] = h
            elif isinstance(layer, cfg.Softmax):
                # over channels: dim 1 of NCHW, the last dim of a flat [b, n]
                h = outputs[ik.single_key]
                outputs[key] = torch.softmax(h, dim=1 if h.dim() == 4 else -1)
            elif isinstance(layer, cfg.Yolov1Detection):
                outputs[key] = _yolov1_detection(outputs[ik.single_key], layer)
            else:  # pragma: no cover - every kind of the IR is handled above
                raise NotImplementedError(layer.kind)

            if key in self._sg_keys:
                outputs[key] = _detach(outputs[key])
        if output_keys is not None:
            return {k: outputs[k] for k in output_keys}
        return outputs[self.output_key]

    @torch.no_grad()
    def clamp_running_vars(self) -> None:
        """Clamp every BN running variance to its node's var_min/var_max, in
        place (model.rs:412-422 → dark_batch_norm.rs:148-172); a block's
        sub-convs take the block's.  Called after each optimizer step.

        The dense and recurrent kinds are not clamped, as in the reference:
        a recurrent layer's ``bn`` is a plain bool with no clamp knobs, and
        the reference's clamp looks for a Linear's statistics one level
        deeper than it keeps them (builder.py:752-787)."""
        for key in self.graph.order:
            layer = self.graph.nodes[key].config
            if not isinstance(layer, _BN_KINDS):
                continue
            bn_cfg = layer.bn
            if bn_cfg.var_min is None and bn_cfg.var_max is None:
                continue
            self._node(key).clamp_running_var(bn_cfg.var_min, bn_cfg.var_max)


class YoloModel(GraphModel):
    """A detection model: validates the MergeDetect2D sink and a uniform
    class count (model.rs:330-353)."""

    def __init__(self, graph: Graph, *, device="cuda",
                 generator: Optional[torch.Generator] = None, remat: str = "off"):
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
        super().__init__(graph, device=device, generator=generator, remat=remat)
        self.num_classes: int = classes.pop()
        self.anchors: Tuple = tuple(n.config.anchors for n in det_nodes)

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
Linear, DarknetRnn, DarknetGru, DarknetLstm and DarknetCrnn.

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
the node's apply function calls around the conv and for BN; a recurrent
node holds a ``SequenceShard`` (its time loop over the micro-batch's
global rows, its sub-layers' ``LayerShard``s), under pipeline parallelism
too; the graph walk is the same.

The reference's layout rewrites, behind its own knobs; each changes only
the plan, never the parameters or their names:

- ``spd_stem``: "auto" (and its alias "stem") runs an eligible darknet
  stem ``Input → conv(k3, s1) → conv(k3, s2)`` over space-to-depth maps
  (``ops/spd_stem.py``); "deep" also packs the stage-1 residual pair
  ``conv(1×1) → conv(3×3) → shortcut`` that follows it; "off" runs neither.
- ``fold_region``: "on" runs the low-channel shape-preserving convs, and
  the sums and shortcuts between them, W-folded (``ops/fold_region.py``).

The port's defaults are ``spd_stem="off"`` and ``fold_region="off"``; the
reference's ``spd_stem`` default is "auto".  A rewrite is skipped, and the
nodes run one by one, where the reference skips it (odd H or W at the
stem; a ``node_subset`` without the whole trio or quintet; any
``node_overrides`` for the stem; any ``node_subset`` for the fold) and
where the reference could not run it: ``output_keys`` naming a node inside
a fused trio or quintet other than its last, or a node of the rewrite
holding a tensor-parallel ``shard`` (the packed kernel of a cut layer is
not the cut of the packed kernel).  A folded region node's output is
unfolded only where a node outside the region, ``output_keys`` or the
graph output reads it (the reference leaves the unused ones to its
compiler's dead-code pass).  ``remat="blocks"`` checkpoints the two SPD
functions, not the fold, as the reference does.
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
from ..ops import blocks, conv, detect, fold_region, norm, recurrent, simple, spd_stem
from ..utils.timing import spanned

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
    that the node's apply function takes.  The node is never cut as a
    whole; under tensor parallelism its sub-layers are.  A recurrent node's
    ``shard`` is its parallel context (``parallel/tp.py``
    ``SequenceShard``) under tensor or pipeline parallelism, else None."""

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
                 generator: Optional[torch.Generator] = None, remat: str = "off",
                 spd_stem: str = "off", fold_region: str = "off"):
        """``device`` defaults to ``"cuda"`` and raises without a card;
        ``generator`` seeds :meth:`init` (a CPU generator seeded 0 when
        omitted); ``remat`` is "off" or "blocks"; ``spd_stem`` "off",
        "auto", "stem" or "deep"; ``fold_region`` "off" or "on" (see the
        module's doc)."""
        super().__init__()
        if remat not in ("off", "blocks"):
            raise ValueError(f"remat must be off|blocks, got {remat!r}")
        if spd_stem not in ("off", "auto", "stem", "deep"):
            raise ValueError(f"spd_stem must be off|auto|stem|deep, got {spd_stem!r}")
        if fold_region not in ("off", "on"):
            raise ValueError(f"fold_region must be off|on, got {fold_region!r}")
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

        self._consumers: Dict[int, set] = {key: set() for key in graph.nodes}
        for node in graph.nodes.values():
            for k in node.input_keys.iter_keys():
                self._consumers[k].add(node.key)
        self._spd_pair = self._spd_res = None
        if spd_stem != "off":
            self._spd_pair = self._detect_spd_pair()
        if spd_stem == "deep" and self._spd_pair is not None:
            self._spd_res = self._detect_spd_res()
        self._fold_keys = self._detect_fold_region() if fold_region == "on" else frozenset()
        self._fold_convs = tuple(k for k in graph.order if k in self._fold_keys
                                 and isinstance(graph.nodes[k].config, cfg.ConvBn2D))

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.init(generator)

    def _detect_spd_pair(self) -> Optional[Tuple[int, int, int]]:
        """(Input, conv0, conv1) of the space-to-depth stem, or None: the
        graph starts with Input → conv0 → conv1, conv0 has no other
        consumer, the pair is eligible (``spd_stem.stem_is_eligible``), and
        the two convs share their freeze status (the fused stem detaches its
        output once).  The reference's conditions (builder.py:106-130)."""
        graph = self.graph
        if len(graph.order) < 3:
            return None
        k_in, k0, k1 = graph.order[:3]
        n_in, n0, n1 = (graph.nodes[k] for k in (k_in, k0, k1))
        if (isinstance(n_in.config, cfg.Input)
                and n0.input_keys.kind == "single" and n0.input_keys.single_key == k_in
                and n1.input_keys.kind == "single" and n1.input_keys.single_key == k0
                and self._consumers[k0] == {k1}
                and spd_stem.stem_is_eligible(n0.config, n1.config)
                and (k0 in self._sg_keys) == (k1 in self._sg_keys)):
            return k_in, k0, k1
        return None

    def _detect_spd_res(self) -> Optional[Tuple[int, int, int]]:
        """(conv2, conv3, shortcut) of the stage-1 residual pair after the
        stem, or None: conv(1×1) → conv(3×3) → a weightless shortcut back to
        the stem's output, nothing else reading them, output channels equal,
        one freeze status (builder.py:143-174)."""
        graph = self.graph
        if len(graph.order) < 6:
            return None
        k1 = self._spd_pair[2]
        k2, k3, k4 = graph.order[3:6]
        n1, n2, n3, n4 = (graph.nodes[k] for k in (k1, k2, k3, k4))
        ins4 = list(n4.input_keys.iter_keys())
        if (n2.input_keys.kind == "single" and n2.input_keys.single_key == k1
                and n3.input_keys.kind == "single" and n3.input_keys.single_key == k2
                and isinstance(n4.config, cfg.DarknetShortcut)
                and set(ins4) == {k3, k1} and len(ins4) == 2
                and n4.config.weights_type == "none"
                and self._consumers[k1] == {k2, k4}
                and self._consumers[k2] == {k3}
                and self._consumers[k3] == {k4}
                and spd_stem.res_block_is_eligible(n2.config, n3.config)
                and n3.config.c == n1.config.c
                and len({k in self._sg_keys for k in (k2, k3, k4)}) == 1):
            return k2, k3, k4
        return None

    def _detect_fold_region(self) -> frozenset:
        """Nodes to run W-folded: the foldable convs
        (``fold_region.conv_is_foldable``), and the Sum2D / weightless
        DarknetShortcut nodes that read one of them, when all their inputs
        have one fully known shape (builder.py:200-241)."""
        region = set()
        for key in self.graph.order:
            node = self.graph.nodes[key]
            layer = node.config
            ikeys = list(node.input_keys.iter_keys())
            if isinstance(layer, cfg.ConvBn2D):
                if len(ikeys) == 1 and fold_region.conv_is_foldable(layer, self._in_c[key]):
                    region.add(key)
            elif isinstance(layer, (cfg.Sum2D, cfg.DarknetShortcut)):
                if not any(k in region for k in ikeys):
                    continue
                if isinstance(layer, cfg.DarknetShortcut) and layer.weights_type != "none":
                    continue
                shapes = set()
                for k in ikeys:
                    s = self.graph.nodes[k].output_shape
                    if not s.is_tensor or not all(d.is_known for d in s.tensor_shape()[1:]):
                        break
                    shapes.add(tuple(d.size for d in s.tensor_shape()[1:]))
                else:
                    if len(shapes) == 1:
                        region.add(key)
        return frozenset(region)

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

    def _sharded(self, keys) -> bool:
        return any(self._node(k).shard is not None for k in keys)

    def _apply_spd(self, fn, keys: Tuple[int, int], extra: tuple, x: Tensor,
                   train: bool) -> Tensor:
        """``fn`` (``spd_stem_apply`` or ``spd_res_block_apply``) over the
        conv nodes ``keys``, under checkpoint with ``remat="blocks"``; in
        training the two new BN states are written here, outside it, as
        :meth:`_apply_bn_node` writes them."""
        ka, kb = keys
        ma, mb = self._node(ka), self._node(kb)
        la, lb = self.graph.nodes[ka].config, self.graph.nodes[kb].config

        def run(inp):
            return fn(ma.params(), ma.state(), la, mb.params(), mb.state(), lb, *extra,
                      inp, train)

        if self.remat and torch.is_grad_enabled():
            out, sa, sb = checkpoint(run, x, use_reentrant=False)
        else:
            out, sa, sb = run(x)
        if train:
            ma.write_state(sa)
            mb.write_state(sb)
        return out

    def _run_spd(self, x: Optional[Tensor], train: bool, run, output_keys,
                 node_overrides, outputs: Dict[int, object]) -> set:
        """The SPD stem (and the deep region) when ``forward``'s arguments
        allow them: their outputs go into ``outputs`` → the keys they
        replace."""
        if (self._spd_pair is None or node_overrides or x is None
                or x.shape[2] % 2 or x.shape[3] % 2):
            return set()
        asked = set(output_keys or ())
        k_in, k0, k1 = self._spd_pair
        if ((run is not None and not {k_in, k0, k1} <= run) or k0 in asked
                or self._sharded((k0, k1))):
            return set()
        out1 = self._apply_spd(spd_stem.spd_stem_apply, (k0, k1), (), x, train)
        outputs[k_in] = x
        outputs[k1] = out1.detach() if k1 in self._sg_keys else out1
        done = {k_in, k0, k1}
        if self._spd_res is None or out1.shape[2] % 2 or out1.shape[3] % 2:
            return done
        k2, k3, k4 = self._spd_res
        if ((run is not None and not {k2, k3, k4} <= run) or asked & {k2, k3}
                or self._sharded((k2, k3))):
            return done
        out4 = self._apply_spd(spd_stem.spd_res_block_apply, (k2, k3),
                               (self.graph.nodes[k4].config.act,), out1, train)
        outputs[k4] = out4.detach() if k4 in self._sg_keys else out4
        return done | {k2, k3, k4}

    def _apply_fold_node(self, key: int, layer, ik, outputs: Dict[int, object],
                         folded: Dict[int, Tensor], train: bool) -> Optional[Tensor]:
        """A region node on W-folded maps → its folded output, or None when
        an input's width is no multiple of ``FOLD`` (the node then runs
        canonically).  An input is folded once and kept in ``folded``."""

        def folded_input(k: int) -> Optional[Tensor]:
            if k not in folded:
                t = outputs[k]
                if not isinstance(t, Tensor) or t.dim() != 4 or t.shape[3] % fold_region.FOLD:
                    return None
                folded[k] = fold_region.fold_w(t)
            return folded[k]

        if isinstance(layer, cfg.ConvBn2D):
            xf = folded_input(ik.single_key)
            if xf is None:
                return None
            m = self._node(key)
            out_f, new_state = fold_region.fold_conv_bn_apply(
                m.params(), m.state(), xf, layer, train)
            if train:
                m.write_state(new_state)
        else:  # Sum2D / DarknetShortcut over inputs of one shape
            ins = [folded_input(k) for k in ik.iter_keys()]
            if any(t is None for t in ins):
                return None
            out_f = ins[0]
            for other in ins[1:]:
                out_f = out_f + other
            if isinstance(layer, cfg.DarknetShortcut):
                out_f = activations.apply(layer.act, out_f)
        return out_f.detach() if key in self._sg_keys else out_f

    def _apply_dense_node(self, key: int, layer, x: Tensor, train: bool) -> Tensor:
        """A Linear or recurrent node (``ops/recurrent.py``), with its
        parallel context ``shard`` (a Linear's ``LayerShard``, a recurrent
        node's ``SequenceShard``); in training, the running statistics
        after its last time step are written into the buffers."""
        m = self._node(key)
        params, state = m.params(), m.state()
        if isinstance(layer, cfg.Linear):
            out, new_state = recurrent.dense_apply(
                params, state, recurrent.flatten_nhwc(x), layer.act, train, shard=m.shard)
        elif isinstance(layer, cfg.DarknetRnn):
            out, new_state = recurrent.rnn_apply(
                params, state, x, hidden=layer.hidden, act=layer.act,
                self_act=layer.self_act, shortcut=layer.shortcut,
                time_steps=layer.time_steps, train=train, shard=m.shard)
        elif isinstance(layer, cfg.DarknetGru):
            out, new_state = recurrent.gru_apply(
                params, state, x, out_f=layer.out, time_steps=layer.time_steps, train=train,
                shard=m.shard)
        elif isinstance(layer, cfg.DarknetLstm):
            out, new_state = recurrent.lstm_apply(
                params, state, x, out_f=layer.out, time_steps=layer.time_steps, train=train,
                shard=m.shard)
        else:
            out, new_state = recurrent.crnn_apply(
                params, state, x, sub_cfgs=crnn_sub_cfgs(layer), hidden=layer.hidden,
                shortcut=layer.shortcut, time_steps=layer.time_steps, train=train,
                shard=m.shard)
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

    @spanned("yolodl.model.forward")
    def forward(self, x: Optional[Tensor], data_format: str = "NCHW", *, train: bool = False,
                output_keys: Optional[Tuple[int, ...]] = None,
                generator: Optional[torch.Generator] = None,
                node_overrides: Optional[Dict[int, Tensor]] = None,
                node_subset: Optional[frozenset] = None):
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

        ``node_subset`` and ``node_overrides`` (the reference's) run a
        pipeline stage (``parallel/pipeline.py``): only the nodes of
        ``node_subset``, with the outputs of nodes outside it that they read
        taken from ``node_overrides`` (``{key: NCHW tensor}``); ``x`` may be
        None when the Input node is not in the subset.  With
        ``output_keys`` an override can be an output too (a tensor that
        passes through the stage), returned as it was given.
        """
        if node_subset is not None:
            run = node_subset
        elif output_keys is not None:
            run = self._nodes_for(tuple(output_keys), train)
        else:
            run = None
        if x is not None and data_format == "NHWC":
            x = x.permute(0, 3, 1, 2)
        elif data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown data_format {data_format!r}")

        outputs: Dict[int, object] = dict(node_overrides or {})
        done = self._run_spd(x, train, run, output_keys, node_overrides, outputs)
        # W-folded region outputs; a region node's unfolded output is made
        # only where something outside the region reads it (unfolded())
        folded: Dict[int, Tensor] = {}
        fold = (bool(self._fold_keys) and node_subset is None
                and not self._sharded(self._fold_convs))

        def unfolded(k: int):
            if k not in outputs and k in folded:
                outputs[k] = fold_region.unfold_w(folded[k])
            return outputs[k]

        for key in self.graph.order:
            if key in outputs or key in done or (run is not None and key not in run):
                continue
            node = self.graph.nodes[key]
            layer = node.config
            ik = node.input_keys
            if fold and key in self._fold_keys:
                out_f = self._apply_fold_node(key, layer, ik, outputs, folded, train)
                if out_f is not None:
                    folded[key] = out_f
                    continue
            if folded:
                for k in ik.iter_keys():
                    unfolded(k)

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
            return {k: unfolded(k) for k in output_keys}
        return unfolded(self.output_key)

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
            # a pipeline stage's model holds only its own nodes
            if not isinstance(layer, _BN_KINDS) or module_key(self._pname[key]) not in self.layers:
                continue
            bn_cfg = layer.bn
            if bn_cfg.var_min is None and bn_cfg.var_max is None:
                continue
            self._node(key).clamp_running_var(bn_cfg.var_min, bn_cfg.var_max)


class YoloModel(GraphModel):
    """A detection model: validates the MergeDetect2D sink and a uniform
    class count (model.rs:330-353)."""

    def __init__(self, graph: Graph, *, device="cuda",
                 generator: Optional[torch.Generator] = None, remat: str = "off",
                 spd_stem: str = "off", fold_region: str = "off"):
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
        super().__init__(graph, device=device, generator=generator, remat=remat,
                         spd_stem=spd_stem, fold_region=fold_region)
        self.num_classes: int = classes.pop()
        self.anchors: Tuple = tuple(n.config.anchors for n in det_nodes)

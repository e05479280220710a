"""Plain darknet network: the cfg reader and the forward of the section
kinds that yolov4.cfg and yolov4-csp.cfg use.

Sections: [net], [convolutional] (batch_normalize, filters, size, stride,
pad, activation mish / leaky / logistic / linear), [route] (layers),
[shortcut] (from, activation linear), [maxpool] (size, stride, darknet's
padding of size - 1), [upsample] (stride, nearest) and [yolo].

Batch norm is the YOLO reference's, as the measured program states it:
eps 1e-4; in training the batch's mean and its biased variance
E[x^2] - E[x]^2, clamped at 0; in inference the running statistics.  Every
operation is plain PyTorch in float32.  One departure from darknet, with
the same result: a head conv whose activation is ``logistic``
(``new_coords=1``) stays linear here, and the decode applies the sigmoid
(darknet's yolo layer applies none after it), so that the loss reads
logits.

``forward`` returns the raw head maps [B, A*(5+C), H, W], in the order of
the cfg's [yolo] sections.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-4


def parse_sections(text: str) -> List[Tuple[str, Dict[str, str]]]:
    """[(kind, {key: value})] in file order; comments and blanks dropped."""
    sections: List[Tuple[str, Dict[str, str]]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].split(";", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            sections.append((line.strip("[]").strip(), {}))
        else:
            key, value = line.split("=", 1)
            sections[-1][1][key.strip()] = value.strip()
    return sections


def _ints(value: str) -> List[int]:
    return [int(v) for v in value.split(",") if v.strip()]


def _floats(value: str) -> List[float]:
    return [float(v) for v in value.split(",") if v.strip()]


@dataclasses.dataclass
class Layer:
    index: int
    kind: str
    inputs: Tuple[int, ...]     # absolute indices of the layers it reads; -1 = the image
    out_c: int
    out_hw: Tuple[int, int]
    opts: Dict[str, object]


@dataclasses.dataclass(frozen=True)
class YoloHead:
    layer: int                  # index of the [yolo] section
    anchors: Tuple[Tuple[float, float], ...]  # (w, h) pixels of the net input, masked
    classes: int
    scale_xy: float
    new_coords: bool
    nms_kind: str               # "greedy" | "diou"
    beta_nms: float
    feature_hw: Tuple[int, int]


class Network:
    """A darknet cfg at a square input of ``size`` pixels."""

    def __init__(self, text: str, size: int):
        sections = parse_sections(text)
        if sections[0][0] != "net":
            raise ValueError("a darknet cfg starts with [net]")
        self.net = dict(sections[0][1])
        self.size = size
        self.layers: List[Layer] = []
        self.heads: List[YoloHead] = []
        c, hw = int(self.net.get("channels", 3)), (size, size)
        for i, (kind, o) in enumerate(sections[1:]):
            prev = i - 1
            if kind == "convolutional":
                k, s = int(o.get("size", 1)), int(o.get("stride", 1))
                pad = k // 2 if int(o.get("pad", 0)) else int(o.get("padding", 0))
                out_c = int(o["filters"])
                hw = ((hw[0] + 2 * pad - k) // s + 1, (hw[1] + 2 * pad - k) // s + 1)
                layer = Layer(i, kind, (prev,), out_c, hw, dict(
                    k=k, stride=s, pad=pad, in_c=c, bn=bool(int(o.get("batch_normalize", 0))),
                    act=o.get("activation", "logistic")))
            elif kind == "route":
                srcs = tuple(j if j >= 0 else i + j for j in _ints(o["layers"]))
                out_c = sum(self.layers[j].out_c for j in srcs)
                hw = self.layers[srcs[0]].out_hw
                layer = Layer(i, kind, srcs, out_c, hw, {})
            elif kind == "shortcut":
                src = _ints(o["from"])[0]
                src = src if src >= 0 else i + src
                if o.get("activation", "linear") != "linear":
                    raise ValueError("only linear shortcuts are read")
                layer = Layer(i, kind, (prev, src), c, hw, {})
            elif kind == "maxpool":
                k = int(o.get("size", o.get("stride", 1)))
                s = int(o.get("stride", 1))
                pad = int(o.get("padding", k - 1))
                hw = ((hw[0] + pad - k) // s + 1, (hw[1] + pad - k) // s + 1)
                layer = Layer(i, kind, (prev,), c, hw, dict(k=k, stride=s, pad=pad))
            elif kind == "upsample":
                s = int(o.get("stride", 2))
                hw = (hw[0] * s, hw[1] * s)
                layer = Layer(i, kind, (prev,), c, hw, dict(stride=s))
            elif kind == "yolo":
                mask = _ints(o["mask"])
                pairs = _floats(o["anchors"])
                anchors = tuple((pairs[2 * m], pairs[2 * m + 1]) for m in mask)
                classes = int(o.get("classes", 20))
                if self.layers[prev].out_c != len(mask) * (5 + classes):
                    raise ValueError(f"[yolo] {i}: head channels do not match")
                self.heads.append(YoloHead(
                    i, anchors, classes, float(o.get("scale_x_y", 1.0)),
                    bool(int(o.get("new_coords", 0))),
                    "diou" if o.get("nms_kind", "default") == "diounms" else "greedy",
                    float(o.get("beta_nms", 0.6)), hw))
                layer = Layer(i, kind, (prev,), c, hw, {})
            else:
                raise ValueError(f"section [{kind}] is not read by the reference")
            self.layers.append(layer)
            c = layer.out_c

    @property
    def convs(self) -> List[Layer]:
        return [layer for layer in self.layers if layer.kind == "convolutional"]

    def head_conv(self, head: YoloHead) -> Layer:
        return self.layers[head.layer - 1]

    def forward(self, x: torch.Tensor, params: Dict[int, Dict[str, torch.Tensor]], *,
                train: bool, quant: Optional[Callable] = None, remat: bool = False,
                stats: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = None
                ) -> List[torch.Tensor]:
        """Raw head maps of the image batch ``x`` [B, 3, S, S] float32.

        ``train`` normalizes with the batch's statistics; ``stats`` (a dict)
        then receives each BN layer's (mean, biased var).  ``quant`` maps a
        conv's input and weight before the product (the control's lower
        precision).  ``remat`` recomputes each layer in the backward pass
        instead of keeping its intermediates (same values, less memory).
        With ``quant`` every tensor a layer hands on (the conv's output
        after batch norm, the activation's, a shortcut's sum) is rounded
        too, as a program computing in that precision would hold it."""
        outs: List[torch.Tensor] = []
        heads: List[torch.Tensor] = []
        for layer in self.layers:
            inp = x if layer.inputs[0] < 0 else outs[layer.inputs[0]]
            if layer.kind == "convolutional":
                p = params[layer.index]
                if remat and torch.is_grad_enabled():
                    y = checkpoint(_conv_layer, inp, p, layer, train, quant, None,
                                   use_reentrant=False)
                else:
                    y = _conv_layer(inp, p, layer, train, quant, stats)
            elif layer.kind == "route":
                y = torch.cat([outs[j] for j in layer.inputs], dim=1)
            elif layer.kind == "shortcut":
                y = outs[layer.inputs[0]] + outs[layer.inputs[1]]
                if quant is not None:
                    y = quant(y)
            elif layer.kind == "maxpool":
                y = _maxpool(inp, layer)
            elif layer.kind == "upsample":
                y = F.interpolate(inp, scale_factor=layer.opts["stride"], mode="nearest")
            else:  # yolo
                heads.append(inp)
                y = inp
            outs.append(y)
        return heads


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


ACTIVATIONS = {
    "mish": lambda x: x * torch.tanh(softplus(x)),
    "leaky": lambda x: torch.clamp(x, min=0.0) + torch.clamp(x, max=0.0) * 0.1,
    "linear": lambda x: x,
}


def _conv_layer(x, p, layer: Layer, train: bool, quant, stats):
    w = p["w"]
    if quant is not None:
        x, w = quant(x), quant(w, per_channel=True)
    y = F.conv2d(x, w, p.get("b"), stride=layer.opts["stride"], padding=layer.opts["pad"])
    if layer.opts["bn"]:
        if train:
            mean = torch.mean(y, dim=(0, 2, 3))
            var = torch.clamp(torch.mean(torch.square(y), dim=(0, 2, 3)) - torch.square(mean),
                              min=0.0)
            if stats is not None:
                stats[layer.index] = (mean.detach(), var.detach())
        else:
            mean, var = p["mean"], p["var"]
        inv = torch.rsqrt(var + BN_EPS) * p["scale"]
        y = y * inv.view(1, -1, 1, 1) + (p["bias"] - mean * inv).view(1, -1, 1, 1)
    if quant is not None:
        y = quant(y)
    act = layer.opts["act"]
    if act == "logistic":   # a new_coords head: the decode applies the sigmoid
        act = "linear"
    y = ACTIVATIONS[act](y)
    return y if quant is None or act == "linear" else quant(y)


def _maxpool(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """darknet's maxpool: ``pad`` in all, pad // 2 before; padding never wins."""
    k, s, pad = layer.opts["k"], layer.opts["stride"], layer.opts["pad"]
    before = pad // 2
    x = F.pad(x, (before, pad - before, before, pad - before), value=float("-inf"))
    return F.max_pool2d(x, k, s)

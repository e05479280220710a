"""Weights made from the seed, on the device, handed to the program and to
the reference alike.

Every conv weight is normal with standard deviation 1 / sqrt(fan_in)
(``HEAD_GAIN`` times that for a head's objectness and class outputs, so
that confidences spread from the threshold towards 1), a batch-normalized
layer's scale ``bn_scale`` x (1 + 0.1 z) and shift ``bn_shift`` + 0.1 z, a head conv's bias 0.1 z: one draw of a ``torch.Generator`` on the device for all of
them, cut into the leaves.  Running statistics start at mean 0, var 1.

For inference cells, ``calibrate`` then sets every layer's running
statistics to the batch statistics of a few of the cell's own images
(computed by the reference in float32), each variance raised to at least
``VAR_FLOOR`` x the layer's median, and shifts each head's objectness bias
by one common offset, so that the reference's NMS keeps a fixed number of
detections an image over all of the cell's images: the cell's
``kept_per_image``, COCO's mean number of objects an image.  Every seed
thus gives the host the same amount of detections to unpack.
Training cells take ``bn_scale`` 0.1 (a workload parameter): with batch
statistics and scales near 1 the random network amplifies any perturbation
so far that rounding in float32 on the card moves the median leaf's
gradient norm 2 %, as much as bfloat16 does, and a float8 control hardly
more; at 0.1 (CPU, 96²) bfloat16 moves it 0.4 % and float8 10 %.  Leaky's
kink at 0 does not scale away, so the leaky model's train cell also takes
``bn_shift`` 0.3, which keeps most units on the kink's linear side (CPU,
96²: bfloat16 0.7 %, float8 12 %; without it 3 % and 4 to 7 %).
Random weights otherwise leave the heads at sigmoid(0) = 0.5, every
confidence at the threshold, and NMS with nothing to decide.  The floor
keeps the network from amplifying rounding: with the statistics alone, a
bfloat16 forward moved the head logits of these random networks by 20 to
90 % of their spread against float32 (256 x 256 on the CPU); with the
floor at 1.25 x the median, by 0.4 to 3 %, while images still move the
logits by 12 to 27 % of their spread.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import detect as ref_detect
from .reference.darknet import Network
from .reference.precision import full_precision

Params = Dict[int, Dict[str, torch.Tensor]]
# running variances below this share of the layer's median are raised to it
VAR_FLOOR = 1.25
# the heads' objectness and class weights are this many times the others'
HEAD_GAIN = 8.0
# the objectness offset is searched for until the kept count is this close
KEPT_TOL = 0.02
KEPT_ROUNDS = 8
KEPT_BLOCK = 32


def make_weights(net: Network, seed: int, device, bn_scale: float = 1.0,
                 bn_shift: float = 0.0) -> Params:
    shapes = []
    for layer in net.convs:
        o, i, k = layer.out_c, layer.opts["in_c"], layer.opts["k"]
        shapes.append((layer.index, "w", (o, i, k, k)))
        if layer.opts["bn"]:
            shapes += [(layer.index, "scale", (o,)), (layer.index, "bias", (o,))]
        else:
            shapes.append((layer.index, "b", (o,)))
    total = sum(math.prod(s) for _, _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params: Params = {layer.index: {} for layer in net.convs}
    at = 0
    for index, leaf, shape in shapes:
        n = math.prod(shape)
        v = z[at:at + n].view(shape)
        at += n
        if leaf == "w":
            v = v * (1.0 / math.sqrt(shape[1] * shape[2] * shape[3]))
        elif leaf == "scale":
            v = bn_scale * (1.0 + 0.1 * v)
        elif leaf == "bias":
            v = bn_shift + 0.1 * v
        else:
            v = 0.1 * v
        params[index][leaf] = v.contiguous()
    for head in net.heads:   # objectness and class logits spread wider than box offsets
        conv = net.head_conv(head)
        w = params[conv.index]["w"].view(len(head.anchors), 5 + head.classes, -1)
        w[:, 4:] *= HEAD_GAIN
    for layer in net.convs:
        if layer.opts["bn"]:
            params[layer.index]["mean"] = torch.zeros(layer.out_c, device=device)
            params[layer.index]["var"] = torch.ones(layer.out_c, device=device)
    return params


@torch.no_grad()
def calibrate(net: Network, params: Params, stat_images: torch.Tensor, blocks, conf_thresh: float,
              iou_thresh: float, kind: str, beta: float, max_dets: int,
              kept_per_image: float) -> None:
    """Running statistics from ``stat_images`` [B, 3, S, S] float32 in
    [0, 1]; then each head's objectness bias moved by one common offset,
    so that the reference keeps ``kept_per_image`` detections an image, to
    within ``KEPT_TOL``, over the images of ``blocks`` (each [b, 3, S, S]
    on the device)."""
    with full_precision():
        stats: Dict[int, tuple] = {}
        net.forward(stat_images, params, train=True, stats=stats)
        for index, (mean, var) in stats.items():
            floor = VAR_FLOOR * torch.median(var)
            params[index]["mean"], params[index]["var"] = mean, torch.clamp(var, min=floor)
        parts = []
        for x in blocks:   # each cell's box, objectness and best class logit
            d = ref_detect.decode(net, net.forward(x.float(), params, train=False))
            parts.append((d.cycxhw, d.obj_logit, d.class_logit.max(-1, keepdim=True).values))
    dense = ref_detect.Dense(*(torch.cat(t) for t in zip(*parts)), d.feature_hw, d.anchors)
    order = torch.sort(_offsets_to_pass(dense, conf_thresh).flatten()).values
    images = dense.obj_logit.shape[0]
    target = kept_per_image * images
    n = 2 * target
    for _ in range(KEPT_ROUNDS):   # n cells pass; the NMS keeps some of them
        n = min(max(1, round(n)), order.numel() - 1)
        shift = float(order[n - 1] + order[n]) / 2
        kept = 0
        for start in range(0, images, KEPT_BLOCK):
            block = ref_detect.Dense(dense.cycxhw[start:start + KEPT_BLOCK],
                                     dense.obj_logit[start:start + KEPT_BLOCK] + shift,
                                     dense.class_logit[start:start + KEPT_BLOCK],
                                     dense.feature_hw, dense.anchors)
            kept += int(ref_detect.survivors(block, conf_thresh, iou_thresh, kind, beta,
                                             max_dets)[-1].sum())
        if abs(kept - target) <= KEPT_TOL * target:
            break
        n *= target / max(kept, 1)
    for head in net.heads:
        conv = net.head_conv(head)
        params[conv.index]["b"][4::5 + head.classes] += shift


def _offsets_to_pass(dense, conf_thresh: float) -> torch.Tensor:
    """[B, N]: the objectness offset at which each cell starts to pass:
    sigmoid(o + d) must reach max(thr, thr / sigmoid(best class logit))."""
    best_cls = torch.sigmoid(dense.class_logit.max(-1).values)
    need = torch.clamp(torch.maximum(torch.full_like(best_cls, conf_thresh), conf_thresh / best_cls),
                       max=1 - 1e-6)
    return torch.log(need / (1 - need)) - dense.obj_logit


def load_into(model: torch.nn.Module, params: Params) -> None:
    """Copy the weights into the program's model, whose leaves are
    ``layers.layer<i>.w|b|bn.scale|bn.bias|bn.mean|bn.var`` for darknet
    layer i; every leaf of the model has to be given."""
    names = {"w": "w", "b": "b", "scale": "bn.scale", "bias": "bn.bias",
             "mean": "bn.mean", "var": "bn.var"}
    given = {f"layers.layer{i}.{names[k]}": v for i, p in params.items() for k, v in p.items()}
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    missing = sorted(set(targets) - set(given))
    extra = sorted(set(given) - set(targets))
    if missing or extra:
        raise ValueError(f"weights do not fit the model: missing {missing[:4]}, extra {extra[:4]}")
    with torch.no_grad():
        for name, value in given.items():
            targets[name].copy_(value)

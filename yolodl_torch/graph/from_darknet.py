"""Darknet cfg → graph IR front-end.

Equivalent capability to ``model-graph/src/darknet.rs`` — but complete: the
reference maps only Convolutional/Route/Shortcut/MaxPool/UpSample and leaves
Yolo and the rest ``todo!()`` (darknet.rs:414-437), so darknet models can't
actually run there.  Here every detection-relevant section becomes a
buildable IR node, including the [yolo] heads (Detect2D with darknet decode
+ anchor-major channel order) and a final MergeDetect2D sink, so a darknet
``.cfg`` + ``.weights`` pair runs through the same jitted model path as
NEWSLABv1 models.

The conversion synthesizes a single NEWSLABv1-style group with explicit
names ("input", "layer0", ..., "output") and reuses the standard flattening
+ shape-inference pass.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..config import darknet_cfg as dk
from ..config import newslab as cfg
from ..shapes import Shape
from .ir import Graph, _flatten  # shared flatten/toposort/shape-inference


def graph_from_darknet(darknet: dk.Darknet) -> Graph:
    net = darknet.net
    if not net.height and not net.width and net.inputs:
        # 1-D sequence cfgs ([net] inputs=N): a 1×1×N map (parser.c
        # params.inputs) so connected/recurrent/conv layers compose
        input_shape = Shape(["_", net.inputs, 1, 1])
    else:
        if net.height <= 0 or net.width <= 0 or net.channels <= 0:
            raise ValueError(
                f"[net] needs positive width/height/channels (got "
                f"{net.width}x{net.height}x{net.channels}) or `inputs`")
        input_shape = Shape(["_", net.channels, net.height, net.width])
    layers: List[cfg.ModuleCfg] = [
        cfg.Input(name="input", shape=input_shape)
    ]
    yolo_names: List[str] = []

    def ref(index: int, current: int) -> str:
        absolute = dk.resolve_index(index, current)
        return f"layer{absolute}"

    for i, layer in enumerate(darknet.layers):
        name = f"layer{i}"
        prev = "input" if i == 0 else f"layer{i - 1}"

        if isinstance(layer, dk.Convolutional):
            if layer.stride_x != layer.stride_y:
                raise ValueError(f"{name}: anisotropic conv stride is not supported")
            layers.append(
                cfg.ConvBn2D(
                    name=name,
                    from_=prev,
                    c=layer.filters,
                    k=layer.size,
                    s=layer.stride_x,
                    p=layer.padding,
                    d=layer.dilation,
                    g=layer.groups,
                    # darknet convs carry a bias only when not batch-normalized
                    bias=not layer.batch_normalize,
                    act=layer.activation,
                    bn=cfg.BatchNormConfig(enabled=layer.batch_normalize),
                    order="bn_act",
                )
            )
        elif isinstance(layer, dk.Route):
            layers.append(
                cfg.DarknetRoute(
                    name=name,
                    from_=tuple(ref(j, i) for j in layer.layers),
                    group_id=layer.group_id,
                    num_groups=layer.groups,
                )
            )
        elif isinstance(layer, dk.Shortcut):
            layers.append(
                cfg.DarknetShortcut(
                    name=name,
                    from_=(prev,) + tuple(ref(j, i) for j in layer.from_layers),
                    act=layer.activation,
                    weights_type=layer.weights_type,
                )
            )
        elif isinstance(layer, dk.MaxPool):
            layers.append(
                cfg.MaxPool(
                    name=name,
                    from_=prev,
                    size=layer.size,
                    stride_y=layer.stride_y,
                    stride_x=layer.stride_x,
                    total_padding=layer.padding,
                    maxpool_depth=layer.maxpool_depth,
                    pool_kind=layer.pool_kind,
                )
            )
        elif isinstance(layer, dk.UpSample):
            if layer.reverse:
                layers.append(
                    cfg.UpSample2D(name=name, from_=prev, scale=float(layer.stride),
                                   stride=layer.stride, reverse=True)
                )
            else:
                layers.append(
                    cfg.UpSample2D(name=name, from_=prev, scale=float(layer.stride))
                )
        elif isinstance(layer, dk.Yolo):
            # darknet anchors are (w, h) pixels of the net input; Detect2D
            # anchors are (h, w) image ratios.
            anchors = tuple(
                (ah / net.height, aw / net.width) for aw, ah in layer.masked_anchors
            )
            if layer.new_coords:
                # new_coords=1: the preceding conv carries activation=
                # logistic and the darknet yolo layer applies NO further
                # activation (yolo_layer.c forward_yolo_layer, the
                # new_coords branch is commented out).  Our scaled decode
                # applies the σ itself — strip the conv's logistic so the
                # sigmoid is applied exactly once, and obj/class reach the
                # loss as logits (the Rust reference's convention,
                # detect_2d.rs:66-139).  End-to-end outputs are exactly
                # darknet's; only the intermediate head-conv tensor is
                # pre-σ here (parity tests compare σ(ours) there).
                for k in range(len(layers) - 1, -1, -1):
                    if layers[k].name == prev:
                        if (isinstance(layers[k], cfg.ConvBn2D)
                                and layers[k].act == "logistic"):
                            layers[k] = dataclasses.replace(
                                layers[k], act="linear")
                        break
            layers.append(
                cfg.Detect2D(
                    name=name,
                    from_=prev,
                    classes=layer.classes,
                    anchors=anchors,
                    # new_coords=1 selects the scaled-YOLOv4 power decode
                    variant="scaled" if layer.new_coords else "darknet",
                    scale_xy=layer.scale_x_y,
                    channel_order="anchor_major",
                    entry_layout="xywh",
                    gaussian=layer.gaussian,
                )
            )
            yolo_names.append(name)
        elif isinstance(layer, dk.Reorg):
            layers.append(
                cfg.Reorg2D(name=name, from_=prev, stride=layer.stride,
                            reverse=layer.reverse, old=layer.old)
            )
        elif isinstance(layer, dk.Sam):
            layers.append(
                cfg.DarknetSam(name=name, from_=(prev, ref(layer.from_layer, i)))
            )
        elif isinstance(layer, dk.ScaleChannels):
            layers.append(
                cfg.DarknetScaleChannels(
                    name=name, from_=(prev, ref(layer.from_layer, i)),
                    scale_wh=layer.scale_wh,
                )
            )
        elif isinstance(layer, dk.Region):
            # region anchors are in grid units of this head's feature map
            fh, fw, _ = darknet.output_shapes()[i]
            anchors = tuple((ah / fh, aw / fw) for aw, ah in layer.anchors)
            layers.append(
                cfg.Detect2D(
                    name=name,
                    from_=prev,
                    classes=layer.classes,
                    anchors=anchors,
                    variant="darknet",
                    scale_xy=1.0,
                    channel_order="anchor_major",
                    entry_layout="xywh",
                    class_activation="softmax" if layer.softmax else "sigmoid",
                )
            )
            yolo_names.append(name)
        elif isinstance(layer, dk.Connected):
            layers.append(
                cfg.Linear(name=name, from_=prev, out=layer.output,
                           act=layer.activation,
                           bn=cfg.BatchNormConfig(enabled=layer.batch_normalize))
            )
        elif isinstance(layer, dk.Rnn):
            layers.append(
                cfg.DarknetRnn(
                    name=name, from_=prev, out=layer.output,
                    hidden=layer.hidden, act=layer.activation,
                    self_act=layer.self_activation,
                    bn=layer.batch_normalize, shortcut=layer.shortcut,
                    time_steps=net.time_steps,
                )
            )
        elif isinstance(layer, dk.Gru):
            layers.append(
                cfg.DarknetGru(name=name, from_=prev, out=layer.output,
                               bn=layer.batch_normalize,
                               time_steps=net.time_steps)
            )
        elif isinstance(layer, dk.Lstm):
            layers.append(
                cfg.DarknetLstm(name=name, from_=prev, out=layer.output,
                                bn=layer.batch_normalize,
                                time_steps=net.time_steps)
            )
        elif isinstance(layer, dk.Crnn):
            if layer.stride != 1:
                raise ValueError(
                    f"{name}: [crnn] with stride != 1 is not supported (the "
                    "hidden state's spatial size must be step-invariant)"
                )
            layers.append(
                cfg.DarknetCrnn(
                    name=name, from_=prev, out=layer.output,
                    hidden=layer.hidden, k=layer.size, p=layer.padding,
                    d=layer.dilation, g=layer.groups, act=layer.activation,
                    bn=layer.batch_normalize, shortcut=layer.shortcut,
                    time_steps=net.time_steps,
                )
            )
        elif isinstance(layer, dk.AvgPool):
            layers.append(cfg.GlobalAvgPool2D(name=name, from_=prev))
        elif isinstance(layer, dk.Dropout):
            layers.append(cfg.Dropout(name=name, from_=prev,
                                      probability=layer.probability))
        elif isinstance(layer, dk.Softmax):
            layers.append(cfg.Softmax(name=name, from_=prev))
        elif isinstance(layer, dk.Detection):
            layers.append(
                cfg.Yolov1Detection(
                    name=name, from_=prev, classes=layer.classes,
                    side=layer.side, num=layer.num, softmax=layer.softmax,
                )
            )
        elif isinstance(layer, dk.Unimplemented) and layer.section in (
                "cost", "crop", "contrastive"):
            # training-only/no-op sections at inference → identity
            # ([contrastive] is a terminal loss layer like [cost]:
            # representation_layer.c computes a loss, nothing consumes it)
            layers.append(cfg.Identity(name=name, from_=prev))
        else:
            raise ValueError(
                f"layer {i}: [{layer.section}] has no graph mapping"
            )

    if yolo_names:
        layers.append(cfg.MergeDetect2D(name="output", from_=tuple(yolo_names)))
        # prune branches no detection head consumes (e.g. the terminal
        # [route]→[contrastive] training tail of yolov4-tiny_contrastive.cfg)
        # so the graph has exactly one sink; darknet still computes them but
        # nothing reads their output at inference
        by_name = {}
        implicit_prev = {}
        prev_name = None
        for lay in layers:
            by_name[lay.name] = lay
            implicit_prev[lay.name] = prev_name
            prev_name = lay.name
        keep = set()
        stack = ["output"]
        while stack:
            cur = stack.pop()
            if cur in keep or cur not in by_name:
                continue
            keep.add(cur)
            src = getattr(by_name[cur], "from_", None)
            if src is None and implicit_prev[cur] is not None:
                stack.append(implicit_prev[cur])
            elif isinstance(src, str):
                stack.append(src)
            elif isinstance(src, (tuple, list)):
                stack.extend(src)
        layers = [lay for lay in layers if lay.name in keep]
    # classifier cfgs (no [yolo] heads) end at their last layer

    model = cfg.Model(groups={"darknet": tuple(layers)}, main_group="darknet")
    graph = _flatten(model)

    # generic per-layer training options → gradient-stop set.  darknet's
    # backward loop runs last→first and BREAKS at a stopbackward layer
    # (network.c:362): that layer and every earlier one get no gradient or
    # weight update — even skip-route sources feeding later layers, because
    # their own backward never runs.  onlyforward (network.c:363) skips one
    # layer's backward: no updates for it, no gradient through it.  Both
    # map to lax.stop_gradient on node outputs (models/builder.py); frozen
    # BN layers still update running stats in the training forward, exactly
    # as darknet's forward does.
    frozen: set = set()
    if darknet.stop_backward:
        last = max(i for i, _ in darknet.stop_backward)
        frozen.update(f"layer{j}" for j in range(last + 1))
    frozen.update(f"layer{i}" for i in darknet.only_forward)
    if frozen:
        graph.stop_gradient_paths = frozenset(frozen)

    # per-[yolo]-layer objectness thresholds, in the head-merge order
    # (yolo_names == cfg layer order), so the train CLI can adopt darknet's
    # ignore_thresh/truth_thresh by default (parser.c:parse_yolo defaults
    # .5/1.0; every corpus cfg carries truth_thresh=1)
    yolo_layers = [l for l in darknet.layers if isinstance(l, dk.Yolo)]
    if yolo_layers:
        graph.detect_ignore_thresh = tuple(
            float(l.ignore_thresh) for l in yolo_layers)
        graph.detect_truth_thresh = tuple(
            float(l.truth_thresh) for l in yolo_layers)
        # darknet training options for LossConfig "auto" adoption
        # (iou_thresh multi-anchor matching yolo_layer.c:640-656,
        # objectness_smooth :457-462, max_delta clip :161-172)
        graph.detect_iou_thresh = tuple(
            float(l.iou_thresh) for l in yolo_layers)
        graph.detect_objectness_smooth = tuple(
            bool(l.objectness_smooth) for l in yolo_layers)
        graph.detect_max_delta = tuple(
            (float(l.max_delta) if l.max_delta is not None else None)
            for l in yolo_layers)
    return graph


def load_darknet_graph(path) -> Graph:
    return graph_from_darknet(dk.Darknet.load(path))

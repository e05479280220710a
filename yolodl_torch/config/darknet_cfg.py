"""AlexeyAB darknet ``.cfg`` front-end.

Equivalent capability to the reference's ``darknet-config`` crate
(``darknet-config/src/darknet.rs:28-42`` comment stripping + INI parse, and
the per-section structs in ``{net,convolutional,route,shortcut,max_pool,
up_sample,yolo}.rs`` with their darknet defaults).  Unlike the reference —
whose darknet→trainable-model path is ``todo!()`` (train/src/model.rs:31-33)
— this front-end feeds the same graph IR as NEWSLABv1, so darknet models
build, run, and train.

Also parses sections the reference models as data-only (connected, softmax,
cost, crop, avgpool, dropout, batchnorm, gaussian_yolo); unknown sections
become :class:`Unimplemented` entries, preserving round-trip intent.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# low-level INI parse


_COMMENT_RE = re.compile(r" *([#;].*)?$", re.MULTILINE)


def _strip_comments(text: str) -> str:
    """Remove #/; comments and trailing whitespace (darknet.rs:28-42)."""
    return _COMMENT_RE.sub("", text)


def parse_sections(text: str) -> List[Tuple[str, Dict[str, str]]]:
    """Split cfg text into (section_name, {key: value}) in order.

    Later duplicate keys within a section overwrite earlier ones, matching
    serde_ini map semantics.
    """
    sections: List[Tuple[str, Dict[str, str]]] = []
    current: Optional[Dict[str, str]] = None
    for raw_line in _strip_comments(text).splitlines():
        line = raw_line.strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            name = line[1:-1].strip().lower()
            current = {}
            sections.append((name, current))
            continue
        if "=" not in line:
            raise ValueError(f"malformed cfg line: {raw_line!r}")
        if current is None:
            raise ValueError(f"key-value pair before any section: {raw_line!r}")
        key, value = line.split("=", 1)
        current[key.strip()] = value.strip()
    return sections


class _TrackedDict(dict):
    """Dict recording which keys the typed parser consumed, so unconsumed
    keys can be preserved verbatim and unknown ones warned about (the
    serde-typed-field strictness the reference gets for free,
    darknet-config/src/yolo.rs derive)."""

    def __init__(self, d):
        super().__init__(d)
        self.used = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.used.add(key)
        return super().get(key, default)


# per-layer training options parsed generically in _build (parser.c:1589-1596)
_GENERIC_TRAIN_KEYS = frozenset({
    "stopbackward", "onlyforward", "dont_update", "burnin_update",
    "train_only_bn", "dontload", "dontloadscales",
})

# keys the reference's config layer (or darknet's parser.c) reads but this
# front-end has no semantics for: parsed-and-preserved without a warning.
# Anything outside these sets warns loudly — the silent-drop trap is closed.
_PRESERVED_KEYS: Dict[str, frozenset] = {
    # tracking/embedding surface (yolo.rs:53-64) + show_details/map
    "yolo": frozenset({
        "embedding_layer", "track_history_size", "sim_thresh",
        "dets_for_track", "dets_for_show", "track_ciou_norm", "map",
        "show_details", "atoms", "delta_normalizer",
    }),
    "gaussian_yolo": frozenset({
        "embedding_layer", "track_history_size", "sim_thresh",
        "dets_for_track", "dets_for_show", "track_ciou_norm", "map",
        "show_details", "delta_normalizer",
    }),
    # region/detection legacy scales (parser.c parse_region/parse_detection)
    "region": frozenset({
        "bias_match", "coords", "jitter", "rescore", "object_scale",
        "noobject_scale", "class_scale", "coord_scale", "absolute",
        "thresh", "random", "tree", "map", "log", "sqrt", "background",
        "classfix", "focus", "mask",
    }),
    "detection": frozenset({
        "jitter", "object_scale", "noobject_scale", "class_scale",
        "coord_scale", "random", "reorg", "forced", "max",
    }),
    # experimental conv variants (parser.c parse_convolutional)
    "convolutional": frozenset({
        "xnor", "bin_output", "binary", "flipped", "sway", "rotate",
        "stretch", "stretch_sway", "deform", "angle", "grad_centr",
        "reverse", "coordconv", "assisted_excitation", "antialiasing",
        "cbn", "steps",
    }),
    "softmax": frozenset({
        "temperature", "tree", "map", "spatial", "noloss",
    }),
    "maxpool": frozenset({"antialiasing", "out_channels"}),
    # darknet's parse_gru/parse_lstm read only output/batch_normalize
    # (parser.c:283-301) — an activation key is ignored there
    "gru": frozenset({"activation"}),
    "lstm": frozenset({"activation"}),
    "route": frozenset(),
    "upsample": frozenset({"scale"}),
    "dropout": frozenset({"dropblock", "dropblock_size_rel",
                          "dropblock_size_abs"}),
    "shortcut": frozenset({"weights_normalization"}),
}


def _get_int(d: Dict[str, str], key: str, default: int) -> int:
    return int(d[key]) if key in d else default

def _get_float(d: Dict[str, str], key: str, default: float) -> float:
    return float(d[key]) if key in d else default

def _get_bool(d: Dict[str, str], key: str, default: bool) -> bool:
    return bool(int(d[key])) if key in d else default

def _get_str(d: Dict[str, str], key: str, default: str) -> str:
    return d.get(key, default)

def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.replace(" ", "").split(",") if x != ""]

def _float_list(s: str) -> List[float]:
    return [float(x) for x in s.replace(" ", "").split(",") if x != ""]


# ---------------------------------------------------------------------------
# sections

ShapeHWC = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Net:
    """[net] section (darknet-config/src/net.rs:7-120): model + train params."""

    width: int
    height: int
    channels: int
    batch: int = 1
    subdivisions: int = 1
    momentum: float = 0.9
    decay: float = 0.0001
    learning_rate: float = 0.001
    burn_in: int = 0
    max_batches: int = 0
    policy: str = "constant"
    steps: Tuple[int, ...] = ()
    scales: Tuple[float, ...] = ()
    # policy parameters (parser.c:1219,1236-1238,1141-1143): power drives
    # both burn-in warmup and poly decay; step/scale are the STEP policy
    # pair (step also the SIG midpoint); sgdr_cycle=0 means max_batches
    power: float = 4.0
    gamma: float = 1.0
    step: int = 1
    scale: float = 1.0
    learning_rate_min: float = 1e-5
    sgdr_cycle: int = 0
    sgdr_mult: int = 2
    mosaic: bool = False
    letter_box: bool = False
    adam: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7
    angle: float = 0.0
    saturation: float = 1.0
    exposure: float = 1.0
    hue: float = 0.0
    # sequence models ([rnn]/[gru]/[lstm]/[crnn] cfgs): flat input width and
    # time-major step count; batch = net.batch/time_steps (rnn_layer.c:31)
    inputs: int = 0
    time_steps: int = 1
    raw: Dict[str, str] = dataclasses.field(default_factory=dict, hash=False, compare=False)

    @property
    def input_shape_hwc(self) -> ShapeHWC:
        if not self.height and not self.width and self.inputs:
            # 1-D input (parser.c: params.inputs when h/w/c unset): model it
            # as a 1×1×inputs map so connected/conv layers compose
            return (1, 1, self.inputs)
        if self.height <= 0 or self.width <= 0 or self.channels <= 0:
            raise ValueError(
                f"[net] needs positive width/height/channels (got "
                f"{self.width}x{self.height}x{self.channels}) or `inputs`")
        return (self.height, self.width, self.channels)


@dataclasses.dataclass(frozen=True)
class Convolutional:
    filters: int
    size: int
    stride_x: int = 1
    stride_y: int = 1
    padding: int = 0
    groups: int = 1
    dilation: int = 1
    batch_normalize: bool = False
    activation: str = "linear"
    share_index: Optional[int] = None

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        h, w, _ = in_hwc
        out_h = (h + 2 * self.padding - self.size) // self.stride_y + 1
        out_w = (w + 2 * self.padding - self.size) // self.stride_x + 1
        return (out_h, out_w, self.filters)


@dataclasses.dataclass(frozen=True)
class Route:
    layers: Tuple[int, ...]  # signed: negative = relative
    group_id: int = 0
    groups: int = 1

    def output_shape(self, in_shapes: Sequence[ShapeHWC]) -> ShapeHWC:
        hws = {(h, w) for h, w, _ in in_shapes}
        if len(hws) != 1:
            raise ValueError(f"route inputs disagree on spatial size: {in_shapes}")
        h, w = next(iter(hws))
        out_c = sum(c // self.groups for _, _, c in in_shapes)
        return (h, w, out_c)


@dataclasses.dataclass(frozen=True)
class Shortcut:
    from_layers: Tuple[int, ...]
    activation: str = "linear"
    weights_type: str = "none"

    def output_shape(self, in_shapes: Sequence[ShapeHWC]) -> ShapeHWC:
        hws = {(h, w) for h, w, _ in in_shapes}
        if len(hws) != 1:
            raise ValueError(f"shortcut inputs disagree on spatial size: {in_shapes}")
        return in_shapes[0]


@dataclasses.dataclass(frozen=True)
class MaxPool:
    size: int = 2
    stride_x: int = 2
    stride_y: int = 2
    padding: int = 1  # darknet default: size - 1
    maxpool_depth: bool = False
    pool_kind: str = "max"  # "max" | "avg" ([local_avgpool])

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        h, w, c = in_hwc
        out_h = (h + self.padding - self.size) // self.stride_y + 1
        out_w = (w + self.padding - self.size) // self.stride_x + 1
        return (out_h, out_w, c)


@dataclasses.dataclass(frozen=True)
class UpSample:
    stride: int = 2
    reverse: bool = False

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        h, w, c = in_hwc
        if self.reverse:
            return (h // self.stride, w // self.stride, c)
        return (h * self.stride, w * self.stride, c)


@dataclasses.dataclass(frozen=True)
class Yolo:
    """[yolo]/[gaussian_yolo] head (darknet-config/src/yolo.rs:15-66,
    gaussian_yolo.rs:15-33; darknet parser.c parse_yolo/parse_gaussian_yolo).

    Training-semantics fields the reference parses are all typed here —
    including ``iou_thresh``/``iou_thresh_kind`` (multi-anchor matching,
    yolo_layer.c:640-656), ``objectness_smooth``, ``max_delta`` (delta
    clipping, yolo_layer.c:161-172), ``focal_loss``, ``counters_per_class``
    and the data-aug knobs ``jitter``/``random``/``resize`` (consumed by
    darknet's loader, parse-and-preserve here)."""

    classes: int = 20
    gaussian: bool = False  # [gaussian_yolo] section
    # all anchor pairs as (w, h) pixels (darknet order!), mask selects a subset
    anchors: Tuple[Tuple[float, float], ...] = ()
    mask: Tuple[int, ...] = ()
    num: Optional[int] = None  # declared total anchors (l.total)
    scale_x_y: float = 1.0
    new_coords: bool = False
    iou_loss: str = "mse"
    iou_normalizer: float = 0.75
    obj_normalizer: float = 1.0
    cls_normalizer: float = 1.0
    uc_normalizer: float = 1.0  # gaussian sigma-delta weight
    ignore_thresh: float = 0.5
    truth_thresh: float = 1.0
    iou_thresh: float = 1.0  # <1: extra anchors match per truth (yolo_layer.c:640)
    iou_thresh_kind: str = "iou"  # iou|giou|diou|ciou (box_iou_kind)
    objectness_smooth: bool = False
    max_delta: Optional[float] = None  # None = FLT_MAX (no clipping)
    focal_loss: bool = False
    counters_per_class: Tuple[int, ...] = ()
    yolo_point: str = "center"  # center|left_top|right_bottom
    label_smooth_eps: float = 0.0
    max_boxes: int = 200
    nms_kind: str = "default"
    beta_nms: float = 0.6  # parser.c:490 default
    # data-aug knobs darknet's loader reads per [yolo] (yolo.rs:38-40,51);
    # parse-and-preserve (training.multi_scale is the JSON5-side consumer)
    jitter: float = 0.2
    random: float = 0.0
    resize: float = 1.0

    @property
    def total_anchors(self) -> Tuple[Tuple[float, float], ...]:
        """darknet's l.total anchor set: `num` pairs — extra listed pairs
        are truncated (parser.c reads min(num, pairs); cspx-p7 declares
        num=16 with 20 pairs listed)."""
        if self.num is not None and self.num < len(self.anchors):
            return self.anchors[: self.num]
        return self.anchors

    @property
    def masked_anchors(self) -> Tuple[Tuple[float, float], ...]:
        if not self.mask:
            return self.anchors
        bad = [i for i in self.mask if i >= len(self.anchors) or i < 0]
        if bad:
            raise ValueError(
                f"[yolo] mask indices {bad} out of range for "
                f"{len(self.anchors)} anchors")
        return tuple(self.anchors[i] for i in self.mask)

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        h, w, c = in_hwc
        entries = (9 if self.gaussian else 5) + self.classes
        expect = len(self.masked_anchors) * entries
        if c != expect:
            raise ValueError(
                f"[yolo] input channels {c} != anchors*entries = {expect}"
            )
        return in_hwc


@dataclasses.dataclass(frozen=True)
class Reorg:
    """darknet [reorg]/[reorg3d]: space-to-depth, stride default 2.
    ``old`` marks the [reorg] REORG_OLD semantics (parser.c:80-81)."""

    stride: int = 2
    reverse: bool = False
    old: bool = True

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        h, w, c = in_hwc
        s = self.stride
        if self.reverse:
            return (h * s, w * s, c // (s * s))
        return (h // s, w // s, c * s * s)


@dataclasses.dataclass(frozen=True)
class Sam:
    """darknet [sam]: elementwise product with `from` layer."""

    from_layer: int = -1

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return in_hwc


@dataclasses.dataclass(frozen=True)
class ScaleChannels:
    """darknet [scale_channels]: SE-style broadcast multiply."""

    from_layer: int = -1
    scale_wh: bool = False


@dataclasses.dataclass(frozen=True)
class Region:
    """darknet [region] (YOLOv2 head): anchors in grid units, softmax
    classes.  Training fields per parser.c parse_region:667-702."""

    classes: int = 20
    num: int = 5
    anchors: Tuple[Tuple[float, float], ...] = ()  # (w, h) grid units
    softmax: bool = True
    coords: int = 4
    max_boxes: int = 200
    thresh: float = 0.5
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    bias_match: bool = False
    rescore: bool = False
    classfix: int = 0
    focal_loss: bool = False
    jitter: float = 0.2
    random: float = 0.0
    resize: float = 1.0

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return in_hwc


@dataclasses.dataclass(frozen=True)
class Connected:
    """darknet [connected]: fully-connected layer."""

    output: int
    activation: str = "linear"
    batch_normalize: bool = False

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return (1, 1, self.output)


@dataclasses.dataclass(frozen=True)
class AvgPool:
    """darknet [avgpool]: global average pool."""

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return (1, 1, in_hwc[2])


@dataclasses.dataclass(frozen=True)
class Dropout:
    probability: float = 0.5

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return in_hwc


@dataclasses.dataclass(frozen=True)
class Softmax:
    groups: int = 1

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return in_hwc


@dataclasses.dataclass(frozen=True)
class Detection:
    """darknet [detection] (YOLOv1 head, detection_layer.c): the forward
    pass is a copy with optional per-cell softmax over the class block;
    per-batch layout is [side²·classes probs][side²·num confs][side²·num·4
    boxes] (get_detection_detections)."""

    classes: int = 20
    coords: int = 4
    side: int = 7
    num: int = 2
    softmax: bool = False
    sqrt: bool = False
    rescore: bool = False
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    jitter: float = 0.2
    random: float = 0.0
    forced: bool = False

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return in_hwc


@dataclasses.dataclass(frozen=True)
class Rnn:
    """darknet [rnn] (parser.c parse_rnn, rnn_layer.c): three connected
    sub-layers; self activation is logistic/loggy when ``logistic``=1/2."""

    output: int
    hidden: int
    activation: str = "logistic"
    batch_normalize: bool = False
    logistic: int = 0
    shortcut: bool = False

    @property
    def self_activation(self) -> str:
        if self.logistic == 2:
            return "loggy"
        if self.logistic == 1:
            return "logistic"
        return self.activation

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return (1, 1, self.output)


@dataclasses.dataclass(frozen=True)
class Gru:
    """darknet [gru] (parser.c parse_gru, gru_layer.c)."""

    output: int
    batch_normalize: bool = False

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return (1, 1, self.output)


@dataclasses.dataclass(frozen=True)
class Lstm:
    """darknet [lstm] (parser.c parse_lstm, lstm_layer.c)."""

    output: int
    batch_normalize: bool = False

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        return (1, 1, self.output)


@dataclasses.dataclass(frozen=True)
class Crnn:
    """darknet [crnn] (parser.c parse_crnn, crnn_layer.c): the rnn
    recurrence with three convolutional sub-layers of this geometry."""

    output: int
    hidden: int
    size: int = 3
    stride: int = 1
    dilation: int = 1
    padding: int = 0
    groups: int = 1
    activation: str = "logistic"
    batch_normalize: bool = False
    shortcut: bool = False

    def output_shape(self, in_hwc: ShapeHWC) -> ShapeHWC:
        h, w, _ = in_hwc
        out_h = (h + 2 * self.padding - self.size) // self.stride + 1
        out_w = (w + 2 * self.padding - self.size) // self.stride + 1
        return (out_h, out_w, self.output)


@dataclasses.dataclass(frozen=True)
class Unimplemented:
    """Parsed-but-not-buildable section (parity with darknet-config's
    Connected/Softmax/Cost/Crop/AvgPool/Dropout/Unimplemented handling)."""

    section: str
    raw: Dict[str, str] = dataclasses.field(hash=False, compare=False, default_factory=dict)


Layer = Union[Convolutional, Route, Shortcut, MaxPool, UpSample, Yolo,
              Connected, AvgPool, Dropout, Softmax, Reorg, Sam,
              ScaleChannels, Region, Rnn, Gru, Lstm, Crnn, Detection, Unimplemented]


@dataclasses.dataclass(frozen=True)
class Darknet:
    net: Net
    layers: Tuple[Layer, ...]
    # generic per-layer training options (parser.c:1589-1593, parsed for
    # every section kind).  ``stop_backward`` holds (layer_index, value)
    # pairs for layers with a nonzero ``stopbackward``: darknet's backward
    # loop breaks at such a layer (network.c:362), so it AND every earlier
    # layer get no gradient/update — the cfg idiom for frozen-backbone
    # fine-tuning (yolov4-custom.cfg).  ``only_forward`` lists layers whose
    # own backward is skipped (network.c:363): no updates for that layer
    # and no gradient through it, but earlier layers still train via other
    # paths (yolov4-tiny_contrastive.cfg routes).
    stop_backward: Tuple[Tuple[int, int], ...] = ()
    only_forward: Tuple[int, ...] = ()
    # per-layer keys the typed parser did not consume (reference-known ones
    # preserved silently, unknown ones warned about at parse time); aligned
    # with ``layers``, re-emitted verbatim by to_cfg_string
    extras: Tuple[Dict[str, str], ...] = dataclasses.field(
        default=(), hash=False, compare=False)

    def layer_extra(self, index: int) -> Dict[str, str]:
        return self.extras[index] if index < len(self.extras) else {}

    @staticmethod
    def load(path) -> "Darknet":
        with open(path) as f:
            return Darknet.from_str(f.read())

    @staticmethod
    def from_str(text: str) -> "Darknet":
        return _build(parse_sections(text))

    def output_shapes(self) -> List[ShapeHWC]:
        """Per-layer output shapes (HWC), resolving route/shortcut indices."""
        shapes: List[ShapeHWC] = []
        for i, layer in enumerate(self.layers):
            if isinstance(
                layer,
                (Convolutional, MaxPool, UpSample, Yolo, Connected, AvgPool,
                 Dropout, Softmax, Reorg, Sam, Region, Rnn, Gru, Lstm, Crnn,
                 Detection),
            ):
                src = self.net.input_shape_hwc if i == 0 else shapes[i - 1]
                shapes.append(layer.output_shape(src))
            elif isinstance(layer, Route):
                idxs = [resolve_index(j, i) for j in layer.layers]
                shapes.append(layer.output_shape([shapes[j] for j in idxs]))
            elif isinstance(layer, Shortcut):
                prev = self.net.input_shape_hwc if i == 0 else shapes[i - 1]
                shapes.append(prev)  # darknet shortcut output = previous layer
            elif isinstance(layer, ScaleChannels):
                j = resolve_index(layer.from_layer, i)
                shapes.append(shapes[j])
            else:
                # passthrough estimate for unimplemented kinds
                shapes.append(self.net.input_shape_hwc if i == 0 else shapes[i - 1])
        return shapes


def resolve_index(index: int, current: int) -> int:
    """Signed layer reference → absolute index (misc.rs LayerIndex:81-90):
    negative is relative to the current layer."""
    absolute = index if index >= 0 else current + index
    if not 0 <= absolute < current:
        raise ValueError(f"layer reference {index} out of range at layer {current}")
    return absolute


# ---------------------------------------------------------------------------


def _build(sections: List[Tuple[str, Dict[str, str]]]) -> Darknet:
    if not sections or sections[0][0] not in ("net", "network"):
        raise ValueError("the first section must be [net]")
    if any(name in ("net", "network") for name, _ in sections[1:]):
        raise ValueError("[net] must appear only once, first")

    net = _parse_net(sections[0][1])
    layers: List[Layer] = []
    extras: List[Dict[str, str]] = []
    stop_backward: List[Tuple[int, int]] = []
    only_forward: List[int] = []
    for i, (name, d) in enumerate(sections[1:]):
        td = _TrackedDict(d)
        layer = _parse_layer(name, td)
        layers.append(layer)
        if isinstance(layer, Unimplemented):
            extras.append({})  # Unimplemented keeps everything in .raw
        else:
            leftover = {k: v for k, v in d.items()
                        if k not in td.used and k not in _GENERIC_TRAIN_KEYS}
            preserved = _PRESERVED_KEYS.get(name, frozenset())
            for k in leftover:
                if k not in preserved:
                    warnings.warn(
                        f"layer {i} [{name}]: unknown key {k!r} is not "
                        f"understood by this front-end (darknet may parse "
                        f"it); preserved verbatim on round-trip")
            extras.append(leftover)
        # generic per-layer training options (parser.c:1589-1593)
        if _get_int(d, "stopbackward", 0):
            stop_backward.append((i, _get_int(d, "stopbackward", 0)))
        if _get_int(d, "onlyforward", 0):
            only_forward.append(i)
        for key in ("dont_update", "burnin_update", "train_only_bn",
                    "dontload", "dontloadscales"):
            if _get_int(d, key, 0):
                warnings.warn(
                    f"layer {i} [{name}]: {key} is parsed by darknet "
                    f"(parser.c:1589-1596) but not supported here — ignored")
    return Darknet(net=net, layers=tuple(layers),
                   stop_backward=tuple(stop_backward),
                   only_forward=tuple(only_forward),
                   extras=tuple(extras))


def _parse_net(d: Dict[str, str]) -> Net:
    return Net(
        width=_get_int(d, "width", 0),
        height=_get_int(d, "height", 0),
        channels=_get_int(d, "channels", 3),
        batch=_get_int(d, "batch", 1),
        subdivisions=_get_int(d, "subdivisions", 1),
        momentum=_get_float(d, "momentum", 0.9),
        decay=_get_float(d, "decay", 0.0001),
        learning_rate=_get_float(d, "learning_rate", 0.001),
        burn_in=_get_int(d, "burn_in", 0),
        max_batches=_get_int(d, "max_batches", 0),
        policy=_get_str(d, "policy", "constant"),
        steps=tuple(_int_list(d["steps"])) if "steps" in d else (),
        scales=tuple(_float_list(d["scales"])) if "scales" in d else (),
        power=_get_float(d, "power", 4.0),
        gamma=_get_float(d, "gamma", 1.0),
        step=_get_int(d, "step", 1),
        scale=_get_float(d, "scale", 1.0),
        learning_rate_min=_get_float(d, "learning_rate_min", 1e-5),
        sgdr_cycle=_get_int(d, "sgdr_cycle", 0),
        sgdr_mult=_get_int(d, "sgdr_mult", 2),
        mosaic=_get_bool(d, "mosaic", False),
        letter_box=_get_bool(d, "letter_box", False),
        adam=_get_bool(d, "adam", False),
        b1=_get_float(d, "B1", 0.9),
        b2=_get_float(d, "B2", 0.999),
        eps=_get_float(d, "eps", 1e-7),
        angle=_get_float(d, "angle", 0.0),
        saturation=_get_float(d, "saturation", 1.0),
        exposure=_get_float(d, "exposure", 1.0),
        hue=_get_float(d, "hue", 0.0),
        inputs=_get_int(d, "inputs", 0),
        time_steps=_get_int(d, "time_steps", 1),
        raw=dict(d),
    )


def _parse_layer(name: str, d: Dict[str, str]) -> Layer:
    if name == "convolutional":
        size = _get_int(d, "size", 1)
        stride = _get_int(d, "stride", 1)
        pad_flag = _get_bool(d, "pad", False)
        # pad=1 overrides padding to size//2 (convolutional.rs:89-96)
        padding = size // 2 if pad_flag else _get_int(d, "padding", 0)
        share = d.get("share_index")
        return Convolutional(
            filters=int(d["filters"]),
            size=size,
            stride_x=_get_int(d, "stride_x", stride),
            stride_y=_get_int(d, "stride_y", stride),
            padding=padding,
            groups=_get_int(d, "groups", 1),
            dilation=_get_int(d, "dilation", 1),
            batch_normalize=_get_bool(d, "batch_normalize", False),
            activation=_get_str(d, "activation", "linear"),
            share_index=int(share) if share is not None else None,
        )
    if name == "route":
        return Route(
            layers=tuple(_int_list(d["layers"])),
            group_id=_get_int(d, "group_id", 0),
            groups=_get_int(d, "groups", 1),
        )
    if name == "shortcut":
        return Shortcut(
            from_layers=tuple(_int_list(d["from"])),
            activation=_get_str(d, "activation", "linear"),
            weights_type=_get_str(d, "weights_type", "none"),
        )
    if name in ("maxpool", "max", "local_avgpool"):
        stride = _get_int(d, "stride", 1)
        size = _get_int(d, "size", stride)
        return MaxPool(
            size=size,
            stride_x=_get_int(d, "stride_x", stride),
            stride_y=_get_int(d, "stride_y", stride),
            padding=_get_int(d, "padding", size - 1),
            maxpool_depth=_get_bool(d, "maxpool_depth", False),
            pool_kind="avg" if name == "local_avgpool" else "max",
        )
    if name == "upsample":
        return UpSample(
            stride=_get_int(d, "stride", 2),
            reverse=_get_bool(d, "reverse", False),
        )
    if name in ("yolo", "gaussian_yolo"):
        anchors = ()
        if "anchors" in d:
            flat = _float_list(d["anchors"])
            anchors = tuple((flat[i], flat[i + 1]) for i in range(0, len(flat) - 1, 2))
        num = _get_int(d, "num", 0) or None
        if num is not None and anchors and num > len(anchors):
            # fewer pairs than declared: darknet leaves trailing biases at
            # the 0.5 default (parser.c); num < len(anchors) is the normal
            # truncation case (cspx-p7 declares num=16 with 20 pairs)
            warnings.warn(
                f"[{name}] num={num} > {len(anchors)} anchor pairs — "
                f"darknet would zero-default the missing biases")
        max_delta = _get_float(d, "max_delta", 0.0) if "max_delta" in d else None
        return Yolo(
            classes=_get_int(d, "classes", 20),
            gaussian=(name == "gaussian_yolo"),
            anchors=anchors,
            mask=tuple(_int_list(d["mask"])) if "mask" in d else (),
            num=num,
            scale_x_y=_get_float(d, "scale_x_y", 1.0),
            new_coords=_get_bool(d, "new_coords", False),
            iou_loss=_get_str(d, "iou_loss", "mse"),
            iou_normalizer=_get_float(d, "iou_normalizer", 0.75),
            obj_normalizer=_get_float(d, "obj_normalizer", 1.0),
            cls_normalizer=_get_float(d, "cls_normalizer", 1.0),
            uc_normalizer=_get_float(d, "uc_normalizer", 1.0),
            ignore_thresh=_get_float(d, "ignore_thresh", 0.5),
            truth_thresh=_get_float(d, "truth_thresh", 1.0),
            iou_thresh=_get_float(d, "iou_thresh", 1.0),
            iou_thresh_kind=_get_str(d, "iou_thresh_kind", "iou"),
            objectness_smooth=_get_bool(d, "objectness_smooth", False),
            max_delta=max_delta,
            focal_loss=_get_bool(d, "focal_loss", False),
            counters_per_class=(tuple(_int_list(d["counters_per_class"]))
                                if "counters_per_class" in d else ()),
            yolo_point=_get_str(d, "yolo_point", "center"),
            label_smooth_eps=_get_float(d, "label_smooth_eps", 0.0),
            max_boxes=_get_int(d, "max", 200),
            nms_kind=_get_str(d, "nms_kind", "default"),
            beta_nms=_get_float(d, "beta_nms", 0.6),
            jitter=_get_float(d, "jitter", 0.2),
            random=_get_float(d, "random", 0.0),
            resize=_get_float(d, "resize", 1.0),
        )
    if name in ("reorg", "reorg_old", "reorg3d"):
        return Reorg(stride=_get_int(d, "stride", 2),
                     reverse=_get_bool(d, "reverse", False),
                     old=(name != "reorg3d"))
    if name == "sam":
        return Sam(from_layer=int(d["from"]))
    if name == "scale_channels":
        return ScaleChannels(from_layer=int(d["from"]),
                             scale_wh=_get_bool(d, "scale_wh", False))
    if name == "region":
        anchors = ()
        if "anchors" in d:
            flat = _float_list(d["anchors"])
            anchors = tuple((flat[i], flat[i + 1]) for i in range(0, len(flat) - 1, 2))
        return Region(
            classes=_get_int(d, "classes", 20),
            num=_get_int(d, "num", 5),
            anchors=anchors,
            softmax=_get_bool(d, "softmax", True),
            coords=_get_int(d, "coords", 4),
            max_boxes=_get_int(d, "max", 200),
            thresh=_get_float(d, "thresh", 0.5),
            object_scale=_get_float(d, "object_scale", 1.0),
            noobject_scale=_get_float(d, "noobject_scale", 1.0),
            class_scale=_get_float(d, "class_scale", 1.0),
            coord_scale=_get_float(d, "coord_scale", 1.0),
            bias_match=_get_bool(d, "bias_match", False),
            rescore=_get_bool(d, "rescore", False),
            classfix=_get_int(d, "classfix", 0),
            focal_loss=_get_bool(d, "focal_loss", False),
            jitter=_get_float(d, "jitter", 0.2),
            random=_get_float(d, "random", 0.0),
            resize=_get_float(d, "resize", 1.0),
        )
    if name == "connected":
        return Connected(
            output=int(d["output"]),
            activation=_get_str(d, "activation", "linear"),
            batch_normalize=_get_bool(d, "batch_normalize", False),
        )
    if name == "rnn":
        return Rnn(
            output=int(d["output"]),
            hidden=_get_int(d, "hidden", 1),  # parser.c:270 default

            activation=_get_str(d, "activation", "logistic"),
            batch_normalize=_get_bool(d, "batch_normalize", False),
            logistic=_get_int(d, "logistic", 0),
            shortcut=_get_bool(d, "shortcut", False),
        )
    if name == "gru":
        return Gru(
            output=int(d["output"]),
            batch_normalize=_get_bool(d, "batch_normalize", False),
        )
    if name == "lstm":
        return Lstm(
            output=int(d["output"]),
            batch_normalize=_get_bool(d, "batch_normalize", False),
        )
    if name == "crnn":
        size = _get_int(d, "size", 3)
        pad_flag = _get_bool(d, "pad", False)
        padding = size // 2 if pad_flag else _get_int(d, "padding", 0)
        return Crnn(
            output=int(d["output"]),
            hidden=_get_int(d, "hidden", 1),
            size=size,
            stride=_get_int(d, "stride", 1),
            dilation=_get_int(d, "dilation", 1),
            padding=padding,
            groups=_get_int(d, "groups", 1),
            activation=_get_str(d, "activation", "logistic"),
            batch_normalize=_get_bool(d, "batch_normalize", False),
            shortcut=_get_bool(d, "shortcut", False),
        )
    if name == "detection":
        return Detection(
            classes=_get_int(d, "classes", 20),
            coords=_get_int(d, "coords", 4),
            side=_get_int(d, "side", 7),
            num=_get_int(d, "num", 2),
            softmax=_get_bool(d, "softmax", False),
            sqrt=_get_bool(d, "sqrt", False),
            rescore=_get_bool(d, "rescore", False),
            object_scale=_get_float(d, "object_scale", 1.0),
            noobject_scale=_get_float(d, "noobject_scale", 1.0),
            class_scale=_get_float(d, "class_scale", 1.0),
            coord_scale=_get_float(d, "coord_scale", 1.0),
            jitter=_get_float(d, "jitter", 0.2),
            random=_get_float(d, "random", 0.0),
            forced=_get_bool(d, "forced", False),
        )
    if name == "avgpool":
        return AvgPool()
    if name == "dropout":
        return Dropout(probability=_get_float(d, "probability", 0.5))
    if name == "softmax":
        return Softmax(groups=_get_int(d, "groups", 1))
    return Unimplemented(section=name, raw=dict(d))


# ---------------------------------------------------------------------------
# serialization (round-trip support, darknet.rs:23-25 `to_string` parity)


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        return f"{value:g}"
    return str(value)


def to_cfg_string(darknet: Darknet) -> str:
    """Serialize back to .cfg text.  Parse→serialize→parse is identity on
    the supported fields (unknown keys from `raw` are preserved for [net]
    and Unimplemented sections)."""
    out = ["[net]"]
    net = darknet.net
    emitted = {
        "width": net.width, "height": net.height, "channels": net.channels,
        "batch": net.batch, "subdivisions": net.subdivisions,
        "momentum": net.momentum, "decay": net.decay,
        "learning_rate": net.learning_rate, "burn_in": net.burn_in,
        "max_batches": net.max_batches, "policy": net.policy,
    }
    for key, value in emitted.items():
        out.append(f"{key}={_fmt(value)}")
    if net.steps:
        out.append("steps=" + ",".join(str(s) for s in net.steps))
    if net.scales:
        out.append("scales=" + ",".join(_fmt(s) for s in net.scales))
    # policy parameters: emit only non-defaults (keeps untouched cfgs terse)
    if net.power != 4.0:
        out.append(f"power={_fmt(net.power)}")
    if net.gamma != 1.0:
        out.append(f"gamma={_fmt(net.gamma)}")
    if net.step != 1:
        out.append(f"step={net.step}")
    if net.scale != 1.0:
        out.append(f"scale={_fmt(net.scale)}")
    if net.learning_rate_min != 1e-5:
        out.append(f"learning_rate_min={_fmt(net.learning_rate_min)}")
    if net.sgdr_cycle:
        out.append(f"sgdr_cycle={net.sgdr_cycle}")
    if net.sgdr_mult != 2:
        out.append(f"sgdr_mult={net.sgdr_mult}")
    for flag in ("mosaic", "letter_box", "adam"):
        if getattr(net, flag):
            out.append(f"{flag}=1")
    if net.inputs:
        out.append(f"inputs={net.inputs}")
    if net.time_steps != 1:
        out.append(f"time_steps={net.time_steps}")
    # every other [net] key rides through verbatim from the parse
    # (augmentation knobs, adam B1/B2/eps, anything unknown) — the
    # documented preserve-unknown-keys contract
    handled = set(emitted) | {
        "steps", "scales", "power", "gamma", "step", "scale",
        "learning_rate_min", "sgdr_cycle", "sgdr_mult", "mosaic",
        "letter_box", "adam", "inputs", "time_steps",
    }
    for key, value in net.raw.items():
        if key not in handled:
            out.append(f"{key}={value}")

    stop_by_idx = dict(darknet.stop_backward)
    only_fwd = set(darknet.only_forward)
    for idx, layer in enumerate(darknet.layers):
        out.append("")
        if isinstance(layer, Convolutional):
            out.append("[convolutional]")
            if layer.batch_normalize:
                out.append("batch_normalize=1")
            out.append(f"filters={layer.filters}")
            out.append(f"size={layer.size}")
            if layer.stride_x == layer.stride_y:
                out.append(f"stride={layer.stride_x}")
            else:
                out.append(f"stride_x={layer.stride_x}")
                out.append(f"stride_y={layer.stride_y}")
            out.append(f"padding={layer.padding}")
            if layer.groups != 1:
                out.append(f"groups={layer.groups}")
            if layer.dilation != 1:
                out.append(f"dilation={layer.dilation}")
            if layer.share_index is not None:
                out.append(f"share_index={layer.share_index}")
            out.append(f"activation={layer.activation}")
        elif isinstance(layer, Route):
            out.append("[route]")
            out.append("layers=" + ",".join(str(i) for i in layer.layers))
            if layer.groups != 1:
                out.append(f"groups={layer.groups}")
                out.append(f"group_id={layer.group_id}")
        elif isinstance(layer, Shortcut):
            out.append("[shortcut]")
            out.append("from=" + ",".join(str(i) for i in layer.from_layers))
            if layer.weights_type != "none":
                out.append(f"weights_type={layer.weights_type}")
            out.append(f"activation={layer.activation}")
        elif isinstance(layer, MaxPool):
            # pool_kind is encoded only by the section header — emitting
            # [maxpool] for an avg pool would silently change semantics
            out.append("[maxpool]" if layer.pool_kind == "max"
                       else "[local_avgpool]")
            if layer.maxpool_depth:
                out.append("maxpool_depth=1")
            out.append(f"size={layer.size}")
            if layer.stride_x == layer.stride_y:
                out.append(f"stride={layer.stride_x}")
            else:
                out.append(f"stride_x={layer.stride_x}")
                out.append(f"stride_y={layer.stride_y}")
            out.append(f"padding={layer.padding}")
        elif isinstance(layer, UpSample):
            out.append("[upsample]")
            out.append(f"stride={layer.stride}")
            if layer.reverse:
                out.append("reverse=1")
        elif isinstance(layer, Yolo):
            # the Gaussian head has 9 box entries, not 5 — emitting [yolo]
            # for it would change the decode (and crash output_shape)
            out.append("[Gaussian_yolo]" if layer.gaussian else "[yolo]")
            if layer.mask:
                out.append("mask=" + ",".join(str(i) for i in layer.mask))
            if layer.anchors:
                out.append(
                    "anchors="
                    + ",".join(f"{_fmt(w)},{_fmt(h)}" for w, h in layer.anchors)
                )
            out.append(f"classes={layer.classes}")
            if layer.num is not None or layer.anchors:
                out.append(f"num={layer.num if layer.num is not None else len(layer.anchors)}")
            out.append(f"scale_x_y={_fmt(layer.scale_x_y)}")
            if layer.new_coords:
                out.append("new_coords=1")
            out.append(f"iou_loss={layer.iou_loss}")
            out.append(f"ignore_thresh={_fmt(layer.ignore_thresh)}")
            out.append(f"truth_thresh={_fmt(layer.truth_thresh)}")
            if layer.iou_thresh != 1.0:
                out.append(f"iou_thresh={_fmt(layer.iou_thresh)}")
            if layer.iou_thresh_kind != "iou":
                out.append(f"iou_thresh_kind={layer.iou_thresh_kind}")
            if layer.objectness_smooth:
                out.append("objectness_smooth=1")
            if layer.max_delta is not None:
                out.append(f"max_delta={_fmt(layer.max_delta)}")
            if layer.focal_loss:
                out.append("focal_loss=1")
            if layer.counters_per_class:
                out.append("counters_per_class="
                           + ",".join(str(c) for c in layer.counters_per_class))
            if layer.yolo_point != "center":
                out.append(f"yolo_point={layer.yolo_point}")
            out.append(f"max={layer.max_boxes}")
            out.append(f"nms_kind={layer.nms_kind}")
            if layer.beta_nms != 0.6:
                out.append(f"beta_nms={_fmt(layer.beta_nms)}")
            if layer.iou_normalizer != 0.75:
                out.append(f"iou_normalizer={_fmt(layer.iou_normalizer)}")
            if layer.obj_normalizer != 1.0:
                out.append(f"obj_normalizer={_fmt(layer.obj_normalizer)}")
            if layer.cls_normalizer != 1.0:
                out.append(f"cls_normalizer={_fmt(layer.cls_normalizer)}")
            if layer.uc_normalizer != 1.0:
                out.append(f"uc_normalizer={_fmt(layer.uc_normalizer)}")
            if layer.label_smooth_eps:
                out.append(
                    f"label_smooth_eps={_fmt(layer.label_smooth_eps)}")
            if layer.jitter != 0.2:
                out.append(f"jitter={_fmt(layer.jitter)}")
            if layer.random:
                out.append(f"random={_fmt(layer.random)}")
            if layer.resize != 1.0:
                out.append(f"resize={_fmt(layer.resize)}")
        elif isinstance(layer, Detection):
            out.append("[detection]")
            out.append(f"classes={layer.classes}")
            out.append(f"coords={layer.coords}")
            out.append(f"side={layer.side}")
            out.append(f"num={layer.num}")
            out.append(f"softmax={1 if layer.softmax else 0}")
            out.append(f"sqrt={1 if layer.sqrt else 0}")
            if layer.rescore:
                out.append("rescore=1")
            if layer.object_scale != 1.0:
                out.append(f"object_scale={_fmt(layer.object_scale)}")
            if layer.noobject_scale != 1.0:
                out.append(f"noobject_scale={_fmt(layer.noobject_scale)}")
            if layer.class_scale != 1.0:
                out.append(f"class_scale={_fmt(layer.class_scale)}")
            if layer.coord_scale != 1.0:
                out.append(f"coord_scale={_fmt(layer.coord_scale)}")
            if layer.jitter != 0.2:
                out.append(f"jitter={_fmt(layer.jitter)}")
            if layer.random:
                out.append(f"random={_fmt(layer.random)}")
            if layer.forced:
                out.append("forced=1")
        elif isinstance(layer, Rnn):
            out.append("[rnn]")
            if layer.batch_normalize:
                out.append("batch_normalize=1")
            out.append(f"output={layer.output}")
            out.append(f"hidden={layer.hidden}")
            out.append(f"activation={layer.activation}")
            if layer.logistic:
                out.append(f"logistic={layer.logistic}")
            if layer.shortcut:
                out.append("shortcut=1")
        elif isinstance(layer, (Gru, Lstm)):
            out.append("[gru]" if isinstance(layer, Gru) else "[lstm]")
            if layer.batch_normalize:
                out.append("batch_normalize=1")
            out.append(f"output={layer.output}")
        elif isinstance(layer, Crnn):
            out.append("[crnn]")
            if layer.batch_normalize:
                out.append("batch_normalize=1")
            out.append(f"size={layer.size}")
            out.append(f"stride={layer.stride}")
            out.append(f"padding={layer.padding}")
            if layer.dilation != 1:
                out.append(f"dilation={layer.dilation}")
            if layer.groups != 1:
                out.append(f"groups={layer.groups}")
            out.append(f"output={layer.output}")
            out.append(f"hidden={layer.hidden}")
            out.append(f"activation={layer.activation}")
            if layer.shortcut:
                out.append("shortcut=1")
        elif isinstance(layer, Connected):
            out.append("[connected]")
            if layer.batch_normalize:
                out.append("batch_normalize=1")
            out.append(f"output={layer.output}")
            out.append(f"activation={layer.activation}")
        elif isinstance(layer, Softmax):
            out.append("[softmax]")
            if layer.groups != 1:
                out.append(f"groups={layer.groups}")
        elif isinstance(layer, Dropout):
            out.append("[dropout]")
            out.append(f"probability={_fmt(layer.probability)}")
        elif isinstance(layer, AvgPool):
            out.append("[avgpool]")
        elif isinstance(layer, Region):
            out.append("[region]")
            if layer.anchors:
                out.append(
                    "anchors="
                    + ",".join(f"{_fmt(w)},{_fmt(h)}" for w, h in layer.anchors)
                )
            out.append(f"classes={layer.classes}")
            out.append(f"num={layer.num}")
            out.append(f"softmax={1 if layer.softmax else 0}")
            if layer.coords != 4:
                out.append(f"coords={layer.coords}")
            if layer.max_boxes != 200:
                out.append(f"max={layer.max_boxes}")
            if layer.thresh != 0.5:
                out.append(f"thresh={_fmt(layer.thresh)}")
            if layer.object_scale != 1.0:
                out.append(f"object_scale={_fmt(layer.object_scale)}")
            if layer.noobject_scale != 1.0:
                out.append(f"noobject_scale={_fmt(layer.noobject_scale)}")
            if layer.class_scale != 1.0:
                out.append(f"class_scale={_fmt(layer.class_scale)}")
            if layer.coord_scale != 1.0:
                out.append(f"coord_scale={_fmt(layer.coord_scale)}")
            if layer.bias_match:
                out.append("bias_match=1")
            if layer.rescore:
                out.append("rescore=1")
            if layer.classfix:
                out.append(f"classfix={layer.classfix}")
            if layer.focal_loss:
                out.append("focal_loss=1")
            if layer.jitter != 0.2:
                out.append(f"jitter={_fmt(layer.jitter)}")
            if layer.random:
                out.append(f"random={_fmt(layer.random)}")
            if layer.resize != 1.0:
                out.append(f"resize={_fmt(layer.resize)}")
        elif isinstance(layer, Reorg):
            out.append("[reorg]" if layer.old else "[reorg3d]")
            out.append(f"stride={layer.stride}")
            if layer.reverse:
                out.append("reverse=1")
        elif isinstance(layer, Sam):
            out.append("[sam]")
            out.append(f"from={layer.from_layer}")
        elif isinstance(layer, ScaleChannels):
            out.append("[scale_channels]")
            out.append(f"from={layer.from_layer}")
            if layer.scale_wh:
                out.append("scale_wh=1")
        else:
            out.append(f"[{layer.section}]")
            for key, value in layer.raw.items():
                out.append(f"{key}={value}")
        if not isinstance(layer, Unimplemented):
            # unconsumed-but-preserved keys ride through verbatim
            for key, value in darknet.layer_extra(idx).items():
                out.append(f"{key}={value}")
            # generic training options (Unimplemented keeps them in raw)
            if idx in stop_by_idx:
                out.append(f"stopbackward={stop_by_idx[idx]}")
            if idx in only_fwd:
                out.append("onlyforward=1")
    return "\n".join(out) + "\n"

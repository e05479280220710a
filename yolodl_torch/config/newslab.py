"""NEWSLABv1 JSON5 model-description front-end.

Equivalent capability to the reference's ``model-config`` crate:
``model-config/src/model.rs:11-55`` (Model with recursive ``includes``, max
depth 5), ``model-config/src/group.rs`` (named groups of layers), and
``model-config/src/module/*.rs`` (the 17 tagged module kinds and their
defaults).  Field names, defaults, and JSON5 syntax are parity surface: the
reference's ``cfg/model/*.json5`` files must load unchanged.

This module only *parses and validates* — graph flattening and shape
inference live in :mod:`yolodl_torch.graph`.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Mapping, Optional, Tuple, Union

from ..shapes import Shape
from . import json5_reader

MAX_INCLUDE_DEPTH = 5  # model.rs:11-13


@dataclasses.dataclass(frozen=True)
class BatchNormConfig:
    """`bn` block (model-config/src/module/bn.rs): enabled/affine default true."""

    enabled: bool = True
    affine: bool = True
    var_min: Optional[float] = None
    var_max: Optional[float] = None

    @staticmethod
    def parse(raw: Optional[Mapping]) -> "BatchNormConfig":
        if raw is None:
            return BatchNormConfig()
        return BatchNormConfig(
            enabled=bool(raw.get("enabled", True)),
            affine=bool(raw.get("affine", True)),
            var_min=raw.get("var_min"),
            var_max=raw.get("var_max"),
        )


@dataclasses.dataclass(frozen=True)
class ModuleCfg:
    """Base class for layer configs. ``name`` labels the node inside its group;
    ``from_`` is the input path spec (None = infer from previous layer)."""

    name: Optional[str] = None

    @property
    def kind(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Input(ModuleCfg):
    shape: Shape = Shape()

    def __post_init__(self):
        if self.name is None:
            raise ValueError("Input module requires a name")


@dataclasses.dataclass(frozen=True)
class ConvBn2D(ModuleCfg):
    """conv_bn_2d_block.rs: defaults s=1, p=k//2, d=1, g=1, bias=true, act=mish.

    ``order`` selects the forward order: "act_bn" = conv→act→bn (the
    reference's NEWSLAB quirk, conv_bn_2d.rs:88-101); "bn_act" = conv→bn→act
    (darknet convolutional semantics, used by the .cfg front-end).
    """

    from_: Optional[str] = None
    c: int = 0
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    d: int = 1
    g: int = 1
    bias: bool = True
    act: str = "mish"
    bn: BatchNormConfig = BatchNormConfig()
    order: str = "act_bn"

    @property
    def padding(self) -> int:
        return self.k // 2 if self.p is None else self.p


@dataclasses.dataclass(frozen=True)
class Conv2D(ModuleCfg):
    from_: Optional[str] = None
    c: int = 0
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    d: int = 1
    g: int = 1
    bias: bool = True

    @property
    def padding(self) -> int:
        return self.k // 2 if self.p is None else self.p


@dataclasses.dataclass(frozen=True)
class DeconvBn2D(ModuleCfg):
    """deconv_bn_2d.rs: transposed conv; `op` = output padding."""

    from_: Optional[str] = None
    c: int = 0
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    op: int = 0
    d: int = 1
    g: int = 1
    bias: bool = True
    act: str = "mish"
    bn: BatchNormConfig = BatchNormConfig()

    @property
    def padding(self) -> int:
        return self.k // 2 if self.p is None else self.p


@dataclasses.dataclass(frozen=True)
class DarkCsp2D(ModuleCfg):
    """dark_csp_2d.rs: defaults shortcut=true, c_mul=1.0."""

    from_: Optional[str] = None
    c: int = 0
    repeat: int = 1
    shortcut: bool = True
    c_mul: float = 1.0
    bn: BatchNormConfig = BatchNormConfig()


@dataclasses.dataclass(frozen=True)
class SppCsp2D(ModuleCfg):
    """spp_csp_2d.rs: defaults k=[1,5,9,13], c_mul=0.5."""

    from_: Optional[str] = None
    c: int = 0
    k: Tuple[int, ...] = (1, 5, 9, 13)
    c_mul: float = 0.5
    bn: BatchNormConfig = BatchNormConfig()


@dataclasses.dataclass(frozen=True)
class UpSample2D(ModuleCfg):
    """up_sample_2d.rs: config is {type: ByScale, scale} or {type: ByStride, stride, reverse}."""

    from_: Optional[str] = None
    scale: float = 2.0
    stride: Optional[int] = None
    reverse: bool = False


@dataclasses.dataclass(frozen=True)
class Concat2D(ModuleCfg):
    from_: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Sum2D(ModuleCfg):
    from_: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Detect2D(ModuleCfg):
    """Head decode config.  ``variant``/``channel_order`` default to the
    NEWSLAB conventions ("scaled" power decode, entry-major channels); the
    darknet front-end overrides them for .weights parity."""

    from_: Optional[str] = None
    classes: int = 0
    # anchors are (h, w) pairs in image-ratio units (model-config Size)
    anchors: Tuple[Tuple[float, float], ...] = ()
    variant: str = "scaled"  # "scaled" | "darknet"
    # xy decode scale: σ(t)·s − 0.5(s−1).  The NEWSLAB scaled decode is
    # fixed at 2 (detect_2d.rs:66-139); darknet heads carry the cfg's
    # scale_x_y (2.0 for yolov4-csp, 1.05 for cspx-p7-mish).
    scale_xy: float = 2.0
    channel_order: str = "entry_major"  # "entry_major" | "anchor_major"
    entry_layout: str = "cycxhw"  # "cycxhw" (NEWSLAB) | "xywh" (darknet)
    class_activation: str = "sigmoid"  # "sigmoid" | "softmax" (region heads)
    # Gaussian-YOLO head: entries are interleaved mean/sigma
    # (mu_x, s_x, mu_y, s_y, mu_w, s_w, mu_h, s_h, obj, classes) — darknet
    # gaussian_yolo_layer.c:809-825
    gaussian: bool = False


@dataclasses.dataclass(frozen=True)
class MergeDetect2D(ModuleCfg):
    from_: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class GroupRef(ModuleCfg):
    """Sub-graph instantiation: `from` maps the sub-group's Input names to
    paths in the enclosing group (group_ref.rs:6-11)."""

    from_: Mapping[str, str] = dataclasses.field(default_factory=dict)
    group: str = ""

    def __post_init__(self):
        if self.name is None:
            raise ValueError("GroupRef module requires a name")


@dataclasses.dataclass(frozen=True)
class MaxPool(ModuleCfg):
    """When ``total_padding`` is set, darknet maxpool semantics apply:
    out = (in + total_padding - size)//stride + 1 with asymmetric -inf pads
    (darknet-config max_pool.rs:19-34); otherwise symmetric torch-style."""

    from_: Optional[str] = None
    size: int = 2
    stride_y: int = 2
    stride_x: int = 2
    padding: int = 0
    maxpool_depth: bool = False
    total_padding: Optional[int] = None
    pool_kind: str = "max"  # "max" | "avg" (darknet local_avgpool)


@dataclasses.dataclass(frozen=True)
class Linear(ModuleCfg):
    """Fully-connected layer.  ``bn`` defaults to disabled: the reference's
    Linear carries a bn field (linear.rs:9) but its runtime is ``todo!()``,
    and darknet connected layers only normalize when batch_normalize=1 —
    set ``bn: {enabled: true}`` explicitly to opt in (connected-BN order:
    gemm → BN scale → +bias → act)."""

    from_: Optional[str] = None
    out: int = 0
    act: str = "linear"
    bn: BatchNormConfig = BatchNormConfig(enabled=False)


@dataclasses.dataclass(frozen=True)
class GlobalAvgPool2D(ModuleCfg):
    """darknet [avgpool]: global spatial average → [b, c, 1, 1] (keepdims,
    matching darknet's [1,1,c] output so 1×1 convs can follow)."""

    from_: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Identity(ModuleCfg):
    """Pass-through (darknet [cost] at inference)."""

    from_: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Reorg2D(ModuleCfg):
    """darknet reorg.  ``old=True`` reproduces [reorg]/[reorg_old] (the
    historical flatten-reinterpret semantics: parser.c:81 maps [reorg] to
    REORG_OLD, whose forward reinterprets the input buffer as
    [c/s^2, h*s, w*s] before the shuffle — blas.c reorg_cpu with input
    dims).  ``old=False`` is the plain space-to-depth of [reorg3d]."""

    from_: Optional[str] = None
    stride: int = 2
    reverse: bool = False
    old: bool = True


@dataclasses.dataclass(frozen=True)
class DarknetSam(ModuleCfg):
    """darknet [sam]: elementwise product of previous layer and `from`
    (sam_layer.c:61-71).  from_ = (prev, referenced)."""

    from_: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class DarknetScaleChannels(ModuleCfg):
    """darknet [scale_channels] (SE block): broadcast-multiply the previous
    layer's [b,1,1,c] (or [b,h,w,1] when scale_wh) onto `from`
    (scale_channels_layer.c).  from_ = (prev, referenced); output takes the
    referenced layer's shape."""

    from_: Tuple[str, ...] = ()
    scale_wh: bool = False


@dataclasses.dataclass(frozen=True)
class Yolov1Detection(ModuleCfg):
    """darknet [detection] (YOLOv1 head, detection_layer.c forward): copy
    with optional per-cell softmax over the leading side²·classes block.
    Per-batch layout: [S²·C class probs][S²·B confidences][S²·B·4 boxes]."""

    from_: Optional[str] = None
    classes: int = 20
    side: int = 7
    num: int = 2
    softmax: bool = False


@dataclasses.dataclass(frozen=True)
class DarknetRnn(ModuleCfg):
    """darknet [rnn] (rnn_layer.c): 3 connected sub-layers, time-major scan.
    ``time_steps`` comes from the cfg's [net] section."""

    from_: Optional[str] = None
    out: int = 0
    hidden: int = 0
    act: str = "logistic"
    self_act: str = "logistic"
    bn: bool = False
    shortcut: bool = False
    time_steps: int = 1


@dataclasses.dataclass(frozen=True)
class DarknetGru(ModuleCfg):
    """darknet [gru] (gru_layer.c): 6 linear connected sub-layers."""

    from_: Optional[str] = None
    out: int = 0
    bn: bool = False
    time_steps: int = 1


@dataclasses.dataclass(frozen=True)
class DarknetLstm(ModuleCfg):
    """darknet [lstm] (lstm_layer.c): 8 linear connected sub-layers."""

    from_: Optional[str] = None
    out: int = 0
    bn: bool = False
    time_steps: int = 1


@dataclasses.dataclass(frozen=True)
class DarknetCrnn(ModuleCfg):
    """darknet [crnn] (crnn_layer.c): the rnn recurrence with conv
    sub-layers of this geometry (requires stride 1 so the hidden state's
    spatial size is invariant across steps)."""

    from_: Optional[str] = None
    out: int = 0
    hidden: int = 0
    k: int = 3
    p: int = 0
    d: int = 1
    g: int = 1
    act: str = "logistic"
    bn: bool = False
    shortcut: bool = False
    time_steps: int = 1


@dataclasses.dataclass(frozen=True)
class Dropout(ModuleCfg):
    """darknet [dropout]; identity at inference."""

    from_: Optional[str] = None
    probability: float = 0.5


@dataclasses.dataclass(frozen=True)
class Softmax(ModuleCfg):
    """darknet [softmax] over the class axis."""

    from_: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DynamicPad2D(ModuleCfg):
    from_: Optional[str] = None
    pad_kind: str = "zero"  # zero | replication | reflection
    l: int = 0
    r: int = 0
    t: int = 0
    b: int = 0


@dataclasses.dataclass(frozen=True)
class DarknetRoute(ModuleCfg):
    """darknet [route]: concat of inputs, each sliced to channel group
    group_id/num_groups (darknet-config route.rs).  Functional here, unlike
    the reference's todo!() stub (tch-modules module.rs:219-227)."""

    from_: Tuple[str, ...] = ()
    group_id: int = 0
    num_groups: int = 1


@dataclasses.dataclass(frozen=True)
class DarknetShortcut(ModuleCfg):
    """darknet [shortcut]: elementwise sum (over the common channel prefix)
    followed by an activation (darknet-config shortcut.rs:5-21)."""

    from_: Tuple[str, ...] = ()
    act: str = "linear"
    weights_type: str = "none"


@dataclasses.dataclass(frozen=True)
class Model:
    """A validated model description: named groups + the main group name."""

    groups: Mapping[str, Tuple[ModuleCfg, ...]]
    main_group: str


# ---------------------------------------------------------------------------
# parsing


def _parse_module(raw: Mapping) -> ModuleCfg:
    kind = raw.get("kind")
    if kind is None:
        raise ValueError(f"module entry missing 'kind': {raw!r}")
    name = raw.get("name")
    frm = raw.get("from")

    def single_from() -> Optional[str]:
        if frm is None:
            return None
        if not isinstance(frm, str):
            raise ValueError(f"{kind}: 'from' must be a single path, got {frm!r}")
        return frm

    def multi_from() -> Tuple[str, ...]:
        if not isinstance(frm, (list, tuple)):
            raise ValueError(f"{kind}: 'from' must be a list of paths, got {frm!r}")
        return tuple(frm)

    if kind == "Input":
        return Input(name=name, shape=Shape(raw["shape"]))
    if kind == "ConvBn2D":
        return ConvBn2D(
            name=name, from_=single_from(), c=int(raw["c"]), k=int(raw["k"]),
            s=int(raw.get("s", 1)), p=raw.get("p"), d=int(raw.get("d", 1)),
            g=int(raw.get("g", 1)), bias=bool(raw.get("bias", True)),
            act=str(raw.get("act", "mish")), bn=BatchNormConfig.parse(raw.get("bn")),
        )
    if kind == "Conv2D":
        return Conv2D(
            name=name, from_=single_from(), c=int(raw["c"]), k=int(raw["k"]),
            s=int(raw.get("s", 1)), p=raw.get("p"), d=int(raw.get("d", 1)),
            g=int(raw.get("g", 1)), bias=bool(raw.get("bias", True)),
        )
    if kind == "DeconvBn2D":
        return DeconvBn2D(
            name=name, from_=single_from(), c=int(raw["c"]), k=int(raw["k"]),
            s=int(raw.get("s", 1)), p=raw.get("p"), op=int(raw.get("op", 0)),
            d=int(raw.get("d", 1)), g=int(raw.get("g", 1)),
            bias=bool(raw.get("bias", True)), act=str(raw.get("act", "mish")),
            bn=BatchNormConfig.parse(raw.get("bn")),
        )
    if kind == "DarkCsp2D":
        return DarkCsp2D(
            name=name, from_=single_from(), c=int(raw["c"]), repeat=int(raw["repeat"]),
            shortcut=bool(raw.get("shortcut", True)), c_mul=float(raw.get("c_mul", 1.0)),
            bn=BatchNormConfig.parse(raw.get("bn")),
        )
    if kind == "SppCsp2D":
        return SppCsp2D(
            name=name, from_=single_from(), c=int(raw["c"]),
            k=tuple(raw.get("k", (1, 5, 9, 13))), c_mul=float(raw.get("c_mul", 0.5)),
            bn=BatchNormConfig.parse(raw.get("bn")),
        )
    if kind == "UpSample2D":
        cfg = raw.get("config")
        if cfg is None:
            # older flat schema: {"kind": "UpSample2D", "scale": 2.0}
            if "scale" in raw:
                cfg = {"type": "ByScale", "scale": raw["scale"]}
            else:
                raise ValueError("UpSample2D requires a 'config' block or 'scale'")
        if cfg.get("type") == "ByScale":
            return UpSample2D(name=name, from_=single_from(), scale=float(cfg["scale"]))
        if cfg.get("type") == "ByStride":
            return UpSample2D(
                name=name, from_=single_from(), scale=float(cfg["stride"]),
                stride=int(cfg["stride"]), reverse=bool(cfg.get("reverse", False)),
            )
        raise ValueError(f"unknown UpSample2D config type: {cfg!r}")
    if kind == "Concat2D":
        return Concat2D(name=name, from_=multi_from())
    if kind == "Sum2D":
        return Sum2D(name=name, from_=multi_from())
    if kind == "Detect2D":
        anchors = tuple((float(a[0]), float(a[1])) for a in raw["anchors"])
        return Detect2D(
            name=name, from_=single_from(), classes=int(raw["classes"]), anchors=anchors
        )
    if kind == "MergeDetect2D":
        return MergeDetect2D(name=name, from_=multi_from())
    if kind == "GroupRef":
        if not isinstance(frm, Mapping):
            raise ValueError("GroupRef 'from' must be a name→path mapping")
        return GroupRef(name=name, from_=dict(frm), group=str(raw["group"]))
    if kind == "MaxPool":
        return MaxPool(
            name=name, from_=single_from(), size=int(raw["size"]),
            stride_y=int(raw.get("stride_y", raw.get("stride", raw["size"]))),
            stride_x=int(raw.get("stride_x", raw.get("stride", raw["size"]))),
            padding=int(raw.get("padding", 0)),
            maxpool_depth=bool(raw.get("maxpool_depth", False)),
        )
    if kind == "Linear":
        bn_raw = raw.get("bn")
        return Linear(name=name, from_=single_from(), out=int(raw["out"]),
                      bn=(BatchNormConfig.parse(bn_raw) if bn_raw is not None
                          else BatchNormConfig(enabled=False)))
    if kind == "DynamicPad2D":
        return DynamicPad2D(
            name=name, from_=single_from(), pad_kind=str(raw.get("type", "zero")),
            l=int(raw.get("l", 0)), r=int(raw.get("r", 0)),
            t=int(raw.get("t", 0)), b=int(raw.get("b", 0)),
        )
    if kind == "DarknetRoute":
        return DarknetRoute(
            name=name, from_=multi_from(), group_id=int(raw.get("group_id", 0)),
            num_groups=int(raw.get("num_groups", 1)),
        )
    if kind == "DarknetShortcut":
        return DarknetShortcut(
            name=name, from_=multi_from(), act=str(raw.get("act", "linear")),
            weights_type=str(raw.get("weights_type", "none")),
        )
    raise ValueError(f"unknown module kind: {kind!r}")


def _load_groups(path: pathlib.Path, depth: int) -> Dict[str, Tuple[ModuleCfg, ...]]:
    """Load `groups` of one file, recursing into `includes` (model.rs:15-42)."""
    if depth > MAX_INCLUDE_DEPTH:
        raise ValueError(f"include depth exceeds {MAX_INCLUDE_DEPTH}: {path}")
    with open(path, encoding="utf-8") as f:
        raw = json5_reader.load(f)

    groups: Dict[str, Tuple[ModuleCfg, ...]] = {}
    for include in raw.get("includes", ()):  # includes resolve relative to the file
        inc_path = (path.parent / include).resolve()
        for gname, layers in _load_groups(inc_path, depth + 1).items():
            if gname in groups:
                raise ValueError(f"duplicate group {gname!r} via include {inc_path}")
            groups[gname] = layers

    for gname, layer_list in raw.get("groups", {}).items():
        if gname in groups:
            raise ValueError(f"duplicate group {gname!r} in {path}")
        groups[gname] = tuple(_parse_module(entry) for entry in layer_list)
    return groups


def load_model(path: Union[str, pathlib.Path]) -> Model:
    """Load a NEWSLABv1 JSON5 model file, resolving includes."""
    path = pathlib.Path(path)
    with open(path, encoding="utf-8") as f:
        raw = json5_reader.load(f)
    main_group = raw.get("main_group")
    if not main_group:
        raise ValueError(f"{path}: missing 'main_group'")
    groups = _load_groups(path, depth=0)
    if main_group not in groups:
        raise ValueError(f"{path}: the group {main_group!r} does not exist")
    return Model(groups=groups, main_group=main_group)


def parse_model_dict(raw: Mapping) -> Model:
    """Build a Model from an already-parsed dict (no includes)."""
    groups = {
        gname: tuple(_parse_module(entry) for entry in layers)
        for gname, layers in raw.get("groups", {}).items()
    }
    main_group = raw["main_group"]
    if main_group not in groups:
        raise ValueError(f"the group {main_group!r} does not exist")
    return Model(groups=groups, main_group=main_group)

"""Darknet activation family as elementwise tensor functions.

Counterpart of ``yolodl_tpu/activations.py``: the same 23 entries, the same
canonical names and darknet spellings, and ``apply``/``resolve``.

``softplus`` is written as JAX's ``jax.nn.softplus`` computes it,
``log1p(exp(-|x|)) + max(x, 0)``, so that Mish matches the reference to
float rounding.  ``torch.nn.functional.softplus`` returns ``x`` above a
threshold of 20 and would differ there.  The NCHW port keeps channels on
axis 1, so the channel-normalizing entries default to ``channel_axis=1``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

MISH = "mish"
HARD_MISH = "hard_mish"
SWISH = "swish"
NORMALIZE_CHANNELS = "normalize_channels"
NORMALIZE_CHANNELS_SOFTMAX = "normalize_channels_softmax"
NORMALIZE_CHANNELS_SOFTMAX_MAXVAL = "normalize_channels_softmax_maxval"
LOGISTIC = "logistic"
LOGGY = "loggy"
RELU = "relu"
LRELU = "l_relu"
ELU = "elu"
SELU = "selu"
GELU = "gelu"
RELIE = "relie"
RAMP = "ramp"
LINEAR = "linear"
TANH = "tanh"
PLSE = "plse"
LEAKY = "leaky"
STAIR = "stair"
HARDTAN = "hardtan"
LHTAN = "lhtan"
RELU6 = "relu6"

# channel axis of the port's NCHW activations
CHANNEL_AXIS = 1


def softplus(x: Tensor) -> Tensor:
    """JAX's formula: log1p(exp(-|x|)) + max(x, 0), no threshold."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def mish(x: Tensor) -> Tensor:
    """x * tanh(softplus(x)) — the YOLOv4 default."""
    return x * torch.tanh(softplus(x))


def hard_mish(x: Tensor) -> Tensor:
    """Piecewise-quadratic mish approximation (tch-act/src/impls.rs:31-36)."""
    case1 = torch.clamp(x, -2.0, 0.0)
    case2 = torch.clamp(x, min=0.0)
    return (case1 * case1 / 2.0 + case1) + case2


def swish(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


def leaky(x: Tensor) -> Tensor:
    """Darknet leaky: slope 0.1 (tch-act/src/impls.rs:27-29)."""
    return torch.clamp(x, min=0.0) + torch.clamp(x, max=0.0) * 0.1


def lrelu(x: Tensor) -> Tensor:
    """Leaky with slope 0.2 (tch-act/src/impls.rs:42-44)."""
    return torch.maximum(x, x * 0.2)


def loggy(x: Tensor) -> Tensor:
    return 2.0 * torch.sigmoid(x) - 1.0


def relie(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, 0.01 * x)


def ramp(x: Tensor) -> Tensor:
    return x * (x > 0) + 0.1 * x


def plse(x: Tensor) -> Tensor:
    return torch.where(
        x < -4.0,
        0.01 * (x + 4.0),
        torch.where(x > 4.0, 0.01 * (x - 4.0) + 1.0, 0.125 * x + 0.5),
    )


def stair(x: Tensor) -> Tensor:
    n = torch.floor(x)
    half = torch.floor(x / 2.0)
    is_even = torch.remainder(n, 2) == 0
    return torch.where(is_even, half, (x - n) + half)


def hardtan(x: Tensor) -> Tensor:
    return torch.clamp(x, -1.0, 1.0)


def lhtan(x: Tensor) -> Tensor:
    return torch.where(x < 0.0, 0.001 * x,
                       torch.where(x > 1.0, 0.001 * (x - 1.0) + 1.0, x))


def relu6(x: Tensor) -> Tensor:
    return torch.clamp(x, 0.0, 6.0)


def elu(x: Tensor) -> Tensor:
    return F.elu(x)


def selu(x: Tensor) -> Tensor:
    return F.selu(x)


def gelu(x: Tensor) -> Tensor:
    """tanh approximation — ``jax.nn.gelu``'s default (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def normalize_channels(x: Tensor, channel_axis: int = CHANNEL_AXIS) -> Tensor:
    """Relu then divide by the channel-sum (darknet activations.c)."""
    relu_x = torch.clamp(x, min=0.0)
    total = torch.sum(relu_x, dim=channel_axis, keepdim=True)
    return relu_x / torch.clamp(total, min=1e-6)


def normalize_channels_softmax(x: Tensor, channel_axis: int = CHANNEL_AXIS) -> Tensor:
    return torch.softmax(x, dim=channel_axis)


def normalize_channels_softmax_maxval(x: Tensor,
                                      channel_axis: int = CHANNEL_AXIS) -> Tensor:
    sm = torch.softmax(x, dim=channel_axis)
    maxval = torch.amax(sm, dim=channel_axis, keepdim=True)
    return sm / torch.clamp(maxval, min=1e-6)


_TABLE: Dict[str, Callable[[Tensor], Tensor]] = {
    LINEAR: lambda x: x,
    MISH: mish,
    HARD_MISH: hard_mish,
    SWISH: swish,
    RELU: torch.relu,
    LEAKY: leaky,
    LOGISTIC: torch.sigmoid,
    LOGGY: loggy,
    LRELU: lrelu,
    ELU: elu,
    SELU: selu,
    GELU: gelu,
    RELIE: relie,
    RAMP: ramp,
    TANH: torch.tanh,
    PLSE: plse,
    STAIR: stair,
    HARDTAN: hardtan,
    LHTAN: lhtan,
    RELU6: relu6,
    NORMALIZE_CHANNELS: normalize_channels,
    NORMALIZE_CHANNELS_SOFTMAX: normalize_channels_softmax,
    NORMALIZE_CHANNELS_SOFTMAX_MAXVAL: normalize_channels_softmax_maxval,
}

# Darknet .cfg spelling → canonical name (darknet uses e.g. `activation=leaky`).
DARKNET_NAMES: Dict[str, str] = {
    "mish": MISH,
    "hard_mish": HARD_MISH,
    "swish": SWISH,
    "normalize_channels": NORMALIZE_CHANNELS,
    "normalize_channels_softmax": NORMALIZE_CHANNELS_SOFTMAX,
    "normalize_channels_softmax_maxval": NORMALIZE_CHANNELS_SOFTMAX_MAXVAL,
    "logistic": LOGISTIC,
    "loggy": LOGGY,
    "relu": RELU,
    "lrelu": LRELU,
    "elu": ELU,
    "selu": SELU,
    "gelu": GELU,
    "relie": RELIE,
    "ramp": RAMP,
    "linear": LINEAR,
    "tanh": TANH,
    "plse": PLSE,
    "leaky": LEAKY,
    "stair": STAIR,
    "hardtan": HARDTAN,
    "lhtan": LHTAN,
    "relu6": RELU6,
}


def resolve(name: str) -> Callable[[Tensor], Tensor]:
    """Look up an activation function by canonical or darknet name."""
    key = name.lower()
    key = DARKNET_NAMES.get(key, key)
    if key not in _TABLE:
        raise KeyError(f"unknown activation: {name!r}")
    return _TABLE[key]


def apply(name: str, x: Tensor) -> Tensor:
    return resolve(name)(x)


ALL_ACTIVATIONS = tuple(_TABLE.keys())

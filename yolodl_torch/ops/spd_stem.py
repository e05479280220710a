"""Space-to-depth stem rewrite: the stem pair (and, with ``spd_stem="deep"``,
the stage-1 residual pair) run over 2×2 → channel packed maps.

Counterpart of ``yolodl_tpu/ops/spd_stem.py``.  The rewrite turns

    conv(k3, s1, C→C0) → BN → act → conv(k3, s2, C0→C1) → BN → act

into two half-resolution convolutions over the space-to-depth input

    SPD(x): [B, C, H, W] → [B, 4C, H/2, W/2]
    conv(k3, 4C→4·C0)   — output channels are the 4 phases of the first conv
    BN (phase-grouped) → act
    conv(k3, 4·C0→C1)   — the stride-2 sampling folded into the phase choice
    BN → act            — exactly the second conv's output

and, for the deep region, ``conv(1×1) → conv(3×3) → shortcut`` into the same
pair of convs over packed phases (:func:`spd_res_block_apply`).  The result
is exact: the packed convs are the same linear maps, and phase-grouped BN
combines the batch statistics of the 4 phases of each channel, which are
the full-resolution statistics.

Layout: NCHW activations and OIHW kernels.  Channel order of a packed map:
``(dy·2 + dx)·C + c`` (``ops/simple.py`` ``space_to_depth``), the
reference's.  The packed kernels are built from the canonical ``[out, in,
k, k]`` kernels inside the forward, so parameters and checkpoints keep the
canonical layout and autograd sums each tap's contributions into the
canonical weight, as the reference's ``.at[].set`` VJP does.  Each packed
kernel is one gather from the canonical kernel through an index that is
computed once per shape and device (:func:`scatter_weights`), not one
slice assignment per tap: the reference's scatter, entry for entry.

Phase-major tiling: a per-channel vector of the packed map is the vector
repeated 4 times (``Tensor.repeat``, the reference's ``jnp.tile``), never
``repeat_interleave``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import activations
from ..config import newslab as cfg
from .conv import conv2d_apply
from .norm import DEFAULT_EPS, DEFAULT_MOMENTUM, _stats_dtype, batch_norm_apply
from .simple import depth_to_space, space_to_depth  # noqa: F401  (re-exported)

Tensor = torch.Tensor
# (o0, i0, y, x, u, v): the packed kernel's block at output channels o0.. and
# input channels i0.., tap (y, x), is the canonical kernel's tap (u, v)
Tap = Tuple[int, int, int, int, int, int]


@functools.lru_cache(maxsize=None)
def _scatter_index(w_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                   taps: Tuple[Tap, ...], device: torch.device) -> Tuple[Tensor, Tensor]:
    """(idx, inv): ``idx`` holds the flat position in ``F.pad(w.reshape(-1),
    (0, 1))`` of every entry of the packed kernel (a canonical entry, or the
    appended zero); ``inv[r, p]`` is the packed position of the r-th copy of
    canonical entry p.  Every entry has the same number of copies."""
    co, ci, kh, kw = w_shape
    numel = co * ci * kh * kw
    idx = np.full(out_shape, numel, dtype=np.int64)
    grid = (np.arange(co)[:, None] * ci + np.arange(ci)[None, :]) * (kh * kw)
    for o0, i0, y, x, u, v in taps:
        idx[o0:o0 + co, i0:i0 + ci, y, x] = grid + u * kw + v
    flat = idx.reshape(-1)
    copies = np.bincount(flat, minlength=numel + 1)[:numel]
    assert copies.min() == copies.max() > 0, "every canonical entry needs one copy count"
    order = np.argsort(flat, kind="stable")[:numel * copies[0]]
    inv = order.reshape(numel, copies[0]).T.copy()
    return torch.from_numpy(idx).to(device), torch.from_numpy(inv).to(device)


class _Scatter(torch.autograd.Function):
    """The packed kernel as one gather; the backward sums each canonical
    entry's copies in a fixed order (a gather and a sum over the copies),
    so it is deterministic, where an accumulating scatter is not."""

    @staticmethod
    def forward(ctx, w, idx, inv):
        ctx.save_for_backward(inv)
        ctx.w_shape = w.shape
        return F.pad(w.reshape(-1), (0, 1))[idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.reshape(-1)[inv].sum(0).reshape(ctx.w_shape), None, None


def scatter_weights(w: Tensor, out_shape: Tuple[int, ...], taps: Iterable[Tap]) -> Tensor:
    """The packed kernel of ``out_shape`` whose blocks ``taps`` name copies of
    the canonical OIHW kernel ``w``'s taps, zero elsewhere: one gather, whose
    backward sums into ``w``.  No two taps write one entry (each builder's
    map is one to one), so this is the reference's ``.at[].set`` chain."""
    idx, inv = _scatter_index(tuple(w.shape), tuple(out_shape), tuple(taps), w.device)
    return _Scatter.apply(w, idx, inv)


def _s1_taps(c_out: int, c_in: int):
    """The 3×3 stride-1 conv over SPD cells: output phase (a, b), tap (u, v)
    reads input phase (dy, dx) of cell offset (di, dj)."""
    for a in range(2):
        for b in range(2):
            for u in range(3):
                for v in range(3):
                    di, dy = divmod(a + u - 1, 2)
                    dj, dx = divmod(b + v - 1, 2)
                    yield ((a * 2 + b) * c_out, (dy * 2 + dx) * c_in, di + 1, dj + 1, u, v)


def build_spd_s1_weights(w: Tensor) -> Tensor:
    """``[C', C, 3, 3]`` (k3 s1) → ``[4C', 4C, 3, 3]``: the stride-1 3×3 conv
    expressed over SPD cells.

    y[2i+a, 2j+b] = Σ_uv w[u,v]·x[2i+a+u−1, 2j+b+v−1]; writing the row as
    2(i+di)+dy gives di = ⌊(a+u−1)/2⌋, dy = (a+u−1) mod 2, so
    ``W'[(a·2+b)·C' + o, (dy·2+dx)·C + i, di+1, dj+1] = w[o, i, u, v]``."""
    c_out, c_in, k, _ = w.shape
    assert k == 3
    return scatter_weights(w, (4 * c_out, 4 * c_in, 3, 3), _s1_taps(c_out, c_in))


def build_spd_1x1_weights(w: Tensor) -> Tensor:
    """``[C', C, 1, 1]`` → ``[4C', 4C, 1, 1]``, block-diagonal over the SPD
    phases (a pointwise conv touches no neighbour)."""
    c_out, c_in = w.shape[:2]
    return scatter_weights(w, (4 * c_out, 4 * c_in, 1, 1),
                           ((ph * c_out, ph * c_in, 0, 0, 0, 0) for ph in range(4)))


def build_spd_stem_weights(w0: Tensor, w1: Tensor) -> Tuple[Tensor, Tensor]:
    """The two stem kernels in the SPD domain.

    w0: ``[C0, C_in, 3, 3]`` (k3 s1) → ``[4·C0, 4·C_in, 3, 3]``
    (:func:`build_spd_s1_weights`); w1: ``[C1, C0, 3, 3]`` (k3 s2) →
    ``[C1, 4·C0, 3, 3]``, the (a, b) = (0, 0) output case of the stride-1
    transform."""
    c0 = w0.shape[0]
    c1 = w1.shape[0]
    assert w0.shape[2] == 3 and w1.shape[2] == 3

    def taps():
        for u in range(3):
            for v in range(3):
                di, dy = divmod(u - 1, 2)
                dj, dx = divmod(v - 1, 2)
                yield (0, (dy * 2 + dx) * c0, di + 1, dj + 1, u, v)

    return build_spd_s1_weights(w0), scatter_weights(w1, (c1, 4 * c0, 3, 3), taps())


def phase_grouped_bn(
    params: Dict[str, Tensor],
    state: Dict[str, Tensor],
    x: Tensor,
    train: bool,
    eps: float = DEFAULT_EPS,
    momentum: float = DEFAULT_MOMENTUM,
    phases: int = 4,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """BN over packed phases: ``x`` has ``phases``·C channels in (phase, c)
    order on dim 1; params and state are per original channel ``[C]``.  The
    batch statistics combine the phases (equal counts), which gives the
    canonical BN's.  ``ops/norm.py``'s rounding: statistics in
    ``_stats_dtype``, ``inv``/``shift`` cast to the activation dtype before
    the multiply-add.  Used by the SPD stem and by W-fold regions
    (``ops/fold_region.py``)."""
    c = x.shape[1] // phases

    if train:
        x32 = x.to(_stats_dtype(x))
        mean_pc = torch.mean(x32, dim=(0, 2, 3)).reshape(phases, c)
        sq_pc = torch.mean(torch.square(x32), dim=(0, 2, 3)).reshape(phases, c)
        mean = torch.mean(mean_pc, dim=0)
        var = torch.mean(sq_pc, dim=0) - torch.square(mean)
        var = torch.clamp(var, min=0.0)
        n = x.numel() // c  # the full-resolution count per channel
        unbiased = var * (n / max(n - 1, 1))
        new_state = {
            "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
            "var": (1.0 - momentum) * state["var"] + momentum * unbiased,
        }
    else:
        new_state = state
        mean, var = state["mean"], state["var"]

    inv = torch.rsqrt(var + eps)
    scale = params.get("scale")
    bias = params.get("bias")
    if scale is not None:
        inv = inv * scale
    shift = -mean * inv
    if bias is not None:
        shift = shift + bias
    view = (1, phases * c, 1, 1)
    inv4 = inv.repeat(phases).to(x.dtype).view(view)
    shift4 = shift.repeat(phases).to(x.dtype).view(view)
    return x * inv4 + shift4, new_state


def _tiled_bias(params: Dict[str, Any], phases: int = 4):
    """The conv bias of a packed map, or None: ``jnp.tile(b, phases)``."""
    b = params.get("b")
    return None if b is None else b.repeat(phases)


def spd_stem_apply(
    params0: Dict[str, Any],
    state0: Dict[str, Any],
    layer0: cfg.ConvBn2D,
    params1: Dict[str, Any],
    state1: Dict[str, Any],
    layer1: cfg.ConvBn2D,
    x: Tensor,
    train: bool,
) -> Tuple[Tensor, Dict[str, Any], Dict[str, Any]]:
    """The rewritten stem on NCHW ``x`` → (the second conv's output,
    new_state0, new_state1)."""
    w0p, w1p = build_spd_stem_weights(params0["w"], params1["w"])

    h = conv2d_apply(space_to_depth(x, 2), w0p, _tiled_bias(params0), padding=1)
    new_state0 = state0
    if layer0.bn.enabled:
        h, bn_s = phase_grouped_bn(params0["bn"], state0["bn"], h, train)
        new_state0 = {**state0, "bn": bn_s}
    h = activations.apply(layer0.act, h)

    h = conv2d_apply(h, w1p, params1.get("b"), padding=1)
    new_state1 = state1
    if layer1.bn.enabled:
        h, bn_s = batch_norm_apply(params1["bn"], state1["bn"], h, train)
        new_state1 = {**state1, "bn": bn_s}
    h = activations.apply(layer1.act, h)
    return h, new_state0, new_state1


def _packed_conv_bn_act(params, state, layer, wp, x, train):
    """One packed conv → (tiled bias) → phase-grouped BN → act."""
    h = conv2d_apply(x, wp, _tiled_bias(params), padding=(wp.shape[2] - 1) // 2)
    new_state = state
    if layer.bn.enabled:
        h, bn_s = phase_grouped_bn(params["bn"], state["bn"], h, train)
        new_state = {**state, "bn": bn_s}
    return activations.apply(layer.act, h), new_state


def spd_res_block_apply(
    params2: Dict[str, Any],
    state2: Dict[str, Any],
    layer2: cfg.ConvBn2D,
    params3: Dict[str, Any],
    state3: Dict[str, Any],
    layer3: cfg.ConvBn2D,
    shortcut_act: str,
    y1: Tensor,
    train: bool,
) -> Tuple[Tensor, Dict[str, Any], Dict[str, Any]]:
    """The stage-1 residual pair ``conv(1×1) → conv(3×3) → shortcut(+y1)``
    in the SPD domain: one pack of ``y1``, one unpack of the shortcut's
    output → (that output, new_state2, new_state3)."""
    w2p = build_spd_1x1_weights(params2["w"])
    w3p = build_spd_s1_weights(params3["w"])

    y1p = space_to_depth(y1, 2)
    h, new_state2 = _packed_conv_bn_act(params2, state2, layer2, w2p, y1p, train)
    h, new_state3 = _packed_conv_bn_act(params3, state3, layer3, w3p, h, train)
    out = activations.apply(shortcut_act, h + y1p)
    return depth_to_space(out, 2), new_state2, new_state3


def res_block_is_eligible(layer2: cfg.ModuleCfg, layer3: cfg.ModuleCfg) -> bool:
    """conv(1×1, s1) → conv(3×3, s1), conv→BN→act order, no dilation or
    groups: the stage-1 residual pair the deep region covers."""
    return (
        isinstance(layer2, cfg.ConvBn2D)
        and isinstance(layer3, cfg.ConvBn2D)
        and layer2.order == "bn_act"
        and layer3.order == "bn_act"
        and layer2.k == 1 and layer2.s == 1 and layer2.padding == 0
        and layer3.k == 3 and layer3.s == 1 and layer3.padding == 1
        and layer2.d == layer3.d == 1
        and layer2.g == layer3.g == 1
    )


def stem_is_eligible(layer0: cfg.ModuleCfg, layer1: cfg.ModuleCfg) -> bool:
    """The darknet conv(k3, s1) → conv(k3, s2) stem in conv→BN→act order
    with no dilation or groups."""
    return (
        isinstance(layer0, cfg.ConvBn2D)
        and isinstance(layer1, cfg.ConvBn2D)
        and layer0.order == "bn_act"
        and layer1.order == "bn_act"
        and layer0.k == 3 and layer0.s == 1 and layer0.padding == 1
        and layer1.k == 3 and layer1.s == 2 and layer1.padding == 1
        and layer0.d == layer1.d == 1
        and layer0.g == layer1.g == 1
    )

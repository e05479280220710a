"""Shared helpers of the wgrad kernel modules.

Counterpart of ``yolodl_tpu/kernels/_util.py``: :func:`make_conv2d_with_wgrad`
builds the stride-1 "same" conv whose weight gradient comes from a given
``wgrad_fn``, so that ``conv2d_lowch`` and ``conv2d_db`` cannot drift apart
on the surrounding algebra.  :func:`wgrad_plan` cuts a launch into tiles,
chunks and stages; the other helpers check and launch the two wgrad
kernels, which share their signature and their scratch layout.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_DTYPES = (torch.float32, torch.bfloat16)

SMEM_LIMIT = 232_448      # dynamic shared memory one block may use on sm_90
# warps of a block (thread 0 is also the producer) -> accumulator registers
# one thread may hold: 16 warps have 128 registers a thread (18 m16n8
# tiles), 8 warps 255 (36 tiles, each fragment read for twice the MMAs)
ACC_REGS_MAX = {16: 72, 8: 144}
REGS_MAX = 255            # registers one thread can address
TMA_BOX_MAX = 256         # positions one TMA box may hold
STAGES_MAX = 8

# warp tiles (m16 tiles, n8 tiles) of 16-warp blocks and, for channel counts
# that are multiples of 8, of 8-warp blocks; the .cu sources instantiate
# exactly these
DB_TILES = ((4, 4), (2, 4), (2, 2), (1, 2))
LOWCH_TILES = ((9, 2), (4, 4), (3, 4), (2, 4), (2, 2), (1, 2))
DB_TILE_8 = (1, 4)        # with DB_TAPS taps
LOWCH_TILE_8 = (9, 4)
DB_TAPS = 9               # taps one warp of wgrad_db accumulates when k > 1

# the bf16 plan as the kernels read it: csrc/wgrad_common.cuh `enum PlanField`
PLAN_FIELDS = (
    "b", "h", "w", "ci", "co", "k",
    "wt", "strips", "rows_per_chunk", "chunks_per_col", "chunks",
    "ci_blk", "co_blk", "ci_splits", "co_splits",
    "a_tma", "b_tma", "cbox", "nbox",
    "stages", "warps", "mt", "nt", "taps", "wm", "wn", "wtap", "wk",
    "x_bytes", "g_bytes", "xbox_stride", "gbox_stride",
    "erow", "ebuf_bytes", "smem_bytes", "slices",
)

# the f32 kernels keep f32 FMA on CUDA cores (one TF32 pass would err by
# about 3e-4 of max|dW| over 739,328 terms): chunks sized for this many
# blocks per SM, in multiples of the kernels' 2-row sub-tile
F32_BLOCKS_PER_SM = 4
F32_ROWS_PER_SUBTILE = 2


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


def _box_channels(c: int) -> int:
    """Channels of one TMA box: the largest of 64, 32, 16, 8 dividing c
    (128, 64, 32 or 16 bytes: the swizzle spans)."""
    return next(n for n in (64, 32, 16, 8) if c % n == 0)


def _f32_plan(kind: str, b, h, w, ci, co, k, sms) -> dict:
    if kind == "lowch":
        ci_t = min(ci, max(1, 64 // (k * k)))
    else:
        ci_t = 64 if k == 1 else 16
    tiles = _ceil(ci, ci_t) * _ceil(co, 64)
    rows = max(1, _ceil(b * h * tiles, F32_BLOCKS_PER_SM * sms), _ceil(b * h, 65535))
    rows = _round_up(rows, F32_ROWS_PER_SUBTILE)
    chunks = b * _ceil(h, rows)
    return {"kind": kind, "dtype": "float32", "b": b, "h": h, "w": w, "ci": ci, "co": co,
            "k": k, "tiles": tiles, "rows_per_chunk": rows, "chunks": chunks,
            "slices": chunks, "reads_xp": _ceil(co, 64), "reads_g": _ceil(ci, ci_t)}


def _warp_tiles(kind: str, k: int, ci_blk: int, co_blk: int, aligned: bool):
    """The block's warps, the warp tile (mt, nt), the warps along each axis
    and the taps per warp for one block's output, or None when no block
    can hold it."""
    kk = k * k
    ntt = 2 * _ceil(co_blk, 16)
    if kind == "db":
        mtt = _ceil(ci_blk, 16)
        taps = 1 if k == 1 else DB_TAPS
        wtap = _ceil(kk, taps)
        menu = [(16, t) for t in (DB_TILES if (k == 1 and aligned) else ((1, 2),))]
        if k > 1 and aligned:
            menu.append((8, DB_TILE_8))
    else:
        mtt = _ceil(k * _round_up(k * ci_blk, 8), 16)
        taps, wtap = kk, 1
        menu = [(16, t) for t in LOWCH_TILES]
        if aligned:
            menu.append((8, LOWCH_TILE_8))
    best = None
    for warps, (mt, nt) in menu:
        acc = 4 * mt * nt * (taps if kind == "db" else 1)
        wm, wn = _ceil(mtt, mt), _ceil(ntt, nt)
        if acc > ACC_REGS_MAX[warps] or wm * wn * wtap > warps:
            continue
        wk = warps // (wm * wn * wtap)
        used = (mtt * ntt) / (wm * mt * wn * nt) * (wm * wn * wtap * wk / warps)
        loads_per_mma = (mt + nt / 2) / (mt * nt)
        score = used / (1 + loads_per_mma)
        if best is None or score > best[0] + 1e-9:
            best = (score, warps, mt, nt, taps, wm, wn, wtap, wk)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=256)
def wgrad_plan(kind: str, b: int, h: int, w: int, ci: int, co: int, k: int,
               dtype=torch.bfloat16, sms: int = 132) -> dict:
    """How one launch of ``wgrad_db`` (kind "db") or ``wgrad_lowch`` (kind
    "lowch") is cut: a pure function of the shapes, the dtype and the
    card's SM count, handed to the kernel field by field (``PLAN_FIELDS``).

    bf16: one block of 16 or 8 warps owns the whole ``[k²·Ci, Co]`` output
    where its accumulators fit 72 (16 warps) or 144 (8 warps) registers a
    thread, else the output is split along Co, then Ci, across blocks
    (``reads_xp``/``reads_g`` say how often each operand is then read from
    device memory).  The contraction is cut into ``chunks`` runs of output
    rows of one image and one column strip of ``wt`` positions, at most one
    per SM; each run's rows go through a ring of ``stages`` row strips in
    shared memory.  For k = 1 there is no halo, so the B·H·W positions are
    viewed as rows of any width that divides them.  Within a block the
    warps tile the output (``wm``×``wn``, times ``wtap`` tap groups for
    wgrad_db) and split the 16-position MMA steps ``wk`` ways; every chunk
    and K-split writes its own slice of the partials.
    """
    if kind not in ("db", "lowch"):
        raise ValueError(f"wgrad_plan: unknown kind {kind!r}")
    if min(b, h, w, ci, co) < 1 or k < 1 or k % 2 == 0:
        raise ValueError(f"wgrad_plan: bad shape b={b} h={h} w={w} ci={ci} co={co} k={k}")
    if kind == "db" and k not in (1, 3, 5) or kind == "lowch" and k > 7:
        raise ValueError(f"wgrad_plan: wgrad_{kind} does not take k={k}")
    if dtype == torch.float32:
        return _f32_plan(kind, b, h, w, ci, co, k, sms)
    if dtype != torch.bfloat16:
        raise ValueError(f"wgrad_plan: unsupported dtype {dtype}")

    a_tma, b_tma = ci % 8 == 0, co % 8 == 0
    # the output of one block: all of it, else split along Co, then Ci
    ci_blk, co_blk = ci, co
    while True:
        tiles = _warp_tiles(kind, k, ci_blk, co_blk, a_tma and b_tma)
        if tiles is not None:
            break
        if co_blk > 16:
            co_blk = _round_up(_ceil(co_blk, 2), 16)
        elif ci_blk > 16:
            ci_blk = _round_up(_ceil(ci_blk, 2), 16)
        else:
            raise ValueError(f"wgrad_{kind}: no plan for ci={ci} co={co} k={k}")
    # a box holds channels of one block only
    cbox = _box_channels(math.gcd(ci, ci_blk)) if a_tma else 0
    nbox = _box_channels(math.gcd(co, co_blk)) if b_tma else 0
    warps, mt, nt, taps, wm, wn, wtap, wk = tiles
    ci_splits, co_splits = _ceil(ci, ci_blk), _ceil(co, co_blk)

    # B2's packed operand: a ring of k + 1 expanded xp rows, each position
    # holding the k shifted pixels side by side (k·Ci padded to a multiple
    # of 8) in an odd number of 16-byte pieces; none for one tap of boxed
    # channels, where the staged strip is the packed operand
    expands = kind == "lowch" and not (k == 1 and a_tma)
    if expands:
        kc_pad = _round_up(k * ci_blk, 8)
        erow = 2 * kc_pad + (16 if (kc_pad // 8) % 2 == 0 else 0)
        erows = k + 1
    else:
        kc_pad = erow = erows = 0

    def ebuf_bytes(wt):
        return _round_up(wt * erow, 1024)

    def stage_bytes(wt):
        xpos = wt + k - 1
        if a_tma:
            xbox = _round_up(xpos * cbox * 2, 1024)
            xb = (ci_blk // cbox) * xbox
        else:
            xbox = 0
            xb = _round_up(xpos * ci * 2 + 32, 1024)
        if b_tma:
            gbox = _round_up(wt * nbox * 2, 1024)
            gb = _ceil(co_blk, nbox) * gbox
        else:
            gbox = 0
            gb = _round_up(wt * co * 2 + 32, 1024)
        return xb, gb, xbox, gbox

    # wgrad_db multiplies from the staged rows and holds k of them; wgrad_lowch
    # hands a stage back once its row is expanded
    min_stages = k + 2 if kind == "db" else 3
    room = SMEM_LIMIT - 2048
    wt_cap = TMA_BOX_MAX - (k - 1)
    wt_max = 0
    for wt in range(16, wt_cap + 1, 16):
        xb, gb, _, _ = stage_bytes(wt)
        if min_stages * (xb + gb) + erows * ebuf_bytes(wt) <= room:
            wt_max = wt
    if wt_max == 0:
        raise ValueError(f"wgrad_{kind}: a 16-position strip of ci={ci} co={co} k={k} "
                         f"does not fit shared memory")

    # the view: k = 1 has no halo, so rows may be any divisor of B·H·W
    vb, vh, vw = b, h, w
    if k == 1:
        total = b * h * w
        best = None
        for d in range(1, min(wt_max, total) + 1):
            if total % d == 0 and total // d >= sms:
                key = (d / _round_up(d, 16), d)
                if best is None or key > best:
                    best = key
        if best is not None and best[0] >= w / _round_up(w, 16):
            vb, vh, vw = 1, total // best[1], best[1]
    w16 = _ceil(vw, 16)
    strips = _ceil(w16, wt_max // 16)
    wt = 16 * _ceil(w16, strips)
    ebuf = ebuf_bytes(wt)
    xb, gb, xbox, gbox = stage_bytes(wt)
    stages = min(STAGES_MAX, (room - erows * ebuf) // (xb + gb))
    acc_regs = 4 * mt * nt * (taps if kind == "db" else 1)
    # the ring, the packed operand, and room for the K-split's scratch
    smem = max(2048 + stages * (xb + gb) + erows * ebuf,
               2048 + (warps * acc_regs * 128 if wk > 1 else 0))

    cols = vb * strips
    per_col = max(1, sms // (cols * ci_splits * co_splits))
    rows = _ceil(vh, per_col)
    per_col = _ceil(vh, rows)
    chunks = cols * per_col
    plan = {
        "b": vb, "h": vh, "w": vw, "ci": ci, "co": co, "k": k,
        "wt": wt, "strips": strips, "rows_per_chunk": rows, "chunks_per_col": per_col,
        "chunks": chunks, "ci_blk": ci_blk, "co_blk": co_blk, "ci_splits": ci_splits,
        "co_splits": co_splits, "a_tma": int(a_tma), "b_tma": int(b_tma), "cbox": cbox,
        "nbox": nbox, "stages": stages, "warps": warps, "mt": mt, "nt": nt, "taps": taps, "wm": wm,
        "wn": wn, "wtap": wtap, "wk": wk, "x_bytes": xb, "g_bytes": gb,
        "xbox_stride": xbox, "gbox_stride": gbox, "erow": erow,
        "ebuf_bytes": ebuf, "smem_bytes": smem, "slices": chunks,
    }
    assert tuple(plan) == PLAN_FIELDS
    # what PERF.md reports per shape, not read by the kernel: an operand
    # staged by whole pixels (channels not a multiple of 8) is read by every
    # block of a chunk, a boxed one only by the blocks that own its channels
    plan.update(
        kind=kind, dtype="bfloat16", blocks=chunks * ci_splits * co_splits, kc_pad=kc_pad,
        threads=32 * warps, regs_per_thread=min(REGS_MAX, 65_536 // (32 * warps)),
        acc_regs=acc_regs,
        reads_xp=co_splits * (1 if a_tma else ci_splits),
        reads_g=ci_splits * (1 if b_tma else co_splits),
        xp_halo=(rows + k - 1) / rows * (wt + k - 1) / wt)
    return plan


def wgrad_reference(xp: Tensor, g: Tensor, k: int) -> Tensor:
    """Plain version of both wgrad kernels: per tap an f32 einsum of the
    shifted ``xp`` window with ``g`` → ``[k, k, Ci, Co]`` f32."""
    _, h, w, co = g.shape
    x32 = xp.to(torch.float32)
    g32 = g.to(torch.float32)
    out = torch.empty((k, k, xp.shape[-1], co), dtype=torch.float32, device=xp.device)
    for u in range(k):
        for v in range(k):
            out[u, v] = torch.einsum("bhwc,bhwo->co", x32[:, u:u + h, v:v + w, :], g32)
    return out


def check_wgrad_args(name: str, xp: Tensor, g: Tensor, k: int, device) -> torch.device:
    """Validate the operands of a wgrad call; returns the resolved device."""
    device = torch.device(device)
    if xp.device.type != device.type or g.device != xp.device:
        raise ValueError(
            f"{name}: xp on {xp.device}, g on {g.device}, caller asked for {device}")
    if xp.dtype != g.dtype or xp.dtype not in _DTYPES:
        raise ValueError(f"{name}: xp and g must both be float32 or bfloat16, "
                         f"got {xp.dtype} and {g.dtype}")
    if xp.dim() != 4 or g.dim() != 4:
        raise ValueError(f"{name}: expected NHWC xp and g, got {tuple(xp.shape)}, "
                         f"{tuple(g.shape)}")
    b, hp, wp, _ = xp.shape
    gb, h, w, _ = g.shape
    if k < 1 or k % 2 == 0 or gb != b or hp != h + k - 1 or wp != w + k - 1:
        raise ValueError(f"{name}: xp {tuple(xp.shape)} is not g {tuple(g.shape)} "
                         f"padded for an odd kernel size k={k}")
    if not (xp.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{name}: xp and g must be contiguous NHWC")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def _readable_to_16(t: Tensor) -> Tensor:
    """``t`` itself where its memory starts at a multiple of 16 bytes and
    ends at one (the bulk copies read whole 16-byte pieces), else a copy
    that does."""
    nbytes = t.numel() * t.element_size()
    if t.data_ptr() % 16 == 0 and nbytes % 16 == 0:
        return t
    buf = torch.zeros(_round_up(nbytes, 16) // t.element_size(), dtype=t.dtype, device=t.device)
    buf[:t.numel()] = t.reshape(-1)
    return buf


def launch_wgrad(lib, kind: str, xp: Tensor, g: Tensor, k: int) -> Tensor:
    """Launch the ``kind`` ("db" or "lowch") kernel of ``lib`` and its chunk
    reduction on the current stream, cut as :func:`wgrad_plan` says; scratch
    and output come from ``torch.empty``."""
    b, _, _, ci = xp.shape
    _, h, w, co = g.shape
    out = torch.empty((k, k, ci, co), dtype=torch.float32, device=xp.device)
    if xp.numel() == 0 or g.numel() == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    plan = wgrad_plan(kind, b, h, w, ci, co, k, xp.dtype, sms)
    partial = torch.empty((plan["slices"], k * k * ci * co), dtype=torch.float32,
                          device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    ptr = ctypes.c_void_p
    if xp.dtype == torch.float32:
        fn = getattr(lib, f"yolodl_wgrad_{kind}_f32")
        fn.argtypes = [ptr, ptr, ptr, ptr] + [ctypes.c_int] * 7 + [ptr]
        fn.restype = ctypes.c_int
        err = fn(xp.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 b, h, w, ci, co, k, plan["rows_per_chunk"], stream)
    else:
        xp, g = _readable_to_16(xp), _readable_to_16(g)
        fields = (ctypes.c_int * len(PLAN_FIELDS))(*(plan[f] for f in PLAN_FIELDS))
        fn = getattr(lib, f"yolodl_wgrad_{kind}_bf16")
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        err = fn(xp.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 fields, len(PLAN_FIELDS), stream)
    if err != 0:
        raise RuntimeError(f"wgrad_{kind} launch failed: cudaError {err}")
    return out


def make_conv2d_with_wgrad(wgrad_fn, doc: str):
    """Stride-1 "same" NHWC conv ``conv2d(x, w, k)`` (w HWIO, output NHWC)
    whose weight gradient is ``wgrad_fn(xp, g, k, device=...)`` on the
    pre-padded input.

    The forward pads x once and keeps the padded ``xp`` for the backward, as
    the reference's custom-vjp forward does.  The forward conv and dX are
    the library's (cuDNN on the card): the NHWC tensors are handed to it as
    NCHW views, which it reads as channels-last without a copy, and dX is
    the library's backward-data of that same call, cropped by the padding.
    Only dW goes through ``wgrad_fn``.
    """

    class Conv2dWithWgrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, k):
            pad = (k - 1) // 2
            xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x.contiguous()
            w_oihw = w.to(x.dtype).permute(3, 2, 0, 1)
            y = F.conv2d(xp.permute(0, 3, 1, 2), w_oihw)
            ctx.save_for_backward(xp, w)
            ctx.k = k
            return y.permute(0, 2, 3, 1)

        @staticmethod
        def backward(ctx, gy):
            xp, w = ctx.saved_tensors
            k = ctx.k
            pad = (k - 1) // 2
            g = gy.contiguous()
            dx = dw = None
            if ctx.needs_input_grad[0]:
                dxp = torch.ops.aten.convolution_backward(
                    g.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2),
                    w.to(g.dtype).permute(3, 2, 0, 1), None, [1, 1], [0, 0], [1, 1],
                    False, [0, 0], 1, [True, False, False])[0].permute(0, 2, 3, 1)
                dx = dxp[:, pad:dxp.shape[1] - pad, pad:dxp.shape[2] - pad, :] if pad else dxp
            if ctx.needs_input_grad[1]:
                dw = wgrad_fn(xp, g.to(xp.dtype), k, device=xp.device).to(w.dtype)
            return dx, dw, None

    def conv2d(x: Tensor, w: Tensor, k: int) -> Tensor:
        if x.dim() != 4 or w.shape[:2] != (k, k) or w.shape[2] != x.shape[-1]:
            raise ValueError(f"conv2d: x {tuple(x.shape)} NHWC and w {tuple(w.shape)} "
                             f"HWIO disagree for k={k}")
        return Conv2dWithWgrad.apply(x, w, k)

    conv2d.__doc__ = doc
    return conv2d

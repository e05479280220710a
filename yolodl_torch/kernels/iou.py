"""Kernel B1: the IoU tile of NMS and the greedy resolution after it, each
a hand-written CUDA kernel beside its plain PyTorch version.

Counterpart of ``yolodl_tpu/kernels/iou_pallas.py`` (``pairwise_iou_pallas``)
and of the suppression in ``yolodl_tpu/loss/nms.py`` ``_suppress``.  The
kernels are ``yolodl_torch/csrc/iou.cu``; its source note says what bounds
each and how the design answers that.  Suppression is two launches per
batch:

- :func:`nms_conflict_bits` — ``[B, K, 4]`` boxes and ``[B, K]`` groups →
  ``[B, K, ceil(K/32)]`` int32 words; bit ``t`` of word ``w`` in row ``j``
  is ``conflict[b, j, 32w+t]``, i.e. candidate ``32w+t`` is suppressed by
  the higher-ranked candidate ``j`` if ``j`` is kept;
- :func:`nms_keep_from_bits` — those bits and ``valid [B, K]`` → ``keep
  [B, K]``, greedy NMS in rank order.

:func:`pairwise_iou` keeps the dense ``[B, K, K]`` f32 IoU matrix, off the
suppression path.

Each wrapper takes the kernel for CUDA tensors and its plain version
(``*_reference``) for CPU tensors.  On CUDA tensors it launches or raises:
nothing falls back.  ``<wrapper>.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

EPSILON = 1e-16  # geometry/boxes.py EPSILON

# fixed-point passes between two convergence checks of the plain resolution
CHECK_EVERY = 4

KINDS = ("greedy", "diou")
BOX_DTYPES = (torch.float32, torch.bfloat16)


def conflict_words(k: int) -> int:
    """32-bit words per row of the conflict bits of K candidates."""
    return (k + 31) // 32


# -- plain versions --------------------------------------------------------------


def pairwise_iou_reference(tlbr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [..., K, 4] TLBR → [..., K, K] f32 IoU, with
    the same operations in the same order as the kernel."""
    t = tlbr.to(torch.float32)
    rt, rl, rb, rr = t[..., :, None, 0], t[..., :, None, 1], t[..., :, None, 2], t[..., :, None, 3]
    ct, cl, cb, cr = t[..., None, :, 0], t[..., None, :, 1], t[..., None, :, 2], t[..., None, :, 3]
    inner_h = torch.clamp(torch.minimum(rb, cb) - torch.maximum(rt, ct), min=0.0)
    inner_w = torch.clamp(torch.minimum(rr, cr) - torch.maximum(rl, cl), min=0.0)
    inter = inner_h * inner_w
    area_r = (rb - rt) * (rr - rl)
    area_c = (cb - ct) * (cr - cl)
    union = area_r + area_c - inter + EPSILON
    return inter / union


def conflict_matrix(tlbr: torch.Tensor, group: torch.Tensor, iou_threshold: float,
                    kind: str = "greedy", beta: float = 0.6,
                    iou: torch.Tensor | None = None) -> torch.Tensor:
    """[B, K, K] bool ``conflict[b, j, i]``: candidate ``i`` overlaps the
    higher-ranked candidate ``j`` (``j < i``) of its group by more than
    ``iou_threshold``.

    ``kind="diou"`` subtracts the normalized centre distance raised to
    ``beta`` from the IoU (darknet box.c dia_box_diou).  The IoU is f32
    (``iou``, or :func:`pairwise_iou_reference`); the penalty is computed
    in the boxes' dtype, each operation rounded to it, the power in f32 with
    ``beta`` rounded to the boxes' dtype as a Python exponent of such a
    tensor is; the difference is taken in f32.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown nms kind {kind!r}")
    k = tlbr.shape[1]
    if iou is None:
        iou = pairwise_iou_reference(tlbr)
    if kind == "diou":
        cy = (tlbr[..., 0] + tlbr[..., 2]) / 2
        cx = (tlbr[..., 1] + tlbr[..., 3]) / 2
        dy = cy[:, :, None] - cy[:, None, :]
        dx = cx[:, :, None] - cx[:, None, :]
        dist = dy * dy + dx * dx
        eh = torch.maximum(tlbr[:, :, None, 2], tlbr[:, None, :, 2]) - \
            torch.minimum(tlbr[:, :, None, 0], tlbr[:, None, :, 0])
        ew = torch.maximum(tlbr[:, :, None, 3], tlbr[:, None, :, 3]) - \
            torch.minimum(tlbr[:, :, None, 1], tlbr[:, None, :, 1])
        diag = eh * eh + ew * ew + 1e-16
        ratio = dist / diag
        # a tensor exponent on the same device: powf on every element (a
        # Python one would take special cases for some values of beta)
        exponent = ratio.new_full((), beta).float()
        iou = iou - torch.pow(ratio.float(), exponent).to(ratio.dtype)
    same_group = group[:, :, None] == group[:, None, :]
    order = torch.arange(k, device=tlbr.device)
    lower = order[:, None] < order[None, :]  # j strictly higher-ranked than i
    return (iou > iou_threshold) & same_group & lower


def pack_bits(conflict: torch.Tensor) -> torch.Tensor:
    """[B, K, K] bool → [B, K, ceil(K/32)] int32, column 32w+t at bit t of
    word w; columns past K are 0."""
    b, k, _ = conflict.shape
    w = conflict_words(k)
    padded = torch.zeros((b, k, 32 * w), dtype=torch.int64, device=conflict.device)
    padded[..., :k] = conflict
    shifts = torch.arange(32, dtype=torch.int64, device=conflict.device)
    words = (padded.view(b, k, w, 32) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """[B, K, W] int32 → [B, K, K] bool (bit 31 is the sign bit: shift, then
    mask)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((bits[..., None] >> shifts) & 1).bool().flatten(-2)[..., :k]


def keep_from_conflict(conflict: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy NMS from the [B, K, K] conflict matrix by an exact Jacobi fixed
    point over all candidates of every image at once.

    Greedy NMS is the unique solution of the triangular recurrence
        keep[i] = valid[i] ∧ ∀ j<i: ¬(keep[j] ∧ conflict[j,i]).
    A fixed point of the map solves the recurrence; after t passes the first
    t candidates are final, so at most K passes are needed.  Convergence is
    read on the host once every ``CHECK_EVERY`` passes.
    """
    k = valid.shape[1]
    keep = valid
    for t in range(1, k + 1):
        new = valid & ~(conflict & keep[:, :, None]).any(dim=1)
        if t % CHECK_EVERY == 0 or t == k:
            if torch.equal(new, keep):
                break
        keep = new
    return keep


def nms_conflict_bits_reference(tlbr: torch.Tensor, group: torch.Tensor,
                                iou_threshold: float, kind: str = "greedy",
                                beta: float = 0.6) -> torch.Tensor:
    """Plain version of :func:`nms_conflict_bits`: the conflict matrix,
    packed."""
    return pack_bits(conflict_matrix(tlbr, group, iou_threshold, kind, beta))


def nms_keep_from_bits_reference(bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`nms_keep_from_bits`: unpack, then the Jacobi
    fixed point."""
    return keep_from_conflict(unpack_bits(bits, valid.shape[1]), valid)


# -- kernels ----------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "yolodl_iou_pairwise_f32": (_P, _P, _I, _I, _P),
    "yolodl_nms_conflict_bits": (_P, _I, _P, _P, _I, _I, _F, _I, _F, _P),
    "yolodl_nms_keep_from_bits": (_P, _P, _P, _I, _I, _P),
    "yolodl_powf_probe": (_P, _P, _I, _F, _P),
}


def entry(name: str):
    """The C entry point ``name`` of the IoU library, built first if
    needed; it returns a cudaError code."""
    from . import _build

    fn = getattr(_build.load("iou"), name)
    fn.argtypes = list(_SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _route(name: str, tensors, device) -> bool:
    """True for the kernel, False for the plain version: every tensor must
    lie where the caller asked for the work (``device``)."""
    device = torch.device(device)
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(f"{name}: tensor on {t.device}, caller asked for {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device.type == "cuda"


def _check_kernel_operands(name: str, tensors, k: int) -> None:
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: operands on different devices")
    if k * k >= 2**31:
        raise ValueError(f"{name}: K={k} exceeds the kernel's index range (K·K < 2³¹)")


def pairwise_iou(tlbr: torch.Tensor, device="cuda") -> torch.Tensor:
    """[B, K, 4] TLBR boxes → [B, K, K] f32 IoU matrices.

    ``device`` is where the caller expects the work to run, and must be the
    tensor's device.  The input is cast to f32 (as ``iou_pallas.py`` casts).
    A CUDA tensor goes to the kernel; a CPU tensor to
    :func:`pairwise_iou_reference`.
    """
    on_card = _route("pairwise_iou", [tlbr], device)
    if tlbr.dim() != 3 or tlbr.shape[-1] != 4:
        raise ValueError(f"expected [B, K, 4] boxes, got {tuple(tlbr.shape)}")
    if not on_card:
        return pairwise_iou_reference(tlbr)
    tlbr = tlbr.to(torch.float32)
    b, k, _ = tlbr.shape
    _check_kernel_operands("pairwise_iou", [tlbr], k)
    if b > 65535:
        raise ValueError(f"pairwise_iou: batch {b} exceeds the kernel's grid")
    out = torch.empty((b, k, k), dtype=torch.float32, device=tlbr.device)
    if b == 0 or k == 0:
        return out
    _check(entry("yolodl_iou_pairwise_f32")(tlbr.data_ptr(), out.data_ptr(), b, k,
                                            _stream(tlbr)), "iou")
    pairwise_iou.launches += 1
    return out


def nms_conflict_bits(tlbr: torch.Tensor, group: torch.Tensor, iou_threshold: float,
                      kind: str = "greedy", beta: float = 0.6, device="cuda") -> torch.Tensor:
    """[B, K, 4] TLBR boxes (f32 or bf16, score-ranked), [B, K] int64 groups
    → [B, K, ceil(K/32)] int32 conflict bits (see the module docstring).

    ``device`` must be the tensors' device: a CUDA tensor goes to the kernel,
    a CPU tensor to :func:`nms_conflict_bits_reference`.
    """
    on_card = _route("nms_conflict_bits", [tlbr, group], device)
    if kind not in KINDS:
        raise ValueError(f"unknown nms kind {kind!r}")
    if tlbr.dim() != 3 or tlbr.shape[-1] != 4 or tuple(group.shape) != tuple(tlbr.shape[:2]):
        raise ValueError(f"nms_conflict_bits: expected [B, K, 4] boxes and [B, K] groups, "
                         f"got {tuple(tlbr.shape)} and {tuple(group.shape)}")
    if tlbr.dtype not in BOX_DTYPES or group.dtype != torch.int64:
        raise ValueError(f"nms_conflict_bits: expected f32 or bf16 boxes and int64 groups, "
                         f"got {tlbr.dtype} and {group.dtype}")
    if not on_card:
        return nms_conflict_bits_reference(tlbr, group, iou_threshold, kind, beta)
    b, k, _ = tlbr.shape
    _check_kernel_operands("nms_conflict_bits", [tlbr, group], k)
    if b > 65535:
        raise ValueError(f"nms_conflict_bits: batch {b} exceeds the kernel's grid")
    bits = torch.empty((b, k, conflict_words(k)), dtype=torch.int32, device=tlbr.device)
    if b == 0 or k == 0:
        return bits
    # the exponent rounded to the boxes' dtype, as the plain version takes it
    exponent = float(torch.tensor(beta, dtype=tlbr.dtype))
    err = entry("yolodl_nms_conflict_bits")(
        tlbr.data_ptr(), int(tlbr.dtype == torch.bfloat16), group.data_ptr(), bits.data_ptr(),
        b, k, float(iou_threshold), int(kind == "diou"), exponent, _stream(tlbr))
    _check(err, "nms_conflict_bits")
    nms_conflict_bits.launches += 1
    return bits


def nms_keep_from_bits(bits: torch.Tensor, valid: torch.Tensor, device="cuda") -> torch.Tensor:
    """[B, K, ceil(K/32)] int32 conflict bits and [B, K] bool ``valid`` (rank
    order) → [B, K] bool ``keep`` of greedy NMS.

    ``device`` must be the tensors' device: a CUDA tensor goes to the kernel,
    a CPU tensor to :func:`nms_keep_from_bits_reference`.
    """
    on_card = _route("nms_keep_from_bits", [bits, valid], device)
    if valid.dim() != 2 or tuple(bits.shape) != (*valid.shape, conflict_words(valid.shape[1])):
        raise ValueError(f"nms_keep_from_bits: expected [B, K, ceil(K/32)] bits and [B, K] "
                         f"valid, got {tuple(bits.shape)} and {tuple(valid.shape)}")
    if bits.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"nms_keep_from_bits: expected int32 bits and bool valid, "
                         f"got {bits.dtype} and {valid.dtype}")
    if not on_card:
        return nms_keep_from_bits_reference(bits, valid)
    b, k = valid.shape
    _check_kernel_operands("nms_keep_from_bits", [bits, valid], k)
    keep = torch.empty((b, k), dtype=torch.bool, device=valid.device)
    if b == 0 or k == 0:
        return keep
    err = entry("yolodl_nms_keep_from_bits")(bits.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                             b, k, _stream(bits))
    _check(err, "nms_keep_from_bits")
    nms_keep_from_bits.launches += 1
    return keep


pairwise_iou.launches = 0
nms_conflict_bits.launches = 0
nms_keep_from_bits.launches = 0

"""The port's suppression kernels (yolodl_torch.kernels.iou
``nms_conflict_bits`` and ``nms_keep_from_bits``) against the JAX
reference, on the CPU.

On CPU tensors the wrappers take their plain versions: the conflict matrix
of ``yolodl_tpu/loss/nms.py`` (``_suppress``, its lines 86-101) packed into
32-bit words, and a Jacobi fixed point over the unpacked bits.  Here the
unpacked plain bits must equal the reference's boolean conflict matrix,
built on both of its IoU routes (``box_iou_pairwise`` and the Pallas tile in
interpret mode), and the plain keep mask must equal the reference's
``_suppress``; both exactly, in f32.  bf16 is held against the reference
only on pairs whose f32 score lies clear of the threshold: XLA may keep bf16
intermediates in f32.  The CUDA kernels are held against the plain versions
bit for bit on the card (chip_smoke.py, and tests/test_torch_nms_card.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.geometry.boxes import box_iou_pairwise as j_box_iou_pairwise
from yolodl_tpu.kernels import pairwise_iou_pallas
from yolodl_tpu.loss import nms as j_nms
from yolodl_torch.kernels import iou as t_iou
from yolodl_torch.loss import nms as t_nms

torch.set_num_threads(2)

THRESHOLD = 0.45
BETA = 0.6


def _clustered(rng, b, k, clusters=6):
    """[B, K, 4] TLBR f32 boxes around a few centres (deep suppression
    chains), with a zero-area box and an exact duplicate where K allows."""
    centres = rng.uniform(0.2, 0.8, (b, clusters, 2))
    pick = rng.integers(0, clusters, (b, k))
    cyx = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 0.05, (b, k, 2))
    hw = rng.uniform(0.05, 0.3, (b, k, 2))
    tlbr = np.concatenate([cyx - hw / 2, cyx + hw / 2], -1).astype(np.float32)
    if k >= 3:
        tlbr[:, 1, 2:] = tlbr[:, 1, :2]  # zero area
        tlbr[:, 2] = tlbr[:, 0]          # duplicate
    return tlbr


def _jax_conflict(tlbr, group, kind, iou_route):
    """yolodl_tpu/loss/nms.py:80-101 for one image: the boolean conflict
    matrix, conflict[j, i] for i suppressed by the higher-ranked j."""
    t = jnp.asarray(tlbr)
    k = t.shape[0]
    iou = pairwise_iou_pallas(t, interpret=True) if iou_route == "pallas" \
        else j_box_iou_pairwise(t, t)
    if kind == "diou":
        cy = (t[:, 0] + t[:, 2]) / 2
        cx = (t[:, 1] + t[:, 3]) / 2
        dist = (cy[:, None] - cy[None, :]) ** 2 + (cx[:, None] - cx[None, :]) ** 2
        enc_t = jnp.minimum(t[:, None, 0], t[None, :, 0])
        enc_l = jnp.minimum(t[:, None, 1], t[None, :, 1])
        enc_b = jnp.maximum(t[:, None, 2], t[None, :, 2])
        enc_r = jnp.maximum(t[:, None, 3], t[None, :, 3])
        diag = (enc_b - enc_t) ** 2 + (enc_r - enc_l) ** 2 + 1e-16
        iou = iou - (dist / diag) ** BETA
    g = jnp.asarray(group)
    order = jnp.arange(k)
    conflict = (iou > THRESHOLD) & (g[:, None] == g[None, :]) & (order[:, None] < order[None, :])
    return np.asarray(conflict), np.asarray(iou)


def _unpack(bits, k):
    """[B, K, W] int32 → [B, K, K] bool with numpy, independently of the port."""
    words = bits.numpy().astype(np.uint32)
    flat = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return flat.reshape(*words.shape[:2], -1)[..., :k].astype(bool)


@pytest.mark.parametrize("iou_route", ["xla", "pallas"])
@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("kind", ["greedy", "diou"])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 200])
def test_plain_bits_equal_jax_conflict(k, kind, groups, iou_route):
    rng = np.random.default_rng(k * 10 + groups)
    b = 2
    tlbr = _clustered(rng, b, k)
    group = rng.integers(0, groups, (b, k))
    bits = t_iou.nms_conflict_bits(torch.from_numpy(tlbr), torch.from_numpy(group), THRESHOLD,
                                   kind, BETA, device="cpu")
    assert bits.dtype == torch.int32 and bits.shape == (b, k, (k + 31) // 32)
    # the ragged last word is zero past K
    assert not _unpack(bits, 32 * bits.shape[-1])[..., k:].any()
    out = _unpack(bits, k)
    for i in range(b):
        ref, _ = _jax_conflict(tlbr[i], group[i], kind, iou_route)
        np.testing.assert_array_equal(out[i], ref)
    if k == 200:  # the case is not trivial
        assert 0 < out.sum() < k * (k - 1)


@pytest.mark.parametrize("kind", ["greedy", "diou"])
@pytest.mark.parametrize("k", [1, 33, 64, 65, 200])
def test_plain_keep_equals_jax_suppress(k, kind):
    rng = np.random.default_rng(k + 7)
    b = 2
    tlbr = _clustered(rng, b, k)
    group = rng.integers(0, 3, (b, k))
    valid = rng.uniform(size=(b, k)) < 0.85
    bits = t_iou.nms_conflict_bits_reference(torch.from_numpy(tlbr), torch.from_numpy(group),
                                             THRESHOLD, kind, BETA)
    keep = t_iou.nms_keep_from_bits(bits, torch.from_numpy(valid), device="cpu")
    assert keep.dtype == torch.bool and keep.shape == (b, k)
    for i in range(b):
        ref = j_nms._suppress(jnp.asarray(tlbr[i]), jnp.zeros(k), jnp.asarray(group[i]),
                              jnp.asarray(valid[i]), THRESHOLD, kind=kind, beta=BETA)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref))
    if k == 200:
        assert 0 < int(keep.sum()) < int(valid.sum())


@pytest.mark.parametrize("k", [40, 150])
def test_plain_keep_deep_chain_equals_jax(k):
    """Each box overlaps only its neighbour: greedy keeps every other box,
    a chain across the reference's blocks of 64."""
    t = np.arange(k, dtype=np.float32) * 0.5
    tlbr = np.stack([np.zeros(k), t, np.ones(k), t + 1.0], -1).astype(np.float32)
    group = np.zeros(k, np.int64)
    valid = np.ones(k, bool)
    bits = t_iou.nms_conflict_bits(torch.from_numpy(tlbr)[None], torch.from_numpy(group)[None],
                                   0.3, device="cpu")
    keep = t_iou.nms_keep_from_bits(bits, torch.from_numpy(valid)[None], device="cpu")[0]
    ref = j_nms._suppress(jnp.asarray(tlbr), jnp.zeros(k), jnp.asarray(group),
                          jnp.asarray(valid), 0.3)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(keep.numpy(), np.arange(k) % 2 == 0)


def test_bf16_plain_bits_equal_jax_clear_of_threshold():
    """bf16 boxes: the plain bits agree with the reference's bf16 formula on
    every pair whose f32 score lies more than 0.02 from the threshold."""
    rng = np.random.default_rng(11)
    k = 120
    tlbr = _clustered(rng, 1, k)
    bf16 = torch.from_numpy(tlbr).to(torch.bfloat16)
    exact = bf16.float().numpy()[0]  # the bf16 boxes' values
    group = np.zeros((1, k), np.int64)
    bits = t_iou.nms_conflict_bits(bf16, torch.from_numpy(group), THRESHOLD, "diou", BETA,
                                   device="cpu")
    ref, _ = _jax_conflict(jnp.asarray(exact, jnp.bfloat16), group[0], "diou", "xla")
    _, score = _jax_conflict(exact, group[0], "diou", "xla")
    clear = np.abs(score - THRESHOLD) > 0.02
    np.testing.assert_array_equal(_unpack(bits, k)[0][clear], ref[clear])
    assert clear.mean() > 0.9


@pytest.mark.parametrize("k", [1, 31, 32, 33, 65])
def test_pack_unpack_round_trip(k):
    rng = np.random.default_rng(k)
    conflict = torch.from_numpy(np.triu(rng.uniform(size=(2, k, k)) < 0.5, 1))
    conflict[:, 0, 31:] = k > 31  # bit 31 is the sign bit of word 0
    bits = t_iou.pack_bits(conflict)
    assert bits.shape == (2, k, (k + 31) // 32) and bits.dtype == torch.int32
    np.testing.assert_array_equal(_unpack(bits, k), conflict.numpy())
    assert torch.equal(t_iou.unpack_bits(bits, k), conflict)
    if k > 31:
        assert int(bits[0, 0, 0]) < 0


def test_bits_layout():
    """Bit t of word w in row j is the pair (j, 32w+t)."""
    k = 40
    tlbr = torch.zeros((1, k, 4))
    tlbr[..., 2:] = 1.0
    tlbr[0, :, 1] = torch.arange(k) * 10.0   # disjoint boxes along x ...
    tlbr[0, :, 3] = tlbr[0, :, 1] + 1.0
    tlbr[0, 35] = tlbr[0, 0]                 # ... but 35 and 31 repeat box 0
    tlbr[0, 31] = tlbr[0, 0]
    bits = t_iou.nms_conflict_bits(tlbr, torch.zeros((1, k), dtype=torch.long), 0.5,
                                   device="cpu")
    assert int(bits[0, 0, 0]) == -2**31 and int(bits[0, 0, 1]) == 1 << 3
    assert int(bits[0, 31, 1]) == 1 << 3  # 31 outranks 35
    assert int(bits.count_nonzero()) == 3


def test_suppress_is_the_two_plain_versions():
    rng = np.random.default_rng(3)
    tlbr = torch.from_numpy(_clustered(rng, 3, 90))
    group = torch.from_numpy(rng.integers(0, 2, (3, 90)))
    valid = torch.from_numpy(rng.uniform(size=(3, 90)) < 0.9)
    keep = t_nms._suppress(tlbr, group, valid, THRESHOLD, "diou", BETA)
    conflict = t_iou.conflict_matrix(tlbr, group, THRESHOLD, "diou", BETA)
    assert torch.equal(keep, t_iou.keep_from_conflict(conflict, valid))


def _good_args():
    tlbr = torch.from_numpy(_clustered(np.random.default_rng(0), 2, 40))
    group = torch.zeros((2, 40), dtype=torch.long)
    valid = torch.ones((2, 40), dtype=torch.bool)
    bits = t_iou.nms_conflict_bits(tlbr, group, THRESHOLD, device="cpu")
    return tlbr, group, valid, bits


@pytest.mark.parametrize("case", [
    "boxes f64", "boxes f16", "groups int32", "boxes [K,4]", "groups [B,K+1]",
    "boxes on cpu, caller asks cuda", "unknown kind",
])
def test_conflict_bits_rejects(case):
    tlbr, group, _, _ = _good_args()
    kw = dict(device="cpu")
    if case == "boxes f64":
        tlbr = tlbr.double()
    elif case == "boxes f16":
        tlbr = tlbr.half()
    elif case == "groups int32":
        group = group.int()
    elif case == "boxes [K,4]":
        tlbr = tlbr[0]
    elif case == "groups [B,K+1]":
        group = torch.zeros((2, 41), dtype=torch.long)
    elif case == "boxes on cpu, caller asks cuda":
        kw = {}
    elif case == "unknown kind":
        kw["kind"] = "soft"
    with pytest.raises(ValueError):
        t_iou.nms_conflict_bits(tlbr, group, THRESHOLD, **kw)


@pytest.mark.parametrize("case", [
    "bits int64", "valid uint8", "bits one word short", "valid [K]",
    "bits on cpu, caller asks cuda",
])
def test_keep_from_bits_rejects(case):
    _, _, valid, bits = _good_args()
    kw = dict(device="cpu")
    if case == "bits int64":
        bits = bits.long()
    elif case == "valid uint8":
        valid = valid.to(torch.uint8)
    elif case == "bits one word short":
        bits = bits[..., :1]
    elif case == "valid [K]":
        valid = valid[0]
    elif case == "bits on cpu, caller asks cuda":
        kw = {}
    with pytest.raises(ValueError):
        t_iou.nms_keep_from_bits(bits, valid, **kw)

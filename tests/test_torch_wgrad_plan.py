"""How the port's wgrad kernels cut a launch (yolodl_torch.kernels._util
wgrad_plan), checked on the CPU where the CUDA kernels cannot run.

(a) The plan at the flagship's 8 low-channel conv shapes (b8, bf16), at the
f32 reference shape and at ragged shapes: shared memory and registers within
what one block may use, chunks that cover every output position of every
image exactly once, warp tiles that cover the block's output, and each
operand read from device memory as often as PERF.md states.

(b) A plain-PyTorch emulation of the kernels' partition (the same chunks,
16-position MMA steps dealt to the same K-split groups, partials added in
the kernels' order, bf16 operands, f32 sums) against ``wgrad_reference``
within 1e-5 of max|dW| (f32 sums in another order over at most 768 terms)
and against the Pallas kernels in interpret mode within the 3e-6 of
tests/test_torch_wgrad.py, at that file's small shapes.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.kernels import wgrad_db as j_db
from yolodl_tpu.kernels import wgrad_pallas as j_lowch
from yolodl_torch.kernels import _build, _util
from yolodl_torch.kernels._util import wgrad_plan, wgrad_reference

torch.set_num_threads(2)

FLAGSHIP = [(8, h, h, ci, co, k) for h, ci, co, k in
            [(608, 3, 32, 3), (304, 64, 32, 1), (304, 32, 64, 3), (152, 128, 64, 1),
             (152, 64, 64, 1), (152, 64, 64, 3), (152, 128, 128, 1), (76, 256, 128, 1)]]
RAGGED = [(2, 37, 53, 3, 24, 3), (3, 19, 19, 40, 72, 1), (2, 8, 40, 130, 20, 1)]
BF16_CASES = [(kind, s) for kind in ("db", "lowch") for s in FLAGSHIP + RAGGED]
SMALL = [("lowch", 2, (16, 32, 64, 3)), ("lowch", 2, (16, 64, 32, 1)),   # test_torch_wgrad.py
         ("db", 3, (16, 32, 64, 3)), ("db", 3, (16, 64, 32, 1)), ("db", 3, (8, 16, 8, 3))]


def _chunks(plan):
    """(image, first column, columns, first row, rows) of every chunk, as
    wgrad_common.cuh make_block derives them from blockIdx.x."""
    out = []
    for chunk in range(plan["chunks"]):
        col, part = divmod(chunk, plan["chunks_per_col"])
        img, strip = divmod(col, plan["strips"])
        w0 = strip * plan["wt"]
        h0 = part * plan["rows_per_chunk"]
        out.append((img, w0, min(plan["wt"], plan["w"] - w0), h0,
                    min(plan["rows_per_chunk"], plan["h"] - h0)))
    return out


@pytest.mark.parametrize("kind,shape", BF16_CASES)
def test_bf16_plan_fits_the_block_and_covers_the_work(kind, shape):
    b, h, w, ci, co, k = shape
    p = wgrad_plan(kind, b, h, w, ci, co, k, torch.bfloat16, 132)
    # shared memory and registers of one block
    assert p["smem_bytes"] <= _util.SMEM_LIMIT == 232_448
    expanded = (k + 1) * p["ebuf_bytes"] if p["erow"] else 0
    ring = 2048 + p["stages"] * (p["x_bytes"] + p["g_bytes"]) + expanded
    assert ring <= p["smem_bytes"]
    assert p["warps"] in (8, 16) and p["threads"] == 32 * p["warps"]
    assert p["acc_regs"] <= _util.ACC_REGS_MAX[p["warps"]] <= p["regs_per_thread"] - 56
    assert p["threads"] * p["regs_per_thread"] <= 65_536 and p["regs_per_thread"] <= 255
    if p["wk"] > 1:  # the K-split's scratch
        assert 2048 + p["warps"] * p["acc_regs"] * 128 <= p["smem_bytes"]
    # the ring holds the rows in use (wgrad_db: the k of a tap window) and at
    # least two rows ahead
    assert (k + 2 if kind == "db" else 3) <= p["stages"] <= _util.STAGES_MAX
    assert p["wt"] % 16 == 0 and p["wt"] + k - 1 <= _util.TMA_BOX_MAX
    # the view keeps the positions (k = 1 may reshape them)
    assert p["b"] * p["h"] * p["w"] == b * h * w and (k == 1 or (p["b"], p["h"], p["w"]) == (b, h, w))
    # chunks cover every position of every image exactly once
    seen = np.zeros((p["b"], p["h"], p["w"]), np.int32)
    for img, w0, wv, h0, rows in _chunks(p):
        assert wv > 0 and rows > 0
        seen[img, h0:h0 + rows, w0:w0 + wv] += 1
    assert (seen == 1).all()
    assert p["slices"] == p["chunks"] and p["blocks"] == p["chunks"] * p["ci_splits"] * p["co_splits"]
    # the warps tile the block's output
    assert p["wm"] * p["wn"] * p["wtap"] * p["wk"] <= p["warps"]
    rows_out = p["ci_blk"] if kind == "db" else k * -(-k * p["ci_blk"] // 8) * 8
    assert p["wm"] * p["mt"] * 16 >= rows_out and p["wn"] * p["nt"] * 8 >= p["co_blk"]
    assert p["wtap"] * p["taps"] >= k * k
    assert p["ci_splits"] * p["ci_blk"] >= ci and p["co_splits"] * p["co_blk"] >= co
    if p["warps"] == 16:
        assert (p["mt"], p["nt"]) in (_util.DB_TILES if kind == "db" else _util.LOWCH_TILES)
    else:  # 8 warps of 255 registers: only where ldmatrix reads both operands
        assert (p["mt"], p["nt"]) == (_util.DB_TILE_8 if kind == "db" else _util.LOWCH_TILE_8)
        assert p["a_tma"] and p["b_tma"]
    # boxes: channel counts that TMA can stride over
    assert p["a_tma"] == int(ci % 8 == 0) and p["b_tma"] == int(co % 8 == 0)
    if p["a_tma"]:
        assert p["cbox"] in (8, 16, 32, 64) and ci % p["cbox"] == 0 and p["ci_blk"] % p["cbox"] == 0
    if kind == "lowch" and not (k == 1 and p["a_tma"]):
        # expanded rows: k shifted pixels a position, an odd number of 16-byte pieces
        assert p["kc_pad"] % 8 == 0 and 0 <= p["kc_pad"] - k * p["ci_blk"] < 8
        assert p["erow"] % 32 == 16 and p["erow"] >= 2 * p["kc_pad"]
        assert p["ebuf_bytes"] >= p["wt"] * p["erow"]
    else:
        assert p["erow"] == 0
    # what PERF.md states: each operand read from device memory once
    if shape in FLAGSHIP:
        assert (p["reads_xp"], p["reads_g"]) == (1, 1)
        assert p["chunks"] <= 132 and p["blocks"] >= 0.9 * 132


@pytest.mark.parametrize("kind", ["db", "lowch"])
def test_f32_plan_at_the_reference_shape(kind):
    p = wgrad_plan(kind, 8, 304, 304, 32, 64, 3, torch.float32, 132)
    assert p["dtype"] == "float32" and p["rows_per_chunk"] % _util.F32_ROWS_PER_SUBTILE == 0
    assert p["chunks"] == 8 * -(-304 // p["rows_per_chunk"]) == p["slices"] <= 65_535
    # the f32 kernels' tiles: wgrad_lowch takes 64 // 9 = 7 input channels, wgrad_db 16
    assert p["tiles"] == (5 if kind == "lowch" else 2) == p["reads_g"] and p["reads_xp"] == 1


def test_plan_splits_an_output_that_does_not_fit_and_rejects_what_it_cannot_take():
    p = wgrad_plan("db", 2, 20, 20, 64, 64, 5, torch.bfloat16, 132)
    assert p["wtap"] == 3 and p["co_splits"] == 4 and p["reads_xp"] == 4 and p["reads_g"] == 1
    with pytest.raises(ValueError, match="does not take k=7"):
        wgrad_plan("db", 2, 20, 20, 8, 8, 7)
    with pytest.raises(ValueError, match="does not take k=9"):
        wgrad_plan("lowch", 2, 20, 20, 8, 8, 9)
    with pytest.raises(ValueError, match="bad shape"):
        wgrad_plan("lowch", 2, 20, 20, 8, 8, 2)


def test_plan_fields_match_the_header():
    text = (_build.CSRC / "wgrad_common.cuh").read_text()
    body = re.search(r"enum PlanField \{(.*?)\};", text, re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "P_COUNT"
    assert tuple(n[2:].lower() for n in names[:-1]) == _util.PLAN_FIELDS


def _emulate(kind, xp, g, k, sms):
    """dW as the bf16 kernels sum it: per chunk and K-split group the MMA
    steps of 16 positions in order, the groups added in order inside the
    block, the chunks by reduce_slices_kernel's two levels."""
    b, h, w, co = g.shape
    ci = xp.shape[-1]
    p = wgrad_plan(kind, b, h, w, ci, co, k, torch.bfloat16, sms)
    xv = xp.float().reshape(p["b"], p["h"] + k - 1, p["w"] + k - 1, ci)
    gv = g.float().reshape(p["b"], p["h"], p["w"], co)
    slices = []
    for img, w0, wv, h0, rows in _chunks(p):
        groups = [torch.zeros((k * k * ci, co)) for _ in range(p["wk"])]
        for r in range(h0, h0 + rows):
            for ks in range(-(-wv // 16)):
                cols = slice(w0 + ks * 16, w0 + min(ks * 16 + 16, wv))
                a = torch.cat([xv[img, r + u, cols.start + v:cols.stop + v, :]
                               for u in range(k) for v in range(k)], dim=1)
                groups[ks % p["wk"]] += a.t() @ gv[img, r, cols, :]
        total = groups[0]
        for extra in groups[1:]:
            total = total + extra
        slices.append(total)
    lanes = [sum(slices[y + 32:len(slices):32], slices[y]) for y in range(min(32, len(slices)))]
    out = lanes[0]
    for lane in lanes[1:]:
        out = out + lane
    return out.reshape(k, k, ci, co), p


@pytest.mark.parametrize("sms", [132, 6])
@pytest.mark.parametrize("kind,batch,shape", SMALL)
def test_emulated_partition_matches_plain_and_pallas(kind, batch, shape, sms):
    hw, ci, co, k = shape
    rng = np.random.default_rng(hw * 100 + ci)
    pad = (k - 1) // 2
    # operands that bf16 holds exactly, so that both frameworks see the same values
    x = torch.from_numpy(rng.normal(size=(batch, hw, hw, ci)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(batch, hw, hw, co)).astype(np.float32)).bfloat16()
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    out, plan = _emulate(kind, xp, g, k, sms)
    if sms == 6:
        assert plan["rows_per_chunk"] > 1 or k == 1
    ref = wgrad_reference(xp, g, k)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale
    if sms == 132:
        j_fn = j_lowch.wgrad_lowch if kind == "lowch" else j_db.wgrad_db
        jref = np.asarray(j_fn(jnp.asarray(xp.float().numpy()), jnp.asarray(g.float().numpy()), k,
                               interpret=True))
        np.testing.assert_allclose(out.numpy() / scale, jref / scale, atol=3e-6)

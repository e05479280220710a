"""B1's CUDA kernels (yolodl_torch.kernels.iou) against their plain versions
on the card, bit for bit.  Marked ``cuda``: they skip without a card.

This file imports nothing of the JAX package, so it also runs where the
reference's optional dependencies are missing; the plain versions are held
against the reference on the CPU in tests/test_torch_nms_bits.py.
"""

import numpy as np
import pytest
import torch

from yolodl_torch.kernels import iou as t_iou

THRESHOLD = 0.45
BETA = 0.6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _clustered(rng, b, k):
    """[B, K, 4] TLBR f32 boxes around a few centres, with a zero-area box
    and exact duplicates where K allows."""
    centres = rng.uniform(0.2, 0.8, (b, 6, 2))
    pick = rng.integers(0, 6, (b, k))
    cyx = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 0.05, (b, k, 2))
    hw = rng.uniform(0.05, 0.3, (b, k, 2))
    tlbr = np.concatenate([cyx - hw / 2, cyx + hw / 2], -1).astype(np.float32)
    if k >= 3:
        tlbr[:, 1, 2:] = tlbr[:, 1, :2]
        tlbr[:, 2] = tlbr[:, 0]
    return tlbr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["greedy", "diou"])
def test_nms_kernels_match_plain_versions_on_card(dtype, kind):
    _card()
    rng = np.random.default_rng(5)
    # 1000 takes shared memory above 48 KB; 1500 reads the rows from device memory
    for k in (1, 33, 300, 512, 1000, 1500):
        tlbr = torch.from_numpy(_clustered(rng, 3, k)).to(dtype).cuda()
        group = torch.from_numpy(rng.integers(0, 4, (3, k))).cuda()
        valid = torch.from_numpy(rng.uniform(size=(3, k)) < 0.9).cuda()
        before = (t_iou.nms_conflict_bits.launches, t_iou.nms_keep_from_bits.launches)
        bits = t_iou.nms_conflict_bits(tlbr, group, THRESHOLD, kind, BETA)
        keep = t_iou.nms_keep_from_bits(bits, valid)
        torch.cuda.synchronize()
        assert (t_iou.nms_conflict_bits.launches, t_iou.nms_keep_from_bits.launches) \
            == (before[0] + 1, before[1] + 1)
        ref = t_iou.nms_conflict_bits_reference(tlbr, group, THRESHOLD, kind, BETA)
        assert torch.equal(bits, ref), k
        assert torch.equal(keep, t_iou.nms_keep_from_bits_reference(bits, valid)), k
        # two launches give the same bits
        assert torch.equal(bits, t_iou.nms_conflict_bits(tlbr, group, THRESHOLD, kind, BETA)), k
        assert torch.equal(keep, t_iou.nms_keep_from_bits(bits, valid)), k


@pytest.mark.cuda
def test_keep_kernel_resolves_a_chain_on_card():
    """Each box overlaps only its neighbour: greedy keeps every other box."""
    _card()
    k = 700
    t = torch.arange(k, dtype=torch.float32) * 0.5
    tlbr = torch.stack([torch.zeros(k), t, torch.ones(k), t + 1.0], -1)[None].cuda()
    bits = t_iou.nms_conflict_bits(tlbr, torch.zeros((1, k), dtype=torch.long).cuda(), 0.3)
    keep = t_iou.nms_keep_from_bits(bits, torch.ones((1, k), dtype=torch.bool).cuda())
    assert torch.equal(keep[0].cpu(), torch.arange(k) % 2 == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 510, 512])
def test_pairwise_iou_matches_plain_version_on_card(k):
    _card()
    tlbr = torch.from_numpy(_clustered(np.random.default_rng(k), 8, k)).cuda()
    before = t_iou.pairwise_iou.launches
    out = t_iou.pairwise_iou(tlbr)
    torch.cuda.synchronize()
    assert t_iou.pairwise_iou.launches == before + 1
    assert torch.equal(out, t_iou.pairwise_iou_reference(tlbr))

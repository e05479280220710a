"""``yolodl_torch.parallel.spatial``: the halo-exchange convolution over the
ranks of a space mesh, against ``yolodl_tpu.parallel.spatial`` under its
``shard_map`` on the virtual CPU devices of tests/conftest.py and against
the unsharded convolution.

The cases are the reference's own (tests/test_spatial.py:17-34): a 4 → 6
channel convolution at (k, s) in (3, 1), (3, 2), (1, 1), (5, 1) of a
seeded ``[2, 64, 32, 4]`` NHWC input (NCHW here), on 2 and on 4 ranks
joined over gloo (``SPATIAL_RANK_SCRIPT`` of tests/_torch_parity.py), at
the reference test's atol 1e-5.  The same ranks run the reference's
two-conv stack with mish (k3 s1, then k3 s2) and backpropagate a seeded
cotangent through it: the input's gradient and each kernel's, summed over
the ranks, against autograd of the unsharded stack, within 1e-5 ·
max|ref| of each (a kernel's gradient, up to ~22, sums 4,096 products a
rank and then the ranks' parts, in another order than the unsharded
conv: 4.6e-5 apart at most, 2.1e-6 of its max, measured on a CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import start_spatial_ranks, wait_ranks
from yolodl_tpu.parallel.spatial import make_spatial_forward as j_forward
from yolodl_tpu.parallel.spatial import spatial_conv2d as j_conv
from yolodl_torch import activations
from yolodl_torch.parallel import spatial

torch.set_num_threads(2)

KERNELS = [(3, 1), (3, 2), (1, 1), (5, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """One group of 2 ranks and one of 4 at once, while this process runs
    the reference under shard_map on meshes of 2 and 4 devices."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 64, 32)).astype(np.float32)
    arrays = {"x": x, **{f"w{k}": rng.normal(size=(6, 4, k, k)).astype(np.float32)
                         for k in (1, 3, 5)},
              "s1": (rng.normal(size=(8, 4, 3, 3)) * 0.1).astype(np.float32),
              "s2": (rng.normal(size=(5, 8, 3, 3)) * 0.1).astype(np.float32),
              "g": rng.normal(size=(2, 5, 32, 16)).astype(np.float32)}
    procs, outs = {}, {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"spatial{n}")
        procs[n], outs[n] = start_spatial_ranks(
            tmp, {"conv": {"mode": "conv", "kernels": KERNELS}}, arrays, n)
    refs = {}
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("space",))
        for k, s in KERNELS:
            w = jnp.asarray(arrays[f"w{k}"].transpose(2, 3, 1, 0))
            out = j_forward(lambda xl: j_conv(xl, w, (k - 1) // 2, s), mesh)(x_nhwc)
            refs[(n, k, s)] = np.asarray(out).transpose(0, 3, 1, 2)
    ranks = {}
    for n in (2, 4):
        wait_ranks(procs[n])
        ranks[n] = dict(np.load(f"{outs[n]}.r0.npz"))
    return arrays, refs, ranks


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,stride", KERNELS)
def test_spatial_conv_matches_reference_and_unsharded(runs, n, k, stride):
    arrays, refs, ranks = runs
    got = ranks[n][f"conv/k{k}s{stride}"]
    pad = (k - 1) // 2
    unsharded = F.conv2d(torch.from_numpy(arrays["x"]), torch.from_numpy(arrays[f"w{k}"]),
                         stride=stride, padding=pad).numpy()
    assert got.shape == unsharded.shape
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, refs[(n, k, stride)], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_conv_stack_gradients_match_the_unsharded_stack(runs, n):
    """The halo's backward returns each received row's gradient to the
    rank it came from: the input gradient of the sharded stack (each rank's
    rows, summed) and the kernels' gradients equal the unsharded stack's."""
    arrays, _, ranks = runs
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    w1, w2 = (torch.from_numpy(arrays[n_]).requires_grad_(True) for n_ in ("s1", "s2"))
    h = activations.apply("mish", F.conv2d(x, w1, padding=1))
    y = activations.apply("mish", F.conv2d(h, w2, stride=2, padding=1))
    (y * torch.from_numpy(arrays["g"])).sum().backward()
    rank = ranks[n]
    np.testing.assert_allclose(rank["conv/stack"], y.detach().numpy(), rtol=0, atol=1e-5)
    for name, t in (("x", x), ("s1", w1), ("s2", w2)):
        ref = t.grad.numpy()
        assert np.abs(ref).max() > 0.1, name
        np.testing.assert_allclose(rank[f"conv/grad/{name}"], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_rejects_valid_padding():
    """tests/test_spatial.py:57-62: a 3×3 kernel at padding 0 is refused."""
    w = torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="same-padding"):
        spatial.spatial_conv2d(torch.zeros(1, 2, 64, 8), w, 0, 1)


def test_one_shard_pads_with_the_fill():
    """On one shard (no axis) the halo is the global edge: ``fill`` rows,
    0 for a convolution and -inf for a max pool."""
    x = torch.arange(12.0).view(1, 1, 3, 4)
    for fill in (0.0, float("-inf")):
        out = spatial.halo_exchange(x, 2, None, fill)
        assert out.shape == (1, 1, 7, 4)
        assert torch.equal(out[:, :, 2:5], x)
        assert (out[:, :, :2] == fill).all() and (out[:, :, 5:] == fill).all()
    y = spatial.spatial_conv2d(x, torch.ones(1, 1, 3, 3), 1)
    assert torch.equal(y, F.conv2d(x, torch.ones(1, 1, 3, 3), padding=1))

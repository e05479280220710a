"""yolodl_torch/utils/tensor_ext.py against yolodl_tpu/utils/tensor_ext.py on
the same seeded inputs, and the port's own copy of units.py (its
arithmetic, conversions, hashing and refusals beside the reference's).

Tolerance: exact for the index functions (crop, cartesian product, the
checks); rtol 1e-6 for softmax and the sums; resize2d_exact as
tests/test_torch_train_cli.py holds the port's resize against
``jax.image.resize``: rtol 1e-5, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_torch import units as t_units
from yolodl_torch.utils import tensor_ext as t_ext
from yolodl_tpu import units as j_units
from yolodl_tpu.utils import tensor_ext as j_ext

torch.set_num_threads(2)


def seeded(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("ratios", [(0.25, 0.75, 0.0, 0.5), (0.0, 1.0, 0.1, 0.9),
                                    (0.3, 0.4, 0.6, 1.0)])
def test_crop_by_ratio(ratios):
    x = seeded((2, 3, 10, 7))
    np.testing.assert_array_equal(t_ext.crop_by_ratio(torch.from_numpy(x), *ratios).numpy(),
                                  np.asarray(j_ext.crop_by_ratio(jnp.asarray(x), *ratios)))


@pytest.mark.parametrize("ratios", [(0.5, 0.5, 0.0, 1.0), (0.0, 1.0, -0.1, 0.5),
                                    (0.2, 1.2, 0.0, 1.0)])
def test_crop_by_ratio_refuses_bad_bounds(ratios):
    x = np.zeros((4, 4), np.float32)
    for crop, arr in ((t_ext.crop_by_ratio, torch.from_numpy(x)),
                      (j_ext.crop_by_ratio, jnp.asarray(x))):
        with pytest.raises(ValueError, match="invalid crop ratios"):
            crop(arr, *ratios)


@pytest.mark.parametrize("shape,out_hw", [((3, 4, 4), (8, 8)), ((2, 3, 17, 11), (6, 13)),
                                          ((9, 5), (9, 20)), ((1, 2, 32, 24), (13, 7))])
def test_resize2d_exact(shape, out_hw):
    x = np.random.default_rng(len(shape)).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(j_ext.resize2d_exact(jnp.asarray(x), *out_hw))
    out = t_ext.resize2d_exact(torch.from_numpy(x), *out_hw).numpy()
    assert out.shape == ref.shape == shape[:-2] + out_hw
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("groups,axis", [(2, -1), (3, 1), (1, 0)])
def test_multi_softmax(groups, axis):
    x = seeded((6, 12, 6), groups)
    np.testing.assert_allclose(t_ext.multi_softmax(torch.from_numpy(x), groups, axis).numpy(),
                               np.asarray(j_ext.multi_softmax(jnp.asarray(x), groups, axis)),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        t_ext.multi_softmax(torch.from_numpy(x), 5, 1)


def test_cartesian_product_nd():
    a, b, c = np.array([0, 1]), np.array([5, 6, 7]), np.array([-1, 2])
    ref = np.asarray(j_ext.cartesian_product_nd(*map(jnp.asarray, (a, b, c))))
    out = t_ext.cartesian_product_nd(*map(torch.from_numpy, (a, b, c))).numpy()
    assert out.shape == (12, 3)
    np.testing.assert_array_equal(out, ref)


def test_sum_and_weighted_mean():
    xs = [seeded((3, 4), s) for s in range(3)]
    ws = [1.0, 3.0, 0.5]
    np.testing.assert_allclose(t_ext.sum_tensors([torch.from_numpy(x) for x in xs]).numpy(),
                               np.asarray(j_ext.sum_tensors([jnp.asarray(x) for x in xs])),
                               rtol=1e-6)
    np.testing.assert_allclose(
        t_ext.weighted_mean_tensors([(torch.from_numpy(x), w) for x, w in zip(xs, ws)]).numpy(),
        np.asarray(j_ext.weighted_mean_tensors([(jnp.asarray(x), w) for x, w in zip(xs, ws)])),
        rtol=1e-6)
    for fn, arg in ((t_ext.sum_tensors, []), (t_ext.weighted_mean_tensors, []),
                    (t_ext.weighted_mean_tensors, [(torch.ones(2), 0.0)])):
        with pytest.raises(ValueError):
            fn(arg)


def test_nan_and_finite_checks():
    x = seeded((3, 4))
    bad = x.copy()
    bad[1, 2] = np.nan
    inf = x * np.float32(np.inf)
    for arr in (x, bad, inf):
        assert bool(t_ext.has_nan(torch.from_numpy(arr))) == bool(j_ext.has_nan(jnp.asarray(arr)))
    for tree in ({"a": x}, {"a": x, "b": [x, (bad,)]}, {"a": inf}, [], {"a": None, "b": x}):
        t_tree = _map(tree, torch.from_numpy)
        j_tree = _map(tree, jnp.asarray)
        assert bool(t_ext.all_finite(t_tree)) == bool(j_ext.all_finite(j_tree))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return None if tree is None else fn(tree)


@pytest.mark.parametrize("mod", [t_units, j_units], ids=["port", "reference"])
def test_units_arithmetic_and_refusals(mod):
    Pixel, Ratio = mod.Pixel, mod.Ratio
    a = Pixel(10.0)
    assert (a + Pixel(5.0)).value == 15.0 and (a + 1.0).value == 11.0
    assert (a - 4.0).value == 6.0 and (4.0 - a).value == -6.0
    assert (a * 2).value == 20.0 and (2 * a).value == 20.0
    assert (a / 4).value == 2.5 and (5 / a).value == 0.5
    assert (-a).value == -10.0
    assert a.to_ratio(100.0) == Ratio(0.1)
    assert Ratio(0.25).to_pixel(80.0) == Pixel(20.0)
    assert a.map(lambda v: v + 1) == Pixel(11.0)
    assert a != Ratio(10.0)
    assert len({Pixel(1.0), Pixel(1.0), Ratio(1.0)}) == 2
    arr = Pixel(np.array([1.0, 2.0]))
    assert arr == Pixel(np.array([1.0, 2.0])) and hash(arr) == hash(Pixel(np.array([1.0, 2.0])))
    assert repr(Ratio(0.5)) == "Ratio(0.5)"
    for op in (lambda: Pixel(1.0) + Ratio(1.0), lambda: Ratio(1.0) * Pixel(2.0),
               lambda: Pixel(1.0) - Ratio(1.0), lambda: Ratio(1.0) / Pixel(1.0)):
        with pytest.raises(TypeError, match="cannot mix"):
            op()


def test_units_copy_is_the_references():
    """The port keeps its own copy: the same classes and methods, none of
    them the reference's objects."""
    for name in ("Pixel", "Ratio"):
        t_cls, j_cls = getattr(t_units, name), getattr(j_units, name)
        assert t_cls is not j_cls and t_cls.UNIT == j_cls.UNIT
        assert sorted(vars(t_cls)) == sorted(vars(j_cls))
    assert sorted(n for n in vars(t_units._UnitWrapper) if not n.startswith("__doc")) == \
        sorted(n for n in vars(j_units._UnitWrapper) if not n.startswith("__doc"))

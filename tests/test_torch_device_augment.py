"""The ops of the port's device augmentation
(``yolodl_torch/data/device_augment.py``) against the JAX reference
(``yolodl_tpu/data/device_augment.py``): the three warps, the jitter, the
bands and the pack.  The deferred stream: test_torch_device_augment_stream.py;
the whole augment program: test_torch_device_augment_program.py.

Every kernel case of ``tests/test_device_augment.py`` has its counterpart
here with that test's own bounds.  The ops run batched over two images (the
reference test's input and a second one with other parameters) against the
reference's per-image ops, run op by op (the two-pass warp jitted: eager,
its first call at each shape takes seconds):

- warps and jitter, port against reference: mean |Δ| ≤ 1e-5 and at most
  0.2 % of pixels with |Δ| > 1e-3 (a border or hue-sextant flip is one ulp
  of a coordinate away); then the reference test's own checks on the port;
- ``twopass_bands`` equal; ``pack_deferred_batch`` identical, u8 and f32.
"""

import jax
import numpy as np
import pytest
import torch

from yolodl_tpu.data import device_augment as j_da
from yolodl_torch.data import device_augment as t_da
from yolodl_torch.data.affine import RandomAffine, pixel_affine, warp_image
from yolodl_torch.data.color import ColorJitter

torch.set_num_threads(2)


def assert_close_to_reference(out, ref):
    """The bound of every warp and jitter comparison, port against reference."""
    diff = np.abs(out - ref)
    assert np.mean(diff) <= 1e-5, np.mean(diff)
    assert np.mean(diff > 1e-3) <= 0.002, np.mean(diff > 1e-3)


def reference_warp(fn, img, m, b, *extra):
    import jax.numpy as jnp

    return np.stack([np.asarray(fn(jnp.asarray(img[i]), jnp.asarray(m[i]), jnp.asarray(b[i]),
                                   *extra)) for i in range(len(img))])


def port_warp(fn, img, m, b, *extra):
    return fn(torch.from_numpy(img), torch.from_numpy(m), torch.from_numpy(b), *extra).numpy()


def batch_of_two(img, aff, rng, second_seed):
    """The reference test's image and transform, then a second image with
    its own transform: [2,3,H,W] images, [2,2,2] m, [2,2] b (f32)."""
    _, h, w = img.shape
    t = aff.sample_transform(rng)
    rng2 = np.random.default_rng(second_seed)
    img2 = rng2.random(img.shape).astype(np.float32)
    t2 = aff.sample_transform(rng2)
    ms, bs = zip(*(pixel_affine(x, h, w) for x in (t, t2)))
    return (np.stack([img, img2]), np.stack(ms).astype(np.float32),
            np.stack(bs).astype(np.float32), t)


class TestWarps:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_general_warp_matches_reference_and_host(self, seed):
        rng = np.random.default_rng(seed)
        img = rng.random((3, 33, 47)).astype(np.float32)
        aff = RandomAffine(rotate_prob=1.0, rotate_degrees=30.0,
                           translation_prob=1.0, translation=0.1,
                           scale_prob=1.0, scale=(0.8, 1.2),
                           horizontal_flip_prob=0.5)
        imgs, m, b, t = batch_of_two(img, aff, rng, 100 + seed)
        out = port_warp(t_da._warp_general, imgs, m, b)
        assert_close_to_reference(out, reference_warp(j_da._warp_general_jnp, imgs, m, b))
        m64, b64 = pixel_affine(t, 33, 47)
        host = warp_image(img, m64, b64)
        assert np.mean(np.abs(out[0] - host)) < 1e-4
        assert np.mean(np.abs(out[0] - host) > 1e-2) < 0.005

    @pytest.mark.parametrize("seed", [0, 1])
    def test_separable_warp_matches_reference_and_host(self, seed):
        rng = np.random.default_rng(seed)
        img = rng.random((3, 32, 48)).astype(np.float32)
        aff = RandomAffine(translation_prob=1.0, translation=0.15,
                           scale_prob=1.0, scale=(0.7, 1.3),
                           horizontal_flip_prob=0.5, vertical_flip_prob=0.5)
        imgs, m, b, t = batch_of_two(img, aff, rng, 100 + seed)
        assert np.all(m[:, 0, 1] == 0) and np.all(m[:, 1, 0] == 0)  # diagonal
        out = port_warp(t_da._warp_separable, imgs, m, b)
        assert_close_to_reference(out, reference_warp(j_da._warp_separable_jnp, imgs, m, b))
        m64, b64 = pixel_affine(t, 32, 48)
        assert np.mean(np.abs(out[0] - warp_image(img, m64, b64))) < 1e-4
        np.testing.assert_allclose(out, port_warp(t_da._warp_general, imgs, m, b), atol=1e-5)

    @pytest.mark.parametrize("warp", ["general", "separable", "twopass"])
    def test_identity_warp_is_exact(self, warp):
        img = np.random.default_rng(0).random((2, 3, 19, 23)).astype(np.float32)
        m = np.tile(np.eye(2, dtype=np.float32), (2, 1, 1))
        b = np.zeros((2, 2), np.float32)
        extra = (3, 3) if warp == "twopass" else ()
        out = port_warp(getattr(t_da, f"_warp_{warp}"), img, m, b, *extra)
        np.testing.assert_array_equal(out, img)


# -- the two-pass warp

TWOPASS_REFERENCE = jax.jit(j_da._warp_twopass_jnp, static_argnums=(3, 4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twopass_matches_reference_and_general_on_smooth(seed):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.random((3, 64, 80)).astype(np.float32), (0, 2, 2))
    aff = RandomAffine(rotate_prob=1.0, rotate_degrees=25.0,
                       translation_prob=1.0, translation=0.1,
                       scale_prob=1.0, scale=(0.8, 1.2),
                       horizontal_flip_prob=0.5, vertical_flip_prob=0.5)
    imgs, m, b, _ = batch_of_two(img, aff, rng, 100 + seed)
    imgs[1] = ndimage.gaussian_filter(imgs[1], (0, 2, 2))
    d1, d2 = t_da.twopass_bands(25.0, 0.8)
    two = port_warp(t_da._warp_twopass, imgs, m, b, d1, d2)
    assert_close_to_reference(two, reference_warp(TWOPASS_REFERENCE, imgs, m, b, d1, d2))
    gen = port_warp(t_da._warp_general, imgs, m, b)
    np.testing.assert_array_equal(gen == 0.0, two == 0.0)  # border mask
    assert np.abs(gen - two).max() < 0.01
    assert np.abs(gen - two).mean() < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twopass_nonsquare_aspect_bands_cover(seed):
    """48x96 (aspect 2) at 40°: the aspect-widened bands cover every
    tap (wider bands change nothing), the square ones do not."""
    from scipy import ndimage

    h, w = 48, 96
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.random((3, h, w)).astype(np.float32), (0, 2, 2))
    aff = RandomAffine(rotate_prob=1.0, rotate_degrees=40.0,
                       scale_prob=1.0, scale=(0.8, 1.2))
    imgs, m, b, _ = batch_of_two(img, aff, rng, 100 + seed)
    imgs[1] = ndimage.gaussian_filter(imgs[1], (0, 2, 2))
    d1, d2 = t_da.twopass_bands(40.0, 0.8, aspect=max(h / w, w / h))
    two = port_warp(t_da._warp_twopass, imgs, m, b, d1, d2)
    assert_close_to_reference(two, reference_warp(TWOPASS_REFERENCE, imgs, m, b, d1, d2))
    gen = port_warp(t_da._warp_general, imgs, m, b)
    np.testing.assert_array_equal(gen == 0.0, two == 0.0)
    big = port_warp(t_da._warp_twopass, imgs, m, b, d1 + 20, d2 + 20)
    np.testing.assert_array_equal(two, big)
    assert np.abs(gen - two).max() < 0.02
    assert np.abs(gen - two).mean() < 2e-3
    d1s, d2s = t_da.twopass_bands(40.0, 0.8)
    assert (d1, d2) != (d1s, d2s)
    short = port_warp(t_da._warp_twopass, imgs, m, b, d1s, d2s)
    assert np.abs(short - big).max() > 0.02  # square bands under-cover


@pytest.mark.parametrize("seed", [0, 1])
def test_twopass_exact_without_rotation(seed):
    rng = np.random.default_rng(seed)
    img = rng.random((3, 33, 47)).astype(np.float32)
    aff = RandomAffine(translation_prob=1.0, translation=0.15,
                       scale_prob=1.0, scale=(0.7, 1.3),
                       horizontal_flip_prob=0.5, vertical_flip_prob=0.5)
    imgs, m, b, _ = batch_of_two(img, aff, rng, 100 + seed)
    two = port_warp(t_da._warp_twopass, imgs, m, b, 3, 3)
    assert_close_to_reference(two, reference_warp(TWOPASS_REFERENCE, imgs, m, b, 3, 3))
    np.testing.assert_allclose(two, port_warp(t_da._warp_general, imgs, m, b), atol=1e-6)


@pytest.mark.parametrize("shift", [(0.1, 0.2, -0.15), (-0.3, 0.0, 0.4)])
def test_jitter_matches_reference_and_host(shift):
    import jax.numpy as jnp

    img = np.random.default_rng(7).random((3, 24, 31)).astype(np.float32)
    imgs = np.stack([img, np.random.default_rng(8).random((3, 24, 31)).astype(np.float32)])
    shifts = np.array([shift, (-shift[0] / 2, 0.3, 0.05)], np.float32)
    out = t_da._hsv_jitter(torch.from_numpy(imgs), *torch.from_numpy(shifts).T).numpy()
    ref = np.stack([np.asarray(j_da._hsv_jitter_jnp(jnp.asarray(imgs[i]), *shifts[i]))
                    for i in range(2)])
    assert_close_to_reference(out, ref)
    host = ColorJitter(hue_shift=0.5, saturation_shift=0.5, value_shift=0.5).apply(img, *shift)
    assert np.mean(np.abs(out[0] - host)) < 1e-5
    assert np.mean(np.abs(out[0] - host) > 1e-3) < 0.002


@pytest.mark.parametrize("rotate,scale_min,aspect", [
    (0.0, 1.0, 1.0), (3.0, 0.9, 1.0), (10.0, 0.8, 1.0), (25.0, 0.8, 1.0),
    (40.0, 0.8, 2.0), (15.0, 1.5, 1.25), (59.0, 0.5, 1.0)])
def test_twopass_bands_equal(rotate, scale_min, aspect):
    assert t_da.twopass_bands(rotate, scale_min, aspect=aspect) == \
        j_da.twopass_bands(rotate, scale_min, aspect=aspect)
    assert t_da.twopass_bands(rotate, scale_min, block=4, aspect=aspect) == \
        j_da.twopass_bands(rotate, scale_min, block=4, aspect=aspect)


@pytest.mark.parametrize("uint8", [True, False])
def test_pack_deferred_batch_identical(uint8):
    """Every mix kind, jitter on some records, identity and real transforms,
    and source values at and beyond [0, 1] (the u8 clip)."""
    rng = np.random.default_rng(4)
    aff = RandomAffine(rotate_prob=1.0, rotate_degrees=20.0, translation_prob=1.0,
                       translation=0.1, horizontal_flip_prob=0.5)
    kinds = [(t_da.MIX_MOSAIC, (0.37, 0.61)), (t_da.MIX_MIXUP, (0.3,)),
             (t_da.MIX_CUTMIX, (0.1, 0.55, 0.2, 0.9)), (t_da.MIX_NONE, ())]
    t_recs, j_recs = [], []
    for i, (kind, params) in enumerate(kinds):
        need = {t_da.MIX_MOSAIC: 4, t_da.MIX_MIXUP: 2, t_da.MIX_CUTMIX: 2}.get(kind, 1)
        images = [rng.uniform(-0.1, 1.1, (3, 13, 17)).astype(np.float32) for _ in range(need)]
        jit = [tuple(rng.uniform(-0.2, 0.2, 3)) for _ in range(need)] if i % 2 == 0 else None
        transforms = [aff.sample_transform(rng) if k % 2 else None for k in range(need)]
        boxes = rng.uniform(0.2, 0.8, (i + 1, 4)).astype(np.float32)
        classes = np.arange(i + 1, dtype=np.int32)
        t_recs.append(t_da.DeferredRecord(images, jit, transforms, kind, params, boxes, classes))
        j_recs.append(j_da.DeferredRecord(images, jit, transforms, kind, params, boxes, classes))
    out = t_da.pack_deferred_batch(t_recs, 4, uint8=uint8)
    ref = j_da.pack_deferred_batch(j_recs, 4, uint8=uint8)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert out["images"].dtype == (np.uint8 if uint8 else np.float32)

"""The port's host augmentation library (``csrc/host_augment.cpp`` through
``data/native_loader.py``) against the reference's ``native/loader.cpp``,
built from the checkout into a temp dir, bit for bit; and against the
port's plain numpy/scipy versions at the reference's tolerances (warp
1e-5, jitter 3e-5), with the warp's border ties excluded and counted."""

import threading

import numpy as np
import pytest
from scipy import ndimage

from _torch_parity import plain_route, reference_native  # noqa: F401
from chip_smoke import border_ties
from yolodl_torch.data import affine as t_affine
from yolodl_torch.data import color as t_color
from yolodl_torch.data import native_loader as t_native


def transform(kind):
    """A 3x3 ±1-frame transform of RandomAffine's kind."""
    c, s = np.cos(np.deg2rad(10.0)), np.sin(np.deg2rad(10.0))
    return {
        "identity": np.eye(3),
        "flip": np.diag([-1.0, 1.0, 1.0]),
        "vflip": np.diag([1.0, -1.0, 1.0]),
        "rotation": np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]),
        "scale": np.diag([1.2, 1.2, 1.0]),
        "shrink": np.diag([0.8, 0.8, 1.0]),
        "out_of_frame": np.array([[1.0, 0.0, 2.5], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
    }[kind]


# (name, shape, m_rc, b_rc); the pixel maps come from pixel_affine as the
# pipeline makes them, or straight from a seed
WARP_CASES = (
    [(kind, (3, 32, 32), *t_affine.pixel_affine(transform(kind), 32, 32))
     for kind in ("identity", "flip", "vflip", "rotation", "scale", "shrink", "out_of_frame")]
    + [(f"odd_{h}x{w}", (3, h, w), *t_affine.pixel_affine(transform("rotation"), h, w))
       for h, w in ((33, 47), (1, 9), (17, 1))]
    + [(f"seeded_{i}", (3, 48, 40),
        np.eye(2) + np.random.default_rng(i).normal(0, 0.15, (2, 2)),
        np.random.default_rng(100 + i).normal(0, 4, 2)) for i in range(4)]
    + [("ties_608", (3, 608, 608), np.array([[1.05, 0.1], [-0.08, 0.97]]),
        np.array([5.0, -7.0]))]
)


def image(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def scipy_warp(img, m_rc, b_rc):
    return np.stack([ndimage.affine_transform(img[c], m_rc, offset=b_rc, order=1,
                                              mode="constant", cval=0.0)
                     for c in range(img.shape[0])]).astype(np.float32)


@pytest.mark.parametrize("name,shape,m_rc,b_rc", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_warp_bit_identical_to_reference(reference_native, name, shape, m_rc, b_rc):
    img = image(shape)
    out = t_native.affine_warp_native(img, m_rc, b_rc)
    ref = reference_native.affine_warp_native(img, m_rc, b_rc)
    assert out.dtype == ref.dtype == np.float32 and out.shape == shape
    np.testing.assert_array_equal(out, ref)
    if name == "out_of_frame":
        assert not out.any()
    if name == "identity":
        np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("name,shape,m_rc,b_rc", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_native_warp_matches_plain_but_border_ties(name, shape, m_rc, b_rc):
    """warp_image's default route against its scipy plain version: every
    value within 1e-5 but at border ties, which are counted; the 608²
    case lands on ties."""
    img = image(shape)
    out = t_affine.warp_image(img, m_rc, b_rc)
    ref = scipy_warp(img, m_rc, b_rc)
    ties = np.broadcast_to(border_ties(m_rc, b_rc, *shape[1:]), shape)
    far = np.abs(out - ref) > 1e-5
    np.testing.assert_allclose(out[~ties], ref[~ties], atol=1e-5)
    assert far.sum() <= ties.sum()
    if name == "ties_608":
        assert ties.any()


def test_warp_plain_route_is_scipy(plain_route):
    name, shape, m_rc, b_rc = WARP_CASES[3]
    img = image(shape)
    assert t_native.affine_warp_native(img, m_rc, b_rc) is None
    np.testing.assert_array_equal(t_affine.warp_image(img, m_rc, b_rc),
                                  scipy_warp(img, m_rc, b_rc))


def jitter_image(kind):
    """[3, 16, 16] pixels of one corner of the HSV conversion."""
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    if kind == "grey":  # delta 0: hue and saturation 0
        return np.repeat(rng.uniform(0, 1, (1, 16, 16)), 3, 0).astype(np.float32)
    if kind == "tie_rg":  # r == g > b: the max resolves to r
        rg = rng.uniform(0.5, 1, (16, 16))
        return np.stack([rg, rg, rg * rng.uniform(0, 1, (16, 16))]).astype(np.float32)
    if kind == "tie_gb":  # g == b > r: the max resolves to g
        gb = rng.uniform(0.5, 1, (16, 16))
        return np.stack([gb * rng.uniform(0, 1, (16, 16)), gb, gb]).astype(np.float32)
    if kind == "red_hues":  # hue near 0 and 1, where the shift wraps
        r = rng.uniform(0.6, 1, (16, 16))
        g, b = r * rng.uniform(0, 0.1, (2, 16, 16))
        return np.stack([r, np.where(rng.random((16, 16)) < 0.5, g, b), b]).astype(np.float32)
    if kind == "extremes":  # 0 and 1 exactly, clamps in both directions
        return rng.choice([0.0, 1.0, 0.5], (3, 16, 16)).astype(np.float32)
    raise ValueError(kind)


JITTER_KINDS = ("random", "grey", "tie_rg", "tie_gb", "red_hues", "extremes")
JITTER_SHIFTS = [(0.03, -0.1, 0.08), (0.0, 0.0, 0.0), (-0.4, 0.5, -0.5), (0.49, 1.5, 1.5),
                 (-0.49, -1.5, -1.5), (0.1, 0.2, 0.2)]


@pytest.mark.parametrize("kind", JITTER_KINDS)
def test_jitter_bit_identical_to_reference(reference_native, kind):
    img = jitter_image(kind)
    for hs, ss, vs in JITTER_SHIFTS:
        out = t_native.color_jitter_native(img, hs, ss, vs)
        np.testing.assert_array_equal(
            out, reference_native.color_jitter_native(img, hs, ss, vs),
            err_msg=str((kind, hs, ss, vs)))
    assert not np.shares_memory(out, img)


@pytest.mark.parametrize("kind", JITTER_KINDS)
def test_native_jitter_matches_plain(monkeypatch, kind):
    img = jitter_image(kind)
    jitter = t_color.ColorJitter(0.5, 0.5, 0.5)
    for hs, ss, vs in JITTER_SHIFTS:
        out = jitter.apply(img, hs, ss, vs)
        monkeypatch.setattr(t_native, "_aug_lib_cache", False)
        ref = jitter.apply(img, hs, ss, vs)
        monkeypatch.undo()
        np.testing.assert_allclose(out, ref, atol=3e-5, err_msg=str((kind, hs, ss, vs)))


# -- the reference's own TestNativeAugmentation (tests/test_data.py:898-958),
# run on both packages' libraries


@pytest.fixture(params=["port", "reference"])
def native(request):
    if request.param == "port":
        return t_native
    return request.getfixturevalue("reference_native")


def test_affine_warp_matches_scipy(native):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (3, 48, 40)).astype(np.float32)
    for _ in range(4):
        m_rc = np.eye(2) + rng.normal(0, 0.15, (2, 2))
        b_rc = rng.normal(0, 4, 2)
        np.testing.assert_allclose(native.affine_warp_native(img, m_rc, b_rc),
                                   scipy_warp(img, m_rc, b_rc), atol=1e-5)


def test_color_jitter_matches_numpy(native):
    img = np.random.default_rng(0).uniform(0, 1, (3, 33, 47)).astype(np.float32)
    for hs, ss, vs in [(0.03, -0.1, 0.08), (0.0, 0.0, 0.0), (-0.4, 0.5, -0.5)]:
        hsv = t_color.rgb_to_hsv(img)
        hsv[0] = (hsv[0] + hs + 1.0) % 1.0
        hsv[1] = np.clip(hsv[1] + ss, 0.0, 1.0)
        hsv[2] = np.clip(hsv[2] + vs, 0.0, 1.0)
        np.testing.assert_allclose(native.color_jitter_native(img, hs, ss, vs),
                                   t_color.hsv_to_rgb(hsv), atol=3e-5)


def test_jitter_dispatch_identical_stream(monkeypatch):
    """ColorJitter.__call__ gives the same result through the native and the
    numpy routes from the same RNG state."""
    img = np.random.default_rng(0).uniform(0, 1, (3, 24, 24)).astype(np.float32)
    jitter = t_color.ColorJitter(0.05, 0.2, 0.2)
    a = jitter(img, np.random.default_rng(7))
    monkeypatch.setattr(t_native, "_aug_lib_cache", False)
    b = jitter(img, np.random.default_rng(7))
    np.testing.assert_allclose(a, b, atol=3e-5)


def test_threads_give_the_serial_outputs():
    """Four threads warping and jittering at once (the calls release the
    GIL) give what one thread gives."""
    cases = [(image((3, 96, 80), i), *WARP_CASES[i][2:], JITTER_SHIFTS[i % 6])
             for i in range(12)]

    def run(case):
        img, m_rc, b_rc, (hs, ss, vs) = case
        return t_native.color_jitter_native(t_native.affine_warp_native(img, m_rc, b_rc),
                                            hs, ss, vs)

    serial = [run(c) for c in cases]
    results = [None] * len(cases)

    def worker(k):
        for _ in range(5):
            for i in range(k, len(cases), 4):
                results[i] = run(cases[i])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(results, serial):
        np.testing.assert_array_equal(a, b)


def test_shapes_the_library_cannot_take_raise():
    """The C++ reads three planes of h·w (jitter) and a CHW block (warp):
    other shapes are refused before a pointer is passed."""
    with pytest.raises(ValueError, match="3-channel CHW"):
        t_native.color_jitter_native(np.zeros((4, 8, 8), np.float32), 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="CHW image"):
        t_native.affine_warp_native(np.zeros((8, 8), np.float32), np.eye(2), np.zeros(2))

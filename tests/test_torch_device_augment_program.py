"""The port's whole augment program (``device_augment.make_augment_fn``)
against the JAX reference's, and the reference's choice of warp.

- ``make_augment_fn`` on one u8 pack (8 records holding every mix kind,
  jitter and affine on some slots) for each of the 32 ``has_*``
  combinations (the 16 with jitter in
  test_torch_device_augment_program_jitter.py), the warp rotating through separable (on a rotation-free
  pack), two-pass and general.  A mix-only program must be identical to
  the reference program run op by op (``jax.disable_jit``, its arithmetic
  as written; jitted, XLA fuses MixUp's multiply-add and moves it by an
  ulp).  With jitter or a warp, the port against the reference as users
  run it (jitted): mean |Δ| ≤ 1e-5 and at most 0.2 % of pixels with
  |Δ| > 1e-3.
- the warp chosen for a stream config and image size
  (``augment_fn_for``) equals what the reference's
  ``apply_device_augmentation`` builds, and ``YDL_AUG_GENERAL_WARP=1``
  selects the general warp.
"""

import itertools

import numpy as np
import pytest
import torch

from yolodl_tpu.data import device_augment as j_da
from yolodl_tpu.data import pipeline as j_pipe
from yolodl_tpu.data.affine import RandomAffine as JRandomAffine
from yolodl_tpu.data.color import ColorJitter as JColorJitter
from yolodl_tpu.data.mosaic import MosaicMixer as JMosaicMixer
from yolodl_torch.data import device_augment as t_da
from yolodl_torch.data import pipeline as t_pipe
from yolodl_torch.data.affine import RandomAffine
from yolodl_torch.data.color import ColorJitter
from yolodl_torch.data.mosaic import MosaicMixer
from yolodl_torch.data.records import DataRecord

torch.set_num_threads(2)

H, W, ROTATE = 24, 32, 15.0


class SyntheticLoader:
    def __init__(self, record_type, h=H, w=W):
        self.record_type, self.h, self.w = record_type, h, w

    def load(self, i):
        rng = np.random.default_rng(2000 + int(i))
        img = rng.random((3, self.h, self.w)).astype(np.float32)
        n = int(rng.integers(1, 4))
        boxes = np.stack([rng.uniform(0.25, 0.75, n), rng.uniform(0.25, 0.75, n),
                          rng.uniform(0.1, 0.3, n), rng.uniform(0.1, 0.3, n)], -1)
        return self.record_type(img, boxes.astype(np.float32),
                                rng.integers(0, 3, n).astype(np.int32))


def stream_config(pipe, classes, rotate=True, **kw):
    color, affine, mosaic = classes
    return pipe.TrainingStreamConfig(
        batch_size=8, max_gt=16, seed=1, workers=1, mosaic_prob=0.3, mixup_prob=0.2,
        cutmix_prob=0.2, mosaic=mosaic(mosaic_margin=0.25),
        color_jitter=color(hue_shift=0.1, saturation_shift=0.2, value_shift=0.2),
        color_jitter_prob=0.6,
        random_affine=affine(rotate_prob=0.5 if rotate else 0.0,
                             rotate_degrees=ROTATE if rotate else None,
                             translation_prob=0.5, translation=0.1, scale_prob=0.5,
                             scale=(0.8, 1.2), horizontal_flip_prob=0.5),
        affine_prob=0.8, **kw)


PORT = (ColorJitter, RandomAffine, MosaicMixer)
REF = (JColorJitter, JRandomAffine, JMosaicMixer)


def port_pack(rotate):
    cfg = stream_config(t_pipe, PORT, rotate, defer_images=True)
    pack = next(iter(t_pipe.TrainingStream(list(range(16)), SyntheticLoader(DataRecord), cfg)))
    pack = pack.deferred
    assert set(pack["kind"].tolist()) == {0, 1, 2, 3}
    assert pack["jit_on"].any() and not pack["jit_on"].all()
    assert pack["aff_on"].any() and not pack["aff_on"].all()
    return pack


@pytest.fixture(scope="module")
def packs():
    """{rotating: pack}: a rotating and a rotation-free pack."""
    return {True: port_pack(True), False: port_pack(False)}


COMBOS = list(itertools.product((False, True), repeat=5))  # J, A, M, X, C
WARPS = ("separable", "twopass", "general")


def warp_kwargs(warp):
    return dict(separable=warp == "separable",
                bands=None if warp == "general" else t_da.twopass_bands(ROTATE, 0.8))


def run_both(pack, jit, **kw):
    import jax
    import jax.numpy as jnp

    out = t_da.make_augment_fn(H, W, **kw)({k: torch.from_numpy(v) for k, v in pack.items()})
    ref_fn = j_da.make_augment_fn(H, W, **kw)
    ref_pack = {k: jnp.asarray(v) for k, v in pack.items()}
    if jit:
        ref = ref_fn(ref_pack)
    else:
        with jax.disable_jit():
            ref = ref_fn(ref_pack)
    return out.numpy(), np.asarray(ref)


def assert_close_to_reference(out, ref):
    diff = np.abs(out - ref)
    assert np.mean(diff) <= 1e-5, np.mean(diff)
    assert np.mean(diff > 1e-3) <= 0.002, np.mean(diff > 1e-3)


def combo_id(combo):
    """J jitter, A affine, M mosaic, X mixup, C cutmix (- off)."""
    return "".join(n if on else "-" for n, on in zip("JAMXC", combo))


@pytest.mark.parametrize("combo", [c for c in COMBOS if not c[0]], ids=combo_id)
def test_program_matches_reference(combo, packs):
    check_combo(combo, packs)


def check_combo(combo, packs):
    has_jitter, has_affine, has_mosaic, has_mixup, has_cutmix = combo
    warp = WARPS[COMBOS.index(combo) % 3] if has_affine else "twopass"
    mix_only = not (has_jitter or has_affine)
    out, ref = run_both(packs[warp != "separable"], jit=not mix_only, **warp_kwargs(warp),
                        has_jitter=has_jitter, has_affine=has_affine, has_mosaic=has_mosaic,
                        has_mixup=has_mixup, has_cutmix=has_cutmix)
    assert out.shape == (8, 3, H, W) and out.dtype == np.float32
    if mix_only:
        np.testing.assert_array_equal(out, ref)
    else:
        assert_close_to_reference(out, ref)


def test_general_warp_env_overrides_the_bands(monkeypatch, packs):
    pack = packs[True]
    flags = dict(has_jitter=False, has_affine=True, has_mosaic=False, has_mixup=False,
                 has_cutmix=False)
    torch_pack = {k: torch.from_numpy(v) for k, v in pack.items()}
    general = t_da.make_augment_fn(H, W, **warp_kwargs("general"), **flags)(torch_pack)
    twopass = t_da.make_augment_fn(H, W, **warp_kwargs("twopass"), **flags)(torch_pack)
    assert not torch.equal(general, twopass)
    monkeypatch.setenv("YDL_AUG_GENERAL_WARP", "1")
    forced = t_da.make_augment_fn(H, W, **warp_kwargs("twopass"), **flags)(torch_pack)
    assert torch.equal(forced, general)


@pytest.mark.parametrize("rotate,size,extra", [
    (None, (24, 32), {}),
    (0.0, (24, 32), {"mixup_prob": 0.0, "cutmix_prob": 0.0}),
    (3.0, (24, 32), {"color_jitter": None}),
    (10.0, (24, 24), {"mosaic_prob": 0.0}),
    (59.0, (24, 24), {}),
    (65.0, (24, 24), {}),
    (40.0, (16, 32), {}),
    (45.0, (32, 16), {}),
])
def test_warp_choice_matches_reference(rotate, size, extra, monkeypatch):
    """What ``augment_fn_for`` builds for a config and an image size equals
    what the reference's ``apply_device_augmentation`` builds."""
    def configs(pipe, classes):
        color, affine, mosaic = classes
        aff = None if rotate is None else affine(
            rotate_prob=0.5 if rotate else 0.0, rotate_degrees=rotate or None,
            scale_prob=0.5, scale=(0.7, 1.2), horizontal_flip_prob=0.5)
        kw = dict(batch_size=2, max_gt=4, mosaic_prob=0.3, mixup_prob=0.2, cutmix_prob=0.2,
                  color_jitter=color(hue_shift=0.1), random_affine=aff)
        return pipe.TrainingStreamConfig(**{**kw, **extra})

    built = {}

    def recording(name):
        def make(h, w, **kw):
            built[name] = (h, w, kw)
            return lambda pack: pack["images"][:, 0]
        return make

    monkeypatch.setattr(t_da, "make_augment_fn", recording("port"))
    monkeypatch.setattr(j_da, "make_augment_fn", recording("ref"))
    t_da.augment_fn_for(configs(t_pipe, PORT), *size)
    h, w = size
    record = j_pipe.TrainingRecord(
        epoch=0, step=0, images=None, boxes=np.zeros((2, 4, 4), np.float32),
        classes=np.zeros((2, 4), np.int32), mask=np.zeros((2, 4), bool), timing=None,
        deferred={"images": np.zeros((2, 1, 3, h, w), np.uint8)})
    next(j_da.apply_device_augmentation(iter([record]), configs(j_pipe, REF)))
    assert built["port"] == built["ref"]

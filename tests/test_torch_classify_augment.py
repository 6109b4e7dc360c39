"""The port's classification augments against the JAX package's, on the
CPU, from the same key.

`torch_aug_draws` replays each JAX op's key schedule, and the port's apply
functions take the values the JAX op drew; outputs are held to the JAX
op's own output for that key: coefficients within 1e-5 of the largest JAX
value (crop + flip alone: exactly equal).  The v2 augment runs jitted on
the JAX side, as the JAX train step compiles it, and its replay derives the
crop's corner and size jitted too (the un-jitted op rounds them an ulp
apart, which moves a coefficient by ~1e-5 of the largest).  The samplers are held to the
JAX distributions over a few thousand draws.  Maps are small (16 source
blocks -> 12 or 8 output blocks) to keep the JAX compiles short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_detection_resnet_ssd_tpu.ops as J
import jpeg_detection_resnet_ssd_torch.ops as P
from jpeg_detection_resnet_ssd_torch.ops import dct_augment, dct_flip

import torch_aug_draws as draws

torch.set_num_threads(1)

B, H8, OUT_V1, OUT_V2 = 4, 16, 12, 8


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    return {"inputs": (rng.normal(0, 100, (B, H8, H8, 64)).astype(np.float32),
                       rng.normal(0, 30, (B, H8 // 2, H8 // 2, 128)).astype(np.float32)),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


def assert_planes_match(got, ref, rtol=1e-5):
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        err = np.abs(a - b).max()
        assert err <= rtol * np.abs(b).max(), (err, np.abs(b).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_flip(batch, seed):
    key = jax.random.PRNGKey(seed)
    y, cbcr = batch["inputs"]
    ref = J.dct_random_crop_flip(jnp.asarray(y), jnp.asarray(cbcr), key,
                                 out_y_blocks=OUT_V1, out_cbcr_blocks=OUT_V1 // 2)
    d = draws.to_torch(draws.cls_crop_flip(key, B, H8, H8, OUT_V1))
    got = dct_augment.dct_random_crop_flip_apply(torch.from_numpy(y), torch.from_numpy(cbcr), d,
                                                 OUT_V1, OUT_V1 // 2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [10, 11])
def test_maker_v1(batch, seed):
    key = jax.random.PRNGKey(seed)
    ref = J.make_dct_classification_augment(OUT_V1)(
        {"inputs": tuple(jnp.asarray(a) for a in batch["inputs"]), "labels": batch["labels"]}, key)
    aug = P.make_dct_classification_augment(OUT_V1, device="cpu")
    got = aug.apply(aug.to_device(batch), draws.to_torch(draws.cls_augment_v1(key, B, H8, H8, OUT_V1)))
    assert_planes_match(got["inputs"], ref["inputs"])
    np.testing.assert_array_equal(got["labels"], batch["labels"])


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_maker_v2(batch, seed):
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(J.make_dct_classification_augment_v2(OUT_V2))(
        {"inputs": tuple(jnp.asarray(a) for a in batch["inputs"]), "labels": batch["labels"]}, key)
    aug = P.make_dct_classification_augment_v2(OUT_V2, device="cpu")
    d = draws.cls_augment_v2(key, B, H8, H8)
    d = draws.to_torch({"crop": d["crop"], "photometric": d["photometric"]})
    got = aug.apply(aug.to_device(batch), d)
    assert_planes_match(got["inputs"], ref["inputs"])
    assert got["inputs"][0].shape == (B, OUT_V2, OUT_V2, 64)


def test_maker_v2_full_frame_and_no_flip_is_a_resize(batch):
    """With the identity view and no flip or photometric, the v2 apply is
    the bilinear resize of the whole frame (16 -> 8 blocks: the exact 2x
    average-pool downscale)."""
    aug = P.make_dct_classification_augment_v2(OUT_V2, photometric=False, device="cpu")
    crop = {"y0": torch.zeros(B), "x0": torch.zeros(B), "ch": torch.full((B,), H8 * 8.0),
            "cw": torch.full((B,), H8 * 8.0), "flip": torch.zeros(B, dtype=torch.bool)}
    got = aug.apply(aug.to_device(batch), {"crop": crop})["inputs"]
    want = [P.dct_downscale_2x(torch.from_numpy(a)) for a in batch["inputs"]]
    assert_planes_match(got, want)


@pytest.mark.parametrize("maker,out", [(P.make_dct_classification_augment, OUT_V1),
                                       (P.make_dct_classification_augment_v2, OUT_V2)])
def test_makers_sample_and_apply_on_their_device(batch, maker, out):
    """An int16-shipped NumPy batch goes in; float32 tensors of the output
    frame on the maker's device come out, two flip launches' worth of
    flips, and the generator decides the draws."""
    aug = maker(out, device="cpu")
    shipped = dict(batch, inputs=tuple(np.round(a).astype(np.int16) for a in batch["inputs"]))
    before = dct_flip.LAUNCHES
    outs = [aug(shipped, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert dct_flip.LAUNCHES == before  # the CPU runs the plain flip
    y, cbcr = outs[0]["inputs"]
    assert y.shape == (B, out, out, 64) and cbcr.shape == (B, out // 2, out // 2, 128)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert torch.equal(outs[0]["inputs"][0], outs[1]["inputs"][0])
    assert not torch.equal(outs[0]["inputs"][0], outs[2]["inputs"][0])


def test_every_flip_goes_through_the_flip_wrapper(batch, monkeypatch):
    calls = []
    real = dct_augment.dct_flip_horizontal
    monkeypatch.setattr(dct_augment, "dct_flip_horizontal",
                        lambda x, *a, **k: calls.append(tuple(x.shape)) or real(x, *a, **k))
    for maker, out in ((P.make_dct_classification_augment, OUT_V1),
                       (P.make_dct_classification_augment_v2, OUT_V2)):
        calls.clear()
        maker(out, device="cpu")(batch, torch.Generator().manual_seed(3))
        assert calls == [(B, out, out, 64), (B, out // 2, out // 2, 128)]


def test_crop_flip_op_is_sample_then_apply(batch):
    y, cbcr = (torch.from_numpy(a) for a in batch["inputs"])
    got = P.dct_random_crop_flip(y, cbcr, torch.Generator().manual_seed(5), OUT_V1, OUT_V1 // 2)
    d = dct_augment.sample_crop_flip(B, H8, H8, torch.Generator().manual_seed(5), OUT_V1)
    for a, b in zip(got, dct_augment.dct_random_crop_flip_apply(y, cbcr, d, OUT_V1, OUT_V1 // 2)):
        assert torch.equal(a, b)


N = 4000


def test_samplers_match_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    got = dct_augment.sample_classification_crop(N, 32, 32, gen)
    ref = draws.cls_augment_v2(jax.random.PRNGKey(0), N, 32, 32)
    for k in ("y0", "x0", "ch", "cw"):
        a, b = got[k].numpy(), ref["crop"][k]
        assert abs(a.mean() - b.mean()) < 0.1 * b.std(), k
        assert abs(a.std() / b.std() - 1) < 0.05, k
        assert 0.0 <= a.min() and a.max() <= 256.0
    full = got["ch"] == 256.0
    assert abs(float(full.double().mean()) - float(np.mean(ref["crop"]["ch"] == 256.0))) < 0.03
    assert abs(float(got["flip"].double().mean()) - 0.5) < 0.03
    assert abs(float(np.mean(ref["ident"])) - 0.2) < 0.03
    got = dct_augment.sample_crop_flip(N, 16, 16, gen, 12)
    ref = draws.cls_crop_flip(jax.random.PRNGKey(1), N, 16, 16, 12)
    for k in ("y0", "x0"):
        assert sorted(set(got[k].tolist())) == sorted(set(ref[k].tolist())) == [0, 1, 2]
    assert abs(float(got["flip"].double().mean()) - 0.5) < 0.03


def test_makers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for maker in (P.make_dct_classification_augment, P.make_dct_classification_augment_v2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            maker(28)

"""The slice as a whole, at full size: the device augmentation chain of the
`ssd_custom` train step, JAX package vs PyTorch port (CPU).

Seeded 44-block source planes (2, 44, 44, 64) / (2, 22, 22, 128) carrying
the two GT boxes of the JAX package's train benchmark (`bench.py:136-140`)
go through the JAX `make_dct_detection_augment_v3(38)` (compiled, as the JAX
step runs it) and `TargetEncoder(AnchorSpec(304, 304)).encode_fn`, and
through the port's chain, fed the JAX op's own draws for the same key, and
the port's `TargetEncoder(device="cpu")`.  Tolerances: the augmented planes
within 1e-5 of the largest JAX value; GT masks exactly equal and boxes
within 1e-3 px; target one-hot columns exactly equal and offsets within
1e-4.  Then one port train step runs with the port's chain as its
`augment_fn`, from weights carried over from a flax variable tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.ops import make_dct_detection_augment_v3 as jax_augment_v3
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.ops import dct_flip, make_dct_detection_augment_v3
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer

import torch_aug_draws as draws
from torch_cases import N_CLASSES
from torch_parity import random_flax_variables

torch.set_num_threads(1)

SIZES = ssd_predictor_sizes("resnet_custom")
BENCH_GT = ((3, 30, 40, 160, 170), (7, 150, 60, 280, 240))
B = 2


def source_batch():
    rng = np.random.default_rng(31)
    gt = np.zeros((B, 64, 5), np.float32)
    gt[:, :2] = BENCH_GT
    mask = np.zeros((B, 64), bool)
    mask[:, :2] = True
    return {"inputs": (rng.normal(0, 100, (B, 44, 44, 64)).astype(np.float32),
                       rng.normal(0, 30, (B, 22, 22, 128)).astype(np.float32)),
            "gt": gt, "gt_mask": mask}


@pytest.fixture(scope="module")
def augmented():
    batch = source_batch()
    key = jax.random.PRNGKey(3)
    ref = jax.jit(jax_augment_v3(out_y_blocks=38))(
        {"inputs": tuple(jnp.asarray(a) for a in batch["inputs"]),
         "gt": jnp.asarray(batch["gt"]), "gt_mask": jnp.asarray(batch["gt_mask"])}, key)
    jax_encoder = JaxTargetEncoder(JaxAnchorSpec(img_height=304, img_width=304), SIZES,
                                   n_classes=N_CLASSES, bipartite_impl="xla")
    ref_targets = np.asarray(jax.jit(jax_encoder.encode_fn)(ref["gt"], ref["gt_mask"]))

    aug = make_dct_detection_augment_v3(out_y_blocks=38, device="cpu")
    got = aug.apply(aug.to_device(batch), draws.to_torch(draws.augment_v3(key, B, 44, 44)))
    encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304), SIZES,
                            n_classes=N_CLASSES, device="cpu")
    return ref, ref_targets, got, encoder(got["gt"], got["gt_mask"]).numpy()


def test_augmented_planes_and_gt_match_jax(augmented):
    ref, _, got, _ = augmented
    for a, b, shape in zip(got["inputs"], ref["inputs"], ((B, 38, 38, 64), (B, 19, 19, 128))):
        b = np.asarray(b)
        assert a.shape == b.shape == shape
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * np.abs(b).max(), (err, np.abs(b).max())
    np.testing.assert_array_equal(got["gt_mask"].numpy(), np.asarray(ref["gt_mask"]))
    np.testing.assert_allclose(got["gt"].numpy(), np.asarray(ref["gt"]), rtol=0, atol=1e-3)


def test_targets_of_the_augmented_gt_match_jax(augmented):
    _, ref, _, got = augmented
    n_total = N_CLASSES + 1
    assert got.shape == ref.shape == (B, 8732, n_total + 12)
    np.testing.assert_array_equal(got[..., :n_total], ref[..., :n_total])
    assert got[..., 1:n_total].sum() >= 1  # some GT survived the crop and was matched
    np.testing.assert_allclose(got[..., n_total:], ref[..., n_total:], rtol=0, atol=1e-4)


def test_train_step_through_the_chain():
    batch = source_batch()
    module, _ = jax_build_model("ssd300_ssd_custom", n_classes=N_CLASSES)
    variables = random_flax_variables(
        module, (np.zeros((1, 38, 38, 64), np.float32), np.zeros((1, 19, 19, 128), np.float32)),
        train=False, seed=0)
    encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304), SIZES,
                            n_classes=N_CLASSES, device="cpu")
    trainer, model, _ = build_trainer(
        ExperimentConfig(compute_dtype="float32", batch_size=B), target_encoder=encoder,
        augment_fn=make_dct_detection_augment_v3(out_y_blocks=38, device="cpu"), device="cpu")
    load_flax_variables(model, variables)
    before = dct_flip.LAUNCHES
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert trainer.step == 1
    assert np.isfinite(float(metrics["total_loss"]))
    assert dct_flip.LAUNCHES == before  # the CPU runs the flip's plain version

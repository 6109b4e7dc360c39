"""Port parity of the VGG classifiers, JAX package vs PyTorch port (CPU):
`vgga`, `vggd` (RGB), `vgga_dct`, `vggd_dct` (Y and CbCr planes) and
`vgga_dct_8x8`, `vggd_dct_8x8` (one "DCT image"), at full width and depth
with 10 classes, and the layers they brought: `Conv` SAME at stride 8,
`max_pool` SAME at stride 2 and `Dropout`.

Weights are seeded NumPy draws carried into the port by
`compat.load_flax_variables` (the port's module is built on the meta
device, `torch_parity.port_module`).  Train mode draws dropout masks: the
port is handed the masks flax draws from the same key, recovered with a
probe module whose scope path is the head's (`torch_parity.
flax_dropout_masks`).  Tolerances: logits within 1e-4 of the largest JAX
logit (eval and train mode), the updated running statistics within 1e-4
of their largest; single layers within 1e-5; a float64 train step of
`vgga_dct` at batch 1: loss rtol 1e-5, every gradient within 1e-3 of its
largest entry; H5 import exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.models import layers as jax_layers
from jpeg_detection_resnet_ssd_tpu.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
from jpeg_detection_resnet_ssd_tpu.train.config import ExperimentConfig as JaxConfig
from jpeg_detection_resnet_ssd_tpu.train.loop import build_optimizer as jax_build_optimizer
from jpeg_detection_resnet_ssd_tpu.train.trainer import TrainState
from jpeg_detection_resnet_ssd_tpu.train.trainer import Trainer as JaxTrainer
from jpeg_detection_resnet_ssd_tpu.train.trainer import (
    classification_loss_fn as jax_classification_loss_fn,
)
from jpeg_detection_resnet_ssd_torch.compat import import_weights_by_name, load_flax_variables
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import _flax_to_state_dict
from jpeg_detection_resnet_ssd_torch.data.pipeline import _pack_inputs
from jpeg_detection_resnet_ssd_torch.models import MODEL_REGISTRY, layers
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer

from torch_parity import float64_convs_as_matmuls, flax_dropout_masks, port_module, random_flax_variables


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module's full-size models, and the
    process's count back afterwards: set at import, the count would hold
    for every module that pytest collects after this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

NAMES = ["vgga", "vggd", "vgga_dct", "vggd_dct", "vgga_dct_8x8", "vggd_dct_8x8"]
# 3x3 stride-1 SAME convs, each a B4 launch a step with `pallas_wgrad`.
B4_CONVS = {"vgga": 8, "vggd": 13, "vgga_dct": 5, "vggd_dct": 7, "vgga_dct_8x8": 4,
            "vggd_dct_8x8": 6}
N_CLASSES = 10

_CASES = {}


def as_torch(inputs):
    if isinstance(inputs, tuple):
        return tuple(torch.from_numpy(a) for a in inputs)
    return torch.from_numpy(inputs)


def replay_masks(monkeypatch, masks):
    """Make the port's dropout sampler hand out `masks` in order."""
    it = iter(masks)
    monkeypatch.setattr(layers, "dropout_mask",
                        lambda shape, keep, generator: torch.from_numpy(next(it)))


def case(name):
    """(inputs, flax variables, JAX eval logits, JAX train logits, JAX
    updated batch_stats, dropout masks, port model), made once per module:
    batch 1 for the RGB models (224x224 VGG-D is 31 GFLOP an image), else 2."""
    if name not in _CASES:
        module, example = jax_build_model(name, num_classes=N_CLASSES)
        batch = 1 if name in ("vgga", "vggd") else 2
        inputs = example(np.random.default_rng(len(name)))
        inputs = tuple(a[:batch] for a in inputs) if isinstance(inputs, tuple) else inputs[:batch]
        variables = random_flax_variables(module, inputs, train=False, seed=4)
        key = jax.random.PRNGKey(len(name))
        ev = module.apply(variables, inputs, train=False)
        tr, mutated = module.apply(variables, inputs, train=True, mutable=["batch_stats"],
                                   rngs={"dropout": key})
        stats = _flax_to_state_dict({"batch_stats": jax.device_get(mutated.get("batch_stats", {}))})
        _CASES[name] = (inputs, variables, np.asarray(ev), np.asarray(tr), stats,
                        flax_dropout_masks(key, batch),
                        port_module(name, variables, num_classes=N_CLASSES))
    return _CASES[name]


def assert_close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    inputs, _, ref, _, _, _, port = case(name)
    with torch.no_grad():
        got = port.eval()(as_torch(inputs)).numpy()
    assert got.shape[-1] == N_CLASSES
    assert_close(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_train_forward_with_flax_dropout_masks_matches_jax(monkeypatch, name):
    inputs, variables, ev, ref, stats, masks, port = case(name)
    replay_masks(monkeypatch, masks)
    with torch.no_grad(), layers.dropout_rng(torch.Generator()):
        got = port.train()(as_torch(inputs)).numpy()
    moved = {k: v.clone() for k, v in port.eval().state_dict().items()}
    load_flax_variables(port, variables)  # back to the statistics JAX started from
    assert_close(got, ref)
    assert not np.allclose(ref, ev)  # the masks made a difference
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    for key, want in stats.items():
        np.testing.assert_allclose(moved[key].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_switch_routes_the_eligible_convs(monkeypatch, name):
    """With `pallas_wgrad` on, the 3x3 stride-1 convs and nothing else (not
    the 8x8 stride-8 stem) go through the Function whose dW is B4."""
    inputs, _, _, _, _, _, port = case(name)
    calls = []
    real = layers.conv3x3_same_wgrad
    monkeypatch.setattr(layers, "conv3x3_same_wgrad",
                        lambda x, weight: calls.append(weight.shape) or real(x, weight))
    with torch.no_grad(), layers.pallas_wgrad(True):
        port.eval()(as_torch(inputs))
    assert len(calls) == B4_CONVS[name]


@pytest.mark.parametrize("name", [*NAMES, "ssd300_deconv", "ssd300_up_sampling",
                                  "ssd300_cb5_only", "ssd300_y_cb4_cbcr_cb5", "ssd300_vgg",
                                  "ssd300_vgg_dct", "ssd300_vgg_dct_image"])
def test_registry_has_the_jax_input_contract(name):
    """The example inputs are JAX's, and the entry's `input_format` packs
    an image into the same shapes (1 image of the contract's side)."""
    with torch.device("meta"):
        _, example = MODEL_REGISTRY[name]()
    _, jax_example = JAX_REGISTRY[name]()
    got, want = example(), jax_example()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    side = 300 if name.startswith("ssd300_") else 224
    image = np.random.default_rng(0).integers(0, 256, (side, side, 3)).astype(np.uint8)
    packed = _pack_inputs([image], MODEL_REGISTRY[name].input_format)
    packed = packed if isinstance(packed, tuple) else (packed,)
    assert [a.shape[1:] for a in packed] == [a.shape[1:] for a in want]


def test_h5_import_of_a_vgg_classifier(tmp_path):
    """The head's Dense layers (`fc1`, `fc2`, `predictions`) and the convs
    of `vgga` from a Keras H5 of the JAX variables, bit for bit."""
    _, variables, _, _, _, _, want = case("vgga")
    path = str(tmp_path / "vgga.h5")
    written = export_keras_h5(variables, path)
    assert {"fc1", "fc2", "predictions", "block1_conv1"} <= set(written)
    with torch.device("meta"):
        port, _ = MODEL_REGISTRY["vgga"](num_classes=N_CLASSES)
    port = port.to_empty(device="cpu")
    _, report = import_weights_by_name(port, path)
    assert sorted(report["loaded"]) == sorted(written)
    assert not report["skipped"] and not report["mismatched"]
    os.remove(path)  # 0.5 GB
    ref = want.state_dict()
    for key, tensor in port.state_dict().items():
        assert torch.equal(tensor, ref[key]), key


@pytest.mark.parametrize("size,kernel,strides", [(300, 8, 8), (224, 8, 8), (37, 8, 8), (9, 3, 2)])
def test_same_conv_at_stride_matches_flax(size, kernel, strides):
    """TF SAME at stride > 1: ceil(size / stride) outputs, the odd padding
    row and column on the high side (300 -> 38 pads (2, 2))."""
    x = np.random.default_rng(size).normal(0, 1, (2, size, size + 3, 3)).astype(np.float32)
    module = nn.Conv(5, (kernel, kernel), strides=(strides, strides), padding="SAME")
    variables = random_flax_variables(module, x, seed=1)
    ref = np.asarray(module.apply(variables, x))
    conv = load_flax_variables(layers.Conv(3, 5, kernel, strides, "SAME"), variables)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, -(-size // strides), -(-(size + 3) // strides), 5)
    assert_close(got, ref, 1e-5)
    assert layers.same_pads(300, 8, 8) == (2, 2) and layers.same_pads(224, 8, 8) == (0, 0)


@pytest.mark.parametrize("h,w", [(75, 75), (7, 9), (38, 38)])
def test_same_max_pool_at_stride_two_matches_flax(h, w):
    """Padded with -inf, not zero: the inputs are all negative, so a zero
    pad would win every window that reaches it."""
    x = -np.abs(np.random.default_rng(h).normal(0, 1, (2, h, w, 4))).astype(np.float32) - 0.1
    ref = np.asarray(jax_layers.max_pool(jnp.asarray(x), 2, 2, "SAME"))
    got = layers.max_pool(torch.from_numpy(x), 2, 2, "SAME").numpy()
    assert got.shape == ref.shape == (2, -(-h // 2), -(-w // 2), 4)
    np.testing.assert_array_equal(got, ref)
    assert layers.same_pads(75, 2, 2) == (0, 1)


def test_dropout_is_identity_in_eval_and_needs_a_generator_in_train():
    drop = layers.Dropout(0.5)
    x = torch.ones(64, 4096)
    assert drop.eval()(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="dropout_rng"):
        drop(x)
    with layers.dropout_rng(torch.Generator().manual_seed(0)):
        y = drop(x)
    with layers.dropout_rng(torch.Generator().manual_seed(0)):
        assert torch.equal(drop(x), y)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y != 0).float().mean()) - 0.5) < 0.01


LR = 1e-2


@pytest.fixture(scope="module")
def vgga_dct_step_f64():
    """One float64 train step of `vgga_dct` at batch 1 in both packages,
    from the same weights and batch, with the dropout masks the JAX step
    draws (its key is split from `fold_in(PRNGKey(1), 0)`)."""
    rng = np.random.default_rng(41)
    y = rng.normal(0, 100, (1, 28, 28, 64)).astype(np.float32)
    cbcr = rng.normal(0, 30, (1, 14, 14, 128)).astype(np.float32)
    batch = {"inputs": (y, cbcr), "labels": np.asarray([7], np.int32)}
    with jax.enable_x64(True), float64_convs_as_matmuls():
        module, _ = jax_build_model("vgga_dct", num_classes=N_CLASSES, dtype=jnp.float64)
        variables = random_flax_variables(module, (y, cbcr), train=False, seed=6)
        tx = jax_build_optimizer(JaxConfig(compute_dtype="float32", learning_rate=LR))
        trainer = JaxTrainer(model=module, loss_fn=jax_classification_loss_fn(), optimizer=tx,
                             mesh=None, donate=False)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        rng_key = jax.random.PRNGKey(1)
        new_state, metrics = jax.jit(trainer._step)(state, batch, rng_key)
        _, drop_key = jax.random.split(jax.random.fold_in(rng_key, 0))
        ref_metrics = {k: float(v) for k, v in metrics.items()}
        trace = jax.device_get(new_state.opt_state[0].trace)
        masks = flax_dropout_masks(drop_key, 1)

    port, model, _ = build_trainer(
        ExperimentConfig(model="vgga_dct", task="classification", compute_dtype="float32",
                         learning_rate=LR, l2_regularization=0.0,
                         model_kwargs={"num_classes": N_CLASSES, "dtype": torch.float64}),
        device="cpu")
    load_flax_variables(model, variables)
    # (the module lays the Dense kernels out as the port holds them)
    ref = {"metrics": ref_metrics, "grads": _flax_to_state_dict({"params": trace}, model)}
    with pytest.MonkeyPatch.context() as mp:
        replay_masks(mp, masks)
        metrics = port.train_step(batch, dropout_generator=torch.Generator())
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: p.grad.numpy() for k, p in model.named_parameters()}}
    return ref, got, masks


def test_float64_step_loss_matches_jax(vgga_dct_step_f64):
    ref, got, masks = vgga_dct_step_f64
    assert set(got["metrics"]) == set(ref["metrics"]) == {"loss", "top1", "top5", "total_loss"}
    for key in ("loss", "total_loss"):
        np.testing.assert_allclose(got["metrics"][key], ref["metrics"][key], rtol=1e-5)
    assert [m.shape for m in masks] == [(1, 4096)] * 2


def test_float64_step_gradients_match_jax(vgga_dct_step_f64):
    ref, got, _ = vgga_dct_step_f64
    assert set(got["grads"]) == set(ref["grads"])
    for key, want in ref["grads"].items():
        scale = np.abs(want).max()
        assert scale > 0, key
        # (assert_allclose's atol check, without its report passes over fc1's 100M entries)
        err = np.abs(got["grads"][key] - want).max()
        assert err <= 1e-3 * scale, (key, err, scale)

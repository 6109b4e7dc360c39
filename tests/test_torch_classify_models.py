"""Port parity of the classification models, JAX package vs PyTorch port
(CPU, float32): the 7 DCT stems with stage 5 and `fc1000`, the RGB
ResNet-50, their new layers (2x2 SAME conv, ConvTranspose, Dense, 2x
upsampling), `remat`, the registry and the weight carriers.

Weights are seeded NumPy draws carried into the port by
`compat.load_flax_variables`.  The DCT stems are scale-agnostic, so they
run on small maps (Y 16x16 blocks, CbCr 8x8; RGB 64x64 pixels) with 10
classes: stage 5 then sees 2x2 to 4x4 maps, enough samples per channel for
train-mode BatchNorm to be well conditioned at batch 2.  Tolerance: logits
within 1e-4 of the largest JAX logit (rtol
1e-4), in eval- and in train-mode BatchNorm; the updated running statistics
likewise; single layers within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5
from jpeg_detection_resnet_ssd_tpu.compat import h5_import as jax_h5
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.models import layers as jax_layers
from jpeg_detection_resnet_ssd_tpu.models.resnet import CLASSIFICATION_ARCHIS as JAX_ARCHIS
from jpeg_detection_resnet_ssd_tpu.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
from jpeg_detection_resnet_ssd_torch.compat import (
    flax_variables,
    import_weights_by_name,
    load_flax_variables,
)
from jpeg_detection_resnet_ssd_torch.models import (
    CLASSIFICATION_ARCHIS,
    MODEL_REGISTRY,
    build_model,
    layers,
)
from jpeg_detection_resnet_ssd_torch.ops import conv_grad

from torch_parity import random_flax_variables

torch.set_num_threads(1)

NAMES = ["resnet50_rgb", *(f"resnet50_dct_{a}" for a in CLASSIFICATION_ARCHIS)]
N_CLASSES = 10


def small_inputs(name, rng, batch=2):
    if name == "resnet50_rgb":
        return rng.uniform(0, 255, (batch, 64, 64, 3)).astype(np.float32)
    y = rng.normal(0, 100, (batch, 16, 16, 64)).astype(np.float32)
    if name.endswith("deconv"):
        return (y, *(rng.normal(0, 30, (batch, 8, 8, 64)).astype(np.float32) for _ in range(2)))
    return (y, rng.normal(0, 30, (batch, 8, 8, 128)).astype(np.float32))


def as_torch(inputs):
    if isinstance(inputs, tuple):
        return tuple(torch.from_numpy(a) for a in inputs)
    return torch.from_numpy(inputs)


_CASES = {}


def case(name):
    """(inputs, flax variables, JAX eval logits, JAX train logits, JAX
    updated batch_stats, port model) for `name`, made once per module."""
    if name not in _CASES:
        module, _ = jax_build_model(name, num_classes=N_CLASSES)
        inputs = small_inputs(name, np.random.default_rng(len(name)))
        variables = random_flax_variables(module, inputs, train=False, seed=3)

        @jax.jit
        def run(v, x):
            return (module.apply(v, x, train=False),
                    module.apply(v, x, train=True, mutable=["batch_stats"]))

        ev, (tr, mutated) = run(variables, inputs)
        port, _ = build_model(name, num_classes=N_CLASSES, device="cpu")
        load_flax_variables(port, variables)
        stats = jax.tree_util.tree_map(np.asarray, dict(mutated["batch_stats"]))
        _CASES[name] = (inputs, variables, np.asarray(ev), np.asarray(tr), stats, port)
    return _CASES[name]


def assert_close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_the_registries_agree():
    assert CLASSIFICATION_ARCHIS == JAX_ARCHIS
    assert set(NAMES) <= set(MODEL_REGISTRY) and set(NAMES) <= set(JAX_REGISTRY)


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    inputs, _, ref, _, _, port = case(name)
    with torch.no_grad():
        got = port.eval()(as_torch(inputs)).numpy()
    assert got.shape == ref.shape == (2, N_CLASSES) and np.isfinite(got).all()
    assert_close(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_train_forward_and_statistics_match_jax(name):
    inputs, variables, _, ref, stats, port = case(name)
    load_flax_variables(port, variables)  # the running statistics as JAX's started
    with torch.no_grad():
        got = port.train()(as_torch(inputs)).numpy()
    port.eval()
    assert_close(got, ref)
    moved = flax_variables(port)["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(stats)
    assert len(leaves) == len(jax.tree_util.tree_leaves(moved)) > 80
    for path, want in leaves:
        node = moved
        for p in path:
            node = node[p.key]
        assert_close(node, want)
    load_flax_variables(port, variables)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_are_the_flax_paths(name):
    _, variables, _, _, _, port = case(name)
    got = jax.tree_util.tree_map(np.shape, flax_variables(port))
    want = jax.tree_util.tree_map(np.shape, dict(variables))
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_with_the_jax_input_contract(name):
    port, example = build_model(name, device="cpu")
    _, jax_example = JAX_REGISTRY[name]()
    got, want = example(), jax_example()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.fc1000.weight.shape == (1000, 2048) and not port.training


def test_two_by_two_same_conv_matches_flax():
    """TF SAME for an even kernel pads 0 before and 1 after."""
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 6, 3)).astype(np.float32)
    module = nn.Conv(4, (2, 2), padding="SAME")
    variables = random_flax_variables(module, x, seed=1)
    ref = np.asarray(module.apply(variables, x))
    conv = load_flax_variables(layers.Conv(3, 4, 2, 1, "SAME"), variables)
    assert conv.pad == (0, 1)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 5, 6, 4)
    assert_close(got, ref, 1e-5)


@pytest.mark.parametrize("kernel,strides", [(2, 2), (3, 2)])
def test_conv_transpose_matches_flax(kernel, strides):
    """flax's ConvTranspose (transpose_kernel=False) is F.conv_transpose2d
    with the kernel flipped in both spatial axes."""
    x = np.random.default_rng(2).normal(0, 1, (2, 4, 5, 6)).astype(np.float32)
    module = nn.ConvTranspose(7, (kernel, kernel), strides=(strides, strides), padding="VALID")
    variables = random_flax_variables(module, x, seed=2)
    ref = np.asarray(module.apply(variables, x))
    port = load_flax_variables(layers.ConvTranspose(6, 7, kernel, strides), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert_close(got, ref, 1e-5)
    kernel_back = flax_variables(port)["params"]["kernel"]
    np.testing.assert_array_equal(kernel_back, variables["params"]["kernel"])


def test_dense_and_upsampling_match_flax():
    x = np.random.default_rng(3).normal(0, 1, (3, 9)).astype(np.float32)
    variables = random_flax_variables(nn.Dense(5), x, seed=3)
    port = load_flax_variables(layers.Dense(9, 5), variables)
    with torch.no_grad():
        assert_close(port(torch.from_numpy(x)).numpy(), nn.Dense(5).apply(variables, x), 1e-5)
    m = np.random.default_rng(4).normal(0, 1, (2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(layers.upsample2x(torch.from_numpy(m)).numpy(),
                                  np.asarray(jax_layers.upsample2x(jnp.asarray(m))))


def test_port_init_draws_flax_distributions():
    """he_normal for ConvTranspose (fan_in k*k*in) and lecun_normal for
    Dense, truncated at two standard deviations, zero biases."""
    g = torch.Generator().manual_seed(0)
    t = layers.ConvTranspose(64, 64, 2, 2, generator=g).weight
    d = layers.Dense(2048, 1000, generator=g)
    for w, std in ((t.detach(), np.sqrt(2 / 256)), (d.weight.detach(), np.sqrt(1 / 2048))):
        assert abs(float(w.std()) / std - 1) < 0.02
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert not d.bias.any()


def _loss_and_grads(model, inputs):
    model.zero_grad(set_to_none=True)
    out = model(inputs)
    loss = (out.square()).mean()
    loss.backward()
    return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["resnet50_dct_late_concat_rfa_thinner", "resnet50_dct_deconv"])
def test_remat_changes_nothing_but_memory(name):
    """Outputs, gradients and the running statistics are identical with and
    without recomputation: the recompute does not move BatchNorm's
    statistics a second time."""
    inputs, variables, _, _, _, _ = case(name)
    results = []
    for remat in (False, True):
        model, _ = build_model(name, num_classes=N_CLASSES, remat=remat, device="cpu")
        load_flax_variables(model, variables).train()
        out, grads = _loss_and_grads(model, as_torch(inputs))
        results.append((out, grads, {k: v.clone() for k, v in model.state_dict().items()}))
    (o0, g0, s0), (o1, g1, s1) = results
    assert torch.equal(o0, o1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert int(s1["stem.bn_in.num_batches_tracked" if name.endswith("deconv")
                  else "stem.bn_y_in.num_batches_tracked"]) == 1


def test_remat_recomputes_under_the_filter_gradient_switch(monkeypatch):
    """The backward's recompute goes through the switch's Function as the
    forward did, so the kernel's dW serves every eligible conv."""
    inputs, variables, _, _, _, _ = case("resnet50_dct_late_concat_rfa_thinner")
    calls = []
    real = conv_grad.conv3x3_filter_grad
    monkeypatch.setattr(conv_grad, "conv3x3_filter_grad",
                        lambda x, dy, *a, **k: calls.append(x.shape) or real(x, dy, *a, **k))
    counts = []
    for remat in (False, True):
        model, _ = build_model("resnet50_dct_late_concat_rfa_thinner", num_classes=N_CLASSES,
                               remat=remat, device="cpu")
        load_flax_variables(model, variables).train()
        calls.clear()
        with layers.pallas_wgrad(True):
            out = model(as_torch(inputs))
        out.square().mean().backward()
        counts.append(len(calls))
    assert counts[0] == counts[1] == 18


def test_flax_variables_round_trip_with_new_layers():
    _, variables, _, _, _, port = case("resnet50_dct_deconv")
    back = flax_variables(load_flax_variables(port, variables))
    for path, want in jax.tree_util.tree_leaves_with_path(dict(variables)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, want)


def test_h5_import_with_dense_and_transposed_convolutions(tmp_path):
    """Both importers on one Keras file of `resnet50_dct_deconv`, the
    ConvTranspose layers named in `transpose_conv_layers`: the same report,
    and the port's weights equal the flax bridge's of JAX's import."""
    inputs, variables, _, _, _, _ = case("resnet50_dct_deconv")
    module, _ = jax_build_model("resnet50_dct_deconv", num_classes=N_CLASSES)
    path = str(tmp_path / "deconv.h5")
    export_keras_h5(variables, path)
    start = random_flax_variables(module, inputs, train=False, seed=9)
    transposed = ("deconv_cb", "deconv_cr")
    jax_vars, jax_report = jax_h5.import_weights_by_name(start, path,
                                                         transpose_conv_layers=transposed)
    fresh, _ = build_model("resnet50_dct_deconv", num_classes=N_CLASSES, device="cpu")
    port, report = import_weights_by_name(fresh, path, transpose_conv_layers=transposed)
    assert report == jax_report and not report["mismatched"] and not report["skipped"]
    assert {"fc1000", "deconv_cb", "stem"} & set(report["loaded"]) == {"fc1000", "deconv_cb"}
    bridged, _ = build_model("resnet50_dct_deconv", num_classes=N_CLASSES, device="cpu")
    load_flax_variables(bridged, jax.tree_util.tree_map(np.asarray, jax_vars))
    want = bridged.state_dict()
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k

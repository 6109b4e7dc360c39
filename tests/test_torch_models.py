"""Port parity at layer and block level, JAX package vs PyTorch port (CPU, f32).

Weights are seeded NumPy draws carried into the port by
`compat.load_flax_variables`; both sides run in float32.  Tolerances:
rtol 1e-5 with atol 1e-5 * max|ref| -- a few convolutions whose sums run in
another order in XLA and in PyTorch's CPU kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from jpeg_detection_resnet_ssd_tpu.boxes.anchors import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.models import layers as jax_layers
from jpeg_detection_resnet_ssd_tpu.models import resnet as jax_resnet
from jpeg_detection_resnet_ssd_tpu.models import ssd as jax_ssd
from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec
from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.models import layers, resnet, ssd

from torch_parity import random_flax_variables

torch.set_num_threads(1)


def assert_close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


class _FlaxBlocks(jax_resnet.ResNetBlocks):
    """Narrow conv and identity bottlenecks, odd map, even kernel."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = self._conv_block(x, 3, [4, 4, 8], 9, "a", train, (2, 2))
        x = self._identity_block(x, 2, [4, 4, 8], 9, "b", train)
        x = self._conv_block(x, 1, [4, 4, 16], 9, "c", train, (1, 1))
        x = self._identity_block(x, 3, [4, 4, 16], 9, "d", train)
        return x


_PORT_BLOCKS = (
    resnet.conv_block(3, (4, 4, 8), 9, "a", strides=2),
    resnet.identity_block(2, (4, 4, 8), 9, "b"),
    resnet.conv_block(1, (4, 4, 16), 9, "c", strides=1),
    resnet.identity_block(3, (4, 4, 16), 9, "d"),
)


class _PortBlocks(resnet.ResNetBlocks):
    def __init__(self, in_features):
        super().__init__()
        self._add_blocks(in_features, _PORT_BLOCKS, torch.Generator().manual_seed(0))

    def forward(self, x):
        return self._run_blocks(x, _PORT_BLOCKS)


def _blocks_pair(rng):
    x = rng.normal(0, 1, (2, 9, 9, 6)).astype(np.float32)
    variables = random_flax_variables(_FlaxBlocks(), x, train=False, seed=1)
    port = load_flax_variables(_PortBlocks(6).eval(), variables)
    return x, variables, port


def test_resnet_blocks_match_jax(rng):
    x, variables, port = _blocks_pair(rng)
    ref = np.asarray(_FlaxBlocks().apply(variables, x, train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 5, 5, 16)
    assert_close(got, ref)


def test_resnet_blocks_keras_names(rng):
    _, variables, port = _blocks_pair(rng)
    names = {k.rsplit(".", 1)[0] for k in port.state_dict()}
    assert names == set(variables["params"]) | set(variables["batch_stats"])
    assert "res9a_branch1" in names and "bn9b_branch2b" in names
    assert "res9b_branch1" not in names  # identity blocks have no projection


def test_resnet_blocks_compute_in_bf16(rng):
    """The flax `dtype` meaning: f32 parameters, bf16 compute and output."""
    x, _, port = _blocks_pair(rng)
    with torch.no_grad():
        ref = port(torch.from_numpy(x)).numpy()
        got = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05 * np.abs(ref).max())


def test_l2_normalization_matches_jax(rng):
    x = rng.normal(0, 3, (2, 5, 5, 7)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-12 floor under the square root
    variables = random_flax_variables(jax_layers.L2Normalization(), x, seed=2)
    ref = np.asarray(jax_layers.L2Normalization().apply(variables, x))
    port = load_flax_variables(layers.L2Normalization(7), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(layers.L2Normalization(7).gamma, torch.full((7,), 20.0))


def test_pool_and_pad_match_flax(rng):
    x = rng.normal(0, 1, (2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        layers.max_pool(torch.from_numpy(x), 3, 1, "SAME").numpy(),
        np.asarray(jax_layers.max_pool(jnp.asarray(x), 3, 1, "SAME")),
    )
    np.testing.assert_array_equal(
        layers.max_pool(torch.from_numpy(x), 2, 2, "VALID").numpy(),
        np.asarray(jax_layers.max_pool(jnp.asarray(x), 2, 2, "VALID")),
    )
    np.testing.assert_array_equal(
        layers.zero_pad2d(torch.from_numpy(x), ((1, 2), (0, 1))).numpy(),
        np.asarray(jax_layers.zero_pad2d(jnp.asarray(x), ((1, 2), (0, 1)))),
    )


_HEAD_SOURCES = ((6, 6, 8), (3, 3, 8), (2, 2, 16), (2, 2, 16), (1, 1, 4), (1, 1, 4))


def test_ssd_head_matches_jax(rng):
    sources = [rng.normal(0, 1, (2, *s)).astype(np.float32) for s in _HEAD_SOURCES]
    head = jax_ssd._SSDHead(3, JaxAnchorSpec())
    variables = random_flax_variables(head, sources, seed=3)
    ref = np.asarray(head.apply(variables, sources))
    port = load_flax_variables(
        ssd._SSDHead(3, AnchorSpec(), [s[-1] for s in _HEAD_SOURCES]), variables
    )
    assert "conv4_3_norm_mbox_conf_4.weight" in port.state_dict()
    with torch.no_grad():
        got = port([torch.from_numpy(s) for s in sources]).numpy()
    assert got.shape == ref.shape == (2, 36 * 4 + 9 * 6 + 4 * 6 + 4 * 6 + 4 + 4, 3 + 1 + 12)
    np.testing.assert_array_equal(got[..., -8:], ref[..., -8:])  # anchors, variances
    assert_close(got[..., :4], ref[..., :4])  # softmax conf
    assert_close(got[..., 4:8], ref[..., 4:8])  # loc


def test_fc6_center_tap_matches_dilated_conv(rng):
    x = rng.normal(0, 1, (1, 5, 5, 6)).astype(np.float32)
    tap = ssd._FC6CenterTap(6, 4, dilation=6, generator=torch.Generator().manual_seed(0))
    full = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), tap.weight, tap.bias, padding=6, dilation=6
    ).permute(0, 2, 3, 1)
    with torch.no_grad():
        np.testing.assert_allclose(tap(torch.from_numpy(x)).numpy(), full.numpy(), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="center-tap"):
            tap(torch.zeros(1, 7, 7, 6))


def test_load_flax_variables_rejects_mismatch(rng):
    x, variables, _ = _blocks_pair(rng)
    params = dict(variables["params"])
    del params["res9a_branch2a"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(_PortBlocks(6), {**variables, "params": params})
    extra = dict(variables["params"], res9z_branch2a=variables["params"]["res9a_branch2a"])
    with pytest.raises(KeyError, match="unused"):
        load_flax_variables(_PortBlocks(6), {**variables, "params": extra})
    with pytest.raises(ValueError, match="module has"):
        load_flax_variables(_PortBlocks(7), variables)


def test_he_normal_init_statistics():
    w = layers.he_normal_(torch.empty(256, 64, 3, 3), torch.Generator().manual_seed(0))
    std = np.sqrt(2.0 / (64 * 9))
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2.0 * std / layers._TRUNC_STD + 1e-6

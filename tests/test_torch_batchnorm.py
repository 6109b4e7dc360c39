"""Train-mode BatchNorm of the port against flax's (CPU, float32).

flax normalises with the batch mean and the biased variance E[x^2] - E[x]^2
(float32, clipped at 0) and moves the running statistics by momentum 0.99
with that biased variance; torch's own layer would move the running
variance with the unbiased one, a factor n / (n - 1) apart (n = B*H*W).
Tolerance rtol 1e-5 (atol 1e-5 * max|ref|): the same arithmetic, summed in
another order.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from jpeg_detection_resnet_ssd_tpu.models import layers as jax_layers
from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.models import layers

from test_torch_models import _FlaxBlocks, _PortBlocks
from torch_parity import random_flax_variables

torch.set_num_threads(1)


class _FlaxBN(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool = False):
        return jax_layers.batch_norm(train, name="bn")(x)


class _PortBN(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.bn = layers.BatchNorm(c)

    def forward(self, x):
        return self.bn(x)


def assert_close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _flax_train(module, variables, x):
    out, mutated = module.apply(variables, x, train=True, mutable=["batch_stats"])
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])


def _bn_case(shape=(2, 5, 5, 6), seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 3, shape) + rng.normal(0, 2, shape[-1])).astype(np.float32)
    variables = random_flax_variables(_FlaxBN(), x, train=False, seed=seed)
    port = load_flax_variables(_PortBN(shape[-1]), variables).train()
    return x, variables, port


@pytest.mark.parametrize("shape", [(2, 5, 5, 6), (4, 3, 3, 8)])
def test_batchnorm_train_output_and_running_stats_match_flax(shape):
    x, variables, port = _bn_case(shape)
    ref, stats = _flax_train(_FlaxBN(), variables, x)
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_close(got.detach().numpy(), ref)
    assert_close(port.bn.running_mean.numpy(), stats["bn"]["mean"])
    assert_close(port.bn.running_var.numpy(), stats["bn"]["var"])


def test_torch_unbiased_update_differs_from_flax():
    """The fault this layer repairs: torch's BatchNorm2d moves the running
    variance with the unbiased batch variance, 2% off at n = 50."""
    x, variables, port = _bn_case()
    _, stats = _flax_train(_FlaxBN(), variables, x)
    plain = torch.nn.BatchNorm2d(6, eps=1e-3, momentum=0.01)
    plain.load_state_dict(port.bn.state_dict())
    plain.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    port(torch.from_numpy(x))
    ref_var = stats["bn"]["var"]
    assert not np.allclose(plain.running_var.detach().numpy(), ref_var, rtol=1e-4)
    assert_close(port.bn.running_var.numpy(), ref_var)


def test_batchnorm_train_returns_input_dtype_and_cumulative_momentum():
    """bf16 in, bf16 out (statistics in float32); momentum None (the
    calibration `chip_smoke.py` does) sets the running statistics to the
    batch's mean and biased variance."""
    x, _, port = _bn_case()
    xt = torch.from_numpy(x)
    assert port(xt.bfloat16()).dtype == torch.bfloat16
    port.bn.reset_running_stats()
    port.bn.momentum = None
    port(xt)
    np.testing.assert_allclose(port.bn.running_mean.numpy(), x.mean((0, 1, 2)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.bn.running_var.numpy(), x.var((0, 1, 2)), rtol=1e-4)


def test_bottleneck_train_mode_matches_flax():
    """Conv and identity bottlenecks in train mode: output and every
    BatchNorm's running statistics."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 9, 9, 6)).astype(np.float32)
    variables = random_flax_variables(_FlaxBlocks(), x, train=False, seed=1)
    port = load_flax_variables(_PortBlocks(6), variables).train()
    ref, stats = _flax_train(_FlaxBlocks(), variables, x)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert_close(got, ref)
    state = port.state_dict()
    for name, leaves in stats.items():
        assert_close(state[f"{name}.running_mean"].numpy(), leaves["mean"])
        assert_close(state[f"{name}.running_var"].numpy(), leaves["var"])

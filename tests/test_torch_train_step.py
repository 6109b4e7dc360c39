"""The whole slice: one train step of the full `ssd300_ssd_custom` at
batch 2, JAX package vs PyTorch port, from the same weights and batch (CPU).

JAX side: the package's own `Trainer._step` (jitted; `_step` does not touch
the mesh, so none is built), with the in-step target encoder
(`bipartite_impl="xla"`), `SSDLoss` + the selective L2 penalty and
`optax.sgd` with momentum.  Port side: `build_trainer(device="cpu")`, whose
plain versions stand in for the CUDA kernels, with the same weights carried
over by `load_flax_variables`.  The gradients are read from the optimizer
state after the first step: the momentum trace of both optax and torch's
SGD is then exactly the gradient.

The step runs twice: in float32 (the configuration the packages train in),
and with float64 compute (float32 parameters, float32 softmax and loss, as
both packages do for any compute dtype).  The gradients are compared in
the float64 step.  In float32 they are chaotic at this random init: a
perturbation of one part in 1e7 of the input moves the port's own
gradients of the stage-4 and stage-5 weights by up to 30% of their largest
entry (relu and max-pool decisions on nearly tied values flip), so any
reordering of float32 sums, XLA's or PyTorch's, does the same.

Tolerances, each per tensor:
  * targets: one-hot columns exact; offsets rtol 1e-5 / atol 1e-5 (see
    `test_torch_target_encoder.py`);
  * loss and total loss rtol 1e-5, L2 penalty rtol 1e-6;
  * gradients (float64 step) within 1e-3 * max|ref|;
  * updated parameters (float64 step) within 1e-6 * max|ref| + 1e-3 * lr *
    max|grad| (the step moves them by lr * grad);
  * running statistics within 1e-4 * max|ref| (the forward's tolerance).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
from jpeg_detection_resnet_ssd_tpu.losses import SSDLoss as JaxSSDLoss
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.train.config import ExperimentConfig as JaxConfig
from jpeg_detection_resnet_ssd_tpu.train.loop import build_optimizer as jax_build_optimizer
from jpeg_detection_resnet_ssd_tpu.train.trainer import TrainState
from jpeg_detection_resnet_ssd_tpu.train.trainer import Trainer as JaxTrainer
from jpeg_detection_resnet_ssd_tpu.train.trainer import detection_loss_fn as jax_loss_fn
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import _flax_to_state_dict
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer

from torch_cases import N_CLASSES, gt_batch
from torch_parity import random_flax_variables

torch.set_num_threads(1)

SIZES = ssd_predictor_sizes("resnet_custom")
LR = 1e-3
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def run_step(dtype):
    rng = np.random.default_rng(21)
    y = rng.normal(0, 100, (2, 38, 38, 64)).astype(np.float32)
    cbcr = rng.normal(0, 30, (2, 19, 19, 128)).astype(np.float32)
    gt, mask = gt_batch(rng, [3, 6])
    batch = {"inputs": (y, cbcr), "gt": gt, "gt_mask": mask}

    module, _ = jax_build_model("ssd300_ssd_custom", n_classes=N_CLASSES, dtype=dtype)
    variables = random_flax_variables(module, (y, cbcr), train=False, seed=0)
    encoder = JaxTargetEncoder(JaxAnchorSpec(), SIZES, n_classes=N_CLASSES, bipartite_impl="xla")
    tx = jax_build_optimizer(JaxConfig(compute_dtype="float32", learning_rate=LR))
    trainer = JaxTrainer(
        model=module, loss_fn=jax_loss_fn(JaxSSDLoss(), 5e-4), optimizer=tx, mesh=None,
        donate=False, target_encoder=encoder.encode_fn,
    )
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
    )
    new_state, ref_metrics = jax.jit(trainer._step)(state, batch, jax.random.PRNGKey(1))
    ref = {
        "metrics": {k: float(v) for k, v in ref_metrics.items()},
        "targets": np.asarray(encoder(gt, mask)),
        "grads": _flax_to_state_dict({"params": jax.device_get(new_state.opt_state[0].trace)}),
        "state": _flax_to_state_dict(jax.device_get(
            {"params": new_state.params, "batch_stats": new_state.batch_stats}
        )),
        "step": int(new_state.step),
    }

    port_encoder = TargetEncoder(AnchorSpec(), SIZES, n_classes=N_CLASSES, device="cpu")
    port, model, _ = build_trainer(
        ExperimentConfig(compute_dtype="float32", learning_rate=LR,
                         model_kwargs={"dtype": TORCH_DTYPES[dtype]}),
        target_encoder=port_encoder, device="cpu",
    )
    load_flax_variables(model, variables)
    metrics = port.train_step(batch)
    got = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "targets": port_encoder(gt, mask).numpy(),
        "grads": {k: p.grad.numpy() for k, p in model.named_parameters()},
        "state": {k: v.numpy() for k, v in model.state_dict().items()},
        "step": port.step,
    }
    return ref, got


@pytest.fixture(scope="module")
def one_step():
    return run_step(jnp.float32)


@pytest.fixture(scope="module")
def one_step_f64():
    with jax.enable_x64(True):
        return run_step(jnp.float64)


def test_targets_match_jax(one_step):
    ref, got = one_step
    n_total = N_CLASSES + 1
    np.testing.assert_array_equal(got["targets"][..., :n_total], ref["targets"][..., :n_total])
    assert got["targets"][..., 1:n_total].sum() >= 9  # every box got an anchor
    np.testing.assert_allclose(got["targets"], ref["targets"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("step", ["one_step", "one_step_f64"])
def test_loss_matches_jax(step, request):
    ref, got = request.getfixturevalue(step)
    assert set(got["metrics"]) == set(ref["metrics"]) == {"loss", "reg", "total_loss"}
    np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["reg"], ref["metrics"]["reg"], rtol=1e-6)
    np.testing.assert_allclose(got["metrics"]["total_loss"], ref["metrics"]["total_loss"], rtol=1e-5)
    assert got["step"] == ref["step"] == 1


# Biases whose gradient is 0 in exact arithmetic: their layer feeds a
# train-mode BatchNorm (directly, or through a conv), which removes any
# constant shift.  Both sides give rounding noise there (~1e-17 in the
# float64 step), held to 1e-3 of the gradient of the layer's weight.
_ZERO_GRAD = re.compile(r"^(res\w+|bn_y_in|bn_cbcr_in)\.bias$")


def test_every_gradient_matches_jax(one_step_f64):
    ref, got = one_step_f64
    assert set(got["grads"]) == set(ref["grads"])
    n_zero = 0
    for key, want in ref["grads"].items():
        scale = np.abs(want).max()
        if _ZERO_GRAD.match(key):
            n_zero += 1
            scale = np.abs(ref["grads"][key[: -len("bias")] + "weight"]).max()
        np.testing.assert_allclose(got["grads"][key], want, rtol=0, atol=1e-3 * scale, err_msg=key)
    assert n_zero == 2 + 69  # the input BatchNorms and the 69 trunk convs


def test_updated_parameters_and_batch_stats_match_jax(one_step_f64):
    ref, got = one_step_f64
    for key, want in ref["state"].items():
        if key.endswith(("running_mean", "running_var")):
            atol = 1e-4 * np.abs(want).max()
        else:
            atol = 1e-6 * np.abs(want).max() + 1e-3 * LR * np.abs(ref["grads"][key]).max()
        np.testing.assert_allclose(got["state"][key], want, rtol=0, atol=atol, err_msg=key)


def test_float32_batch_stats_match_jax(one_step):
    ref, got = one_step
    stats = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 71  # 71 BatchNorms
    for key in stats:
        want = ref["state"][key]
        np.testing.assert_allclose(got["state"][key], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=key)

"""The classification train step, JAX package vs PyTorch port (CPU).

  * `BF16MomentumSGD` against `optax.sgd(accumulator_dtype=bfloat16)`,
    jitted as the JAX step runs it, over 3 steps: traces bit-identical,
    parameters within 2.4e-7 of the largest (a multiply-add rounded once
    by XLA);
  * `softmax_cross_entropy` within 1e-6 and `top_k_accuracy` exactly, on
    logits full of ties;
  * one train step of `resnet50_dct_late_concat_rfa_thinner` (10 classes,
    Y 16x16 blocks, batch 4) from the same weights and batch, through the
    JAX package's `Trainer._step` with `classification_loss_fn` and the
    `train-classify` optimizer (SGD 0.1, Nesterov, inverse-time decay), and
    through the port's `build_trainer(task="classification")`: in float64
    compute, loss within 1e-5, top-1/top-5 equal, gradients within 1e-3 of
    the largest, updated parameters within 1e-6 of the largest plus 1e-3 *
    lr * max|grad|, running statistics within 1e-4; the same for two steps
    with `remat=True` and `momentum_dtype="bfloat16"` (parameters only);
  * `fit` and the validation hook on classification batches.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.losses import softmax_cross_entropy as jax_xent
from jpeg_detection_resnet_ssd_tpu.losses import top_k_accuracy as jax_top_k
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.train.config import ExperimentConfig as JaxConfig
from jpeg_detection_resnet_ssd_tpu.train.loop import build_optimizer as jax_build_optimizer
from jpeg_detection_resnet_ssd_tpu.train.trainer import TrainState
from jpeg_detection_resnet_ssd_tpu.train.trainer import Trainer as JaxTrainer
from jpeg_detection_resnet_ssd_tpu.train.trainer import (
    classification_loss_fn as jax_classification_loss_fn,
)
from jpeg_detection_resnet_ssd_torch.compat import flax_variables, load_flax_variables
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import _flax_to_state_dict
from jpeg_detection_resnet_ssd_torch.losses import softmax_cross_entropy, top_k_accuracy
from jpeg_detection_resnet_ssd_torch.train import (
    BF16MomentumSGD,
    ExperimentConfig,
    build_optimizer,
    build_trainer,
    fit,
    make_validation_fn,
)

from torch_parity import random_flax_variables

torch.set_num_threads(1)

MODEL = "resnet50_dct_late_concat_rfa_thinner"
N_CLASSES = 10


@pytest.mark.parametrize("nesterov", [False, True])
def test_bf16_momentum_matches_optax(nesterov):
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 4, 5), (17,), (64, 32)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(0, 1, s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = optax.sgd(0.1, momentum=0.9, nesterov=nesterov, accumulator_dtype=jnp.bfloat16)
    update = jax.jit(tx.update)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    port = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = build_optimizer(ExperimentConfig(learning_rate=0.1, momentum=0.9, nesterov=nesterov,
                                           momentum_dtype="bfloat16"), port)
    assert isinstance(opt, BF16MomentumSGD)
    for g in grads:
        u, state = update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, u)
        for t, a in zip(port, g):
            t.grad = torch.from_numpy(a.copy())
        opt.step()
        for ref, got in zip(params, port):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                       atol=2.4e-7 * np.abs(ref).max())
        for ref, got in zip(state[0].trace, port):
            buf = opt.state[got]["momentum_buffer"]
            assert buf.dtype == torch.bfloat16
            np.testing.assert_array_equal(buf.float().numpy(), np.asarray(ref, np.float32))


def test_bf16_momentum_survives_a_state_dict_round_trip():
    """A restored buffer (torch casts it to the parameter's dtype) steps as
    the bf16 one it was."""
    rng = np.random.default_rng(1)
    p = rng.normal(0, 1, (50,)).astype(np.float32)
    grads = [torch.from_numpy(rng.normal(0, 1, (50,)).astype(np.float32)) for _ in range(3)]
    finals = []
    for restore in (False, True):
        w = torch.nn.Parameter(torch.from_numpy(p.copy()))
        opt = BF16MomentumSGD([w], lr=0.05, momentum=0.9)
        for i, g in enumerate(grads):
            if restore and i == 2:
                state = opt.state_dict()
                opt = BF16MomentumSGD([w], lr=0.05, momentum=0.9)
                opt.load_state_dict(state)
            w.grad = g.clone()
            opt.step()
        finals.append(w.detach().clone())
    assert torch.equal(finals[0], finals[1])


@pytest.mark.parametrize("k", [1, 2, 5, 12])
def test_cross_entropy_and_top_k_with_ties(k):
    rng = np.random.default_rng(k)
    logits = rng.integers(-2, 3, (64, 10)).astype(np.float32)  # many ties
    logits[:4] = 1.0  # all ten tied
    labels = rng.integers(0, 10, 64).astype(np.int32)
    onehot = np.eye(10, dtype=np.float32)[labels]
    got = float(top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k))
    assert got == float(jax_top_k(jnp.asarray(logits), jnp.asarray(labels), k))
    ref = float(jax_xent(jnp.asarray(logits), jnp.asarray(onehot)))
    got = float(softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(onehot)))
    assert got == pytest.approx(ref, rel=1e-6)


def _cls_batch(seed=31, batch=4):
    rng = np.random.default_rng(seed)
    return {"inputs": (rng.normal(0, 100, (batch, 16, 16, 64)).astype(np.float32),
                       rng.normal(0, 30, (batch, 8, 8, 128)).astype(np.float32)),
            "labels": rng.integers(0, N_CLASSES, batch).astype(np.int32)}


def _config(**kw):
    return dict(model=MODEL, task="classification", model_kwargs={"num_classes": N_CLASSES},
                learning_rate=0.1, nesterov=True, lr_decay=1e-4, l2_regularization=0.0,
                compute_dtype="float32", **kw)


def run_steps(n_steps=1, **levers):
    """(JAX rows, port rows) of `n_steps` float64 steps: metrics, the
    gradients (the first step's momentum trace) and the state after each."""
    batches = [_cls_batch(31 + i) for i in range(n_steps)]
    with jax.enable_x64(True):
        module, _ = jax_build_model(MODEL, num_classes=N_CLASSES, dtype=jnp.float64,
                                    remat=levers.get("remat", False))
        variables = random_flax_variables(module, batches[0]["inputs"], train=False, seed=5)
        tx = jax_build_optimizer(JaxConfig(**_config(**levers)))
        trainer = JaxTrainer(model=module, loss_fn=jax_classification_loss_fn(), optimizer=tx,
                             mesh=None, donate=False)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]))
        step = jax.jit(trainer._step)
        ref = []
        for b in batches:
            state, metrics = step(state, b, jax.random.PRNGKey(1))
            ref.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "trace": jax.device_get(state.opt_state[0].trace),
                "state": jax.device_get({"params": state.params, "batch_stats": state.batch_stats}),
            })
    port, model, _ = build_trainer(ExperimentConfig(**{**_config(**levers), "model_kwargs": {
        "num_classes": N_CLASSES, "dtype": torch.float64}}), device="cpu")
    load_flax_variables(model, variables)
    got = []
    for b in batches:
        metrics = port.train_step(b)
        got.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()},
        })
    for r in ref:
        r["trace"] = _flax_to_state_dict({"params": r["trace"]}, model)
        r["state"] = _flax_to_state_dict(r["state"], model)
    return ref, got, model


@pytest.fixture(scope="module")
def one_step():
    return run_steps(1)


@pytest.fixture(scope="module")
def levers_steps():
    return run_steps(2, remat=True, momentum_dtype="bfloat16")


def test_step_metrics_match_jax(one_step):
    ref, got, _ = one_step
    r, g = ref[0]["metrics"], got[0]["metrics"]
    assert r.keys() == g.keys() == {"loss", "top1", "top5", "total_loss"}
    assert g["loss"] == pytest.approx(r["loss"], rel=1e-5)
    assert g["total_loss"] == g["loss"]
    assert (g["top1"], g["top5"]) == (r["top1"], r["top5"])


# Biases whose gradient is 0 in exact arithmetic: their layer feeds a
# train-mode BatchNorm (directly, or through a conv), which removes any
# constant shift.  Both sides give rounding noise there (~1e-17 in the
# float64 step), held to 1e-3 of the gradient of the layer's weight.
_ZERO_GRAD = re.compile(r"^(stem\.)?(res\w+|bn_y_in|bn_cbcr_in)\.bias$")


def test_step_gradients_match_jax(one_step):
    ref, got, _ = one_step
    grads, trace = got[0]["grads"], ref[0]["trace"]
    assert grads.keys() == trace.keys() and len(grads) > 250
    n_zero = 0
    for k, want in trace.items():
        scale = np.abs(want).max()
        if _ZERO_GRAD.match(k):
            n_zero += 1
            scale = np.abs(trace[k[: -len("bias")] + "weight"]).max()
        np.testing.assert_allclose(grads[k], want, rtol=0, atol=1e-3 * scale, err_msg=k)
    assert n_zero == 2 + 69  # the input BatchNorms and the 69 convs


def _assert_state(ref_state, got_state, room):
    """Parameters within 1e-6 of their largest plus `room[k]`; running
    statistics within 1e-4 of their largest."""
    for k, want in ref_state.items():
        got = got_state[k]
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * np.abs(want).max()
        else:
            tol = 1e-6 * np.abs(want).max() + room[k]
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)


def test_step_updates_match_jax(one_step):
    ref, got, _ = one_step
    room = {k: 1e-3 * 0.1 * np.abs(g).max() for k, g in got[0]["grads"].items()}
    _assert_state(ref[0]["state"], got[0]["state"], room)


def test_remat_and_bf16_momentum_match_jax(levers_steps):
    """Two steps with both memory levers.  The second reads the bf16 trace,
    where a gradient whose float32 values differ in the last bit between
    the packages may round to bf16 one step (2^-8 of it) apart; so the
    second step's parameters get lr * 2^-7 * max|grad| more room."""
    ref, got, model = levers_steps
    assert model.remat and model.stem.remat
    g_max = {k: max(np.abs(g["grads"][k]).max() for g in got) for k in got[0]["grads"]}
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g["metrics"]["loss"] == pytest.approx(r["metrics"]["loss"], rel=1e-5)
        room = {k: 0.1 * (1e-3 + (2.0 ** -7 if i else 0.0)) * v for k, v in g_max.items()}
        _assert_state(r["state"], g["state"], room)


def test_fit_and_validation_on_classification_batches(tmp_path):
    batches = [_cls_batch(40 + i, batch=2) for i in range(3)]
    cfg = ExperimentConfig(**{**_config(batch_size=2, epochs=1, steps_per_epoch=3),
                              "learning_rate": 1e-3})
    val_fn = make_validation_fn(None, batches[:2])
    trainer, history = fit(cfg, batches, val_fn=val_fn, device="cpu", run_dir=str(tmp_path))
    row = history[-1]
    assert trainer.step == 3 and np.isfinite(row["loss"])
    assert {"loss", "top1", "top5", "total_loss", "val_loss", "val_top1", "val_top5"} <= row.keys()
    logits = trainer.eval_step()(batches[0]["inputs"])
    onehot = torch.nn.functional.one_hot(torch.from_numpy(batches[0]["labels"]).long(), N_CLASSES)
    want0 = float(softmax_cross_entropy(logits, onehot.float()))
    logits1 = trainer.eval_step()(batches[1]["inputs"])
    onehot1 = torch.nn.functional.one_hot(torch.from_numpy(batches[1]["labels"]).long(), N_CLASSES)
    want = (want0 + float(softmax_cross_entropy(logits1, onehot1.float()))) / 2
    assert val_fn(trainer)["loss"] == pytest.approx(want, rel=1e-6)
    flax_variables(trainer.model)  # a classifier round-trips through the bridge

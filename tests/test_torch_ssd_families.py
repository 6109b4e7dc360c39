"""Port parity of the SSD300 families beyond `ssd_custom`, JAX package vs
PyTorch port (CPU): the four ResNet "identical" detectors (`deconv`,
`up_sampling`, `cb5_only`, `y_cb4_cbcr_cb5`) and the three VGG ones
(`ssd300_vgg`, `ssd300_vgg_dct`, `ssd300_vgg_dct_image`), at full width and
depth with 20 classes.

Weights are seeded NumPy draws carried into the port by
`compat.load_flax_variables` (the port's module is built on the meta
device, `torch_parity.port_module`).  Tolerances:
  * forward at batch 1, eval- and train-mode BatchNorm: the whole output
    within 1e-4 of its largest JAX value, and the softmax scores alone
    within 1e-3 (the random heads' logits reach the hundreds, so float32
    rounding of one part in 1e6 moves a score of `ssd300_vgg` by up to
    5e-4); the updated running statistics within 1e-4 of their largest;
  * the selective L2 penalty rtol 1e-6 over the same kernels;
  * a float64 train step of `ssd300_vgg_dct` at batch 1 (float32
    parameters, as `test_torch_train_step.py` runs `ssd_custom`): loss and
    total loss rtol 1e-5, every gradient within 1e-3 of its largest entry;
  * H5 import of `ssd300_vgg` (conf layers without the class suffix):
    every tensor exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5
from jpeg_detection_resnet_ssd_tpu.losses import SSDLoss as JaxSSDLoss
from jpeg_detection_resnet_ssd_tpu.losses.classification import (
    default_ssd_reg_filter,
    l2_regularization_loss as jax_l2,
)
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.models import ssd_predictor_sizes as jax_predictor_sizes
from jpeg_detection_resnet_ssd_tpu.train.config import ExperimentConfig as JaxConfig
from jpeg_detection_resnet_ssd_tpu.train.loop import build_optimizer as jax_build_optimizer
from jpeg_detection_resnet_ssd_tpu.train.trainer import TrainState
from jpeg_detection_resnet_ssd_tpu.train.trainer import Trainer as JaxTrainer
from jpeg_detection_resnet_ssd_tpu.train.trainer import detection_loss_fn as jax_loss_fn
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder, build_anchors
from jpeg_detection_resnet_ssd_torch.compat import (
    flax_variables,
    import_weights_by_name,
    load_flax_variables,
)
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import _flax_to_state_dict
from jpeg_detection_resnet_ssd_torch.losses import l2_regularization_loss
from jpeg_detection_resnet_ssd_torch.losses.classification import regularized_parameters
from jpeg_detection_resnet_ssd_torch.models import (
    MODEL_REGISTRY,
    layers,
    ssd_family,
    ssd_predictor_sizes,
)
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer

from torch_cases import N_CLASSES, gt_batch
from torch_parity import float64_convs_as_matmuls, port_module, random_flax_variables


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module's full-size models, and the
    process's count back afterwards: set at import, the count would hold
    for every module that pytest collects after this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

NAMES = ["ssd300_deconv", "ssd300_up_sampling", "ssd300_cb5_only", "ssd300_y_cb4_cbcr_cb5",
         "ssd300_vgg", "ssd300_vgg_dct", "ssd300_vgg_dct_image"]
# Filter gradients a train step takes from B4 with `pallas_wgrad`: the 3x3
# stride-1 SAME convs (the stems' 3x3 bottleneck middles and stage 5's for
# the identical family, the VGG blocks' convs) and the 6 head convs.
B4_CONVS = {"ssd300_deconv": 20, "ssd300_up_sampling": 20, "ssd300_cb5_only": 15,
            "ssd300_y_cb4_cbcr_cb5": 20, "ssd300_vgg": 19, "ssd300_vgg_dct": 13,
            "ssd300_vgg_dct_image": 12}
N_ROWS = {"resnet_identical": 6716, "vgg": 8732, "vgg_dct": 8732, "vgg_dct_image": 8732}

_CASES = {}


def as_torch(inputs):
    if isinstance(inputs, tuple):
        return tuple(torch.from_numpy(a) for a in inputs)
    return torch.from_numpy(inputs)


def case(name):
    """(inputs, flax variables, JAX eval output, JAX train output, JAX
    updated batch_stats, port model) at batch 1, made once per module."""
    if name not in _CASES:
        module, example = jax_build_model(name, n_classes=N_CLASSES)
        inputs = example(np.random.default_rng(len(name)))
        inputs = tuple(a[:1] for a in inputs) if isinstance(inputs, tuple) else inputs[:1]
        variables = random_flax_variables(module, inputs, train=False, seed=3)
        ev = module.apply(variables, inputs, train=False)
        tr, mutated = module.apply(variables, inputs, train=True, mutable=["batch_stats"])
        stats = _flax_to_state_dict({"batch_stats": jax.device_get(mutated.get("batch_stats", {}))})
        _CASES[name] = (inputs, variables, np.asarray(ev), np.asarray(tr), stats,
                        port_module(name, variables, n_classes=N_CLASSES))
    return _CASES[name]


def assert_output_close(got, ref):
    """The output within 1e-4 of its largest value, the scores within 1e-3."""
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    n_total = N_CLASSES + 1
    np.testing.assert_allclose(got[..., :n_total], ref[..., :n_total], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    inputs, _, ref, _, _, port = case(name)
    with torch.no_grad():
        got = port.eval()(as_torch(inputs)).numpy()
    assert_output_close(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_train_forward_and_statistics_match_jax(name):
    inputs, variables, _, ref, stats, port = case(name)
    with torch.no_grad():
        got = port.train()(as_torch(inputs)).numpy()
    moved = {k: v.clone() for k, v in port.eval().state_dict().items()}
    load_flax_variables(port, variables)  # back to the statistics JAX started from
    assert_output_close(got, ref)
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    for key, want in stats.items():
        np.testing.assert_allclose(moved[key].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_output_rows_are_the_familys_anchors(name):
    _, _, ref, _, _, _ = case(name)
    family = ssd_family(name)
    sizes = ssd_predictor_sizes(family)
    assert sizes == jax_predictor_sizes(family)
    assert ref.shape[1] == build_anchors(AnchorSpec(), sizes).shape[0] == N_ROWS[family]


@pytest.mark.parametrize("name", ["ssd300_ssd_custom", *NAMES])
def test_selective_l2_matches_jax(name):
    if name in _CASES:
        variables, port = case(name)[1], case(name)[5]
    else:
        module, example = jax_build_model(name, n_classes=N_CLASSES)
        variables = random_flax_variables(module, tuple(a[:1] for a in example()), train=False)
        port = port_module(name, variables, n_classes=N_CLASSES)
    selected = {"/".join(str(p.key) for p in path)
                for path, _ in jax.tree_util.tree_leaves_with_path(variables["params"])
                if default_ssd_reg_filter(tuple(str(p.key) for p in path))}
    got = {key.rsplit(".", 1)[0].replace(".", "/") + "/kernel"
           for key, _ in regularized_parameters(port)}
    assert got == selected and len(got) >= 18
    want = float(jax_l2(variables["params"], 5e-4))
    with torch.no_grad():
        np.testing.assert_allclose(float(l2_regularization_loss(port, 5e-4)), want, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_switch_routes_the_eligible_convs(monkeypatch, name):
    """With `pallas_wgrad` on, exactly the B4_CONVS convs go through the
    Function whose dW is B4 (recorded in a forward); the dilated fc6, the
    8x8 stride-8 stem and the VALID extras stay on the library's conv."""
    inputs, _, _, _, _, port = case(name)
    calls = []
    real = layers.conv3x3_same_wgrad

    def record(x, weight):
        calls.append(tuple(weight.shape[:2]))
        return real(x, weight)

    monkeypatch.setattr(layers, "conv3x3_same_wgrad", record)
    with torch.no_grad(), layers.pallas_wgrad(True):
        port.eval()(as_torch(inputs))
    assert len(calls) == B4_CONVS[name]


def test_h5_import_of_unsuffixed_conf_names(tmp_path):
    """`ssd300_vgg`'s conf layers are `{source}_mbox_conf`: a Keras H5 of
    the JAX variables loads every layer into the port, bit for bit."""
    _, variables, _, _, _, want = case("ssd300_vgg")
    path = str(tmp_path / "ssd300_vgg.h5")
    layers_written = export_keras_h5(variables, path)
    assert "fc7_mbox_conf" in layers_written and "conv4_3_norm" in layers_written
    with torch.device("meta"):
        port, _ = MODEL_REGISTRY["ssd300_vgg"](n_classes=N_CLASSES)
    port = port.to_empty(device="cpu")
    _, report = import_weights_by_name(port, path)
    os.remove(path)
    assert sorted(report["loaded"]) == sorted(layers_written)
    assert not report["skipped"] and not report["mismatched"]
    ref = want.state_dict()
    for key, tensor in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(tensor, ref[key]), key
    assert set(flax_variables(port)["params"]["head"]) == set(variables["params"]["head"])


LR = 1e-3


@pytest.fixture(scope="module")
def vgg_dct_step_f64():
    """One float64 train step of `ssd300_vgg_dct` at batch 1 in both
    packages, from the same weights and batch."""
    with jax.enable_x64(True), float64_convs_as_matmuls():
        rng = np.random.default_rng(31)
        y = rng.normal(0, 100, (1, 38, 38, 64)).astype(np.float32)
        cbcr = rng.normal(0, 30, (1, 19, 19, 128)).astype(np.float32)
        gt, mask = gt_batch(rng, [4])
        batch = {"inputs": (y, cbcr), "gt": gt, "gt_mask": mask}
        sizes = ssd_predictor_sizes("vgg_dct")
        module, _ = jax_build_model("ssd300_vgg_dct", n_classes=N_CLASSES, dtype=jnp.float64)
        variables = random_flax_variables(module, (y, cbcr), train=False, seed=5)
        encoder = JaxTargetEncoder(JaxAnchorSpec(), sizes, n_classes=N_CLASSES, bipartite_impl="xla")
        tx = jax_build_optimizer(JaxConfig(compute_dtype="float32", learning_rate=LR))
        trainer = JaxTrainer(model=module, loss_fn=jax_loss_fn(JaxSSDLoss(), 5e-4), optimizer=tx,
                             mesh=None, donate=False, target_encoder=encoder.encode_fn)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        new_state, metrics = jax.jit(trainer._step)(state, batch, jax.random.PRNGKey(1))
        ref = {"metrics": {k: float(v) for k, v in metrics.items()},
               "grads": _flax_to_state_dict({"params": jax.device_get(new_state.opt_state[0].trace)})}

    port, model, _ = build_trainer(
        ExperimentConfig(model="ssd300_vgg_dct", compute_dtype="float32", learning_rate=LR,
                         model_kwargs={"n_classes": N_CLASSES, "dtype": torch.float64}),
        target_encoder=TargetEncoder(AnchorSpec(), sizes, n_classes=N_CLASSES, device="cpu"),
        device="cpu")
    load_flax_variables(model, variables)
    metrics = port.train_step(batch)
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: p.grad.numpy() for k, p in model.named_parameters()}}
    return ref, got


def test_float64_step_loss_matches_jax(vgg_dct_step_f64):
    ref, got = vgg_dct_step_f64
    assert set(got["metrics"]) == set(ref["metrics"]) == {"loss", "reg", "total_loss"}
    for key in ("loss", "total_loss"):
        np.testing.assert_allclose(got["metrics"][key], ref["metrics"][key], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["reg"], ref["metrics"]["reg"], rtol=1e-6)


def test_float64_step_gradients_match_jax(vgg_dct_step_f64):
    ref, got = vgg_dct_step_f64
    assert set(got["grads"]) == set(ref["grads"])
    dead = []
    for key, want in ref["grads"].items():
        scale = np.abs(want).max()
        # 0 at this init: an extra block on a 3x3 or 1x1 map whose relus are
        # all off, or a head layer with no matched anchor and no mined negative
        if scale == 0:
            dead.append(key)
            assert not got["grads"][key].any(), key
        np.testing.assert_allclose(got["grads"][key], want, rtol=0, atol=1e-3 * scale, err_msg=key)
    assert len(dead) < len(ref["grads"]) // 3, dead

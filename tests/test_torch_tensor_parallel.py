"""Tensor parallelism of the PyTorch port (ROADMAP A13b) on the CPU.

Two or four gloo ranks, each a process started here
(`tests/torch_dp_worker.py`, a file store under the test's tmp dir), step on
a (data, model) mesh whose model axis shards every conv or dense kernel of
at least `min_features` outputs; the same case run in this process without
a process group is the single-process step on the global batch.  What must
hold: the metrics within 1e-5 of the loss, every parameter, BatchNorm
statistic and momentum within 1e-5 of the largest parameter value, the
ranks bit-identical to each other, sharded weights and their momentum the
rank's slice.  Against the JAX package: `make_mesh`'s model-minor grid,
`param_shardings`' model-axis leaves on the full models, and the
`Trainer(tp_rule=tensor_parallel_rule)` step on a 1x2 mesh of conftest's
CPU devices.
"""

import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import torch_dp_worker as worker
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.parallel import mesh as jax_mesh
from jpeg_detection_resnet_ssd_tpu.train import Trainer as JaxTrainer
from jpeg_detection_resnet_ssd_tpu.train import detection_loss_fn as jax_detection_loss_fn
from jpeg_detection_resnet_ssd_torch.cli import main as port_cli
from jpeg_detection_resnet_ssd_torch.compat import flax_variables
from jpeg_detection_resnet_ssd_torch.models.zoo import MODEL_REGISTRY
from jpeg_detection_resnet_ssd_torch.parallel import Mesh, make_mesh, model_shards, shard_parameters
from jpeg_detection_resnet_ssd_torch.train import CheckpointManager, ExperimentConfig, build_trainer

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The single-process references run at 1 thread (at 2 the CPU's float32
    kernels are not bit-reproducible from run to run); restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def ranks(tmp_path):
    """run(case, world=2, **kwargs) -> the results of `world` worker
    processes (`torch_dp_worker.run_ranks`); children still alive at
    teardown are killed."""
    procs = []
    yield lambda case, **kwargs: worker.run_ranks(case, tmp_path, procs, **kwargs)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def assert_ranks_equal_one_process(results, ref):
    """Metrics within TOL of the loss and bit-identical on every rank; the
    whole state and momentum within TOL of the largest parameter, ranks
    bit-identical."""
    scale = ref["metrics"]["total_loss"].abs().max()
    for r in results:
        for k, v in ref["metrics"].items():
            assert (r["metrics"][k] - v).abs().max() <= TOL * scale, (k, r["metrics"][k], v)
            assert torch.equal(r["metrics"][k], results[0]["metrics"][k]), k
    assert_state_equals_one_process(results, ref)


def assert_state_equals_one_process(results, ref, parts=("state", "momentum")):
    """The whole state and momentum within TOL of the largest parameter,
    the ranks bit-identical."""
    largest = max(float(v.abs().max()) for v in ref["state"].values() if v.is_floating_point())
    for part in parts:
        for key, want in ref[part].items():
            got = [r[part][key] for r in results]
            assert all(torch.equal(got[0], g) for g in got[1:]), f"{part} {key} differs between ranks"
            if want.is_floating_point():
                err = float((got[0].float() - want.float()).abs().max())
                assert err <= TOL * largest, (part, key, err)
            else:
                assert torch.equal(got[0], want), key


# TinyTPSSD at min_features=32 over 2 model ranks: (key, local output features).
TINY_SHARDED = {"conv_y.weight": 16, "fc6.weight": 16, "a_mbox_pred.weight": 50,
                "b_mbox_pred.weight": 50}


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_make_mesh_is_the_jax_model_minor_grid(ranks, n_model):
    """4 ranks: each rank's (data, model) indices and the members of its
    data and model groups are its cell, column and row of JAX's
    `make_mesh(4 // n_model, n_model)` grid (device r is rank r); a mesh
    of 3 x n_model over 4 processes raises."""
    grid = jax_mesh.make_mesh(n_data=4 // n_model, n_model=n_model,
                              devices=jax.devices()[:4]).devices
    ids = np.vectorize(lambda d: d.id)(grid)
    results = ranks("mesh", world=4, n_model=n_model, bad_n_data=3)
    for r, res in enumerate(results):
        (i,), (j,) = np.nonzero(ids == r)
        assert res["shape"] == {"data": 4 // n_model, "model": n_model}
        assert (res["rank"], res["data_index"], res["model_index"]) == (r, i, j)
        assert res["data_group"] == ids[:, j].tolist()
        assert res["model_group"] == ids[i].tolist()
        assert res["error"] == f"mesh 3x{n_model} != 4 processes"


def _jax_model_axis_leaves(name, n_model, **kwargs):
    module, example = jax_build_model(name, **kwargs)
    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x, train=False),
                            example())["params"]
    mesh = jax_mesh.make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    shardings = jax_mesh.param_shardings(mesh, shapes, jax_mesh.tensor_parallel_rule)
    leaves = {}
    for (path, sharding), leaf in zip(jax.tree_util.tree_leaves_with_path(shardings),
                                      jax.tree_util.tree_leaves(shapes)):
        if jax_mesh.MODEL_AXIS in tuple(sharding.spec):
            leaves[tuple(p.key for p in path)] = leaf.shape
    return leaves


@pytest.mark.parametrize("n_model", [2, 3])
@pytest.mark.parametrize("name,kwargs,n_leaves,n_sharded", [
    ("ssd300_ssd_custom", {"n_classes": 20}, 13, 27_262_976),
    ("resnet50_dct_late_concat_rfa_thinner", {"num_classes": 1000}, 11, 7_340_032),
], ids=["ssd_custom", "resnet50_dct"])
def test_sharded_leaves_are_param_shardings_model_axis_leaves(name, kwargs, n_leaves, n_sharded,
                                                              n_model):
    """`shard_parameters` on the port's full model (built on the meta device,
    model index 1 of `n_model`) shards exactly the leaves JAX's
    `param_shardings` puts on the model axis, each to its slice of output
    features; at 3 model ranks no 1024- or 2048-wide axis divides, so every
    leaf stays replicated."""
    want = _jax_model_axis_leaves(name, n_model, **kwargs)
    with torch.device("meta"):
        module, _ = MODEL_REGISTRY[name](**kwargs)
    full = {k: tuple(v.shape) for k, v in module.named_parameters()}
    shard_parameters(module, Mesh({"data": 1, "model": n_model}, 1))
    shards = model_shards(module)
    got = {tuple(k.split(".")[:-1]) + ("kernel",) for k in shards}
    assert got == set(want)
    if n_model == 3:
        assert not shards
        return
    assert len(shards) == n_leaves
    assert sum(int(np.prod(full[k])) for k in shards) == n_sharded
    for key, shard in shards.items():
        local = tuple(module.get_parameter(key).shape)
        assert shard.axis == 0 and shard.index == 1 and shard.size == n_model
        assert local == (full[key][0] // n_model, *full[key][1:])
        assert full[key][0] == want[tuple(key.split(".")[:-1]) + ("kernel",)][-1]


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_detection_step_equals_one_process_on_the_global_batch(ranks, n_data, n_model):
    """3 steps of `TinyTPSSD` (B4-eligible conv, `_FC6CenterTap` and heads
    sharded; the B4 route on its plain version) through the v3 device
    augment, B2's plain version, the SSD loss's mining and the L2 penalty,
    on n_data x n_model ranks, against one process on the global batch."""
    results = ranks("detect", world=n_data * n_model, tp=True, n_model=n_model)
    ref = worker.detect_steps(tp=True)
    assert ref["metrics"]["reg"].min() > 0
    assert_ranks_equal_one_process(results, ref)
    for key, local in TINY_SHARDED.items():
        assert results[0]["shapes"]["weights"][key][0] == local, key


@pytest.mark.parametrize("min_features", [1024, 512])
def test_tp_ssd_custom_step_equals_one_process(ranks, min_features):
    """One f32 step of the full `ssd300_ssd_custom` at a global batch of 2 on
    a 1x2 mesh, the B4 route on (its plain version here): at the default
    rule `fc6` (its center tap) and the other 12 leaves of >= 1024 outputs
    are sharded; at 512 also stage 5's 3x3 512->512 convs, whose filter
    gradient is then taken on 256-column output slices."""
    results = ranks("ssd_custom", pallas_wgrad=True, n_model=2, min_features=min_features)
    ref = worker.ssd_custom_step(pallas_wgrad=True)
    assert float(ref["metrics"]["loss"][0]) > 0
    assert_ranks_equal_one_process(results, {**ref, "momentum": {}})
    half = {1024: 27_262_976, 512: 37_158_912}[min_features] // 2
    assert all(r["n_params"] == ref["n_params"] - half for r in results)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_replicated_gradients_are_model_index_0s(ranks, n_data, n_model):
    """With a different error added to the replicated gradients of each
    model index (as the card's nondeterministic library kernels add one in
    the last bits), the replicas stay bit-identical and take model index
    0's step, which carries none: one process's."""
    results = ranks("detect", world=n_data * n_model, tp=True, n_model=n_model, noise=1e-3)
    assert_ranks_equal_one_process(results, worker.detect_steps(tp=True))


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_classification_step_with_dropout_equals_one_process(ranks, n_data, n_model):
    """3 Nesterov steps of a Conv + BatchNorm + Dropout + Dense classifier
    with the conv and the Dense kernel sharded: dropout's masks are drawn
    for the global batch, the same on a model group's ranks."""
    results = ranks("classify", world=n_data * n_model, n_model=n_model)
    ref = worker.classify_steps()
    assert_ranks_equal_one_process(results, ref)
    assert results[0]["shapes"]["weights"]["fc.weight"] == (5, 32)
    assert results[0]["shapes"]["weights"]["conv.weight"] == (16, 192, 3, 3)


@pytest.mark.parametrize("momentum_dtype", ["float32", "bfloat16"])
def test_sharded_momentum_holds_the_local_slice(ranks, momentum_dtype):
    """After 1x2 steps the SGD momentum (and `BF16MomentumSGD`'s bf16
    trace) of a sharded kernel has the rank's slice's shape, a replicated
    one the full shape; gathered, it is one process's momentum.  The bf16
    trace takes one step: its rounding turns a float32 difference at a
    rounding boundary into one bf16 step, up to 2^-8 of the largest trace
    value, so it is held to that and the parameters (updated in float32)
    to TOL."""
    steps = 3 if momentum_dtype == "float32" else 1
    results = ranks("detect", tp=True, n_model=2, momentum_dtype=momentum_dtype, steps=steps)
    ref = worker.detect_steps(tp=True, momentum_dtype=momentum_dtype, steps=steps)
    want_dtype = torch.bfloat16 if momentum_dtype == "bfloat16" else torch.float32
    for r in results:
        shapes = r["shapes"]
        assert shapes["momentum"] == shapes["weights"]
        assert set(shapes["momentum_dtype"].values()) == {want_dtype}
        for key, full in ref["shapes"]["weights"].items():
            local = shapes["weights"][key]
            if key in TINY_SHARDED:
                assert local == (TINY_SHARDED[key], *full[1:]), key
            else:
                assert local == full, key
    if momentum_dtype == "float32":
        assert_ranks_equal_one_process(results, ref)
        return
    assert_state_equals_one_process(results, ref, parts=("state",))
    largest = max(float(v.float().abs().max()) for v in ref["momentum"].values())
    for key, want in ref["momentum"].items():
        got = results[0]["momentum"][key].float()
        assert float((got - want.float()).abs().max()) <= 2**-8 * largest, key


class JaxWideDetector(fnn.Module):
    """The JAX trainer test's `TinyDetector` (`tests/test_trainer.py`):
    a 1024-wide `fc6` that the default rule shards."""

    n_classes: int = 3
    n_boxes: int = 32

    @fnn.compact
    def __call__(self, inputs, train: bool = False):
        y, cbcr = inputs
        x = fnn.relu(fnn.Conv(1024, (3, 3), name="fc6")(y))
        x = jnp.mean(x, axis=(1, 2))
        out = fnn.Dense(self.n_boxes * (self.n_classes + 1 + 4), name="head")(x)
        out = out.reshape(x.shape[0], self.n_boxes, -1)
        conf = jax.nn.softmax(out[..., : self.n_classes + 1])
        loc = out[..., self.n_classes + 1:]
        anchors = jnp.ones(loc.shape[:-1] + (8,), loc.dtype) * 0.1
        return jnp.concatenate([conf, loc, anchors], axis=-1)


def test_tp_step_equals_the_jax_tp_rule_step(ranks, tmp_path):
    """2 steps (SGD 1e-3, momentum 0.9, SSD loss + L2) of the JAX
    `Trainer(tp_rule=tensor_parallel_rule)` on a 1x2 mesh of CPU devices
    and of the port on 2 gloo ranks (a 1x2 mesh) from the same weights
    (`compat.flax_bridge`): losses within 1e-5 and the updated kernels
    within 1e-5 of the largest."""
    rng = np.random.default_rng(3)
    b, n, c = 4, 32, 3
    y = rng.normal(0, 1, (b, 12, 12, 16)).astype(np.float32)
    cbcr = rng.normal(0, 1, (b, 6, 6, 32)).astype(np.float32)
    targets = np.zeros((b, n, c + 1 + 12), np.float32)
    targets[..., 0] = 1.0
    for i in range(b):
        idx = rng.integers(0, n, 3)
        targets[i, idx, 0] = 0.0
        targets[i, idx, 1 + rng.integers(0, c)] = 1.0
    targets[..., -4:] = [0.1, 0.1, 0.2, 0.2]
    mesh = jax_mesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    trainer = JaxTrainer(model=JaxWideDetector(), loss_fn=jax_detection_loss_fn(l2_scale=5e-4),
                         optimizer=optax.sgd(1e-3, momentum=0.9), mesh=mesh,
                         tp_rule=jax_mesh.tensor_parallel_rule, donate=False)
    with mesh:
        state = trainer.init_state(jax.random.PRNGKey(0), (y[:1], cbcr[:1]))
        assert state.params["fc6"]["kernel"].sharding.spec[-1] == "model"
        init = jax.tree_util.tree_map(np.asarray, state.params)
        batch = {"inputs": (y, cbcr), "targets": targets}
        batch = jax.device_put(batch, trainer.batch_shardings(batch))
        losses = []
        for _ in range(2):
            state, metrics = trainer.train_step(state, batch, jax.random.PRNGKey(1))
            losses.append({k: float(v) for k, v in metrics.items()})
    final = jax.tree_util.tree_map(np.asarray, state.params)
    variables, data = tmp_path / "variables.npz", tmp_path / "batch.npz"
    np.savez(variables, **{f"params/{layer}/{leaf}": v for layer, leaves in init.items()
                           for leaf, v in leaves.items()})
    np.savez(data, y=y, cbcr=cbcr, targets=targets)

    results = ranks("wide", variables=str(variables), batch=str(data), n_model=2)
    largest = max(float(np.abs(v).max()) for leaves in final.values() for v in leaves.values())
    for r in results:
        assert r["shapes"]["weights"]["fc6.weight"] == (512, 16, 3, 3)
        for step, want in enumerate(losses):
            for k in ("loss", "reg", "total_loss"):
                got = float(r["metrics"][k][step])
                assert abs(got - want[k]) <= TOL * abs(want["total_loss"]), (step, k, got, want[k])
        pairs = [(r["state"]["fc6.weight"].numpy().transpose(2, 3, 1, 0), final["fc6"]["kernel"]),
                 (r["state"]["head.weight"].numpy().T, final["head"]["kernel"]),
                 (r["state"]["fc6.bias"].numpy(), final["fc6"]["bias"])]
        for got, want in pairs:
            assert np.abs(got - want).max() <= TOL * largest


def _tiny_tp_trainer():
    """A one-process trainer of `tiny_tp_ssd` (whole kernels)."""
    config = ExperimentConfig(model="tiny_tp_ssd", compute_dtype="float32", learning_rate=0.05,
                              model_kwargs={})
    with worker.tiny_models():
        trainer, _, _ = build_trainer(config, device="cpu", mesh=make_mesh())
    return trainer


def test_tp_fit_checkpoint_loads_into_one_process(ranks, tmp_path):
    """`fit` on a 1x2 mesh (2 epochs of one step): world rank 0 alone saves;
    its checkpoint holds whole tensors, which restore into a one-process
    trainer equal to the ranks' gathered parameters and momentum; the run
    equals one process's `fit`."""
    tp = ranks("fit", run_dir=str(tmp_path / "tp"), epochs=2, model="tiny_tp_ssd", n_model=2)
    assert tp[0]["saves"] == [1, 2] and tp[1]["saves"] == []
    trainer = _tiny_tp_trainer()
    CheckpointManager(str(tmp_path / "tp" / "checkpoints")).restore(trainer)
    assert trainer.step == 2 and not model_shards(trainer.model)
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, tp[0]["state"][key]), key
    for key, p in trainer.model.named_parameters():
        assert torch.equal(trainer.optimizer.state[p]["momentum_buffer"], tp[0]["momentum"][key]), key
    one = worker.fit_run(str(tmp_path / "one"), epochs=2, model="tiny_tp_ssd")
    for r in tp:
        for got, want in zip(r["history"], one["history"]):
            assert abs(got["total_loss"] - want["total_loss"]) <= TOL * abs(want["total_loss"])
    assert_state_equals_one_process(tp, one)


def test_one_process_checkpoint_resumes_under_tp(ranks, tmp_path):
    """A one-process run's checkpoint after 2 steps, resumed on a 1x2 mesh
    for a third: each rank keeps its slices of the weights and momentum,
    and the step is the uninterrupted one-process run's third."""
    worker.fit_run(str(tmp_path / "part"), epochs=2, model="tiny_tp_ssd")
    resumed = ranks("fit", run_dir=str(tmp_path / "part"), epochs=3, restart=True,
                    model="tiny_tp_ssd", n_model=2)
    whole = worker.fit_run(str(tmp_path / "whole"), epochs=3, model="tiny_tp_ssd")
    for r in resumed:
        assert [h["step"] for h in r["history"]] == [3]
        assert r["shapes"]["weights"]["fc6.weight"][0] == TINY_SHARDED["fc6.weight"]
    want = whole["history"][-1]["total_loss"]
    for r in resumed:
        assert abs(r["history"][-1]["total_loss"] - want) <= TOL * abs(want)
    assert_state_equals_one_process(resumed, whole)


def test_a_sharded_module_is_not_taken_for_the_whole_model():
    """`flax_variables` and `load_flax_variables` refuse a module holding
    slices of its kernels, rather than read or fill a slice as a kernel."""
    from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables

    module = worker.TinyTPSSD(generator=torch.Generator().manual_seed(0))
    variables = flax_variables(module)
    shard_parameters(module, Mesh({"data": 1, "model": 2}, 0), worker._rule(32))
    assert set(model_shards(module)) == set(TINY_SHARDED)
    with pytest.raises(ValueError, match="slice of their kernel over the model axis"):
        flax_variables(module)
    with pytest.raises(ValueError, match="slice of their kernel over the model axis"):
        load_flax_variables(module, variables)


def test_train_detect_cli_with_two_model_shards(tmp_path):
    """`train-detect --device cpu --n-model-shards 2` under the environment
    `torchrun` sets for two processes (a 1x2 mesh: each rank steps on the
    whole `--batch-size`), then `--restart`; world rank 0 alone prints and
    checkpoints, and the checkpoint restores in one process (the CLI's
    `evaluate`/`export` path) with whole kernels."""
    from chip_smoke import write_detect_inputs

    voc, stem = write_detect_inputs(str(tmp_path), n=8)
    cfg = tmp_path / "f32.json"
    cfg.write_text(ExperimentConfig(compute_dtype="float32", batch_size=2, num_workers=1,
                                    model_kwargs={"n_classes": 20}).to_json())
    argv = [sys.executable, "-m", "jpeg_detection_resnet_ssd_torch.cli", "train-detect",
            "--voc-root", voc, "--device-augment", "--pack-cache", stem, "--config", str(cfg),
            "--steps-per-epoch", "2", "--output-dir", str(tmp_path / "exp"), "--device", "cpu",
            "--n-model-shards", "2"]
    outs = []
    try:
        worker.run_cli_ranks(argv, tmp_path, outs)
        (run_dir, first), (again, second) = outs
        assert again == run_dir and (first["step"], second["step"]) == (2, 4)
        assert np.isfinite(first["total_loss"]) and np.isfinite(second["total_loss"])
        run_dir = Path(run_dir.split(": ", 1)[1])
        assert sorted(os.listdir(run_dir / "checkpoints")) == ["ckpt_00000002.pt",
                                                               "ckpt_00000004.pt"]
        config = ExperimentConfig.load(str(run_dir / "saved_config.json"))
        assert config.n_model_shards == 2
        trainer, module, _ = port_cli._restore_run(config, str(run_dir), "cpu")
        assert trainer.step == 4 and not model_shards(module)
        assert module.fc6.weight.shape == (1024, 2048, 3, 3)
        assert all(torch.isfinite(p).all() for p in module.parameters())
    finally:  # ~0.4 GB a checkpoint
        shutil.rmtree(tmp_path / "exp", ignore_errors=True)

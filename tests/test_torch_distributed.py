"""Data parallelism of the PyTorch port (ROADMAP A13a) on the CPU.

Two gloo ranks, each a process started here (`tests/torch_dp_worker.py`,
a file store under the test's tmp dir, so nothing listens on a port), step
on their rows of a global batch; the same case run in this process without
a process group is the single-process step on the global batch.  What must
hold: the metrics within 1e-5 of the loss, every parameter and BatchNorm
statistic within 1e-5 of the largest parameter value, and the two ranks
bit-identical to each other.  The warmup schedule and the tensor-parallel
rule are compared with the JAX package's.
"""

import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.parallel import mesh as jax_mesh
from jpeg_detection_resnet_ssd_tpu.train import loop as jax_loop
from jpeg_detection_resnet_ssd_tpu.train.config import ExperimentConfig as JaxConfig
from jpeg_detection_resnet_ssd_torch.losses.ssd_loss import top_k_sum
from jpeg_detection_resnet_ssd_torch.parallel import (
    Mesh,
    active_mesh,
    data_parallel,
    make_mesh,
    scale_learning_rate,
    shard_batch,
    tensor_parallel_rule,
)
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer, fit
from jpeg_detection_resnet_ssd_torch.utils import (
    is_primary_process,
    maybe_initialize_distributed,
    process_count,
    process_index,
)

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
    """run(case, **kwargs) -> the results of 2 worker processes
    (`torch_dp_worker.run_ranks`); children still alive at teardown are
    killed."""
    procs = []
    yield lambda case, **kwargs: worker.run_ranks(case, tmp_path, procs, **kwargs)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def assert_ranks_equal_one_process(results, ref):
    """Metrics within TOL of the loss, state within TOL of the largest
    parameter, ranks bit-identical."""
    for r in results:
        for k, v in ref["metrics"].items():
            scale = ref["metrics"]["total_loss"].abs().max()
            assert (r["metrics"][k] - v).abs().max() <= TOL * scale, (k, r["metrics"][k], v)
    largest = max(float(v.abs().max()) for v in ref["state"].values() if v.is_floating_point())
    for key, want in ref["state"].items():
        got = [r["state"][key] for r in results]
        assert all(torch.equal(got[0], g) for g in got[1:]), f"{key} differs between ranks"
        if want.is_floating_point():
            assert float((got[0] - want).abs().max()) <= TOL * largest, key
        else:
            assert torch.equal(got[0], want), key


@pytest.mark.parametrize("n_valid", [[2, 2, 2, 2], [3, 1, 0, 0]],
                         ids=["objects_in_every_row", "no_objects_on_rank_1"])
def test_detection_step_equals_one_process_on_the_global_batch(ranks, n_valid):
    """3 steps of a Conv + BatchNorm detector through the v3 device augment,
    the target encoder, the SSD loss's mining and the L2 penalty; in the
    second case rank 1's rows hold no objects."""
    results = ranks("detect", n_valid=n_valid)
    ref = worker.detect_steps(n_valid=n_valid)
    assert ref["metrics"]["reg"].min() > 0
    assert_ranks_equal_one_process(results, ref)
    # the ranks report the global metrics, not their own rows'
    for r in results:
        assert torch.equal(r["metrics"]["total_loss"], results[0]["metrics"]["total_loss"])


def test_ssd_custom_step_equals_one_process_on_the_global_batch(ranks):
    """One f32 step of the full `ssd300_ssd_custom` at a global batch of 2
    (1 row a rank: every BatchNorm normalises over the two ranks' rows)."""
    results = ranks("ssd_custom")
    ref = worker.ssd_custom_step()
    assert float(ref["metrics"]["loss"][0]) > 0
    assert_ranks_equal_one_process(results, ref)


def test_hard_negative_mining_spans_the_ranks(ranks):
    """Rank 1's rows hold no positive and the threshold falls in a group of
    ties on both ranks: the ranks' shares sum to the single-process loss
    and their gradients are the single-process gradient's rows, exactly."""
    y_true, y_pred = worker.mining_problem()
    cls_neg = -np.log(y_pred[..., 0]) * y_true[..., 0]
    k = 3 * int(y_true[..., 1:-12].max(-1).sum())
    t = np.sort(cls_neg.reshape(-1))[::-1][k - 1]
    ties = cls_neg == t
    assert ties[:2].any() and ties[2:].any() and k - (cls_neg > t).sum() < ties.sum()
    assert not y_true[2:, :, 1:-12].any()
    results = ranks("mining")
    ref = worker.mining_loss()
    total = sum(float(r["loss"]) for r in results)
    assert abs(total - float(ref["loss"])) <= TOL * abs(float(ref["loss"]))
    assert torch.equal(torch.cat([r["grad"] for r in results]), ref["grad"])
    # the process-group helpers, inside a rank
    for rank, r in enumerate(results):
        assert r["dist"] == {"again": True, "index": rank, "count": 2, "primary": rank == 0}


def test_classification_step_with_dropout_equals_one_process(ranks):
    """3 Nesterov steps of a Conv + BatchNorm + Dropout classifier: the
    masks are drawn for the global batch; loss, top-1 and top-5 global."""
    results = ranks("classify")
    ref = worker.classify_steps()
    assert_ranks_equal_one_process(results, ref)


def test_load_or_create_packs_on_rank_0_and_validates_everywhere(ranks, tmp_path):
    from torch_cases import write_voc_tree

    voc = tmp_path / "voc"
    write_voc_tree(voc, 3, seed=4, image_set="trainval.txt")
    stem = str(tmp_path / "pack" / "corpus")
    results = ranks("pack", stem=stem, voc_root=str(voc))
    assert [r["packed_here"] for r in results] == [True, False]
    assert [r["n"] for r in results] == [3, 3]
    np.testing.assert_array_equal(results[0]["y0"], results[1]["y0"])
    # a rank that finds the cache packs nothing
    again = ranks("pack", stem=stem, voc_root=str(voc))
    assert [r["packed_here"] for r in again] == [False, False]


def test_fit_checkpoints_on_rank_0_and_restart_equals_the_uninterrupted_run(ranks, tmp_path):
    """`fit` with a run dir: rank 0 alone saves and logs; both ranks restore,
    and 3 epochs + `restart` to 6 equal 6 epochs without a break."""
    whole, part = tmp_path / "whole", tmp_path / "part"
    full = ranks("fit", run_dir=str(whole), epochs=6)
    assert full[0]["saves"] == [1, 2, 3, 4, 5, 6] and full[1]["saves"] == []
    with open(whole / "results" / "results.csv") as f:
        assert len(f.read().splitlines()) == 1 + 6
    ranks("fit", run_dir=str(part), epochs=3)
    resumed = ranks("fit", run_dir=str(part), epochs=6, restart=True)
    assert resumed[0]["saves"] == [4, 5, 6] and resumed[1]["saves"] == []
    for r in range(2):
        assert [h["step"] for h in resumed[r]["history"]] == [4, 5, 6]
        for key, want in full[r]["state"].items():
            assert torch.equal(resumed[r]["state"][key], want), key
        assert resumed[r]["history"][-1] == {**full[r]["history"][-1],
                                             "time_s": resumed[r]["history"][-1]["time_s"]}


@pytest.mark.parametrize("n_replicas", [1, 2, 4])
def test_warmup_schedule_scales_with_the_mesh(n_replicas):
    """`build_trainer` on a mesh of P ranks: the warmup lr of JAX's
    `_make_schedule(config, P)`, for the schedule and the first lr."""
    kw = dict(learning_rate=0.1, warmup_epochs=2, steps_per_epoch=5, lr_decay=1e-3)
    ref = jax_loop._make_schedule(JaxConfig(**kw), n_replicas)
    mesh = Mesh({"data": n_replicas, "model": 1}, 0, None)
    with worker.tiny_models():
        trainer, _, _ = build_trainer(ExperimentConfig(model="tiny_ssd", model_kwargs={}, **kw),
                                      device="cpu", mesh=mesh)
    for step in (0, 1, 4, 9, 10, 11, 50):
        np.testing.assert_allclose(trainer.schedule(step), float(ref(step)), rtol=1e-6)
    np.testing.assert_allclose(trainer.optimizer.param_groups[0]["lr"], float(ref(0)), rtol=1e-6)
    assert scale_learning_rate(0.1, n_replicas) == jax_mesh.scale_learning_rate(0.1, n_replicas)


def test_tensor_parallel_rule_matches_jax():
    """On every leaf of `ssd300_ssd_custom`'s parameter shapes (JAX's from
    `jax.eval_shape`, nothing computed)."""
    module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x, train=False),
                            example())["params"]
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    sharded = {1024: 0, 256: 0}
    for path, leaf in leaves:
        keys = tuple(getattr(p, "key", getattr(p, "name", str(p))) for p in path)
        for min_features in sharded:
            spec = tuple(jax_mesh.tensor_parallel_rule(keys, leaf, min_features))
            want = spec.index(jax_mesh.MODEL_AXIS) if jax_mesh.MODEL_AXIS in spec else None
            assert tensor_parallel_rule(keys, tuple(leaf.shape), min_features) == want, keys
            sharded[min_features] += want is not None
    assert len(leaves) > 100 and 0 < sharded[1024] < sharded[256]


def test_single_process_path_is_unchanged():
    """Without a process group the mesh is one rank, the reductions are the
    single-process code, and `fit` is bit-identical with or without a mesh."""
    mesh = make_mesh()
    assert (mesh.shape, mesh.rank, mesh.data_group) == ({"data": 1, "model": 1}, 0, None)
    with data_parallel(mesh):
        assert active_mesh() is None
    with data_parallel(Mesh({"data": 2, "model": 1}, 1, None)):
        assert active_mesh().rank == 1
    assert active_mesh() is None
    assert (process_index(), process_count(), is_primary_process()) == (0, 1, True)
    assert maybe_initialize_distributed() is False
    with pytest.raises(ValueError, match="2x1 != 1 processes"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="0x2 != 1 processes"):
        make_mesh(n_model=2)  # a 1x2 mesh needs two processes
    flat = torch.tensor([3.0, 1.0, 1.0, 1.0, 0.0, 2.0])
    assert torch.equal(top_k_sum(flat, torch.tensor(3.0), flat), top_k_sum(flat, torch.tensor(3.0)))
    rows = shard_batch({"x": np.arange(8).reshape(4, 2), "t": (torch.arange(4),), "n": 3},
                       Mesh({"data": 2, "model": 1}, 1, None))
    assert rows["x"].tolist() == [[4, 5], [6, 7]] and rows["t"][0].tolist() == [2, 3]
    assert rows["n"] == 3

    config = ExperimentConfig(model="tiny_ssd", compute_dtype="float32", batch_size=4, epochs=2,
                              steps_per_epoch=1, learning_rate=0.05, model_kwargs={})
    batches = worker.detection_batches(2, 4, 3)
    runs = []
    with worker.tiny_models():
        for m in (None, mesh):
            trainer, history = fit(config, batches, target_encoder=worker._encoder("cpu"),
                                   augment_fn=worker.ops.make_dct_detection_augment_v3(8, device="cpu"),
                                   device="cpu", mesh=m)
            runs.append((trainer.model.state_dict(), history))
    for key, want in runs[0][0].items():
        assert torch.equal(runs[1][0][key], want), key
    assert [h["total_loss"] for h in runs[0][1]] == [h["total_loss"] for h in runs[1][1]]


def test_a_world_size_without_a_rank_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="set RANK"):
        maybe_initialize_distributed()


def test_train_detect_cli_on_two_gloo_ranks(tmp_path):
    """`train-detect --device cpu` under the environment `torchrun` sets for
    two processes: each rank steps on its shard of the packed corpus at
    `--batch-size // 2` rows, rank 0 alone creates the run dir, prints and
    checkpoints, and `--restart` resumes on both ranks."""
    from chip_smoke import write_detect_inputs

    voc, stem = write_detect_inputs(str(tmp_path), n=8)
    cfg = tmp_path / "f32.json"
    cfg.write_text(ExperimentConfig(compute_dtype="float32", batch_size=2, num_workers=1,
                                    model_kwargs={"n_classes": 20}).to_json())
    argv = [sys.executable, "-m", "jpeg_detection_resnet_ssd_torch.cli", "train-detect",
            "--voc-root", voc, "--device-augment", "--pack-cache", stem, "--config", str(cfg),
            "--steps-per-epoch", "2", "--output-dir", str(tmp_path / "exp"), "--device", "cpu"]
    outs = []
    try:
        worker.run_cli_ranks(argv, tmp_path, outs)
        (run_dir, first), (again, second) = outs
        assert again == run_dir and (first["step"], second["step"]) == (2, 4)
        assert np.isfinite(first["total_loss"]) and np.isfinite(second["total_loss"])
        ckpts = Path(run_dir.split(": ", 1)[1]) / "checkpoints"
        assert sorted(os.listdir(ckpts)) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]
    finally:  # ~0.4 GB a checkpoint
        shutil.rmtree(tmp_path / "exp", ignore_errors=True)

"""The port's `bench` command on the CPU: the JAX command's keys plus the
device, and the parameter counts of the JAX package's models (their JAX
side from `jax.eval_shape`, so nothing is computed)."""

import json

import jax
import numpy as np
import pytest

from jpeg_detection_resnet_ssd_tpu.eval.imagenet_eval import count_params as jax_count_params
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.cli import main as port_cli


def _jax_params(name, **kw):
    module, example = jax_build_model(name, **kw)
    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x, train=False),
                            example())
    return jax_count_params(shapes["params"])


@pytest.mark.parametrize("model,kw,params", [
    ("ssd300_ssd_custom", {"n_classes": 20}, 51_984_110),
    ("resnet50_dct_late_concat_rfa_thinner", {"num_classes": 1000}, None),
])
def test_bench_prints_the_jax_keys_and_the_jax_parameter_count(capsys, model, kw, params):
    port_cli.main(["bench", "--model", model, "--batch-size", "1", "--runs", "1",
                   "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"model", "params", "batch_size", "images_per_sec", "device"}
    assert (row["model"], row["batch_size"], row["device"]) == (model, 1, "cpu")
    assert np.isfinite(row["images_per_sec"]) and row["images_per_sec"] > 0
    assert row["params"] == _jax_params(model, **kw)
    if params is not None:
        assert row["params"] == params


def test_bench_defaults_are_the_jax_commands():
    args = port_cli.build_parser().parse_args(["bench"])
    assert (args.model, args.batch_size, args.runs, args.device) == (
        "ssd300_ssd_custom", 32, 10, "cuda")

"""Port parity: Keras H5 weight import, JAX package vs PyTorch port (CPU).

The JAX package's `export_keras_h5` writes the seeded flax variables of
`ssd300_ssd_custom` as a Keras weights file; both packages import it by
layer name.  The reports must be equal, the port's weights equal to the flax
bridge's, and its float32 forward within the slice's 1e-4 (rtol 1e-4, atol
1e-4 * max|ref| per block: ~60 convolutions summed in other orders by XLA
and PyTorch's CPU kernels).
"""

import copy

import h5py
import jax
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5
from jpeg_detection_resnet_ssd_tpu.compat import h5_import as jax_h5
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.compat import (
    import_weights_by_name,
    list_h5_layers,
    load_flax_variables,
    load_keras_h5_weights,
)
from jpeg_detection_resnet_ssd_torch.models import build_model

from torch_parity import random_flax_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def h5_case(tmp_path_factory):
    module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    y, cbcr = (a[:1] for a in example(np.random.default_rng(7)))
    variables = random_flax_variables(module, (y, cbcr), train=False, seed=0)
    path = str(tmp_path_factory.mktemp("h5") / "ssd_custom.h5")
    export_keras_h5(variables, path)
    # Both importers start from other weights (seed 1 for JAX, the port's
    # init), which the file must overwrite.
    start = random_flax_variables(module, (y, cbcr), train=False, seed=1)
    jax_vars, jax_report = jax_h5.import_weights_by_name(start, path)
    ref = np.array(jax.jit(lambda v, i: module.apply(v, i, train=False))(jax_vars, (y, cbcr)))
    fresh, _ = build_model("ssd300_ssd_custom", n_classes=20, device="cpu")
    port, report = import_weights_by_name(copy.deepcopy(fresh), path)
    with torch.no_grad():
        got = port((torch.from_numpy(y), torch.from_numpy(cbcr))).numpy()
    return dict(path=path, variables=variables, start=start, fresh=fresh, port=port,
                report=report, jax_report=jax_report, got=got, ref=ref)


def test_reports_are_equal(h5_case):
    report = h5_case["report"]
    assert report == h5_case["jax_report"]
    assert len(report["loaded"]) == 161 and not report["skipped"] and not report["mismatched"]


def test_weights_equal_the_flax_bridges(h5_case):
    bridged = load_flax_variables(copy.deepcopy(h5_case["fresh"]), h5_case["variables"])
    got, want = h5_case["port"].state_dict(), bridged.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k


def test_forward_after_import_matches_jax(h5_case):
    got, ref = h5_case["got"], h5_case["ref"]
    assert got.shape == ref.shape == (1, 8732, 33) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 25:], ref[..., 25:])  # anchors, variances
    for block in (slice(0, 21), slice(21, 25)):
        np.testing.assert_allclose(got[..., block], ref[..., block], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref[..., block]).max())


def test_layer_listing_matches_jax(h5_case):
    path = h5_case["path"]
    assert list_h5_layers(path) == jax_h5.list_h5_layers(path)
    got, ref = load_keras_h5_weights(path), jax_h5.load_keras_h5_weights(path)
    assert got.keys() == ref.keys()
    for lname in ref:
        assert got[lname].keys() == ref[lname].keys()
        for w in ref[lname]:
            np.testing.assert_array_equal(got[lname][w], ref[lname][w])


@pytest.fixture(scope="module")
def edited_h5(h5_case, tmp_path_factory):
    """The exported file with one layer renamed, one kernel of the wrong
    shape, one weight of an unknown name and one layer the model lacks."""
    path = str(tmp_path_factory.mktemp("h5") / "edited.h5")
    with h5py.File(h5_case["path"], "r") as src, h5py.File(path, "w") as dst:
        src.copy("model_weights", dst)
        g = dst["model_weights"]
        g.move("fc7_mbox_loc", "fc7_mbox_loc_voc")
        kernel = g["conv4_3_norm_mbox_loc"]["conv4_3_norm_mbox_loc/kernel:0"]
        short = np.asarray(kernel)[..., :-1]
        del g["conv4_3_norm_mbox_loc"]["conv4_3_norm_mbox_loc/kernel:0"]
        g["conv4_3_norm_mbox_loc"].create_dataset("conv4_3_norm_mbox_loc/kernel:0", data=short)
        grp = g["res5c_branch2a"]
        grp.attrs["weight_names"] = np.array(
            list(grp.attrs["weight_names"]) + [b"res5c_branch2a/alpha:0"])
        grp.create_dataset("res5c_branch2a/alpha:0", data=np.ones(3, np.float32))
        extra = g.create_group("dense_extra")
        extra.attrs["weight_names"] = np.array([b"dense_extra/kernel:0"])
        extra.create_dataset("dense_extra/kernel:0", data=np.ones((4, 2), np.float32))
    return path


@pytest.mark.parametrize("rename", [None, {"fc7_mbox_loc_voc": "fc7_mbox_loc"}])
def test_renamed_and_mismatched_layers_match_jax(h5_case, edited_h5, rename):
    before = h5_case["fresh"].state_dict()
    port, report = import_weights_by_name(copy.deepcopy(h5_case["fresh"]), edited_h5,
                                          rename=rename)
    _, jax_report = jax_h5.import_weights_by_name(h5_case["start"], edited_h5, rename=rename)
    assert report == jax_report
    assert sorted(report["mismatched"]) == ["conv4_3_norm_mbox_loc", "res5c_branch2a"]
    assert ("fc7_mbox_loc_voc" in report["loaded"]) == (rename is not None)
    assert ("fc7_mbox_loc_voc" in report["skipped"]) == (rename is None)
    assert "dense_extra" in report["skipped"]
    state = port.state_dict()
    # A mismatched layer is left whole as it was.
    untouched = [k for k in state
                 if any(f".{layer}." in f".{k}" for layer in report["mismatched"])]
    assert len(untouched) == 4  # two kernels, two biases
    for key in untouched:
        assert torch.equal(state[key], before[key]), key
    assert not torch.equal(state["head.fc7_mbox_conf_21.weight"],
                           before["head.fc7_mbox_conf_21.weight"])


def test_verbose_report_line(h5_case, capsys):
    import_weights_by_name(copy.deepcopy(h5_case["fresh"]), h5_case["path"], verbose=True)
    assert capsys.readouterr().out.strip() == "h5 import: 161 loaded, 0 skipped, 0 mismatched"


def test_transposed_convolutions_name_their_roadmap_item(h5_case):
    """A layer named in `transpose_conv_layers` has its kernel's in and out
    axes swapped first, as the JAX importer does; a plain conv's kernel then
    no longer fits, and both importers report it mismatched."""
    layers = ("fc7_mbox_loc", "conv4_3_norm_mbox_conf_21")
    port, report = import_weights_by_name(copy.deepcopy(h5_case["fresh"]), h5_case["path"],
                                          transpose_conv_layers=layers)
    _, jax_report = jax_h5.import_weights_by_name(h5_case["start"], h5_case["path"],
                                                  transpose_conv_layers=layers)
    assert report == jax_report
    assert sorted(report["mismatched"]) == sorted(layers)

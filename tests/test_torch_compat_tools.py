"""Port parity of the weight tooling (ROADMAP A14c) on the CPU: H5 export,
head surgery and the checksum-verified fetch, JAX package vs PyTorch port.

One seeded flax-layout NumPy tree of `resnet50_dct_cb5_only` (7 classes) is
exported by both packages: the files must hold the same layer names in the
same order and bit-identical datasets, and each package's importer must
read the other's file into the source model's forward.  Nothing is
downloaded: the fetch cases use local files and `file://` URLs.
"""

import copy
import hashlib
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5 as jax_export
from jpeg_detection_resnet_ssd_tpu.compat import h5_import as jax_h5
from jpeg_detection_resnet_ssd_tpu.compat import sample_tensors as jax_sample_tensors
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.compat import (
    ChecksumError,
    export_keras_h5,
    fetch_weights,
    flax_variables,
    import_weights_by_name,
    sample_tensors,
)
from jpeg_detection_resnet_ssd_torch.compat import fetch as port_fetch
from jpeg_detection_resnet_ssd_torch.models import build_model

from torch_parity import port_module, random_flax_variables


def _datasets(path):
    """[(layer, [(weight name, array)])] in file order, and the attributes."""
    out = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"]
        names = [n.decode() for n in g.attrs["layer_names"]]
        for lname in names:
            wnames = [w.decode() for w in g[lname].attrs["weight_names"]]
            out.append((lname, [(w, g[lname][w][()]) for w in wnames]))
        attrs = (g.attrs["layer_names"].dtype, [g[n].attrs["weight_names"].dtype for n in names])
    return out, attrs


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    module, example = jax_build_model("resnet50_dct_cb5_only", num_classes=7)
    inputs = tuple(a[:1] for a in example(np.random.default_rng(3)))
    variables = random_flax_variables(module, inputs, train=False, seed=0)
    tmp = tmp_path_factory.mktemp("export")
    paths = {k: str(tmp / f"{k}.h5") for k in ("jax", "port", "module")}
    names = {"jax": jax_export(variables, paths["jax"]),
             "port": export_keras_h5(variables, paths["port"])}
    source = port_module("resnet50_dct_cb5_only", variables, num_classes=7)
    names["module"] = export_keras_h5(source, paths["module"])
    apply = jax.jit(lambda v, x: module.apply(v, x, train=False))
    yield dict(module=module, inputs=inputs, variables=variables, paths=paths, names=names,
               source=source, apply=apply, ref=np.asarray(apply(variables, inputs)))
    for p in paths.values():
        os.remove(p)


def test_export_writes_the_jax_exporters_file(exported):
    names = exported["names"]
    assert names["port"] == names["jax"]
    assert "res1a2_branch2a" in names["jax"] and "fc1000" in names["jax"]
    want, want_attrs = _datasets(exported["paths"]["jax"])
    for key in ("port", "module"):
        got, got_attrs = _datasets(exported["paths"][key])
        if key == "module":  # the module's layers, walked in its own order
            assert sorted(names[key]) == sorted(names["jax"])
            got = sorted(got)
            want = sorted(want)
        else:
            assert got_attrs == want_attrs
        assert [(n, [w for w, _ in ws]) for n, ws in got] == [(n, [w for w, _ in ws]) for n, ws in want]
        for (lname, gws), (_, wws) in zip(got, want):
            for (w, a), (_, b) in zip(gws, wws):
                assert a.dtype == b.dtype and a.shape == b.shape, w
                np.testing.assert_array_equal(a, b, err_msg=w)


def test_the_ports_file_imports_into_jax(exported):
    start = random_flax_variables(exported["module"], exported["inputs"], train=False, seed=1)
    loaded, report = jax_h5.import_weights_by_name(start, exported["paths"]["port"])
    assert not report["mismatched"] and not report["skipped"]
    got = np.asarray(exported["apply"](loaded, exported["inputs"]))
    ref = exported["ref"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_the_jax_file_imports_into_the_port(exported):
    fresh, _ = build_model("resnet50_dct_cb5_only", num_classes=7, device="cpu")
    port, report = import_weights_by_name(copy.deepcopy(fresh), exported["paths"]["jax"])
    assert not report["mismatched"] and not report["skipped"]
    x = tuple(torch.from_numpy(a) for a in exported["inputs"])
    with torch.no_grad():
        got, want = port.eval()(x), exported["source"](x)
    assert torch.equal(got, want)
    # and the module's own export round-trips through the port
    back, _ = import_weights_by_name(copy.deepcopy(fresh), exported["paths"]["module"])
    with torch.no_grad():
        assert torch.equal(back.eval()(x), want)


def test_classification_weights_transfer_into_the_detector(exported, tmp_path):
    """The reference's transfer story: a classifier's `res*` layers load by
    name into `ssd300_cb5_only`; its `fc1000` does not."""
    det, example = build_model("ssd300_cb5_only", n_classes=20, device="cpu")
    det, report = import_weights_by_name(det, exported["paths"]["port"])
    assert "res1a2_branch2a" in report["loaded"] and "res5a_branch2a" in report["loaded"]
    assert "fc1000" in report["skipped"]
    want = exported["variables"]["params"]["stem"]["res1a2_branch2a"]["kernel"]
    got = flax_variables(det)["params"]["stem"]["res1a2_branch2a"]["kernel"]
    np.testing.assert_array_equal(got, want)
    y, cbcr = (torch.from_numpy(a[:1]) for a in example())
    with torch.no_grad():
        assert torch.isfinite(det.eval()((y, cbcr))).all()


@pytest.mark.parametrize("case", ["downsample", "upsample", "listed", "two_tensors"])
def test_sample_tensors_matches_jax(case):
    """Equal outputs and per-axis indices from the same seeded generator."""
    rng = np.random.default_rng(11)
    kernel = rng.normal(0, 1, (3, 3, 8, 12)).astype(np.float32)
    other = rng.normal(0, 1, (3, 3, 8, 12)).astype(np.float32)
    tensors, instructions, axes = {
        "downsample": ([kernel], [3, 3, 8, 5], [3]),
        "upsample": ([kernel], [3, 3, 8, 20], [3]),
        "listed": ([kernel], [3, 3, [0, 2, 7], [1, 4]], [2, 3]),
        "two_tensors": ([kernel, other], [3, 3, 8, 6], [3]),
    }[case]
    got, got_idx = sample_tensors(tensors, instructions, axes=axes, rng=np.random.default_rng(5))
    want, want_idx = jax_sample_tensors(tensors, instructions, axes=axes,
                                        rng=np.random.default_rng(5))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_idx, want_idx):
        assert (g is None and w is None) or np.array_equal(g, w)
    if case in ("downsample", "two_tensors"):
        assert got_idx[3][0] == 0  # the background index survives
        np.testing.assert_array_equal(got[-1], tensors[-1][..., got_idx[3]])
    if case == "upsample":
        np.testing.assert_array_equal(got[0][..., :12], kernel)


class TestWeightFetch:
    """The JAX package's `TestWeightFetch` cases on the port's fetch, local
    files and `file://` only, plus the remote case, which downloads
    nothing."""

    def _make_source(self, tmp_path, data=b"weights-bytes-v1"):
        src = tmp_path / "src" / "model.h5"
        src.parent.mkdir()
        src.write_bytes(data)
        return str(src), hashlib.md5(data).hexdigest()

    def test_fetch_verify_and_cache(self, tmp_path):
        src, md5 = self._make_source(tmp_path)
        cache = str(tmp_path / "cache")
        p1 = fetch_weights(src, checksum=md5, cache_dir=cache)
        assert p1 == os.path.join(cache, "model.h5")
        assert open(p1, "rb").read() == b"weights-bytes-v1"
        os.remove(src)  # the second call hits the cache
        assert fetch_weights(src, checksum=md5, cache_dir=cache) == p1

    def test_checksum_mismatch_raises(self, tmp_path):
        src, _ = self._make_source(tmp_path)
        with pytest.raises(ChecksumError, match="md5 mismatch"):
            fetch_weights(src, checksum="0" * 32, cache_dir=str(tmp_path / "cache"))
        assert os.listdir(tmp_path / "cache") == []  # no partial or final file

    def test_corrupted_cache_refetched(self, tmp_path):
        src, md5 = self._make_source(tmp_path)
        cache = tmp_path / "cache"
        cache.mkdir()
        (cache / "model.h5").write_bytes(b"corrupted")
        p = fetch_weights(src, checksum="md5:" + md5, cache_dir=str(cache))
        assert open(p, "rb").read() == b"weights-bytes-v1"

    def test_sha256_and_file_url(self, tmp_path):
        src, _ = self._make_source(tmp_path)
        sha = hashlib.sha256(b"weights-bytes-v1").hexdigest()
        p = fetch_weights("file://" + src, checksum="sha256:" + sha,
                          cache_dir=str(tmp_path / "cache"))
        assert os.path.exists(p)
        with pytest.raises(ValueError, match="unsupported checksum"):
            fetch_weights(src, checksum="sha1:00", cache_dir=str(tmp_path / "cache2"))

    def test_known_weights_registry(self, tmp_path):
        from jpeg_detection_resnet_ssd_tpu.compat.fetch import KNOWN_WEIGHTS as JAX_KNOWN

        assert port_fetch.KNOWN_WEIGHTS == JAX_KNOWN
        with pytest.raises(KeyError, match="unknown weights"):
            port_fetch.fetch_known_weights("nope")

    def test_remote_urls_are_never_downloaded(self, tmp_path, monkeypatch):
        def no_network(*args, **kwargs):
            raise AssertionError("the fetch tried to open a URL")

        monkeypatch.setattr("urllib.request.urlopen", no_network)
        monkeypatch.setenv("HOME", str(tmp_path))
        origin = "https://example.invalid/releases/w.h5"
        target = os.path.join(str(tmp_path), ".cache", "jpeg_dct_torch", "weights", "w.h5")
        assert port_fetch.default_cache_dir() == os.path.dirname(target)
        with pytest.raises(OSError, match="pre-stage the file at " + target):
            fetch_weights(origin)
        assert not os.path.exists(os.path.dirname(target))
        # a file pre-staged in the cache is served, checksum and all
        os.makedirs(os.path.dirname(target))
        with open(target, "wb") as f:
            f.write(b"staged")
        assert fetch_weights(origin, checksum=hashlib.md5(b"staged").hexdigest()) == target
        with pytest.raises(OSError, match="pre-stage"):
            fetch_weights(origin, checksum="0" * 32)  # stale: discarded, not downloaded

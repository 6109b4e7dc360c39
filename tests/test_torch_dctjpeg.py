"""Port parity: the JPEG -> DCT decoder, JAX package vs PyTorch port (CPU).

Both packages build the same C++ source against the same libjpeg, so every
array must be identical: coefficients, planes, packed tensors.  The port's
library is its own file (`_build/libdctjpeg_host.so`) and is loaded in the
same process as the JAX package's.
"""

import hashlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from jpeg_detection_resnet_ssd_tpu import dctjpeg as jax_dctjpeg
from jpeg_detection_resnet_ssd_torch import dctjpeg

from torch_cases import GOLDEN_JPEG

REPO = Path(__file__).resolve().parent.parent


def jpeg_bytes(seed, size=(120, 160), subsampling=2, gray=False, quality=75):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : size[0], 0 : size[1]]
    base = 96 + 48 * np.sin(xx / 9.0) + 0.4 * yy
    arr = np.stack([base, 0.8 * base + 20, 255 - base], -1) + rng.normal(0, 8, (*size, 3))
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    kw = {} if gray else {"subsampling": subsampling}
    img.save(buf, "jpeg", quality=quality, **kw)
    return buf.getvalue()


CASES = {
    "golden": lambda: GOLDEN_JPEG.read_bytes(),
    "420": lambda: jpeg_bytes(0, subsampling=2),
    "444": lambda: jpeg_bytes(1, subsampling=0),
    "gray": lambda: jpeg_bytes(2, gray=True),
    "ragged_420": lambda: jpeg_bytes(3, size=(97, 131), subsampling=2, quality=90),
}


def assert_identical(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_library_is_the_ports_own():
    dctjpeg.loads(CASES["golden"]())
    jax_dctjpeg.loads(CASES["golden"]())
    assert dctjpeg._LIB_PATH.name == "libdctjpeg_host.so"
    assert dctjpeg._LIB_PATH.parent.name == "_build"
    assert dctjpeg._lib is not jax_dctjpeg._lib
    assert dctjpeg._lib._name != jax_dctjpeg._lib._name


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("normalized", [True, False])
def test_loads_matches_jax(case, normalized):
    buf = CASES[case]()
    got = dctjpeg.loads(buf, normalized=normalized)
    ref = jax_dctjpeg.loads(buf, normalized=normalized)
    assert_identical(got, ref)
    assert got[0].dtype == np.int32 and got[0].shape[-1] == 64


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_components_matches_jax(case):
    buf = CASES[case]()
    comps, hw, sampling = dctjpeg.decode_components(buf, dequantize=True)
    ref_comps, ref_hw, ref_sampling = jax_dctjpeg.decode_components(buf, dequantize=True)
    assert_identical(comps, ref_comps)
    assert (hw, sampling) == (ref_hw, ref_sampling)


def test_load_from_a_path_matches_jax():
    assert_identical(dctjpeg.load(str(GOLDEN_JPEG)), jax_dctjpeg.load(str(GOLDEN_JPEG)))


@pytest.mark.parametrize("case,crop", [("444", None), ("444", (64, 96)), ("gray", (40, 56))])
def test_decode_dct_image_matches_jax(case, crop, tmp_path):
    buf = CASES[case]()
    got = dctjpeg.decode_dct_image(buf, crop_hw=crop)
    np.testing.assert_array_equal(got, jax_dctjpeg.decode_dct_image(buf, crop_hw=crop))
    if crop is not None:
        assert got.shape == (*crop, 3)
    path = tmp_path / "x.jpg"
    path.write_bytes(buf)
    np.testing.assert_array_equal(dctjpeg.decode_dct_image(str(path), crop_hw=crop), got)


def test_decode_dct_image_rejects_subsampled_input_as_jax_does():
    buf = CASES["420"]()
    with pytest.raises(dctjpeg.JPEGDecodeError, match="4:4:4"):
        dctjpeg.decode_dct_image(buf)
    with pytest.raises(jax_dctjpeg.JPEGDecodeError, match="4:4:4"):
        jax_dctjpeg.decode_dct_image(buf)


@pytest.mark.parametrize("case", ["golden", "420", "gray"])
@pytest.mark.parametrize("out_hw", [(304, 304), (240, 320)])
def test_pack_matches_jax(case, out_hw):
    buf = CASES[case]()
    got = dctjpeg.pack(buf, *out_hw)
    ref = jax_dctjpeg.pack(buf, *out_hw)
    assert_identical(got, ref)
    h, w = out_hw
    assert got[0].shape == (h // 8, w // 8, 64) and got[1].shape == (h // 16, w // 16, 128)
    assert got[0].dtype == np.int16


def test_pack_rejects_sizes_off_the_16_grid():
    with pytest.raises(dctjpeg.JPEGDecodeError, match="multiples of 16"):
        dctjpeg.pack(CASES["golden"](), 300, 300)


@pytest.mark.parametrize("shape", [(5, 7, 64), (1, 1, 64), (38, 38, 64)])
def test_block_plane_reshapes_match_jax(shape):
    blocks = np.random.default_rng(0).integers(-1024, 1024, shape).astype(np.int32)
    plane = dctjpeg.blocks_to_plane(blocks)
    np.testing.assert_array_equal(plane, jax_dctjpeg.blocks_to_plane(blocks))
    back = dctjpeg.plane_to_blocks(plane)
    np.testing.assert_array_equal(back, jax_dctjpeg.plane_to_blocks(plane))
    np.testing.assert_array_equal(back, blocks)


@pytest.mark.parametrize("cut", [0, 2, 40, 200])
def test_truncated_bytes_raise_as_in_jax(cut):
    buf = CASES["golden"]()[:cut]
    with pytest.raises(dctjpeg.JPEGDecodeError):
        dctjpeg.loads(buf)
    with pytest.raises(jax_dctjpeg.JPEGDecodeError):
        jax_dctjpeg.loads(buf)


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Twelve processes load the decoder at once into an empty build
    directory: each gets a whole library (the build holds a file lock and
    renames a finished file into place) and decodes the same arrays."""
    code = (
        "import hashlib, sys\n"
        "from pathlib import Path\n"
        "from jpeg_detection_resnet_ssd_torch import dctjpeg\n"
        "dctjpeg._BUILD_DIR = Path(sys.argv[1])\n"
        "dctjpeg._LIB_PATH = dctjpeg._BUILD_DIR / 'libdctjpeg_host.so'\n"
        "y, cb, cr = dctjpeg.loads(Path(sys.argv[2]).read_bytes())\n"
        "print(hashlib.sha1(y.tobytes() + cb.tobytes() + cr.tobytes()).hexdigest())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp_path), str(GOLDEN_JPEG)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(12)
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err
            outs.append(out.strip())
    finally:
        for proc in procs:
            proc.kill()
    y, cb, cr = dctjpeg.loads(GOLDEN_JPEG.read_bytes())
    assert set(outs) == {hashlib.sha1(y.tobytes() + cb.tobytes() + cr.tobytes()).hexdigest()}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dctjpeg.lock", "libdctjpeg_host.so"]

"""JPEG -> block-DCT decoding: native C++ core + numpy-facing API.

The port's own copy of the JAX package's `dctjpeg` module (its source,
`csrc/dctjpeg.cc`, and this ctypes loader), with the same functions:

  * `loads(buf)` / `load(path)` -- the jpeg2dct contract: `(dct_y, dct_cb,
    dct_cr)` int32 arrays of shape `(h_blocks, w_blocks, 64)` per component,
    dequantized, natural frequency order.  A 300x300 4:2:0 JPEG gives Y
    (38,38,64) and Cb/Cr (19,19,64).
  * `decode_dct_image(buf_or_path, crop_hw=None)` -- the jpegdecoder level-2
    contract: per-component coefficients laid out spatially in 8x8 block
    positions, stacked to an (H, W, 3) plane (4:4:4 or grayscale input).
  * `pack(buf_or_path, out_h, out_w)` -- decode, resize, re-encode at 4:2:0
    and decode coefficients, all in C++.

The library is built with g++ against the system libjpeg (`jpeglib.h` and
`-ljpeg`) at first use, into the git-ignored `_build/` directory of this
package as `libdctjpeg_host.so`, and rebuilt whenever the source is newer.
A file lock serialises the build across threads and processes (pytest-xdist
workers), and the library is written to a temporary name and renamed, so no
process loads half a file.  A failed build raises; there is no fallback.
It links with `-Bsymbolic`, so its calls between its own functions stay
inside it even where the JAX package's library of the same symbols is
loaded in the same process.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "dctjpeg.cc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LIB_PATH = _BUILD_DIR / "libdctjpeg_host.so"
_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wl,-Bsymbolic")
_lock = threading.Lock()
_lib = None


class _DctDecoded(ctypes.Structure):
    _fields_ = [
        ("n_components", ctypes.c_int),
        ("img_height", ctypes.c_int),
        ("img_width", ctypes.c_int),
        ("h_samp", ctypes.c_int * 4),
        ("v_samp", ctypes.c_int * 4),
        ("h_blocks", ctypes.c_int * 4),
        ("w_blocks", ctypes.c_int * 4),
        ("coeffs", ctypes.POINTER(ctypes.c_int32) * 4),
        ("error", ctypes.c_char * 200),
    ]


def _stale() -> bool:
    return not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime


def _build_library() -> None:
    """Compile `csrc/dctjpeg.cc` into `_LIB_PATH` unless an up-to-date
    library is there, holding an exclusive lock on `_build/dctjpeg.lock`."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "dctjpeg.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while this one waited
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", *_GXX_FLAGS, str(_SRC), "-o", tmp, "-ljpeg"],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed on {_SRC} (exit {proc.returncode}); the decoder needs "
                    f"libjpeg's header and library:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build_library()
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.dctjpeg_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.POINTER(_DctDecoded),
        ]
        lib.dctjpeg_decode.restype = ctypes.c_int
        lib.dctjpeg_release.argtypes = [ctypes.POINTER(_DctDecoded)]
        lib.dctjpeg_release.restype = None
        lib.dctjpeg_pack.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.dctjpeg_pack.restype = ctypes.c_int
        _lib = lib
        return _lib


class JPEGDecodeError(RuntimeError):
    pass


def decode_components(buf: bytes, dequantize: bool = True):
    """Decode a JPEG buffer to a list of (h_blocks, w_blocks, 64) int32 arrays.

    Returns (components, (img_height, img_width), sampling) where sampling is
    a list of per-component (h_samp, v_samp).
    """
    lib = _get_lib()
    out = _DctDecoded()
    rc = lib.dctjpeg_decode(buf, len(buf), int(dequantize), ctypes.byref(out))
    if rc != 0:
        raise JPEGDecodeError(out.error.decode(errors="replace"))
    try:
        comps = []
        sampling = []
        for ci in range(out.n_components):
            hb, wb = out.h_blocks[ci], out.w_blocks[ci]
            arr = np.ctypeslib.as_array(out.coeffs[ci], shape=(hb, wb, 64))
            comps.append(np.array(arr, dtype=np.int32))  # copy before release
            sampling.append((out.h_samp[ci], out.v_samp[ci]))
        return comps, (out.img_height, out.img_width), sampling
    finally:
        lib.dctjpeg_release(ctypes.byref(out))


def loads(buf: bytes, normalized: bool = True):
    """jpeg2dct-compatible: bytes -> (dct_y, dct_cb, dct_cr) int32 arrays.

    `normalized=True` dequantizes.  A grayscale JPEG yields zero chroma at
    half the luma block resolution (4:2:0-shaped).
    """
    comps, _, _ = decode_components(buf, dequantize=normalized)
    y = comps[0]
    if len(comps) >= 3:
        return y, comps[1], comps[2]
    hb = (y.shape[0] + 1) // 2
    wb = (y.shape[1] + 1) // 2
    zeros = np.zeros((hb, wb, 64), dtype=np.int32)
    return y, zeros, zeros.copy()


def load(path: str, normalized: bool = True):
    """jpeg2dct-compatible: file path -> (dct_y, dct_cb, dct_cr)."""
    with open(path, "rb") as f:
        return loads(f.read(), normalized=normalized)


def blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    """(H8, W8, 64) block tensor -> (H8*8, W8*8) spatial coefficient plane."""
    h8, w8, _ = blocks.shape
    return (
        blocks.reshape(h8, w8, 8, 8).transpose(0, 2, 1, 3).reshape(h8 * 8, w8 * 8)
    )


def plane_to_blocks(plane: np.ndarray) -> np.ndarray:
    """Inverse of `blocks_to_plane`."""
    h, w = plane.shape
    return (
        plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
            h // 8, w // 8, 64
        )
    )


def _read(buf_or_path) -> bytes:
    if isinstance(buf_or_path, (str, os.PathLike)):
        with open(buf_or_path, "rb") as f:
            return f.read()
    return bytes(buf_or_path)


def decode_dct_image(buf_or_path, crop_hw: tuple[int, int] | None = None):
    """jpegdecoder level-2 contract: (H, W, C) spatial DCT-coefficient image.

    Components must share one sampling grid (4:4:4); grayscale broadcasts the
    Y plane to 3 channels.  `crop_hw` crops the top-left corner.
    """
    comps, (h, w), sampling = decode_components(_read(buf_or_path), dequantize=True)
    if len(comps) == 1:
        planes = [blocks_to_plane(comps[0])] * 3
    else:
        if len(set(sampling)) != 1:
            raise JPEGDecodeError(
                "decode_dct_image requires 4:4:4 (subsampling=0) input; "
                f"got sampling {sampling}"
            )
        planes = [blocks_to_plane(c) for c in comps[:3]]
    img = np.stack(planes, axis=-1)
    if crop_hw is not None:
        img = img[: crop_hw[0], : crop_hw[1]]
    return img


def pack(buf_or_path, out_h: int, out_w: int, quality: int = 75):
    """JPEG -> decode -> half-pixel bilinear resize to (out_h, out_w) -> 4:2:0
    re-encode at `quality` -> dequantized coefficients, all in C++.

    Returns (y (out_h/8, out_w/8, 64) int16, cbcr (out_h/16, out_w/16, 128)
    int16).  out_h and out_w must be multiples of 16.  ctypes releases the
    GIL during the call, so a thread pool scales it across cores.
    """
    buf = _read(buf_or_path)
    lib = _get_lib()
    y = np.empty((out_h // 8, out_w // 8, 64), dtype=np.int16)
    cbcr = np.empty((out_h // 16, out_w // 16, 128), dtype=np.int16)
    err = ctypes.create_string_buffer(200)
    rc = lib.dctjpeg_pack(
        buf, len(buf), out_h, out_w, quality,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        cbcr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        err, ctypes.sizeof(err),
    )
    if rc != 0:
        raise JPEGDecodeError(err.value.decode(errors="replace"))
    return y, cbcr

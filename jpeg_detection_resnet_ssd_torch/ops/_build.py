"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `ops/csrc/<name>.cu` exposes a plain C interface and is compiled into
`jpeg_detection_resnet_ssd_torch/_build/lib<name>.so` (git-ignored) at first
use, and again whenever the source is newer than the library.  Sources
include no PyTorch header, so a build takes seconds.  Nothing is built at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# -fmad=false: no a*b+c contraction, so kernels that promise bit-equality
# with their plain PyTorch version keep IEEE rounding at every step.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str, force: bool = False) -> str:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists.

    Returns nvcc's output (the `-Xptxas -v` register and shared-memory
    report), or "" when nothing was built.  The library is written to a
    temporary file and renamed into place, so no concurrent caller loads
    a half-written file.
    """
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out = library_path(name)
    if not force and out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib

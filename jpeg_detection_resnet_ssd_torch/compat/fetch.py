"""Checksum-verified pretrained-weight fetch with a local cache.

Counterpart of the JAX package's `compat/fetch.py`, the role of
`keras_utils.get_file(fname, origin, cache_subdir, md5_hash)` in the
reference's pretrained-ResNet50 path
(`classification_part/vgg_jpeg_keras/networks/resnet_dct.py:46-51,295-308`):
copy once into a cache directory, verify the checksum, and reuse the cached
copy on later calls; a corrupted cache entry (hash mismatch) is discarded
and fetched again.

Sources are `file://` URLs and plain local paths.  This package downloads
nothing: a remote URL is served from the cache when its file was pre-staged
there (`default_cache_dir()`, or `cache_dir`), and otherwise raises an
`OSError` that names the path to pre-stage.  Checksums are `"md5:<hex>"` or
`"sha256:<hex>"`; a bare hex string is an md5, as in Keras.

Pair with `compat.import_weights_by_name` for the reference's
`load_weights(by_name=True)` transfer semantics.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.parse
import urllib.request

# The two checkpoints the reference fetches (`resnet_dct.py:295-308`).
KNOWN_WEIGHTS = {
    "resnet50_tf_kernels": {
        "origin": (
            "https://github.com/fchollet/deep-learning-models/"
            "releases/download/v0.2/"
            "resnet50_weights_tf_dim_ordering_tf_kernels.h5"
        ),
        "checksum": "md5:a7b3fe01876f51b976af0dea6bc144eb",
    },
    "resnet50_tf_kernels_notop": {
        "origin": (
            "https://github.com/fchollet/deep-learning-models/"
            "releases/download/v0.2/"
            "resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5"
        ),
        "checksum": "md5:a268eb855778b3df3c7506639542a6af",
    },
}


class ChecksumError(RuntimeError):
    """Fetched file's hash does not match the expected checksum."""


def default_cache_dir() -> str:
    """`~/.cache/jpeg_dct_torch/weights` of the current home directory."""
    return os.path.join(os.path.expanduser("~"), ".cache", "jpeg_dct_torch", "weights")


def _parse_checksum(checksum: str) -> tuple[str, str]:
    if ":" in checksum:
        algo, _, digest = checksum.partition(":")
    else:
        algo, digest = "md5", checksum  # Keras passes a bare md5 hex
    algo = algo.lower()
    if algo not in ("md5", "sha256"):
        raise ValueError(f"unsupported checksum algorithm {algo!r}")
    return algo, digest.lower()


def file_checksum(path: str, algo: str = "md5", chunk: int = 1 << 20) -> str:
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def verify_checksum(path: str, checksum: str) -> bool:
    algo, digest = _parse_checksum(checksum)
    return file_checksum(path, algo) == digest


def _local_source(origin: str) -> str | None:
    """Return a filesystem path when `origin` is local, else None."""
    parsed = urllib.parse.urlparse(origin)
    if parsed.scheme == "file":
        return urllib.request.url2pathname(parsed.path)
    return origin if parsed.scheme == "" else None


def fetch_weights(
    origin: str,
    checksum: str | None = None,
    fname: str | None = None,
    cache_dir: str | None = None,
    force: bool = False,
) -> str:
    """Fetch `origin` into the cache, verify `checksum`, return the path.

    A cached file whose hash matches is returned without fetching again; a
    cached file that FAILS verification is deleted and fetched again (the
    `get_file` recovery behaviour).  When the new copy still fails,
    `ChecksumError` is raised.  A remote origin is never downloaded: unless
    its file is in the cache, an `OSError` names the path to pre-stage."""
    cache_dir = cache_dir or default_cache_dir()
    fname = fname or os.path.basename(urllib.parse.urlparse(origin).path)
    if not fname:
        raise ValueError(f"cannot derive a file name from origin {origin!r}")
    target = os.path.join(cache_dir, fname)

    if os.path.exists(target) and not force:
        if checksum is None or verify_checksum(target, checksum):
            return target
        os.remove(target)  # corrupted cache entry: discard and fetch again

    src = _local_source(origin)
    if src is None:
        raise OSError(
            f"{origin!r} is remote and this package downloads nothing; "
            f"pre-stage the file at {target}"
        )
    os.makedirs(cache_dir, exist_ok=True)
    # Private temp file per call: a shared `target + ".part"` path races
    # under concurrent fetches of the same weights (interleaved writes, a
    # verify-then-replace TOCTOU, and one caller's cleanup deleting
    # another's copy in progress).  mkstemp on the same filesystem keeps
    # os.replace atomic.
    fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=fname + ".", suffix=".part")
    os.close(fd)
    try:
        if os.path.abspath(src) == os.path.abspath(target):
            raise ValueError("origin and cache target are the same file")
        shutil.copyfile(src, tmp)
        if checksum is not None and not verify_checksum(tmp, checksum):
            algo, digest = _parse_checksum(checksum)
            raise ChecksumError(
                f"{origin}: {algo} mismatch (expected {digest}, got "
                f"{file_checksum(tmp, algo)})"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def fetch_known_weights(name: str, cache_dir: str | None = None) -> str:
    """Fetch one of the reference's pretrained checkpoints by short name
    (`KNOWN_WEIGHTS`): 'resnet50_tf_kernels' / 'resnet50_tf_kernels_notop'."""
    try:
        spec = KNOWN_WEIGHTS[name]
    except KeyError:
        raise KeyError(
            f"unknown weights {name!r}; available: {sorted(KNOWN_WEIGHTS)}"
        ) from None
    return fetch_weights(spec["origin"], checksum=spec["checksum"], cache_dir=cache_dir)

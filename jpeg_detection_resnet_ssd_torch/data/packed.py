"""Packed DCT-tensor corpus: decode once, train from memmapped coefficients.

Counterpart of the JAX package's `data/packed.py`, with its file formats,
names and `meta.json` keys, so a corpus packed by either package loads in
the other.  With the device augmentation chain
(`ops/dct_detect_augment.py`) no pixel work is left per epoch, so the host
only hands the card fixed-shape coefficient tensors.  A detection corpus
is decoded once into

    <stem>.y.npy       (N, H8, W8, 64)      int16 luma coefficients
    <stem>.cbcr.npy    (N, H8/2, W8/2, 128) int16 chroma
    <stem>.labels.npz  gt (N, max_gt, 5) f32, gt_mask (N, max_gt) bool,
                       image_ids
    <stem>.meta.json   n, img_height, img_width, max_gt, quality

and `PackedDctPipeline` serves batches with a gather and a cast per batch.
Epochs are shuffled per (seed, epoch); shards slice the index space.  A
classification corpus (`create_classification`) has the same planes at a
square frame, `labels.npz` with int32 `labels` and `image_ids`, and
`meta.json` with n, img_size, quality and `task: classification`.

`load_or_create` is safe across the ranks of a process group: rank 0 alone
packs, every rank waits at one barrier, then each validates.  PIL and cv2
are imported inside the functions that decode, so the package imports
without them.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch.distributed

from jpeg_detection_resnet_ssd_torch.data import augment as aug
from jpeg_detection_resnet_ssd_torch.data.dct_convert import check_codec, rgb_to_dct_tensors
from jpeg_detection_resnet_ssd_torch.data.pipeline import _load_record_rgb, _load_rgb
from jpeg_detection_resnet_ssd_torch.utils.distributed import process_count, process_index


class PackedDctDataset:
    """Memmap-backed fixed-frame DCT corpus for the device-augment path.

    Detection corpora (`create`) carry padded GT boxes; classification
    corpora (`create_classification`) carry int class labels."""

    def __init__(self, stem: str):
        self.stem = stem
        with open(stem + ".meta.json") as f:
            self.meta = json.load(f)
        self.y = np.load(stem + ".y.npy", mmap_mode="r")
        self.cbcr = np.load(stem + ".cbcr.npy", mmap_mode="r")
        labels = np.load(stem + ".labels.npz", allow_pickle=False)
        if "labels" in labels:  # classification corpus
            self.labels = labels["labels"]
            self.gt = self.gt_mask = None
        else:
            self.gt = labels["gt"]
            self.gt_mask = labels["gt_mask"]
            self.labels = None
        self.image_ids = [s for s in labels["image_ids"]]

    def __len__(self):
        return self.y.shape[0]

    @classmethod
    def create_classification(
        cls,
        dataset,
        stem: str,
        img_size: int = 256,
        quality: int = 75,
        num_workers: int = 8,
        verbose: bool = False,
        codec: str = "libjpeg",
    ) -> "PackedDctDataset":
        """Pack an (image, class-label) dataset (records `(path, label)`, as
        `ImageFolderDataset` gives) at the device-augment source frame
        (oversized, e.g. 256 = 32 luma blocks for a 224 crop): the
        evaluation view's resize, then the block DCT by `codec`."""
        check_codec(codec)
        n = len(dataset)
        s8 = img_size // 8
        os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
        y_arr = np.lib.format.open_memmap(
            stem + ".y.npy", mode="w+", dtype=np.int16, shape=(n, s8, s8, 64),
        )
        c_arr = np.lib.format.open_memmap(
            stem + ".cbcr.npy", mode="w+", dtype=np.int16, shape=(n, s8 // 2, s8 // 2, 128),
        )
        labels = np.zeros((n,), np.int32)
        image_ids = [""] * n

        def work(i):
            path, label = dataset[i]
            image = aug.classification_eval_view(_load_rgb(path), size=img_size)
            y, cbcr = rgb_to_dct_tensors(image, quality=quality, codec=codec)
            y_arr[i] = y.astype(np.int16)
            c_arr[i] = cbcr.astype(np.int16)
            labels[i] = label
            image_ids[i] = os.path.basename(path)
            if verbose and i % 1000 == 0:
                print(f"pack: {i}/{n}", flush=True)

        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(work, range(n)))
        y_arr.flush()
        c_arr.flush()
        np.savez(stem + ".labels.npz", labels=labels, image_ids=np.asarray(image_ids))
        with open(stem + ".meta.json", "w") as f:
            json.dump({"n": n, "img_size": img_size, "quality": quality,
                       "task": "classification"}, f)
        return cls(stem)

    @classmethod
    def create(
        cls,
        dataset,
        stem: str,
        img_height: int = 352,
        img_width: int = 352,
        max_gt: int = 64,
        quality: int = 75,
        num_workers: int = 8,
        verbose: bool = False,
        use_native: bool = True,
        codec: str = "libjpeg",
    ) -> "PackedDctDataset":
        """Decode + resize + block-DCT every record once.

        `dataset` is any detection dataset (records with image_path/bytes and
        (k, 5) `boxes`).  The frame is the device-augment source frame
        (oversized, e.g. 352 = 44 luma blocks for a 304 crop).

        `use_native=True` runs the per-image work (JPEG decode, cv2-convention
        bilinear resize, 4:2:0 re-encode, coefficient decode) in one C++ call
        (`dctjpeg.pack`) that releases the GIL.  Records the native path
        cannot decode (e.g. PNGs) take the Python path (`aug.resize` and
        `rgb_to_dct_tensors`); box rescaling is `aug.resize`'s either way.
        `codec="numpy"` takes the Python path for every record (PIL decode,
        `aug.resize`, the NumPy codec) and never calls libjpeg's encoder:
        the same files, where libjpeg is missing."""
        native = check_codec(codec) == "libjpeg" and use_native
        n = len(dataset)
        h8, w8 = img_height // 8, img_width // 8
        os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
        y_arr = np.lib.format.open_memmap(
            stem + ".y.npy", mode="w+", dtype=np.int16, shape=(n, h8, w8, 64),
        )
        c_arr = np.lib.format.open_memmap(
            stem + ".cbcr.npy", mode="w+", dtype=np.int16, shape=(n, h8 // 2, w8 // 2, 128),
        )
        gt = np.zeros((n, max_gt, 5), np.float32)
        gt_mask = np.zeros((n, max_gt), bool)
        image_ids = [""] * n

        def native_pack_record(rec):
            """One C++ call for the image; (y, cbcr, labels), or None when the
            record needs the Python path."""
            import io

            from PIL import Image

            from jpeg_detection_resnet_ssd_torch import dctjpeg

            buf = rec.get("image_bytes")
            if buf is None:
                with open(rec["image_path"], "rb") as f:
                    buf = f.read()
            try:
                # Header-only probe for the original size (PIL decodes
                # lazily), needed to rescale boxes as `aug.resize` does.
                with Image.open(io.BytesIO(buf)) as im:
                    if im.format != "JPEG":
                        return None
                    w0, h0 = im.size
                y, cbcr = dctjpeg.pack(buf, img_height, img_width, quality=quality)
            except (dctjpeg.JPEGDecodeError, OSError):
                return None
            labels = rec["boxes"].astype(np.float32).copy()
            if len(labels):
                labels[:, [1, 3]] *= img_width / w0
                labels[:, [2, 4]] *= img_height / h0
            return y, cbcr, labels

        def work(i):
            rec = dataset[i]
            out = native_pack_record(rec) if native else None
            if out is not None:
                y, cbcr, labels = out
            else:
                image = _load_record_rgb(rec)
                labels = rec["boxes"].copy()
                image, labels = aug.resize(
                    aug.to_3_channels(image), labels, img_height, img_width,
                    filter_degenerate=False,
                )
                y, cbcr = rgb_to_dct_tensors(image, quality=quality, codec=codec)
            y_arr[i] = y.astype(np.int16)
            c_arr[i] = cbcr.astype(np.int16)
            k = min(len(labels), max_gt)
            if k:
                gt[i, :k] = labels[:k]
                gt_mask[i, :k] = True
            image_ids[i] = str(rec.get("image_id", i))
            if verbose and i % 200 == 0:
                print(f"pack: {i}/{n}", flush=True)

        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(work, range(n)))
        y_arr.flush()
        c_arr.flush()
        np.savez(stem + ".labels.npz", gt=gt, gt_mask=gt_mask, image_ids=np.asarray(image_ids))
        with open(stem + ".meta.json", "w") as f:
            json.dump(
                {"n": n, "img_height": img_height, "img_width": img_width,
                 "max_gt": max_gt, "quality": quality},
                f,
            )
        return cls(stem)


def load_or_create(
    stem: str,
    dataset,
    *,
    task: str = "detection",
    num_workers: int = 8,
    verbose: bool = True,
    codec: str = "libjpeg",
    **create_kwargs,
) -> PackedDctDataset:
    """Create-or-load with staleness validation, safe across processes.

    Pass the full (unsharded) dataset.  The corpus is packed when
    `<stem>.meta.json` does not exist (`create_classification` for
    `task="classification"`, else `create`), by rank 0 alone (concurrent
    writers would corrupt the memmaps); then every rank validates the loaded
    corpus against the dataset's size and the pack parameters, so a stale
    cache (a different dataset, a changed frame size or quality) raises
    instead of training on the wrong data.  `codec` computes the planes
    when packing (both codecs write the same files, so a cache packed by
    either serves both).  Shard at the pipeline
    (`PackedDctPipeline(shard_index=..., shard_count=...)`), never here."""
    # Every rank enters the barrier whatever it sees on disk: a rank that
    # branched on its own os.path.exists() and saw the cache only after rank
    # 0 had packed it would skip the barrier while the others wait in it (a
    # TOCTOU across processes: a hang, or mispaired collectives).  Only the
    # create decision is rank 0's.
    if process_index() == 0 and not os.path.exists(stem + ".meta.json"):
        create = (PackedDctDataset.create_classification if task == "classification"
                  else PackedDctDataset.create)
        create(dataset, stem, num_workers=num_workers, verbose=verbose, codec=codec,
               **create_kwargs)
    if process_count() > 1:
        torch.distributed.barrier()
    packed = PackedDctDataset(stem)
    if len(packed) != len(dataset):
        raise ValueError(
            f"pack cache {stem} holds {len(packed)} records but the dataset "
            f"has {len(dataset)} — stale cache? delete {stem}.* to re-pack"
        )
    for k, v in create_kwargs.items():
        if k in packed.meta and packed.meta[k] != v:
            raise ValueError(
                f"pack cache {stem} was built with {k}={packed.meta[k]} but "
                f"this run wants {k}={v} — delete {stem}.* to re-pack"
            )
    return packed


class PackedDctPipeline:
    """Batch iterator over a PackedDctDataset: gather + cast, nothing else.

    Yields {'inputs': (y, cbcr), 'gt', 'gt_mask'} (or 'labels' for a
    classification corpus) as NumPy arrays: the batch contract of
    `fit(augment_fn=make_dct_detection_augment_v3(...), target_encoder=...)`.
    The epoch order is `np.random.default_rng((seed, epoch)).permutation`
    of the shard's indices when training; each batch's rows are gathered in
    ascending index order.  `ship_dtype=np.int16` halves the host->device
    copy; the device augment casts to float32 (use it only with an
    augment_fn: raw int16 into a conv would mispromote).
    """

    def __init__(
        self,
        dataset: PackedDctDataset,
        batch_size: int,
        *,
        train: bool = True,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        drop_last: bool = True,
        ship_dtype=np.float32,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.epoch = 0
        self.indices = np.arange(len(dataset))[shard_index::shard_count]
        self.drop_last = drop_last
        self.ship_dtype = np.dtype(ship_dtype)

    def __iter__(self):
        idx = self.indices
        if self.train:
            idx = np.random.default_rng((self.seed, self.epoch)).permutation(idx)
            self.epoch += 1
        end = len(idx) // self.batch_size * self.batch_size if self.drop_last else len(idx)
        for s in range(0, end, self.batch_size):
            take = np.sort(idx[s : s + self.batch_size])
            batch = {
                "inputs": (
                    np.ascontiguousarray(self.ds.y[take], self.ship_dtype),
                    np.ascontiguousarray(self.ds.cbcr[take], self.ship_dtype),
                ),
            }
            if self.ds.labels is not None:
                batch["labels"] = self.ds.labels[take]
            else:
                batch["gt"] = self.ds.gt[take]
                batch["gt_mask"] = self.ds.gt_mask[take]
            yield batch

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

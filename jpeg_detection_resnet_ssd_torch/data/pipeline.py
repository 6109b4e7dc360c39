"""Host-side input pipelines: threaded decode -> augment -> DCT -> batches.

Counterpart of the JAX package's `data/pipeline.py`, with the same seeded
epoch order and per-item generators, so both packages yield equal batches
from one dataset:

  * per-epoch shuffle from `np.random.default_rng((seed, epoch))` when
    training, dataset order otherwise;
  * a thread pool runs the per-image work (PIL decode, the augmentation
    chain, JPEG re-encode, native DCT decode); libjpeg, cv2 and ctypes
    release the GIL;
  * `prefetch_to_device` stages the next batches on the card from pinned
    memory while the current step runs.

Input formats:
  'dct'        -> (y, cbcr)
  'dct_deconv' -> (y, cb, cr)
  'rgb'        -> float32 image
  'dct_image'  -> (H, W, 3) DCT plane (jpegdecoder layout)
  'dct_255'    -> (H, W, 3) DCT plane rescaled to 0-255

`ClassificationPipeline` yields ImageNet-style batches (the training view
with host augmentation, or the evaluation resize); `DeviceDCTAugmentedPipeline`
decodes one oversized coefficient map per image on the host and crops and
flips it on the device.  PIL is imported inside the functions that decode,
so the package imports without it.
"""

from __future__ import annotations

import io
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.data import augment as aug
from jpeg_detection_resnet_ssd_torch.data.dct_convert import (
    check_codec,
    rgb_to_dct_image,
    rgb_to_dct_tensors,
)
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device


def _load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_record_rgb(rec: dict) -> np.ndarray:
    """Decode a detection record's image from bytes (HDF5 cache) or path."""
    if "image_bytes" in rec:
        from PIL import Image

        with Image.open(io.BytesIO(rec["image_bytes"])) as im:
            return np.asarray(im.convert("RGB"))
    return _load_rgb(rec["image_path"])


def _pack_inputs(images: list[np.ndarray], input_format: str, codec: str = "libjpeg"):
    """A batch of RGB images in a model's input contract: `rgb` (float32
    pixels), `dct_image` / `dct_255` (the jpegdecoder layout), `dct` (Y,
    CbCr planes) or `dct_deconv` (Y, Cb, Cr); `codec` computes the planes
    (`rgb_to_dct_tensors`)."""
    if input_format == "rgb":
        return np.stack(images).astype(np.float32)
    if input_format == "dct_image":
        return np.stack(
            [rgb_to_dct_image(im) for im in images]
        ).astype(np.float32)
    if input_format == "dct_255":
        # The `_dct_255` generator variant: each dequantized coefficient of
        # the jpegdecoder layout rescaled into 0-255 with the reference's
        # integer arithmetic `(x + 1024) * 255 // 2048` (floor division).
        planes = np.stack(
            [rgb_to_dct_image(im) for im in images]
        ).astype(np.int64)
        return ((planes + 1024) * 255 // 2048).astype(np.float32)
    ys, cbcrs = zip(*(rgb_to_dct_tensors(im, codec=codec) for im in images))
    y = np.stack(ys).astype(np.float32)
    cbcr = np.stack(cbcrs).astype(np.float32)
    if input_format == "dct_deconv":
        cb, cr = cbcr[..., :64], cbcr[..., 64:]
        return (y, cb, cr)
    if input_format == "dct":
        return (y, cbcr)
    raise ValueError(f"unknown input_format {input_format!r}")


class _BasePipeline:
    def __init__(self, dataset, batch_size: int, *, train: bool,
                 input_format: str = "dct", seed: int = 0,
                 num_workers: int = 8, drop_remainder: bool | None = None,
                 codec: str = "libjpeg"):
        if check_codec(codec) == "numpy" and input_format in ("dct_image", "dct_255"):
            raise ValueError(f"input_format {input_format!r} needs codec='libjpeg'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.input_format = input_format
        self.seed = seed
        self.num_workers = num_workers
        self.codec = codec
        self.drop_remainder = train if drop_remainder is None else drop_remainder
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self):
        order = np.arange(len(self.dataset))
        if self.train:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        return order

    def _item_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, int(index)))

    def __iter__(self):
        order = self._epoch_order()
        nb = len(self)
        for b in range(nb):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            items = list(self._pool.map(self._prepare_item, idx))
            yield self._collate(items)

    def _prepare_item(self, index):  # pragma: no cover - abstract
        raise NotImplementedError

    def _collate(self, items):  # pragma: no cover - abstract
        raise NotImplementedError


class ClassificationPipeline(_BasePipeline):
    """ImageNet-style batches {'inputs': ..., 'labels': int32 (B,)} from an
    `ImageFolderDataset` (records `(path, label)`).

    Training applies `augment.classification_train_view` with the item's
    generator; evaluation (or `host_augment=False` while training, the
    contract of the device-augment paths: epoch shuffling and
    drop_remainder stay, the host emits the deterministic view) applies
    `classification_eval_view`.  `codec` ("libjpeg" or "numpy", keyword
    of every pipeline) computes the DCT planes (`data.dct_convert`)."""

    def __init__(self, dataset, batch_size: int, *, train: bool,
                 input_format: str = "dct", image_size: int = 224,
                 host_augment: bool | None = None, **kw):
        super().__init__(dataset, batch_size, train=train,
                         input_format=input_format, **kw)
        self.image_size = image_size
        self.host_augment = train if host_augment is None else host_augment

    def _prepare_item(self, index):
        path, label = self.dataset[int(index)]
        image = _load_rgb(path)
        if self.host_augment:
            image = aug.classification_train_view(
                image, self._item_rng(index), self.image_size
            )
        else:
            image = aug.classification_eval_view(image, self.image_size)
        return image, label

    def _collate(self, items):
        images = [im for im, _ in items]
        labels = np.asarray([lab for _, lab in items], np.int32)
        return {
            "inputs": _pack_inputs(images, self.input_format, self.codec),
            "labels": labels,
        }


class DetectionPipeline(_BasePipeline):
    """Pascal-VOC-style detection batches.

    Training (`encoder` set): yields {'inputs', 'targets'}, or with
    `device_encode` the padded GT {'inputs', 'gt', 'gt_mask'} for a
    `Trainer` whose target encoder runs inside the step.  `targets` is the
    encoder's output, a tensor on the encoder's device.  Evaluation
    (`encoder=None`): yields {'inputs', 'labels', 'image_ids', 'inverters',
    'difficult'}, where the inverters map predicted boxes back to original
    image coordinates.

    `augmentation`: "default" is the Caffe-SSD host chain
    (`augment.SSDDataAugmentation(img_height, img_width)`) when training and
    none otherwise; None resizes only; a callable `(image, labels, rng) ->
    (image, labels)` is used as it is.  `codec` ("libjpeg" or "numpy")
    computes the DCT planes (`data.dct_convert.rgb_to_dct_tensors`).
    """

    def __init__(self, dataset, batch_size: int, *, train: bool,
                 encoder=None, augmentation: Callable | str | None = "default",
                 input_format: str = "dct", img_height: int = 300,
                 img_width: int = 300, max_gt: int = 64,
                 device_encode: bool = False, **kw):
        super().__init__(dataset, batch_size, train=train,
                         input_format=input_format, **kw)
        self.encoder = encoder
        self.device_encode = device_encode
        self.img_height, self.img_width = img_height, img_width
        self.max_gt = max_gt
        if augmentation == "default":
            augmentation = aug.SSDDataAugmentation(img_height, img_width) if train else None
        self.augmentation = augmentation

    def _prepare_item(self, index):
        rec = self.dataset[int(index)]
        image = _load_record_rgb(rec)
        labels = rec["boxes"].copy()
        inverter = None
        if self.augmentation is not None:
            image, labels = self.augmentation(
                image, labels, self._item_rng(index)
            )
        else:
            image = aug.to_3_channels(image)
            image, labels, inverter = aug.resize(
                image, labels, self.img_height, self.img_width,
                filter_degenerate=False, return_inverter=True,
            )
        difficult = rec.get(
            "difficult", np.zeros(len(rec["boxes"]), bool)
        )
        return image, labels, rec.get("image_id"), inverter, rec, difficult

    def _collate(self, items):
        images = [it[0] for it in items]
        labels_list = [it[1] for it in items]
        batch: dict[str, Any] = {
            "inputs": _pack_inputs(images, self.input_format, self.codec)
        }
        if self.encoder is not None:
            gt, mask = self.encoder.pad_labels(labels_list, self.max_gt)
            if self.device_encode:
                batch["gt"] = gt
                batch["gt_mask"] = mask
            else:
                batch["targets"] = self.encoder(gt, mask)
        else:
            # Evaluation contract: original-coordinate GT + inverse transforms.
            batch["labels"] = [it[4]["boxes"] for it in items]
            batch["image_ids"] = [it[2] for it in items]
            batch["inverters"] = [it[3] for it in items]
            batch["difficult"] = [it[5] for it in items]
        return batch


def _map_leaves(fn, tree, leaf_type):
    """`tree` with every `leaf_type` leaf replaced by `fn(leaf)`, through
    dicts, lists and tuples; other leaves as they are."""
    if isinstance(tree, leaf_type):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, leaf_type) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, leaf_type) for v in tree)
    return tree


def prefetch_to_device(iterator, size: int = 2, device: str | torch.device | None = None):
    """Yield `iterator`'s batches with their NumPy arrays as tensors on
    `device`, staged by a background thread up to `size` batches ahead.

    On a CUDA device the thread copies each array into pinned memory and on
    to the card with `non_blocking=True` on a side stream, and records an
    event; the consumer's stream waits for that event before the batch is
    handed out, so the copies overlap the step that runs meanwhile.  On the
    CPU the arrays become tensors that share their memory.  `device` None
    means CUDA and raises without a card.  An exception in the iterator is
    raised in the consumer; a consumer that stops early stops the thread.
    """
    return _prefetch(iterator, max(int(size), 1), resolve_device(device))


def _prefetch(iterator, size: int, dev: torch.device):
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(x):
        t = torch.from_numpy(x)
        if side is None:
            return t
        with torch.cuda.stream(side):
            return t.pin_memory().to(dev, non_blocking=True)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                staged = _map_leaves(stage, batch, np.ndarray)
                event = side.record_event() if side is not None else None
                if not put((staged, event, None)):
                    return
        except Exception as exc:  # handed to the consumer, which raises it
            put((None, None, exc))
            return
        put((end, None, None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            batch, event, exc = q.get()
            if exc is not None:
                raise exc
            if batch is end:
                return
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                # the tensors were allocated on the side stream: tell the
                # caching allocator that the consumer's stream uses them
                _map_leaves(lambda t: t.record_stream(stream), batch, torch.Tensor)
            yield batch
    finally:
        stop.set()
        thread.join()


class DeviceDCTAugmentedPipeline:
    """Recompression-free classification batches: the host decodes one
    oversized DCT map per image (`ClassificationPipeline(host_augment=False,
    image_size=source_size)`), and the crop and flip run on `device` in
    coefficient space.

    Training: step s's draws come from a CPU generator seeded
    `(seed << 20) ^ s` (the JAX pipeline's key), a random 16-px-aligned
    crop to `crop_blocks` and a flip (`ops.dct_random_crop_flip_apply`, the
    flip kernel on the card), then with `photometric` the DCT photometric
    op from the same generator.  Evaluation: the exact center crop.  Yields
    {'inputs': (y (B, c, c, 64), cbcr (B, c/2, c/2, 128)), 'labels'} with
    the planes as float32 tensors on `device` (None means CUDA and raises
    without a card)."""

    def __init__(self, dataset, batch_size: int, *, train: bool = True,
                 source_size: int = 256, crop_blocks: int = 28,
                 photometric: bool = True, seed: int = 0, num_workers: int = 8,
                 quality: int = 75, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.inner = ClassificationPipeline(
            dataset, batch_size, train=train, host_augment=False,
            input_format="dct", image_size=source_size, seed=seed,
            num_workers=num_workers,
        )
        self.train = train
        self.crop_blocks = crop_blocks
        self.photometric = photometric
        self.seed = seed
        self._step = 0

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        from jpeg_detection_resnet_ssd_torch.ops import _draws
        from jpeg_detection_resnet_ssd_torch.ops.dct_augment import (
            dct_random_crop_flip_apply,
            dct_random_photometric_apply,
            sample_crop_flip,
            sample_photometric,
        )

        c = self.crop_blocks
        for batch in self.inner:
            y, cbcr = batch["inputs"]
            if self.train:
                gen = torch.Generator().manual_seed((self.seed << 20) ^ self._step)
                self._step += 1
                b, h8, w8 = y.shape[:3]
                draws = {"crop": sample_crop_flip(b, h8, w8, gen, c)}
                if self.photometric:
                    draws["photometric"] = sample_photometric(b, gen)
                draws = _draws.to_device(draws, self.device)
                y, cbcr = (torch.from_numpy(a).to(self.device) for a in (y, cbcr))
                y, cbcr = dct_random_crop_flip_apply(y, cbcr, draws["crop"], c, c // 2)
                if self.photometric:
                    y, cbcr = dct_random_photometric_apply(y, cbcr, draws["photometric"])
            else:
                off = ((y.shape[1] - c) // 4) * 2
                offc, cb = off // 2, c // 2
                y = torch.from_numpy(np.ascontiguousarray(y[:, off:off + c, off:off + c]))
                cbcr = torch.from_numpy(
                    np.ascontiguousarray(cbcr[:, offc:offc + cb, offc:offc + cb]))
                y, cbcr = y.to(self.device), cbcr.to(self.device)
            yield {"inputs": (y, cbcr), "labels": batch["labels"]}

"""Dataset index sources: ImageNet class dirs, Pascal VOC XML, CSV, COCO JSON.

The port's copy of the JAX package's `data/datasets.py` (NumPy and the
standard library; h5py is imported inside `Hdf5ImageCache` only), so both
packages parse one tree into equal records.

All parsers are pure: they return plain Python lists of records
  classification: (path, class_index)
  detection:      {image_path, image_id, boxes: (k,5) float32
                   [class_id, xmin, ymin, xmax, ymax], difficult: (k,) bool}
Deterministic ordering (sorted) so per-host sharding is reproducible.
"""

from __future__ import annotations

import json
import os
import pickle
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class ImageFolderDataset:
    """ImageNet-style directory-of-class-dirs dataset.

    Labels come from a class-index JSON mapping `{index: [wnid, name]}` (the
    Keras `imagenet_class_index.json` format the reference loads,
    `generators.py:15-35`), or from sorted directory names when absent.
    """

    def __init__(self, root: str, class_index_json: str | None = None,
                 extensions=(".jpeg", ".jpg", ".png")):
        self.root = root
        if class_index_json:
            with open(class_index_json) as f:
                index = json.load(f)
            self.class_to_idx = {v[0]: int(k) for k, v in index.items()}
            self.idx_to_name = {int(k): v[1] for k, v in index.items()}
        else:
            dirs = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )
            self.class_to_idx = {d: i for i, d in enumerate(dirs)}
            self.idx_to_name = {i: d for i, d in enumerate(dirs)}
        self.samples: list[tuple[str, int]] = []
        for cls in sorted(self.class_to_idx):
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[cls])
                    )

    @property
    def num_classes(self) -> int:
        return len(self.class_to_idx)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def shard(self, process_index: int, process_count: int) -> "ImageFolderDataset":
        """Deterministic per-host shard (round-robin)."""
        out = object.__new__(ImageFolderDataset)
        out.root = self.root
        out.class_to_idx = self.class_to_idx
        out.idx_to_name = self.idx_to_name
        out.samples = self.samples[process_index::process_count]
        return out


def parse_voc_xml(
    images_dirs,
    image_set_filenames,
    annotations_dirs,
    classes=VOC_CLASSES,
    include_difficult: bool = True,
    exclude_truncated: bool = False,
):
    """Pascal VOC: returns a list of detection records.

    Mirrors `DataGenerator.parse_xml`
    (`object_detection_2d_data_generator.py:406-546`): class_id 0 is
    background; VOC class names map to ids 1..20 in the canonical order.
    """
    if isinstance(images_dirs, str):
        images_dirs = [images_dirs]
    if isinstance(image_set_filenames, str):
        image_set_filenames = [image_set_filenames]
    if isinstance(annotations_dirs, str):
        annotations_dirs = [annotations_dirs]
    name_to_id = {n: i + 1 for i, n in enumerate(classes)}
    records = []
    for images_dir, set_file, ann_dir in zip(
        images_dirs, image_set_filenames, annotations_dirs
    ):
        with open(set_file) as f:
            image_ids = [line.strip().split()[0] for line in f if line.strip()]
        for image_id in image_ids:
            xml_path = os.path.join(ann_dir, image_id + ".xml")
            boxes, difficult = [], []
            if os.path.exists(xml_path):
                root = ET.parse(xml_path).getroot()
                for obj in root.findall("object"):
                    name = obj.findtext("name")
                    if name not in name_to_id:
                        continue
                    is_difficult = (obj.findtext("difficult") or "0").strip() == "1"
                    is_truncated = (obj.findtext("truncated") or "0").strip() == "1"
                    if not include_difficult and is_difficult:
                        continue
                    if exclude_truncated and is_truncated:
                        continue
                    bb = obj.find("bndbox")
                    boxes.append(
                        [
                            name_to_id[name],
                            float(bb.findtext("xmin")),
                            float(bb.findtext("ymin")),
                            float(bb.findtext("xmax")),
                            float(bb.findtext("ymax")),
                        ]
                    )
                    difficult.append(is_difficult)
            records.append(
                {
                    "image_path": os.path.join(images_dir, image_id + ".jpg"),
                    "image_id": image_id,
                    "boxes": np.asarray(boxes, np.float32).reshape(-1, 5),
                    "difficult": np.asarray(difficult, bool),
                }
            )
    return records


def parse_detection_csv(csv_path: str, images_dir: str):
    """CSV rows `image_name,xmin,xmax,ymin,ymax,class_id` (the ssd_keras CSV
    contract, `object_detection_2d_data_generator.py:273-404`)."""
    import csv as _csv

    by_image: dict[str, list] = {}
    with open(csv_path, newline="") as f:
        reader = _csv.reader(f)
        header = next(reader)
        for row in reader:
            if not row:
                continue
            name, xmin, xmax, ymin, ymax, cls = row[:6]
            by_image.setdefault(name, []).append(
                [float(cls), float(xmin), float(ymin), float(xmax), float(ymax)]
            )
    records = []
    for name in sorted(by_image):
        boxes = np.asarray(by_image[name], np.float32)
        records.append(
            {
                "image_path": os.path.join(images_dir, name),
                "image_id": os.path.splitext(name)[0],
                "boxes": boxes,
                "difficult": np.zeros(len(boxes), bool),
            }
        )
    return records


def parse_coco_json(annotations_json: str, images_dir: str,
                    include_crowd: bool = False):
    """MS COCO instances JSON -> detection records with contiguous class ids
    (1..n in the categories list's FILE order — the reference enumerates
    `annotations['categories']` as-is, `eval_utils/coco_utils.py:54-57` /
    `object_detection_2d_data_generator.py` parse_json; real COCO files list
    categories id-ascending so the two orders coincide there, but the file
    order is the genuine contract — pinned by tests/test_reference_parity)."""
    with open(annotations_json) as f:
        coco = json.load(f)
    cat_to_contiguous = {
        c["id"]: i + 1 for i, c in enumerate(coco["categories"])
    }
    images = {im["id"]: im for im in coco["images"]}
    by_image: dict[int, list] = {im_id: [] for im_id in images}
    for ann in coco["annotations"]:
        if not include_crowd and ann.get("iscrowd", 0):
            continue
        x, y, w, h = ann["bbox"]
        by_image[ann["image_id"]].append(
            [cat_to_contiguous[ann["category_id"]], x, y, x + w, y + h]
        )
    records = []
    for im_id in sorted(by_image):
        im = images[im_id]
        boxes = np.asarray(by_image[im_id], np.float32).reshape(-1, 5)
        records.append(
            {
                "image_path": os.path.join(images_dir, im["file_name"]),
                "image_id": im_id,
                "boxes": boxes,
                "difficult": np.zeros(len(boxes), bool),
            }
        )
    return records, cat_to_contiguous


@dataclass
class DetectionDataset:
    """A list of detection records + convenience IO.

    Covers the roles of the reference generator's dataset state: pickled
    save/load (`save_dataset`, `object_detection_2d_data_generator.py:1208`)
    and in-memory packing (the HDF5 path's purpose was host-RAM locality; a
    pickle of decoded records serves the same role portably).
    """

    records: list = field(default_factory=list)

    @classmethod
    def from_voc(cls, *args, **kwargs):
        return cls(parse_voc_xml(*args, **kwargs))

    @classmethod
    def from_csv(cls, *args, **kwargs):
        return cls(parse_detection_csv(*args, **kwargs))

    @classmethod
    def from_coco(cls, *args, **kwargs):
        records, _ = parse_coco_json(*args, **kwargs)
        return cls(records)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    def shard(self, process_index: int, process_count: int):
        return DetectionDataset(self.records[process_index::process_count])

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.records, f)

    @classmethod
    def load(cls, path: str):
        with open(path, "rb") as f:
            return cls(pickle.load(f))


class Hdf5ImageCache:
    """HDF5-packed detection dataset: encoded image bytes + labels in one file.

    Role of `DataGenerator.create_hdf5_dataset`
    (`object_detection_2d_data_generator.py:673`): removes per-image
    filesystem round trips for datasets that fit local disk.  Images are
    stored as variable-length uint8 (original encoded bytes — no
    recompression); records come back with an `image_bytes` field the
    pipelines decode in place of `image_path`.
    """

    def __init__(self, h5_path: str):
        import h5py

        self._f = h5py.File(h5_path, "r")
        self._n = self._f.attrs["n_records"]

    @classmethod
    def create(cls, dataset, h5_path: str, verbose: bool = False):
        import h5py

        with h5py.File(h5_path, "w") as f:
            n = len(dataset)
            f.attrs["n_records"] = n
            vlen_u8 = h5py.special_dtype(vlen=np.uint8)
            vlen_f4 = h5py.special_dtype(vlen=np.float32)
            images = f.create_dataset("images", (n,), dtype=vlen_u8)
            boxes = f.create_dataset("boxes", (n,), dtype=vlen_f4)
            difficult = f.create_dataset(
                "difficult", (n,), dtype=h5py.special_dtype(vlen=np.uint8)
            )
            ids = f.create_dataset(
                "image_ids", (n,), dtype=h5py.string_dtype()
            )
            for i in range(n):
                rec = dataset[i]
                with open(rec["image_path"], "rb") as img:
                    images[i] = np.frombuffer(img.read(), np.uint8)
                boxes[i] = np.asarray(rec["boxes"], np.float32).reshape(-1)
                difficult[i] = np.asarray(rec["difficult"], np.uint8)
                ids[i] = str(rec["image_id"])
                if verbose and i % 500 == 0:
                    print(f"hdf5 pack: {i}/{n}")
        return cls(h5_path)

    def __len__(self):
        return int(self._n)

    def __getitem__(self, i):
        return {
            "image_bytes": bytes(self._f["images"][i]),
            "boxes": np.asarray(self._f["boxes"][i], np.float32).reshape(-1, 5),
            "difficult": np.asarray(self._f["difficult"][i], bool),
            "image_id": (
                self._f["image_ids"][i].decode()
                if isinstance(self._f["image_ids"][i], bytes)
                else str(self._f["image_ids"][i])
            ),
        }

    def shard(self, process_index: int, process_count: int):
        # HDF5-backed sharding: materialize the shard's records lazily via a
        # view object.
        parent = self

        class _Shard:
            def __init__(self):
                self._idx = list(range(process_index, len(parent),
                                       process_count))

            def __len__(self):
                return len(self._idx)

            def __getitem__(self, i):
                return parent[self._idx[i]]

        return _Shard()

    def close(self):
        self._f.close()

"""Image datasets (the JAX package's data/datasets.py): CIFAR-10 from the
python-pickle layout on disk, and the deterministic synthetic stand-in.

The synthetic sets draw from numpy's ``RandomState`` exactly as the JAX
package does, so the images and labels are bitwise its own. Nothing is
downloaded: ``--download`` is refused by the entry.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import tarfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..native import chw_to_hwc_u8

# The reference's normalization constants
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGE_STATS = {"cifar10": (CIFAR10_MEAN, CIFAR10_STD),
               "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: images NHWC uint8, integer labels."""

    images: np.ndarray  # (N, H, W, C) uint8
    labels: np.ndarray  # (N,) int32
    num_classes: int
    name: str = "dataset"
    synthetic: bool = False

    def __post_init__(self):
        if self.images.ndim != 4 or self.images.dtype != np.uint8:
            raise ValueError(f"images must be (N, H, W, C) uint8, got "
                             f"{self.images.dtype} {self.images.shape}")
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but "
                             f"{len(self.labels)} labels")
        self.labels = self.labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.images)


def _cifar_batches_dir(data_dir: Path) -> Optional[Path]:
    for cand in (data_dir / "cifar-10-batches-py", data_dir):
        if (cand / "data_batch_1").exists():
            return cand
    tar = data_dir / "cifar-10-python.tar.gz"
    if tar.exists():
        with tarfile.open(tar) as tf:
            tf.extractall(data_dir, filter="data")
        cand = data_dir / "cifar-10-batches-py"
        if (cand / "data_batch_1").exists():
            return cand
    return None


def load_cifar10(data_dir: str, train: bool) -> Optional[ArrayDataset]:
    """Read the standard CIFAR-10 python-pickle layout (what torchvision's
    download writes). None when it is not on disk. The pickles are the
    user's own files, read as the reference reads them."""
    root = _cifar_batches_dir(Path(data_dir))
    if root is None:
        return None
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for fname in files:
        with open(root / fname, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        xs.append(np.asarray(entry["data"], np.uint8))
        ys.append(np.asarray(entry.get("labels", entry.get("fine_labels")),
                             np.int32))
    images = chw_to_hwc_u8(np.concatenate(xs), 3, 32, 32)
    return ArrayDataset(images, np.concatenate(ys), num_classes=10,
                        name="cifar10", synthetic=False)


def synthetic_image_dataset(n: int, hw: Tuple[int, int] = (32, 32),
                            num_classes: int = 10, seed: int = 0,
                            name: str = "synthetic") -> ArrayDataset:
    """Deterministic synthetic classification data: class-conditional
    means (from a fixed seed, shared by train and val) plus noise, so the
    loss can fall."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    class_means = np.random.RandomState(1234).randint(
        40, 216, size=(num_classes, 1, 1, 3))
    noise = rng.randint(-40, 40, size=(n, *hw, 3))
    images = np.clip(class_means[labels] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(images, labels, num_classes=num_classes,
                        name=name, synthetic=True)


_SYNTH_SIZES = {"cifar10": (50_000, 10_000), "imagenet": (10_000, 1_000)}


def load_imagenet(data_dir: str, train: bool) -> Optional[ArrayDataset]:
    """The packed layout: ``{data_dir}/imagenet/{split}_images.npy``
    (N, H, W, 3) uint8, memory-mapped, and ``{split}_labels.npy``. None
    when absent."""
    split = "train" if train else "val"
    base = Path(data_dir) / "imagenet"
    img_p, lab_p = base / f"{split}_images.npy", base / f"{split}_labels.npy"
    if not (img_p.exists() and lab_p.exists()):
        return None
    images = np.load(img_p, mmap_mode="r")
    labels = np.load(lab_p)
    classes_p = base / "classes.json"
    num_classes = (len(json.loads(classes_p.read_text()))
                   if classes_p.exists() else int(labels.max()) + 1)
    return ArrayDataset(images, labels, num_classes=num_classes,
                        name=f"imagenet-{split}", synthetic=False)


def get_dataset(name: str, data_dir: str = "./data", train: bool = True,
                synthetic: bool = False,
                synthetic_size: Optional[int] = None,
                seed: int = 0) -> ArrayDataset:
    """The dataset factory: the real set from ``data_dir`` when present
    (and ``synthetic`` is not forced), else the synthetic stand-in, flagged
    by ``.synthetic``."""
    name = name.lower()
    if name == "cifar10":
        if not synthetic:
            ds = load_cifar10(data_dir, train)
            if ds is not None:
                return ds
        n = synthetic_size or _SYNTH_SIZES["cifar10"][0 if train else 1]
        return synthetic_image_dataset(n, (32, 32), 10,
                                       seed=seed + (0 if train else 1),
                                       name="cifar10-synthetic")
    if name == "imagenet":
        if not synthetic:
            ds = load_imagenet(data_dir, train)
            if ds is not None:
                return ds
        n = synthetic_size or _SYNTH_SIZES["imagenet"][0 if train else 1]
        return synthetic_image_dataset(n, (224, 224), 1000,
                                       seed=seed + (0 if train else 1),
                                       name="imagenet-synthetic")
    raise ValueError(f"unknown dataset {name!r} (cifar10, imagenet)")

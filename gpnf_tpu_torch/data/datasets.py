"""CIFAR-10, ImageNet-32/64 and synthetic image datasets as shuffling
numpy loaders.

Counterpart of the cifar10/imagenet/synthetic part of
gpnf_tpu/data/datasets.py: the CIFAR-10 python pickle batches, the
downsampled-ImageNet npz shards (train_data_batch_*.npz and val_data.npz)
or an image folder of PNGs (<root>/train/**.png and <root>/val/**.png) are
read from disk when present, otherwise a deterministic synthetic set of the
dataset's size stands in. Pixels are float32 NCHW in [-0.5, 0.5]. The
CIFAR-10 training loader augments on the host with the JAX package's
shift-and-flip (its numpy path; the JAX package's optional C++ pass makes
the same decisions). Not ported yet: the MNIST reader.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, Optional

import numpy as np

from ..utils.png import read_png

SIZES = {"cifar10": 32, "imagenet_32": 32, "imagenet_64": 64, "synthetic": 32}


class NumpyLoader:
    """Mini-batch iterator over uint8 NCHW images; augment="cifar" shifts
    and flips each training image."""

    def __init__(self, images: np.ndarray, batch_size: int, *, shuffle: bool,
                 augment: str = "none", seed: int = 0, drop_last: bool = True):
        self.images = images
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = self.images.shape[0] // self.batch_size
        if not self.drop_last and self.images.shape[0] % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(self.images.shape[0])
        if self.shuffle:
            self.rng.shuffle(idx)
        end = ((len(idx) // self.batch_size) * self.batch_size
               if self.drop_last else len(idx))
        for start in range(0, end, self.batch_size):
            batch = self.images[idx[start: start + self.batch_size]]
            if self.augment == "cifar":
                n = batch.shape[0]
                shifts = self.rng.integers(0, 6, size=n).astype(np.int32)
                horiz = (self.rng.random(n) < 0.5).astype(np.uint8)
                flip = (self.rng.random(n) < 0.5).astype(np.uint8)
                batch = shift_flip(batch, 3, shifts, horiz, flip)
            yield batch.astype(np.float32) / 255.0 - 0.5


def shift_flip(batch: np.ndarray, pixels: int, shifts, horizontal,
               flip) -> np.ndarray:
    """Edge-pad by `pixels`, crop at offset shifts[i] along one axis
    (horizontal[i] picks which), and mirror left-right where flip[i]."""
    n, _, h, w = batch.shape
    padded = np.pad(batch, ((0, 0), (0, 0), (pixels, pixels), (pixels, pixels)),
                    mode="edge")
    out = np.empty_like(batch)
    for i in range(n):
        s = int(shifts[i])
        if horizontal[i]:
            img = padded[i, :, pixels: pixels + h, s: s + w]
        else:
            img = padded[i, :, s: s + h, pixels: pixels + w]
        out[i] = img[:, :, ::-1] if flip[i] else img
    return out


def _load_cifar10(root: str):
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None

    def read(fn):
        # the CIFAR-10 distribution format; read only from a local data root
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return d[b"data"].reshape(-1, 3, 32, 32)

    train = np.concatenate([read(f"data_batch_{i}") for i in range(1, 6)])
    return train.astype(np.uint8), read("test_batch").astype(np.uint8)


def _load_imagenet_npz(root: str, size: int):
    """Downsampled-ImageNet npz shards: train_data_batch_*.npz and
    val_data.npz, each with a `data` array of rows of 3 * size * size."""
    train_files = sorted(glob.glob(os.path.join(root,
                                                "train_data_batch_*.npz")))
    val = os.path.join(root, "val_data.npz")
    if not train_files or not os.path.exists(val):
        return None

    def read(fn):
        with np.load(fn) as d:
            return d["data"].reshape(-1, 3, size, size).astype(np.uint8)

    return np.concatenate([read(f) for f in train_files]), read(val)


def _load_imagefolder(root: str, size: int):
    """<root>/train/**.png and <root>/val/**.png, class folders allowed and
    ignored (the density model is unconditional); every image size x size."""

    def read_split(split):
        paths = sorted(glob.glob(os.path.join(root, split, "**", "*.png"),
                                 recursive=True))
        if not paths:
            return None
        imgs = []
        for path in paths:
            img = read_png(path)  # (H, W, 3) uint8
            if img.shape[:2] != (size, size):
                raise ValueError(f"{path}: expected {size}x{size}, got "
                                 f"{img.shape}")
            imgs.append(np.transpose(img, (2, 0, 1)))
        return np.stack(imgs).astype(np.uint8)

    train, val = read_split("train"), read_split("val")
    if train is None or val is None:
        return None
    return train, val


def _synthetic(size: int, n_train: int = 2048, n_test: int = 512, seed: int = 7):
    """Deterministic structured images (smooth gradients + texture)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    def make(n):
        phase = rng.uniform(0, 2 * np.pi, (n, 3, 1, 1)).astype(np.float32)
        freq = rng.uniform(1, 4, (n, 3, 1, 1)).astype(np.float32)
        img = 0.5 + 0.5 * np.sin(2 * np.pi * freq * (xx + yy)[None, None] + phase)
        img = img + rng.normal(0, 0.08, (n, 3, size, size)).astype(np.float32)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    return make(n_train), make(n_test)


def get_dataset(name: str, batch_size: int, data_root: Optional[str] = None,
                seed: int = 0):
    """Returns (train_loader, test_loader, image_shape (H, W, C))."""
    name = name.lower()
    if name not in SIZES:
        raise ValueError(f"dataset {name!r} is not ported yet "
                         f"({', '.join(SIZES)} are)")
    root = data_root or os.environ.get("GPNF_DATA_ROOT", "./data")
    size = SIZES[name]
    loaded = None
    if name == "cifar10":
        loaded = _load_cifar10(root)
    elif name.startswith("imagenet"):
        loaded = (_load_imagenet_npz(root, size)
                  or _load_imagefolder(root, size))
    augment = "cifar" if name == "cifar10" else "none"
    train, test = loaded if loaded is not None else _synthetic(size)
    return (NumpyLoader(train, batch_size, shuffle=True, augment=augment,
                        seed=seed),
            NumpyLoader(test, batch_size, shuffle=False), (size, size, 3))

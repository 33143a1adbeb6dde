"""Image datasets: MNIST / CIFAR-10 / CIFAR-100 / SVHN as uint8 NHWC numpy
arrays, the port's own copy of ``pytorch_distributed_nn_tpu/data/
datasets.py`` (the same constants, parsers, synthetic recipe and
augmentation; nothing here imports the JAX package).

Real data under ``<data_dir>/<name lower>_data`` (MNIST idx files, CIFAR
pickle batches, SVHN .mat) is parsed with numpy; nothing is ever
downloaded. Without it, a deterministic synthetic set of the real
shapes and sizes stands in (byte for byte the JAX package's), and the
returned dataset says so.

Augmentation (the reference's CIFAR/SVHN transform): reflect-pad 4,
random 32x32 crop, random horizontal flip. :func:`augment_batch` is the
numpy gather of the JAX package's host path; the JAX package's threaded
C++ engine for it (``data/native_augment.py``), which produces the same
bytes, is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np

_MNIST_MEAN, _MNIST_STD = (0.1307,), (0.3081,)
_CIFAR_MEAN = tuple(x / 255.0 for x in (125.3, 123.0, 113.9))
_CIFAR_STD = tuple(x / 255.0 for x in (63.0, 62.1, 66.7))
_SVHN_MEAN, _SVHN_STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)

DATASETS = ("MNIST", "Cifar10", "Cifar100", "SVHN")


@dataclasses.dataclass
class Dataset:
    """One split: uint8 NHWC pixels, int32 labels and the normalisation
    constants; ``images`` is the normalised f32 view, made on first use."""

    name: str
    labels: np.ndarray
    num_classes: int
    augment: bool  # apply train-time augmentation in the loader
    raw_images: np.ndarray
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    synthetic: bool = False
    _images: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def images(self) -> np.ndarray:
        if self._images is None:
            self._images = normalize(self.raw_images, self.mean, self.std)
        return self._images

    def __len__(self):
        return len(self.raw_images)


def spec(name: str):
    """(shape, classes, mean, std, train size, test size) of a dataset."""
    if name == "MNIST":
        return (28, 28, 1), 10, _MNIST_MEAN, _MNIST_STD, 60000, 10000
    if name == "Cifar10":
        return (32, 32, 3), 10, _CIFAR_MEAN, _CIFAR_STD, 50000, 10000
    if name == "Cifar100":
        return (32, 32, 3), 100, _CIFAR_MEAN, _CIFAR_STD, 50000, 10000
    if name == "SVHN":
        return (32, 32, 3), 10, _SVHN_MEAN, _SVHN_STD, 73257, 26032
    raise ValueError(f"unknown dataset {name!r}; available: {DATASETS}")


def normalize(images_uint8: np.ndarray, mean, std) -> np.ndarray:
    x = images_uint8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _read_idx(path: str) -> np.ndarray:
    """An MNIST idx file (optionally .gz): big-endian magic + dims."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    ndim = int.from_bytes(raw[0:4], "big") & 0xFF
    dims = [int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(raw, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find_idx(root: str, stem: str):
    for base in (os.path.join(root, "MNIST", "raw"), root):
        for suffix in ("", ".gz"):
            p = os.path.join(base, stem + suffix)
            if os.path.isfile(p):
                return p
    return None


def _load_mnist(root: str, train: bool):
    stem = "train" if train else "t10k"
    imgs_p = _find_idx(root, f"{stem}-images-idx3-ubyte")
    labels_p = _find_idx(root, f"{stem}-labels-idx1-ubyte")
    if imgs_p is None or labels_p is None:
        return None
    return _read_idx(imgs_p)[..., None], _read_idx(labels_p).astype(np.int32)


def _load_cifar(root: str, train: bool, coarse100: bool):
    if coarse100:
        paths = [os.path.join(root, "cifar-100-python",
                              "train" if train else "test")]
        label_key = b"fine_labels"
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        paths = ([os.path.join(base, f"data_batch_{i}") for i in range(1, 6)]
                 if train else [os.path.join(base, "test_batch")])
        label_key = b"labels"
    if not all(os.path.isfile(p) for p in paths):
        return None
    imgs, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8))
        labels.append(np.asarray(d[label_key], np.int32))
    imgs = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs, np.concatenate(labels)


def _load_svhn(root: str, train: bool):
    path = os.path.join(root, f"{'train' if train else 'test'}_32x32.mat")
    if not os.path.isfile(path):
        return None
    from scipy.io import loadmat

    d = loadmat(path)
    imgs = np.transpose(d["X"], (3, 0, 1, 2))  # HWCN -> NHWC
    labels = d["y"].astype(np.int32).ravel()
    labels[labels == 10] = 0  # SVHN stores digit 0 as class 10
    return imgs, labels


def try_load_real(name: str, data_dir: str, train: bool):
    """(images, labels) from disk when the canonical files are there and
    parse, else None (never downloads)."""
    loaders = {"MNIST": lambda: _load_mnist(data_dir, train),
               "Cifar10": lambda: _load_cifar(data_dir, train, False),
               "Cifar100": lambda: _load_cifar(data_dir, train, True),
               "SVHN": lambda: _load_svhn(data_dir, train)}
    try:
        return loaders[name]()
    except (OSError, ValueError, KeyError, ImportError, EOFError,
            pickle.UnpicklingError):
        return None


def synthetic(name: str, train: bool, seed: int = 0,
              size: Optional[int] = None):
    """Deterministic class-structured fake data of the real shapes: a fixed
    random template per class plus N(0, 64^2) noise, clipped to bytes."""
    shape, n_classes, _, _, n_train, n_test = spec(name)
    n = size if size is not None else (n_train if train else n_test)
    rng = np.random.RandomState(seed if train else seed + 1)
    templates = np.random.RandomState(42).randint(
        0, 256, size=(n_classes, *shape)).astype(np.float32)
    labels = rng.randint(0, n_classes, size=(n,)).astype(np.int32)
    noise = rng.normal(0.0, 64.0, size=(n, *shape)).astype(np.float32)
    imgs = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return imgs, labels


def load_dataset(name: str, train: bool, data_dir: str = "./data",
                 synthetic_size: Optional[int] = None) -> Dataset:
    """One split of ``name``: real files when present (and no
    ``synthetic_size`` is forced), else the synthetic set."""
    shape, n_classes, mean, std, _, _ = spec(name)
    real = None if synthetic_size is not None else try_load_real(
        name, os.path.join(data_dir, name.lower() + "_data"), train)
    if real is None:
        imgs, labels = synthetic(name, train, size=synthetic_size)
    else:
        imgs, labels = real
    if imgs.shape[1:] != shape:
        raise ValueError(f"{name}: images of shape {imgs.shape[1:]}, "
                         f"expected {shape}")
    return Dataset(name=name, labels=labels, num_classes=n_classes,
                   augment=train and name != "MNIST", synthetic=real is None,
                   raw_images=np.ascontiguousarray(imgs), mean=tuple(mean),
                   std=tuple(std))


def augment_draws(rng: np.random.RandomState, n: int):
    """(ys, xs, flip) crop origins in [0, 9) and flips of one batch, drawn
    in the order the JAX package's ``augment_batch`` draws them."""
    ys = rng.randint(0, 9, size=n)
    xs = rng.randint(0, 9, size=n)
    flip = rng.rand(n) < 0.5
    return ys, xs, flip


def augment_gather(images: np.ndarray, ys, xs, flip) -> np.ndarray:
    """Reflect-pad 4, crop at (ys, xs), flip: one strided-view gather."""
    n, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (h, w), axis=(1, 2))
    out = windows[np.arange(n), ys, xs]  # (n, c, h, w)
    out = np.ascontiguousarray(np.moveaxis(out, 1, -1))
    out[flip] = out[flip, :, ::-1]
    return out


def augment_batch(images: np.ndarray,
                  rng: np.random.RandomState) -> np.ndarray:
    """The reference's train transform on a batch, with draws from rng."""
    return augment_gather(images, *augment_draws(rng, len(images)))

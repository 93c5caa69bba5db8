"""Array datasets, the built-in and synthetic loaders, deterministic splits.

Counterpart of ``deepcv_tpu/data/datasets.py`` (``ArrayDataset``,
``load_dataset`` for catalog entries of ``type: synthetic``, ``cifar10``,
``cifar100``, ``mnist`` and ``fashion_mnist``, ``split_dataset``), copied
so that the port imports nothing of the JAX package. Everything is numpy
and seeded the same way, so a catalog entry gives the same images and a
split the same indices as in the JAX package.

A built-in dataset comes from, in order: its ``.npz`` cache under the
root; the canonical on-disk files (CIFAR python pickles, MNIST idx),
parsed with the standard library and cached; the cached synthetic
stand-in ``<name>_<split>_synthetic.npz``; or that stand-in generated by
:func:`_synthetic_like` and cached. Nothing is downloaded: the JAX
package's torchvision step is left out. Other catalog types (image
folders, tar shards, torchvision datasets) are not ported yet and raise.
"""
from __future__ import annotations

import gzip
import logging
import pickle
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["ArrayDataset", "load_dataset", "split_dataset", "DATASET_LOADERS",
           "DEFAULT_DATA_ROOT"]

_logger = logging.getLogger(__name__)

DEFAULT_DATA_ROOT = Path("data/01_raw")


class ArrayDataset:
    """In-memory dataset: images (N, H, W, C) uint8/float + targets (N, ...);
    ``classes`` names the labels (the classifier head's width)."""

    def __init__(self, images: np.ndarray, targets: np.ndarray,
                 classes: Optional[Sequence[str]] = None, name: str = "dataset",
                 provenance: str = "real"):
        if len(images) != len(targets):
            raise ValueError(f"images/targets length mismatch: {len(images)} vs {len(targets)}")
        self.images = images
        self.targets = targets
        self.classes = list(classes) if classes is not None else None
        self.name = name
        #: 'real' (on-disk pixels) or 'synthetic' (generated)
        self.provenance = provenance

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.targets[idx]

    @property
    def image_shape(self) -> Tuple[int, ...]:
        return tuple(self.images.shape[1:])

    @property
    def num_classes(self) -> Optional[int]:
        if self.classes is not None:
            return len(self.classes)
        if np.issubdtype(self.targets.dtype, np.integer):
            return int(self.targets.max()) + 1
        return None

    def subset(self, indices: np.ndarray, name: Optional[str] = None) -> "ArrayDataset":
        return ArrayDataset(self.images[indices], self.targets[indices],
                            classes=self.classes, name=name or f"{self.name}_subset",
                            provenance=self.provenance)

    def __repr__(self):
        return (f"ArrayDataset({self.name}, n={len(self)}, image_shape={self.image_shape}, "
                f"provenance={self.provenance})")


def _synthetic(root=None, train=True, n: int = 512, image_shape=(32, 32, 3),
               num_classes: int = 10, seed: int = 0, **kw) -> ArrayDataset:
    """Deterministic synthetic dataset (no download): uniform uint8 pixels
    and uniform labels from ``numpy.random.default_rng(seed + (0 if train
    else 1))``."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    images = rng.integers(0, 256, size=(n, *image_shape), dtype=np.uint8)
    targets = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    return ArrayDataset(images, targets,
                        classes=[str(i) for i in range(num_classes)],
                        name=f"synthetic_{'train' if train else 'test'}",
                        provenance="synthetic")


#: shapes of the built-in datasets: (image shape, classes, train size, test size)
_KNOWN_SHAPES = {
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
    "cifar100": ((32, 32, 3), 100, 50000, 10000),
    "mnist": ((28, 28, 1), 10, 60000, 10000),
    "fashion_mnist": ((28, 28, 1), 10, 60000, 10000),
}


def _split_name(name: str, train: bool) -> str:
    return f"{name}_{'train' if train else 'test'}"


def _synthetic_like(name: str, train: bool) -> ArrayDataset:
    """A deterministic stand-in of a built-in dataset's shape: per-class
    base images plus noise, bit-identical to the JAX package's."""
    shape, ncls, ntrain, ntest = _KNOWN_SHAPES[name]
    n = ntrain if train else ntest
    # zlib.crc32, not hash(): str hashes are salted per process
    rng = np.random.default_rng(zlib.crc32(name.encode()) + (0 if train else 1))
    targets = rng.integers(0, ncls, size=(n,)).astype(np.int64)
    base = rng.integers(0, 256, size=(ncls, *shape), dtype=np.uint8)
    noise = rng.integers(0, 64, size=(n, *shape), dtype=np.uint8)
    images = np.clip(base[targets].astype(np.int16) + noise - 32, 0, 255).astype(np.uint8)
    return ArrayDataset(images, targets, classes=[str(i) for i in range(ncls)],
                        name=f"{_split_name(name, train)}_synthetic",
                        provenance="synthetic")


def _parse_cifar_pickle(name: str, root: Path, train: bool) -> Optional[ArrayDataset]:
    """The canonical CIFAR python-pickle layout under ``root``
    (``cifar-10-batches-py/data_batch_{1..5}|test_batch`` or
    ``cifar-100-python/train|test``, or ``root`` itself): CHW uint8 rows
    -> NHWC."""
    if name == "cifar10":
        sub, files = "cifar-10-batches-py", (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"])
        label_key, meta_file, names_key = b"labels", "batches.meta", b"label_names"
    else:
        sub, files = "cifar-100-python", (["train"] if train else ["test"])
        label_key, meta_file, names_key = b"fine_labels", "meta", b"fine_label_names"
    d = root / sub
    if not (d / files[0]).exists():
        d = root
        if not (d / files[0]).exists():
            return None
    xs, ys = [], []
    for f in files:
        with open(d / f, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        rows = np.asarray(batch[b"data"], np.uint8)
        xs.append(rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.extend(batch[label_key])
    classes = None
    if (d / meta_file).exists():
        with open(d / meta_file, "rb") as fh:
            meta = pickle.load(fh, encoding="bytes")
        classes = [c.decode() for c in meta[names_key]]
    return ArrayDataset(np.ascontiguousarray(np.concatenate(xs)),
                        np.asarray(ys, np.int64), classes=classes,
                        name=_split_name(name, train))


def _read_idx(path: Path) -> np.ndarray:
    """An MNIST idx{1,3}-ubyte file (optionally gzipped): magic byte 4 is
    ndim, then ndim big-endian uint32 dims, then the uint8 payload."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = data[3]
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _parse_mnist_idx(name: str, root: Path, train: bool) -> Optional[ArrayDataset]:
    """MNIST / FashionMNIST idx files under ``root``, searched only in this
    dataset's own directories (the two share file names)."""
    prefix = "train" if train else "t10k"
    tv_dir = "MNIST" if name == "mnist" else "FashionMNIST"
    for d in (root / tv_dir / "raw", root / name, root / tv_dir, root / "raw", root):
        for ext in ("", ".gz"):
            img_p = d / f"{prefix}-images-idx3-ubyte{ext}"
            lbl_p = d / f"{prefix}-labels-idx1-ubyte{ext}"
            if img_p.exists() and lbl_p.exists():
                classes = ([str(i) for i in range(10)] if name == "mnist" else
                           ["T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
                            "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot"])
                return ArrayDataset(np.ascontiguousarray(_read_idx(img_p)[..., None]),
                                    _read_idx(lbl_p).astype(np.int64), classes=classes,
                                    name=_split_name(name, train))
    return None


def _load_builtin(name: str, root: Path, train: bool) -> ArrayDataset:
    """A CIFAR/MNIST-family dataset: the npz cache, else the parsed on-disk
    files (then cached), else the cached or generated synthetic stand-in."""
    root = Path(root)
    split = _split_name(name, train)
    cache = root / f"{split}.npz"
    if cache.exists():
        z = np.load(cache, allow_pickle=True)
        # classes=None is cached as an empty array
        classes = list(z["classes"]) if "classes" in z else []
        return ArrayDataset(z["images"], z["targets"], classes=classes or None, name=split)
    parse = _parse_cifar_pickle if name.startswith("cifar") else _parse_mnist_idx
    try:
        ds = parse(name, root, train)
    except Exception as e:  # corrupt or truncated files: fall through
        _logger.warning("on-disk %s parse failed (%s)", name, e)
        ds = None
    if ds is not None:
        root.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache, images=ds.images, targets=ds.targets,
                            classes=np.asarray(ds.classes or []))
        return ds
    _logger.warning("no real %s under %s; using the synthetic stand-in", name, root)
    syn_cache = root / f"{split}_synthetic.npz"
    if syn_cache.exists():
        z = np.load(syn_cache, allow_pickle=True)
        return ArrayDataset(z["images"], z["targets"], classes=list(z["classes"]),
                            name=f"{split}_synthetic", provenance="synthetic")
    ds = _synthetic_like(name, train)
    root.mkdir(parents=True, exist_ok=True)
    np.savez(syn_cache, images=ds.images, targets=ds.targets, classes=np.asarray(ds.classes))
    return ds


#: catalog ``type`` -> loader
DATASET_LOADERS: Dict[str, Callable[..., ArrayDataset]] = {"synthetic": _synthetic}
for _n in _KNOWN_SHAPES:
    DATASET_LOADERS[_n] = (lambda root=None, train=True, _n=_n, **kw:
                           _load_builtin(_n, Path(root or DEFAULT_DATA_ROOT), train))


def load_dataset(name_or_spec: Union[str, Mapping[str, Any]], root=None,
                 train: bool = True, **kwargs) -> ArrayDataset:
    """Load a dataset by registered name or catalog-entry spec
    (``{"type": <name>, ...kwargs}`` or ``{"type": ..., "dataset_kwargs":
    {...}}``)."""
    if isinstance(name_or_spec, Mapping):
        spec = dict(name_or_spec)
        t = spec.pop("type", spec.pop("dataset", None))
        root = spec.pop("root", root)
        train = bool(spec.pop("train", train))
        kwargs = {**spec.pop("dataset_kwargs", {}), **spec, **kwargs}
        name_or_spec = str(getattr(t, "identifier", t)).rsplit(".", 1)[-1]
    name = str(name_or_spec).lower()
    if name not in DATASET_LOADERS:
        raise NotImplementedError(
            f"dataset type '{name}' is not ported yet (ported: {sorted(DATASET_LOADERS)})")
    return DATASET_LOADERS[name](root=root, train=train, **kwargs)


def split_dataset(trainset: ArrayDataset, testset: Optional[ArrayDataset] = None,
                  validset_ratio: float = 0.2, testset_ratio: float = 0.0,
                  seed: int = 434546) -> Dict[str, ArrayDataset]:
    """Deterministic train/valid[/test] split by ratios from one
    ``numpy.random.default_rng(seed).permutation``; ``testset_ratio`` is
    ignored when a testset exists. Memory-mapped datasets are not ported."""
    if isinstance(trainset.images, np.memmap):
        raise NotImplementedError("splitting memory-mapped datasets is not ported yet")
    n = len(trainset)
    perm = np.random.default_rng(seed).permutation(n)
    n_valid = int(round(validset_ratio * n))
    n_test = 0 if testset is not None else int(round(testset_ratio * n))
    out: Dict[str, ArrayDataset] = {}
    if n_test:
        out["testset"] = trainset.subset(perm[:n_test], name="testset")
    if testset is not None:
        out["testset"] = testset
    out["validset"] = trainset.subset(perm[n_test:n_test + n_valid], name="validset")
    out["trainset"] = trainset.subset(perm[n_test + n_valid:], name="trainset")
    return out

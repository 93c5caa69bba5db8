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
package's torchvision step is left out, and a torchvision catalog type
raises.

The other loaders: ``memmap`` opens ``images.npy`` and ``targets.npy`` as
memory maps (only the pages a batch touches are read; the training loop
streams such a dataset), ``tar_shards`` reads the webdataset-style shards
:func:`write_tar_shards` writes, and ``image_folder`` decodes
``root/<class>/*.jpg`` with PIL, which is imported only when called.
:func:`tar_shards_to_memmap` and :func:`materialize_image_folder_to_memmap`
convert once to the memmap format, one image in memory at a time.
"""
from __future__ import annotations

import gzip
import logging
import pickle
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["ArrayDataset", "load_dataset", "split_dataset", "get_random_subset",
           "DATASET_LOADERS", "DEFAULT_DATA_ROOT", "write_tar_shards", "tar_shards_to_memmap",
           "materialize_image_folder_to_memmap"]

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


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the image_folder loaders decode with PIL (the 'pillow' "
                          "package), which is not installed") from e
    return Image


def _decode(image_cls, path: Path, image_size: int) -> np.ndarray:
    img = image_cls.open(path).convert("RGB").resize((image_size, image_size),
                                                     image_cls.BILINEAR)
    return np.asarray(img, np.uint8)


def _image_files(root: Path, extensions):
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    files = [(f, ci) for ci, cname in enumerate(classes)
             for f in sorted((root / cname).iterdir()) if f.suffix.lower() in extensions]
    return classes, files


def _image_folder(root=None, train=True, image_size: int = 224,
                  extensions=(".png", ".jpg", ".jpeg", ".bmp"), **kw) -> ArrayDataset:
    """``root/<class_name>/*.jpg``: decoded with PIL, resized (bilinear) to
    ``image_size`` squares, NHWC uint8; classes in sorted order."""
    image_cls = _pil_image()
    root = Path(root or DEFAULT_DATA_ROOT)
    if not root.exists():
        raise FileNotFoundError(f"image_folder root not found: {root}")
    classes, files = _image_files(root, extensions)
    if not classes:
        raise ValueError(f"image_folder root has no class subdirectories: {root}")
    if not files:
        raise ValueError(f"no images found under {root}")
    return ArrayDataset(np.stack([_decode(image_cls, f, image_size) for f, _ in files]),
                        np.asarray([ci for _, ci in files], np.int64), classes=classes,
                        name=f"image_folder_{root.name}")


def _memmap_dataset(root=None, train=True, images_path=None, targets_path=None,
                    classes=None, **kw) -> ArrayDataset:
    """``images.npy`` and ``targets.npy`` (under ``root``, or at the given
    paths) opened as ``np.memmap`` views."""
    root = Path(root) if root else None
    images_path = Path(images_path) if images_path else (root / "images.npy")
    targets_path = Path(targets_path) if targets_path else (root / "targets.npy")
    return ArrayDataset(np.load(images_path, mmap_mode="r"),
                        np.load(targets_path, mmap_mode="r"), classes=classes,
                        name=f"memmap_{images_path.stem}")


def materialize_image_folder_to_memmap(root, out_dir, image_size: int = 224,
                                       extensions=(".png", ".jpg", ".jpeg", ".bmp"),
                                       shuffle_seed: int = 0) -> ArrayDataset:
    """Convert an ``image_folder`` tree once into memmap ``.npy`` files, one
    decoded image in memory at a time, rows in the order of
    ``default_rng(shuffle_seed).permutation`` (a memmap splits by contiguous
    ranges, so a class-sorted file would put whole classes into the
    validset). Returns the opened memmap dataset."""
    from numpy.lib.format import open_memmap

    image_cls = _pil_image()
    root, out_dir = Path(root), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    classes, files = _image_files(root, extensions)
    if not files:
        raise ValueError(f"no images found under {root}")
    files = [files[i] for i in np.random.default_rng(shuffle_seed).permutation(len(files))]
    images = open_memmap(out_dir / "images.npy", mode="w+", dtype=np.uint8,
                         shape=(len(files), image_size, image_size, 3))
    targets = open_memmap(out_dir / "targets.npy", mode="w+", dtype=np.int64,
                          shape=(len(files),))
    for i, (f, ci) in enumerate(files):
        images[i] = _decode(image_cls, f, image_size)
        targets[i] = ci
    images.flush()
    targets.flush()
    (out_dir / "classes.txt").write_text("\n".join(classes))
    return _memmap_dataset(root=out_dir, classes=classes)


def write_tar_shards(dataset, out_dir, shard_size: int = 1024) -> list:
    """Write ``dataset`` (raw uint8 images) as ``shard-%05d.tar`` files
    whose members pair ``{idx:08d}.img.npy`` with ``{idx:08d}.cls`` (the
    label in ASCII), and ``classes.txt``; earlier shards in ``out_dir`` are
    removed first. Returns the shard paths."""
    import io
    import tarfile

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for stale in list(out_dir.glob("shard-*.tar")) + [out_dir / "classes.txt"]:
        stale.unlink(missing_ok=True)
    if np.asarray(dataset[0][0]).dtype != np.uint8:
        raise ValueError("write_tar_shards stores uint8 raw pixels; got dtype "
                         f"{np.asarray(dataset[0][0]).dtype}: export the raw dataset "
                         "(before to_tensor/normalize)")
    paths = []
    n = len(dataset)
    for s0 in range(0, n, int(shard_size)):
        p = out_dir / f"shard-{len(paths):05d}.tar"
        with tarfile.open(p, "w") as tf:
            for i in range(s0, min(n, s0 + int(shard_size))):
                img, tgt = dataset[i]
                buf = io.BytesIO()
                np.save(buf, np.asarray(img, np.uint8))
                info = tarfile.TarInfo(f"{i:08d}.img.npy")
                info.size = buf.getbuffer().nbytes
                buf.seek(0)
                tf.addfile(info, buf)
                cls = str(int(np.asarray(tgt).reshape(-1)[0])).encode()
                info = tarfile.TarInfo(f"{i:08d}.cls")
                info.size = len(cls)
                tf.addfile(info, io.BytesIO(cls))
        paths.append(p)
    if getattr(dataset, "classes", None):
        (out_dir / "classes.txt").write_text("\n".join(dataset.classes))
    return paths


def _sorted_shards(shard_dir) -> list:
    """The shard files in numeric order."""
    shards = sorted(Path(shard_dir).glob("shard-*.tar"),
                    key=lambda p: int(p.stem.split("-", 1)[1]))
    if not shards:
        raise ValueError(f"no shard-*.tar files under {shard_dir}")
    return shards


def _count_shard_pairs(shards) -> int:
    """Image/label pairs in the shards, from their indexes alone; an
    unpaired member raises."""
    import tarfile

    total = 0
    for sp in shards:
        stems_img, stems_cls = set(), set()
        with tarfile.open(sp, "r") as tf:
            for m in tf:
                stem, _, kind = m.name.partition(".")
                (stems_img if kind == "img.npy" else stems_cls).add(stem)
        orphans = stems_img ^ stems_cls
        if orphans:
            raise ValueError(f"{sp}: {len(orphans)} unpaired member(s) (e.g. "
                             f"{sorted(orphans)[:3]}): truncated or hand-built shard")
        total += len(stems_img)
    return total


def _iter_tar_shards(shard_dir):
    """(image, label) pairs, shard by shard, one pair in memory at a time."""
    import io
    import tarfile

    for sp in _sorted_shards(shard_dir):
        with tarfile.open(sp, "r") as tf:
            pending: Dict[str, Dict[str, bytes]] = {}
            for m in tf:
                stem, _, kind = m.name.partition(".")
                entry = pending.setdefault(stem, {})
                entry[kind] = tf.extractfile(m).read()
                if "img.npy" in entry and "cls" in entry:
                    yield np.load(io.BytesIO(entry["img.npy"])), int(entry["cls"].decode())
                    del pending[stem]


def _fill_from_shards(shard_dir, alloc):
    """Stream the shards' pairs into the arrays ``alloc(n, image_shape)``
    returns; rows must share one image shape."""
    n = _count_shard_pairs(_sorted_shards(shard_dir))
    it = _iter_tar_shards(shard_dir)
    first_img, first_cls = next(it)
    images, targets = alloc(n, first_img.shape)
    images[0], targets[0] = first_img, first_cls
    for i, (img, cls) in enumerate(it, start=1):
        if img.shape != first_img.shape:
            raise ValueError(f"shard row {i}: image shape {img.shape} != "
                             f"{first_img.shape} (row 0)")
        images[i], targets[i] = img, cls
    return images, targets


def _shard_classes(shard_dir: Path) -> Optional[list]:
    p = shard_dir / "classes.txt"
    return p.read_text().splitlines() if p.exists() else None


def _tar_shards_dataset(root=None, train=True, **kw) -> ArrayDataset:
    """Tar shards (:func:`write_tar_shards`) read into one in-memory array."""
    if root is None:
        raise ValueError("the 'tar_shards' loader needs root=<shard dir> "
                         "(the directory write_tar_shards produced)")
    root = Path(root)
    images, targets = _fill_from_shards(
        root, lambda n, shape: (np.empty((n, *shape), np.uint8), np.empty((n,), np.int64)))
    return ArrayDataset(images, targets, classes=_shard_classes(root),
                        name=f"tar_shards_{root.name}")


def tar_shards_to_memmap(shard_dir, out_dir) -> ArrayDataset:
    """Convert tar shards once into ``images.npy`` and ``targets.npy`` (the
    ``memmap`` format); a failure removes the partial files."""
    from numpy.lib.format import open_memmap

    shard_dir, out_dir = Path(shard_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    img_path, tgt_path = out_dir / "images.npy", out_dir / "targets.npy"
    try:
        images, targets = _fill_from_shards(shard_dir, lambda n, shape: (
            open_memmap(img_path, mode="w+", dtype=np.uint8, shape=(n, *shape)),
            open_memmap(tgt_path, mode="w+", dtype=np.int64, shape=(n,))))
        images.flush()
        targets.flush()
    except Exception:
        img_path.unlink(missing_ok=True)
        tgt_path.unlink(missing_ok=True)
        raise
    classes = _shard_classes(shard_dir)
    if classes is not None:
        (out_dir / "classes.txt").write_text("\n".join(classes))
    return _memmap_dataset(root=out_dir, classes=classes)


#: catalog ``type`` -> loader
DATASET_LOADERS: Dict[str, Callable[..., ArrayDataset]] = {
    "synthetic": _synthetic, "image_folder": _image_folder, "memmap": _memmap_dataset,
    "tar_shards": _tar_shards_dataset}
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
    ignored when a testset exists. A memory-mapped dataset splits by
    contiguous ranges instead, so that each split stays a memmap view."""
    n = len(trainset)
    mmap = isinstance(trainset.images, np.memmap)
    n_valid = int(round(validset_ratio * n))
    n_test = 0 if testset is not None else int(round(testset_ratio * n))
    perm = None if mmap else np.random.default_rng(seed).permutation(n)

    def take(lo, hi):
        return slice(lo, hi) if mmap else perm[lo:hi]

    out: Dict[str, ArrayDataset] = {}
    if n_test:
        out["testset"] = trainset.subset(take(0, n_test), name="testset")
    if testset is not None:
        out["testset"] = testset
    out["validset"] = trainset.subset(take(n_test, n_test + n_valid), name="validset")
    out["trainset"] = trainset.subset(take(n_test + n_valid, n), name="trainset")
    return out


def get_random_subset(dataset: ArrayDataset, size: Union[int, float],
                      seed: int = 0) -> ArrayDataset:
    """``size`` rows (a share of the dataset when a float <= 1) drawn by
    ``numpy.random.default_rng(seed).permutation``."""
    n = len(dataset)
    k = int(round(size * n)) if isinstance(size, float) and size <= 1.0 else int(size)
    return dataset.subset(np.random.default_rng(seed).permutation(n)[:k],
                          name=f"{dataset.name}_sub{k}")

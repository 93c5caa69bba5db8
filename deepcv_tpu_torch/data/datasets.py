"""Array datasets, the synthetic loader and deterministic splits.

Counterpart of ``deepcv_tpu/data/datasets.py`` (``ArrayDataset``,
``load_dataset`` for catalog entries of ``type: synthetic``,
``split_dataset``), copied so that the port imports nothing of the JAX
package. Everything is numpy and seeded the same way, so a catalog entry
gives the same images and a split the same indices as in the JAX package.
Other catalog types (CIFAR, MNIST, image folders, tar shards, torchvision
datasets) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["ArrayDataset", "load_dataset", "split_dataset", "DATASET_LOADERS"]


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


#: catalog ``type`` -> loader
DATASET_LOADERS: Dict[str, Callable[..., ArrayDataset]] = {"synthetic": _synthetic}


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

"""The preprocess node: split, parse the transform list, wrap.

Counterpart of ``deepcv_tpu/data/preprocess.py`` (``preprocess``,
``parse_transforms_specification``, ``PreprocessedDataset``): transforms
compile to one batched function applied on the device to each batch of raw
uint8 NHWC images. Ported transforms: ``to_tensor`` and ``normalize``
(with given statistics, or the trainset's per-channel mean and std).
Augmentation recipes and target transforms are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from deepcv_tpu_torch.data import transforms as T
from deepcv_tpu_torch.data.datasets import ArrayDataset, split_dataset
from deepcv_tpu_torch.hyperparams import to_hyperparameters
from deepcv_tpu_torch.utils import set_seeds

__all__ = ["preprocess", "PreprocessedDataset", "Compose",
           "parse_transforms_specification", "dataset_stats", "PREPROCESS_DEFAULTS",
           "TRANSFORMS"]

PREPROCESS_DEFAULTS = {
    "seed": 434546,
    "cache": False,
    "split_dataset": ...,
    "transforms": ...,
    "target_transforms": None,
    "augmentation_recipe": None,
    "augmentation_reciepe": None,
}

#: transform name -> function of an NHWC batch
TRANSFORMS: Dict[str, Callable] = {"to_tensor": T.to_tensor, "normalize": T.normalize}


def dataset_stats(trainset: ArrayDataset) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and std of the trainset's images in [0, 1] (uint8
    scaled by 1/255), accumulated in float64 over chunks."""
    imgs = trainset.images
    c = imgs.shape[-1]
    s, sq, count = np.zeros(c), np.zeros(c), 0
    for lo in range(0, len(imgs), 1024):
        chunk = np.asarray(imgs[lo:lo + 1024], np.float64).reshape(-1, c)
        if imgs.dtype == np.uint8:
            chunk /= 255.0
        s += chunk.sum(0)
        sq += (chunk * chunk).sum(0)
        count += chunk.shape[0]
    mean = s / count
    return mean.astype(np.float32), np.sqrt(np.maximum(sq / count - mean ** 2, 0)).astype(np.float32)


class Compose:
    """Apply ``(fn, kwargs)`` steps in order to a batch."""

    def __init__(self, steps: Sequence[Tuple[Callable, Mapping[str, Any]]]):
        self.steps = [(fn, dict(kw)) for fn, kw in steps]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for fn, kw in self.steps:
            x = fn(x, **kw)
        return x

    def __repr__(self):
        return f"Compose({[getattr(fn, '__name__', fn) for fn, _ in self.steps]})"


def _resolve(entry: Any, trainset: Optional[ArrayDataset]):
    kwargs: Dict[str, Any] = {}
    if isinstance(entry, Mapping) and len(entry) == 1:
        (entry, kwargs), = entry.items()
        kwargs = dict(kwargs or {})
    if hasattr(entry, "resolve"):  # a !py! tag
        kwargs = {**getattr(entry, "kwargs", {}), **kwargs}
        entry = entry.resolve()
    if isinstance(entry, str):
        if entry not in TRANSFORMS:
            raise NotImplementedError(f"transform '{entry}' is not ported yet "
                                      f"(ported: {sorted(TRANSFORMS)})")
        entry = TRANSFORMS[entry]
    if entry not in TRANSFORMS.values():
        raise NotImplementedError(f"transform {entry!r} is not ported yet "
                                  f"(ported: {sorted(TRANSFORMS)})")
    if entry is T.normalize and ("mean" not in kwargs or "std" not in kwargs):
        if trainset is None:
            raise ValueError("normalize without mean/std needs a trainset to compute them")
        mean, std = dataset_stats(trainset)
        kwargs.setdefault("mean", mean.tolist())
        kwargs.setdefault("std", std.tolist())
    return entry, kwargs


def parse_transforms_specification(specs: Sequence[Any],
                                   trainset: Optional[ArrayDataset] = None) -> Compose:
    """YAML transform list -> one batched :class:`Compose`."""
    return Compose([_resolve(e, trainset) for e in (specs or [])])


class PreprocessedDataset:
    """A dataset and the transform applied to its batches on the device."""

    def __init__(self, dataset: ArrayDataset, transform: Optional[Compose] = None):
        self.dataset = dataset
        self.transform = transform

    def __len__(self):
        return len(self.dataset)

    @property
    def classes(self):
        return self.dataset.classes

    @property
    def num_classes(self):
        return self.dataset.num_classes

    @property
    def image_shape(self):
        """Post-transform image shape (the transforms keep NHWC shapes)."""
        return self.dataset.image_shape

    def batch_transform(self, images: torch.Tensor) -> torch.Tensor:
        """Raw (uint8) batch -> transformed float batch, on its device."""
        return self.transform(images) if self.transform is not None else images

    def __repr__(self):
        return f"PreprocessedDataset({self.dataset!r}, transform={self.transform})"


def preprocess(datasets: Mapping[str, ArrayDataset], params: Mapping[str, Any]
               ) -> Dict[str, PreprocessedDataset]:
    """The preprocess pipeline node: seed -> split -> parse the transform
    list -> wrap. ``datasets`` holds 'trainset' and optionally 'testset'."""
    hp, _ = to_hyperparameters(dict(params), PREPROCESS_DEFAULTS)
    for key in ("target_transforms", "augmentation_recipe", "augmentation_reciepe"):
        if hp.get(key):
            raise NotImplementedError(f"preprocessing '{key}' is not ported yet")
    set_seeds(int(hp["seed"]))
    split_cfg = dict(hp["split_dataset"])
    splits = split_dataset(datasets["trainset"], datasets.get("testset"),
                           validset_ratio=float(split_cfg.get("validset_ratio", 0.2)),
                           testset_ratio=float(split_cfg.get("testset_ratio", 0.0)),
                           seed=int(hp["seed"]))
    transform = parse_transforms_specification(hp["transforms"], trainset=splits["trainset"])
    return {name: PreprocessedDataset(ds, transform) for name, ds in splits.items()}

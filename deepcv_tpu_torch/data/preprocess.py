"""The preprocess node: split, parse the transform list, wrap.

Counterpart of ``deepcv_tpu/data/preprocess.py`` (``preprocess``,
``parse_transforms_specification``, ``PreprocessedDataset``): transforms
compile to one batched function applied on the device to each batch of raw
uint8 NHWC images. The transform list names any entry of
:data:`~deepcv_tpu_torch.data.transforms.TRANSFORM_REGISTRY` (``normalize``
with given statistics, or the trainset's per-channel mean and std); its
random entries draw from the batch's generator, as the JAX package's take
the batch's key. ``augmentation_recipe`` (or the reference's spelling
``augmentation_reciepe``) compiles through
:func:`~deepcv_tpu_torch.data.augmentation.apply_augmentation_recipe` and
augments the trainset's batches. ``target_transforms`` parse the same way
into ``PreprocessedDataset.target_transform``, which
:meth:`PreprocessedDataset.transform_targets` applies to a batch of
targets.

A recipe runs one of two routes, counted in
``PreprocessedDataset.batch_transform.routes``:

* ``K1``: a uint8 batch with three channels whose recipe
  :meth:`~deepcv_tpu_torch.data.augmentation.AugmentationRecipe.fits_k1`
  (no section, steps a subsequence of K1's order) goes through one
  :func:`~deepcv_tpu_torch.ops.kernels.fused_augment.fused_augment_normalize`
  call (the kernel on a card, its plain version on the CPU), which also
  normalizes when the transform list is ``to_tensor`` and at most one
  ``normalize``;
* ``eager``: any other batch (the conf's ``basic_augmentation`` and
  ``augmix_augmentation`` among them: posterize and the geometric steps
  are not in K1's body) runs ``to_tensor``, the recipe, then the transform
  list.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from deepcv_tpu_torch.data import transforms as T
from deepcv_tpu_torch.data.augmentation import (
    AugmentationRecipe, apply_augmentation_recipe, draw_factors)
from deepcv_tpu_torch.data.datasets import ArrayDataset, split_dataset
from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize
from deepcv_tpu_torch.hyperparams import to_hyperparameters
from deepcv_tpu_torch.utils import set_seeds

__all__ = ["preprocess", "PreprocessedDataset", "Compose",
           "parse_transforms_specification", "dataset_stats", "PREPROCESS_DEFAULTS"]

PREPROCESS_DEFAULTS = {
    "seed": 434546,
    "cache": False,
    "split_dataset": ...,
    "transforms": ...,
    "target_transforms": None,
    "augmentation_recipe": None,
    "augmentation_reciepe": None,
}

Compose = T.Compose


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


def _resolve(entry: Any, trainset: Optional[ArrayDataset]):
    kwargs: Dict[str, Any] = {}
    if isinstance(entry, Mapping) and len(entry) == 1:
        (entry, kwargs), = entry.items()
        kwargs = dict(kwargs or {})
    if hasattr(entry, "resolve"):  # a !py! tag
        kwargs = {**getattr(entry, "kwargs", {}), **kwargs}
        entry = entry.resolve()
    if isinstance(entry, str):
        if entry not in T.TRANSFORM_REGISTRY:
            raise ValueError(f"Unknown transform '{entry}'; known: "
                             f"{sorted(T.TRANSFORM_REGISTRY)}")
        entry = T.TRANSFORM_REGISTRY[entry]
    if not callable(entry):
        raise ValueError(f"Cannot parse transform spec entry: {entry!r}")
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
    """A dataset, the transform applied to its batches on the device and,
    for a trainset, the augmentation recipe run before it."""

    def __init__(self, dataset: ArrayDataset, transform: Optional[Compose] = None,
                 augmentation: Optional[AugmentationRecipe] = None,
                 target_transform: Optional[Compose] = None):
        self.dataset = dataset
        self.transform = transform
        self.augmentation = augmentation
        self.target_transform = target_transform

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
        """Post-transform image shape: the dataset's, or, when the transform
        list resizes, crops or pads, that of one image through it on the
        CPU."""
        steps = self.transform.steps if self.transform is not None else []
        if not any(fn in T.RESHAPING for fn, _, _ in steps):
            return self.dataset.image_shape
        raw = torch.zeros((1, *self.dataset.image_shape),
                          dtype=torch.from_numpy(self.dataset.images[:1]).dtype)
        return tuple(self.transform(raw, torch.Generator().manual_seed(0)).shape[1:])

    def _k1_normalize(self) -> Optional[Tuple[Sequence[float], Sequence[float]]]:
        """K1's normalize constants when the transform list is ``to_tensor``
        and at most one ``normalize`` (mean 0, std 1 for no normalize); None
        when other transforms must run after K1."""
        steps = [(fn, kw) for fn, kw, _ in self.transform.steps] \
            if self.transform is not None else []
        if not steps or steps[0][0] is not T.to_tensor:
            return None
        if len(steps) == 1:
            return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
        if len(steps) == 2 and steps[1][0] is T.normalize:
            return steps[1][1]["mean"], steps[1][1]["std"]
        return None

    def batch_transform(self, images: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        augment: bool = True) -> torch.Tensor:
        """Raw (uint8) batch -> transformed float batch, on its device:
        ``to_tensor``, the augmentation recipe (when ``augment`` and the
        dataset has one), then the transform list. ``generator`` (on the
        batch's device) feeds the recipe's draws and then the transform
        list's random entries; augmenting without one raises."""
        x = images
        if self.augmentation is not None and augment:
            if generator is None:
                raise ValueError("augmentation requires a torch.Generator")
            if (images.dtype == torch.uint8 and images.dim() == 4
                    and images.shape[-1] == 3 and self.augmentation.fits_k1()):
                _ROUTES["K1"] += 1
                norm = self._k1_normalize()
                mean, std = norm or ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
                f = draw_factors(self.augmentation, images.shape[0], generator)
                x = fused_augment_normalize(
                    images, f["brightness"], f["contrast"], f["saturation"],
                    f["gamma"], f["noise_sigma"], mean, std, seed=f["seed"])
                if norm is not None:
                    return x
            else:
                _ROUTES["eager"] += 1
                x = self.augmentation(T.to_tensor(images), generator)
        return self.transform(x, generator) if self.transform is not None else x

    def transform_targets(self, targets: torch.Tensor) -> torch.Tensor:
        """A batch of targets through ``target_transform`` (unchanged without
        one)."""
        return self.target_transform(targets) if self.target_transform else targets

    def __repr__(self):
        return (f"PreprocessedDataset({self.dataset!r}, transform={self.transform}, "
                f"augmentation={self.augmentation})")


#: batches augmented by each route in this process
_ROUTES = PreprocessedDataset.batch_transform.routes = {"K1": 0, "eager": 0}


def preprocess(datasets: Mapping[str, ArrayDataset], params: Mapping[str, Any]
               ) -> Dict[str, PreprocessedDataset]:
    """The preprocess pipeline node: seed -> split -> parse the transform
    list -> wrap. ``datasets`` holds 'trainset' and optionally 'testset'."""
    hp, _ = to_hyperparameters(dict(params), PREPROCESS_DEFAULTS)
    set_seeds(int(hp["seed"]))
    split_cfg = dict(hp["split_dataset"])
    splits = split_dataset(datasets["trainset"], datasets.get("testset"),
                           validset_ratio=float(split_cfg.get("validset_ratio", 0.2)),
                           testset_ratio=float(split_cfg.get("testset_ratio", 0.0)),
                           seed=int(hp["seed"]))
    transform = parse_transforms_specification(hp["transforms"], trainset=splits["trainset"])
    target_tf = parse_transforms_specification(hp["target_transforms"]) \
        if hp.get("target_transforms") else None
    recipe = hp.get("augmentation_recipe") or hp.get("augmentation_reciepe")
    augmentation = apply_augmentation_recipe(recipe) if recipe else None
    return {name: PreprocessedDataset(
        ds, transform, augmentation if name == "trainset" else None, target_tf)
        for name, ds in splits.items()}

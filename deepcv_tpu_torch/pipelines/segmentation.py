"""Semantic segmentation: ``train_semantic_segmentation``.

Counterpart of ``deepcv_tpu/pipelines/segmentation.py`` (``SEG_CLASSES``,
``generate_segmentation_dataset`` and its ``synthetic_shapes_seg`` loader,
``segmentation_loss``, ``pixel_accuracy``, ``mean_iou``,
``create_segmenter``, ``train_segmenter``, ``get_pipelines``): a backbone
from its spec (the conf's ``hrnet_backbone``, or ``unet_spec()``), a 1x1
class conv and a bilinear resize back to the input's resolution, trained
with per-pixel softmax cross-entropy. The generator draws from numpy's
``default_rng`` in the JAX package's order, so a seed gives the same bytes.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from deepcv_tpu_torch.data.datasets import DATASET_LOADERS, ArrayDataset
from deepcv_tpu_torch.pipelines.framework import (
    Node, Pipeline, append_dense_head, preprocess_node)
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.training import train as train_fn

__all__ = ["SEG_CLASSES", "generate_segmentation_dataset", "segmentation_loss",
           "pixel_accuracy", "mean_iou", "create_segmenter", "train_segmenter",
           "get_pipelines"]

#: class 0 is background; 1..3 are the rectangle colors
SEG_CLASSES = ("background", "red", "green", "blue")


def generate_segmentation_dataset(n: int = 512, image_size: int = 32,
                                  max_objects: int = 3, seed: int = 0,
                                  train: bool = True) -> ArrayDataset:
    """Images with 1..max_objects colored rectangles over dark noise;
    targets are per-pixel int32 masks (0 background, 1 + color). Later
    rectangles overwrite earlier ones, in the pixels and in the mask."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    c = len(SEG_CLASSES) - 1
    imgs = np.zeros((n, image_size, image_size, 3), np.uint8)
    masks = np.zeros((n, image_size, image_size), np.int32)
    for i in range(n):
        imgs[i] = rng.integers(0, 40, (image_size, image_size, 3))
        for _ in range(int(rng.integers(1, max_objects + 1))):
            w = rng.uniform(0.15, 0.45)
            h = rng.uniform(0.15, 0.45)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            cls = int(rng.integers(c))
            x0, x1 = int((cx - w / 2) * image_size), int((cx + w / 2) * image_size)
            y0, y1 = int((cy - h / 2) * image_size), int((cy + h / 2) * image_size)
            color = np.zeros(3, np.uint8)
            color[cls] = rng.integers(180, 256)
            imgs[i, y0:y1, x0:x1] = color
            masks[i, y0:y1, x0:x1] = 1 + cls
    return ArrayDataset(imgs, masks, classes=list(SEG_CLASSES),
                        name=f"seg_shapes_{'train' if train else 'test'}",
                        provenance="synthetic")


DATASET_LOADERS["synthetic_shapes_seg"] = (
    lambda root=None, train=True, n=512, image_size=32, seed=0, **kw:
    generate_segmentation_dataset(n=int(n), image_size=int(image_size), seed=int(seed),
                                  train=train))


def segmentation_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel softmax cross-entropy in float32: ``pred`` (N, H, W, C)
    logits, ``target`` (N, H, W) integer mask."""
    logp = F.log_softmax(pred.float(), dim=-1)
    return -logp.gather(-1, target.long().unsqueeze(-1)).mean()


def pixel_accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.argmax(-1) == target).float().mean()


def mean_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean IoU over the classes present in the prediction or the target."""
    num_classes = pred.shape[-1]
    p1 = F.one_hot(pred.argmax(-1).reshape(-1), num_classes).float()
    t1 = F.one_hot(target.reshape(-1).long(), num_classes).float()
    inter = (p1 * t1).sum(0)
    union = p1.sum(0) + t1.sum(0) - inter
    present = union > 0
    iou = torch.where(present, inter / union.clamp(min=1.0), torch.zeros_like(inter))
    return iou.sum() / present.float().sum().clamp(min=1.0)


def create_segmenter(datasets, model_params: Mapping[str, Any], device=None) -> DeepcvModule:
    """The backbone's spec with the dense head appended: a 1x1 conv to the
    dataset's classes and a resize back to its image size."""
    trainset = datasets["trainset"]
    hp = copy.deepcopy(dict(model_params))
    append_dense_head(hp, "seg_head", len(trainset.classes or SEG_CLASSES),
                      trainset.image_shape[:2])
    return DeepcvModule(trainset.image_shape, hp, device=device)


def train_segmenter(datasets, model: DeepcvModule, hp: Mapping[str, Any], trackers=()):
    state, history = train_fn(hp, model, segmentation_loss, datasets,
                              metrics={"pixel_accuracy": pixel_accuracy, "mean_iou": mean_iou},
                              loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


def get_pipelines() -> Dict[str, Pipeline]:
    return {"train_semantic_segmentation": Pipeline([
        Node(preprocess_node, ["seg_train", "seg_test", "params:seg_preprocessing"],
             "datasets", name="preprocess"),
        Node(create_segmenter, ["datasets", "params:semantic_segmentation_model", "device"],
             "model", name="create_segmenter"),
        Node(train_segmenter, ["datasets", "model", "params:train_semantic_segmentation",
                               "trackers"], "train_results", name="train"),
    ], name="train_semantic_segmentation", tags={"train", "segmentation"})}

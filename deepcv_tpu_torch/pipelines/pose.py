"""Pose estimation by keypoint heatmaps: ``train_pose_estimator``.

Counterpart of ``deepcv_tpu/pipelines/pose.py`` (``POSE_KEYPOINTS``,
``generate_pose_dataset`` and its ``synthetic_pose`` loader,
``heatmap_mse_loss``, ``decode_heatmaps``, ``pck``,
``create_pose_estimator``, ``train_pose_estimator``, ``get_pipelines``):
a backbone from its spec, a 1x1 conv to one heatmap per keypoint and a
bilinear resize to the dataset's heatmap size, trained by MSE against
Gaussian heatmaps (float targets, which ``train()`` keeps float32). The
generator draws from numpy's ``default_rng`` in the JAX package's order.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping

import numpy as np
import torch

from deepcv_tpu_torch.data.datasets import DATASET_LOADERS, ArrayDataset
from deepcv_tpu_torch.pipelines.framework import (
    Node, Pipeline, append_dense_head, preprocess_node)
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.training import train as train_fn

__all__ = ["POSE_KEYPOINTS", "generate_pose_dataset", "heatmap_mse_loss",
           "decode_heatmaps", "pck", "create_pose_estimator", "train_pose_estimator",
           "get_pipelines"]

#: the synthetic task's keypoints (a rectangle's corners)
POSE_KEYPOINTS = ("top_left", "top_right", "bottom_left", "bottom_right")


def generate_pose_dataset(n: int = 512, image_size: int = 32, heatmap_size: int = 16,
                          sigma: float = 1.0, seed: int = 0,
                          train: bool = True) -> ArrayDataset:
    """One bright rectangle per image over dark noise; the keypoints are its
    corners. Targets are (heatmap, heatmap, K) float32 Gaussians peaked on
    the heatmap cell nearest each corner."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    k, s = len(POSE_KEYPOINTS), heatmap_size
    imgs = np.zeros((n, image_size, image_size, 3), np.uint8)
    tgts = np.zeros((n, s, s, k), np.float32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    for i in range(n):
        imgs[i] = rng.integers(0, 40, (image_size, image_size, 3))
        w = rng.uniform(0.3, 0.7)
        h = rng.uniform(0.3, 0.7)
        cx = rng.uniform(w / 2, 1 - w / 2)
        cy = rng.uniform(h / 2, 1 - h / 2)
        x0, x1 = (cx - w / 2) * image_size, (cx + w / 2) * image_size
        y0, y1 = (cy - h / 2) * image_size, (cy + h / 2) * image_size
        imgs[i, int(y0):int(y1), int(x0):int(x1)] = rng.integers(150, 256, 3)
        corners = [(x0, y0), (x1 - 1, y0), (x0, y1 - 1), (x1 - 1, y1 - 1)]
        for j, (px, py) in enumerate(corners):
            hx = min(s - 1, round(px / image_size * s))
            hy = min(s - 1, round(py / image_size * s))
            tgts[i, :, :, j] = np.exp(-((xx - hx) ** 2 + (yy - hy) ** 2) / (2.0 * sigma ** 2))
    return ArrayDataset(imgs, tgts, classes=list(POSE_KEYPOINTS),
                        name=f"pose_{'train' if train else 'test'}", provenance="synthetic")


DATASET_LOADERS["synthetic_pose"] = (
    lambda root=None, train=True, n=512, image_size=32, heatmap_size=16, sigma=1.0, seed=0,
    **kw: generate_pose_dataset(n=int(n), image_size=int(image_size),
                                heatmap_size=int(heatmap_size), sigma=float(sigma),
                                seed=int(seed), train=train))


def heatmap_mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over (N, S, S, K) heatmaps, in float32."""
    return (pred.float() - target.float()).square().mean()


def decode_heatmaps(pred: torch.Tensor):
    """Heatmaps (N, S, S, K) -> (coords (N, K, 2) as (x, y) heatmap pixels,
    scores (N, K), the peak values): each channel's argmax, shifted a
    quarter pixel toward the larger neighbour on each axis where the peak
    is interior on that axis (0 < p < S - 1). Both neighbour reads are
    around the integer peak."""
    n, s, _, k = pred.shape
    flat = pred.reshape(n, s * s, k)
    idx = flat.argmax(1)
    scores = flat.gather(1, idx[:, None, :])[:, 0, :]
    yi, xi = idx // s, idx % s

    def at(dx, dy):
        j = (yi + dy).clamp(0, s - 1) * s + (xi + dx).clamp(0, s - 1)
        return flat.gather(1, j[:, None, :])[:, 0, :]

    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    x = xi.float() + torch.where((xi > 0) & (xi < s - 1),
                                 0.25 * torch.sign(at(1, 0) - at(-1, 0)).float(), zero)
    y = yi.float() + torch.where((yi > 0) & (yi < s - 1),
                                 0.25 * torch.sign(at(0, 1) - at(0, -1)).float(), zero)
    return torch.stack([x, y], dim=-1), scores


def pck(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """PCK@alpha: the share of keypoints decoded within ``alpha`` times the
    heatmap size of the target's decoded peak."""
    s = pred.shape[1]
    dist = torch.linalg.vector_norm(decode_heatmaps(pred)[0] - decode_heatmaps(target)[0],
                                    dim=-1)
    return (dist <= alpha * s).float().mean()


def create_pose_estimator(datasets, model_params: Mapping[str, Any],
                          device=None) -> DeepcvModule:
    """The backbone's spec with the dense head appended: a 1x1 conv to one
    channel per keypoint and a resize to the targets' heatmap size."""
    trainset = datasets["trainset"]
    tgt = trainset.dataset.targets
    hp = copy.deepcopy(dict(model_params))
    append_dense_head(hp, "pose_head", tgt.shape[-1], (tgt.shape[1], tgt.shape[1]))
    return DeepcvModule(trainset.image_shape, hp, device=device)


def train_pose_estimator(datasets, model: DeepcvModule, hp: Mapping[str, Any], trackers=()):
    state, history = train_fn(hp, model, heatmap_mse_loss, datasets, metrics={"pck": pck},
                              loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


def get_pipelines() -> Dict[str, Pipeline]:
    return {"train_pose_estimator": Pipeline([
        Node(preprocess_node, ["pose_train", "pose_test", "params:pose_preprocessing"],
             "datasets", name="preprocess"),
        Node(create_pose_estimator, ["datasets", "params:pose_estimator_model", "device"],
             "model", name="create_pose_estimator"),
        Node(train_pose_estimator, ["datasets", "model", "params:train_pose_estimator",
                                    "trackers"], "train_results", name="train"),
    ], name="train_pose_estimator", tags={"train", "pose"})}

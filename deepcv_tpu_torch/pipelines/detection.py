"""Object detection: ``train_object_detector`` and ``train_fpn_detector``.

Counterpart of ``deepcv_tpu/pipelines/detection.py`` (``SHAPE_CLASSES``,
``DenseDetectionHead``, ``generate_shapes_dataset`` and
``generate_shapes_dataset_fpn`` with their ``synthetic_shapes`` and
``synthetic_shapes_fpn`` loaders, ``detection_loss``,
``detection_loss_focal``, ``objectness_accuracy``,
``mean_iou_on_objects``, ``decode_detections``,
``decode_detections_flat``, ``map50``, ``map50_flat``,
``flat_grid_layout``, ``create_detector``, ``train_detector``,
``create_fpn_detector``, ``train_fpn_detector``, ``get_pipelines``):

* a single-stage dense detector: every cell of an SxS grid predicts
  (objectness, cx, cy, w, h, class logits) by a 1x1 conv on the backbone's
  map (a K2 conv), trained with a YOLOv1-style cell-matched loss;
* its multi-scale variant: the backbone gathers named levels, an FPN with a
  shared 3x3 head emits one flat (N, sum of S^2, 5 + C) tensor over the
  levels (fine to coarse), trained with a focal objectness loss;
* mAP@0.5 in the validation pass only (``train()``'s ``eval_metrics``):
  top-k decode, class-aware NMS, VOC AP on the device (``ops/boxes.py``).

The generators draw from numpy's ``default_rng`` in the JAX package's
order, so a seed gives the same bytes.
"""
from __future__ import annotations

import copy
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch.data.datasets import DATASET_LOADERS, ArrayDataset
from deepcv_tpu_torch.ops.boxes import batched_nms, mean_average_precision, nms, topk
from deepcv_tpu_torch.ops.nn import LecunConv2d
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, preprocess_node
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.training import train as train_fn

__all__ = ["SHAPE_CLASSES", "DenseDetectionHead", "generate_shapes_dataset",
           "generate_shapes_dataset_fpn", "detection_loss", "detection_loss_focal",
           "objectness_accuracy", "mean_iou_on_objects", "decode_detections",
           "decode_detections_flat", "map50", "map50_flat", "flat_grid_layout",
           "create_detector", "train_detector", "create_fpn_detector", "train_fpn_detector",
           "get_pipelines"]

#: synthetic-shapes classes (also the rectangle fill colors)
SHAPE_CLASSES = ("red", "green", "blue")


class DenseDetectionHead(nn.Module):
    """Per-cell (objectness + box + class) head over an NHWC feature map:
    one 1x1 conv to 5 + num_classes channels (flax's default init), NHWC
    out."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.det_head = LecunConv2d(int(in_channels), 5 + int(num_classes), (1, 1))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.det_head(features.movedim(-1, 1)).movedim(1, -1)


# --------------------------------------------------------------------------- #
# Synthetic shapes datasets
# --------------------------------------------------------------------------- #

def _draw_rectangle(rng, imgs, i, image_size, c, max_wh):
    """One rectangle of a random class drawn into image ``i``; returns (cx,
    cy, w, h, cls). The draws' order is the JAX generators'."""
    w = rng.uniform(0.15, max_wh)
    h = rng.uniform(0.15, max_wh)
    cx = rng.uniform(w / 2, 1 - w / 2)
    cy = rng.uniform(h / 2, 1 - h / 2)
    cls = int(rng.integers(c))
    x0, x1 = int((cx - w / 2) * image_size), int((cx + w / 2) * image_size)
    y0, y1 = int((cy - h / 2) * image_size), int((cy + h / 2) * image_size)
    color = np.zeros(3, np.uint8)
    color[cls] = rng.integers(180, 256)
    imgs[i, y0:y1, x0:x1] = color
    return cx, cy, w, h, cls


def _set_cell(row, cx, cy, w, h, cls, s, gx, gy):
    """A target row: [objectness, cx and cy in the cell, w, h, one-hot class]."""
    row[0] = 1.0
    row[1] = cx * s - gx
    row[2] = cy * s - gy
    row[3] = w
    row[4] = h
    row[5:] = 0.0
    row[5 + cls] = 1.0


def generate_shapes_dataset(n: int = 512, image_size: int = 32, grid: int = 8,
                            max_objects: int = 3, seed: int = 0,
                            train: bool = True) -> ArrayDataset:
    """Images with 1..max_objects colored rectangles over dark noise; the
    target grid (S, S, 5 + C) holds, in the cell of each rectangle's centre,
    [objectness, cx in cell, cy in cell, w, h, one-hot class] (w and h as
    fractions of the image)."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    c = len(SHAPE_CLASSES)
    imgs = np.zeros((n, image_size, image_size, 3), np.uint8)
    tgts = np.zeros((n, grid, grid, 5 + c), np.float32)
    for i in range(n):
        imgs[i] = rng.integers(0, 40, (image_size, image_size, 3))
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cx, cy, w, h, cls = _draw_rectangle(rng, imgs, i, image_size, c, 0.45)
            gx, gy = min(grid - 1, int(cx * grid)), min(grid - 1, int(cy * grid))
            _set_cell(tgts[i, gy, gx], cx, cy, w, h, cls, grid, gx, gy)
    return ArrayDataset(imgs, tgts, classes=list(SHAPE_CLASSES),
                        name=f"shapes_{'train' if train else 'test'}", provenance="synthetic")


DATASET_LOADERS["synthetic_shapes"] = (
    lambda root=None, train=True, n=512, image_size=32, grid=8, seed=0, **kw:
    generate_shapes_dataset(n=int(n), image_size=int(image_size), grid=int(grid),
                            seed=int(seed), train=train))


def generate_shapes_dataset_fpn(n: int = 512, image_size: int = 32,
                                grids: Tuple[int, ...] = (8, 4),
                                size_bounds: Tuple[float, ...] = (0.3,),
                                max_objects: int = 3, seed: int = 0,
                                train: bool = True) -> ArrayDataset:
    """Rectangle images with flat multi-level targets (N, sum of S^2, 5 +
    C): each rectangle goes to the first level whose size bound is at least
    max(w, h) (the next coarser past the last bound), then to the cell of
    its centre in that level's grid."""
    if len(size_bounds) != len(grids) - 1:
        raise ValueError("need one size bound per level boundary "
                         f"({len(grids) - 1}), got {len(size_bounds)}")
    rng = np.random.default_rng(seed + (0 if train else 1))
    c = len(SHAPE_CLASSES)
    offsets = np.cumsum([0] + [s * s for s in grids])[:-1]
    imgs = np.zeros((n, image_size, image_size, 3), np.uint8)
    tgts = np.zeros((n, sum(s * s for s in grids), 5 + c), np.float32)
    for i in range(n):
        imgs[i] = rng.integers(0, 40, (image_size, image_size, 3))
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cx, cy, w, h, cls = _draw_rectangle(rng, imgs, i, image_size, c, 0.6)
            lvl = int(np.searchsorted(np.asarray(size_bounds), max(w, h)))
            s = grids[lvl]
            gx, gy = min(s - 1, int(cx * s)), min(s - 1, int(cy * s))
            _set_cell(tgts[i, offsets[lvl] + gy * s + gx], cx, cy, w, h, cls, s, gx, gy)
    return ArrayDataset(imgs, tgts, classes=list(SHAPE_CLASSES),
                        name=f"shapes_fpn_{'train' if train else 'test'}",
                        provenance="synthetic")


def _load_shapes_fpn(root=None, train=True, n=512, image_size=32, grids=(8, 4),
                     size_bounds=None, max_objects=3, seed=0, **kw):
    """Catalog loader: with no bounds, (0.3,) for two levels, else bounds
    evenly spaced over the generator's (0.15, 0.6) object sizes."""
    grids = tuple(int(g) for g in grids)
    if size_bounds is None:
        k = len(grids) - 1
        size_bounds = (0.3,) if k == 1 else tuple(
            round(0.15 + (0.6 - 0.15) * (i + 1) / (k + 1), 4) for i in range(k))
    return generate_shapes_dataset_fpn(
        n=int(n), image_size=int(image_size), grids=grids,
        size_bounds=tuple(float(b) for b in size_bounds), max_objects=int(max_objects),
        seed=int(seed), train=train)


DATASET_LOADERS["synthetic_shapes_fpn"] = _load_shapes_fpn


# --------------------------------------------------------------------------- #
# Losses and metrics
# --------------------------------------------------------------------------- #

def _objectness_bce(logit: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    return logit.clamp(min=0) - logit * obj + torch.log1p(torch.exp(-logit.abs()))


def _box_and_class_terms(pred, target, obj, n_obj):
    """The object cells' box MSE (sigmoid of channels 1:5 against the
    targets) and class cross-entropy, each over the object count."""
    box_err = (torch.sigmoid(pred[..., 1:5]) - target[..., 1:5]).square().sum(-1)
    logp = F.log_softmax(pred[..., 5:], dim=-1)
    cls_loss = -(obj * (target[..., 5:] * logp).sum(-1)).sum() / n_obj
    return (obj * box_err).sum() / n_obj, cls_loss


def detection_loss(pred: torch.Tensor, target: torch.Tensor, box_weight: float = 5.0,
                   noobj_weight: float = 0.5) -> torch.Tensor:
    """YOLOv1-style loss over the dense grid (N, S, S, 5 + C), in float32:
    objectness sigmoid-BCE on every cell (no-object cells weighted by
    ``noobj_weight``), box MSE and class CE on object cells."""
    pred, target = pred.float(), target.float()
    obj = target[..., 0]
    bce = _objectness_bce(pred[..., 0], obj)
    obj_loss = torch.where(obj > 0, bce, noobj_weight * bce).mean()
    box_loss, cls_loss = _box_and_class_terms(pred, target, obj, obj.sum().clamp(min=1.0))
    return obj_loss + box_weight * box_loss + cls_loss


def detection_loss_focal(pred: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
                         alpha: float = 0.25, box_weight: float = 5.0) -> torch.Tensor:
    """Focal variant (Lin et al., arXiv:1708.02002) over the flat
    multi-level layout (N, T, 5 + C), in float32: sigmoid focal BCE on
    objectness over the object count (RetinaNet's normalisation), plus the
    object cells' box MSE and class CE of :func:`detection_loss`."""
    pred, target = pred.float(), target.float()
    obj = target[..., 0]
    bce = _objectness_bce(pred[..., 0], obj)
    p_t = torch.exp(-bce)
    alpha_t = torch.where(obj > 0, alpha, 1.0 - alpha)
    n_obj = obj.sum().clamp(min=1.0)
    obj_loss = (alpha_t * (1.0 - p_t) ** gamma * bce).sum() / n_obj
    box_loss, cls_loss = _box_and_class_terms(pred, target, obj, n_obj)
    return obj_loss + box_weight * box_loss + cls_loss


def objectness_accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cell-level objectness accuracy, the mean of the object cells' and the
    empty cells' accuracies."""
    obj = target[..., 0] > 0.5
    hit = ((pred[..., 0] > 0) == obj).float()
    acc_obj = (hit * obj).sum() / obj.sum().clamp(min=1)
    acc_no = (hit * ~obj).sum() / (~obj).sum().clamp(min=1)
    return 0.5 * (acc_obj + acc_no)


def _cell_boxes(fields: torch.Tensor, gx, gy, s, raw: bool) -> torch.Tensor:
    """Cell rows (channels 1:5: cx and cy in the cell, w, h) -> normalized
    xyxy boxes; ``raw`` applies the head's sigmoid (targets are stored after
    it). The one copy of this decode: predictions, their IoU with the
    targets and the ground truth of mAP all go through it."""
    cxy = torch.sigmoid(fields[..., 1:3]) if raw else fields[..., 1:3]
    wh = torch.sigmoid(fields[..., 3:5]) if raw else fields[..., 3:5]
    cx = (gx + cxy[..., 0]) / s
    cy = (gy + cxy[..., 1]) / s
    return torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                        cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], dim=-1)


def mean_iou_on_objects(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean IoU of the predicted and target boxes over the object cells of
    a dense grid (N, S, S, 5 + C)."""
    n, s = pred.shape[0], pred.shape[1]
    grid = torch.arange(s, dtype=torch.float32, device=pred.device)
    gy, gx = grid[None, :, None].expand(n, s, s), grid[None, None, :].expand(n, s, s)
    a = _cell_boxes(pred, gx, gy, s, raw=True)
    b = _cell_boxes(target, gx, gy, s, raw=False)
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    union = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]) \
        + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter
    iou = inter / union.clamp(min=1e-9)
    obj = target[..., 0]
    return (iou * obj).sum() / obj.sum().clamp(min=1)


# --------------------------------------------------------------------------- #
# Decoding and mAP
# --------------------------------------------------------------------------- #

def _apply_nms(boxes, scores, classes, nms_iou: Optional[float], class_aware: bool):
    """Zero the scores of the candidates NMS suppresses, every image at once
    (``ops/boxes.py``); no-op when ``nms_iou`` is None."""
    if nms_iou is None:
        return scores
    keep = batched_nms(boxes, scores, classes, nms_iou) if class_aware \
        else nms(boxes, scores, nms_iou)
    return torch.where(keep, scores, torch.zeros_like(scores))


def decode_detections(pred: torch.Tensor, top_k: int = 16, nms_iou: Optional[float] = None,
                      class_aware_nms: bool = True):
    """Dense grid (N, S, S, 5 + C) -> the top-k cells by objectness: (boxes
    xyxy (N, k, 4), scores (N, k), classes (N, k)), ties ranked by the lower
    cell index. With ``nms_iou``, greedy NMS (class-aware by default) zeroes
    the suppressed candidates' scores; shapes stay fixed."""
    n, s = pred.shape[0], pred.shape[1]
    flat = pred.reshape(n, s * s, -1)
    scores, idx = topk(torch.sigmoid(flat[..., 0]), top_k)
    sel = flat.gather(1, idx[..., None].expand(-1, -1, flat.shape[-1]))
    boxes = _cell_boxes(sel, (idx % s).float(), (idx // s).float(), s, raw=True)
    classes = sel[..., 5:].argmax(-1)
    return boxes, _apply_nms(boxes, scores, classes, nms_iou, class_aware_nms), classes


def flat_grid_layout(grids: Tuple[int, ...], device=None):
    """(gx, gy, grid size) of every cell of the flat concatenation of the
    SxS levels ``grids`` (fine to coarse), float32 on ``device``."""
    gx, gy, gs = [], [], []
    for s in grids:
        j = np.arange(s * s)
        gx.append(j % s)
        gy.append(j // s)
        gs.append(np.full(s * s, s))
    return tuple(torch.from_numpy(np.concatenate(a).astype(np.float32)).to(device)
                 for a in (gx, gy, gs))


def decode_detections_flat(pred: torch.Tensor, grids: Tuple[int, ...], top_k: int = 16,
                           nms_iou: Optional[float] = None, class_aware_nms: bool = True):
    """Flat multi-level grid (N, T, 5 + C) -> the top-k cells over all
    levels, then optional NMS (which also merges one object's detections on
    two levels), as :func:`decode_detections`."""
    gx, gy, gs = flat_grid_layout(grids, pred.device)
    scores, idx = topk(torch.sigmoid(pred[..., 0]), top_k)
    sel = pred.gather(1, idx[..., None].expand(-1, -1, pred.shape[-1]))
    boxes = _cell_boxes(sel, gx[idx], gy[idx], gs[idx], raw=True)
    classes = sel[..., 5:].argmax(-1)
    return boxes, _apply_nms(boxes, scores, classes, nms_iou, class_aware_nms), classes


def map50(pred: torch.Tensor, target: torch.Tensor, score_threshold: float = 0.0,
          top_k: int = 16) -> torch.Tensor:
    """mAP@0.5 over the evaluated batch: decode with class-aware NMS, the
    ground truth read off the dense grid, VOC all-point AP per class over
    the classes present (``ops/boxes.mean_average_precision``, on the
    device). Every unsuppressed top-k detection is ranked (a threshold of
    0). A validation metric (``train()``'s ``eval_metrics``).

    ``train()`` hands validation metrics float32 logits. Under bfloat16 the
    JAX package decodes the bf16 logits, whose rounded sigmoid scores tie
    more often, so ranks (and the mAP) can differ there; in float32 they
    agree."""
    n, s, _, ch = target.shape
    boxes, scores, classes = decode_detections(pred, top_k=top_k, nms_iou=0.5)
    flat = target.reshape(n, s * s, ch)
    j = torch.arange(s * s, device=target.device)
    gt_boxes = _cell_boxes(flat, (j % s).float()[None], (j // s).float()[None], s, raw=False)
    m_ap, _ = mean_average_precision(boxes, scores, classes, scores > score_threshold,
                                     gt_boxes, flat[..., 5:].argmax(-1), flat[..., 0] > 0.5,
                                     num_classes=ch - 5)
    return m_ap


def map50_flat(pred: torch.Tensor, target: torch.Tensor, grids: Tuple[int, ...],
               score_threshold: float = 0.0, top_k: int = 16) -> torch.Tensor:
    """mAP@0.5 for the flat multi-level layout (:func:`map50`'s protocol);
    pass ``functools.partial(map50_flat, grids=...)`` as an eval metric."""
    boxes, scores, classes = decode_detections_flat(pred, grids, top_k=top_k, nms_iou=0.5)
    gx, gy, gs = flat_grid_layout(grids, target.device)
    gt_boxes = _cell_boxes(target, gx[None], gy[None], gs[None], raw=False)
    m_ap, _ = mean_average_precision(boxes, scores, classes, scores > score_threshold,
                                     gt_boxes, target[..., 5:].argmax(-1), target[..., 0] > 0.5,
                                     num_classes=target.shape[-1] - 5)
    return m_ap


# --------------------------------------------------------------------------- #
# Models and training
# --------------------------------------------------------------------------- #

def create_detector(datasets, model_params: Mapping[str, Any], device=None) -> DeepcvModule:
    """The backbone's spec ending in the dense head: a norm-free 1x1 conv to
    5 + num_classes channels (a K2 conv)."""
    trainset = datasets["trainset"]
    num_classes = trainset.dataset.targets.shape[-1] - 5
    hp = copy.deepcopy(dict(model_params))
    hp["architecture"].append({"conv2d": {
        "kernel_size": [1, 1], "out_channels": 5 + num_classes, "padding": 0, "act_fn": None,
        **{t: None for t in ("batch_norm", "group_norm", "layer_norm")}}})
    return DeepcvModule(trainset.image_shape, hp, device=device)


def train_detector(datasets, model: DeepcvModule, hp: Mapping[str, Any], trackers=()):
    state, history = train_fn(hp, model, detection_loss, datasets,
                              metrics={"objectness_accuracy": objectness_accuracy,
                                       "mean_iou": mean_iou_on_objects},
                              eval_metrics={"map50": map50}, loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


def create_fpn_detector(datasets, model_params: Mapping[str, Any], device=None) -> DeepcvModule:
    """The backbone's spec, which gathers its named levels
    (``_new_branch_from_tensor {_from: [c3, c4]}``), with the FPN and its
    shared head appended (``fpn_channels``, default 64): the flat (N,
    T_total, 5 + C) output of the FPN targets."""
    trainset = datasets["trainset"]
    num_classes = trainset.dataset.targets.shape[-1] - 5
    hp = copy.deepcopy(dict(model_params))
    channels = int(hp.pop("fpn_channels", 64))
    hp["architecture"].append({"fpn": {"channels": channels, "head_outputs": 5 + num_classes}})
    return DeepcvModule(trainset.image_shape, hp, device=device)


def train_fpn_detector(datasets, model: DeepcvModule, hp: Mapping[str, Any], trackers=()):
    """``fpn_grids`` (default (8, 4)) lays out the decode and the mAP; it
    must run strictly fine to coarse and flatten to the targets' cells."""
    grids = tuple(int(g) for g in hp.get("fpn_grids", (8, 4)))
    if list(grids) != sorted(grids, reverse=True) or len(set(grids)) != len(grids):
        raise ValueError(f"fpn_grids must be strictly fine->coarse (decreasing), got {grids}")
    t_total = sum(s * s for s in grids)
    t_ds = datasets["trainset"].dataset.targets.shape[1]
    if t_total != t_ds:
        raise ValueError(f"fpn_grids {grids} flatten to {t_total} cells but the dataset "
                         f"targets have {t_ds}")
    state, history = train_fn(hp, model, detection_loss_focal, datasets,
                              metrics={"objectness_accuracy": objectness_accuracy},
                              eval_metrics={"map50": functools.partial(map50_flat, grids=grids)},
                              loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


def get_pipelines() -> Dict[str, Pipeline]:
    return {
        "train_object_detector": Pipeline([
            Node(preprocess_node, ["shapes_train", "shapes_test", "params:shapes_preprocessing"],
                 "datasets", name="preprocess"),
            Node(create_detector, ["datasets", "params:object_detector_model", "device"],
                 "model", name="create_detector"),
            Node(train_detector, ["datasets", "model", "params:train_object_detector",
                                  "trackers"], "train_results", name="train"),
        ], name="train_object_detector", tags={"train", "detection"}),
        "train_fpn_detector": Pipeline([
            Node(preprocess_node, ["shapes_fpn_train", "shapes_fpn_test",
                                   "params:shapes_preprocessing"], "datasets", name="preprocess"),
            Node(create_fpn_detector, ["datasets", "params:fpn_detector_model", "device"],
                 "model", name="create_fpn_detector"),
            Node(train_fpn_detector, ["datasets", "model", "params:train_fpn_detector",
                                      "trackers"], "train_results", name="train"),
        ], name="train_fpn_detector", tags={"train", "detection"}),
    }

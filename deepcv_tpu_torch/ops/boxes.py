"""Box ops: IoU, non-maximum suppression, mAP, and the top-k they rank by.

Counterpart of ``deepcv_tpu/ops/boxes.py`` (``box_iou``, ``nms``,
``batched_nms``, ``soft_nms``, ``mean_average_precision``). Shapes stay
static, as there: a fixed set of candidates, validity carried as masks,
suppression and greedy matching as loops of vector steps over precomputed
IoU matrices. The loops here run over a leading batch of images at once
(the JAX package ``vmap``\\ s them), so NMS takes N steps for any number of
images.

Boxes are (..., 4) in xyxy order. Ranking breaks ties by the lower index,
as ``jax.lax.top_k`` and the stable ``jnp.argsort`` do (:func:`topk`,
:func:`argsort_desc`); ``torch.topk`` promises no order among equal values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["argsort_desc", "topk", "box_iou", "nms", "batched_nms", "soft_nms",
           "mean_average_precision"]


def argsort_desc(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Indices that sort ``x`` along ``dim`` in descending order, equal
    values in ascending index order (``jnp.argsort(-x)``, stable)."""
    return torch.sort(x, dim=dim, descending=True, stable=True).indices


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices, equal
    values in ascending index order (``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., M, 4), b (..., N, 4) -> (..., M, N). A pair
    whose union has no area gets 0."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0.0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0.0) * (a[..., 3] - a[..., 1]).clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(union))


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        score_threshold: Optional[float] = None) -> torch.Tensor:
    """Greedy NMS over a fixed set of N candidates per image: boxes (..., N,
    4), scores (..., N) -> boolean keep mask (..., N). In descending score
    order, a kept candidate suppresses every later one whose IoU with it
    exceeds ``iou_threshold``; with ``score_threshold`` only candidates
    scoring above it start kept. N vector steps over the sorted (..., N, N)
    IoU matrix."""
    n = boxes.shape[-2]
    order = argsort_desc(scores)
    sorted_boxes = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    iou = box_iou(sorted_boxes, sorted_boxes)
    keep = torch.ones_like(scores, dtype=torch.bool) if score_threshold is None \
        else scores.gather(-1, order) > score_threshold
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        suppress = (iou[..., i, :] > iou_threshold) & (later > i) & keep[..., i:i + 1]
        keep = keep & ~suppress
    return torch.zeros_like(keep).scatter(-1, order, keep)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                iou_threshold: float = 0.5,
                score_threshold: Optional[float] = None) -> torch.Tensor:
    """Class-aware NMS: boxes of different classes never suppress each
    other. Each image's boxes are moved by class times its own span (the max
    minus the min of that image's coordinates, plus 1), then one
    :func:`nms` pass runs."""
    span = boxes.amax(dim=(-2, -1), keepdim=True) - boxes.amin(dim=(-2, -1), keepdim=True) + 1.0
    offset = classes.to(boxes.dtype)[..., None] * span
    return nms(boxes + offset, scores, iou_threshold, score_threshold)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, method: str = "gaussian",
             sigma: float = 0.5, iou_threshold: float = 0.3) -> torch.Tensor:
    """Soft-NMS (Bodla et al., arXiv:1704.04503) -> the rescored (..., N)
    float32 scores. N rounds; each picks the highest current score among the
    candidates not yet picked (the lowest index among equals) and decays the
    others' scores by its IoU with them: 'gaussian' ``exp(-iou^2 / sigma)``,
    or 'linear' ``1 - iou`` where iou exceeds ``iou_threshold``."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"soft_nms method must be 'gaussian' or 'linear', got {method!r}")
    n = boxes.shape[-2]
    iou = box_iou(boxes, boxes)
    s = scores.float()
    done = torch.zeros_like(s, dtype=torch.bool)
    idx = torch.arange(n, device=boxes.device)
    neg_inf = torch.tensor(float("-inf"), device=boxes.device)
    for _ in range(n):
        j = torch.where(done, neg_inf, s).argmax(-1, keepdim=True)
        row = iou.gather(-2, j[..., None].expand(*j.shape, n))[..., 0, :]
        if method == "linear":
            decay = torch.where(row > iou_threshold, 1.0 - row, torch.ones_like(row))
        else:
            decay = torch.exp(-(row ** 2) / sigma)
        picked = idx == j
        s = torch.where(done | picked, s, s * decay)
        done = done | picked
    return s


def mean_average_precision(pred_boxes: torch.Tensor, pred_scores: torch.Tensor,
                           pred_classes: torch.Tensor, pred_valid: torch.Tensor,
                           gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                           gt_valid: torch.Tensor, num_classes: int,
                           iou_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """mAP at ``iou_threshold`` over a batch of images -> (mAP, per-class AP
    (num_classes,)): Pascal-VOC all-point AP per class, averaged over the
    classes with ground truth (an absent class's entry is 0). Predictions are
    ranked across the whole batch.

    pred_boxes (N, P, 4), pred_scores/classes/valid (N, P); gt_boxes (N, G,
    4), gt_classes/valid (N, G).

    Matching is the VOC protocol: in descending score order each prediction
    takes its best-IoU unmatched ground truth of its class (IoU at least the
    threshold), else it is a false positive. A prediction can only take a
    ground truth of its own image, so the JAX package's one scan over the
    N*P ranked predictions is, per image, a chain of that image's P
    predictions in score order: here P vector steps over every image and
    class at once, on the device the tensors are on (no copy to the host).
    The cumulative sums then run over the batch-wide ranking."""
    n, p, _ = pred_boxes.shape
    dev = pred_boxes.device
    iou = box_iou(pred_boxes.float(), gt_boxes.float())                   # (N, P, G)
    cls = torch.arange(num_classes, device=dev)
    pv = pred_valid[None] & (pred_classes[None] == cls[:, None, None])     # (C, N, P)
    gv = gt_valid[None] & (gt_classes[None] == cls[:, None, None])         # (C, N, G)
    n_gt = gv.float().sum((1, 2))                                           # (C,)
    scores = pred_scores.float()

    # greedy matching: each image's predictions in its own score order
    order = argsort_desc(scores)                                            # (N, P)
    iou_sorted = iou.gather(1, order[..., None].expand(-1, -1, iou.shape[-1]))
    pv_sorted = pv.gather(2, order[None].expand(num_classes, -1, -1))
    matched = torch.zeros_like(gv)
    hits = []
    for j in range(p):
        row = torch.where(gv & ~matched, iou_sorted[None, :, j, :], -1.0)   # (C, N, G)
        best = row.argmax(-1, keepdim=True)
        hit = (row.gather(-1, best)[..., 0] >= iou_threshold) & pv_sorted[..., j]
        matched = matched.scatter(-1, best, matched.gather(-1, best) | hit[..., None])
        hits.append(hit)
    tp_sorted = torch.stack(hits, -1)                                       # (C, N, P)
    tp = torch.zeros_like(tp_sorted).scatter(2, order[None].expand(num_classes, -1, -1),
                                             tp_sorted)

    # AP over the batch-wide ranking of each class's predictions
    ranked = torch.where(pv, scores[None], float("-inf")).reshape(num_classes, n * p)
    rank = argsort_desc(ranked)
    tp_ranked = tp.reshape(num_classes, n * p).gather(1, rank).float()
    v = pv.reshape(num_classes, n * p).gather(1, rank).float()
    cum_tp = tp_ranked.cumsum(1)
    cum_fp = (v - tp_ranked).cumsum(1)
    recall = cum_tp / n_gt.clamp(min=1.0)[:, None]
    precision = cum_tp / (cum_tp + cum_fp).clamp(min=1e-12)
    envelope = precision.flip(1).cummax(1).values.flip(1)
    delta_r = torch.diff(recall, dim=1, prepend=torch.zeros_like(recall[:, :1]))
    present = n_gt > 0
    per_class = torch.where(present, (envelope * delta_r).sum(1), torch.zeros_like(n_gt))
    m_ap = per_class.sum() / present.sum().clamp(min=1)
    return m_ap, per_class

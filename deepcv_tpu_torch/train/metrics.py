"""Metrics and their running means.

Counterpart of ``deepcv_tpu/train/metrics.py`` (``accuracy``,
``top_k_accuracy``, ``METRIC_FNS``, ``MetricAccumulator``).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

__all__ = ["accuracy", "top_k_accuracy", "METRIC_FNS", "MetricAccumulator"]


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax predictions equal to int labels (or to the argmax
    of one-hot rows)."""
    if labels.dim() > 1 and labels.shape[-1] == logits.shape[-1]:
        labels = labels.argmax(-1)
    return (logits.argmax(-1) == labels).float().mean()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Fraction of rows whose label is among the ``k`` largest logits."""
    if labels.dim() > 1 and labels.shape[-1] == logits.shape[-1]:
        labels = labels.argmax(-1)
    topk = torch.argsort(logits, dim=-1)[..., -k:]
    return (topk == labels[..., None]).any(-1).float().mean()


#: metrics by name (NAS selection and rewards look them up here)
METRIC_FNS: Dict[str, Callable] = {
    "accuracy": accuracy,
    "top_5_accuracy": lambda logits, labels: top_k_accuracy(logits, labels, 5),
}


class MetricAccumulator:
    """Weighted running mean over batches. Device scalars are summed on the
    device; they reach the host only in :meth:`compute`."""

    def __init__(self):
        self._sums: Dict[str, torch.Tensor] = {}
        self._count = 0.0

    def update(self, values: Mapping[str, torch.Tensor], weight: float = 1.0):
        for k, v in values.items():
            v = v.detach().float() * weight if torch.is_tensor(v) else float(v) * weight
            self._sums[k] = self._sums[k] + v if k in self._sums else v
        self._count += weight

    def compute(self) -> Dict[str, float]:
        if self._count == 0:
            return {}
        return {k: float(v) / self._count for k, v in self._sums.items()}

    def reset(self):
        self._sums.clear()
        self._count = 0.0

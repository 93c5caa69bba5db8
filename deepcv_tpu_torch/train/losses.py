"""Losses and their weighting.

Counterpart of ``deepcv_tpu/train/losses.py`` (``cross_entropy_loss``,
``label_smoothing_xentropy_loss``, ``mse_loss``, ``l1_loss``,
``distillation_loss``, ``distill_accuracy``,
``jensen_shannon_divergence_consistency_loss``, ``triplet_margin_loss``,
``WeightedLosses``), each registered in :data:`LOSS_FNS` under the JAX
package's name.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_loss", "label_smoothing_xentropy_loss", "mse_loss", "l1_loss",
           "distillation_loss", "distill_accuracy", "jensen_shannon_divergence_consistency_loss",
           "triplet_margin_loss", "WeightedLosses", "LOSS_FNS"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy in float32 (``torch.nn.CrossEntropyLoss``
    values). Labels are int classes or one-hot rows; integer class labels
    outside [0, num_classes) are left out of the mean, as in the JAX
    package (torch's ``ignore_index`` for any out-of-range label)."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    if not labels.is_floating_point() and labels.dim() == logits.dim() - 1:
        valid = (labels >= 0) & (labels < num_classes)
        y = F.one_hot(labels.clamp(0, num_classes - 1).long(), num_classes).float()
        if label_smoothing:
            y = y * (1.0 - label_smoothing) + label_smoothing / num_classes
        rows = -(y * logp).sum(-1) * valid
        return rows.sum() / valid.sum().clamp(min=1)
    y = labels.float()
    if label_smoothing:
        y = y * (1.0 - label_smoothing) + label_smoothing / num_classes
    return -(y * logp).sum(-1).mean()


def label_smoothing_xentropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """Cross-entropy against labels smoothed by ``smoothing``."""
    return cross_entropy_loss(logits, labels, label_smoothing=smoothing)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error in float32."""
    return (pred.float() - target.float()).square().mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error in float32."""
    return (pred.float() - target.float()).abs().mean()


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                        margin: float = 1.0, p: int = 2) -> torch.Tensor:
    """``mean(max(d(a, p) - d(a, n) + margin, 0))`` in float32, with the
    L2 distance ``sqrt(sum(d^2) + 1e-12)`` (the Lp one for other ``p``)."""
    def dist(a, b):
        d = a.float() - b.float()
        if p == 2:
            return torch.sqrt((d * d).sum(-1) + 1e-12)
        return (d.abs() ** p).sum(-1) ** (1.0 / p)

    return torch.clamp(dist(anchor, positive) - dist(anchor, negative) + margin, min=0.0).mean()


def distillation_loss(student_logits: torch.Tensor, targets: torch.Tensor,
                      temperature: float = 4.0, alpha: float = 0.5) -> torch.Tensor:
    """Knowledge distillation (Hinton et al., arXiv:1503.02531) over
    precomputed teacher logits: ``targets`` (N, 1 + C) hold the integer
    label in column 0 and the frozen teacher's logits after it (the layout
    :func:`deepcv_tpu_torch.serve.distill_targets` makes). Loss = alpha *
    CE(student, label) + (1 - alpha) * T^2 * KL(teacher_T || student_T), in
    float32."""
    labels = targets[..., 0].to(torch.int64)
    t_logits = targets[..., 1:].float()
    s_logits = student_logits.float()
    hard = cross_entropy_loss(s_logits, labels)
    t = float(temperature)
    p_t = F.softmax(t_logits / t, dim=-1)
    logp_s = F.log_softmax(s_logits / t, dim=-1)
    logp_t = F.log_softmax(t_logits / t, dim=-1)
    kl = (p_t * (logp_t - logp_s)).sum(-1).mean()
    return float(alpha) * hard + (1.0 - float(alpha)) * (t * t) * kl


def distill_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Accuracy against the hard label of a distillation target layout
    (column 0 of the (N, 1 + C) targets)."""
    return (logits.argmax(-1) == targets[..., 0].to(torch.int64)).float().mean()


def jensen_shannon_divergence_consistency_loss(logits_clean: torch.Tensor,
                                               *logits_augmented: torch.Tensor
                                               ) -> torch.Tensor:
    """AugMix's JSD consistency (arXiv:1912.02781 eq. 4): the mean over
    {clean, augmented...} of KL(p || M), M their mean distribution, with
    the probabilities clipped to [1e-7, 1] inside the logs and no gradient
    through the clean branch; float32."""
    p_clean = F.softmax(logits_clean.float(), dim=-1).detach()
    ps = [p_clean] + [F.softmax(lg.float(), dim=-1) for lg in logits_augmented]
    m = sum(ps) / len(ps)
    log_m = torch.log(torch.clamp(m, 1e-7, 1.0))

    def kl(p):
        return (p * (torch.log(torch.clamp(p, 1e-7, 1.0)) - log_m)).sum(-1)

    return (sum(kl(p) for p in ps) / len(ps)).mean()


LOSS_FNS: Dict[str, Callable] = {"cross_entropy": cross_entropy_loss,
                                 "distillation": distillation_loss,
                                 "label_smoothing_xentropy": label_smoothing_xentropy_loss,
                                 "mse": mse_loss,
                                 "l1": l1_loss,
                                 "jsd_consistency": jensen_shannon_divergence_consistency_loss,
                                 "triplet_margin": triplet_margin_loss}


class WeightedLosses:
    """Named loss terms with weights; returns the per-term values and their
    weighted mean under 'main_loss'."""

    MAIN = "main_loss"

    def __init__(self, losses: Union[Callable, Sequence[Callable], Mapping[str, Callable]],
                 weights: Optional[Union[Sequence[float], Mapping[str, float]]] = None):
        if isinstance(losses, str):
            losses = {losses: LOSS_FNS[losses]}
        elif callable(losses):
            losses = {"loss": losses}
        elif isinstance(losses, (list, tuple)):
            losses = {getattr(f, "__name__", f"loss_{i}"): f for i, f in enumerate(losses)}
        self.terms: Dict[str, Callable] = {}
        self.weights: Dict[str, float] = {}
        for name, spec in dict(losses).items():
            fn, w = spec if isinstance(spec, (tuple, list)) else (spec, 1.0)
            self.terms[name] = LOSS_FNS[fn] if isinstance(fn, str) else fn
            self.weights[name] = float(w)
        if weights is not None:
            if isinstance(weights, Mapping):
                self.weights.update({k: float(v) for k, v in weights.items()})
            else:
                self.weights.update({n: float(w) for n, w in zip(self.terms, weights)})
        self._norm = sum(self.weights.values())
        if self._norm <= 0:
            raise ValueError("Loss weights must sum to a positive value")

    def __call__(self, *args, **kwargs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        values = {name: fn(*args, **kwargs) for name, fn in self.terms.items()}
        main = sum(self.weights[n] * v for n, v in values.items()) / self._norm
        values[self.MAIN] = main
        return main, values

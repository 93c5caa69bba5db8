"""Meta-learning for fast adaptation: Reptile episodic training.

Counterpart of ``deepcv_tpu/train/meta_learning.py`` (``sample_episodes``,
``reptile_train``, ``adapt``, ``episode_accuracy``): Reptile
(arXiv:1803.02999), first order, so the inner loop is plain SGD and no
graph spans it. Episodes are fixed (n_way x k_shot) support and
(n_way x q_queries) query sets drawn on the host with numpy, so the same
``rng`` gives the JAX package's episodes bit for bit.

The JAX package vmaps the inner loop over a meta-batch of episodes. Here
the episodes run one after another on the model's own parameters, updated
in place: K2's autograd launch has no batching rule, and its packed weight
is cached per version of the module's ``weight`` (``_WeightOp``), which an
in-place update moves on (a new tensor at a freed address could be served
a stale pack). Models with batch statistics are refused, as in the JAX
package: use group or layer norm.
"""
from __future__ import annotations

import copy
import logging
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sample_episodes", "reptile_train", "adapt", "episode_accuracy"]

_logger = logging.getLogger(__name__)


def sample_episodes(images: np.ndarray, labels: np.ndarray, *, n_way: int,
                    k_shot: int, q_queries: int, n_episodes: int,
                    rng: np.random.Generator,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Draw ``n_episodes`` N-way K-shot episodes.

    Returns (support_x (E, N*K, ...), support_y (E, N*K), query_x
    (E, N*Q, ...), query_y (E, N*Q)) with labels relabeled 0..n_way-1 per
    episode (class identity is episode-local).
    """
    labels = np.asarray(labels).astype(np.int64)
    classes = np.unique(labels)
    if len(classes) < n_way:
        raise ValueError(f"need >= {n_way} classes for {n_way}-way episodes, "
                         f"dataset has {len(classes)}")
    by_class = {c: np.flatnonzero(labels == c) for c in classes}
    need = k_shot + q_queries
    for c, idx in by_class.items():
        if len(idx) < need:
            raise ValueError(f"class {c} has {len(idx)} examples, "
                             f"episodes need k_shot+q_queries={need}")
    sx, sy, qx, qy = [], [], [], []
    for _ in range(n_episodes):
        way = rng.choice(classes, size=n_way, replace=False)
        s_idx, q_idx = [], []
        for c in way:
            pick = rng.choice(by_class[c], size=need, replace=False)
            s_idx.append(pick[:k_shot])
            q_idx.append(pick[k_shot:])
        s_idx, q_idx = np.concatenate(s_idx), np.concatenate(q_idx)
        sx.append(images[s_idx])
        qx.append(images[q_idx])
        sy.append(np.repeat(np.arange(n_way), k_shot))
        qy.append(np.repeat(np.arange(n_way), q_queries))
    return (np.stack(sx), np.stack(sy).astype(np.int32),
            np.stack(qx), np.stack(qy).astype(np.int32))


def _check_pure_params(model: torch.nn.Module) -> None:
    if any(n.rsplit(".", 1)[-1].startswith("running_") for n, _ in model.named_buffers()):
        raise ValueError(
            "meta-learning needs a pure-params model: batch statistics updated on "
            "5-shot support sets are garbage (the classic few-shot BN failure) — build "
            "the model with group_norm/layer_norm instead of batch_norm")


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), y.long())


def _inner_sgd(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor, steps: int,
               lr: float) -> None:
    """``steps`` SGD steps on the support loss, in place on the model's
    parameters (``w - lr * g``, the JAX package's update)."""
    params = [p for p in model.parameters() if p.requires_grad]
    for _ in range(steps):
        grads = torch.autograd.grad(_ce(model(x), y), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)


def _device_batch(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def reptile_train(model: torch.nn.Module, images: np.ndarray, labels: np.ndarray, *,
                  n_way: int = 4, k_shot: int = 5, q_queries: int = 5,
                  meta_steps: int = 100, meta_batch: int = 4,
                  inner_steps: int = 5, inner_lr: float = 0.05,
                  meta_lr: float = 0.5, meta_lr_final: float = 0.05,
                  seed: int = 0, log_every: int = 0
                  ) -> Tuple[torch.nn.Module, Dict[str, list]]:
    """Reptile meta-training of ``model``'s parameters, in place on its
    device: parameters that adapt fast to unseen classes.

    Each meta-step samples ``meta_batch`` episodes (numpy ``rng`` seeded
    ``seed``), runs ``inner_steps`` of SGD per episode from the meta
    parameters, and moves them toward the mean adapted parameters:
    theta += eps * (mean(phi) - theta), eps linearly annealed from
    ``meta_lr`` to ``meta_lr_final``. Returns ``(model, history)``, the
    history holding each meta-step's query accuracy of the adapted models
    (the few-shot metric) and eps.
    """
    _check_pure_params(model)
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    rng = np.random.default_rng(seed)
    was_training = model.training
    model.eval()
    history: Dict[str, list] = {"query_accuracy": [], "meta_lr": []}
    for t in range(meta_steps):
        sx, sy, qx, qy = (_device_batch(a, device) for a in sample_episodes(
            images, labels, n_way=n_way, k_shot=k_shot, q_queries=q_queries,
            n_episodes=meta_batch, rng=rng))
        frac = t / max(meta_steps - 1, 1)
        eps = meta_lr + (meta_lr_final - meta_lr) * frac
        theta = [p.detach().clone() for p in params]
        adapted_sum = [torch.zeros_like(p) for p in params]
        correct = torch.zeros((), dtype=torch.int64, device=device)
        for e in range(meta_batch):
            with torch.no_grad():
                for p, t0 in zip(params, theta):
                    p.copy_(t0)
            _inner_sgd(model, sx[e], sy[e], inner_steps, inner_lr)
            with torch.no_grad():
                for s, p in zip(adapted_sum, params):
                    s.add_(p)
                correct += (model(qx[e]).argmax(-1) == qy[e].long()).sum()
        with torch.no_grad():
            for p, t0, s in zip(params, theta, adapted_sum):
                p.copy_(t0 + eps * (s / meta_batch - t0))
        history["query_accuracy"].append(float(correct) / qy.numel())
        history["meta_lr"].append(float(eps))
        if log_every and (t + 1) % log_every == 0:
            _logger.info("reptile %d/%d: adapted query acc %.3f", t + 1, meta_steps,
                         history["query_accuracy"][-1])
    model.train(was_training)
    return model, history


def adapt(model: torch.nn.Module, support_x, support_y, *, steps: int = 10,
          lr: float = 0.05) -> torch.nn.Module:
    """Few-shot adaptation: a copy of ``model`` (on its device) fine-tuned
    by ``steps`` SGD steps on one episode's support set; ``model`` is left
    as it was."""
    _check_pure_params(model)
    device = next(model.parameters()).device
    adapted = copy.deepcopy(model).eval()
    _inner_sgd(adapted, _device_batch(support_x, device), _device_batch(support_y, device),
               steps, lr)
    return adapted


def episode_accuracy(model: torch.nn.Module, query_x, query_y) -> float:
    """Query-set accuracy of an (adapted) model on one episode, in eval mode."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    with torch.no_grad():
        pred = model(_device_batch(query_x, device)).argmax(-1).cpu().numpy()
    model.train(was_training)
    return float(np.mean(pred == np.asarray(query_y)))

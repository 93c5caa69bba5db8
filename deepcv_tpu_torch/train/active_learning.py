"""Uncertainty-driven active learning.

Counterpart of ``deepcv_tpu/train/active_learning.py`` (the five
acquisitions, ``mc_class_probabilities``, ``active_learning_loop``):
pool-based active learning. A labeled pool plays the unlabeled corpus; the
loop starts from a small seeded labeled subset, trains, scores the rest of
the pool with an MC-dropout acquisition, reveals the labels of the top-k
and repeats, recording every round's validation metrics.

The acquisitions are the JAX package's numpy reductions over the
(samples, pool, classes) stack, so the same stack and ``rng`` give the same
scores. Scoring runs the model in training mode (dropout live) on the
model's device, the K2 convs among its ops, with every buffer restored
afterwards (the JAX package discards the batch-statistics update). A ragged
last chunk is padded by tiling its last real row, as the JAX scorer does,
so that train-mode batch statistics see a full chunk of real rows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from deepcv_tpu_torch.data.preprocess import PreprocessedDataset
from deepcv_tpu_torch.ops.moe import MoEMlp
from deepcv_tpu_torch.ops.nn import Dropout
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.training import train

__all__ = ["ACQUISITION_FNS", "register_acquisition", "acquisition_scores",
           "mc_class_probabilities", "active_learning_loop"]

_EPS = 1e-12

ACQUISITION_FNS: Dict[str, Callable] = {}


def register_acquisition(name: str):
    """Register ``fn(probs: (S, N, C) ndarray, rng) -> (N,) scores``
    (higher = more informative = acquired first)."""
    def dec(fn):
        ACQUISITION_FNS[name] = fn
        return fn
    return dec


def _entropy(p: np.ndarray) -> np.ndarray:
    return -np.sum(p * np.log(p + _EPS), axis=-1)


@register_acquisition("entropy")
def _acq_entropy(probs: np.ndarray, rng) -> np.ndarray:
    """Predictive entropy H[E_s p_s]: total uncertainty."""
    return _entropy(probs.mean(axis=0))


@register_acquisition("bald")
def _acq_bald(probs: np.ndarray, rng) -> np.ndarray:
    """BALD mutual information H[E_s p_s] - E_s H[p_s] (Houlsby et al.,
    arXiv:1112.5745): epistemic uncertainty only, so 0 everywhere for a
    model without dropout."""
    return _entropy(probs.mean(axis=0)) - _entropy(probs).mean(axis=0)


@register_acquisition("margin")
def _acq_margin(probs: np.ndarray, rng) -> np.ndarray:
    """1 - (top1 - top2) of the mean prediction: boundary proximity."""
    top2 = np.sort(probs.mean(axis=0), axis=-1)[..., -2:]
    return 1.0 - (top2[..., 1] - top2[..., 0])


@register_acquisition("variation_ratio")
def _acq_variation_ratio(probs: np.ndarray, rng) -> np.ndarray:
    """1 - max_c E_s p_s: the confidence's complement."""
    return 1.0 - probs.mean(axis=0).max(axis=-1)


@register_acquisition("random")
def _acq_random(probs: np.ndarray, rng) -> np.ndarray:
    """Uniform random scores: the control arm."""
    return rng.random(probs.shape[1])


def acquisition_scores(probs: np.ndarray, acquisition: str,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Score a pool from its MC probability stack ``(S, N, C)``."""
    if acquisition not in ACQUISITION_FNS:
        raise ValueError(f"unknown acquisition {acquisition!r} "
                         f"(have {sorted(ACQUISITION_FNS)})")
    return np.asarray(ACQUISITION_FNS[acquisition](
        np.asarray(probs), rng or np.random.default_rng(0)))


def mc_class_probabilities(model: torch.nn.Module, pool, indices: np.ndarray, *,
                           n_samples: int = 8, batch_size: int = 64,
                           seed: int = 0) -> np.ndarray:
    """MC-dropout class probabilities over ``pool.dataset.images[indices]``:
    ``(n_samples, len(indices), n_classes)`` float32.

    Each chunk of ``batch_size`` raw images goes through
    ``pool.batch_transform`` (no augmentation), the model in training mode
    on its device and a float32 softmax. Sample ``s`` draws its dropout from
    its own generator on the model's device, seeded ``seed * 1000 + s`` (the
    JAX package's key for it). Buffers (batch norm's running statistics) are
    restored afterwards, and the model is left in the mode it was in.
    """
    device = next(model.parameters()).device
    images = pool.dataset.images
    n = len(indices)
    bs = min(batch_size, max(1, n))
    drawers = [m for m in model.modules() if isinstance(m, (Dropout, MoEMlp))]
    generators = [m.generator for m in drawers]
    buffers = {k: b.detach().clone() for k, b in model.named_buffers()}
    was_training = model.training
    samples = []
    try:
        model.train()
        with torch.no_grad():
            for s in range(n_samples):
                gen = torch.Generator(device=device).manual_seed(seed * 1000 + s)
                for m in drawers:
                    m.generator = gen
                outs = []
                for start in range(0, n, bs):
                    raw = np.stack([np.asarray(images[i]) for i in indices[start:start + bs]])
                    real = len(raw)
                    if real < bs:
                        # tile the last real row: zero rows would skew the
                        # train-mode batch statistics of the real ones
                        raw = np.concatenate([raw, np.repeat(raw[-1:], bs - real, axis=0)])
                    x = pool.batch_transform(torch.from_numpy(raw).to(device), augment=False)
                    logits = model(x)
                    p = torch.softmax(logits.float(), dim=-1)
                    outs.append(p[:real].cpu().numpy())
                samples.append(np.concatenate(outs))
    finally:
        model.train(was_training)
        for m, g in zip(drawers, generators):
            m.generator = g
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(buffers[k])
    return np.stack(samples)


def _labeled_view(pool, indices: np.ndarray, name: str):
    """A PreprocessedDataset over a pool index subset, sharing the pool's
    fitted transforms (normalization statistics stay those of the whole
    pool: refitting per round would leak budget-dependent statistics)."""
    return PreprocessedDataset(pool.dataset.subset(np.asarray(indices), name=name),
                               transform=pool.transform, augmentation=pool.augmentation,
                               target_transform=pool.target_transform)


def active_learning_loop(input_shape, model_hp: Mapping[str, Any],
                         training_hp: Mapping[str, Any], losses,
                         datasets: Mapping[str, Any], *,
                         rounds: int = 4, acquire_per_round: int = 16,
                         init_labeled=16, acquisition: str = "bald",
                         n_mc: int = 8, metric: str = "valid_accuracy",
                         backend_conf=None, metrics=None, seed: int = 0,
                         score_batch_size: int = 64, device=None) -> Dict[str, Any]:
    """Pool-based active learning: (train -> score the pool -> acquire) x
    ``rounds``, on ``device`` (CUDA unless given).

    ``datasets``: ``{'poolset': PreprocessedDataset, 'validset': ...}``; the
    pool's labels stay hidden until acquisition reveals them.
    ``init_labeled``: an int (a seeded uniform draw) or an index array.
    Each round trains a new model from the same seeded init (its generator
    seeded ``seed``) on the labeled set, with the training hp's ``seed``
    defaulting to ``seed``: accuracy changes reflect the data acquired.

    Returns ``{'rounds': [{'round', 'n_labeled', metrics..., 'acquired'}],
    'labeled_indices', 'model', 'state', 'history', 'final'}``, where
    ``acquired`` is the index batch selected after that round's training.
    """
    if acquisition not in ACQUISITION_FNS:   # fail before the first training
        raise ValueError(f"unknown acquisition {acquisition!r} "
                         f"(have {sorted(ACQUISITION_FNS)})")
    pool = datasets["poolset"]
    validset = datasets["validset"]
    rng = np.random.default_rng(seed)
    n_pool = len(pool)
    if isinstance(init_labeled, (int, np.integer)):
        labeled = rng.choice(n_pool, size=min(int(init_labeled), n_pool), replace=False)
    else:
        labeled = np.unique(np.asarray(init_labeled, dtype=np.int64))
    labeled = np.sort(labeled)

    out_rounds = []
    model = state = history = None
    for r in range(int(rounds)):
        model = DeepcvModule(input_shape, model_hp, device=device,
                             generator=torch.Generator().manual_seed(seed))
        hp = dict(training_hp)
        hp.setdefault("save_every_iters", 0)
        if hp.get("output_path"):
            hp["output_path"] = f"{hp['output_path']}/al_round_{r}"
        hp.setdefault("seed", seed)
        state, history = train(
            hp, model, losses,
            {"trainset": _labeled_view(pool, labeled, f"al_labeled_r{r}"),
             "validset": validset},
            backend_conf=backend_conf, metrics=metrics)
        entry = {"round": r, "n_labeled": int(len(labeled)), "acquired": []}
        if history.get("valid"):
            entry.update({k: v for k, v in history["valid"][-1].items() if k != "epoch"})
        remaining = np.setdiff1d(np.arange(n_pool), labeled)
        if r < rounds - 1 and len(remaining) and acquire_per_round > 0:
            probs = mc_class_probabilities(model, pool, remaining, n_samples=int(n_mc),
                                           batch_size=score_batch_size, seed=seed + r)
            scores = acquisition_scores(probs, acquisition, rng)
            k = min(int(acquire_per_round), len(remaining))
            picked = remaining[np.argsort(scores)[::-1][:k]]
            entry["acquired"] = [int(i) for i in picked]
            labeled = np.sort(np.concatenate([labeled, picked]))
        out_rounds.append(entry)
    return {"rounds": out_rounds, "labeled_indices": labeled,
            "model": model, "state": state, "history": history,
            "final": {metric: out_rounds[-1].get(metric)}}

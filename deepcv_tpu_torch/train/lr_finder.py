"""Learning-rate range test (the fastai-style LR finder).

Counterpart of ``deepcv_tpu/train/lr_finder.py`` (``run_lr_range_test``,
``find_optimal_params``, ``plot_search_curves``): SGD with momentum 0.9 on
an exponential LR sweep from ``min_lr`` to ``max_lr`` over ``num_steps``
steps, an exponentially smoothed (bias-corrected) loss, and a stop when the
loss is not finite or the smoothed loss passes ``divergence_factor`` times
its best; the suggestion is the LR of the steepest descent of the smoothed
loss, for the one-cycle policy.
"""
from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from deepcv_tpu_torch.data.pipeline import BatchIterator
from deepcv_tpu_torch.data.preprocess import PreprocessedDataset
from deepcv_tpu_torch.train.losses import WeightedLosses

__all__ = ["run_lr_range_test", "find_optimal_params", "plot_search_curves"]

_logger = logging.getLogger(__name__)


def run_lr_range_test(model, losses, trainset, batch_size: int = 64,
                      min_lr: float = 1e-7, max_lr: float = 10.0,
                      num_steps: int = 100, smoothing: float = 0.98,
                      divergence_factor: float = 4.0, seed: int = 0) -> Dict[str, Any]:
    """Sweep the LR on ``model`` (trained in training mode on the device its
    parameters live on, batches in the JAX package's order, each
    transformed with a generator keyed by (seed, step)); the model's
    parameters and buffers are restored afterwards. Returns {'lrs',
    'losses', 'smoothed', 'best_lr', 'suggested': {'base_lr', 'max_lr'}}."""
    from deepcv_tpu_torch.train.training import _device_targets, step_generator

    if not isinstance(losses, WeightedLosses):
        losses = WeightedLosses(losses)
    ds = trainset if isinstance(trainset, PreprocessedDataset) else PreprocessedDataset(trainset)
    device = next(model.parameters()).device
    kept = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gamma = (max_lr / min_lr) ** (1.0 / max(1, num_steps - 1))

    def lr_at(count: int) -> float:
        return min_lr * gamma ** count

    opt = torch.optim.SGD(model.parameters(), lr=lr_at(0), momentum=0.9)
    it = BatchIterator(ds, batch_size, shuffle=True, seed=seed)
    lrs, raw, smoothed = [], [], []
    avg, best = 0.0, float("inf")
    i = 0
    model.train()
    try:
        while i < num_steps:
            for x, y in it.epoch(i // max(1, len(it))):
                if i >= num_steps:
                    break
                xb = ds.batch_transform(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                                        generator=step_generator(seed, i, device))
                yb = ds.transform_targets(_device_targets(y, device))
                main, _ = losses(model(xb), yb)
                opt.zero_grad(set_to_none=True)
                main.backward()
                for group in opt.param_groups:
                    group["lr"] = lr_at(i)
                opt.step()
                lv = float(main.detach())
                lrs.append(lr_at(i))
                raw.append(lv)
                avg = smoothing * avg + (1 - smoothing) * lv
                sm = avg / (1 - smoothing ** (i + 1))
                smoothed.append(sm)
                best = min(best, sm)
                i += 1
                if not math.isfinite(lv) or sm > divergence_factor * best:
                    _logger.info("LR range test diverged at lr=%.2e (step %d)", lrs[-1], i)
                    i = num_steps
                    break
    finally:
        model.load_state_dict(kept)
    out = {"lrs": lrs, "losses": raw, "smoothed": smoothed}
    out.update(find_optimal_params(lrs, smoothed))
    return out


def find_optimal_params(lrs: Sequence[float], smoothed: Sequence[float]) -> Dict[str, Any]:
    """The steepest-descent LR of the smoothed loss and the one-cycle
    (base_lr, max_lr) it suggests."""
    lrs = np.asarray(lrs)
    sm = np.asarray(smoothed)
    if len(lrs) < 5:
        return {"best_lr": float(lrs[-1]) if len(lrs) else 1e-3,
                "suggested": {"base_lr": 1e-4, "max_lr": 1e-3}}
    grad = np.gradient(sm, np.log10(np.maximum(lrs, 1e-12)))
    lo = max(1, len(lrs) // 20)
    steepest = int(np.argmin(grad[lo:len(lrs) - 1])) + lo
    best_lr = float(lrs[steepest])
    return {"best_lr": best_lr, "suggested": {"base_lr": best_lr / 25.0, "max_lr": best_lr}}


def plot_search_curves(result: Mapping[str, Any], path="lr_range_test.png"):
    """Save the LR-against-loss curve: a PNG with matplotlib, else a CSV of
    (lr, loss, smoothed) beside ``path``. Returns the file written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        csv = path.with_suffix(".csv")
        with csv.open("w") as f:
            f.write("lr,loss,smoothed\n")
            for lr, loss, sm in zip(result["lrs"], result["losses"], result["smoothed"]):
                f.write(f"{lr},{loss},{sm}\n")
        return csv
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(result["lrs"], result["smoothed"], label="smoothed loss")
    ax.set_xscale("log")
    ax.axvline(result["best_lr"], color="r", ls="--", label=f"best lr {result['best_lr']:.2e}")
    ax.set_xlabel("learning rate")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path

"""Notebook helpers: a batch of images as a grid, a training history as
curves, a model's summary.

Counterpart of ``deepcv_tpu/notebook.py`` (``show_batch``,
``plot_history``, ``model_summary``). The plots return the matplotlib
``Figure``, so they work headless (scripts, tests) and inline in a notebook;
matplotlib is imported at the first plot, not with this module (a machine
without it can still import the package). Tensors on any device are read
back to the host.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

__all__ = ["show_batch", "plot_history", "model_summary"]


def _plt():
    import os

    import matplotlib
    try:
        from IPython import get_ipython
        interactive = get_ipython() is not None
    except Exception:
        interactive = False
    if not interactive and not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")            # headless scripts/tests/CI
    import matplotlib.pyplot as plt
    return plt


def show_batch(images, labels: Optional[Sequence[Any]] = None,
               classes: Optional[Sequence[str]] = None, n_cols: int = 8,
               mean: Optional[Sequence[float]] = None,
               std: Optional[Sequence[float]] = None,
               title: Optional[str] = None):
    """Grid-plot a batch of (N, H, W, C) images (normalized or uint8);
    optional per-image labels (ints resolved through ``classes``)."""
    from deepcv_tpu_torch.data.viz import to_uint8

    imgs = to_uint8(images, mean=mean, std=std)
    n = imgs.shape[0]
    n_cols = max(1, min(int(n_cols), n))
    n_rows = (n + n_cols - 1) // n_cols
    plt = _plt()
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(1.6 * n_cols, 1.8 * n_rows),
                             squeeze=False)
    for i in range(n_rows * n_cols):
        ax = axes[i // n_cols][i % n_cols]
        ax.axis("off")
        if i >= n:
            continue
        ax.imshow(imgs[i] if imgs.shape[-1] != 1 else imgs[i, ..., 0],
                  cmap=None if imgs.shape[-1] != 1 else "gray")
        if labels is not None:
            lab = labels[i]
            if classes is not None and not isinstance(lab, str):
                lab = classes[int(lab)]
            ax.set_title(str(lab), fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def plot_history(history: Mapping[str, Any],
                 metrics: Optional[Sequence[str]] = None):
    """Plot a ``train()`` history dict: train-loss curve over steps plus
    every validation metric over epochs (or only the named ``metrics``)."""
    train_rows = list(history.get("train") or [])
    valid_rows = list(history.get("valid") or [])
    val_keys = [k for k in (valid_rows[-1] if valid_rows else {})
                if k != "epoch" and (metrics is None or k in metrics
                                     or k.replace("valid_", "") in metrics)]
    plt = _plt()
    n_panels = 1 + (1 if val_keys else 0)
    fig, axes = plt.subplots(1, n_panels, figsize=(5.5 * n_panels, 3.6),
                             squeeze=False)
    ax = axes[0][0]
    if train_rows:
        loss_key = "loss" if "loss" in train_rows[-1] else \
            next(iter(k for k in train_rows[-1] if k != "step"), None)
        if loss_key:
            ax.plot([r["step"] for r in train_rows],
                    [r[loss_key] for r in train_rows], lw=1.2)
            ax.set_ylabel(loss_key)
    ax.set_xlabel("step")
    ax.set_title("training")
    ax.grid(True, alpha=0.3)
    if val_keys:
        ax = axes[0][1]
        for k in val_keys:
            ax.plot([r["epoch"] for r in valid_rows],
                    [r[k] for r in valid_rows], marker="o", ms=3, label=k)
        ax.set_xlabel("epoch")
        ax.set_title("validation")
        ax.legend(fontsize=8)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return fig


def model_summary(model) -> str:
    """The model's per-submodule shape/capacity table as a string; also
    rendered as monospace when a notebook display hook is active."""
    text = str(model.describe() if hasattr(model, "describe") else model)
    try:  # pretty inline rendering when running under IPython
        from IPython import get_ipython
        from IPython.display import HTML, display
        if get_ipython() is not None:
            import html
            display(HTML(f"<pre>{html.escape(text)}</pre>"))
    except Exception:
        pass
    return text

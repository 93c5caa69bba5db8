"""Dataset and prediction visualisation on the host: a batch as an image
grid (numpy), saved as a PNG or returned for a logger's ``add_image``.

Counterpart of ``deepcv_tpu/data/viz.py`` (``to_uint8``, ``make_grid``,
``save_image_grid``). A tensor (on any device) is read back to the host
first. :func:`save_image_grid` needs PIL, as in the JAX package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["to_uint8", "make_grid", "save_image_grid"]


def _host(images) -> np.ndarray:
    if isinstance(images, torch.Tensor):
        return images.detach().float().cpu().numpy()
    return np.asarray(images, np.float32)


def to_uint8(images, mean: Optional[Sequence[float]] = None,
             std: Optional[Sequence[float]] = None) -> np.ndarray:
    """A float NHWC batch (normalised with ``mean`` and ``std`` when given;
    in [0, 1], or in [0, 255] when its maximum passes 1.5) -> uint8 NHWC."""
    x = _host(images)
    if mean is not None and std is not None:
        x = x * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    x = np.clip(x, 0.0, 1.0) if x.max() <= 1.5 else np.clip(x / 255.0, 0, 1)
    return (x * 255.0 + 0.5).astype(np.uint8)


def make_grid(images, n_cols: int = 8, padding: int = 2, pad_value: int = 255) -> np.ndarray:
    """Tile an NHWC batch into one (H', W', C) uint8 grid image."""
    imgs = to_uint8(images)
    n, h, w, c = imgs.shape
    n_cols = min(n_cols, n)
    n_rows = -(-n // n_cols)
    grid = np.full((n_rows * (h + padding) + padding, n_cols * (w + padding) + padding, c),
                   pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, n_cols)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = imgs[i]
    return grid


def save_image_grid(images, path: Union[str, Path], n_cols: int = 8,
                    labels: Optional[Sequence] = None) -> Path:
    """Save a thumbnail grid as a PNG (PIL), each image's label drawn in red
    at its top left; returns the path."""
    from PIL import Image, ImageDraw

    grid = make_grid(images, n_cols=n_cols)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    img = Image.fromarray(grid)
    if labels is not None:
        draw = ImageDraw.Draw(img)
        shape = _host(images).shape
        n, h, w = len(labels), shape[1], shape[2]
        for i, lab in enumerate(labels):
            r, col = divmod(i, min(n_cols, n))
            draw.text((2 + col * (w + 2) + 2, 2 + r * (h + 2)), str(lab), fill=(255, 0, 0))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path)
    return path

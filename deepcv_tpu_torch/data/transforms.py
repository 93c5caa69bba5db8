"""Deterministic image transforms on NHWC tensors.

Counterpart of ``deepcv_tpu/data/transforms.py`` (``to_tensor``,
``normalize``). Layout stays the JAX package's: channels last. They run on
whatever device the tensor lies on, so serving preprocesses on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from deepcv_tpu_torch.utils import register

__all__ = ["to_tensor", "normalize"]


def to_tensor(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (torchvision ToTensor values); a
    floating tensor is only cast to float32."""
    if x.is_floating_point():
        return x.to(torch.float32)
    return x.to(torch.float32) / 255.0


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Per-channel standardization over the last (channel) dim."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


register("to_tensor", to_tensor)
register("normalize", normalize)

"""Image transforms on NHWC batches.

Counterpart of ``deepcv_tpu/data/transforms.py``: ``to_tensor``,
``normalize`` and the photometric subset (``rgb_to_grayscale``,
``adjust_gamma``, ``adjust_brightness``, ``adjust_contrast``,
``adjust_saturation`` and ``gaussian_noise``), registered under the JAX
package's names and aliases. Layout stays the JAX package's: channels last.
They run on whatever device the tensor lies on, so serving and training
preprocess on the card.

Images are float tensors in [0, 1]; a factor is a Python number or a
per-image (N,) tensor. The photometric adjustments follow PIL's
``ImageEnhance``: ``out = degenerate + factor * (img - degenerate)``,
clipped to [0, 1].

Every quotient is an IEEE division on every device (:func:`_true_div`) and
the contrast mean is computed in integers, so the chain rounds the same way
on the CPU and on the card; the fused augment kernel (K1,
``ops/kernels/fused_augment.py``) repeats exactly this arithmetic.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from deepcv_tpu_torch.utils import register

__all__ = ["to_tensor", "normalize", "rgb_to_grayscale", "adjust_gamma",
           "adjust_brightness", "adjust_contrast", "adjust_saturation",
           "gaussian_noise"]

Factor = Union[float, torch.Tensor]


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device. PyTorch's CUDA kernels
    multiply by the float32 reciprocal of a host scalar instead, which moves
    some quotients by one ulp; a 0-d tensor on ``x``'s device divides."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _per_image(factor: Factor, x: torch.Tensor):
    """A scalar stays a scalar; a (N,) tensor becomes (N, 1, ..., 1)."""
    if not isinstance(factor, torch.Tensor):
        return float(factor)
    factor = factor.to(dtype=x.dtype, device=x.device)
    if factor.dim() == 1:
        factor = factor.reshape((-1,) + (1,) * (x.dim() - 1))
    return factor


def to_tensor(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (torchvision ToTensor values); a
    floating tensor is only cast to float32."""
    if x.is_floating_point():
        return x.to(torch.float32)
    return _true_div(x.to(torch.float32), 255.0)


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Per-channel standardization over the last (channel) dim."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def rgb_to_grayscale(x: torch.Tensor, keep_channels: bool = True) -> torch.Tensor:
    """ITU-R 601-2 luma (PIL ``convert('L')`` weights). 1- and 2-channel
    images are already 'L', so they pass through; 4+-channel images take
    the luma of their first three channels."""
    if x.shape[-1] < 3:
        g = x[..., :1]
    else:
        g = (x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114)[..., None]
    return g.expand(x.shape) if keep_channels else g


def adjust_gamma(x: torch.Tensor, gamma: Factor, gain: float = 1.0) -> torch.Tensor:
    return torch.clamp(gain * torch.clamp(x, 0.0, 1.0) ** _per_image(gamma, x), 0.0, 1.0)


def _blend(a: torch.Tensor, b: torch.Tensor, factor: Factor) -> torch.Tensor:
    """PIL ``Image.blend``: ``b + factor * (a - b)``, clipped to [0, 1]."""
    return torch.clamp(b + _per_image(factor, a) * (a - b), 0.0, 1.0)


def adjust_brightness(x: torch.Tensor, factor: Factor) -> torch.Tensor:
    """PIL ``ImageEnhance.Brightness``: blend with black."""
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x: torch.Tensor, factor: Factor) -> torch.Tensor:
    """PIL ``ImageEnhance.Contrast``: blend with the image's mean grey.

    PIL takes the mean of the uint8 'L' image, ``(R*299 + G*587 + B*114) //
    1000`` for RGB (the first channel otherwise), rounded half up. Both are
    integer arithmetic here, so the grey level is exact on every device:
    ``(2 * sum + HW) // (2 * HW)`` is ``floor(mean + 0.5)``.
    """
    q = torch.round(x * 255.0).to(torch.int32)
    if x.shape[-1] == 3:
        luma = (q[..., 0] * 299 + q[..., 1] * 587 + q[..., 2] * 114) // 1000
    else:
        luma = q[..., 0]
    hw = luma.shape[1] * luma.shape[2]
    total = luma.sum(dim=(1, 2), dtype=torch.int64)
    grey = (2 * total + hw) // (2 * hw)
    grey = _true_div(grey.to(x.dtype), 255.0).reshape((-1,) + (1,) * (x.dim() - 1))
    return _blend(x, grey, factor)


def adjust_saturation(x: torch.Tensor, factor: Factor) -> torch.Tensor:
    """PIL ``ImageEnhance.Color``: blend with the grayscale image."""
    return _blend(x, rgb_to_grayscale(x, keep_channels=True), factor)


def gaussian_noise(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   sigma: Factor = 0.1) -> torch.Tensor:
    """Add ``sigma * N(0, 1)`` noise drawn from ``generator`` (on ``x``'s
    device), clipped to [0, 1]."""
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return torch.clamp(x + _per_image(sigma, x) * noise, 0.0, 1.0)


register("to_tensor", to_tensor)
register("normalize", normalize)
register("rgb_to_grayscale", rgb_to_grayscale, aliases=("grayscale",))
register("adjust_gamma", adjust_gamma, aliases=("gamma",))
register("adjust_brightness", adjust_brightness)
register("adjust_contrast", adjust_contrast)
register("adjust_saturation", adjust_saturation, aliases=("adjust_color", "tweak_colors"))
register("gaussian_noise", gaussian_noise, aliases=("noise",))

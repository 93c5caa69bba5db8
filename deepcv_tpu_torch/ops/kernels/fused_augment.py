"""K1, fused augment + normalize: wrapper and plain version.

Counterpart of ``deepcv_tpu/ops/pallas/fused_augment.py`` (the TPU kernel
``_kernel``, reached through ``fused_augment_normalize``). The CUDA source
is ``deepcv_tpu_torch/csrc/fused_augment.cu``; its header note says what
bounds it on an H100 and what this design does about it.

On a uint8 NHWC batch with three channels and per-image (N,) factors it
computes ``to_tensor -> adjust_brightness -> adjust_contrast ->
adjust_saturation -> adjust_gamma -> [gaussian_noise] -> normalize`` of
``deepcv_tpu_torch/data/transforms.py``. A neutral factor (1, 1, 1, 1 and
sigma 0) makes its step the identity up to float rounding, which is how a
recipe's per-image gates reach the kernel.

The kernel is one launch whose work unit follows H*W: one warp an image,
eight images a block, for images of at most 1,024 pixels (32x32), one block
an image above that. Each image reads its bytes once into shared memory
(the warp plan), builds per-image byte tables of everything up to the
contrast blend, exact to the bit, and writes whole pixels a lane through a
shared-memory stage as coalesced 16-byte stores. After the grey level the
power is ``ex2(g * lg2(y))`` and the normalize one FMA, within 1e-5 of the
plain version. Its noise is Philox4x32-10 keyed by (seed, image, element),
so a seed gives the same noise whatever the plan.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or raises);
a CPU tensor takes :func:`plain_fused_augment_normalize`. The input is
data, so there is no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from deepcv_tpu_torch.data import transforms as T

__all__ = ["plain_fused_augment_normalize", "fused_augment_normalize"]

_KERNEL = "fused_augment"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FACTORS = ("brightness", "contrast", "saturation", "gamma")
#: the C launcher's parameters: x, the four factors, sigma, seed, out; n,
#: hw; mean and std; dtype; the stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6
             + [ctypes.c_int, ctypes.c_void_p])

Seed = Union[int, torch.Tensor]


def plain_fused_augment_normalize(images_u8: torch.Tensor, brightness: torch.Tensor,
                                  contrast: torch.Tensor, saturation: torch.Tensor,
                                  gamma: torch.Tensor, noise_sigma: Optional[torch.Tensor],
                                  mean: Sequence[float], std: Sequence[float],
                                  seed: Seed = 0, out_dtype=torch.float32) -> torch.Tensor:
    """The port's eager chain. Its noise comes from a ``torch.Generator``
    seeded with ``seed``, not from the kernel's Philox streams, so only the
    noise statistics compare between the two."""
    x = T.adjust_brightness(T.to_tensor(images_u8), brightness)
    x = T.adjust_contrast(x, contrast)
    x = T.adjust_saturation(x, saturation)
    x = T.adjust_gamma(x, gamma)
    if noise_sigma is not None:
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        x = T.gaussian_noise(x, gen, sigma=noise_sigma)
    return T.normalize(x, mean, std).to(out_dtype)


def _check(images_u8, factors, noise_sigma, mean, std, seed, out_dtype):
    if images_u8.dim() != 4 or images_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 NHWC images, got {images_u8.dtype} "
                        f"{tuple(images_u8.shape)}")
    n, h, w, c = images_u8.shape
    if c != 3:
        raise ValueError(f"the kernel takes 3-channel images, got {c} channels")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("mean and std need one value per channel (3)")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not supported (float32 or bfloat16)")
    for name, f in (*zip(_FACTORS, factors), ("noise_sigma", noise_sigma)):
        if f is None:
            continue
        if tuple(f.shape) != (n,) or f.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), got {f.dtype} "
                             f"{tuple(f.shape)}")
        if f.device != images_u8.device:
            raise ValueError(f"{name} on {f.device}, images on {images_u8.device}")
    if isinstance(seed, torch.Tensor) and (seed.numel() != 1 or seed.dtype != torch.int64):
        raise ValueError(f"seed must be an int or one int64, got {seed.dtype} "
                         f"{tuple(seed.shape)}")


def _launcher():
    """The kernel's C launcher, built and loaded on first use."""
    from deepcv_tpu_torch.ops.kernels import _build

    fn = _build.load(_KERNEL).fused_augment_normalize_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _run_kernel(images_u8, factors, noise_sigma, mean, std, seed, out_dtype):
    n, h, w, _ = images_u8.shape
    dev = images_u8.device
    out = torch.empty((n, h, w, 3), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    x = images_u8.contiguous()
    factors = [f.contiguous() for f in factors]
    if noise_sigma is not None:
        noise_sigma = noise_sigma.contiguous()
        if not isinstance(seed, torch.Tensor):
            seed = torch.tensor([int(seed)], dtype=torch.int64)
        seed = seed.reshape(1).to(dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), *(f.data_ptr() for f in factors),
                 None if noise_sigma is None else noise_sigma.data_ptr(),
                 None if noise_sigma is None else seed.data_ptr(),
                 out.data_ptr(), n, h * w, *(float(m) for m in mean),
                 *(float(s) for s in std), _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err} "
                           f"(images {tuple(images_u8.shape)})")
    fused_augment_normalize.launches += 1
    return out


def fused_augment_normalize(images_u8: torch.Tensor, brightness: torch.Tensor,
                            contrast: torch.Tensor, saturation: torch.Tensor,
                            gamma: torch.Tensor, noise_sigma: Optional[torch.Tensor],
                            mean: Sequence[float], std: Sequence[float],
                            seed: Seed = 0, out_dtype=torch.float32) -> torch.Tensor:
    """Augment and normalize a uint8 (N, H, W, 3) batch with per-image (N,)
    float32 factors; ``noise_sigma`` None leaves the noise out. ``seed`` (an
    int, or one int64 on the images' device) keys the noise. On a CUDA
    tensor this launches the kernel and adds one to
    ``fused_augment_normalize.launches``; a failed launch raises."""
    factors = (brightness, contrast, saturation, gamma)
    _check(images_u8, factors, noise_sigma, mean, std, seed, out_dtype)
    if images_u8.device.type == "cuda":
        return _run_kernel(images_u8, factors, noise_sigma, mean, std, seed, out_dtype)
    if images_u8.device.type == "cpu":
        return plain_fused_augment_normalize(images_u8, *factors, noise_sigma, mean, std,
                                             seed, out_dtype)
    raise RuntimeError(f"no {_KERNEL} for device {images_u8.device}")


#: launches of the CUDA kernel in this process (the wrapper adds one per
#: successful launch and nowhere else)
fused_augment_normalize.launches = 0

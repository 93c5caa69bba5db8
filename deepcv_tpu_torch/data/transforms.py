"""Image transforms on NHWC batches.

Counterpart of ``deepcv_tpu/data/transforms.py``, whole: ``to_tensor``,
``normalize``, ``denormalize``, ``resize``, ``center_crop``, ``pad``, the
photometric adjustments (``rgb_to_grayscale``, ``adjust_gamma``,
``adjust_brightness``, ``adjust_contrast``, ``adjust_saturation``,
``adjust_hue``, ``color_jitter``, ``gaussian_noise``), the batched affine
warp and the random geometric transforms, each registered under the JAX
package's names and aliases (:data:`TRANSFORM_REGISTRY`), and
:class:`Compose`. Layout stays the JAX package's: channels last. They run
on whatever device the tensor lies on, so serving and training preprocess
on the card.

A random transform takes a ``torch.Generator`` on the batch's device and is
split in two: ``draw_*`` makes its per-image draws, and the application
(``rotate_matrices``, ``crop``, ``flip``, ...) takes them as arguments, so
the same draws give the same batch on every device.

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

import inspect
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from deepcv_tpu_torch.utils import register

__all__ = ["to_tensor", "normalize", "denormalize", "resize", "center_crop", "pad",
           "rgb_to_grayscale", "adjust_gamma", "adjust_brightness", "adjust_contrast",
           "adjust_saturation", "adjust_hue", "color_jitter", "gaussian_noise",
           "affine_transform", "center_affine", "random_rotate", "random_translate",
           "random_scale", "random_crop", "random_horizontal_flip",
           "random_vertical_flip", "uniform", "Compose", "TRANSFORM_REGISTRY"]

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


def uniform(shape, generator: torch.Generator, lo: float = 0.0, hi: float = 1.0
            ) -> torch.Tensor:
    """``lo + (hi - lo) * U[0, 1)`` on ``generator``'s device, float32."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device)


def denormalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Inverse of :func:`normalize`."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return x * std + mean


def _resize_kernel(method: str) -> Optional[Callable]:
    """``jax.image.resize``'s kernels by method name; None for nearest."""
    if method == "nearest":
        return None
    if method in ("linear", "bilinear", "trilinear", "triangle"):
        return lambda t: torch.clamp(1.0 - t.abs(), min=0.0)
    if method in ("cubic", "bicubic", "tricubic"):
        def keys_cubic(t):
            out = ((1.5 * t - 2.5) * t) * t + 1.0
            out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
            return torch.where(t >= 2.0, torch.zeros_like(t), out)
        return keys_cubic
    if method in ("lanczos3", "lanczos5"):
        radius = float(method[-1])

        def lanczos(t):
            y = radius * torch.sin(math.pi * t) * torch.sin(math.pi * t / radius)
            out = torch.where(t > 1e-3, y / torch.where(t != 0, math.pi ** 2 * t * t,
                                                        torch.ones_like(t)),
                              torch.ones_like(t))
            return torch.where(t > radius, torch.zeros_like(t), out)
        return lanczos
    raise ValueError(f'Unknown resize method "{method}"')


def _resize_weights(n_in: int, n_out: int, kernel: Callable, antialias: bool,
                    device) -> torch.Tensor:
    """The (n_in, n_out) weight matrix of ``jax.image.resize`` along one axis
    (``compute_weight_mat``: half-pixel centres, the kernel widened by the
    inverse scale when shrinking with ``antialias``, weights normalised over
    the input and zero where the sample falls outside it)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    t = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(t)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: Union[int, Tuple[int, int]], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """Resize an NHWC batch to ``size`` (an int is square), as
    ``jax.image.resize`` does: a separable weight matrix per resized axis
    (``linear``, ``cubic``, ``lanczos3``/``5``), or the floor of the
    scaled centre for ``nearest``; an axis of unchanged size is left as
    it is."""
    if isinstance(size, int):
        size = (size, size)
    kernel = _resize_kernel(method)
    x = x if x.is_floating_point() or kernel is None else x.to(torch.float32)
    for dim, n_out in ((1, int(size[0])), (2, int(size[1]))):
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        if kernel is None:
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32, device=x.device)
                               + 0.5) * n_in / n_out).long()
            x = x.index_select(dim, idx)
            continue
        w = _resize_weights(n_in, n_out, kernel, antialias, x.device).to(x.dtype)
        x = torch.einsum("nhwc,ho->nowc" if dim == 1 else "nhwc,wo->nhoc", x, w)
    return x


def center_crop(x: torch.Tensor, size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    if isinstance(size, int):
        size = (size, size)
    top = (x.shape[1] - size[0]) // 2
    left = (x.shape[2] - size[1]) // 2
    return x[:, top:top + size[0], left:left + size[1], :]


#: ``jnp.pad``'s modes by torch's names
_PAD_MODES = {"reflect": "reflect", "edge": "replicate", "wrap": "circular"}


def pad(x: torch.Tensor, padding: Union[int, Tuple[int, int]], mode: str = "constant",
        value: float = 0.0) -> torch.Tensor:
    """Pad the spatial dims by ``padding`` (an int, or (rows, cols)) on both
    sides, with ``jnp.pad``'s ``constant``, ``edge``, ``reflect`` or
    ``wrap``."""
    if isinstance(padding, int):
        padding = (padding, padding)
    ph, pw = int(padding[0]), int(padding[1])
    if mode == "constant":
        return torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph), value=float(value))
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode '{mode}' is not supported (constant, edge, reflect, wrap)")
    nchw = x.permute(0, 3, 1, 2)
    out = torch.nn.functional.pad(nchw, (pw, pw, ph, ph), mode=_PAD_MODES[mode])
    return out.permute(0, 2, 3, 1)


def adjust_hue(x: torch.Tensor, factor: Factor) -> torch.Tensor:
    """Shift the hue by ``factor`` turns (in [-0.5, 0.5]) through HSV, as
    the JAX package writes it (``% 6`` and ``% 1`` as floor modulo)."""
    if isinstance(factor, torch.Tensor):
        factor = factor.to(dtype=x.dtype, device=x.device)
        if factor.dim() == 1:
            factor = factor.reshape(-1, 1, 1)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn + 1e-12
    h = torch.where(mx == r, torch.remainder((g - b) / diff, 6.0),
                    torch.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0)) / 6.0
    s = torch.where(mx > 0, diff / (mx + 1e-12), torch.zeros_like(mx))
    v = mx
    h = torch.remainder(h + factor, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    sector = [i == k for k in range(6)]

    def select(values):
        out = torch.zeros_like(v)
        for cond, val in zip(reversed(sector), reversed(values)):
            out = torch.where(cond, val, out)
        return out

    return torch.stack([select([v, q, p, p, t, v]), select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], dim=-1)


def draw_color_jitter(n: int, generator: torch.Generator, brightness: float = 0.0,
                      contrast: float = 0.0, saturation: float = 0.0,
                      hue: float = 0.0) -> Dict[str, torch.Tensor]:
    """``color_jitter``'s per-image factors: in ``[max(0, 1 - v), 1 + v]``
    for each set adjustment, and in ``[-hue, hue]`` for the hue."""
    out = {}
    for name, v in (("brightness", brightness), ("contrast", contrast),
                    ("saturation", saturation)):
        if v:
            out[name] = uniform(n, generator, max(0.0, 1.0 - v), 1.0 + v)
    if hue:
        out["hue"] = uniform(n, generator, -hue, hue)
    return out


def apply_color_jitter(x: torch.Tensor, factors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """brightness -> contrast -> saturation -> hue, each where drawn."""
    for name, fn in (("brightness", adjust_brightness), ("contrast", adjust_contrast),
                     ("saturation", adjust_saturation), ("hue", adjust_hue)):
        if name in factors:
            x = fn(x, factors[name])
    return x


def color_jitter(x: torch.Tensor, generator: torch.Generator, brightness: float = 0.0,
                 contrast: float = 0.0, saturation: float = 0.0,
                 hue: float = 0.0) -> torch.Tensor:
    """torchvision ``ColorJitter`` in the JAX package's fixed order."""
    return apply_color_jitter(x, draw_color_jitter(len(x), generator, brightness, contrast,
                                                   saturation, hue))


# --------------------------------------------------------------------------- #
# Geometric transforms
# --------------------------------------------------------------------------- #

def affine_transform(x: torch.Tensor, matrices: torch.Tensor, order: int = 1,
                     cval: float = 0.0, pil_exact_u8: bool = False) -> torch.Tensor:
    """Warp an NHWC batch by per-image inverse affines ``matrices`` (N, 2, 3),
    with PIL's ``Image.transform(AFFINE, BILINEAR)`` rules as the JAX
    package writes them, as an explicit four-tap gather:

    * output pixel (i, j) samples the source at ``M @ (j + 0.5, i + 0.5, 1)``;
    * it is filled with ``cval`` iff that (unshifted) source centre falls
      outside ``[0, W) x [0, H)``;
    * else the four taps around ``src - 0.5`` are clamped to the image and
      combined by the lerps ``a + d * (b - a)``, along x then y.

    ``pil_exact_u8`` snaps the input to the uint8 grid and takes the floor
    of the result, as PIL's uint8 store truncates."""
    n, h, w, c = x.shape
    m = matrices.to(device=x.device, dtype=torch.float32)
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    px, py = (jj + 0.5).reshape(1, -1), (ii + 0.5).reshape(1, -1)
    src_x = m[:, 0, 0:1] * px + m[:, 0, 1:2] * py + m[:, 0, 2:3]      # (N, H*W)
    src_y = m[:, 1, 0:1] * px + m[:, 1, 1:2] * py + m[:, 1, 2:3]
    inside = (src_x >= 0) & (src_x < w) & (src_y >= 0) & (src_y < h)
    sx, sy = src_x - 0.5, src_y - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dx, dy = (sx - x0)[..., None], (sy - y0)[..., None]
    img = x.to(torch.float32)
    if pil_exact_u8:
        img = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0)
    flat = img.reshape(n, h * w, c)

    def tap(yi, xi):
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        return flat.gather(1, idx[..., None].expand(n, h * w, c))

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 + dx * (v01 - v00)
    bot = v10 + dx * (v11 - v10)
    out = top + dy * (bot - top)
    fill = cval * 255.0 if pil_exact_u8 else cval
    out = torch.where(inside[..., None], out, torch.full_like(out, fill))
    if pil_exact_u8:
        out = _true_div(torch.floor(out), 255.0)
    return out.reshape(n, h, w, c).to(x.dtype)


def center_affine(n: int, h: int, w: int, a, b, c, d, tx=None, ty=None,
                  device=None) -> torch.Tensor:
    """(N, 2, 3) inverse affines that rotate or shear about the image centre:
    ``x_src = a (x - cx) + b (y - cy) + cx + tx``, ``y_src = c (x - cx) +
    d (y - cy) + cy + ty``."""
    cx, cy = w / 2.0, h / 2.0

    def vec(v):
        v = torch.as_tensor(0.0 if v is None else v, dtype=torch.float32, device=device)
        return v.expand(n) if v.dim() == 0 else v.to(torch.float32)

    a, b, c, d, tx, ty = (vec(v) for v in (a, b, c, d, tx, ty))
    e = -a * cx - b * cy + cx + tx
    f = -c * cx - d * cy + cy + ty
    return torch.stack([torch.stack([a, b, e], -1), torch.stack([c, d, f], -1)], dim=1)


def rotate_matrices(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse affines of rotations by ``theta`` radians about the centre,
    PIL's counterclockwise convention."""
    cos, sin = torch.cos(theta), torch.sin(theta)
    return center_affine(len(theta), h, w, cos, -sin, sin, cos, device=theta.device)


def draw_rotate(n: int, generator: torch.Generator,
                degrees: Union[float, Tuple[float, float]]) -> torch.Tensor:
    """Per-image angles in radians, uniform in [-v, v] degrees (or the given
    range)."""
    if isinstance(degrees, (int, float)):
        lo, hi = -float(degrees), float(degrees)
    else:
        lo, hi = float(degrees[0]), float(degrees[1])
    return torch.deg2rad(uniform(n, generator, lo, hi))


def random_rotate(x: torch.Tensor, generator: torch.Generator,
                  degrees: Union[float, Tuple[float, float]],
                  distribution: str = "uniform") -> torch.Tensor:
    """Random rotation about the centre, per image; ``degrees`` v means
    [-v, v]."""
    if distribution != "uniform":
        raise ValueError(f"random_rotate: distribution '{distribution}' (only 'uniform')")
    theta = draw_rotate(len(x), generator, degrees)
    return affine_transform(x, rotate_matrices(theta, x.shape[1], x.shape[2]))


def draw_translate(n: int, generator: torch.Generator, max_frac: float, h: int, w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image shifts (tx, ty) in pixels, up to ``max_frac`` of each dim."""
    tx = uniform(n, generator, -max_frac, max_frac) * w
    ty = uniform(n, generator, -max_frac, max_frac) * h
    return tx, ty


def translate_matrices(tx: torch.Tensor, ty: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return center_affine(len(tx), h, w, 1.0, 0.0, 0.0, 1.0, tx=tx, ty=ty, device=tx.device)


def random_translate(x: torch.Tensor, generator: torch.Generator, max_frac: float
                     ) -> torch.Tensor:
    """Random per-image translation up to ``max_frac`` of each spatial dim."""
    n, h, w, _ = x.shape
    return affine_transform(x, translate_matrices(*draw_translate(n, generator, max_frac,
                                                                  h, w), h, w))


def scale_matrices(s: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse affines of isotropic zooms by ``s`` about the centre."""
    inv = 1.0 / s
    return center_affine(len(s), h, w, inv, 0.0, 0.0, inv, device=s.device)


def random_scale(x: torch.Tensor, generator: torch.Generator, max_frac: float
                 ) -> torch.Tensor:
    """Random per-image zoom in [1 - f, 1 + f] about the centre."""
    s = uniform(len(x), generator, 1.0 - max_frac, 1.0 + max_frac)
    return affine_transform(x, scale_matrices(s, x.shape[1], x.shape[2]))


def draw_crop(n: int, generator: torch.Generator, h: int, w: int,
              size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image (top, left) of a ``size`` window in an (h, w) image."""
    top = torch.randint(0, h - size[0] + 1, (n,), generator=generator,
                        device=generator.device)
    left = torch.randint(0, w - size[1] + 1, (n,), generator=generator,
                         device=generator.device)
    return top, left


def crop(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
         size: Tuple[int, int]) -> torch.Tensor:
    """Per-image windows of ``size`` at (top, left), as one gather."""
    n, h, w, c = x.shape
    rows = top.to(x.device)[:, None] + torch.arange(size[0], device=x.device)[None]
    cols = left.to(x.device)[:, None] + torch.arange(size[1], device=x.device)[None]
    idx = (rows[:, :, None] * w + cols[:, None, :]).reshape(n, -1)
    out = x.reshape(n, h * w, c).gather(1, idx[..., None].expand(n, idx.shape[1], c))
    return out.reshape(n, size[0], size[1], c)


def random_crop(x: torch.Tensor, generator: torch.Generator,
                size: Union[int, Tuple[int, int]], padding: int = 0) -> torch.Tensor:
    """Per-image random crop after optional zero padding (torchvision
    ``RandomCrop``)."""
    if isinstance(size, int):
        size = (size, size)
    if padding:
        x = pad(x, padding)
    top, left = draw_crop(len(x), generator, x.shape[1], x.shape[2], size)
    return crop(x, top, left, size)


def draw_flip(n: int, generator: torch.Generator, p: float = 0.5) -> torch.Tensor:
    """Per-image Bernoulli(p) flip decisions."""
    return uniform(n, generator) < p


def flip(x: torch.Tensor, chosen: torch.Tensor, dim: int) -> torch.Tensor:
    """Flip the images where ``chosen`` along ``dim`` (2: horizontal,
    1: vertical)."""
    return torch.where(chosen.to(x.device).reshape(-1, 1, 1, 1), x.flip(dim), x)


def random_horizontal_flip(x: torch.Tensor, generator: torch.Generator, p: float = 0.5
                           ) -> torch.Tensor:
    return flip(x, draw_flip(len(x), generator, p), 2)


def random_vertical_flip(x: torch.Tensor, generator: torch.Generator, p: float = 0.5
                         ) -> torch.Tensor:
    return flip(x, draw_flip(len(x), generator, p), 1)


# --------------------------------------------------------------------------- #
# Composition and the registry
# --------------------------------------------------------------------------- #

class Compose:
    """Apply ``(fn, kwargs)`` steps (or bare callables) in order to a batch;
    a random step (one whose signature takes ``generator``) draws from the
    generator given to the call, and raises without one."""

    def __init__(self, entries: Sequence[Any]):
        self.steps = []
        for e in entries:
            fn, kwargs = e if isinstance(e, tuple) else (e, {})
            random = "generator" in inspect.signature(fn).parameters
            self.steps.append((fn, dict(kwargs), random))

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        for fn, kwargs, random in self.steps:
            if random:
                if generator is None:
                    raise ValueError(f"Transform {fn.__name__} needs a torch.Generator; "
                                     "pass generator= to Compose.__call__")
                x = fn(x, generator, **kwargs)
            else:
                x = fn(x, **kwargs)
        return x

    def __repr__(self):
        return "Compose([" + ", ".join(getattr(f, "__name__", repr(f))
                                       for f, _, _ in self.steps) + "])"


#: the transforms by the JAX package's names and aliases
TRANSFORM_REGISTRY: Dict[str, Callable] = {}

for _name, _fn, _aliases in (
        ("to_tensor", to_tensor, ()), ("normalize", normalize, ()),
        ("denormalize", denormalize, ()), ("resize", resize, ()),
        ("center_crop", center_crop, ()), ("pad", pad, ()),
        ("rgb_to_grayscale", rgb_to_grayscale, ("grayscale",)),
        ("adjust_gamma", adjust_gamma, ("gamma",)),
        ("adjust_brightness", adjust_brightness, ()),
        ("adjust_contrast", adjust_contrast, ()),
        ("adjust_saturation", adjust_saturation, ("adjust_color", "tweak_colors")),
        ("adjust_hue", adjust_hue, ()), ("color_jitter", color_jitter, ()),
        ("random_rotate", random_rotate, ("rotate",)),
        ("random_translate", random_translate, ("translate",)),
        ("random_scale", random_scale, ("scale",)),
        ("random_crop", random_crop, ()),
        ("random_horizontal_flip", random_horizontal_flip, ("hflip",)),
        ("random_vertical_flip", random_vertical_flip, ("vflip",)),
        ("gaussian_noise", gaussian_noise, ("noise",))):
    register(_name, _fn, aliases=_aliases)
    TRANSFORM_REGISTRY[_name] = _fn
    TRANSFORM_REGISTRY.update({a: _fn for a in _aliases})

#: the transforms that change an image's height or width
RESHAPING = (resize, center_crop, pad, random_crop)

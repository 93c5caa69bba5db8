"""Augmentation: the 13 AugMix ops, AugMix, RandAugment, TrivialAugment,
random erasing, mixup, CutMix and the recipe parser.

Counterpart of ``deepcv_tpu/data/augmentation.py``, whole:

* the 13 ops of AugMix's table (``AUGMENTATION_OPS``) with PIL's integer
  arithmetic as the JAX package writes it: truncating LUTs, Pillow's
  ``(r*19595 + g*38470 + b*7471 + 0x8000) >> 16`` grey, the blends'
  ``floor(base + f * (img - base))``, sharpness' SMOOTH filter as shifted
  integer adds rounded by ``floor(acc / 13 + 0.5)``, the geometric ops
  through :func:`~deepcv_tpu_torch.data.transforms.affine_transform` with
  ``pil_exact_u8``;
* :func:`augment_and_mix`, :func:`rand_augment_batch`,
  :func:`trivial_augment_batch`, :func:`random_erasing_batch`,
  :func:`mixup_batch` and :func:`cutmix_batch`;
* the recipe parser (``RECIPE_DEFAULTS``, ``apply_augmentation_recipe``,
  ``AugmentationRecipe``) with every entry and section of the JAX
  package's, and its validation messages.

Every random op is a draw and an application: ``draw_*`` takes a
``torch.Generator`` on the batch's device, and the application takes the
draws as arguments. ``torch`` and ``jax.random`` give different bits from
one seed, so the two packages agree sample by sample only when the draws are
fed in, and in distribution otherwise.

Where the JAX package runs every op on the whole batch and keeps each
image's chosen one (AugMix chains, RandAugment), the port runs each op only
on the images that chose it (:func:`apply_chosen`): each image's result is
the same, for about 1/13 of the work. The Beta and Dirichlet draws are
built from the generator's own normal and uniform draws (:func:`gamma`),
since ``torch.distributions`` takes no generator.

Each listed recipe step with a severity other than false/0 runs behind an
independent per-image Bernoulli gate whose probability is the midpoint of
``augmentation_ops_depth`` over the number of steps, so an image gets that
many steps on average. Then, in this order: ``rand_augment`` (or
``trivial_augment``), ``augmix``, ``random_erasing``.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from deepcv_tpu_torch.data import transforms as T
from deepcv_tpu_torch.hyperparams import to_hyperparameters

__all__ = ["RECIPE_DEFAULTS", "K1_ORDER", "AUGMENTATION_OPS", "OPS", "AugOp",
           "autocontrast", "equalize", "posterize", "solarize", "color", "contrast",
           "brightness", "sharpness", "shear_x", "shear_y", "translate_x", "translate_y",
           "rotate", "gamma", "beta", "dirichlet", "apply_chosen",
           "draw_augment_and_mix", "augment_and_mix_apply", "augment_and_mix",
           "draw_rand_augment", "rand_augment_apply", "rand_augment_batch",
           "trivial_augment_batch", "draw_random_erasing", "random_erasing_apply",
           "random_erasing_batch", "draw_mixup", "mixup_apply", "mixup_batch",
           "draw_cutmix", "cutmix_apply", "cutmix_batch",
           "apply_augmentation_recipe", "AugmentationRecipe", "draw_factors"]

RECIPE_DEFAULTS = {
    "keep_same_input_shape": True,
    "random_transform_order": True,     # honored as per-image random gating
    "augmentation_ops_depth": [1, 4],
    "augmentations_per_image": [1, 3],
    "transforms": ...,
    "augmix": None,
    "transforms_additional": None,
}

_div = T._true_div


def _per_image(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(device=x.device, dtype=torch.float32).reshape(-1, 1, 1, 1)


# --------------------------------------------------------------------------- #
# Draws: levels, signs, gamma, Beta and Dirichlet
# --------------------------------------------------------------------------- #

def _levels(shape, g: torch.Generator, level: float) -> torch.Tensor:
    """AugMix's ``sample_level``: uniform in (0.1, level]."""
    return T.uniform(shape, g, 0.1, float(level))


def _signs(shape, g: torch.Generator) -> torch.Tensor:
    return torch.where(T.uniform(shape, g) < 0.5, 1.0, -1.0)


def _int_param(sampled: torch.Tensor, maxval: float) -> torch.Tensor:
    return torch.floor(sampled * maxval / 10.0)


def _float_param(sampled: torch.Tensor, maxval: float) -> torch.Tensor:
    return sampled * maxval / 10.0


def gamma(alpha, shape, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``generator``'s normal and uniform draws:
    Marsaglia and Tsang's squeeze (each element redrawn until accepted),
    and for alpha < 1 a draw at alpha + 1 times ``U ** (1 / alpha)``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = generator.device
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).expand(shape)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    while True:
        z = torch.randn(shape, generator=generator, device=dev)
        u = torch.rand(shape, generator=generator, device=dev)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
        if bool(done.all()):
            break
    u = torch.rand(shape, generator=generator, device=dev)
    return torch.where(boost, out * u ** (1.0 / a), out)


def beta(a: float, b: float, shape, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) as X / (X + Y) of two gamma draws."""
    x, y = gamma(a, shape, generator), gamma(b, shape, generator)
    return x / (x + y)


def dirichlet(alpha: float, n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """(n, k) rows from a symmetric Dirichlet(alpha): normalised gammas."""
    g = gamma(alpha, (n, k), generator)
    return g / g.sum(-1, keepdim=True)


# --------------------------------------------------------------------------- #
# The 13 ops: each an application fn(x, value) and the per-image value
# from a level sample and a sign, param(sample, sign, h, w)
# --------------------------------------------------------------------------- #

def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0)


def _from_u8(levels: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return _div(levels.to(torch.float32), 255.0).to(like.dtype)


def autocontrast(x: torch.Tensor, value=None) -> torch.Tensor:
    """PIL ``ImageOps.autocontrast`` (cutoff 0): per image and channel,
    ``(u8 - lo) * 255 // (hi - lo)``, PIL's truncating LUT."""
    u8 = _u8(x).to(torch.int32)
    lo = u8.amin(dim=(1, 2), keepdim=True)
    hi = u8.amax(dim=(1, 2), keepdim=True)
    span = torch.clamp(hi - lo, min=1)
    out = torch.where(hi > lo, torch.div((u8 - lo) * 255, span, rounding_mode="floor"), u8)
    return _from_u8(torch.clamp(out, 0, 255), x)


def equalize(x: torch.Tensor, value=None) -> torch.Tensor:
    """PIL ``ImageOps.equalize`` per image and channel: one 256-bin
    histogram each (one ``scatter_add_`` over offset indices), ``step =
    (npixels - count of the last non-zero bin) // 255``, ``lut[i] = (step //
    2 + cumsum[:i]) // step``, the identity where step is 0."""
    n, h, w, c = x.shape
    u8 = _u8(x).to(torch.int64).permute(0, 3, 1, 2).reshape(n * c, h * w)
    offset = torch.arange(n * c, device=x.device)[:, None] * 256
    histo = torch.zeros(n * c * 256, dtype=torch.int64, device=x.device)
    histo.scatter_add_(0, (u8 + offset).reshape(-1), torch.ones_like(u8).reshape(-1))
    histo = histo.reshape(n * c, 256)
    last_idx = 255 - (histo > 0).flip(-1).to(torch.int8).argmax(-1, keepdim=True)
    last_val = histo.gather(1, last_idx)
    step = torch.div(histo.sum(-1, keepdim=True) - last_val, 255, rounding_mode="floor")
    csum = torch.cumsum(histo, -1) - histo
    lut = torch.div(torch.div(step, 2, rounding_mode="floor") + csum,
                    torch.clamp(step, min=1), rounding_mode="floor").clamp(0, 255)
    out = torch.where(step == 0, u8, lut.gather(1, u8))
    return _from_u8(out.reshape(n, c, h, w).permute(0, 2, 3, 1), x)


def posterize(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep ``bits`` (per image) of each channel."""
    shift = (8 - bits.to(x.device)).to(torch.int32).reshape(-1, 1, 1, 1)
    u8 = _u8(x).to(torch.int32)
    return _from_u8(torch.bitwise_left_shift(torch.bitwise_right_shift(u8, shift), shift), x)


def solarize(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Invert the levels at or above ``threshold`` (per image)."""
    u8 = _u8(x)
    return _from_u8(torch.where(u8 < _per_image(threshold, x), u8, 255.0 - u8), x)


def _blend_trunc_u8(base: torch.Tensor, img: torch.Tensor, factor: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
    """PIL's ``Image.blend(degenerate, img, f)`` on u8 levels, truncated."""
    v = base + _per_image(factor, img) * (img - base)
    return _from_u8(torch.clamp(torch.floor(v), 0.0, 255.0), like)


def _pil_grey_u8(u8: torch.Tensor) -> torch.Tensor:
    """Pillow's ``convert('L')`` on u8 levels, in integers; a non-RGB image
    is already 'L'."""
    if u8.shape[-1] != 3:
        return u8
    rgb = u8.to(torch.int32)
    grey = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return grey[..., None].to(u8.dtype).expand(u8.shape)


def color(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``ImageEnhance.Color``: blend from the 'L' grey image."""
    u8 = _u8(x)
    return _blend_trunc_u8(_pil_grey_u8(u8), u8, factor, x)


def contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``ImageEnhance.Contrast``: blend from the constant ``int(L.mean() +
    0.5)``, the mean taken in integers (``(2 * sum + count) // (2 *
    count)``)."""
    u8 = _u8(x)
    grey = _pil_grey_u8(u8).to(torch.int64)
    count = grey[0].numel()
    total = grey.sum(dim=(1, 2, 3), keepdim=True)
    mean = torch.div(2 * total + count, 2 * count, rounding_mode="floor")
    return _blend_trunc_u8(mean.to(torch.float32), u8, factor, x)


def brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``ImageEnhance.Brightness``: blend from black."""
    u8 = _u8(x)
    return _blend_trunc_u8(torch.zeros_like(u8), u8, factor, x)


def sharpness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``ImageEnhance.Sharpness``: blend from the SMOOTH-filtered image
    (``[[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13`` rounded half up, the 1-pixel
    border kept), the 3x3 sums as shifted integer adds."""
    u8 = _u8(x)
    q = u8.to(torch.int32)
    h, w = q.shape[1], q.shape[2]
    acc = 4 * q[:, 1:-1, 1:-1]
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + q[:, dy:dy + h - 2, dx:dx + w - 2]
    smooth = torch.clamp(torch.floor(_div(acc.to(torch.float32), 13.0) + 0.5), 0.0, 255.0)
    smoothed = u8.clone()
    smoothed[:, 1:-1, 1:-1] = smooth
    return _blend_trunc_u8(smoothed, u8, factor, x)


def _shear(x: torch.Tensor, s: torch.Tensor, axis: int) -> torch.Tensor:
    s = s.to(device=x.device, dtype=torch.float32)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    rows = ([one, s, zero], [zero, one, zero]) if axis == 0 else \
        ([one, zero, zero], [s, one, zero])
    m = torch.stack([torch.stack(rows[0], -1), torch.stack(rows[1], -1)], dim=1)
    return T.affine_transform(x, m, pil_exact_u8=True)


def shear_x(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """PIL affine (1, s, 0, 0, 1, 0)."""
    return _shear(x, s, 0)


def shear_y(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """PIL affine (1, 0, 0, s, 1, 0)."""
    return _shear(x, s, 1)


def _translate(x: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    t = t.to(device=x.device, dtype=torch.float32)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    tx, ty = (t, zero) if axis == 0 else (zero, t)
    m = torch.stack([torch.stack([one, zero, tx], -1),
                     torch.stack([zero, one, ty], -1)], dim=1)
    return T.affine_transform(x, m, pil_exact_u8=True)


def translate_x(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Shift by ``t`` whole pixels along x (PIL affine (1, 0, t, 0, 1, 0))."""
    return _translate(x, t, 0)


def translate_y(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return _translate(x, t, 1)


def rotate(x: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Rotate by ``degrees`` about the centre, PIL's counterclockwise sense."""
    theta = torch.deg2rad(degrees.to(device=x.device, dtype=torch.float32))
    return T.affine_transform(x, T.rotate_matrices(theta, x.shape[1], x.shape[2]),
                              pil_exact_u8=True)


class AugOp(NamedTuple):
    """An AugMix op: ``apply(x, value)`` with ``value`` per image, and
    ``param(sample, sign, h, w)``, the value from a level sample in (0.1,
    level] and a random sign, as the JAX op draws it."""
    apply: Callable
    param: Callable


def _enhance(sample, sign, h, w):
    return _float_param(sample, 1.8) + 0.1


def _none(sample, sign, h, w):
    return torch.zeros_like(sample)


#: the reference's 13-op table, in its order
OPS: Dict[str, AugOp] = {
    "autocontrast": AugOp(autocontrast, _none),
    "equalize": AugOp(equalize, _none),
    "posterize": AugOp(posterize, lambda s, sg, h, w: 4 - _int_param(s, 4)),
    "rotate": AugOp(rotate, lambda s, sg, h, w: _int_param(s, 30) * sg),
    "solarize": AugOp(solarize, lambda s, sg, h, w: 256.0 - _int_param(s, 256)),
    "shear_x": AugOp(shear_x, lambda s, sg, h, w: _float_param(s, 0.3) * sg),
    "shear_y": AugOp(shear_y, lambda s, sg, h, w: _float_param(s, 0.3) * sg),
    "translate_x": AugOp(translate_x, lambda s, sg, h, w: _int_param(s, w / 3.0) * sg),
    "translate_y": AugOp(translate_y, lambda s, sg, h, w: _int_param(s, h / 3.0) * sg),
    "color": AugOp(color, _enhance),
    "contrast": AugOp(contrast, _enhance),
    "brightness": AugOp(brightness, _enhance),
    "sharpness": AugOp(sharpness, _enhance),
}


def _op_fn(name: str) -> Callable:
    op = OPS[name]

    def fn(x: torch.Tensor, generator: torch.Generator, level: float) -> torch.Tensor:
        n, h, w = x.shape[:3]
        return op.apply(x, op.param(_levels(n, generator, level), _signs(n, generator), h, w))

    fn.__name__ = name
    return fn


#: name -> ``fn(x, generator, level)``, each op with its own draws
AUGMENTATION_OPS: Dict[str, Callable] = {name: _op_fn(name) for name in OPS}


def _op_values(op_idx: torch.Tensor, samples: torch.Tensor, signs: torch.Tensor,
               ops: Sequence[str], h: int, w: int) -> torch.Tensor:
    """Each element's value for the op it chose."""
    out = torch.zeros_like(samples)
    for j, name in enumerate(ops):
        out = torch.where(op_idx == j, OPS[name].param(samples, signs, h, w), out)
    return out


def apply_chosen(x: torch.Tensor, choice: torch.Tensor, values: torch.Tensor,
                 ops: Sequence[str], counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Apply to each image the op ``ops[choice[i]]`` at ``values[i]`` (none
    where ``choice`` is -1), running each op only on the images that chose
    it. ``counts`` (images per op, read back once by the caller) saves the
    read back here."""
    k = len(ops)
    key = torch.where(choice < 0, k, choice).to(torch.int64)
    if counts is None:
        counts = torch.bincount(key, minlength=k + 1).tolist()
    order = torch.argsort(key, stable=True)
    out, start = x.clone(), 0
    for j, cnt in enumerate(counts[:k]):
        if cnt:
            idx = order[start:start + cnt]
            out.index_copy_(0, idx, OPS[ops[j]].apply(x.index_select(0, idx),
                                                      values.index_select(0, idx)))
        start += cnt
    return out


# --------------------------------------------------------------------------- #
# AugMix
# --------------------------------------------------------------------------- #

def draw_augment_and_mix(n: int, h: int, w: int, generator: torch.Generator,
                         severity: int = 3, width: int = 3, depth: int = -1,
                         alpha: float = 1.0, ops: Optional[Sequence[str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """AugMix's per-image draws: the chains' Dirichlet weights ``ws`` (N,
    width), the Beta mixing weight ``m`` (N,), each chain's ``depths`` (N,
    width; 1-3 when ``depth`` < 1), its ops ``op_idx`` and their ``values``
    (N, width, max depth)."""
    ops = list(ops or OPS)
    max_depth = depth if depth > 0 else 3
    g = generator
    ws = dirichlet(alpha, n, width, g)
    m = beta(alpha, alpha, n, g)
    depths = torch.full((n, width), max_depth, device=g.device) if depth > 0 else \
        torch.randint(1, 4, (n, width), generator=g, device=g.device)
    op_idx = torch.randint(0, len(ops), (n, width, max_depth), generator=g, device=g.device)
    samples = _levels(op_idx.shape, g, severity)
    values = _op_values(op_idx, samples, _signs(op_idx.shape, g), ops, h, w)
    return {"ws": ws, "m": m, "depths": depths, "op_idx": op_idx, "values": values}


def augment_and_mix_apply(x: torch.Tensor, ws: torch.Tensor, m: torch.Tensor,
                          depths: torch.Tensor, op_idx: torch.Tensor, values: torch.Tensor,
                          ops: Optional[Sequence[str]] = None) -> torch.Tensor:
    """AugMix with its draws given: chain c of image i applies ``op_idx[i,
    c, :depths[i, c]]`` at ``values``; the chains mix by ``ws`` and the mix
    blends with the image by ``m``. The images per op of every chain step
    are read back in one transfer."""
    ops = list(ops or OPS)
    n, width, max_depth = op_idx.shape
    dev = x.device
    step = torch.arange(max_depth, device=dev)
    choice = torch.where(step[None, None, :] < depths.to(dev)[..., None], op_idx.to(dev), -1)
    key = torch.where(choice < 0, len(ops), choice)
    counts = torch.nn.functional.one_hot(key.permute(1, 2, 0), len(ops) + 1).sum(2).tolist()
    mixed = torch.zeros_like(x)
    for c in range(width):
        cur = x
        for i in range(max_depth):
            cur = apply_chosen(cur, choice[:, c, i], values[:, c, i].to(dev), ops,
                               counts[c][i])
        mixed = mixed + _per_image(ws[:, c], x) * cur
    mm = _per_image(m, x)
    return (1.0 - mm) * x + mm * mixed


def augment_and_mix(x: torch.Tensor, generator: torch.Generator, severity: int = 3,
                    width: int = 3, depth: int = -1, alpha: float = 1.0,
                    ops: Optional[Sequence[str]] = None) -> torch.Tensor:
    """AugMix (arXiv:1912.02781): ``width`` Dirichlet-weighted chains of
    ``depth`` ops (1-3 when ``depth`` < 1), Beta-mixed with the image."""
    n, h, w = x.shape[:3]
    d = draw_augment_and_mix(n, h, w, generator, severity, width, depth, alpha, ops)
    return augment_and_mix_apply(x, ops=ops, **d)


# --------------------------------------------------------------------------- #
# RandAugment, TrivialAugment, random erasing
# --------------------------------------------------------------------------- #

def draw_rand_augment(n: int, h: int, w: int, generator: torch.Generator, rounds: int = 2,
                      magnitude: float = 5.0, ops: Optional[Sequence[str]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RandAugment's draws: each round's op choice per image and its value,
    both (rounds, N)."""
    ops = list(ops or OPS)
    g = generator
    choice = torch.randint(0, len(ops), (int(rounds), n), generator=g, device=g.device)
    values = _op_values(choice, _levels(choice.shape, g, magnitude),
                        _signs(choice.shape, g), ops, h, w)
    return choice, values


def rand_augment_apply(x: torch.Tensor, choice: torch.Tensor, values: torch.Tensor,
                       ops: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Round r applies ``ops[choice[r, i]]`` at ``values[r, i]`` to image i."""
    ops = list(ops or OPS)
    for r in range(choice.shape[0]):
        x = apply_chosen(x, choice[r].to(x.device), values[r].to(x.device), ops)
    return x


def rand_augment_batch(x: torch.Tensor, generator: torch.Generator, n: int = 2,
                       magnitude: float = 5.0, ops: Optional[Sequence[str]] = None
                       ) -> torch.Tensor:
    """RandAugment (arXiv:1909.13719): ``n`` rounds, each one op per image,
    chosen uniformly from the pool, at ``magnitude`` on AugMix's 0-10 scale."""
    choice, values = draw_rand_augment(len(x), x.shape[1], x.shape[2], generator, n,
                                       magnitude, ops)
    return rand_augment_apply(x, choice, values, ops)


def trivial_augment_batch(x: torch.Tensor, generator: torch.Generator,
                          ops: Optional[Sequence[str]] = None) -> torch.Tensor:
    """TrivialAugment (arXiv:2103.10158): one RandAugment round at the
    magnitude ceiling, each op drawing its value per image."""
    return rand_augment_batch(x, generator, n=1, magnitude=10.0, ops=ops)


def draw_random_erasing(x_shape, generator: torch.Generator, p: float = 0.5,
                        scale=(0.02, 0.33), ratio=(0.3, 3.3), value: Optional[float] = None
                        ) -> Dict[str, Optional[torch.Tensor]]:
    """Random erasing's per-image draws: the gate, the area in pixels, the
    log aspect ratio, the box's relative position, and the fill (uniform in
    [0, 1), or None for a constant ``value``)."""
    n, h, w, _ = x_shape
    g = generator
    return {"gate": T.uniform(n, g) < float(p),
            "area": T.uniform(n, g, float(scale[0]), float(scale[1])) * (h * w),
            "log_r": T.uniform(n, g, math.log(float(ratio[0])), math.log(float(ratio[1]))),
            "uy": T.uniform(n, g), "ux": T.uniform(n, g),
            "fill": T.uniform(x_shape, g) if value is None else None}


def random_erasing_apply(x: torch.Tensor, gate: torch.Tensor, area: torch.Tensor,
                         log_r: torch.Tensor, uy: torch.Tensor, ux: torch.Tensor,
                         fill: Optional[torch.Tensor], value: Optional[float] = None
                         ) -> torch.Tensor:
    """Overwrite each gated image's box (height ``sqrt(area * r)``, width
    ``sqrt(area / r)``, each clipped to [1, side], at ``(uy, ux)`` of the
    free range) with ``fill``, or with ``value``."""
    n, h, w, _ = x.shape
    dev = x.device
    area, log_r, uy, ux = (t.to(dev) for t in (area, log_r, uy, ux))
    r = torch.exp(log_r)
    eh = torch.clamp(torch.sqrt(area * r), 1, h)
    ew = torch.clamp(torch.sqrt(area / r), 1, w)
    y0 = uy * (h - eh)
    x0 = ux * (w - ew)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inside = (rows >= y0[:, None, None]) & (rows < (y0 + eh)[:, None, None]) \
        & (cols >= x0[:, None, None]) & (cols < (x0 + ew)[:, None, None])
    mask = (inside & gate.to(dev)[:, None, None])[..., None]
    fill = torch.full_like(x, float(value)) if fill is None else fill.to(dev, x.dtype)
    return torch.where(mask, fill, x)


def random_erasing_batch(x: torch.Tensor, generator: torch.Generator, p: float = 0.5,
                         scale=(0.02, 0.33), ratio=(0.3, 3.3),
                         value: Optional[float] = None) -> torch.Tensor:
    """Random erasing (arXiv:1708.04896): with probability ``p`` per image,
    one box of area fraction U(scale) and aspect exp(U(log ratio)) filled
    with uniform values in [0, 1] (the recipe runs before normalize) or
    with ``value``."""
    d = draw_random_erasing(tuple(x.shape), generator, p, scale, ratio, value)
    return random_erasing_apply(x, value=value, **d)


# --------------------------------------------------------------------------- #
# mixup and CutMix: batch -> (batch, perm, lam); the training loop combines
# lam * loss(y) + (1 - lam) * loss(y[perm])
# --------------------------------------------------------------------------- #

def draw_mixup(n: int, generator: torch.Generator, alpha: float = 0.2
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A permutation of the batch and one lam ~ Beta(alpha, alpha)."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm, beta(alpha, alpha, (), generator)


def mixup_apply(x: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor):
    """mixup (arXiv:1710.09412) with its draws: lam becomes ``max(lam, 1 -
    lam)`` (the image keeps the larger share). Returns (x_mixed, perm, lam)."""
    lam = torch.maximum(lam, 1.0 - lam).to(x.device)
    xm = lam * x + (1.0 - lam) * x.index_select(0, perm.to(x.device))
    return xm.to(x.dtype), perm, lam


def mixup_batch(x: torch.Tensor, generator: torch.Generator, alpha: float = 0.2):
    return mixup_apply(x, *draw_mixup(len(x), generator, alpha))


def draw_cutmix(n: int, h: int, w: int, generator: torch.Generator, alpha: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A permutation, lam0 ~ Beta(alpha, alpha) and the box centre (cy, cx),
    uniform over the image."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    lam0 = beta(alpha, alpha, (), generator)
    return perm, lam0, T.uniform((), generator, 0.0, float(h)), \
        T.uniform((), generator, 0.0, float(w))


def cutmix_apply(x: torch.Tensor, perm: torch.Tensor, lam0: torch.Tensor,
                 cy: torch.Tensor, cx: torch.Tensor):
    """CutMix (arXiv:1905.04899) with its draws: the box of side
    ``sqrt(1 - lam0)`` times the image's, centred at (cy, cx) and clipped
    to the image, comes from the permuted batch; lam is the kept share of
    the pixels. Returns (x_mixed, perm, lam)."""
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    cut = torch.sqrt(1.0 - lam0.to(dev))
    bh, bw = cut * h, cut * w
    cy, cx = cy.to(dev), cx.to(dev)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    mask = (yy >= cy - bh / 2) & (yy < cy + bh / 2) & (xx >= cx - bw / 2) & (xx < cx + bw / 2)
    xm = torch.where(mask[None, :, :, None], x.index_select(0, perm.to(dev)), x)
    return xm.to(x.dtype), perm, 1.0 - mask.to(torch.float32).mean()


def cutmix_batch(x: torch.Tensor, generator: torch.Generator, alpha: float = 1.0):
    return cutmix_apply(x, *draw_cutmix(len(x), x.shape[1], x.shape[2], generator, alpha))


# --------------------------------------------------------------------------- #
# The recipe
# --------------------------------------------------------------------------- #

def _blend_factor(n: int, g: torch.Generator, s: float) -> torch.Tensor:
    """Per-image ``1 + s * N(0, 1)`` (brightness, contrast, saturation)."""
    return 1.0 + s * torch.randn((n,), generator=g, device=g.device)


def _gamma_factor(n: int, g: torch.Generator, s: float) -> torch.Tensor:
    """Per-image ``exp(s * N(0, 1))``."""
    return torch.exp(s * torch.randn((n,), generator=g, device=g.device))


def _gate(n: int, g: torch.Generator, p: float) -> torch.Tensor:
    """Per-image Bernoulli(p) gates."""
    return torch.rand((n,), generator=g, device=g.device) < p


def _rotate_degrees(s):
    return (180.0 * s[0], 180.0 * s[1]) if isinstance(s, (list, tuple)) else 180.0 * s


#: recipe entry -> fn(x, generator, severity); the draws of
#: ``deepcv_tpu/data/augmentation.py:350-374``
_RECIPE_TRANSFORMS: Dict[str, Callable] = {
    "brightness": lambda x, g, s: T.adjust_brightness(x, _blend_factor(len(x), g, s)),
    "contrast": lambda x, g, s: T.adjust_contrast(x, _blend_factor(len(x), g, s)),
    "tweak_colors": lambda x, g, s: T.adjust_saturation(x, _blend_factor(len(x), g, s)),
    "gamma": lambda x, g, s: T.adjust_gamma(x, _gamma_factor(len(x), g, s)),
    "posterize": lambda x, g, s: AUGMENTATION_OPS["posterize"](x, g, max(1.0, 10.0 * s)),
    "noise": lambda x, g, s: T.gaussian_noise(x, g, sigma=s),
    "rotate": lambda x, g, s: T.random_rotate(x, g, _rotate_degrees(s)),
    "translate": lambda x, g, s: T.random_translate(x, g, s),
    "scale": lambda x, g, s: T.random_scale(x, g, s),
    "crop": lambda x, g, s: T.random_crop(x, g, (x.shape[1], x.shape[2]),
                                          padding=max(1, int(0.1 * x.shape[1]))),
    # the severity is the flip probability for these two
    "random_horizontal_flip": lambda x, g, s: T.random_horizontal_flip(x, g, p=s),
    "random_vertical_flip": lambda x, g, s: T.random_vertical_flip(x, g, p=s),
}
_RECIPE_TRANSFORMS["hflip"] = _RECIPE_TRANSFORMS["random_horizontal_flip"]
_RECIPE_TRANSFORMS["vflip"] = _RECIPE_TRANSFORMS["random_vertical_flip"]
#: entries the JAX package accepts and skips (stubs in the reference too)
_STUB_RECIPE_TRANSFORMS = ("smooth_non_linear_deformation",)
#: the K1 argument each blend or gamma step sets
_K1_FACTOR = {"brightness": "brightness", "contrast": "contrast",
              "tweak_colors": "saturation", "gamma": "gamma"}

#: the steps K1 fuses, in the order it applies them
K1_ORDER = ("brightness", "contrast", "tweak_colors", "gamma", "noise")


def _merged(value: Any, key: str) -> Optional[Dict[str, Any]]:
    """A recipe section as a mapping: a YAML list of dicts is merged,
    ``true`` means all defaults, anything else that is not a mapping fails
    naming the expected form."""
    if isinstance(value, (list, tuple)):
        out: Dict[str, Any] = {}
        for d in value:
            out.update(d)
        return out
    if value is True:
        return {}
    if value is not None and not isinstance(value, Mapping):
        raise ValueError(f"{key}: expected a mapping of options (or 'true' for defaults), "
                         f"got {value!r}")
    return dict(value) if value is not None else None


def _check_section(spec: Mapping[str, Any], key: str, known: Sequence[str], note: str = ""):
    unknown = set(spec) - set(known)
    if unknown:
        raise ValueError(f"{key}: unknown keys {sorted(unknown)} "
                         f"(known: {', '.join(known)}{note})")
    bad_ops = [o for o in (spec.get("ops") or []) if o not in OPS]
    if bad_ops:
        raise ValueError(f"{key}: unknown ops {bad_ops}; known: {sorted(OPS)}")


def apply_augmentation_recipe(recipe: Mapping[str, Any]) -> "AugmentationRecipe":
    """Compile a YAML augmentation recipe (``parameters.yml``'s
    ``augmentations_recipes`` format) into a batched, picklable
    ``fn(x, generator) -> x``: the gated steps, then ``rand_augment: {n,
    magnitude, ops}`` or ``trivial_augment: {ops}`` (one round at magnitude
    10; the two are exclusive), ``augmix`` and ``random_erasing: {p,
    scale, ratio, value}``, validated as the JAX package validates them.
    ``transforms_additional`` raises: the JAX parser never reads it, so a
    recipe that sets it would train without it there."""
    hp, _ = to_hyperparameters(dict(recipe), RECIPE_DEFAULTS)
    if hp.get("transforms_additional"):
        raise NotImplementedError(
            "augmentation recipe 'transforms_additional' is not implemented: the JAX "
            "package's parser never reads it either; list the steps under 'transforms'")
    steps: List[Tuple[str, Any]] = []
    for tspec in hp["transforms"] or []:
        if isinstance(tspec, Mapping):
            (tname, sev), = tspec.items()
        else:
            tname, sev = str(tspec), 0.5
        if sev in (False, None, 0, 0.0) or tname in _STUB_RECIPE_TRANSFORMS:
            continue
        if tname not in _RECIPE_TRANSFORMS:
            raise ValueError(f"Unknown augmentation transform '{tname}'; "
                             f"known: {sorted(_RECIPE_TRANSFORMS)}")
        steps.append((tname, sev))
    lo, hi = hp["augmentation_ops_depth"]
    target_ops = (float(lo) + float(hi)) / 2.0
    gate_p = min(1.0, target_ops / max(1, len(steps))) if steps else 0.0

    augmix_spec = hp.get("augmix")
    if isinstance(augmix_spec, (list, tuple)):
        augmix_spec = _merged(augmix_spec, "augmix")
    ra = _merged(hp.get("rand_augment"), "rand_augment")
    if ra is not None:
        _check_section(ra, "rand_augment", ("n", "magnitude", "ops"))
    ta = _merged(hp.get("trivial_augment"), "trivial_augment")
    if ta is not None:
        if ra is not None:
            raise ValueError("rand_augment and trivial_augment are exclusive "
                             "(TrivialAugment IS one RandAugment round at full magnitude)")
        _check_section(ta, "trivial_augment", ("ops",),
                       " — TA is tuning-free by construction")
        ra = {"n": 1, "magnitude": 10.0, "ops": ta.get("ops")}
    re_spec = _merged(hp.get("random_erasing"), "random_erasing")
    if re_spec is not None:
        _check_section(re_spec, "random_erasing", ("p", "scale", "ratio", "value"))
    return AugmentationRecipe(steps, gate_p, augmix_spec=augmix_spec, rand_augment=ra,
                              random_erasing=re_spec)


def _severity(s: Any) -> Any:
    return tuple(float(v) for v in s) if isinstance(s, (list, tuple)) else float(s)


class AugmentationRecipe:
    """A compiled recipe: step names with their severities, the gate
    probability and the sections' options. Holds no function, so it
    pickles."""

    def __init__(self, steps: Sequence[Tuple[str, Any]], gate_p: float, augmix_spec=None,
                 rand_augment=None, random_erasing=None):
        self._steps = [(str(n), _severity(s)) for n, s in steps]
        self.gate_p = float(gate_p)
        self.augmix_spec = augmix_spec
        # is-not-None: 'rand_augment: {}' means the defaults, not off
        self.rand_augment = dict(rand_augment) if rand_augment is not None else None
        self.random_erasing = dict(random_erasing) if random_erasing is not None else None

    @property
    def steps(self) -> List[str]:
        return [n for n, _ in self._steps]

    @property
    def severities(self) -> List[Tuple[str, Any]]:
        return list(self._steps)

    def fits_k1(self) -> bool:
        """Whether one K1 launch computes the recipe: no section, and steps
        that are a subsequence of K1's order."""
        if self.augmix_spec or self.rand_augment is not None \
                or self.random_erasing is not None:
            return False
        order = iter(K1_ORDER)
        return all(name in order for name in self.steps)

    def __call__(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The eager chain on an NHWC float batch in [0, 1]: each step on the
        whole batch, kept where its gate is on, then the sections.
        ``generator`` lies on ``x``'s device."""
        for name, sev in self._steps:
            gate = _gate(len(x), generator, self.gate_p)
            out = _RECIPE_TRANSFORMS[name](x, generator, sev)
            x = torch.where(gate.reshape((-1,) + (1,) * (x.dim() - 1)), out, x)
        if self.rand_augment is not None:
            ra = self.rand_augment
            x = rand_augment_batch(x, generator, n=int(ra.get("n", 2)),
                                   magnitude=float(ra.get("magnitude", 5.0)),
                                   ops=ra.get("ops"))
        if self.augmix_spec:
            chains = self.augmix_spec.get("augmentation_chains_count", [1, 3])
            width = int(chains[1]) if isinstance(chains, (list, tuple)) else int(chains)
            alpha = float(self.augmix_spec.get("transform_chains_dirichlet", 1.0))
            x = augment_and_mix(x, generator, width=width, alpha=alpha)
        if self.random_erasing is not None:
            re_ = self.random_erasing
            x = random_erasing_batch(x, generator, p=float(re_.get("p", 0.5)),
                                     scale=tuple(re_.get("scale", (0.02, 0.33))),
                                     ratio=tuple(re_.get("ratio", (0.3, 3.3))),
                                     value=re_.get("value"))
        return x

    def __repr__(self):
        return (f"AugmentationRecipe(steps={self._steps}, gate_p={self.gate_p}, "
                f"augmix={self.augmix_spec}, rand_augment={self.rand_augment}, "
                f"random_erasing={self.random_erasing})")


def draw_factors(recipe: AugmentationRecipe, n: int,
                 generator: torch.Generator) -> Dict[str, Any]:
    """K1's per-image inputs for a recipe that :meth:`~AugmentationRecipe.fits_k1`,
    on ``generator``'s device: for each step in order, the gates and then
    the factors, as the eager chain draws them; a gated-off image gets the
    neutral value (1, 1, 1, 1 and sigma 0). ``noise_sigma`` is None when
    the recipe has no noise step, and ``seed`` (one int64 on the device,
    drawn without a host synchronise) is then 0."""
    ones = torch.ones((n,), device=generator.device)
    out: Dict[str, Any] = {"brightness": ones, "contrast": ones, "saturation": ones,
                           "gamma": ones, "noise_sigma": None, "seed": 0}
    for name, sev in recipe.severities:
        gate = _gate(n, generator, recipe.gate_p)
        if name == "noise":
            out["noise_sigma"] = torch.where(gate, sev, 0.0)
            out["seed"] = torch.randint(0, 2 ** 62, (1,), generator=generator,
                                        device=generator.device, dtype=torch.int64)
        else:
            draw = _gamma_factor if name == "gamma" else _blend_factor
            out[_K1_FACTOR[name]] = torch.where(gate, draw(n, generator, sev), 1.0)
    return out

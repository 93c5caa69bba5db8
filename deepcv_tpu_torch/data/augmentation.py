"""Augmentation recipes: the photometric subset.

Counterpart of ``deepcv_tpu/data/augmentation.py``'s recipe parser
(``RECIPE_DEFAULTS``, ``_RECIPE_TRANSFORMS``, ``apply_augmentation_recipe``,
``AugmentationRecipe``) for the five entries that the fused augment kernel
(K1) computes: ``brightness``, ``contrast``, ``tweak_colors``, ``gamma`` and
``noise``. Every other entry (``posterize``, ``rotate``, ``crop``, ...) and
the ``augmix``, ``rand_augment``, ``trivial_augment`` and
``random_erasing`` sections raise ``NotImplementedError``, naming them.

Each listed step with a severity other than false/0 runs behind an
independent per-image Bernoulli gate whose probability is the midpoint of
``augmentation_ops_depth`` over the number of steps, so an image gets that
many steps on average. A recipe draws from a ``torch.Generator`` on the
batch's device: for each step in order, the gates, then the step's own
draws. ``torch`` and ``jax.random`` give different bits from one seed, so
the two packages agree in distribution, not sample by sample.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from deepcv_tpu_torch.data import transforms as T
from deepcv_tpu_torch.hyperparams import to_hyperparameters

__all__ = ["RECIPE_DEFAULTS", "K1_ORDER", "UNPORTED_RECIPE_TRANSFORMS",
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

#: the recipe entries of the JAX package this port does not carry yet
UNPORTED_RECIPE_TRANSFORMS = (
    "posterize", "rotate", "translate", "scale", "crop", "random_horizontal_flip",
    "random_vertical_flip", "hflip", "vflip")
#: entries the JAX package accepts and skips (stubs in the reference too)
_STUB_RECIPE_TRANSFORMS = ("smooth_non_linear_deformation",)
#: recipe sections that add whole augmentation policies
_UNPORTED_SECTIONS = ("augmix", "rand_augment", "trivial_augment", "random_erasing",
                      "transforms_additional")


def _blend_factor(n: int, g: torch.Generator, s: float) -> torch.Tensor:
    """Per-image ``1 + s * N(0, 1)`` (brightness, contrast, saturation)."""
    return 1.0 + s * torch.randn((n,), generator=g, device=g.device)


def _gamma_factor(n: int, g: torch.Generator, s: float) -> torch.Tensor:
    """Per-image ``exp(s * N(0, 1))``."""
    return torch.exp(s * torch.randn((n,), generator=g, device=g.device))


def _gate(n: int, g: torch.Generator, p: float) -> torch.Tensor:
    """Per-image Bernoulli(p) gates."""
    return torch.rand((n,), generator=g, device=g.device) < p


#: recipe entry -> fn(x, generator, severity); the factor draws of
#: ``deepcv_tpu/data/augmentation.py:351-360``
_RECIPE_TRANSFORMS: Dict[str, Callable] = {
    "brightness": lambda x, g, s: T.adjust_brightness(x, _blend_factor(len(x), g, s)),
    "contrast": lambda x, g, s: T.adjust_contrast(x, _blend_factor(len(x), g, s)),
    "tweak_colors": lambda x, g, s: T.adjust_saturation(x, _blend_factor(len(x), g, s)),
    "gamma": lambda x, g, s: T.adjust_gamma(x, _gamma_factor(len(x), g, s)),
    "noise": lambda x, g, s: T.gaussian_noise(x, g, sigma=s),
}
#: the K1 argument each blend or gamma step sets
_K1_FACTOR = {"brightness": "brightness", "contrast": "contrast",
              "tweak_colors": "saturation", "gamma": "gamma"}

#: the steps K1 fuses, in the order it applies them
K1_ORDER = ("brightness", "contrast", "tweak_colors", "gamma", "noise")


def apply_augmentation_recipe(recipe: Mapping[str, Any]) -> "AugmentationRecipe":
    """Compile a YAML augmentation recipe (``parameters.yml``'s
    ``augmentations_recipes`` format) into a batched, picklable
    ``fn(x, generator) -> x``."""
    hp, _ = to_hyperparameters(dict(recipe), RECIPE_DEFAULTS)
    for key in _UNPORTED_SECTIONS:
        if hp.get(key):
            raise NotImplementedError(f"augmentation recipe '{key}' is not ported yet")
    steps: List[Tuple[str, float]] = []
    for tspec in hp["transforms"] or []:
        if isinstance(tspec, Mapping):
            (tname, sev), = tspec.items()
        else:
            tname, sev = str(tspec), 0.5
        if sev in (False, None, 0, 0.0) or tname in _STUB_RECIPE_TRANSFORMS:
            continue
        if tname in UNPORTED_RECIPE_TRANSFORMS:
            raise NotImplementedError(
                f"augmentation transform '{tname}' is not ported yet "
                f"(ported: {sorted(_RECIPE_TRANSFORMS)})")
        if tname not in _RECIPE_TRANSFORMS:
            raise ValueError(f"Unknown augmentation transform '{tname}'; "
                             f"known: {sorted(_RECIPE_TRANSFORMS)}")
        steps.append((tname, float(sev)))
    lo, hi = hp["augmentation_ops_depth"]
    target_ops = (float(lo) + float(hi)) / 2.0
    gate_p = min(1.0, target_ops / max(1, len(steps))) if steps else 0.0
    return AugmentationRecipe(steps, gate_p)


class AugmentationRecipe:
    """A compiled recipe: step names with their severities and the gate
    probability. Holds no function, so it pickles."""

    def __init__(self, steps: Sequence[Tuple[str, float]], gate_p: float):
        self._steps = [(str(n), float(s)) for n, s in steps]
        self.gate_p = float(gate_p)

    @property
    def steps(self) -> List[str]:
        return [n for n, _ in self._steps]

    @property
    def severities(self) -> List[Tuple[str, float]]:
        return list(self._steps)

    def fits_k1(self) -> bool:
        """Whether the steps are a subsequence of K1's order, so that one K1
        launch computes the recipe."""
        order = iter(K1_ORDER)
        return all(name in order for name in self.steps)

    def __call__(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The eager chain: each step on the whole batch, kept where its
        gate is on. ``generator`` lies on ``x``'s device."""
        for name, sev in self._steps:
            gate = _gate(len(x), generator, self.gate_p)
            out = _RECIPE_TRANSFORMS[name](x, generator, sev)
            x = torch.where(gate.reshape((-1,) + (1,) * (x.dim() - 1)), out, x)
        return x

    def __repr__(self):
        return f"AugmentationRecipe(steps={self._steps}, gate_p={self.gate_p})"


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

"""SinGAN generative augmentation: a pyramid of small per-scale GANs trained
on one image, sampled coarse to fine into variants that keep its patch
statistics.

Counterpart of ``deepcv_tpu/data/singan.py`` (``SinGAN``, ``train_singan``,
``distilled_singan_augmentation``; Shaham et al., arXiv:1905.01164), with
the JAX package's choices: LSGAN losses (least squares) instead of the
paper's WGAN-GP, Adam at ``b1 = 0.5`` for both nets, and per iteration one
discriminator step, then one generator step against the updated
discriminator whose loss adds ``rec_weight`` times the reconstruction error
of the fixed-noise path. Each scale's nets are :class:`ConvStack`\\ s, named
as flax names them (``Conv_<i>``, ``GroupNorm_<i>``, group norm eps 1e-6),
so :func:`deepcv_tpu_torch.interop.load_jax_variables` carries JAX weights
across. Resizes are ``jax.image.resize``'s antialiased bilinear
(:func:`deepcv_tpu_torch.data.transforms.resize`).

Where the JAX package scans a scale's steps in one device program, this is a
host loop of steps on the device; the losses are read back once a scale.
Random draws (initialisation, noise) come from a ``torch.Generator``; JAX's
draws are not reproduced, so a port run and a JAX run from one seed train
different pyramids.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepcv_tpu_torch.data.transforms import resize
from deepcv_tpu_torch.ops.nn import lecun_normal_
from deepcv_tpu_torch.train.optimizers import build_optimizer
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["SinGAN", "ConvStack", "train_singan", "singan_step",
           "distilled_singan_augmentation", "pyramid_shapes"]

_logger = logging.getLogger(__name__)

#: flax ``GroupNorm``'s epsilon (torch's default is 1e-5)
GROUP_NORM_EPS = 1e-6


class ConvStack(nn.Module):
    """SinGAN's per-scale net on NHWC tensors: ``n_layers - 1`` times 3x3
    conv, group norm (4 groups) and leaky relu (0.2), then a 3x3 conv to
    ``out_channels`` (tanh for the generator)."""

    jax_flat = True

    def __init__(self, in_channels: int, features: int = 32, out_channels: int = 3,
                 n_layers: int = 5, final_act: Optional[str] = None):
        super().__init__()
        self.n_layers, self.final_act = int(n_layers), final_act
        for i in range(self.n_layers):
            cin = in_channels if i == 0 else features
            cout = out_channels if i == self.n_layers - 1 else features
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 3, padding=1))
            if i < self.n_layers - 1:
                self.add_module(f"GroupNorm_{i}", nn.GroupNorm(4, features, eps=GROUP_NORM_EPS))

    def init_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: LeCun-normal kernels, zero biases, unit scales."""
        with torch.no_grad():
            for name, m in self.named_children():
                if name.startswith("Conv_"):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
                else:
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(self.n_layers - 1):
            h = getattr(self, f"Conv_{i}")(h)
            h = F.leaky_relu(getattr(self, f"GroupNorm_{i}")(h), 0.2)
        h = getattr(self, f"Conv_{self.n_layers - 1}")(h)
        if self.final_act == "tanh":
            h = torch.tanh(h)
        return h.permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize(x, (h, w), "bilinear", antialias=True)


def pyramid_shapes(h: int, w: int, n_scales: int, scale_factor: float,
                   min_size: int) -> List[Tuple[int, int]]:
    """The (H, W) of each scale, coarsest first."""
    shapes = []
    for s in range(n_scales):
        f = scale_factor ** (n_scales - 1 - s)
        shapes.append((max(min_size, int(round(h * f))), max(min_size, int(round(w * f)))))
    return shapes


class SinGAN:
    """A trained pyramid: per-scale generators and noise amplitudes."""

    def __init__(self, generators: Sequence[ConvStack], noise_amps: Sequence[float],
                 shapes: Sequence[Tuple[int, int]], features: int, rec_z0: torch.Tensor,
                 channels: int = 3):
        self.generators = list(generators)
        self.noise_amps = [float(a) for a in noise_amps]
        self.shapes = list(shapes)
        self.features = int(features)
        self.channels = int(channels)
        self.rec_z0 = rec_z0                   # fixed coarsest noise (the recon path)

    @property
    def device(self) -> torch.device:
        return self.rec_z0.device

    def _noise(self, generator: Optional[torch.Generator], shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    @torch.no_grad()
    def sample(self, n: int = 1, start_scale: int = 0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n variants (N, H, W, C) in [0, 1]; ``start_scale > 0`` follows the
        reconstruction path below that scale, so the training image's global
        layout stays and only finer textures are drawn anew."""
        h0, w0 = self.shapes[0]
        c = self.channels
        x = torch.zeros((n, h0, w0, c), device=self.device)
        for s, (hs, ws) in enumerate(self.shapes):
            x = _resize(x, hs, ws)
            if s < start_scale:
                z = (self.rec_z0.expand(n, hs, ws, c) if s == 0
                     else torch.zeros((n, hs, ws, c), device=self.device))
            else:
                z = self.noise_amps[s] * self._noise(generator, (n, hs, ws, c))
            x = x + self.generators[s](x + z)
        return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)

    def reconstruct(self) -> torch.Tensor:
        """The pyramid's fixed-noise reconstruction of the training image."""
        return self.sample(n=1, start_scale=len(self.shapes))

    @torch.no_grad()
    def harmonize(self, image, generator: Optional[torch.Generator] = None,
                  start_scale: int = 1, mask=None) -> torch.Tensor:
        """Editing, harmonisation and completion (the paper's §4): an edited
        image ((H, W, C) or (N, H, W, C) in [0, 1] at the finest resolution)
        is injected at ``start_scale`` and only the finer generators run
        over it. With a ``generator`` each scale adds noise drawn from it
        (without one the zero-noise path runs, as the JAX package's
        ``key=None``); ``mask`` (1 = edited) keeps the original outside
        it."""
        if not 0 <= start_scale < len(self.shapes):
            raise ValueError(f"start_scale must be in [0, {len(self.shapes) - 1}], "
                             f"got {start_scale}")
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        batched = x.dim() == 4
        if not batched:
            x = x[None]
        original = x
        x = _resize(x * 2.0 - 1.0, *self.shapes[start_scale])
        for s in range(start_scale, len(self.shapes)):
            x = _resize(x, *self.shapes[s])
            x_in = x if generator is None else \
                x + self.noise_amps[s] * self._noise(generator, x.shape)
            x = x + self.generators[s](x_in)
        out = torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)
        if mask is not None:
            m = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
            out = m * out + (1.0 - m) * original
        return out if batched else out[0]


def singan_step(gen: ConvStack, dsc: ConvStack, g_opt: torch.optim.Optimizer,
                d_opt: torch.optim.Optimizer, real: torch.Tensor, prev: torch.Tensor,
                z: torch.Tensor, prev_rec: torch.Tensor, z_rec: torch.Tensor,
                rec_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One iteration at a scale: a discriminator step on LSGAN's loss (real
    to 1, the detached fake to 0), then a generator step on the updated
    discriminator's adversarial loss plus ``rec_weight`` times the
    reconstruction MSE. Returns the generator's (loss, reconstruction MSE)
    as device scalars."""
    with torch.no_grad():
        fake = prev + gen(prev + z)
    d_loss = ((dsc(real) - 1.0) ** 2).mean() + (dsc(fake) ** 2).mean()
    d_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    d_opt.step()
    for p in dsc.parameters():
        p.requires_grad_(False)
    try:
        adv = ((dsc(prev + gen(prev + z)) - 1.0) ** 2).mean()
        rec = ((prev_rec + gen(prev_rec + z_rec) - real) ** 2).mean()
        g_loss = adv + rec_weight * rec
        g_opt.zero_grad(set_to_none=True)
        g_loss.backward()
        g_opt.step()
    finally:
        for p in dsc.parameters():
            p.requires_grad_(True)
    return g_loss.detach(), rec.detach()


def _adam(module: nn.Module, lr: float) -> torch.optim.Optimizer:
    return build_optimizer("adam", {"lr": lr, "betas": (0.5, 0.999)}, module.parameters())


def train_singan(image, n_scales: int = 3, steps_per_scale: int = 300, features: int = 32,
                 scale_factor: float = 0.5, min_size: int = 6, lr: float = 5e-4,
                 rec_weight: float = 10.0, seed: int = 0,
                 device: Union[None, str, torch.device] = None
                 ) -> Tuple[SinGAN, Dict[str, Any]]:
    """Train a SinGAN pyramid on one image (uint8, or float in [0, 1], HWC)
    on ``device`` (CUDA unless given). Returns ``(model, history)``;
    ``history["scales"]`` holds each scale's shape, noise amplitude and its
    first and last generator and reconstruction losses.

    Weights and the fixed coarsest noise come from a CPU generator seeded
    with ``seed``, each step's noise (times the scale's amplitude) from a
    generator on the device seeded with ``seed + 1``."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image))
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    img = (img * 2.0 - 1.0).to(dev)                      # tanh range
    h, w, c = img.shape[-3], img.shape[-2], img.shape[-1]
    shapes = pyramid_shapes(h, w, n_scales, scale_factor, min_size)
    reals = [_resize(img[None], hs, ws) for hs, ws in shapes]
    cpu_gen = torch.Generator().manual_seed(int(seed))
    rec_z0 = torch.randn((1, *shapes[0], c), generator=cpu_gen).to(dev)
    dev_gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)

    generators: List[ConvStack] = []
    noise_amps: List[float] = []
    history: Dict[str, Any] = {"scales": []}
    prev_rec = torch.zeros_like(reals[0])
    for s, (hs, ws) in enumerate(shapes):
        real = reals[s]
        prev_rec = _resize(prev_rec, hs, ws)
        # the noise amplitude: RMSE of the upsampled reconstruction (paper §3)
        amp = 1.0 if s == 0 else float(torch.sqrt(((real - prev_rec) ** 2).mean()))
        z_rec = rec_z0 if s == 0 else torch.zeros_like(real)
        gen = ConvStack(c, features, c, final_act="tanh")
        dsc = ConvStack(c, features, 1)
        gen.init_parameters(cpu_gen)
        dsc.init_parameters(cpu_gen)
        gen.to(dev)
        dsc.to(dev)
        g_opt, d_opt = _adam(gen, lr), _adam(dsc, lr)
        gls, recs = [], []
        for _ in range(steps_per_scale):
            z = amp * torch.randn(real.shape, generator=dev_gen, device=dev)
            gl, rec = singan_step(gen, dsc, g_opt, d_opt, real, prev_rec, z, prev_rec, z_rec,
                                  rec_weight)
            gls.append(gl)
            recs.append(rec)
        gls, recs = torch.stack(gls).tolist(), torch.stack(recs).tolist()
        gen.eval()
        for p in gen.parameters():
            p.requires_grad_(False)
        generators.append(gen)
        noise_amps.append(amp)
        history["scales"].append({"shape": (hs, ws), "noise_amp": amp,
                                  "g_loss_first": gls[0], "g_loss_last": gls[-1],
                                  "rec_first": recs[0], "rec_last": recs[-1]})
        with torch.no_grad():
            prev_rec = prev_rec + gen(prev_rec + z_rec)   # recon input of the next scale
        _logger.info("singan scale %d (%dx%d): rec %.4f -> %.4f", s, hs, ws, recs[0], recs[-1])
    return SinGAN(generators, noise_amps, shapes, features, rec_z0, channels=c), history


def distilled_singan_augmentation(image, n_variants: int = 8, start_scale: Optional[int] = None,
                                  generator: Optional[torch.Generator] = None,
                                  **train_kwargs) -> torch.Tensor:
    """Distil a per-image SinGAN and draw ``n_variants`` variants in [0, 1]
    at the image's finest pyramid resolution (by default from the second
    finest scale on, keeping the global layout)."""
    model, _ = train_singan(image, **train_kwargs)
    if start_scale is None:
        start_scale = max(1, len(model.shapes) - 2)
    return model.sample(n=n_variants, start_scale=start_scale, generator=generator)

"""Keypoints: the ``train_keypoint_detector`` autoencoder, keypoint
extraction, descriptor matching and AdaLAM-style match filtering.

Counterpart of ``deepcv_tpu/pipelines/keypoints.py`` (``Autoencoder``,
``create_autoencoder``, ``train_autoencoder``, ``extract_keypoints``,
``extract_dense_descriptors``, ``match_descriptors``,
``filter_matches_adalam``, ``get_pipelines``):

* an encoder and a decoder ``DeepcvModule`` trained jointly to reconstruct
  their input (``self_supervised_target: input``), the decoder ending in a
  norm-free 3x3 sigmoid conv to the input's channels;
* inference: keypoints as the top-k local maxima of a score map, dense
  unit-norm descriptors, mutual-nearest-neighbour matching by one batched
  matmul (a batch of image pairs at once), and AdaLAM's seeds,
  neighbourhoods and per-seed similarity RANSAC as fixed-shape tensor
  programs, every seed at once.

Rankings break ties by the lower index, as ``jax.lax.top_k`` does
(``ops/boxes.topk``): a map with fewer than k peaks ranks its ``-inf``
entries by index, and AdaLAM's uniform scores and masked Gumbel draws tie
often.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch.ops.boxes import topk
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, preprocess_node
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.losses import mse_loss
from deepcv_tpu_torch.train.training import train as train_fn

__all__ = ["Autoencoder", "create_autoencoder", "train_autoencoder", "extract_keypoints",
           "extract_dense_descriptors", "match_descriptors", "filter_matches_adalam",
           "get_pipelines"]


class Autoencoder(nn.Module):
    """An encoder and a decoder ``DeepcvModule`` in sequence, NHWC in and
    out. The code between them stays NCHW-logical in channels_last memory
    (no permute there and back). ``interop`` maps the JAX variables'
    top-level ``encoder`` and ``decoder`` onto :attr:`jax_parts`."""

    jax_parts = ("encoder", "decoder")

    def __init__(self, encoder: DeepcvModule, decoder: DeepcvModule):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.input_shape = encoder.input_shape

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def capacity(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder.module(self.encoder.module(x.movedim(-1, 1))).movedim(1, -1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's NHWC feature map."""
        return self.encoder(x)


def create_autoencoder(datasets, encoder_params: Mapping[str, Any],
                       decoder_params: Mapping[str, Any], device=None) -> Autoencoder:
    """The encoder on the dataset's images and the decoder on its output,
    the decoder's spec ending in a norm-free 3x3 conv with a sigmoid to the
    input's channels (a K2 conv; the sigmoid runs after the kernel)."""
    input_shape = datasets["trainset"].image_shape
    encoder = DeepcvModule(input_shape, copy.deepcopy(dict(encoder_params)), device=device)
    dec_hp = copy.deepcopy(dict(decoder_params))
    dec_hp.setdefault("architecture", []).append({"conv2d": {
        "kernel_size": [3, 3], "out_channels": input_shape[-1], "padding": 1,
        "act_fn": "sigmoid", **{t: None for t in ("batch_norm", "group_norm")}}})
    decoder = DeepcvModule(tuple(encoder.output_shape[1:]), dec_hp, device=device)
    return Autoencoder(encoder, decoder)


def train_autoencoder(datasets, model: Autoencoder, hp: Mapping[str, Any], trackers=()):
    hp = {**dict(hp), "self_supervised_target": "input"}
    state, history = train_fn(hp, model, mse_loss, datasets,
                              metrics={"reconstruction_mse": mse_loss}, loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


# --------------------------------------------------------------------------- #
# Keypoints, descriptors, matching
# --------------------------------------------------------------------------- #

def extract_keypoints(score_map: torch.Tensor, k: int = 64, nms_window: int = 3,
                      min_score: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k local maxima of a score map (N, H, W) or (N, H, W, 1) ->
    (coords (N, k, 2) as (y, x), scores (N, k)). A pixel is a peak when it
    is at least the max of its ``nms_window`` window (stride 1, 'SAME'
    padding with -inf, asymmetric for an even window as flax pads) and above
    ``min_score``; the rest score -inf and rank by index."""
    if score_map.dim() == 4:
        score_map = score_map[..., 0]
    n, h, w = score_map.shape
    lo = (nms_window - 1) // 2
    hi = nms_window - 1 - lo
    padded = F.pad(score_map[:, None], (lo, hi, lo, hi), value=float("-inf"))
    pooled = F.max_pool2d(padded, nms_window, stride=1)[:, 0]
    is_peak = (score_map >= pooled) & (score_map > min_score)
    masked = torch.where(is_peak, score_map, torch.full_like(score_map, float("-inf")))
    scores, idx = topk(masked.reshape(n, h * w), k)
    return torch.stack([idx // w, idx % w], dim=-1), scores


def extract_dense_descriptors(feature_map: torch.Tensor, l2_normalize: bool = True
                              ) -> torch.Tensor:
    """(N, H, W, C) feature maps -> (N, H*W, C) float32 descriptors, unit
    norm (plus 1e-8) with ``l2_normalize``."""
    n, h, w, c = feature_map.shape
    d = feature_map.reshape(n, h * w, c).float()
    if l2_normalize:
        d = d / (d.square().sum(-1, keepdim=True).sqrt() + 1e-8)
    return d


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, mutual: bool = True,
                      max_distance: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs matching of (..., A, C) against (..., B, C) descriptors (a
    batch of pairs in one ``bmm``): (index into b for each a, valid mask).
    Nearest by the largest dot product (the smallest distance for unit
    vectors); ``mutual`` keeps a pair only when each is the other's nearest;
    ``max_distance`` also bounds ``2 - 2 a.b``, the squared distance of unit
    vectors."""
    sim = desc_a @ desc_b.transpose(-1, -2)
    best_b = sim.argmax(-1)
    valid = torch.ones_like(best_b, dtype=torch.bool)
    if mutual:
        best_a = sim.argmax(-2)
        valid = best_a.gather(-1, best_b) == torch.arange(desc_a.shape[-2],
                                                          device=desc_a.device)
    if max_distance is not None:
        d2 = 2.0 - 2.0 * sim.gather(-1, best_b[..., None])[..., 0]
        valid = valid & (d2 <= max_distance ** 2)
    return best_b, valid


def _dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Euclidean distances as the square root of the summed squares of the
    differences (the JAX package's ``jnp.linalg.norm``; ``torch.cdist``
    takes a matmul form above 25 rows, which rounds otherwise)."""
    return (p - q).square().sum(-1).sqrt()


def filter_matches_adalam(coords_a: torch.Tensor, coords_b: torch.Tensor,
                          matches: torch.Tensor, valid: torch.Tensor,
                          scores: Optional[torch.Tensor] = None, *,
                          generator: Optional[torch.Generator] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          n_seeds: int = 32, n_hypotheses: int = 16,
                          seed_radius: float = 8.0, neighborhood_radius: float = 24.0,
                          inlier_tol: float = 3.0, min_inliers: int = 6) -> torch.Tensor:
    """AdaLAM-style outlier filtering of putative matches (arXiv:2006.04250)
    -> the refined (A,) mask, a subset of ``valid``.

    ``coords_a`` (A, 2) and ``coords_b`` (B, 2) keypoint positions,
    ``matches`` (A,) indices into b, ``valid`` (A,), ``scores`` (A,) match
    quality (uniform when None). (1) Seeds: the ``n_seeds`` best valid
    matches that are the best within ``seed_radius``; (2) each seed's
    neighbourhood: the valid matches within ``neighborhood_radius`` of it
    in both images; (3) per seed, ``n_hypotheses`` similarity transforms
    (2-point solver in complex numbers) from pairs of its neighbours drawn
    uniformly by the top 2 of Gumbel noise over the neighbourhood, the one
    with the most inliers (residual within ``inlier_tol`` times max(1,
    scale)) kept. A match survives as an inlier of a seed's best model with
    at least ``min_inliers``. Every seed runs at once.

    The Gumbel draws, shaped (S, T, A) with S = min(n_seeds, A), are
    ``gumbel`` when given (a test feeds the JAX package's own), else drawn
    from ``generator`` (a fresh one seeded 0 on the tensors' device)."""
    dev = coords_a.device
    a = coords_a.float()
    b = coords_b.float()[matches]
    n_a = a.shape[0]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    sc = torch.ones(n_a, device=dev) if scores is None else scores.float()
    sc = torch.where(valid, sc, neg_inf)

    # 1. seeds: valid matches that are the best within seed_radius
    near = _dist(a[:, None], a[None]) <= seed_radius
    local_best = sc >= torch.where(near, sc[None], neg_inf).amax(1)
    seed_score = torch.where(local_best & valid, sc, neg_inf)
    _, seed_idx = topk(seed_score, min(n_seeds, n_a))
    seed_ok = torch.isfinite(seed_score[seed_idx])

    # 2. neighbourhoods: close to the seed in both images
    neigh = ((_dist(a[seed_idx][:, None], a[None]) <= neighborhood_radius)
             & (_dist(b[seed_idx][:, None], b[None]) <= neighborhood_radius)
             & valid[None] & seed_ok[:, None])                              # (S, A)

    # 3. per-seed similarity RANSAC, every seed at once
    n_s = neigh.shape[0]
    if gumbel is None:
        gen = generator or torch.Generator(device=dev).manual_seed(0)
        u = torch.rand((n_s, n_hypotheses, n_a), generator=gen, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))
    elif tuple(gumbel.shape) != (n_s, n_hypotheses, n_a):
        raise ValueError(f"gumbel must be (seeds, hypotheses, matches) = "
                         f"{(n_s, n_hypotheses, n_a)}, got {tuple(gumbel.shape)}")
    g = torch.where(neigh[:, None, :], gumbel.to(dev, torch.float32), neg_inf)
    _, pick = topk(g, 2)                                                    # (S, T, 2)
    za = torch.complex(a[:, 0], a[:, 1])
    zb = torch.complex(b[:, 0], b[:, 1])
    p1, p2 = za[pick[..., 0]], za[pick[..., 1]]
    q1, q2 = zb[pick[..., 0]], zb[pick[..., 1]]
    dp = p2 - p1
    degenerate = dp.abs() < 1e-6
    alpha = (q2 - q1) / torch.where(degenerate, torch.ones_like(dp), dp)    # scale + rotation
    beta = q1 - alpha * p1
    resid = (alpha[..., None] * za + beta[..., None] - zb).abs()            # (S, T, A)
    tol = inlier_tol * alpha.abs().clamp(min=1.0)[..., None]
    inl = (resid <= tol) & neigh[:, None, :] & ~degenerate[..., None]
    counts = inl.sum(-1)                                                    # (S, T)
    best = counts.argmax(-1, keepdim=True)
    inliers = inl.gather(1, best[..., None].expand(-1, -1, n_a))[:, 0]      # (S, A)
    supported = counts.gather(1, best)[:, 0] >= min_inliers
    return (inliers & supported[:, None]).any(0) & valid


def get_pipelines() -> Dict[str, Pipeline]:
    return {"train_keypoint_detector": Pipeline([
        Node(preprocess_node, ["cifar10_train", "cifar10_test", "params:cifar10_preprocessing"],
             "datasets", name="preprocess"),
        Node(create_autoencoder, ["datasets", "params:keypoints_encoder_model",
                                  "params:keypoints_decoder_model", "device"],
             "model", name="create_autoencoder"),
        Node(train_autoencoder, ["datasets", "model", "params:train_keypoint_detector",
                                 "trackers"], "train_results", name="train"),
    ], name="train_keypoint_detector", tags={"train", "keypoints"})}

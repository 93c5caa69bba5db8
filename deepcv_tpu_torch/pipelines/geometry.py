"""Video stabilisation, homographies and stitching, sequence and audio
synchronisation, and watermark removal.

Counterpart of ``deepcv_tpu/pipelines/geometry.py``, whole, each built
from the port's own pieces:

* global translation by phase correlation (``torch.fft``'s real FFTs and
  one argmax; a batch of pairs at once);
* homographies by the normalised DLT (an SVD of the weighted 2N x 9
  system, ``H[2, 2]`` set to 1) inside a fixed-size RANSAC whose
  ``n_iters`` hypotheses are one batched solve; their point sets are the
  top-k of Gumbel noise drawn from a ``torch.Generator``, or given;
* frame warps through :func:`~deepcv_tpu_torch.pipelines.video.flow_warp`;
* time alignment by normalised cross-correlation of per-frame embeddings,
  every lag at once; audio as log band energies and spectral flux hopped at
  the video rate;
* a static semi-transparent watermark estimated from the clip's temporal
  mean and spread, and unblended.

They run on the device their inputs lie on.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepcv_tpu_torch.ops.boxes import topk
from deepcv_tpu_torch.pipelines.keypoints import extract_keypoints, match_descriptors
from deepcv_tpu_torch.pipelines.video import flow_warp

__all__ = ["phase_correlation", "stabilize_video", "estimate_homography",
           "ransac_homography", "ransac_sets", "stitch_pair", "synchronize_sequences",
           "audio_onset_envelope", "synchronize_audio", "remove_watermark"]


# --------------------------------------------------------------------------- #
# Global translation: phase correlation
# --------------------------------------------------------------------------- #

def phase_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The whole-pixel shift (dy, dx) with ``a[y, x] ~= b[y - dy, x - dx]``,
    for (H, W) images or (..., H, W) batches: the normalised cross-power
    spectrum's inverse, its argmax, peaks past half the size wrapped to
    negative shifts. float32 (..., 2)."""
    h, w = a.shape[-2:]
    fa = torch.fft.rfft2(a.float())
    fb = torch.fft.rfft2(b.float())
    r = fa * torch.conj(fb)
    r = r / (r.abs() + 1e-8)
    corr = torch.fft.irfft2(r, s=(h, w))
    idx = corr.reshape(*corr.shape[:-2], h * w).argmax(-1)
    dy, dx = idx // w, idx % w
    dy = torch.where(dy > h // 2, dy - h, dy)
    dx = torch.where(dx > w // 2, dx - w, dx)
    return torch.stack([dy, dx], -1).float()


def _moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Edge-replicated moving average along dim 0 of (T, D)."""
    pad, t = window // 2, x.shape[0]
    xp = torch.cat([x[:1].expand(pad, -1), x, x[-1:].expand(pad, -1)], 0)
    k = 1.0 / window
    return sum(xp[d:d + t] * k for d in range(window))


def stabilize_video(frames: torch.Tensor, smoothing: int = 9
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stabilise a (T, H, W, C) clip in [0, 1]: per-step translations by
    phase correlation of consecutive luma frames, their cumulative
    trajectory low-passed by a ``smoothing``-frame moving average, and each
    frame warped by (smoothed - actual). Returns (frames, trajectory (T, 2)
    as (dy, dx))."""
    t = frames.shape[0]
    luma = frames.float().mean(-1)
    steps = phase_correlation(luma[1:], luma[:-1])
    traj = torch.cat([torch.zeros((1, 2), device=frames.device), torch.cumsum(steps, 0)], 0)
    corr = _moving_average(traj, smoothing) - traj
    # backward warp: to move a frame by +corr, sample it at -corr
    flow = (-corr.flip(-1))[:, None, None, :].expand(t, *frames.shape[1:3], 2)
    return flow_warp(frames.float(), flow), traj


# --------------------------------------------------------------------------- #
# Homography: normalised DLT and batched RANSAC
# --------------------------------------------------------------------------- #

def _normalize_pts(p: torch.Tensor, w: torch.Tensor):
    """Hartley normalisation of (..., N, 2) points under weights (..., N):
    weighted zero mean, weighted mean distance sqrt(2)."""
    wsum = w.sum(-1) + 1e-8
    mean = (p * w[..., None]).sum(-2) / wsum[..., None]
    d = (p - mean[..., None, :]).square().sum(-1).sqrt()
    scale = math.sqrt(2.0) / ((d * w).sum(-1) / wsum + 1e-8)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack([torch.stack([scale, zero, -scale * mean[..., 0]], -1),
                     torch.stack([zero, scale, -scale * mean[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return (p - mean[..., None, :]) * scale[..., None, None], t


def estimate_homography(pts_a: torch.Tensor, pts_b: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DLT homography with ``pts_b ~ H @ pts_a`` from (..., N, 2) (x, y)
    points: weighted least squares by the SVD of the normalised 2N x 9
    system (a batch of systems in one call), denormalised, ``H[2, 2]``
    set to 1."""
    pts_a, pts_b = pts_a.float(), pts_b.float()
    w = torch.ones(pts_a.shape[:-1], device=pts_a.device) if weights is None \
        else weights.float()
    an, ta = _normalize_pts(pts_a, w)
    bn, tb = _normalize_pts(pts_b, w)
    x, y, u, v = an[..., 0], an[..., 1], bn[..., 0], bn[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    a = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    vh = torch.linalg.svd(a, full_matrices=False)[2]
    hn = vh[..., -1, :].reshape(*vh.shape[:-2], 3, 3)
    h = torch.linalg.inv(tb) @ hn @ ta
    return h / (h[..., 2:3, 2:3] + 1e-12)


def _reproj_err2(h: torch.Tensor, pts_a: torch.Tensor, pts_b: torch.Tensor) -> torch.Tensor:
    ones = torch.ones_like(pts_a[..., :1])
    proj = torch.cat([pts_a, ones], -1) @ h.transpose(-1, -2)
    proj = proj[..., :2] / (proj[..., 2:3] + 1e-12)
    return (proj - pts_b).square().sum(-1)


def ransac_sets(n: int, valid: Optional[torch.Tensor], generator: torch.Generator,
                n_iters: int = 128, sample_size: int = 6) -> torch.Tensor:
    """(n_iters, sample_size) point sets, each the top-k of Gumbel noise
    over the valid correspondences (uniform draws in [1e-6, 1))."""
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((n_iters, n), generator=generator,
                                          device=generator.device)
    gumbel = -torch.log(-torch.log(u))
    if valid is not None:
        gumbel = torch.where(valid.to(gumbel.device)[None], gumbel,
                             torch.full_like(gumbel, float("-inf")))
    return topk(gumbel, sample_size)[1]


def ransac_homography(pts_a: torch.Tensor, pts_b: torch.Tensor,
                      valid: Optional[torch.Tensor] = None, n_iters: int = 128,
                      threshold: float = 2.0, sample_size: int = 6,
                      generator: Optional[torch.Generator] = None,
                      sets: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Outlier-robust homography from (N, 2) (x, y) correspondences:
    ``n_iters`` hypotheses of ``sample_size`` points (6: a 4-point DLT is
    exactly determined and reprojects poorly in float32) solved and scored
    as one batch; the best (the first of the most inliers) is refit by
    least squares on its inliers, then once more on the refit's. ``sets``
    gives the hypotheses' points; else they are drawn from ``generator``
    (a seed-0 generator on the points' device when None). Returns (H,
    inlier mask)."""
    dev = pts_a.device
    n = pts_a.shape[0]
    v = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.to(dev)
    if sets is None:
        generator = generator or torch.Generator(device=dev).manual_seed(0)
        sets = ransac_sets(n, v, generator, n_iters, sample_size)
    sets = sets.to(dev)
    pts_a, pts_b = pts_a.float(), pts_b.float()
    hs = estimate_homography(pts_a[sets], pts_b[sets])
    inls = (_reproj_err2(hs, pts_a, pts_b) <= threshold ** 2) & v
    best = inls.sum(-1).argmax()
    h = estimate_homography(pts_a, pts_b, weights=inls[best].float())
    inliers = (_reproj_err2(h, pts_a, pts_b) <= threshold ** 2) & v
    h = estimate_homography(pts_a, pts_b, weights=inliers.float())
    inliers = (_reproj_err2(h, pts_a, pts_b) <= threshold ** 2) & v
    return h, inliers


# --------------------------------------------------------------------------- #
# Stitching
# --------------------------------------------------------------------------- #

def _harris_score(gray: torch.Tensor, k: float = 0.05) -> torch.Tensor:
    """Harris response of a (H, W) image, the structure tensor smoothed by
    a zero-padded 5x5 box ('same' ``convolve2d``)."""
    dy, dx = torch.gradient(gray)
    h, w = gray.shape

    def smooth(x):
        xp = torch.nn.functional.pad(x, (2, 2, 2, 2))
        return sum(xp[i:i + h, j:j + w] * 0.04 for i in range(5) for j in range(5))

    ixx, iyy, ixy = smooth(dx * dx), smooth(dy * dy), smooth(dx * dy)
    return ixx * iyy - ixy * ixy - k * (ixx + iyy) * (ixx + iyy)


def _patch_descriptors(gray: torch.Tensor, coords: torch.Tensor, patch: int = 7
                       ) -> torch.Tensor:
    """Centred, L2-normalised ``patch`` x ``patch`` patches of the
    edge-padded (H, W) image at (K, 2) (y, x) keypoints -> (K, patch^2)."""
    p = patch // 2
    gp = torch.nn.functional.pad(gray[None, None], (p, p, p, p), mode="replicate")[0, 0]
    ar = torch.arange(patch, device=gray.device)
    rows = coords[:, 0].long()[:, None, None] + ar[:, None]
    cols = coords[:, 1].long()[:, None, None] + ar[None, :]
    d = gp[rows, cols].reshape(len(coords), -1)
    d = d - d.mean(-1, keepdim=True)
    return d / (d.square().sum(-1, keepdim=True).sqrt() + 1e-8)


def stitch_pair(img_a: torch.Tensor, img_b: torch.Tensor, k: int = 128,
                threshold: float = 2.0, generator: Optional[torch.Generator] = None,
                sets: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stitch two overlapping (H, W, C) views in [0, 1]: Harris keypoints,
    patch descriptors, mutual nearest neighbours, the RANSAC homography
    a -> b, then b warped onto a's (H, 2W) canvas and feathered in.
    Returns (panorama, H_ab, inlier mask)."""
    img_a, img_b = img_a.float(), img_b.float()
    ga, gb = img_a.mean(-1), img_b.mean(-1)
    ca = extract_keypoints(_harris_score(ga)[None], k=k)[0][0]
    cb = extract_keypoints(_harris_score(gb)[None], k=k)[0][0]
    best_b, valid = match_descriptors(_patch_descriptors(ga, ca), _patch_descriptors(gb, cb),
                                      mutual=True)
    pts_a = ca.flip(-1).float()
    pts_b = cb[best_b].flip(-1).float()
    h_ab, inliers = ransac_homography(pts_a, pts_b, valid=valid, threshold=threshold,
                                      generator=generator, sets=sets)
    h, w, c = img_a.shape
    cw = 2 * w
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img_a.device),
                            torch.arange(cw, dtype=torch.float32, device=img_a.device),
                            indexing="ij")
    src = torch.stack([jj, ii, torch.ones_like(jj)], -1) @ h_ab.T
    sx = src[..., 0] / (src[..., 2] + 1e-12)
    sy = src[..., 1] / (src[..., 2] + 1e-12)
    flow = torch.stack([sx - jj, sy - ii], -1)[None]
    b_pad = torch.nn.functional.pad(img_b, (0, 0, 0, cw - w))
    bw = flow_warp(b_pad[None], flow)[0]
    b_mask = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)).float()[..., None]
    a_pad = torch.nn.functional.pad(img_a, (0, 0, 0, cw - w))
    a_mask = torch.nn.functional.pad(torch.ones((h, w, 1), device=img_a.device),
                                     (0, 0, 0, cw - w))
    wsum = a_mask + b_mask
    pano = torch.where(wsum > 0, (a_pad * a_mask + bw * b_mask) / (wsum + 1e-12),
                       torch.zeros_like(a_pad))
    return pano, h_ab, inliers


# --------------------------------------------------------------------------- #
# Synchronisation
# --------------------------------------------------------------------------- #

def _sync_scores(emb_a: torch.Tensor, emb_b: torch.Tensor, lags: torch.Tensor
                 ) -> torch.Tensor:
    def norm(e):
        e = e - e.mean(0, keepdim=True)
        return e / (e.square().sum(-1, keepdim=True).sqrt() + 1e-8)

    a, b = norm(emb_a.float()), norm(emb_b.float())
    ta, tb = a.shape[0], b.shape[0]
    pos = torch.arange(tb, device=a.device)[None, :] + lags[:, None]       # (L, tb)
    ok = (pos >= 0) & (pos < ta)
    sims = (a[pos.clamp(0, ta - 1)] * b[None]).sum(-1) * ok
    return sims.sum(-1) / (ok.sum(-1) + 1e-8)


def synchronize_sequences(emb_a: torch.Tensor, emb_b: torch.Tensor, max_lag: int = 16
                          ) -> Tuple[int, torch.Tensor]:
    """Temporal offset between two recordings from (T, D) per-frame
    embeddings: the lag in [-max_lag, max_lag] with ``b[t] ~ a[t + lag]``
    at the best normalised cross-correlation, and every lag's score."""
    lags = torch.arange(-max_lag, max_lag + 1, device=emb_a.device)
    scores = _sync_scores(emb_a, emb_b, lags)
    return int(lags[int(scores.argmax())]), scores


def _band_edges(n_bins: int, n_bands: int) -> np.ndarray:
    """The distinct ints of ``10 ** linspace(0, log10(n_bins - 1), n_bands +
    1)`` in float32 (``jnp.geomspace``'s arithmetic; at 2,049 bins its last
    edge rounds to 2,048 there and 2,047 here), padded with ``n_bins - 1``."""
    hi = float(torch.log10(torch.tensor(float(n_bins - 1))))
    lin = torch.linspace(0.0, hi, n_bands + 1, dtype=torch.float32)
    u = np.unique(torch.pow(torch.tensor(10.0), lin).to(torch.int32).numpy())
    return np.concatenate([u, np.full(n_bands + 1 - len(u), n_bins - 1, np.int32)])


def audio_onset_envelope(waveform: torch.Tensor, sample_rate: float, fps: float = 30.0,
                         n_fft: int = 1024, n_bands: int = 32) -> torch.Tensor:
    """Mono (T_samples,) or (T_samples, channels) waveform -> per-video-frame
    embedding (T_frames, 2 * n_bands): the log1p energies of ``n_bands``
    log-spaced bands of Hann-windowed ``n_fft`` frames hopped at the frame
    rate, and their half-wave-rectified differences (spectral flux)."""
    wav = torch.as_tensor(waveform, dtype=torch.float32)
    if wav.dim() == 2:
        wav = wav.mean(-1)
    hop = max(1, int(round(float(sample_rate) / float(fps))))
    n_frames = max(1, 1 + (wav.shape[0] - n_fft) // hop)
    if wav.shape[0] < n_fft:
        wav = torch.nn.functional.pad(wav, (0, n_fft - wav.shape[0]))
    idx = torch.arange(n_frames, device=wav.device)[:, None] * hop \
        + torch.arange(n_fft, device=wav.device)[None, :]
    window = torch.as_tensor(np.hanning(n_fft), dtype=torch.float32, device=wav.device)
    mag = torch.fft.rfft(wav[idx] * window, dim=-1).abs()
    n_bins = mag.shape[-1]
    edges = _band_edges(n_bins, n_bands)
    band = np.clip(np.searchsorted(edges[1:], np.arange(n_bins)), 0, n_bands - 1)
    energy = torch.zeros((mag.shape[0], n_bands), device=wav.device).index_add_(
        1, torch.as_tensor(band, device=wav.device), mag)
    log_e = torch.log1p(energy)
    flux = torch.clamp(torch.diff(log_e, dim=0, prepend=log_e[:1]), min=0.0)
    return torch.cat([log_e, flux], -1)


def synchronize_audio(wav_a: torch.Tensor, wav_b: torch.Tensor, sample_rate: float,
                      fps: float = 30.0, max_lag_s: float = 2.0
                      ) -> Tuple[int, float, torch.Tensor]:
    """Temporal offset between two soundtracks: ``(lag_frames, lag_seconds,
    scores)`` with :func:`synchronize_sequences`' convention."""
    emb_a = audio_onset_envelope(wav_a, sample_rate, fps=fps)
    emb_b = audio_onset_envelope(wav_b, sample_rate, fps=fps)
    max_lag = max(1, int(round(float(max_lag_s) * float(fps))))
    lag, scores = synchronize_sequences(emb_a, emb_b, max_lag=max_lag)
    return lag, lag / float(fps), scores


# --------------------------------------------------------------------------- #
# Watermark removal: I_t(x) = (1 - a(x)) J_t(x) + a(x) W(x), a and W static,
# the clean background's temporal mean and spread the same everywhere
# --------------------------------------------------------------------------- #

def _watermark_stats(frames: torch.Tensor, percentile: float, alpha_floor: float):
    m = frames.mean(0)
    s = frames.std(0, correction=0)
    c = s.shape[-1]
    sigma_hi = torch.quantile(s.reshape(-1, c), percentile / 100.0, dim=0)
    rough = 1.0 - (s / torch.clamp(sigma_hi, min=1e-8)).mean(-1)
    clean0 = (rough < 0.3)[..., None]
    sigma_j = (s * clean0).sum((0, 1)) / torch.clamp(clean0.sum((0, 1)), min=1.0)
    alpha = 1.0 - (s / torch.clamp(sigma_j, min=1e-8)).mean(-1)
    alpha = torch.clamp(alpha, 0.0, 0.95)
    alpha = torch.where(alpha < alpha_floor, torch.zeros_like(alpha), alpha)
    clean_mask = (alpha == 0.0)[..., None]
    mu_j = (m * clean_mask).sum((0, 1)) / torch.clamp(clean_mask.sum((0, 1)), min=1.0)
    alpha_w = m - (1.0 - alpha[..., None]) * mu_j
    alpha_w = torch.where(alpha[..., None] > 0.0, alpha_w, torch.zeros_like(alpha_w))
    return alpha, alpha_w


def remove_watermark(frames: torch.Tensor, alpha_floor: float = 0.25,
                     percentile: float = 90.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Estimate and remove a static semi-transparent watermark from a (T, H,
    W, C) clip in [0, 1]: the alpha matte from the ratio of each pixel's
    temporal spread to the clean background's (calibrated in two passes,
    seeded at the ``percentile`` of the spreads), mattes under
    ``alpha_floor`` zeroed, then each frame unblended. Returns
    ``(clean_frames, alpha (H, W), watermark (H, W, C))``."""
    frames = torch.as_tensor(frames).float()
    if frames.dim() != 4 or frames.shape[0] < 2:
        raise ValueError(f"expected (T>=2, H, W, C) frames, got {tuple(frames.shape)}")
    alpha, alpha_w = _watermark_stats(frames, float(percentile), float(alpha_floor))
    a = alpha[..., None]
    clean = torch.clamp((frames - alpha_w) / torch.clamp(1.0 - a, min=0.05), 0.0, 1.0)
    watermark = torch.where(a > 0.0, alpha_w / torch.clamp(a, min=1e-8),
                            torch.zeros_like(alpha_w))
    return clean, alpha, torch.clamp(watermark, 0.0, 1.0)

"""Classical keypoints: Harris and Shi-Tomasi corners, oriented BRIEF (ORB)
descriptors and Hamming matching, and the harness that scores any matcher
against a known homography.

Counterpart of ``deepcv_tpu/pipelines/classical_features.py``, whole. Every
function takes one image or a batch: a (H, W) image, or (N, H, W) images
with their keypoints (N, K, 2) as (y, x), run as one batched program
(bench.py config 4's classical half matches 64 pairs at once):

* the corner response from the box-smoothed structure tensor of central
  differences (``torch.gradient``, ``jnp.gradient``'s rule), the box as
  shifted adds over edge-padded rows and columns;
* keypoints through :func:`~deepcv_tpu_torch.pipelines.keypoints.extract_keypoints`,
  the learned detector's max-pool NMS and tie-breaking top-k;
* orientation from the intensity centroid in a disc, and BRIEF tests
  (numpy's ``default_rng(71)`` pattern, bit-equal to the JAX package's)
  rotated by it and sampled bilinearly on the blurred image; descriptors
  are ±1 so that Hamming distance is a matmul: ``hamming(a, b) = (D -
  a.b) / 2``, matched by
  :func:`~deepcv_tpu_torch.pipelines.keypoints.match_descriptors`.

A bit compares two bilinear samples, so a pair whose samples are equal up
to rounding may take either sign on another device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepcv_tpu_torch.pipelines.keypoints import extract_keypoints, match_descriptors

__all__ = ["harris_response", "detect_and_describe", "orb_descriptors", "orb_test_values",
           "intensity_orientations", "match_hamming", "matching_precision",
           "evaluate_matchers", "brief_pattern", "orb_matcher"]


def _batched(x: torch.Tensor, dims: int) -> Tuple[torch.Tensor, bool]:
    """``x`` with a leading batch dim, and whether one was added."""
    return (x[None], True) if x.dim() == dims else (x, False)


def _smooth(x: torch.Tensor, window: int) -> torch.Tensor:
    """Box-filter (N, H, W) maps: the mean of ``window`` edge-padded rows,
    then of ``window`` columns (``jnp.convolve`` with ``ones / window``)."""
    if window % 2 == 0:
        raise ValueError(f"smoothing window must be odd, got {window}")
    pad, h, w = window // 2, x.shape[-2], x.shape[-1]
    k = 1.0 / window
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x, x[:, -1:].expand(-1, pad, -1)], 1)
    x = sum(xp[:, d:d + h] * k for d in range(window))
    xp = torch.cat([x[..., :1].expand(-1, -1, pad), x, x[..., -1:].expand(-1, -1, pad)], 2)
    return sum(xp[..., d:d + w] * k for d in range(window))


def harris_response(gray: torch.Tensor, k: float = 0.05, window: int = 5,
                    method: str = "harris") -> torch.Tensor:
    """Corner response of (H, W) or (N, H, W) grey images: ``det(M) -
    k tr(M)^2`` (``harris``) or the smaller eigenvalue of M
    (``shi_tomasi``), M the ``window``-box-smoothed structure tensor."""
    if method not in ("harris", "shi_tomasi"):
        raise ValueError(f"unknown corner method '{method}' (harris|shi_tomasi)")
    g, single = _batched(gray, 2)
    dy, dx = torch.gradient(g, dim=(1, 2))
    ixx, iyy, ixy = _smooth(dx * dx, window), _smooth(dy * dy, window), \
        _smooth(dx * dy, window)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    out = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))) \
        if method == "shi_tomasi" else det - k * tr * tr
    return out[0] if single else out


def brief_pattern(n_tests: int = 256, patch_size: int = 31, seed: int = 71) -> np.ndarray:
    """The (n_tests, 2, 2) BRIEF test pattern as (dy, dx) offset pairs:
    Gaussian offsets (sigma patch / 5, BRIEF's G-II layout) from numpy's
    ``default_rng(seed)``, clipped to the patch radius."""
    rng = np.random.default_rng(seed)
    r = patch_size // 2
    pts = rng.normal(0.0, patch_size / 5.0, size=(n_tests, 2, 2))
    return np.clip(pts, -r, r)


def _bilinear_sample(gray: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample (N, H, W) images at float (N, ..., 2) (y, x) points, the
    points clamped to the image."""
    n, h, w = gray.shape
    y = torch.clamp(pts[..., 0], 0.0, h - 1.0)
    x = torch.clamp(pts[..., 1], 0.0, w - 1.0)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy, wx = y - y0, x - x0
    flat = gray.reshape(n, h * w)

    def at(yi, xi):
        return flat.gather(1, (yi * w + xi).reshape(n, -1)).reshape(yi.shape)

    return ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x1)
            + wy * (1 - wx) * at(y1, x0) + wy * wx * at(y1, x1))


def intensity_orientations(gray: torch.Tensor, coords: torch.Tensor,
                           radius: int = 4) -> torch.Tensor:
    """Per-keypoint orientation from the intensity centroid (ORB §3.2):
    ``atan2(m01, m10)`` over the disc of ``radius`` around each (y, x)
    keypoint of the edge-padded image; (K,) or (N, K) radians."""
    g, single = _batched(gray, 2)
    c = coords[None] if single else coords
    size = 2 * radius + 1
    n, h, w = g.shape
    gp = torch.nn.functional.pad(g[:, None], (radius,) * 4, mode="replicate")[:, 0]
    offs = torch.arange(size, dtype=g.dtype, device=g.device) - radius
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    disc = ((oy * oy + ox * ox) <= radius * radius).to(g.dtype)
    rows = c[..., 0].long()[..., None, None] + torch.arange(size, device=g.device)[:, None]
    cols = c[..., 1].long()[..., None, None] + torch.arange(size, device=g.device)[None, :]
    wp = w + 2 * radius
    patch = gp.reshape(n, -1).gather(1, (rows * wp + cols).reshape(n, -1)
                                     ).reshape(rows.shape[:2] + (size, size)) * disc
    m10 = (ox * patch).sum((-2, -1))
    m01 = (oy * patch).sum((-2, -1))
    out = torch.atan2(m01, m10)
    return out[0] if single else out


def orb_test_values(gray: torch.Tensor, coords: torch.Tensor,
                    orientations: Optional[torch.Tensor] = None, n_tests: int = 256,
                    patch_size: int = 31, blur_window: int = 3) -> torch.Tensor:
    """The two samples of every BRIEF test: (..., K, n_tests, 2), the
    blurred image sampled at both points of the pattern rotated by each
    keypoint's orientation (zero when None)."""
    g, single = _batched(gray, 2)
    c = coords[None] if single else coords
    pattern = torch.as_tensor(brief_pattern(n_tests, patch_size), dtype=g.dtype,
                              device=g.device)
    smoothed = _smooth(g, blur_window) if blur_window > 1 else g
    if orientations is None:
        theta = torch.zeros(c.shape[:2], dtype=g.dtype, device=g.device)
    else:
        theta = orientations[None] if single else orientations
    cs, sn = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    dy, dx = pattern[..., 0], pattern[..., 1]                         # (T, 2)
    ry = dx * sn + dy * cs                                            # (N, K, T, 2)
    rx = dx * cs - dy * sn
    base = c.to(g.dtype)[:, :, None, None, :]
    pts = torch.stack([base[..., 0] + ry, base[..., 1] + rx], -1)
    vals = _bilinear_sample(smoothed, pts)
    return vals[0] if single else vals


def orb_descriptors(gray: torch.Tensor, coords: torch.Tensor,
                    orientations: Optional[torch.Tensor] = None, n_tests: int = 256,
                    patch_size: int = 31, blur_window: int = 3) -> torch.Tensor:
    """Oriented-BRIEF descriptors at (K, 2) or (N, K, 2) (y, x) keypoints:
    (..., K, n_tests) of ±1, float32, +1 where a test's first sample
    (:func:`orb_test_values`) is the larger."""
    vals = orb_test_values(gray, coords, orientations, n_tests, patch_size, blur_window)
    return torch.where(vals[..., 0] > vals[..., 1], 1.0, -1.0).to(torch.float32)


def detect_and_describe(image: torch.Tensor, k: int = 256, n_tests: int = 256,
                        method: str = "harris", nms_window: int = 5,
                        orientation_radius: int = 4
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The classical pipeline on one (H, W[, C]) image or a batch (N, H, W,
    C): corner response -> NMS top-k -> orientations -> ORB descriptors.
    Returns coords (..., k, 2) as (y, x), descriptors (..., k, n_tests) of
    ±1 and valid (..., k): False rows are NMS slots below the threshold."""
    single = image.dim() < 4
    gray = image.float()
    gray = gray.mean(-1) if gray.dim() != 2 else gray
    gray = gray[None] if single else gray
    resp = harris_response(gray, method=method)
    coords, scores = extract_keypoints(resp, k=k, nms_window=nms_window)
    theta = intensity_orientations(gray, coords, radius=orientation_radius)
    desc = orb_descriptors(gray, coords, theta, n_tests=n_tests)
    valid = torch.isfinite(scores)
    if single:
        return coords[0], desc[0], valid[0]
    return coords, desc, valid


def match_hamming(desc_a: torch.Tensor, desc_b: torch.Tensor, mutual: bool = True,
                  max_hamming: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs Hamming matching of ±1 descriptors (a batch of pairs at
    once) by the dot-product matcher: for ``d / sqrt(D)`` vectors the
    largest dot product is the smallest Hamming distance, and
    ``max_hamming`` h bounds the distance by ``2 sqrt(h / D)``."""
    d = desc_a.shape[-1]
    scale = 1.0 / math.sqrt(d)
    max_distance = 2.0 * math.sqrt(max_hamming / d) if max_hamming is not None else None
    return match_descriptors(desc_a * scale, desc_b * scale, mutual=mutual,
                             max_distance=max_distance)


def matching_precision(coords_a: torch.Tensor, coords_b: torch.Tensor,
                       matches: torch.Tensor, valid: torch.Tensor, h_true: torch.Tensor,
                       tol: float = 3.0) -> Dict[str, torch.Tensor]:
    """Score matches against a ground-truth homography ``h_true`` (homogeneous
    (x, y, 1) of image a into image b): a match is correct when its b
    keypoint lies within ``tol`` pixels of the projected a keypoint.
    Returns n_matches, n_correct and precision (0-d, or (N,) for a batch)."""
    pa = coords_a.flip(-1).float()
    idx = matches[..., None].expand(*matches.shape, 2)
    pb = coords_b.gather(-2, idx).flip(-1).float()
    h = h_true.to(pa)
    proj = torch.cat([pa, torch.ones_like(pa[..., :1])], -1) @ h.transpose(-1, -2)
    proj = proj[..., :2] / (proj[..., 2:3] + 1e-12)
    err = (proj - pb).square().sum(-1).sqrt()
    correct = valid & (err <= tol)
    n_valid = valid.sum(-1)
    n_correct = correct.sum(-1)
    return {"n_matches": n_valid, "n_correct": n_correct,
            "precision": n_correct / torch.clamp(n_valid, min=1)}


def evaluate_matchers(img_a: torch.Tensor, img_b: torch.Tensor, h_true: torch.Tensor,
                      matchers: Mapping[str, Callable], tol: float = 3.0
                      ) -> Dict[str, Dict[str, float]]:
    """Run every matcher ``fn(img_a, img_b) -> (coords_a, coords_b,
    matches, valid)`` on the same pair and score it by
    :func:`matching_precision`."""
    out: Dict[str, Dict[str, float]] = {}
    for name, fn in matchers.items():
        ca, cb, m, v = fn(img_a, img_b)
        stats = matching_precision(ca, cb, m, v, h_true, tol=tol)
        out[name] = {k: float(val) for k, val in stats.items()}
    return out


def orb_matcher(k: int = 256, n_tests: int = 256, mutual: bool = True,
                max_hamming: Optional[int] = None) -> Callable:
    """The classical pipeline in :func:`evaluate_matchers`' form; it takes
    image pairs or batches of them."""
    def fn(img_a, img_b):
        ca, da, va = detect_and_describe(img_a, k=k, n_tests=n_tests)
        cb, db, vb = detect_and_describe(img_b, k=k, n_tests=n_tests)
        m, valid = match_hamming(da, db, mutual=mutual, max_hamming=max_hamming)
        return ca, cb, m, valid & va & vb.gather(-1, m)
    return fn

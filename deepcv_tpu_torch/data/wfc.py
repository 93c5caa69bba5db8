"""Wave Function Collapse: procedural tilemaps that satisfy adjacency
constraints, and the growing-grid tile learner that feeds it.

Counterpart of ``deepcv_tpu/data/wfc.py`` (``adjacency_from_exemplar``,
``wave_function_collapse``, ``sample_tilemaps``, ``validate_tilemap``,
``growing_grid``, ``learn_tiles``, ``render_tilemap``,
``generate_texture``), the simple-tiled model (Gumin's formulation):

* **Propagation is a batched product, not a worklist.** One sweep computes,
  for every cell and direction at once, ``support[d] = shift_d(wave) @
  A[d]^T`` (a ``(4, H*W, T) x (4, T, T)`` product in float32, exact on these
  0/1 counts) and intersects the four supports. Sweeps repeat to the
  fixpoint. The JAX package loops on the device (``lax.while_loop``); here
  the host checks the wave only every :data:`SWEEPS_PER_CHECK` sweeps: a
  sweep can only remove tiles and changes nothing at the fixpoint, so the
  extra sweeps give the same wave with fewer host syncs.
* **Observation**: the cell of least Shannon entropy of its allowed tiles'
  weights (ties broken by uniform noise of 1e-6), its tile drawn from the
  weights (Gumbel-max), then propagation. :func:`sample_tilemaps` runs
  ``n`` generations as one batch; lanes that end in a contradiction are
  drawn again, as the JAX package's retries do.
* :func:`growing_grid` (Fritzke's growing-grid SOM) runs its full-batch
  phases on the device with the JAX package's arithmetic; its start weights
  and the lattice's growth are the JAX package's numpy draws and rules, so
  it gives the JAX codebook. :func:`learn_tiles` and :func:`render_tilemap`
  are numpy.

Direction order everywhere: 0 = right (+col), 1 = left, 2 = down (+row),
3 = up. ``A[d][s, t]`` is True iff tile ``t`` may be the d-direction
neighbour of tile ``s``; consistency forces ``A[1] == A[0].T`` and ``A[3]
== A[2].T``. Random draws come from a ``torch.Generator`` (JAX's keys are
not reproduced); the constraints are checked by :func:`validate_tilemap`.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple, Union

import numpy as np
import torch

from deepcv_tpu_torch.utils import resolve_device

__all__ = ["adjacency_from_exemplar", "wave_function_collapse", "sample_tilemaps",
           "validate_tilemap", "growing_grid", "learn_tiles", "render_tilemap",
           "generate_texture", "propagate", "SWEEPS_PER_CHECK"]

_logger = logging.getLogger(__name__)

_OPPOSITE = (1, 0, 3, 2)
#: propagation sweeps between two host checks of the fixpoint
SWEEPS_PER_CHECK = 4

Device = Union[None, str, torch.device]


def adjacency_from_exemplar(exemplar: np.ndarray, n_tiles: Optional[int] = None,
                            wrap: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(adjacency (4, T, T) bool, weights (T,) float32) of an exemplar
    tile-index map: every neighbour pair it shows (and its mirror), and the
    tiles' frequencies. ``wrap`` also counts pairs across its borders."""
    ex = np.asarray(exemplar)
    if ex.ndim != 2:
        raise ValueError(f"exemplar must be 2-D tile indices, got {ex.shape}")
    if not np.issubdtype(ex.dtype, np.integer):
        raise ValueError("exemplar must hold integer tile indices")
    t_count = int(ex.max()) + 1 if n_tiles is None else int(n_tiles)
    if ex.min() < 0 or int(ex.max()) >= t_count:
        raise ValueError("exemplar indices out of [0, n_tiles) range")
    adj = np.zeros((4, t_count, t_count), dtype=bool)

    def _count(src: np.ndarray, dst: np.ndarray, d: int) -> None:
        adj[d][src.ravel(), dst.ravel()] = True
        adj[_OPPOSITE[d]][dst.ravel(), src.ravel()] = True

    if wrap:
        _count(ex, np.roll(ex, -1, axis=1), 0)
        _count(ex, np.roll(ex, -1, axis=0), 2)
    else:
        _count(ex[:, :-1], ex[:, 1:], 0)
        _count(ex[:-1, :], ex[1:, :], 2)
    weights = np.bincount(ex.ravel(), minlength=t_count).astype(np.float64)
    return adj, (weights / weights.sum()).astype(np.float32)


def _shifted_waves(wave: torch.Tensor, wrap: bool) -> torch.Tensor:
    """The 4 neighbour views of ``wave`` (N, H, W, T) -> (4, N, H, W, T);
    out-of-grid neighbours (without ``wrap``) impose nothing: all True."""
    if wrap:
        return torch.stack([wave.roll(-1, 2), wave.roll(1, 2), wave.roll(-1, 1),
                            wave.roll(1, 1)])
    n, h, w, t = wave.shape
    col = torch.ones((n, h, 1, t), dtype=wave.dtype, device=wave.device)
    row = torch.ones((n, 1, w, t), dtype=wave.dtype, device=wave.device)
    return torch.stack([torch.cat([wave[:, :, 1:], col], 2),
                        torch.cat([col, wave[:, :, :-1]], 2),
                        torch.cat([wave[:, 1:], row], 1),
                        torch.cat([row, wave[:, :-1]], 1)])


def _sweep(wave: torch.Tensor, adj_f32: torch.Tensor, wrap: bool) -> torch.Tensor:
    neigh = _shifted_waves(wave, wrap).to(torch.float32)
    support = torch.einsum("dnhwu,dtu->dnhwt", neigh, adj_f32) > 0.0
    return wave & support.all(0)


def propagate(wave: torch.Tensor, adj_f32: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Arc consistency to the fixpoint for a batch of waves (N, H, W, T)
    bool: tile ``t`` stays at a cell iff for every direction some tile
    ``u`` with ``A[d][t, u]`` is still possible at the neighbour."""
    while True:
        before = wave
        for _ in range(SWEEPS_PER_CHECK):
            wave = _sweep(wave, adj_f32, wrap)
        if torch.equal(wave, before):
            return wave


def _collapse(adj: torch.Tensor, weights: torch.Tensor, n: int, height: int, width: int,
              wrap: bool, generator: Optional[torch.Generator]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` generations at once: (grids (N, H, W) int64, ok (N,) bool)."""
    dev = weights.device
    t_count = weights.shape[0]
    adj_f32 = adj.to(torch.float32)
    log_w = torch.log(torch.clamp(weights, min=1e-30))
    wave = propagate(torch.ones((n, height, width, t_count), dtype=torch.bool, device=dev),
                     adj_f32, wrap)
    lanes = torch.arange(n, device=dev)
    while True:
        flat = wave.reshape(n, -1, t_count)
        counts = flat.sum(-1)
        active = (counts > 1).any(1) & (counts > 0).all(1)
        if not bool(active.any()):
            break
        w_allowed = weights * flat
        wsum = w_allowed.sum(-1)
        plogp = torch.where(flat, w_allowed * log_w, torch.zeros((), device=dev)).sum(-1)
        entropy = torch.log(wsum.clamp(min=1e-30)) - plogp / wsum.clamp(min=1e-30)
        entropy = entropy + torch.rand(entropy.shape, generator=generator, device=dev) * 1e-6
        entropy = torch.where(counts > 1, entropy, torch.full((), float("inf"), device=dev))
        cell = entropy.argmin(1)
        allowed = flat[lanes, cell]                                     # (N, T)
        gumbel = -torch.log(-torch.log(
            torch.rand((n, t_count), generator=generator, device=dev).clamp(min=1e-20)))
        tile = torch.where(allowed, log_w + gumbel,
                           torch.full((), float("-inf"), device=dev)).argmax(1)
        onehot = torch.nn.functional.one_hot(tile, t_count).bool()
        flat = flat.clone()
        flat[lanes, cell] = torch.where(active[:, None], onehot, allowed)
        wave = propagate(flat.reshape(n, height, width, t_count), adj_f32, wrap)
    ok = (wave.sum(-1) == 1).reshape(n, -1).all(1)
    return wave.to(torch.uint8).argmax(-1), ok


def _tensors(adjacency, weights, device: Device):
    dev = resolve_device(device)
    adj = torch.as_tensor(np.asarray(adjacency, dtype=bool), device=dev)
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=dev)
    if tuple(adj.shape) != (4, w.shape[0], w.shape[0]):
        raise ValueError(f"adjacency must be (4, T, T) with T={w.shape[0]}, "
                         f"got {tuple(adj.shape)}")
    return adj, w


def wave_function_collapse(adjacency: np.ndarray, weights: np.ndarray, shape: Tuple[int, int],
                           generator: Optional[torch.Generator] = None, wrap: bool = False,
                           max_restarts: int = 8, device: Device = None) -> np.ndarray:
    """One ``shape``-sized tilemap (int32) satisfying ``adjacency``, generated
    on ``device`` (CUDA unless given; ``generator`` must live there). On a
    contradiction it starts again, up to ``max_restarts`` times, then
    raises RuntimeError."""
    adj, w = _tensors(adjacency, weights, device)
    for attempt in range(max_restarts + 1):
        grid, ok = _collapse(adj, w, 1, int(shape[0]), int(shape[1]), bool(wrap), generator)
        if bool(ok[0]):
            return grid[0].cpu().numpy().astype(np.int32)
        _logger.info("wfc: contradiction, restart %d/%d", attempt + 1, max_restarts)
    raise RuntimeError(f"wave_function_collapse: contradiction after {max_restarts + 1} "
                       f"attempts — adjacency likely over-constrained for shape "
                       f"{tuple(shape)}")


def sample_tilemaps(adjacency: np.ndarray, weights: np.ndarray, shape: Tuple[int, int],
                    n: int, generator: Optional[torch.Generator] = None, wrap: bool = False,
                    max_restarts: int = 8, device: Device = None) -> np.ndarray:
    """``n`` tilemaps (N, H, W) int32 generated as one batch; the lanes that
    hit a contradiction are drawn again (only those), up to
    ``max_restarts`` times."""
    adj, w = _tensors(adjacency, weights, device)
    grids, ok = _collapse(adj, w, n, int(shape[0]), int(shape[1]), bool(wrap), generator)
    grids, ok = grids.cpu().numpy().astype(np.int32), ok.cpu().numpy()
    for _ in range(max_restarts):
        if ok.all():
            break
        retry_g, retry_ok = _collapse(adj, w, n, int(shape[0]), int(shape[1]), bool(wrap),
                                      generator)
        bad = ~ok
        grids[bad] = retry_g.cpu().numpy().astype(np.int32)[bad]
        ok[bad] = retry_ok.cpu().numpy()[bad]
    if not ok.all():
        raise RuntimeError(f"sample_tilemaps: {int((~ok).sum())}/{n} lanes still "
                           f"contradicted after {max_restarts} retries")
    return grids


def validate_tilemap(grid: np.ndarray, adjacency: np.ndarray, wrap: bool = False) -> bool:
    """True iff every neighbour pair in ``grid`` is allowed by ``adjacency``
    (the plain numpy oracle)."""
    g = np.asarray(grid)
    adj = np.asarray(adjacency, dtype=bool)
    if wrap:
        pairs = [(g, np.roll(g, -1, axis=1), 0), (g, np.roll(g, -1, axis=0), 2)]
    else:
        pairs = [(g[:, :-1], g[:, 1:], 0), (g[:-1, :], g[1:, :], 2)]
    return all(adj[d][a.ravel(), b.ravel()].all() for a, b, d in pairs)


# --------------------------------------------------------------------------- #
# Growing Grid tile learning
# --------------------------------------------------------------------------- #

def _som_phase(x: torch.Tensor, w0: np.ndarray, coords: np.ndarray, sig: float, steps: int,
               lr: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """``steps`` full-batch SOM updates on the device; returns (weights,
    the last step's per-unit errors, its mean quantisation error)."""
    coords = torch.as_tensor(coords, dtype=torch.float32, device=x.device)
    wk = torch.as_tensor(w0, dtype=torch.float32, device=x.device)
    xx = torch.sum(x * x, 1)[:, None]
    for _ in range(steps):
        d2 = xx + torch.sum(wk * wk, 1)[None] - 2.0 * x @ wk.T          # (N, K)
        bmu = d2.argmin(1)
        gd2 = torch.sum((coords[bmu][:, None, :] - coords[None, :, :]) ** 2, -1)
        h = torch.exp(-gd2 / (2.0 * sig * sig))
        num = h.T @ x
        hs = h.sum(0)
        den = torch.clamp(hs, min=1e-12)[:, None]
        # units with an empty neighbourhood keep their weights
        upd = torch.where(hs[:, None] > 1e-8, num / den, wk)
        wk = (1.0 - lr) * wk + lr * upd
        dmin = d2.min(1).values
        unit_err = torch.nn.functional.one_hot(bmu, wk.shape[0]).to(torch.float32).T @ dmin
        qe = dmin.mean()
    return wk.cpu().numpy(), unit_err.cpu().numpy(), float(qe)


def _coords(r: int, c: int) -> np.ndarray:
    return np.stack(np.meshgrid(np.arange(r), np.arange(c), indexing="ij"), -1).reshape(-1, 2)


def growing_grid(data: np.ndarray, *, initial: Tuple[int, int] = (2, 2), max_units: int = 16,
                 steps_per_phase: int = 30, lr: float = 0.5, sigma: float = 1.2, seed: int = 0,
                 finetune_sigmas: Tuple[float, ...] = (0.5, 0.2, 0.05),
                 device: Device = None) -> Tuple[np.ndarray, Tuple[int, int], list]:
    """Fit a growing-grid SOM to (N, D) data on ``device``.

    Returns (codebook (K, D) row-major over the final lattice, the lattice
    (R, C), each phase's mean quantisation error). Growth: constant
    ``sigma``, one row or column inserted after each phase between the unit
    of largest error and its neighbour of largest error (the mean of the
    two lines), until ``R * C >= max_units``; then ``finetune_sigmas``
    shrink the neighbourhood so units specialise."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    r, c = initial
    w = (x.mean(0).cpu().numpy()[None, :]
         + 0.01 * rng.standard_normal((r * c, d))).astype(np.float32)
    history: list = []
    while True:
        w, errs, qe = _som_phase(x, w, _coords(r, c), float(sigma), steps_per_phase, lr)
        history.append(qe)
        if r * c >= max_units:
            break
        e = int(np.argmax(errs))
        er, ec = divmod(e, c)
        nbrs = [(er + dr, ec + dc) for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0))
                if 0 <= er + dr < r and 0 <= ec + dc < c]
        fr, fc = max(nbrs, key=lambda rc: errs[rc[0] * c + rc[1]])
        grid_w = w.reshape(r, c, d)
        if fr == er:                                        # insert a column
            lo = min(ec, fc)
            new_col = 0.5 * (grid_w[:, lo] + grid_w[:, lo + 1])
            grid_w = np.concatenate([grid_w[:, :lo + 1], new_col[:, None],
                                     grid_w[:, lo + 1:]], axis=1)
            c += 1
        else:                                               # insert a row
            lo = min(er, fr)
            new_row = 0.5 * (grid_w[lo] + grid_w[lo + 1])
            grid_w = np.concatenate([grid_w[:lo + 1], new_row[None], grid_w[lo + 1:]], axis=0)
            r += 1
        w = grid_w.reshape(r * c, d)
    for sig in finetune_sigmas:
        w, _, qe = _som_phase(x, w, _coords(r, c), float(sig), steps_per_phase, lr)
        history.append(qe)
    return w, (r, c), history


def learn_tiles(image: np.ndarray, tile_size: int = 4, max_tiles: int = 12, seed: int = 0,
                device: Device = None, **gg_kw):
    """A tile vocabulary learned from one exemplar image: its non-overlapping
    ``tile_size`` patches -> growing-grid codebook -> nearest-codeword
    tilemap. Returns ``codebook`` (K, t, t, C), ``tilemap`` (H//t, W//t)
    int32, ``grid_shape`` and ``qe_history``."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    t = int(tile_size)
    if h % t or w % t:
        raise ValueError(f"image {h}x{w} not divisible by tile_size {t}")
    gh, gw = h // t, w // t
    patches = img.reshape(gh, t, gw, t, ch).transpose(0, 2, 1, 3, 4).reshape(gh * gw, t * t * ch)
    codebook, grid_shape, hist = growing_grid(patches, max_units=max_tiles, seed=seed,
                                              device=device, **gg_kw)
    d2 = (np.sum(patches ** 2, 1)[:, None] + np.sum(codebook ** 2, 1)[None]
          - 2.0 * patches @ codebook.T)
    tilemap = np.argmin(d2, 1).astype(np.int32).reshape(gh, gw)
    return {"codebook": codebook.reshape(-1, t, t, ch), "tilemap": tilemap,
            "grid_shape": grid_shape, "qe_history": hist}


def render_tilemap(tilemap: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """(gh, gw) tile indices + (K, t, t, C) codebook -> (gh*t, gw*t, C)."""
    tiles = np.asarray(codebook)[np.asarray(tilemap)]        # (gh, gw, t, t, C)
    gh, gw, t, _, ch = tiles.shape
    return tiles.transpose(0, 2, 1, 3, 4).reshape(gh * t, gw * t, ch)


def generate_texture(image: np.ndarray, out_tiles: Tuple[int, int],
                     generator: Optional[torch.Generator] = None, tile_size: int = 4,
                     max_tiles: int = 12, seed: int = 0, wrap: bool = False,
                     max_restarts: int = 8, device: Device = None) -> np.ndarray:
    """The whole chain: exemplar image -> growing-grid tiles -> the
    exemplar's adjacency -> a WFC tilemap of ``out_tiles`` (rows, cols) ->
    the rendered texture."""
    learned = learn_tiles(image, tile_size=tile_size, max_tiles=max_tiles, seed=seed,
                          device=device)
    adj, weights = adjacency_from_exemplar(learned["tilemap"], n_tiles=len(learned["codebook"]))
    grid = wave_function_collapse(adj, weights, out_tiles, generator, wrap=wrap,
                                  max_restarts=max_restarts, device=device)
    return render_tilemap(grid, learned["codebook"])

"""Hyperparameter tuners and the early-stop assessor, in-process.

Counterpart of ``deepcv_tpu/search/tuners.py``, copied (numpy only) so that
the port imports nothing of the JAX package: the same seed gives the same
suggestions.

  * :class:`RandomTuner` — uniform sampling from the space;
  * :class:`TPETuner` — Tree-structured Parzen Estimator (Bergstra et al.,
    NIPS 2011): models p(x|good) / p(x|bad) per dimension with Parzen windows
    over observed trials and maximizes expected improvement;
  * :class:`GridTuner` — exhaustive grid over choice/quantized domains;
  * :class:`MedianStopAssessor` — kill a trial whose best intermediate so far
    is below the median of completed trials' running averages at the same
    step (NNI Medianstop parity).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from deepcv_tpu_torch.hyperparams import HyperparameterSpace, HyperparamDomain

__all__ = ["RandomTuner", "TPETuner", "GridTuner", "MedianStopAssessor"]


class _BaseTuner:
    def __init__(self, space: HyperparameterSpace, seed: int = 0,
                 maximize: bool = True):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.maximize = maximize
        self.observations: List[Dict[str, Any]] = []  # {'params', 'value'}

    def suggest(self) -> Dict[str, Any]:
        raise NotImplementedError

    def observe(self, params: Mapping[str, Any], value: float):
        self.observations.append({"params": dict(params), "value": float(value)})


class RandomTuner(_BaseTuner):
    def suggest(self) -> Dict[str, Any]:
        return self.space.sample(self.rng)


class GridTuner(_BaseTuner):
    """Exhaustive grid; continuous domains are discretized to ``resolution``."""

    def __init__(self, space, seed: int = 0, maximize: bool = True,
                 resolution: int = 4):
        super().__init__(space, seed, maximize)
        axes = []
        for name, d in space.domains.items():
            if d.kind == "choice":
                axes.append([(name, v) for v in d.values])
            elif d.kind == "randint":
                lo, hi = int(d.values[0]), int(d.values[1])
                axes.append([(name, v) for v in range(lo, hi)])
            elif d.kind == "quniform":
                lo, hi = float(d.values[0]), float(d.values[1])
                q = float(d.values[2]) if len(d.values) > 2 else 1.0
                # clip like NNI quniform (rounding can escape [lo, hi])
                pts = np.unique(np.clip(np.round(
                    np.linspace(lo, hi, resolution) / q) * q, lo, hi))
                axes.append([(name, float(v)) for v in pts])
            else:
                lo, hi = float(d.values[0]), float(d.values[1])
                if d.kind == "loguniform":
                    pts = np.exp(np.linspace(np.log(lo), np.log(hi), resolution))
                else:
                    pts = np.linspace(lo, hi, resolution)
                axes.append([(name, float(v)) for v in pts])
        self._grid = itertools.cycle(itertools.product(*axes))

    def suggest(self) -> Dict[str, Any]:
        return dict(next(self._grid))


class TPETuner(_BaseTuner):
    """Tree-structured Parzen Estimator (simplified, per-dimension factored).

    After ``n_startup`` random trials, splits observations at the
    ``gamma``-quantile into good/bad sets, fits Parzen windows to each, draws
    ``n_ei_candidates`` from the good model and keeps the candidate maximizing
    l(x)/g(x).
    """

    def __init__(self, space, seed: int = 0, maximize: bool = True,
                 n_startup: int = 8, gamma: float = 0.25, n_ei_candidates: int = 24):
        super().__init__(space, seed, maximize)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_ei = n_ei_candidates

    def suggest(self) -> Dict[str, Any]:
        if len(self.observations) < self.n_startup:
            return self.space.sample(self.rng)
        obs = sorted(self.observations, key=lambda o: o["value"],
                     reverse=self.maximize)
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        good, bad = obs[:n_good], obs[n_good:]

        best_cand, best_score = None, -np.inf
        for _ in range(self.n_ei):
            cand = {}
            score = 0.0
            for name, dom in self.space.domains.items():
                v = self._sample_from(good, name, dom)
                cand[name] = v
                score += (self._log_density(good, name, dom, v)
                          - self._log_density(bad, name, dom, v))
            if score > best_score:
                best_cand, best_score = cand, score
        return best_cand

    # ------------------------------------------------------------ internals
    def _values(self, obs, name):
        return [o["params"][name] for o in obs if name in o["params"]]

    def _sample_from(self, obs, name, dom: HyperparamDomain):
        vals = self._values(obs, name)
        if not vals or self.rng.uniform() < 0.2:   # exploration mass
            return dom.sample(self.rng)
        center = vals[int(self.rng.integers(len(vals)))]
        if dom.kind == "choice":
            return center
        if dom.kind == "randint":
            lo, hi = int(dom.values[0]), int(dom.values[1])
            return int(np.clip(round(center + self.rng.normal() * max(1, (hi - lo) / 8)),
                               lo, hi - 1))
        lo, hi = float(dom.values[0]), float(dom.values[1])
        if dom.kind == "loguniform":
            lcenter = math.log(center)
            sigma = (math.log(hi) - math.log(lo)) / 8
            return float(np.clip(math.exp(lcenter + self.rng.normal() * sigma), lo, hi))
        sigma = (hi - lo) / 8
        v = float(np.clip(center + self.rng.normal() * sigma, lo, hi))
        if dom.kind == "quniform":
            q = float(dom.values[2]) if len(dom.values) > 2 else 1.0
            v = float(np.clip(np.round(v / q) * q, lo, hi))
        return v

    def _log_density(self, obs, name, dom: HyperparamDomain, v) -> float:
        vals = self._values(obs, name)
        if not vals:
            return 0.0
        if dom.kind == "choice":
            counts = sum(1 for x in vals if x == v) + 0.5
            return math.log(counts / (len(vals) + 0.5 * len(dom.values)))
        xs = np.asarray(vals, dtype=float)
        x = float(v)
        if dom.kind == "loguniform":
            xs = np.log(xs)
            x = math.log(max(v, 1e-300))
            span = math.log(float(dom.values[1])) - math.log(float(dom.values[0]))
        elif dom.kind == "randint":
            span = float(dom.values[1]) - float(dom.values[0])
        else:
            span = float(dom.values[1]) - float(dom.values[0])
        sigma = max(span / 8, 1e-12)
        dens = np.mean(np.exp(-0.5 * ((xs - x) / sigma) ** 2)) / (sigma * math.sqrt(2 * math.pi))
        return math.log(max(dens, 1e-300))


class MedianStopAssessor:
    """Early-stop rule (NNI Medianstop parity): stop a trial at step t when its
    best intermediate so far is strictly worse than the median of the running
    averages (up to step t) of all COMPLETED trials."""

    def __init__(self, maximize: bool = True, start_step: int = 2):
        self.maximize = maximize
        self.start_step = start_step
        self._completed: List[List[float]] = []

    def trial_end(self, intermediates: Sequence[float]):
        if intermediates:
            self._completed.append(list(intermediates))

    def should_stop(self, intermediates: Sequence[float]) -> bool:
        t = len(intermediates)
        if t < self.start_step or not self._completed:
            return False
        running_avgs = [float(np.mean(c[:t])) for c in self._completed if len(c) >= t]
        if not running_avgs:
            return False
        median = float(np.median(running_avgs))
        best = max(intermediates) if self.maximize else min(intermediates)
        return best < median if self.maximize else best > median

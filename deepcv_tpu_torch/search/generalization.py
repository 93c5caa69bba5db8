"""Generalization-across-scales prediction (arXiv:1909.12673).

Counterpart of ``deepcv_tpu/search/generalization.py``, copied (numpy and
scipy only) so that the port imports nothing of the JAX package: fit an
error-landscape envelope over (model-capacity m, trainset-size n,
best-val-error) observations from a handful of cheap small-subset trainings,
then predict the full-dataset error — so HP-search trials can be scored
without full training runs (``search.hp_search.scaling_prediction_trial``).

Functional form (paper eq. 4, the reference's envelope :156-172):

    eps(m, n) = eps0 * | e_mn / (e_mn - i*eta) |
    e_mn = a * n^(-alpha) + b * m^(-beta) + c_inf

with complex-magnitude divergence handling; fitted by least squares over the
log-error.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GeneralizationAcrossScalesPredictor"]

_logger = logging.getLogger(__name__)


class GeneralizationAcrossScalesPredictor:
    """Least-squares fit of the error-landscape envelope.

    Usage::

        pred = GeneralizationAcrossScalesPredictor()
        pred.fit(capacities=[...], trainset_sizes=[...], val_errors=[...])
        est = pred.predict(capacity=model_capacity, trainset_size=full_n)
    """

    def __init__(self):
        self.params: Optional[np.ndarray] = None  # (a, alpha, b, beta, c_inf, eta)

    @staticmethod
    def _envelope(theta: np.ndarray, m: np.ndarray, n: np.ndarray) -> np.ndarray:
        a, alpha, b, beta, c_inf, eta = theta
        e_mn = np.abs(a) * n ** (-np.abs(alpha)) + np.abs(b) * m ** (-np.abs(beta)) \
            + np.abs(c_inf)
        denom = np.sqrt(e_mn ** 2 + eta ** 2)  # |e - i*eta| with e real
        eps0 = 1.0
        return eps0 * e_mn ** 2 / np.maximum(denom, 1e-12)

    def fit(self, capacities: Sequence[float], trainset_sizes: Sequence[float],
            val_errors: Sequence[float]) -> "GeneralizationAcrossScalesPredictor":
        m = np.asarray(capacities, float)
        n = np.asarray(trainset_sizes, float)
        y = np.asarray(val_errors, float)
        if not (len(m) == len(n) == len(y)) or len(m) < 3:
            raise ValueError("fit() needs >= 3 aligned (capacity, size, error) triplets "
                             "(scaling_prediction_trial trains on 6 subsets by default)")
        from scipy.optimize import least_squares

        def residuals(theta):
            pred = self._envelope(theta, m, n)
            return np.log(np.maximum(pred, 1e-9)) - np.log(np.maximum(y, 1e-9))

        best = None
        for x0 in ([1.0, 0.5, 1.0, 0.5, 0.05, 0.01],
                   [0.5, 0.3, 0.5, 0.3, 0.01, 0.001],
                   [2.0, 0.7, 2.0, 0.7, 0.1, 0.1]):
            try:
                res = least_squares(residuals, x0, max_nfev=2000)
                if best is None or res.cost < best.cost:
                    best = res
            except Exception as e:  # noqa: BLE001 — another start may converge
                _logger.debug("ls fit from %s failed: %s", x0, e)
        if best is None:
            raise RuntimeError("envelope fit failed for all starts")
        self.params = best.x
        return self

    def predict(self, capacity: float, trainset_size: float) -> float:
        """Predicted validation ERROR at (capacity, trainset_size)."""
        if self.params is None:
            raise RuntimeError("fit() must run before predict()")
        return float(self._envelope(self.params,
                                    np.asarray([float(capacity)]),
                                    np.asarray([float(trainset_size)]))[0])

    def fit_from_subset_trainings(self, results: Sequence[Dict[str, Any]]
                                  ) -> "GeneralizationAcrossScalesPredictor":
        """Convenience: results = [{'capacity', 'trainset_size', 'val_error'}]."""
        return self.fit([r["capacity"] for r in results],
                        [r["trainset_size"] for r in results],
                        [r["val_error"] for r in results])

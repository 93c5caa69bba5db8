"""In-process hyperparameter-search runner.

Counterpart of ``deepcv_tpu/search/runner.py`` (``Trial``, ``SearchRunner``).
Trials run one after another in one process: the tuner suggests flat
dotted-name params (``model:...`` / ``training:...``), the trial function
trains and reports, and the runner appends each trial's record to
``<output_dir>/trials.jsonl`` and writes ``summary.json`` at the end. While a
trial runs, ``DEEPCV_SEARCH_EXPERIMENT`` (the output directory's name) and
``DEEPCV_SEARCH_TRIAL`` (its index) name it to the pipeline framework's
experiment tracker.

The JAX package also points XLA's persistent compilation cache at
``data/04_training/jit_cache`` (``persistent_jit_cache``). The port has no
compilation to keep: its kernels are built once by ``nvcc`` into
``deepcv_tpu_torch/_build/`` and every later trial and process loads them
from there. The argument is kept for the same call sites and changes
nothing.
"""
from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from deepcv_tpu_torch.hyperparams import HyperparameterSpace
from deepcv_tpu_torch.search.tuners import GridTuner, MedianStopAssessor, RandomTuner, TPETuner

__all__ = ["Trial", "SearchRunner"]

_logger = logging.getLogger(__name__)

TUNERS = {"tpe": TPETuner, "random": RandomTuner, "grid": GridTuner}


class Trial:
    """Handle passed to the trial function."""

    def __init__(self, trial_id: int, params: Dict[str, Any],
                 assessor: Optional[MedianStopAssessor]):
        self.trial_id = trial_id
        self.params = params
        self.intermediates: List[float] = []
        self.final: Optional[float] = None
        self._assessor = assessor
        self.stopped_early = False

    def report_intermediate_result(self, value: float):
        self.intermediates.append(float(value))

    def report_final_result(self, value: float):
        self.final = float(value)

    def should_stop(self) -> bool:
        """The median-stop decision, which the trial function may poll."""
        if self._assessor and self._assessor.should_stop(self.intermediates):
            self.stopped_early = True
            return True
        return False


class SearchRunner:
    """Run ``max_trials`` trials of ``trial_fn(params, trial) -> float|None``
    (the trial's value is its reported final result, else what it returns;
    a trial that raises is logged and recorded with value None)."""

    def __init__(self, space: HyperparameterSpace, trial_fn: Callable,
                 tuner: str = "tpe", max_trials: int = 20, maximize: bool = True,
                 seed: int = 0, use_assessor: bool = True,
                 output_dir="data/04_training/hp_search",
                 persistent_jit_cache: bool = True):
        self.space = space
        self.trial_fn = trial_fn
        if tuner not in TUNERS:
            raise ValueError(f"Unknown tuner '{tuner}' (tpe|random|grid)")
        self.tuner = TUNERS[tuner](space, seed=seed, maximize=maximize)
        self.assessor = MedianStopAssessor(maximize=maximize) if use_assessor else None
        self.max_trials = int(max_trials)
        self.maximize = maximize
        self.output_dir = Path(output_dir)
        del persistent_jit_cache    # the JAX package's; there is no cache to persist here

    def run(self) -> Dict[str, Any]:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        results = []
        best = None
        t_start = time.perf_counter()
        for i in range(self.max_trials):
            params = self.tuner.suggest()
            trial = Trial(i, params, self.assessor)
            os.environ["DEEPCV_SEARCH_EXPERIMENT"] = self.output_dir.name
            os.environ["DEEPCV_SEARCH_TRIAL"] = str(i)
            t0 = time.perf_counter()
            try:
                out = self.trial_fn(params, trial)
            except Exception as e:  # noqa: BLE001 — a failed trial is a record, not the end
                _logger.exception("trial %d failed: %s", i, e)
                out = None
            dt = time.perf_counter() - t0
            value = trial.final if trial.final is not None else out
            if value is not None:
                self.tuner.observe(params, float(value))
                if self.assessor:
                    self.assessor.trial_end(trial.intermediates or [float(value)])
            rec = {"trial": i, "params": params, "value": value,
                   "intermediates": trial.intermediates, "seconds": dt,
                   "stopped_early": trial.stopped_early}
            results.append(rec)
            if value is not None and (
                    best is None or
                    (value > best["value"] if self.maximize else value < best["value"])):
                best = rec
            _logger.info("trial %d/%d value=%s (%.1fs)%s", i + 1, self.max_trials,
                         value, dt, " [early-stopped]" if trial.stopped_early else "")
            with (self.output_dir / "trials.jsonl").open("a") as f:
                f.write(json.dumps(rec) + "\n")
        summary = {"best": best, "trials": results,
                   "total_seconds": time.perf_counter() - t_start}
        (self.output_dir / "summary.json").write_text(json.dumps(summary, indent=1))
        return summary

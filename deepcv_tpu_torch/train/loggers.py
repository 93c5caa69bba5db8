"""Metric and experiment logging sinks.

Counterpart of ``deepcv_tpu/train/loggers.py``: the loggers share one
interface, ``log_params(dict)``, ``log_metrics(dict, step)``,
``log_artifact(path)``, ``set_tags(dict)`` and ``flush()``.

* :class:`MetricsJsonlLogger` appends one JSON record a call to a file;
* :class:`TensorBoardLogger` writes scalars, histograms and the hparams
  table with ``torch.utils.tensorboard``, imported when it is constructed
  (it raises there when ``tensorboard`` is not installed);
* :class:`ExperimentTracker` is a file-based run store (``meta.json``,
  ``params.json``, ``metrics.jsonl``, ``artifacts/`` under
  ``<root>/<experiment>/<run_id>/``) with the JAX package's records, or
  mlflow's when mlflow is importable;
* :func:`git_metadata` gives the commit, branch and user tags.
"""
from __future__ import annotations

import json
import logging
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

__all__ = ["MetricsJsonlLogger", "TensorBoardLogger", "ExperimentTracker",
           "git_metadata"]

_logger = logging.getLogger(__name__)


def git_metadata(cwd: Optional[str] = None) -> Dict[str, str]:
    """Git commit, branch and user tags."""
    out = {}
    for tag, cmd in [("git_commit", ["git", "rev-parse", "HEAD"]),
                     ("git_branch", ["git", "rev-parse", "--abbrev-ref", "HEAD"]),
                     ("git_user", ["git", "config", "user.name"])]:
        try:
            v = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd,
                               timeout=5).stdout.strip()
            if v:
                out[tag] = v
        except Exception:
            pass
    return out


class MetricsJsonlLogger:
    """An append-only JSON-lines file of records."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a")

    def log_params(self, params: Mapping[str, Any]):
        self._f.write(json.dumps({"type": "params", "params": _jsonable(params)}) + "\n")

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0):
        self._f.write(json.dumps({"type": "metrics", "step": int(step),
                                  "time": time.time(),
                                  **{k: float(v) for k, v in metrics.items()}}) + "\n")

    def set_tags(self, tags: Mapping[str, str]):
        self._f.write(json.dumps({"type": "tags", "tags": dict(tags)}) + "\n")

    def log_artifact(self, path):
        self._f.write(json.dumps({"type": "artifact", "path": str(path)}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class TensorBoardLogger:
    """TensorBoard scalars, histograms and, on ``flush``, the hparams table
    of the logged params against the last metrics."""

    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter
        self.writer = SummaryWriter(str(log_dir))
        self._hparams: Dict[str, Any] = {}
        self._last_metrics: Dict[str, float] = {}

    def log_params(self, params: Mapping[str, Any]):
        self._hparams.update(_flatten(params))

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0):
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), int(step))
        self._last_metrics = {k: float(v) for k, v in metrics.items()}

    def log_histogram(self, name: str, values, step: int = 0):
        """A histogram of ``values`` (parameters at validation points)."""
        import numpy as np
        self.writer.add_histogram(name, np.asarray(values), int(step))

    def set_tags(self, tags: Mapping[str, str]):
        for k, v in tags.items():
            self.writer.add_text(f"tags/{k}", str(v))

    def log_artifact(self, path):
        pass

    def flush(self):
        if self._hparams and self._last_metrics:
            clean = {k: v for k, v in self._hparams.items()
                     if isinstance(v, (int, float, str, bool))}
            try:
                self.writer.add_hparams(clean, self._last_metrics)
            except Exception as e:
                _logger.debug("add_hparams failed: %s", e)
        self.writer.flush()

    def close(self):
        self.flush()
        self.writer.close()


class ExperimentTracker:
    """A file-based run store (mlflow's when mlflow is importable)::

        <root>/<experiment>/<run_id>/
            meta.json        run name, start and end time, status, tags
            params.json
            metrics.jsonl
            artifacts/
    """

    def __init__(self, root="data/04_training/experiments", experiment: str = "default",
                 run_name: Optional[str] = None):
        self._mlflow = None
        try:
            import mlflow
            self._mlflow = mlflow
            mlflow.set_tracking_uri(str(Path(root).absolute()))
            mlflow.set_experiment(experiment)
            self._run = mlflow.start_run(run_name=run_name)
            return
        except ImportError:
            pass
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.run_id = f"{run_name or 'run'}_{stamp}"
        self.dir = Path(root) / experiment / self.run_id
        (self.dir / "artifacts").mkdir(parents=True, exist_ok=True)
        self._meta = {"run_name": run_name or self.run_id, "experiment": experiment,
                      "start_time": time.time(), "tags": {}}
        self._metrics_f = (self.dir / "metrics.jsonl").open("a")
        self._params: Dict[str, Any] = {}
        self._write_meta()

    def _write_meta(self):
        (self.dir / "meta.json").write_text(json.dumps(self._meta, indent=1))

    def log_params(self, params: Mapping[str, Any]):
        if self._mlflow:
            self._mlflow.log_params(_flatten(params))
            return
        self._params.update(_flatten(params))
        (self.dir / "params.json").write_text(json.dumps(_jsonable(self._params),
                                                         indent=1))

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0):
        if self._mlflow:
            self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()},
                                     step=int(step))
            return
        self._metrics_f.write(json.dumps({"step": int(step), "time": time.time(),
                                          **{k: float(v) for k, v in metrics.items()}})
                              + "\n")

    def set_tags(self, tags: Mapping[str, str]):
        if self._mlflow:
            self._mlflow.set_tags(dict(tags))
            return
        self._meta["tags"].update({k: str(v) for k, v in tags.items()})
        self._write_meta()

    def log_artifact(self, path):
        if self._mlflow:
            self._mlflow.log_artifact(str(path))
            return
        import shutil
        src = Path(path)
        if src.is_dir():
            shutil.copytree(src, self.dir / "artifacts" / src.name,
                            dirs_exist_ok=True)
        elif src.exists():
            shutil.copy2(src, self.dir / "artifacts" / src.name)

    def flush(self):
        if not self._mlflow:
            self._metrics_f.flush()

    def end_run(self, status: str = "FINISHED"):
        if self._mlflow:
            self._mlflow.end_run(status=status)
            return
        self._meta["end_time"] = time.time()
        self._meta["status"] = status
        self._write_meta()
        self._metrics_f.close()


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


def _jsonable(obj):
    if isinstance(obj, Mapping):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return repr(obj)

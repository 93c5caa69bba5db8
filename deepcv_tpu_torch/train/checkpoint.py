"""Checkpoints: every-N-steps saves, best-k by a validation metric, resume.

Counterpart of ``deepcv_tpu/train/checkpoint.py`` (``CheckpointManager``
with ``restore_best``, ``resume_from_path``). The JAX package saves its whole ``TrainState`` with
orbax; here a checkpoint is one ``torch.save`` file holding what an exact
resume needs: the step, the model's and the optimizer's ``state_dict`` and
the state of the training loop's generator.

Layout::

    <dir>/steps/<step>.pt     periodic saves (the latest ``keep``)
    <dir>/best/<step>.pt      best-k by the tracked metric
    <dir>/best/index.json     metric values of the kept best checkpoints
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

__all__ = ["CheckpointManager", "resume_from_path"]


def _write(path: Path, state: Dict[str, Any]) -> None:
    """Atomic write: a reader never sees a half-written checkpoint."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Step checkpoints + best-k tracking in one directory."""

    def __init__(self, directory, keep: int = 3, best_k: int = 3, mode: str = "max"):
        self.dir = Path(directory)
        self.keep = int(keep)
        self.best_k = int(best_k)
        self.mode = mode
        self._best_dir = self.dir / "best"
        self._best_index_path = self._best_dir / "index.json"
        self._best: Dict[str, float] = {}
        if self._best_index_path.exists():
            self._best = json.loads(self._best_index_path.read_text())

    def steps(self):
        """Saved periodic steps, oldest first."""
        d = self.dir / "steps"
        return sorted(int(p.stem) for p in d.glob("*.pt")) if d.exists() else []

    def step_path(self, step: int) -> Path:
        return self.dir / "steps" / f"{int(step)}.pt"

    def save(self, step: int, state: Dict[str, Any]) -> Path:
        """Checkpoint at ``step``; keeps the latest ``keep`` periodic saves."""
        path = self.step_path(step)
        _write(path, state)
        for old in self.steps()[:-self.keep] if self.keep > 0 else ():
            self.step_path(old).unlink(missing_ok=True)
        return path

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        step = self.latest_step if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.dir / 'steps'}")
        return torch.load(self.step_path(step), map_location=map_location,
                          weights_only=False)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def update_best(self, step: int, metric_value: float, state: Dict[str, Any]) -> bool:
        """Save into best/ if the metric ranks in the top-k."""
        if self.best_k <= 0:
            return False
        if len(self._best) >= self.best_k:
            worst = min(self._best, key=lambda s: self._best[s] if self.mode == "max"
                        else -self._best[s])
            if not self._better(metric_value, self._best[worst]):
                return False
            (self._best_dir / f"{worst}.pt").unlink(missing_ok=True)
            del self._best[worst]
        _write(self._best_dir / f"{int(step)}.pt", state)
        self._best[str(int(step))] = float(metric_value)
        self._best_index_path.write_text(json.dumps(self._best))
        return True


    def best_checkpoints(self) -> Dict[str, float]:
        """Metric value of each kept best checkpoint, by step."""
        return dict(self._best)

    def restore_best(self, map_location=None) -> Dict[str, Any]:
        """The checkpoint of the best metric value kept."""
        if not self._best:
            raise FileNotFoundError(f"No best checkpoints recorded under {self._best_dir}")
        pick = max if self.mode == "max" else min
        step = pick(self._best, key=self._best.get)
        return torch.load(self._best_dir / f"{step}.pt", map_location=map_location,
                          weights_only=False)


def resume_from_path(path, map_location=None) -> Dict[str, Any]:
    """The checkpoint at ``path``: a ``.pt`` file, or a manager directory
    (its latest periodic save)."""
    p = Path(path)
    if p.is_dir():
        return CheckpointManager(p).restore(map_location=map_location)
    return torch.load(p, map_location=map_location, weights_only=False)

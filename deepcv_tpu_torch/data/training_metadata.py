"""Training metadata: the queryable record of what was trained on what.

Counterpart of ``deepcv_tpu/data/training_metadata.py``
(``TrainingMetaData``, ``DatasetStats``, ``Task``, ``Experiment``,
``MetaTracker``), copied so that the port imports nothing of the JAX
package: plain dataclasses kept as JSON lines under a store directory, the
rows the generalization predictor reads (:meth:`MetaTracker.scaling_triplets`).

``Experiment.model_capacity`` is the port model's ``capacity()``, which is
the JAX model's count less the zero kernel rows the JAX package adds where a
conv takes fewer than 8 input channels (``pad_channels_for_tpu``): a record
of the same spec carries a smaller capacity here (the conf's
``image_classifier`` at 32x32x3: 1,876 fewer, its four convs on 3 or 4
channels). ``model_spec_hash`` is the JAX package's hash.
"""
from __future__ import annotations

import dataclasses
import json
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

__all__ = ["TrainingMetaData", "DatasetStats", "Task", "Experiment", "MetaTracker"]


@dataclasses.dataclass
class TrainingMetaData:
    """Base record: every metadata entity has a UUID and a creation time."""
    uuid: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    created_at: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DatasetStats(TrainingMetaData):
    """Per-dataset statistics."""
    name: str = ""
    n_samples: int = 0
    image_shape: Sequence[int] = ()
    num_classes: Optional[int] = None
    per_channel_mean: Sequence[float] = ()
    per_channel_std: Sequence[float] = ()

    @classmethod
    def from_dataset(cls, dataset, compute_stats: bool = False) -> "DatasetStats":
        mean, std = (), ()
        if compute_stats:
            from deepcv_tpu_torch.data.preprocess import dataset_stats
            m, s = dataset_stats(dataset)
            mean, std = m.tolist(), s.tolist()
        return cls(name=dataset.name, n_samples=len(dataset),
                   image_shape=tuple(dataset.image_shape),
                   num_classes=dataset.num_classes,
                   per_channel_mean=mean, per_channel_std=std)


@dataclasses.dataclass
class Task(TrainingMetaData):
    """A (task type, dataset, objective) triple."""
    task_type: str = "classification"
    dataset_stats: Optional[DatasetStats] = None
    loss_name: str = ""
    metric_names: Sequence[str] = ()


@dataclasses.dataclass
class Experiment(TrainingMetaData):
    """One training run's summary."""
    task: Optional[Task] = None
    model_capacity: int = 0
    model_spec_hash: str = ""
    hyperparameters: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    final_metrics: Mapping[str, float] = dataclasses.field(default_factory=dict)
    trainset_size: int = 0
    steps: int = 0
    wall_time_s: float = 0.0


class MetaTracker:
    """Append-only JSON-lines store of experiments
    (``<store_dir>/experiments.jsonl``)."""

    def __init__(self, store_dir="data/04_training/metadataset"):
        self.dir = Path(store_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._path = self.dir / "experiments.jsonl"

    def store(self, experiment: Experiment):
        with self._path.open("a") as f:
            f.write(json.dumps(experiment.to_dict(), default=str) + "\n")

    def load_all(self) -> List[Dict[str, Any]]:
        if not self._path.exists():
            return []
        return [json.loads(line) for line in self._path.read_text().splitlines() if line]

    def reset(self):
        if self._path.exists():
            self._path.unlink()

    def scaling_triplets(self, metric: str = "valid_accuracy",
                         as_error: bool = True) -> List[Dict[str, float]]:
        """(capacity, trainset_size, val_error) rows for the generalization
        predictor; records without the metric, a capacity or a trainset
        size are skipped."""
        rows = []
        for e in self.load_all():
            v = e.get("final_metrics", {}).get(metric)
            if v is None or not e.get("model_capacity") or not e.get("trainset_size"):
                continue
            rows.append({"capacity": float(e["model_capacity"]),
                         "trainset_size": float(e["trainset_size"]),
                         "val_error": float(1.0 - v) if as_error else float(v)})
        return rows

    @staticmethod
    def experiment_from_training(model, hp: Mapping[str, Any], history: Mapping[str, Any],
                                 trainset, task_type: str = "classification",
                                 loss_name: str = "cross_entropy") -> Experiment:
        """The record of a ``train()`` run: its last validation metrics,
        steps and wall time from ``history``, the model's capacity and spec
        hash, the trainset's statistics."""
        from deepcv_tpu_torch.hyperparams import Hyperparameters
        final = dict(history.get("valid", [{}])[-1]) if history.get("valid") else {}
        final.pop("epoch", None)
        hp_obj = hp if isinstance(hp, Hyperparameters) else Hyperparameters(dict(hp))
        return Experiment(
            task=Task(task_type=task_type,
                      dataset_stats=DatasetStats.from_dataset(
                          getattr(trainset, "dataset", trainset)),
                      loss_name=loss_name),
            model_capacity=int(model.capacity()) if hasattr(model, "capacity") else 0,
            model_spec_hash=getattr(getattr(model, "hp", None), "spec_hash", lambda: "")(),
            hyperparameters=hp_obj.to_dict(),
            final_metrics=final,
            trainset_size=len(getattr(trainset, "dataset", trainset)),
            steps=int(history.get("steps", 0)),
            wall_time_s=float(history.get("total_time_s", 0.0)))

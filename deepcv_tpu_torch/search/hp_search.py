"""Cheap search trials by generalization-across-scales prediction, and
hyperparameter search over single-shot NAS.

Counterpart of ``deepcv_tpu/search/hp_search.py``
(``scaling_prediction_trial``, ``hp_search_over_nas``).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

from deepcv_tpu_torch.data.datasets import get_random_subset
from deepcv_tpu_torch.data.preprocess import PreprocessedDataset
from deepcv_tpu_torch.search.generalization import GeneralizationAcrossScalesPredictor

__all__ = ["scaling_prediction_trial", "hp_search_over_nas"]

_logger = logging.getLogger(__name__)


def scaling_prediction_trial(model, losses, datasets: Mapping[str, Any],
                             training_hp: Mapping[str, Any],
                             subset_fractions: Sequence[float] = (0.05, 0.1, 0.2,
                                                                  0.3, 0.4, 0.5),
                             metric: str = "valid_accuracy",
                             full_size: Optional[int] = None,
                             backend_conf=None, seed: int = 0) -> Dict[str, Any]:
    """Train ``model`` on growing random subsets of the trainset (subset i
    drawn with seed ``seed + i``), fit the error envelope
    (arXiv:1909.12673) to the validation errors and predict the error at
    ``full_size`` (the trainset's size by default). Every subset's run
    starts from the model's weights at the call, as every JAX run starts
    from the same init; the model keeps the last run's weights.

    Returns {'predicted_error', 'predicted_score', 'observations',
    'predictor'}."""
    from deepcv_tpu_torch.train.training import train

    trainset = datasets["trainset"]
    inner = getattr(trainset, "dataset", trainset)
    validset = datasets.get("validset", datasets.get("testset"))
    capacity = int(model.capacity()) if hasattr(model, "capacity") else 0
    full_size = int(full_size or len(inner))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    observations = []
    for i, frac in enumerate(subset_fractions):
        sub = get_random_subset(inner, float(frac), seed=seed + i)
        sub_pre = PreprocessedDataset(sub, transform=getattr(trainset, "transform", None),
                                      augmentation=getattr(trainset, "augmentation", None),
                                      target_transform=getattr(trainset, "target_transform",
                                                               None))
        hp = dict(training_hp)
        hp.setdefault("save_every_iters", 0)
        _, hist = train(hp, model, losses, {"trainset": sub_pre, "validset": validset},
                        backend_conf=backend_conf, init_variables=start)
        score = hist["valid"][-1].get(metric, 0.0) if hist["valid"] else 0.0
        observations.append({"capacity": float(capacity), "trainset_size": float(len(sub)),
                             "val_error": float(1.0 - score)})
        _logger.info("subset %.0f%% (%d samples): %s=%.4f", 100 * frac, len(sub), metric, score)

    predictor = GeneralizationAcrossScalesPredictor().fit_from_subset_trainings(observations)
    predicted_error = predictor.predict(capacity, full_size)
    return {"predicted_error": predicted_error, "predicted_score": 1.0 - predicted_error,
            "observations": observations, "predictor": predictor}


def hp_search_over_nas(input_shape, model_hp: Mapping[str, Any],
                       training_hp: Mapping[str, Any], losses,
                       datasets: Mapping[str, Any], space, *,
                       algorithm: str = "darts",
                       metric: str = "valid_accuracy", tuner: str = "tpe",
                       max_trials: int = 8, maximize: bool = True,
                       backend_conf=None, metrics=None,
                       output_dir="data/04_training/hp_over_nas",
                       seed: int = 0, **nas_kwargs) -> Dict[str, Any]:
    """A hyperparameter search whose every trial runs a whole single-shot
    NAS: the tuner samples ``model:``/``training:`` dotted overrides, the
    trial merges them into the supernet's spec and the training hp, runs
    :func:`~deepcv_tpu_torch.search.nas.single_shot_neural_architecture_search`
    (``algorithm``) and reports the searched supernet's validation
    ``metric``. ``space`` is a HyperparameterSpace or an NNI JSON path;
    ``nas_kwargs`` go to the NAS (``device`` among them). Returns the
    runner's summary plus ``architectures`` (trial -> exported
    architecture) and ``best['architecture']``."""
    from deepcv_tpu_torch.hyperparams import HyperparameterSpace, apply_dotted_overrides
    from deepcv_tpu_torch.search.nas import single_shot_neural_architecture_search
    from deepcv_tpu_torch.search.runner import SearchRunner

    if isinstance(space, (str, Path)):
        space = HyperparameterSpace.from_nni_json(str(space))
    architectures: Dict[int, Dict[str, Any]] = {}

    def trial_fn(params: Mapping[str, Any], trial):
        m_flat = {k: v for k, v in params.items() if k.startswith("model:")}
        t_flat = {k: v for k, v in params.items() if not k.startswith("model:")}
        m_hp = apply_dotted_overrides(dict(model_hp), m_flat)
        t_hp = apply_dotted_overrides(dict(training_hp), t_flat)
        t_hp.setdefault("save_every_iters", 0)
        arch, _state, hist = single_shot_neural_architecture_search(
            input_shape, m_hp, t_hp, losses, datasets, backend_conf=backend_conf,
            algorithm=algorithm, metrics=metrics, **nas_kwargs)
        architectures[trial.trial_id] = arch
        for v in hist.get("valid", []):
            trial.report_intermediate_result(float(v.get(metric, 0.0)))
        trial.report_final_result(float(hist["valid"][-1].get(metric, 0.0))
                                  if hist.get("valid") else 0.0)

    summary = SearchRunner(space, trial_fn, tuner=tuner, max_trials=max_trials,
                           maximize=maximize, seed=seed, output_dir=output_dir).run()
    summary["architectures"] = architectures
    if summary.get("best"):
        summary["best"]["architecture"] = architectures.get(summary["best"]["trial"])
    return summary

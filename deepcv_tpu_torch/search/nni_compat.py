"""NNI interop shims.

Counterpart of ``deepcv_tpu/search/nni_compat.py``, copied so that the port
imports nothing of the JAX package. It only reads environment variables and
writes NNI configs, so it needs no ``nni`` package:
  * mode detection: standalone or under a dispatcher, from NNI's ``NNI_*``
    variables or the in-process runner's ``DEEPCV_SEARCH_*`` ones;
  * :func:`sample_search_space` merges flat ``model:``/``training:`` dotted
    samples into nested hp dicts;
  * :func:`gen_nni_config` writes an NNI experiment config (TPE tuner,
    Medianstop assessor, trial command ``python -m deepcv_tpu_torch run
    --pipeline=<name>``) for the external NNI dispatcher;
  * :func:`experiment_and_trial`.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import yaml

from deepcv_tpu_torch.hyperparams import HyperparameterSpace, apply_dotted_overrides

__all__ = ["is_nni_run_standalone", "is_nni_gen_search_space_mode",
           "experiment_and_trial", "sample_search_space", "gen_nni_config"]


def is_nni_gen_search_space_mode() -> bool:
    """Whether NNI asks for its search space (``NNI_GEN_SEARCH_SPACE``)."""
    return bool(os.environ.get("NNI_GEN_SEARCH_SPACE"))


def is_nni_run_standalone() -> bool:
    """True when NOT running under any search dispatcher (the experiment is
    unset, empty or 'STANDALONE')."""
    exp = os.environ.get("NNI_EXP_ID", os.environ.get("DEEPCV_SEARCH_EXPERIMENT",
                                                      "STANDALONE"))
    return exp in ("", "STANDALONE")


def experiment_and_trial() -> Tuple[Optional[str], Optional[str]]:
    exp = os.environ.get("DEEPCV_SEARCH_EXPERIMENT") or os.environ.get("NNI_EXP_ID")
    trial = os.environ.get("DEEPCV_SEARCH_TRIAL") or os.environ.get("NNI_TRIAL_JOB_ID")
    if exp in ("STANDALONE", ""):
        return None, None
    return exp, trial


def sample_search_space(sampled: Mapping[str, Any],
                        model_hp: Mapping[str, Any],
                        training_hp: Mapping[str, Any]
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Merge a flat sample (``model:arch.x`` / ``training:optimizer_opts.lr``
    dotted names) into copies of the model/training hp dicts; unprefixed
    names go to the training hp."""
    model_flat = {k[len("model:"):]: v for k, v in sampled.items()
                  if k.startswith("model:")}
    training_flat = {k[len("training:"):]: v for k, v in sampled.items()
                     if k.startswith("training:")}
    unprefixed = {k: v for k, v in sampled.items() if ":" not in k}
    training_flat.update(unprefixed)  # unprefixed entries default to training
    return (apply_dotted_overrides(dict(model_hp), model_flat, strip_prefixes=()),
            apply_dotted_overrides(dict(training_hp), training_flat, strip_prefixes=()))


NNI_CONFIG_TEMPLATE: Dict[str, Any] = {
    "authorName": "deepcv_tpu_torch",
    "trainingServicePlatform": "local",
    "maxExecDuration": "24h",
    "maxTrialNum": 64,
    "trialConcurrency": 1,
    "tuner": {"builtinTunerName": "TPE",
              "classArgs": {"optimize_mode": "maximize"}},
    "assessor": {"builtinAssessorName": "Medianstop",
                 "classArgs": {"optimize_mode": "maximize"}},
}


def gen_nni_config(pipeline_name: str, search_space_path,
                   output_path=None, max_trials: int = 64,
                   gpu_or_tpu_num: int = 0) -> Dict[str, Any]:
    """Fill the per-pipeline NNI experiment YAML from the common template;
    written to ``output_path`` when given."""
    cfg = dict(NNI_CONFIG_TEMPLATE)
    cfg["experimentName"] = f"deepcv_tpu_torch_{pipeline_name}"
    cfg["maxTrialNum"] = int(max_trials)
    cfg["searchSpacePath"] = str(search_space_path)
    cfg["trial"] = {
        "command": f"python -m deepcv_tpu_torch run --pipeline={pipeline_name}",
        "codeDir": ".",
        "gpuNum": int(gpu_or_tpu_num),
    }
    if output_path is not None:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        Path(output_path).write_text(yaml.safe_dump(cfg, sort_keys=False))
    return cfg

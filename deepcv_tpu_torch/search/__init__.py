"""Hyperparameter search and neural-architecture search (counterpart of
``deepcv_tpu/search``)."""
from deepcv_tpu_torch.search.tuners import RandomTuner, TPETuner, GridTuner, MedianStopAssessor  # noqa: F401
from deepcv_tpu_torch.search.runner import SearchRunner, Trial  # noqa: F401
from deepcv_tpu_torch.search.nas import (  # noqa: F401
    list_mutables, sample_architecture, export_architecture,
    apply_fixed_architecture, arch_params_mask,
    single_shot_neural_architecture_search,
)
from deepcv_tpu_torch.search.generalization import GeneralizationAcrossScalesPredictor  # noqa: F401
from deepcv_tpu_torch.search.hp_search import scaling_prediction_trial, hp_search_over_nas  # noqa: F401
from deepcv_tpu_torch.search.nni_compat import (  # noqa: F401
    is_nni_run_standalone, gen_nni_config, sample_search_space,
)

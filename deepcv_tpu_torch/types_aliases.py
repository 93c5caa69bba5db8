"""Shared type aliases: the JAX package's ``deepcv_tpu/types_aliases.py``
names, with ``torch.Tensor`` where it has ``jax.Array``."""
from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Sequence, Union

import torch

__all__ = [
    "TENSOR_T", "TENSOR_OR_SEQ_OF_TENSORS_T", "PARAMS_T", "VARIABLES_T",
    "HYPERPARAMS_T", "LOSS_FN_T", "METRIC_FN_T", "ACT_FN_T",
    "SUBMODULE_CREATORS_DICT_T", "MODULE_OR_CALLBACK_T", "DATASET_T",
    "PATH_T", "SEED_T", "SCHEDULE_T", "PYTREE_T",
]

#: a device tensor
TENSOR_T = torch.Tensor

#: single tensor or a parallel-stream list (HRNet)
TENSOR_OR_SEQ_OF_TENSORS_T = Union[torch.Tensor, Sequence[torch.Tensor]]

#: parameters by name (a model's ``named_parameters()`` as a mapping)
PARAMS_T = Mapping[str, Any]

#: a model's ``state_dict`` (parameters and buffers)
VARIABLES_T = Mapping[str, Any]

#: hyperparameter mapping (dict or deepcv_tpu_torch.hyperparams.Hyperparameters)
HYPERPARAMS_T = Mapping[str, Any]

#: loss(logits, targets) -> scalar
LOSS_FN_T = Callable[..., torch.Tensor]

#: metric(logits, targets) -> scalar
METRIC_FN_T = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: activation function
ACT_FN_T = Callable[[torch.Tensor], torch.Tensor]

#: creator-name -> creator entry
SUBMODULE_CREATORS_DICT_T = Dict[str, Dict[str, Any]]

#: graph node implementation: nn.Module or ForwardCallback
MODULE_OR_CALLBACK_T = Any

#: any array-backed dataset
DATASET_T = Any

PATH_T = Union[str, Path]
SEED_T = Union[int, torch.Generator]
SCHEDULE_T = Callable[[int], float]
PYTREE_T = Any

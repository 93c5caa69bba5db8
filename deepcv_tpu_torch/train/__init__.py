"""Training runtime of the port: losses, metrics, schedules, the optimizer
builder, checkpoints and ``train()``; active learning, boosting and
Reptile meta-learning on top of it. The re-exports are the JAX package's
``deepcv_tpu/train/__init__.py``'s."""
from deepcv_tpu_torch.train.backend import BackendConfig  # noqa: F401
from deepcv_tpu_torch.train.losses import (  # noqa: F401
    cross_entropy_loss, label_smoothing_xentropy_loss,
    jensen_shannon_divergence_consistency_loss, triplet_margin_loss, WeightedLosses,
)
from deepcv_tpu_torch.train.schedules import build_schedule, one_cycle, piecewise_linear  # noqa: F401
from deepcv_tpu_torch.train.training import (  # noqa: F401
    train, TrainState, TRAINING_HP_DEFAULTS, Preempted, request_preemption,
)
from deepcv_tpu_torch.train.active_learning import active_learning_loop  # noqa: F401
from deepcv_tpu_torch.train.boosting import adaboost_train, BoostedEnsemble  # noqa: F401

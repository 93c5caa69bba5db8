"""Pipelines of the port: nodes, the project context and the classification
pipelines ``train_vit`` and ``train_resnet50``."""
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, ProjectContext  # noqa: F401

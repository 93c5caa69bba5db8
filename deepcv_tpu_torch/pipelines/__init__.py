"""Pipelines of the port: nodes, the project context and the task packages
``classification``, ``pose`` and ``segmentation`` (``registry.py``)."""
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, ProjectContext  # noqa: F401

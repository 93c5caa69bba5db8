"""Pipelines of the port: nodes, the project context and the six task
packages (``registry.py``), with the SORT tracker (``tracking.py``)."""
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, ProjectContext  # noqa: F401

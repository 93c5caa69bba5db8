"""Project pipeline registry.

Counterpart of ``deepcv_tpu/pipelines/registry.py`` (``create_pipelines``,
``TASK_PACKAGES``): the task packages' ``get_pipelines()`` in one mapping,
all six of the JAX package's.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Mapping, Optional

from deepcv_tpu_torch.pipelines.framework import Pipeline

__all__ = ["create_pipelines", "TASK_PACKAGES"]

#: built-in task packages, in the JAX package's registration order
TASK_PACKAGES = ("classification", "keypoints", "detection", "pose", "segmentation", "video")


def create_pipelines(plugins: Optional[Mapping[str, Any]] = None) -> Dict[str, Pipeline]:
    """Pipelines of the enabled task packages (the conf's ``plugins:``
    section: ``enabled``/``disabled`` lists)."""
    plugins = dict(plugins or {})
    unknown_keys = set(plugins) - {"enabled", "disabled", "extra_modules"}
    if unknown_keys:
        raise ValueError(f"Unknown plugins config key(s) {sorted(unknown_keys)}; "
                         "expected enabled / disabled / extra_modules")
    if plugins.get("extra_modules"):
        raise NotImplementedError("plugins 'extra_modules' are not ported yet")
    enabled = plugins.get("enabled")
    disabled = set(plugins.get("disabled") or ())
    for group in (enabled or (), disabled):
        bad = set(group) - set(TASK_PACKAGES)
        if bad:
            raise ValueError(f"Unknown task package(s) {sorted(bad)}")
    pipelines: Dict[str, Pipeline] = {}
    for pkg in TASK_PACKAGES:
        if (enabled is None or pkg in enabled) and pkg not in disabled:
            mod = importlib.import_module(f"deepcv_tpu_torch.pipelines.{pkg}")
            pipelines.update(mod.get_pipelines())
    return pipelines

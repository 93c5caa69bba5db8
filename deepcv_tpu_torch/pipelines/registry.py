"""Project pipeline registry.

Counterpart of ``deepcv_tpu/pipelines/registry.py`` (``create_pipelines``,
``TASK_PACKAGES``): the task packages' ``get_pipelines()`` in one mapping,
all six of the JAX package's, then those of the conf's ``plugins:
{extra_modules: [...]}`` (any importable module with a ``get_pipelines()``),
and ``__default__``, the union of them all in that order.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Mapping, Optional

from deepcv_tpu_torch.pipelines.framework import Pipeline

__all__ = ["create_pipelines", "TASK_PACKAGES"]

#: built-in task packages, in the JAX package's registration order
TASK_PACKAGES = ("classification", "keypoints", "detection", "pose", "segmentation", "video")


def create_pipelines(plugins: Optional[Mapping[str, Any]] = None) -> Dict[str, Pipeline]:
    """Pipelines of the enabled task packages and the extra modules (the
    conf's ``plugins:`` section: ``enabled``/``disabled`` lists of task
    packages, ``extra_modules``), plus ``__default__``."""
    plugins = dict(plugins or {})
    unknown_keys = set(plugins) - {"enabled", "disabled", "extra_modules"}
    if unknown_keys:
        raise ValueError(f"Unknown plugins config key(s) {sorted(unknown_keys)}; "
                         "expected enabled / disabled / extra_modules")
    enabled = plugins.get("enabled")
    disabled = set(plugins.get("disabled") or ())
    for group in (enabled or (), disabled):
        bad = set(group) - set(TASK_PACKAGES)
        if bad:
            raise ValueError(f"Unknown task package(s) {sorted(bad)}; built-in plugins: "
                             f"{TASK_PACKAGES} (external code goes in extra_modules)")
    modules = [importlib.import_module(f"deepcv_tpu_torch.pipelines.{pkg}")
               for pkg in TASK_PACKAGES
               if (enabled is None or pkg in enabled) and pkg not in disabled]
    modules += [importlib.import_module(str(m)) for m in plugins.get("extra_modules") or ()]
    pipelines: Dict[str, Pipeline] = {}
    for mod in modules:
        if not hasattr(mod, "get_pipelines"):
            raise ValueError(f"Plugin module '{mod.__name__}' has no get_pipelines()")
        for name, p in mod.get_pipelines().items():
            if name in pipelines:
                raise ValueError(f"Duplicate pipeline name '{name}'")
            pipelines[name] = p
    if pipelines:
        pipelines["__default__"] = Pipeline(
            [n for p in pipelines.values() for n in p.nodes], name="__default__",
            tags=set().union(*(p.tags for p in pipelines.values())))
    return pipelines

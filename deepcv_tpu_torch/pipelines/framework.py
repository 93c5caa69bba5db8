"""Minimal pipeline orchestration: nodes, pipelines and the project context.

Counterpart of ``deepcv_tpu/pipelines/framework.py`` (``Node``,
``Pipeline``, ``ProjectContext``, ``preprocess_node``,
``append_dense_head``): conf loading from
``conf/base`` and ``conf/local``, ``params:<dotted.path>`` inputs with
``--params`` overrides, catalog entries loaded by ``load_dataset``, nodes
run in order. Not ported yet: experiment trackers, partial runs and the
intermediate cache.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import torch

from deepcv_tpu_torch.config import ConfigLoader
from deepcv_tpu_torch.data.datasets import load_dataset
from deepcv_tpu_torch.hyperparams import apply_dotted_overrides
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["Node", "Pipeline", "ProjectContext", "preprocess_node", "append_dense_head"]

_logger = logging.getLogger(__name__)


def append_dense_head(hp: dict, name: str, out_channels: int, size) -> dict:
    """Append the dense-prediction head the pixel-level tasks share: a
    norm-free 1x1 ``conv2d`` to ``out_channels`` (a K2 conv) and a bilinear
    ``interpolate`` to ``size`` (segmentation class maps, pose heatmaps)."""
    hp["architecture"].extend([
        {"conv2d": [name, {"kernel_size": [1, 1], "out_channels": int(out_channels),
                           "padding": 0, "act_fn": None,
                           **{t: None for t in ("batch_norm", "group_norm", "layer_norm",
                                                "layer_nrm_and_mean_batch_nrm")}}]},
        {"interpolate": {"size": [int(v) for v in size]}},
    ])
    return hp


def preprocess_node(trainset, testset, params):
    """Catalog datasets -> ``data.preprocess.preprocess``."""
    from deepcv_tpu_torch.data.preprocess import preprocess
    return preprocess({"trainset": trainset, "testset": testset}, params)


class Node:
    """One pipeline step: ``fn(*inputs) -> outputs``. Inputs name catalog
    entries, earlier outputs, ``params:...`` paths or ``device``."""

    def __init__(self, fn: Callable, inputs: Sequence[str], outputs: Union[str, Sequence[str]],
                 name: Optional[str] = None, tags: Sequence[str] = ()):
        self.fn = fn
        self.inputs = list(inputs)
        self.outputs = [outputs] if isinstance(outputs, str) else list(outputs or [])
        self.name = name or getattr(fn, "__name__", "node")
        self.tags = set(tags)

    def __repr__(self):
        return f"Node({self.name}: {self.inputs} -> {self.outputs})"


class Pipeline:
    """An ordered list of nodes with tags."""

    def __init__(self, nodes: Sequence[Node], name: str = "pipeline", tags: Sequence[str] = ()):
        self.nodes = list(nodes)
        self.name = name
        self.tags = set(tags)

    def __repr__(self):
        return f"Pipeline({self.name}, nodes={[n.name for n in self.nodes]})"

    def describe(self) -> str:
        lines = [f"Pipeline '{self.name}' (tags: {sorted(self.tags)})"]
        lines += [f"  {n.name}: {n.inputs} -> {n.outputs}" for n in self.nodes]
        return "\n".join(lines)


class ProjectContext:
    """Loads the conf, resolves the catalog and runs a pipeline on ``device``
    (CUDA unless given)."""

    def __init__(self, project_path: Union[str, Path] = ".",
                 conf_paths: Optional[Sequence[Union[str, Path]]] = None,
                 extra_params: Optional[Mapping[str, Any]] = None,
                 device: Union[None, str, torch.device] = None):
        self.project_path = Path(project_path)
        conf_paths = conf_paths or [self.project_path / "conf" / "base",
                                    self.project_path / "conf" / "local"]
        self.config = ConfigLoader(conf_paths)
        self._extra_params = dict(extra_params or {})
        self.device = resolve_device(device)
        self._pipelines = None

    @property
    def pipelines(self):
        if self._pipelines is None:
            from deepcv_tpu_torch.pipelines.registry import create_pipelines
            self._pipelines = create_pipelines(self.params("plugins", None))
        return self._pipelines

    def params(self, dotted: str, default=None):
        """A parameter by dotted path, with the ``--params`` overrides below it."""
        if dotted in self._extra_params:
            return self._extra_params[dotted]
        v = self.config.get(dotted, default)
        if isinstance(v, Mapping):
            overrides = {k[len(dotted) + 1:]: val for k, val in self._extra_params.items()
                         if k.startswith(dotted + ".")}
            if overrides:
                v = apply_dotted_overrides(dict(v), overrides)
        return v

    def load_catalog_entry(self, name: str):
        entry = self.config.catalog.get(name)
        if entry is None:
            raise KeyError(f"Catalog entry '{name}' not found; known: "
                           f"{sorted(self.config.catalog)}")
        return load_dataset(entry, root=entry.get("root", "data/01_raw"),
                            train=bool(entry.get("train", True)))

    def _resolve_input(self, name: str, store: Mapping[str, Any]):
        if name in store:
            return store[name]
        if name.startswith("params:"):
            v = self.params(name[len("params:"):])
            if v is None:
                raise KeyError(f"Parameter '{name}' not found in conf")
            return v
        if name in self.config.catalog:
            return self.load_catalog_entry(name)
        raise KeyError(f"Input '{name}' is neither a prior node output, a catalog "
                       "entry nor a parameter")

    def run(self, pipeline_name: str) -> Dict[str, Any]:
        """Run a pipeline's nodes in order; returns the data store."""
        if pipeline_name not in self.pipelines:
            raise KeyError(f"Unknown pipeline '{pipeline_name}'; known: "
                           f"{sorted(self.pipelines)}")
        store: Dict[str, Any] = {"context": self, "device": self.device, "trackers": []}
        for node in self.pipelines[pipeline_name].nodes:
            args = [self._resolve_input(i, store) for i in node.inputs]
            t0 = time.perf_counter()
            out = node.fn(*args)
            _logger.info("node %s took %.2fs", node.name, time.perf_counter() - t0)
            if len(node.outputs) == 1:
                store[node.outputs[0]] = out
            else:
                store.update(zip(node.outputs, out))
        return store

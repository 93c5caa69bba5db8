"""Minimal pipeline orchestration: nodes, pipelines and the project context.

Counterpart of ``deepcv_tpu/pipelines/framework.py`` (``Node``,
``Pipeline``, ``ProjectContext``, ``preprocess_node``,
``append_dense_head``): conf loading from
``conf/base`` and ``conf/local``, ``params:<dotted.path>`` inputs with
``--params`` overrides, catalog entries loaded by ``load_dataset``, nodes
run in order. A partial run (``from_nodes``, ``to_nodes``, ``only_nodes``,
``tags``; :meth:`Pipeline.filter`) reads the inputs whose producing node
it leaves out from the intermediate cache, the pickled outputs that earlier
runs wrote under ``data/02_intermediate/<pipeline>/`` (the outputs some node
of the pipeline consumes; ``persist_intermediates=False`` neither writes
nor reads them). A pipeline tagged ``train`` runs with an
:class:`~deepcv_tpu_torch.train.loggers.ExperimentTracker` (git and
pipeline tags, the node list as params), passed to its nodes as
``trackers`` and closed with the run's status.
"""
from __future__ import annotations

import logging
import os
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import torch

from deepcv_tpu_torch.config import ConfigLoader
from deepcv_tpu_torch.data.datasets import load_dataset
from deepcv_tpu_torch.hyperparams import apply_dotted_overrides
from deepcv_tpu_torch.train.loggers import ExperimentTracker, git_metadata
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["Node", "Pipeline", "ProjectContext", "preprocess_node", "append_dense_head"]

_logger = logging.getLogger(__name__)


class _CacheUnpickler(pickle.Unpickler):
    """Loads an intermediate only from this package's, torch's and numpy's
    classes. The JAX package keeps its intermediates at the same path of a
    project, and loading one of those would import it (and JAX) here."""

    _MODULES = ("deepcv_tpu_torch", "torch", "numpy", "collections", "copyreg", "_codecs")
    _BUILTINS = {"set", "frozenset", "slice", "complex", "range", "bytearray", "object"}

    def __init__(self, f, path: Path):
        super().__init__(f)
        self.path = path

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in self._MODULES or (module == "builtins" and name in self._BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the intermediate cache {self.path} holds {module}.{name}, which is not of "
            "deepcv_tpu_torch, torch or numpy (a file another package wrote?): run the "
            "producing node again with this package, or pass --no-persist")


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

    def filter(self, from_nodes: Sequence[str] = (), to_nodes: Sequence[str] = (),
               only_nodes: Sequence[str] = (), tags: Sequence[str] = ()) -> "Pipeline":
        """The nodes a partial run keeps: from the first of ``from_nodes``,
        up to the last of ``to_nodes``, only ``only_nodes``, only nodes
        carrying one of ``tags``; the filters compose. An unknown node name
        or an empty selection raises."""
        names = [n.name for n in self.nodes]
        for ref in (*from_nodes, *to_nodes, *only_nodes):
            if ref not in names:
                raise KeyError(f"Pipeline '{self.name}' has no node '{ref}'; nodes: {names}")
        keep = self.nodes
        if from_nodes:
            start = min(names.index(r) for r in from_nodes)
            keep = [n for n in keep if names.index(n.name) >= start]
        if to_nodes:
            stop = max(names.index(r) for r in to_nodes)
            keep = [n for n in keep if names.index(n.name) <= stop]
        if only_nodes:
            keep = [n for n in keep if n.name in only_nodes]
        if tags:
            keep = [n for n in keep if n.tags & set(tags)]
        if not keep:
            raise ValueError(f"Node selection left pipeline '{self.name}' empty "
                             f"(from={list(from_nodes)}, to={list(to_nodes)}, "
                             f"only={list(only_nodes)}, tags={list(tags)})")
        return Pipeline(keep, name=self.name, tags=self.tags)


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
        self._persist_dir: Optional[Path] = None
        self._persist_names: set = set()

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
        if self._persist_dir is not None and (self._persist_dir / f"{name}.pkl").exists():
            path = self._persist_dir / f"{name}.pkl"
            _logger.info("input '%s' loaded from the intermediate cache %s", name, path)
            with open(path, "rb") as f:
                return _CacheUnpickler(f, path).load()
        raise KeyError(
            f"Input '{name}' is neither a prior node output, a catalog entry, nor a "
            "persisted intermediate"
            + ("" if self._persist_dir is None else f" (looked in {self._persist_dir})")
            + " — run the producing node first (partial runs reuse data/02_intermediate/)")

    def intermediate_dir(self, pipeline_name: str) -> Path:
        return self.project_path / "data" / "02_intermediate" / pipeline_name

    def _persist_output(self, name: str, value: Any) -> None:
        if self._persist_dir is None or name not in self._persist_names:
            return
        path = self._persist_dir / f"{name}.pkl"
        tmp = path.with_suffix(f".pkl.{os.getpid()}.tmp")
        try:
            self._persist_dir.mkdir(parents=True, exist_ok=True)
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            tmp.replace(path)
        except Exception as e:  # unpicklable outputs, a read-only data dir, ...
            _logger.debug("intermediate '%s' not persisted (%s)", name, e)
            tmp.unlink(missing_ok=True)

    @staticmethod
    def _search_trial_run_name() -> Optional[str]:
        """The run name of the active search trial, ``<experiment>_<trial>``
        (the in-process runner's ``DEEPCV_SEARCH_*`` variables, or NNI's),
        or None outside a search."""
        exp = os.environ.get("DEEPCV_SEARCH_EXPERIMENT") or os.environ.get("NNI_EXP_ID")
        trial = os.environ.get("DEEPCV_SEARCH_TRIAL") or os.environ.get("NNI_TRIAL_JOB_ID")
        if exp and exp != "STANDALONE":
            return f"{exp}_{trial or 'trial'}"
        return None

    def run(self, pipeline_name: str, loggers: Sequence[Any] = (),
            from_nodes: Sequence[str] = (), to_nodes: Sequence[str] = (),
            only_nodes: Sequence[str] = (), tags: Sequence[str] = (),
            persist_intermediates: bool = True) -> Dict[str, Any]:
        """Run a pipeline's nodes (or a selection of them) in order; returns
        the data store."""
        if pipeline_name not in self.pipelines:
            raise KeyError(f"Unknown pipeline '{pipeline_name}'; known: "
                           f"{sorted(self.pipelines)}")
        pipeline = self.pipelines[pipeline_name]
        self._persist_names = {i for n in pipeline.nodes for i in n.inputs}
        if from_nodes or to_nodes or only_nodes or tags:
            pipeline = pipeline.filter(from_nodes=from_nodes, to_nodes=to_nodes,
                                       only_nodes=only_nodes, tags=tags)
            _logger.info("partial run: nodes %s", [n.name for n in pipeline.nodes])
        self._persist_dir = self.intermediate_dir(pipeline_name) if persist_intermediates \
            else None
        tracker = None
        if "train" in pipeline.tags:
            tracker = ExperimentTracker(experiment=pipeline.name,
                                        run_name=self._search_trial_run_name() or pipeline.name)
            tracker.set_tags({**git_metadata(str(self.project_path)), "pipeline": pipeline.name})
            tracker.log_params({"pipeline_nodes": [n.name for n in pipeline.nodes]})
        store: Dict[str, Any] = {"context": self, "device": self.device,
                                 "trackers": [tracker, *loggers] if tracker else list(loggers)}
        status = "FINISHED"
        try:
            for node in pipeline.nodes:
                args = [self._resolve_input(i, store) for i in node.inputs]
                t0 = time.perf_counter()
                out = node.fn(*args)
                _logger.info("node %s took %.2fs", node.name, time.perf_counter() - t0)
                outs = [out] if len(node.outputs) == 1 else list(out) if node.outputs else []
                for name, value in zip(node.outputs, outs):
                    store[name] = value
                    self._persist_output(name, value)
            return store
        except Exception:
            status = "FAILED"
            raise
        finally:
            if tracker:
                tracker.end_run(status)

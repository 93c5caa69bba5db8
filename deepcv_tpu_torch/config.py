"""YAML config loading with SAFE registry-based object tags.

Counterpart of ``deepcv_tpu/config.py`` (``ConfigError``, ``TaggedFactory``,
the safe ``!py!`` loader, ``load_yaml(..., registry=)``), copied so that the
port imports nothing of the JAX package. ``!py!name`` resolves through
:mod:`deepcv_tpu_torch.utils`'s registry — strings map to registered
factories, never to ``eval``. A tagged scalar with an argument mapping
becomes a :class:`TaggedFactory` carrying the kwargs.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping, Optional, Union

import yaml

from deepcv_tpu_torch.utils import Registry, get_by_identifier

__all__ = ["TaggedFactory", "load_yaml", "ConfigError"]


class ConfigError(ValueError):
    """A named, typed configuration error (bad parameter value/path — e.g. a
    CLI ``--params`` override that nulls a structurally-required key). The
    CLI maps these to a one-line message and exit code 2 instead of a raw
    traceback (reference analogue: kedro's typed config errors,
    kedro_cli.py:122-141)."""


# Reference YAML used torch/torchvision/ignite dotted names; map them onto our
# registered equivalents so the reference's own parameter files load unchanged.
REFERENCE_NAME_ALIASES = {
    "torch.nn.ReLU": "relu",
    "torch.nn.LeakyReLU": "leaky_relu",
    "torch.nn.Sigmoid": "sigmoid",
    "torch.nn.Tanh": "tanh",
    "torch.nn.GELU": "gelu",
    "torch.nn.SiLU": "silu",
    "torch.nn.Identity": "identity",
    "torch.nn.Flatten": "flatten",
    "torchvision.transforms.ToTensor": "to_tensor",
    "torchvision.transforms.Normalize": "normalize",
    "torchvision.transforms.RandomCrop": "random_crop",
    "torchvision.transforms.RandomHorizontalFlip": "random_horizontal_flip",
    "torchvision.transforms.Resize": "resize",
    "torchvision.transforms.CenterCrop": "center_crop",
    "torchvision.transforms.ColorJitter": "color_jitter",
    "ignite.contrib.handlers.PiecewiseLinear": "piecewise_linear",
    "deepcv.meta.one_cycle.OneCyclePolicy": "one_cycle",
}


class TaggedFactory:
    """A lazily-applied ``!py!`` tag: identifier + optional kwargs.

    Consumers call :meth:`resolve` to get the underlying registered object, or
    :meth:`build` to call it with merged kwargs.
    """

    def __init__(self, identifier: str, kwargs: Optional[Mapping[str, Any]] = None,
                 registry: Optional[Registry] = None):
        self.identifier = identifier
        self.kwargs = dict(kwargs or {})
        self._registry = registry

    def resolve(self) -> Any:
        ident = REFERENCE_NAME_ALIASES.get(self.identifier, self.identifier)
        return get_by_identifier(ident, self._registry)

    def build(self, **extra):
        obj = self.resolve()
        kw = {**self.kwargs, **extra}
        return obj(**kw) if kw else (obj() if callable(obj) and _wants_call(obj) else obj)

    def __repr__(self):
        return f"TaggedFactory({self.identifier!r}, {self.kwargs!r})"

    def __eq__(self, other):
        return (isinstance(other, TaggedFactory)
                and other.identifier == self.identifier and other.kwargs == self.kwargs)

    def __hash__(self):
        return hash((self.identifier, tuple(sorted(self.kwargs))))


def _wants_call(obj) -> bool:
    """Classes get instantiated on build(); plain functions are returned as-is."""
    return isinstance(obj, type)


class _SafeTagLoader(yaml.SafeLoader):
    pass


def _py_tag_constructor(loader: _SafeTagLoader, tag_suffix: str, node: yaml.Node):
    if isinstance(node, yaml.ScalarNode):
        val = loader.construct_scalar(node)
        # the reference's `!py!X "": {kwargs}` puts kwargs in a sibling mapping;
        # a bare scalar tag has no kwargs
        if val in ("", None):
            return TaggedFactory(tag_suffix)
        return TaggedFactory(tag_suffix)  # scalar value ignored (always "")
    if isinstance(node, yaml.MappingNode):
        kwargs = loader.construct_mapping(node, deep=True)
        return TaggedFactory(tag_suffix, kwargs)
    if isinstance(node, yaml.SequenceNode):
        seq = loader.construct_sequence(node, deep=True)
        return TaggedFactory(tag_suffix, {"args": seq})
    raise yaml.constructor.ConstructorError(None, None, f"Bad !py! node: {node}")


# Accept the reference's full tag URIs and a short local form.
for _prefix in ("tag:yaml.org,2002:python/name:",
                "tag:yaml.org,2002:python/object:",
                "!py!", "!pyobj!"):
    _SafeTagLoader.add_multi_constructor(_prefix, _py_tag_constructor)

_TAG_DIRECTIVE_RE = re.compile(r"^%TAG\s+!\w+!\s+\S+\s*$", re.MULTILINE)


def load_yaml(path_or_text: Union[str, Path], registry: Optional[Registry] = None) -> Any:
    """Load YAML safely; ``!py!``/``!pyobj!`` tags become :class:`TaggedFactory`.

    Accepts a filesystem path or raw YAML text. Handles the reference's
    ``%YAML 1.2`` + ``%TAG`` prologue (parameters.yml:1-3) by honoring the tag
    handles without unsafe construction.
    """
    s = str(path_or_text)
    is_pathlike = isinstance(path_or_text, Path) or ("\n" not in s and len(s) < 4096)
    text = Path(s).read_text() if (is_pathlike and Path(s).exists()) else s
    # declare the !py!/!pyobj! tag handles when the document doesn't
    if ("!py!" in text or "!pyobj!" in text) and "%TAG" not in text:
        text = ("%TAG !py! tag:yaml.org,2002:python/name:\n"
                "%TAG !pyobj! tag:yaml.org,2002:python/object:\n"
                "---\n" + text)
    docs = [d for d in yaml.load_all(text, Loader=_SafeTagLoader) if d is not None]
    if not docs:
        return {}
    return docs[0] if len(docs) == 1 else docs

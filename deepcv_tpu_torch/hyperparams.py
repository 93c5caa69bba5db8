"""Frozen hyperparameter mapping with required/default semantics.

Counterpart of ``deepcv_tpu/hyperparams.py`` (``Hyperparameters``,
``to_hyperparameters``, ``merge_hyperparameters``, ``HyperparamDomain``,
``HyperparameterSpace``, ``apply_dotted_overrides``), copied so that the
port imports nothing of the JAX package. A default value of ``...``
(Ellipsis) marks a required key.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Hyperparameters", "to_hyperparameters", "merge_hyperparameters",
           "HyperparamDomain", "HyperparameterSpace", "apply_dotted_overrides"]


class Hyperparameters(Mapping):
    """Immutable, hashable-by-content mapping of hyperparameters.

    ``hp.with_defaults(defaults)`` returns ``(hp_with_defaults, missing_hps)``
    where ``defaults`` values of ``...`` flag required parameters; missing
    required names are returned so callers can raise
    (reference training_metadata.py:108-118).
    """

    def __init__(self, *args, **kwargs):
        self._store: Dict[str, Any] = dict(*args, **kwargs)

    # --- Mapping protocol -------------------------------------------------
    def __getitem__(self, k):
        return self._store[k]

    def __iter__(self):
        return iter(self._store)

    def __len__(self):
        return len(self._store)

    def __repr__(self):
        return f"Hyperparameters({self._store!r})"

    # --- reference API ----------------------------------------------------
    def with_defaults(self, defaults: Mapping[str, Any]) -> Tuple["Hyperparameters", list]:
        merged = dict(defaults)
        merged.update(self._store)
        missing = [k for k, v in merged.items() if v is ...]
        for k in missing:
            merged.pop(k)
        return Hyperparameters(merged), missing

    def to_dict(self) -> Dict[str, Any]:
        """Deep-ish copy as a plain mutable dict."""
        def conv(v):
            if isinstance(v, Hyperparameters):
                return v.to_dict()
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(conv(x) for x in v)
            return v
        return {k: conv(v) for k, v in self._store.items()}

    def spec_hash(self) -> str:
        """Stable content hash, the JAX package's (the same hex digits for the
        same hp): the key of a model spec in the training metadata."""
        import hashlib

        def default(o):
            return getattr(o, "__qualname__", None) or repr(o)

        blob = json.dumps(self.to_dict(), sort_keys=True, default=default)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def to_hyperparameters(hp: Union[Mapping, Hyperparameters],
                       defaults: Optional[Mapping[str, Any]] = None,
                       raise_if_missing: bool = True,
                       ) -> Union[Hyperparameters, Tuple[Hyperparameters, list]]:
    """Convert a dict to :class:`Hyperparameters`, applying ``defaults``.

    Mirrors reference ``deepcv.meta.hyperparams.to_hyperparameters``
    (hyperparams.py:229-248): with ``defaults`` given, returns
    ``(hp, missing)`` and raises if a required (``...``) key is absent.
    """
    if not isinstance(hp, Hyperparameters):
        hp = Hyperparameters(hp)
    if defaults is None:
        return hp
    hp, missing = hp.with_defaults(defaults)
    if missing and raise_if_missing:
        raise ValueError(f"Missing required hyperparameter(s): {missing}")
    return hp, missing


def merge_hyperparameters(*dicts: Mapping[str, Any]) -> Hyperparameters:
    """Recursively merge mappings (later wins), returning Hyperparameters."""
    def rec(a, b):
        out = dict(a)
        for k, v in b.items():
            if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
                out[k] = rec(out[k], v)
            else:
                out[k] = v
        return out

    acc: Dict[str, Any] = {}
    for d in dicts:
        acc = rec(acc, dict(d))
    return Hyperparameters(acc)


class HyperparamDomain:
    """One searchable hyperparameter domain, as in NNI's search-space JSON:
    ``choice``, ``uniform``, ``loguniform``, ``quniform`` or ``randint``."""

    KINDS = ("choice", "uniform", "loguniform", "quniform", "randint")

    def __init__(self, kind: str, values: Sequence[Any]):
        if kind not in self.KINDS:
            raise ValueError(f"Unknown domain kind '{kind}', expected one of {self.KINDS}")
        self.kind = kind
        self.values = list(values)

    @classmethod
    def from_nni(cls, spec: Mapping[str, Any]) -> "HyperparamDomain":
        return cls(spec["_type"], spec["_value"])

    def to_nni(self) -> Dict[str, Any]:
        return {"_type": self.kind, "_value": self.values}

    def sample(self, rng: np.random.Generator) -> Any:
        """One value drawn with a numpy Generator (the JAX package's draws)."""
        if self.kind == "choice":
            return self.values[int(rng.integers(len(self.values)))]
        lo, hi = float(self.values[0]), float(self.values[1])
        if self.kind == "uniform":
            return float(rng.uniform(lo, hi))
        if self.kind == "loguniform":
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        if self.kind == "quniform":
            q = float(self.values[2]) if len(self.values) > 2 else 1.0
            return float(np.round(rng.uniform(lo, hi) / q) * q)
        return int(rng.integers(int(lo), int(hi)))

    def __repr__(self):
        return f"HyperparamDomain({self.kind}, {self.values})"


class HyperparameterSpace:
    """Named :class:`HyperparamDomain`\\ s over dotted hp paths (optionally
    prefixed ``model:`` or ``training:``); reads and writes NNI search-space
    JSON."""

    def __init__(self, domains: Mapping[str, HyperparamDomain]):
        self.domains = dict(domains)

    @classmethod
    def from_nni_json(cls, path_or_dict) -> "HyperparameterSpace":
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        return cls({k: HyperparamDomain.from_nni(v) for k, v in d.items()})

    def to_nni_json(self) -> Dict[str, Any]:
        return {k: v.to_nni() for k, v in self.domains.items()}

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        return {k: d.sample(rng) for k, d in self.domains.items()}

    def __len__(self):
        return len(self.domains)

    def __repr__(self):
        return f"HyperparameterSpace({list(self.domains)})"


def apply_dotted_overrides(hp_tree: Dict[str, Any], flat: Mapping[str, Any],
                           strip_prefixes: Sequence[str] = ("model:", "training:"),
                           ) -> Dict[str, Any]:
    """Merge flat dotted-name params into a nested hp dict (in a copy):
    ``"training:optimizer_opts.lr" -> hp['optimizer_opts']['lr']`` (the first
    of ``strip_prefixes`` a name starts with is taken off). A path that
    descends through a non-mapping raises ConfigError."""
    from deepcv_tpu_torch.config import ConfigError

    out = copy.deepcopy(hp_tree)
    for name, value in flat.items():
        for p in strip_prefixes:
            if name.startswith(p):
                name = name[len(p):]
                break
        node = out
        parts = name.split(".")
        for i, part in enumerate(parts[:-1]):
            if part in node and not isinstance(node[part], dict):
                raise ConfigError(
                    f"override '{name}' descends through "
                    f"'{'.'.join(parts[:i + 1])}', which holds "
                    f"{type(node[part]).__name__} ({node[part]!r}), not a mapping")
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out

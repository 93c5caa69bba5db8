"""Frozen hyperparameter mapping with required/default semantics.

Counterpart of ``deepcv_tpu/hyperparams.py`` (``Hyperparameters``,
``to_hyperparameters``, ``merge_hyperparameters``), copied so that the port
imports nothing of the JAX package. A default value of ``...`` (Ellipsis)
marks a required key.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

__all__ = ["Hyperparameters", "to_hyperparameters", "merge_hyperparameters"]


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

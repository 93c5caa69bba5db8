"""Generic utilities: seeding, the safe identifier registry, device choice.

Counterpart of ``deepcv_tpu/utils.py`` (``set_seeds``, ``Registry``,
``register``, ``get_by_identifier``, ``identifier_to_str``), copied rather
than imported so that the port never loads the JAX package.

``get_by_identifier`` resolves YAML strings through a registry first and
imports only dotted paths under :attr:`Registry.SAFE_IMPORT_PREFIXES` — the
safe replacement for unsafe-YAML object construction.
"""
from __future__ import annotations

import importlib
import logging
import random
from functools import reduce
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["set_seeds", "get_by_identifier", "identifier_to_str",
           "recursive_getattr", "Registry", "GLOBAL_REGISTRY", "register",
           "resolve_device"]

_logger = logging.getLogger(__name__)


def set_seeds(seed: int = 563454) -> torch.Generator:
    """Seed ``random``, numpy and torch's global generators and return a
    fresh CPU ``torch.Generator`` seeded with ``seed`` (the port's explicit
    counterpart of the JAX package's returned PRNG key)."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Asking for CUDA (explicitly or by default) on a machine with
    no card raises — nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


class Registry:
    """String-identifier -> python-object registry (exact name, then alias);
    dotted imports only under :attr:`SAFE_IMPORT_PREFIXES`."""

    #: module prefixes importable from YAML specs (safety allowlist)
    SAFE_IMPORT_PREFIXES = ("deepcv_tpu_torch.", "torch.nn.functional.")

    def __init__(self, name: str = "global"):
        self.name = name
        self._entries: Dict[str, Any] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, name: str, obj: Any = None, *, aliases: Sequence[str] = ()):
        """Register ``obj`` under ``name`` (usable as decorator when obj is None)."""
        def _do(o):
            if name in self._entries and self._entries[name] is not o:
                _logger.debug("Registry %s: overriding entry %s", self.name, name)
            self._entries[name] = o
            for a in aliases:
                self._aliases[a] = name
            return o

        return _do if obj is None else _do(obj)

    def __contains__(self, name: str) -> bool:
        return name in self._entries or name in self._aliases

    def get(self, name: str, default: Any = None) -> Any:
        if name in self._entries:
            return self._entries[name]
        if name in self._aliases:
            return self._entries[self._aliases[name]]
        return default

    def __getitem__(self, name: str) -> Any:
        if name not in self:
            raise KeyError(f"'{name}' not registered in registry '{self.name}'. "
                           f"Known: {sorted(self._entries)[:40]}...")
        return self.get(name)

    def names(self):
        return sorted(self._entries)


GLOBAL_REGISTRY = Registry("global")


def register(name: str, obj: Any = None, *, aliases: Sequence[str] = ()):
    """Register into the global registry (decorator-friendly)."""
    return GLOBAL_REGISTRY.register(name, obj, aliases=aliases)


def _ensure_builtin_registrations():
    """Import the modules that populate the global registry, so resolution
    works whatever the caller imported first."""
    for mod in ("deepcv_tpu_torch.ops.nn", "deepcv_tpu_torch.data.transforms"):
        importlib.import_module(mod)


def get_by_identifier(identifier: str, registry: Optional[Registry] = None) -> Any:
    """Resolve a string identifier: registry name or alias first, then a
    dotted import path limited to :attr:`Registry.SAFE_IMPORT_PREFIXES`."""
    registry = registry or GLOBAL_REGISTRY
    if identifier not in registry:
        _ensure_builtin_registrations()
    if identifier in registry:
        return registry[identifier]
    if "." in identifier:
        if not identifier.startswith(Registry.SAFE_IMPORT_PREFIXES):
            raise ValueError(
                f"Refusing to import '{identifier}': not registered and not under safe "
                f"prefixes {Registry.SAFE_IMPORT_PREFIXES}. Register it explicitly with "
                f"deepcv_tpu_torch.utils.register().")
        module_name, _, attr = identifier.rpartition(".")
        return recursive_getattr(importlib.import_module(module_name), attr)
    raise ValueError(f"Cannot resolve identifier '{identifier}' "
                     f"(not in registry '{registry.name}', not a dotted path)")


def identifier_to_str(obj: Any) -> str:
    """Inverse-ish of :func:`get_by_identifier` for logging/serialization."""
    if isinstance(obj, str):
        return obj
    qual = getattr(obj, "__qualname__", None) or getattr(obj, "__name__", None)
    mod = getattr(obj, "__module__", "")
    return f"{mod}.{qual}" if qual else repr(obj)


def recursive_getattr(obj: Any, dotted: str) -> Any:
    """``recursive_getattr(m, "a.b.c") == m.a.b.c``."""
    return reduce(getattr, dotted.split("."), obj)

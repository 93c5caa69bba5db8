"""Weights from the JAX package into the port.

The JAX package keeps a model's variables as a pytree (``params`` and
``batch_stats``) and saves bundles with orbax, a JAX library the port cannot
read. This module is the bridge: given that pytree as numpy arrays, it builds
the ``state_dict`` of the port's :class:`~deepcv_tpu_torch.spec.DeepcvModule`
for the same spec.

    conv kernels    (kh, kw, Cin, Cout) HWIO -> (Cout, Cin, kh, kw) OIHW
    dense kernels   (in, out)                -> (out, in)
    norm scale/bias                          -> weight/bias
    batch_stats mean/var                     -> running_mean/running_var

A nested module's variables sit under its node, each of its own nodes a
level below (``node_impls_<nested>/node_impls_<local>/...`` ->
``module.nodes.<nested>.nodes.<local>...``). A layer unit's variables sit
under ``op`` and ``norms_<i>``; a ViT node's
under its submodules' names, which the port keeps: ``embed/proj``,
``embed/cls_token``, ``embed/pos_embedding``, ``enc<i>/ln_1``,
``enc<i>/attn/qkv`` (its kernel's columns are ``[q | k | v]``, so the
transposed weight keeps ``in_proj_weight``'s row order), ``enc<i>/attn/out``,
``enc<i>/ln_2``, ``enc<i>/mlp/fc1`` and ``enc<i>/mlp/fc2``.

The JAX package zero-pads conv inputs to at least 8 channels on the TPU
(``pad_channels_for_tpu``), so a 3-channel stem kernel there is
(7, 7, 8, 64); the padded rows meet zeros and are dropped here. A key that
does not map, or a parameter of the port left without a value, raises.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["jax_to_torch_state_dict", "load_jax_variables"]

#: the JAX package pads conv input channels up to this count
TPU_MIN_CHANNELS = 8

_NORM_RE = re.compile(r"^norms_(\d+)$")
_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
#: leaves of a ViT node's submodules, by JAX name
_SUBMODULE_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
#: parameters a ViT node holds directly
_NODE_PARAMS = ("cls_token", "pos_embedding")
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_key(collection: str, path: Tuple[str, ...]) -> str:
    base, rest = "module", path
    while rest and rest[0].startswith("node_impls_"):
        base += f".nodes.{rest[0][len('node_impls_'):]}"
        rest = rest[1:]
    if base == "module" or not rest:
        raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
    if collection == "params" and rest[0] == "op":
        leaf = rest[-1]
        if rest[1:-1] not in ((), ("inner",)) or leaf not in ("kernel", "bias"):
            raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
        return f"{base}.op.{'weight' if leaf == 'kernel' else 'bias'}"
    m = _NORM_RE.match(rest[0])
    table = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    if m and len(rest) == 2 and rest[1] in table:
        return f"{base}.norms.{m.group(1)}.{table[rest[1]]}"
    if collection == "params" and len(rest) == 1 and rest[0] in _NODE_PARAMS:
        return f"{base}.{rest[0]}"
    if collection == "params" and len(rest) >= 2 and rest[-1] in _SUBMODULE_LEAF:
        return f"{base}.{'.'.join(rest[:-1])}.{_SUBMODULE_LEAF[rest[-1]]}"
    raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")


def _convert(key: str, a: np.ndarray, target: torch.Tensor) -> np.ndarray:
    if a.ndim == 4:                     # HWIO -> OIHW
        cin = target.shape[1]
        if a.shape[2] != cin:
            if not (cin < TPU_MIN_CHANNELS and a.shape[2] == TPU_MIN_CHANNELS):
                raise ValueError(f"{key}: JAX kernel {a.shape} does not fit "
                                 f"{tuple(target.shape)}")
            a = a[:, :, :cin, :]
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:                   # dense (in, out) -> (out, in)
        a = a.T
    if tuple(a.shape) != tuple(target.shape):
        raise ValueError(f"{key}: converted shape {a.shape} != {tuple(target.shape)}")
    return a


def jax_to_torch_state_dict(variables_np: Mapping[str, Any],
                            model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``model`` from the JAX variables of the same spec
    (``{'params': ..., 'batch_stats': ...}`` as numpy arrays)."""
    targets = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables_np.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unmapped JAX collection '{collection}'")
        for path, arr in _flatten(tree):
            key = _torch_key(collection, path)
            if key not in targets:
                raise KeyError(f"JAX variable {collection}/{'/'.join(path)} maps to "
                               f"'{key}', which the model does not have")
            t = targets[key]
            out[key] = torch.tensor(_convert(key, arr, t), dtype=t.dtype)
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"no JAX variable for {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out


def load_jax_variables(model: torch.nn.Module, variables_np: Mapping[str, Any]):
    """Load JAX variables into ``model`` in place; returns the model."""
    model.load_state_dict(jax_to_torch_state_dict(variables_np, model))
    return model

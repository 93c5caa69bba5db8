"""Architecture spec -> static DAG of torch modules, and its executor.

Counterpart of ``deepcv_tpu/spec/graph.py`` (``SpecError``,
``define_nn_architecture``, ``SpecModule``). The spec is compiled once into a
node list. Shapes are inferred while compiling: every node is built on the
meta device and run there on a meta tensor of the current shape, so each
creator learns its input size and no FLOP is spent (the JAX package used
``jax.eval_shape``). A node that outputs parallel streams (HRNet's) has a
list of shapes. Spec faults are :class:`SpecError`\\ s raised here, at
build time.

Ported: plain creators, links and nested modules (``_nested_deepcvmodule``
or ``_nested_deepcv_module``: a sub-architecture compiled with its own
hp, whose parameters live under ``nodes.<nested name>.nodes.<local
name>``). NAS choice points are a later slice and are refused with a
SpecError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn as nn

from deepcv_tpu_torch.spec.creators import (
    CreatorContext, ForwardCallback, Shapes, check_creator_params, get_creator)
from deepcv_tpu_torch.spec.tokens import YamlTokens as T

__all__ = ["SpecError", "NodeMeta", "define_nn_architecture", "SpecModule"]


class SpecError(ValueError):
    """Raised for invalid architecture specifications."""


@dataclasses.dataclass(frozen=True)
class NodeMeta:
    """Static per-node metadata."""
    name: str
    kind: str                                   # 'module' | 'callback'
    creator: str = ""
    refs: Tuple[str, ...] = ()


def _is_tagged(obj) -> bool:
    return hasattr(obj, "identifier") and hasattr(obj, "resolve")


def _entry_name_and_params(entry: Any, index: int):
    """(explicit_name, creator_key, params) of one spec list entry."""
    if isinstance(entry, str):
        return None, entry, {}
    if _is_tagged(entry) or not isinstance(entry, Mapping) or len(entry) != 1:
        raise SpecError(
            f"Architecture entry #{index} must be a single-key mapping "
            f"'{{creator: params}}', got: {entry!r}")
    (key, value), = entry.items()
    name = None
    if isinstance(value, (list, tuple)) and len(value) == 2 and isinstance(value[0], str) \
            and isinstance(value[1], Mapping):
        name, params = value[0], dict(value[1])
    elif isinstance(value, Mapping):
        params = dict(value)
    elif value is None:
        params = {}
    else:
        params = {"args": value}
    if T.NAME in params:
        name = params.pop(T.NAME)
    return name, key, params


def _creator_label(key) -> str:
    return str(key).lstrip("_")


def _shape_of(x) -> Shapes:
    """A tensor's shape, or a stream list's shapes."""
    return [tuple(t.shape) for t in x] if isinstance(x, (list, tuple)) else tuple(x.shape)


def _meta_input(shape: Shapes):
    """Meta tensors of ``shape`` (a list for a stream list); feature maps in
    channels_last memory."""
    if isinstance(shape, list):
        return [_meta_input(s) for s in shape]
    x = torch.empty(tuple(shape))
    return x.contiguous(memory_format=torch.channels_last) if len(shape) == 4 else x


def define_nn_architecture(architecture: Sequence[Any], hp: Mapping[str, Any],
                           ctx: CreatorContext, input_shape: Shapes,
                           ) -> Tuple[Tuple[NodeMeta, ...], Dict[str, Any],
                                      Tuple[str, ...], Dict[str, Shapes]]:
    """Compile a YAML architecture list for an NCHW-logical ``input_shape``
    (batch dim included; a list of shapes for a stream list) into
    ``(node_metas, node_impls, referenced, node_shapes)``. Modules are
    created on the meta device."""
    if not isinstance(architecture, (list, tuple)) or not architecture:
        raise SpecError(f"'architecture' must be a non-empty list, got {type(architecture)}")

    metas: List[NodeMeta] = []
    impls: Dict[str, Any] = {}
    shapes: Dict[str, Shapes] = {}
    names_seen: Dict[str, int] = {}
    refs_needed = set()
    with torch.device("meta"):
        x = _meta_input(input_shape)
        stored: Dict[str, torch.Tensor] = {}
        for idx, entry in enumerate(architecture):
            explicit_name, key, params = _entry_name_and_params(entry, idx)
            if key == T.NAS_LAYER_CHOICE or T.FROM_NAS_INPUT_CHOICE in params:
                raise SpecError(f"Architecture entry #{idx}: '{key}' (NAS choices) "
                                "is not ported yet")
            nested = key in (T.NESTED_DEEPCV_MODULE, T.NESTED_DEEPCV_MODULE_ALT)
            if nested:
                sub_hp = entry[key]
                sub_hp = dict({"architecture": list(sub_hp)}
                              if isinstance(sub_hp, (list, tuple)) else sub_hp)
                if sub_hp.get("architecture") is None:
                    raise SpecError(f"Nested module entry #{idx} has no 'architecture'")
                explicit_name = explicit_name or sub_hp.get(T.NAME)
            name = explicit_name or f"_submodule_{idx}_{'nested' if nested else _creator_label(key)}"
            if name in names_seen:
                raise SpecError(f"Duplicate submodule name '{name}'")
            if nested:
                # the sub-architecture sees its own hp (its act_fn, its norms)
                # and the model's weight_norm, as in the JAX package
                sub = SpecModule(*define_nn_architecture(
                    sub_hp["architecture"], sub_hp,
                    CreatorContext(hp=sub_hp, weight_norm=ctx.weight_norm,
                                   signal_1d=ctx.signal_1d, quantize=ctx.quantize,
                                   quantize_scales=ctx.quantize_scales,
                                   scope=f"{ctx.scope}{name}/"),
                    _shape_of(x))[:3])
                names_seen[name] = idx
                metas.append(NodeMeta(name=name, kind="module", creator="nested"))
                x = sub(x)
                impls[name], stored[name], shapes[name] = sub, x, _shape_of(x)
                ctx = dataclasses.replace(ctx, submodule_names=tuple(names_seen))
                continue
            refs = params.pop(T.FROM, None)
            refs = tuple([refs] if isinstance(refs, str) else list(refs or []))
            for r in refs:
                if r not in names_seen:
                    raise SpecError(
                        f"Submodule '{name}' references undefined/later submodule '{r}' "
                        f"(defined so far: {sorted(names_seen)})")
            names_seen[name] = idx

            entry_c = get_creator(key) if isinstance(key, str) else None
            if entry_c is None:
                raise SpecError(f"Unknown submodule creator '{key}' (node '{name}')")
            merged = {k: hp[k] for k in entry_c["global_keys"] if k in hp}
            merged.update(params)
            check_creator_params(key, merged)
            impl = entry_c["fn"](merged, ctx, name, _shape_of(x))

            if isinstance(impl, ForwardCallback):
                if not refs and not impl.uses_current:
                    raise SpecError(f"'{name}': new-branch node requires '{T.FROM}' references")
                metas.append(NodeMeta(name=name, kind="callback", creator=str(key), refs=refs))
                refs_needed.update(refs)
                x = impl(x, [stored[r] for r in refs])
            else:
                if refs:
                    raise SpecError(f"Submodule '{name}' ({key}): '{T.FROM}' references are "
                                    "only valid on link/branch creators")
                metas.append(NodeMeta(name=name, kind="module", creator=str(key)))
                x = impl(x)
            impls[name] = impl
            stored[name] = x
            shapes[name] = _shape_of(x)
            ctx = dataclasses.replace(ctx, submodule_names=tuple(names_seen))
    return tuple(metas), impls, tuple(sorted(refs_needed)), shapes


class SpecModule(nn.Module):
    """Executes a compiled architecture DAG: module nodes live in
    ``self.nodes`` (so their parameters are ``nodes.<name>.*``), callbacks
    hold no parameters; outputs are kept only for referenced nodes."""

    def __init__(self, node_metas: Tuple[NodeMeta, ...], node_impls: Mapping[str, Any],
                 referenced: Tuple[str, ...] = ()):
        super().__init__()
        self.node_metas = tuple(node_metas)
        self.referenced = frozenset(referenced)
        self.nodes = nn.ModuleDict({m.name: node_impls[m.name]
                                    for m in self.node_metas if m.kind == "module"})
        self._callbacks = {m.name: node_impls[m.name]
                           for m in self.node_metas if m.kind == "callback"}

    def forward(self, x):
        stored: Dict[str, torch.Tensor] = {}
        for meta in self.node_metas:
            if meta.kind == "callback":
                x = self._callbacks[meta.name](x, [stored[r] for r in meta.refs])
            else:
                x = self.nodes[meta.name](x)
            if meta.name in self.referenced:
                stored[meta.name] = x
        return x

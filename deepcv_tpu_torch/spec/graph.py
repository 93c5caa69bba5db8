"""Architecture spec -> static DAG of torch modules, and its executor.

Counterpart of ``deepcv_tpu/spec/graph.py`` (``SpecError``,
``define_nn_architecture``, ``SpecModule``). The spec is compiled once into a
node list. Shapes are inferred while compiling: every node is built on the
meta device and run there on a meta tensor of the current shape, so each
creator learns its input size and no FLOP is spent (the JAX package used
``jax.eval_shape``). A node that outputs parallel streams (HRNet's) has a
list of shapes. Spec faults are :class:`SpecError`\\ s raised here, at
build time.

Plain creators, links and nested modules (``_nested_deepcvmodule`` or
``_nested_deepcv_module``: a sub-architecture compiled with its own hp,
whose parameters live under ``nodes.<nested name>.nodes.<local name>``)
and the NAS choice points, ``_nas_layer_choice`` (a list of candidate
entries) and ``_from_nas_input_choice`` (candidate references of a link,
``_n_chosen`` of them taken), in two modes (``CreatorContext.nas_mode``):

* ``fixed`` builds one candidate per mutable under the mutable's own name:
  ``nas_arch[name]`` (0 by default; the first ``_n_chosen`` references for
  an input choice). An out-of-range choice is a SpecError;
* ``supernet`` builds every candidate of a layer choice as
  ``<name>_cand<i>`` and mixes their outputs with weights over a trainable
  logit vector ``arch__<name>`` (zeros at init) held by the SpecModule that
  holds the mutable; an input choice mixes its references, each first
  resized to the first one's spatial size. :attr:`SpecModule.sampling`
  picks the weights: ``softmax`` (DARTS), ``sampled`` (ProxylessNAS: one
  candidate drawn by Gumbel-max over the logits from
  :attr:`SpecModule.generator` in training mode, the argmax otherwise,
  with the straight-through ``hard + soft - soft.detach()``) or
  ``uniform`` (SPOS: one drawn uniformly, no gradient to the logits). Every
  candidate is computed on every forward, as in the JAX package, so that
  each candidate's BatchNorm statistics move. Candidates whose output
  shapes differ cannot be summed: the build raises a SpecError naming the
  mutable and the shapes. ``forced_arch`` forces one-hot weights (the mean
  multi-hot for a list) on the supernet's own parameters.

Nested mutables are named ``<nested>/<local>``. The JAX package builds a
nested supernet with ``softmax`` whatever its model's sampling; here every
level takes the model's sampling.
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.spec.creators import (
    CreatorContext, ForwardCallback, Shapes, check_creator_params, get_creator)
from deepcv_tpu_torch.spec.tokens import YamlTokens as T

__all__ = ["SpecError", "NodeMeta", "define_nn_architecture", "SpecModule",
           "clone_with_forced_arch", "ARCH_PARAM_PREFIX", "NAS_MODES", "NAS_SAMPLINGS"]

ARCH_PARAM_PREFIX = "arch__"
NAS_MODES = ("fixed", "supernet")
NAS_SAMPLINGS = ("softmax", "sampled", "uniform")


class SpecError(ValueError):
    """Raised for invalid architecture specifications."""


@dataclasses.dataclass(frozen=True)
class NodeMeta:
    """Static per-node metadata."""
    name: str
    kind: str                                   # 'module' | 'callback' | 'choice'
    creator: str = ""
    refs: Tuple[str, ...] = ()
    #: supernet input choice: (choice name, candidates, n_chosen)
    input_choice: Optional[Tuple[str, int, int]] = None
    #: supernet layer choice: candidate count
    n_candidates: int = 0


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


def _build_node(key, params: Dict[str, Any], hp: Mapping[str, Any], ctx: CreatorContext,
                name: str, in_shape: Shapes):
    """One creator entry -> its module or ForwardCallback."""
    entry_c = get_creator(key) if isinstance(key, str) else None
    if entry_c is None:
        raise SpecError(f"Unknown submodule creator '{key}' (node '{name}')")
    merged = {k: hp[k] for k in entry_c["global_keys"] if k in hp}
    merged.update(params)
    check_creator_params(key, merged)
    return entry_c["fn"](merged, ctx, name, in_shape)


def _build_candidate(cand: Any, idx: int, hp: Mapping[str, Any], ctx: CreatorContext,
                     node_name: str, in_shape: Shapes):
    """(creator key, module) of one layer-choice candidate, built as
    ``node_name``; a link is refused."""
    _, key, params = _entry_name_and_params(cand, idx)
    impl = _build_node(key, params, hp, ctx, node_name, in_shape)
    if isinstance(impl, ForwardCallback):
        raise SpecError(f"'{node_name}': a layer-choice candidate must be a layer, "
                        f"got the link '{key}'")
    return key, impl


def _as_refs(v) -> Tuple[str, ...]:
    return tuple([v] if isinstance(v, str) else list(v or []))


def _mix(weights: torch.Tensor, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum_i weights[i] * tensors[i]`` (the JAX package's python sum)."""
    out = 0
    for i, t in enumerate(tensors):
        out = out + weights[i] * t
    return out


def _resized_to_first(refs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each reference resized to the first one's spatial size."""
    tgt = tuple(refs[0].shape[2:])
    return [r if tuple(r.shape[2:]) == tgt else dnn.interpolate(r, tgt) for r in refs]


def define_nn_architecture(architecture: Sequence[Any], hp: Mapping[str, Any],
                           ctx: CreatorContext, input_shape: Shapes,
                           ) -> Tuple[Tuple[NodeMeta, ...], Dict[str, Any],
                                      Tuple[str, ...], Dict[str, Shapes]]:
    """Compile a YAML architecture list for an NCHW-logical ``input_shape``
    (batch dim included; a list of shapes for a stream list) into
    ``(node_metas, node_impls, referenced, node_shapes)``. Modules are
    created on the meta device; a supernet layer choice's impl is the list
    of its candidates."""
    if not isinstance(architecture, (list, tuple)) or not architecture:
        raise SpecError(f"'architecture' must be a non-empty list, got {type(architecture)}")
    supernet = ctx.nas_mode == "supernet"
    metas: List[NodeMeta] = []
    impls: Dict[str, Any] = {}
    shapes: Dict[str, Shapes] = {}
    names_seen: Dict[str, int] = {}
    refs_needed = set()

    def unique(name: str, idx: int) -> str:
        if name in names_seen:
            raise SpecError(f"Duplicate submodule name '{name}'")
        names_seen[name] = idx
        return name

    with torch.device("meta"):
        x = _meta_input(input_shape)
        stored: Dict[str, torch.Tensor] = {}
        for idx, entry in enumerate(architecture):
            explicit_name, key, params = _entry_name_and_params(entry, idx)
            if key == T.NAS_LAYER_CHOICE:
                candidates = params.pop(T.CANDIDATES, None)
                if not candidates:
                    raise SpecError(f"'{T.NAS_LAYER_CHOICE}' entry #{idx} needs "
                                    f"'{T.CANDIDATES}'")
                name = unique(explicit_name or f"_submodule_{idx}_layer_choice", idx)
                if supernet:
                    cands = [_build_candidate(cand, idx, hp, ctx, f"{name}_cand{ci}",
                                              _shape_of(x))[1]
                             for ci, cand in enumerate(candidates)]
                    outs = [c(x) for c in cands]
                    out_shapes = [_shape_of(o) for o in outs]
                    if any(s != out_shapes[0] for s in out_shapes):
                        raise SpecError(
                            f"supernet layer choice '{ctx.scope}{name}': its candidates' "
                            f"outputs differ in shape ({out_shapes}, NCHW) and cannot be "
                            "mixed; give the candidates one output shape")
                    metas.append(NodeMeta(name=name, kind="choice", creator="layer_choice",
                                          n_candidates=len(cands)))
                    impls[name], x = cands, outs[0]
                else:
                    choice = ctx.nas_arch.get(name, 0)
                    choice = int(choice[0] if isinstance(choice, (list, tuple)) else choice)
                    if not 0 <= choice < len(candidates):
                        raise SpecError(f"nas_arch['{name}']={choice} out of range "
                                        f"(0..{len(candidates) - 1})")
                    c_key, impl = _build_candidate(candidates[choice], idx, hp, ctx, name,
                                                   _shape_of(x))
                    metas.append(NodeMeta(name=name, kind="module", creator=str(c_key)))
                    x = impl(x)
                    impls[name] = impl
                stored[name], shapes[name] = x, _shape_of(x)
                ctx = dataclasses.replace(ctx, submodule_names=tuple(names_seen))
                continue
            nested = key in (T.NESTED_DEEPCV_MODULE, T.NESTED_DEEPCV_MODULE_ALT)
            if nested:
                sub_hp = entry[key]
                sub_hp = dict({"architecture": list(sub_hp)}
                              if isinstance(sub_hp, (list, tuple)) else sub_hp)
                if sub_hp.get("architecture") is None:
                    raise SpecError(f"Nested module entry #{idx} has no 'architecture'")
                name = unique(explicit_name or sub_hp.get(T.NAME) or f"_submodule_{idx}_nested",
                              idx)
                # the sub-architecture sees its own hp (its act_fn, its norms),
                # the model's weight_norm and NAS options, and the choices
                # addressed '<name>/<local>' (bare keys pass through)
                sub_nas = {**{k: v for k, v in ctx.nas_arch.items() if "/" not in k},
                           **{k.split("/", 1)[1]: v for k, v in ctx.nas_arch.items()
                              if k.startswith(name + "/")}}
                sub = SpecModule(*define_nn_architecture(
                    sub_hp["architecture"], sub_hp,
                    dataclasses.replace(ctx, hp=sub_hp, submodule_names=(),
                                        scope=f"{ctx.scope}{name}/", nas_arch=sub_nas),
                    _shape_of(x)))
                metas.append(NodeMeta(name=name, kind="module", creator="nested"))
                x = sub(x)
                impls[name], stored[name], shapes[name] = sub, x, _shape_of(x)
                ctx = dataclasses.replace(ctx, submodule_names=tuple(names_seen))
                continue
            refs = _as_refs(params.pop(T.FROM, None))
            choice_cands = _as_refs(params.pop(T.FROM_NAS_INPUT_CHOICE, None))
            n_chosen = int(params.pop(T.N_CHOSEN, 1))
            params.pop(T.RETURN_MASK, None)
            name = explicit_name or f"_submodule_{idx}_{_creator_label(key)}"
            for r in (*refs, *choice_cands):
                if r not in names_seen:
                    raise SpecError(
                        f"Submodule '{name}' references undefined/later submodule '{r}' "
                        f"(defined so far: {sorted(names_seen)})")
            unique(name, idx)
            impl = _build_node(key, params, hp, ctx, name, _shape_of(x))

            if isinstance(impl, ForwardCallback):
                input_choice = None
                if not choice_cands:
                    all_refs = refs
                elif supernet:
                    input_choice, all_refs = (name, len(choice_cands), n_chosen), choice_cands
                else:
                    chosen = ctx.nas_arch.get(name, list(range(min(n_chosen, len(choice_cands)))))
                    chosen = [chosen] if isinstance(chosen, (int, str)) else list(chosen)
                    for c in chosen:
                        if not isinstance(c, str) and not 0 <= int(c) < len(choice_cands):
                            raise SpecError(f"nas_arch['{name}'] picks {c}, out of range "
                                            f"(0..{len(choice_cands) - 1})")
                    all_refs = tuple(c if isinstance(c, str) else choice_cands[int(c)]
                                     for c in chosen)
                if not all_refs and not impl.uses_current:
                    raise SpecError(f"'{name}': new-branch node requires '{T.FROM}' or "
                                    f"'{T.FROM_NAS_INPUT_CHOICE}' references")
                metas.append(NodeMeta(name=name, kind="callback", creator=str(key),
                                      refs=all_refs, input_choice=input_choice))
                refs_needed.update(all_refs)
                ref_vals = [stored[r] for r in all_refs]
                if input_choice is not None:
                    resized = _resized_to_first(ref_vals)
                    cand_shapes = [_shape_of(r) for r in resized]
                    if any(s != cand_shapes[0] for s in cand_shapes):
                        raise SpecError(
                            f"supernet input choice '{ctx.scope}{name}': its candidates "
                            f"{list(all_refs)} differ in channels ({cand_shapes}, NCHW after "
                            "the resize) and cannot be mixed")
                    ref_vals = [resized[0]]
                x = impl(x, ref_vals)
            else:
                if refs or choice_cands:
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
    ``self.nodes`` (so their parameters are ``nodes.<name>.*``; a supernet
    layer choice's candidates ``nodes.<name>_cand<i>.*``), callbacks hold no
    parameters, a supernet choice's logits are ``arch__<name>``; outputs are
    kept only for referenced nodes. ``node_shapes`` are the nodes' output
    shapes from the build (NCHW-logical, batch 1).

    ``sampling`` mixes the supernet's candidates (module docstring);
    ``generator`` (set by the training loop) feeds the ``sampled`` and
    ``uniform`` draws in training mode; ``forced_arch`` (name -> candidate
    index, or a list of indices) forces the choice weights."""

    def __init__(self, node_metas: Tuple[NodeMeta, ...], node_impls: Mapping[str, Any],
                 referenced: Tuple[str, ...] = (),
                 node_shapes: Optional[Mapping[str, Shapes]] = None, sampling: str = "softmax"):
        super().__init__()
        self.node_metas = tuple(node_metas)
        self.referenced = frozenset(referenced)
        #: each node's output shape at batch 1, NCHW-logical, from the build
        self.node_shapes = dict(node_shapes or {})
        nodes: Dict[str, nn.Module] = {}
        #: a candidate's node key -> (its choice, its index)
        self.candidate_of: Dict[str, Tuple[str, int]] = {}
        for m in self.node_metas:
            if m.kind == "module":
                nodes[m.name] = node_impls[m.name]
            elif m.kind == "choice":
                for i, cand in enumerate(node_impls[m.name]):
                    nodes[f"{m.name}_cand{i}"] = cand
                    self.candidate_of[f"{m.name}_cand{i}"] = (m.name, i)
            if m.kind == "choice" or m.input_choice is not None:
                n = m.n_candidates if m.kind == "choice" else m.input_choice[1]
                self.register_parameter(f"{ARCH_PARAM_PREFIX}{m.name}",
                                        nn.Parameter(torch.zeros(n)))
        self.nodes = nn.ModuleDict(nodes)
        self._callbacks = {m.name: node_impls[m.name]
                           for m in self.node_metas if m.kind == "callback"}
        self.generator: Optional[torch.Generator] = None
        self.forced_arch: Optional[Dict[str, Any]] = None
        self.set_sampling(sampling)

    def set_sampling(self, sampling: str) -> None:
        """The mixing of this module's choices and of its nested modules'."""
        if sampling not in NAS_SAMPLINGS:
            raise SpecError(f"nas_sampling must be one of {NAS_SAMPLINGS}, got {sampling!r}")
        self.sampling = sampling
        for node in self.nodes.values():
            if isinstance(node, SpecModule):
                node.set_sampling(sampling)

    def init_parameters(self, generator: torch.Generator) -> None:
        """The architecture logits start at zero (the nodes init themselves)."""
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.zero_()

    def arch_logits(self) -> Dict[str, nn.Parameter]:
        """This module's choice logits by mutable name."""
        return {n[len(ARCH_PARAM_PREFIX):]: p for n, p in self.named_parameters(recurse=False)
                if n.startswith(ARCH_PARAM_PREFIX)}

    def _choice_weights(self, name: str, n: int) -> torch.Tensor:
        logits = getattr(self, f"{ARCH_PARAM_PREFIX}{name}")
        if self.forced_arch is not None and name in self.forced_arch:
            c = self.forced_arch[name]
            if isinstance(c, (list, tuple)):
                # n_chosen > 1: the mean multi-hot over every chosen candidate
                return sum(F.one_hot(torch.tensor(int(i)), n) for i in c).to(
                    logits.device, logits.dtype) / float(len(c))
            return F.one_hot(torch.tensor(int(c)), n).to(logits.device, logits.dtype)
        draw = self.training and self.generator is not None
        if self.sampling == "sampled":
            # ProxylessNAS binary gates: one path by Gumbel-max over the
            # logits, the gate's gradient reaching them through the softmax
            if draw:
                g = self.generator
                u = torch.rand(n, generator=g, device=g.device) * (1.0 - 2e-6) + 1e-6
                idx = torch.argmax(logits.detach().to(g.device) - torch.log(-torch.log(u)))
            else:
                idx = torch.argmax(logits.detach())
            hard = F.one_hot(idx.to(logits.device), n).to(logits.dtype)
            soft = torch.softmax(logits, 0)
            return hard + soft - soft.detach()
        if self.sampling == "uniform":
            # SPOS: one path drawn uniformly, no gradient to the logits
            if draw:
                g = self.generator
                idx = torch.randint(0, n, (), generator=g, device=g.device)
            else:
                idx = torch.argmax(logits.detach())
            return F.one_hot(idx.to(logits.device), n).to(logits.dtype)
        return torch.softmax(logits, 0)

    def forward(self, x):
        stored: Dict[str, torch.Tensor] = {}
        for meta in self.node_metas:
            if meta.kind == "callback":
                refs = [stored[r] for r in meta.refs]
                if meta.input_choice is not None:
                    cname, n_cand, _ = meta.input_choice
                    refs = [_mix(self._choice_weights(cname, n_cand), _resized_to_first(refs))]
                x = self._callbacks[meta.name](x, refs)
            elif meta.kind == "choice":
                outs = [self.nodes[f"{meta.name}_cand{i}"](x) for i in range(meta.n_candidates)]
                x = _mix(self._choice_weights(meta.name, meta.n_candidates), outs)
            else:
                x = self.nodes[meta.name](x)
            if meta.name in self.referenced:
                stored[meta.name] = x
        return x


def clone_with_forced_arch(module: SpecModule, arch: Mapping[str, Any]) -> SpecModule:
    """A shallow clone of ``module`` (the same parameters and buffers) with
    ``forced_arch`` set at every nesting level: ``'<nested>/<local>'`` keys
    reach the nested SpecModule ``nodes[<nested>]``."""
    arch = dict(arch)
    clone = copy.copy(module)
    clone.__dict__["_modules"] = dict(module._modules)
    nodes = {}
    for name, node in module.nodes.items():
        sub = {k.split("/", 1)[1]: v for k, v in arch.items() if k.startswith(name + "/")}
        nodes[name] = clone_with_forced_arch(node, sub) \
            if isinstance(node, SpecModule) and sub else node
    clone.nodes = nn.ModuleDict(nodes)
    clone.forced_arch = {k: v for k, v in arch.items() if "/" not in k}
    return clone


_CAND_RE = re.compile(r"^(.*)_(\d+)$")


def jax_scope_name(module: SpecModule, node_key: str) -> str:
    """The JAX package's scope of node ``node_key`` of ``module``
    (``node_impls_<name>``; a candidate ``<name>_cand<i>`` is
    ``node_impls_<name>_<i>`` there)."""
    if node_key in module.candidate_of:
        choice, i = module.candidate_of[node_key]
        return f"node_impls_{choice}_{i}"
    return f"node_impls_{node_key}"


def node_key_of_jax_scope(module: SpecModule, scope: str) -> Optional[str]:
    """The inverse of :func:`jax_scope_name` (None when ``module`` has no
    such node)."""
    key = scope[len("node_impls_"):]
    if key in module.nodes:
        return key
    m = _CAND_RE.match(key)
    if m and f"{m.group(1)}_cand{m.group(2)}" in module.candidate_of:
        return f"{m.group(1)}_cand{m.group(2)}"
    return None

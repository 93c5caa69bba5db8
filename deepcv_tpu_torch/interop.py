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
    weight norm     op/layer_instance/{kernel,bias}, the one key
                    'op/layer_instance/kernel/scale' -> op.weight, op.bias, op.scale

A nested module's variables sit under its node, each of its own nodes a
level below (``node_impls_<nested>/node_impls_<local>/...`` ->
``module.nodes.<nested>.nodes.<local>...``). A NAS supernet's candidates
``node_impls_<choice>_<i>`` are the port's ``nodes.<choice>_cand<i>``, and
its logits ``arch__<choice>`` keep their name and layout at the level of
the module that holds the choice (``module.arch__<choice>``,
``module.nodes.<nested>.arch__<choice>``); a fixed build's chosen
candidate sits under the choice's own name in both. A layer unit's variables sit
under ``op`` and ``norms_<i>``; a ViT node's
under its submodules' names, which the port keeps: ``embed/proj``,
``embed/cls_token``, ``embed/pos_embedding``, ``enc<i>/ln_1``,
``enc<i>/attn/qkv`` (its kernel's columns are ``[q | k | v]``, so the
transposed weight keeps ``in_proj_weight``'s row order), ``enc<i>/attn/out``,
``enc<i>/ln_2``, ``enc<i>/mlp/fc1`` and ``enc<i>/mlp/fc2``. The zoo's cells
keep theirs too: a squeeze-excitation node's ``reduce`` and ``expand``; a
ConvNeXt stem's ``proj`` and ``ln``, a downsampling's ``ln`` and ``conv``,
a block's ``dwconv`` (a depthwise kernel (kh, kw, 1, C) becomes (C, 1, kh,
kw) as any conv kernel), ``ln``, ``fc1``, ``fc2`` and its own
``layer_scale``. A Swin block's are ``ln_1``, ``attn/qkv``, ``attn/out``,
``ln_2``, ``mlp/fc1``, ``mlp/fc2`` and ``attn/rel_pos_bias``, the
((2w-1)^2, heads) bias table, kept as it is (the port stores it in the
JAX layout, which is also torchvision's); a patch merging's ``ln`` and
``reduce``. A V-MoE block's expert mixture sits under ``moe_mlp``:
``router`` (D, E), ``expert_w1`` (E, D, M), ``expert_b1`` (E, M),
``expert_w2`` (E, M, D) and ``expert_b2`` (E, D), all kept as they are
(the port computes with the JAX layouts). An HRNet node
(``deepcv_tpu_torch/ops/hrnet.py``) names its JAX variables itself
(``jax_names``): its convs ``stream<i>_conv``, ``stem_conv<i>``,
``down_shared_32to32``, ``up_shared_32to32`` (or ``down_<j>to<i>_<k>``,
``up_<j>to<i>``, ``down_newbranch``), and its norms, which the JAX modules
create in their own scope, ``<class>_<k>`` (``LayerNorm_0``,
``MeanOnlyBatchNorm_0``: the running ``mean``); a head's ``mix``,
``v2/mix`` and ``pyr<i>`` keep their names.

The JAX package zero-pads conv inputs to at least 8 channels on the TPU
(``pad_channels_for_tpu``), so a 3-channel stem kernel there is
(7, 7, 8, 64); the padded rows meet zeros and are dropped here. Under
weight norm they are not inert there: flax's ``WeightNorm`` takes its norm
over all 8 input rows, padded ones included. Where a weight-normed conv's
dropped rows are not all zero, their share of the norm is folded into the
scale, per output filter, ``scale * sqrt(|v_kept|^2 + eps) / sqrt(|v|^2 +
eps)``, so the port's forward equals the JAX forward. Gradients do not: in
the JAX package the padded rows take part in the norm and are trained,
here they do not exist. They agree where the padded rows are zero. A key
that does not map, or a parameter of the port left without a value, raises.

An FPN node's convs keep their JAX names (``lateral<i>``, ``smooth<i>``,
``shared_head``). A model of several ``DeepcvModule``\\ s names them in
``jax_parts``: the keypoints ``Autoencoder``'s variables are
``params/encoder/...`` and ``params/decoder/...`` (and the same under
``batch_stats``), each part mapped as a model of its own.

A 3-d conv kernel (kd, kh, kw, Cin, Cout) DHWIO becomes (Cout, Cin, kd, kh,
kw) and a 1-d one (kw, Cin, Cout) WIO (Cout, Cin, kw), their padded input
rows cut as a 2-d kernel's (the ``conv3d`` stem of the video classifier has
3 real channels of 8). The video models (``pipelines/video.py``) name
their parameters by the JAX paths themselves (``jax_flat``): ``FlowModel``'s
``c1``, ``c2``, ``out``; ``TemporalVideoModel``'s ``enc_conv_<i>``,
``enc_gn_<i>``, ``embed``, ``pos_embedding``, ``block_<i>`` (a ViT
encoder block's names), ``ln_final``, ``gru/{ir,iz,in,hr,hz,hn}`` and
``head``. The learned codec's ``PyramidModel`` and SinGAN's ``ConvStack``
(``deepcv_tpu_torch/codec.py``, ``data/singan.py``) name theirs the same
way: the flax ``phase<i>/Conv_<j>`` and ``Conv_<i>``, ``GroupNorm_<i>``
parameters become ``phase<i>.Conv_<j>.weight`` and ``.bias``,
``Conv_<i>.weight``, ``GroupNorm_<i>.weight``; pass the codec's params as
``{"params": codec.params}``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from deepcv_tpu_torch.spec.graph import (ARCH_PARAM_PREFIX, SpecModule, jax_scope_name,
                                         node_key_of_jax_scope)

__all__ = ["jax_to_torch_state_dict", "load_jax_variables", "jax_param_paths"]

#: the JAX package pads conv input channels up to this count
TPU_MIN_CHANNELS = 8

_NORM_RE = re.compile(r"^norms_(\d+)$")
#: an op's leaves under ``op``, after flax's ``WeightNorm`` (``layer_instance``)
#: and ``FlattenThen`` (``inner``) are taken off the path
_OP_LEAF = {("kernel",): "weight", ("bias",): "bias", ("kernel", "scale"): "scale"}
_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
#: leaves of a ViT or Swin node's submodules, by JAX name
_SUBMODULE_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
#: parameters of a node's submodule that keep their JAX name and layout:
#: the Swin bias table (under ``attn``) and the V-MoE router and experts
#: (under ``moe_mlp``)
_SUBMODULE_PARAMS = {"attn": ("rel_pos_bias",),
                     "moe_mlp": ("router", "expert_w1", "expert_b1", "expert_w2",
                                 "expert_b2")}
_KEPT_LAYOUT = frozenset(p for names in _SUBMODULE_PARAMS.values() for p in names)
#: parameters a ViT or ConvNeXt node holds directly
_NODE_PARAMS = ("cls_token", "pos_embedding", "layer_scale")
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_key(collection: str, path: Tuple[str, ...], model: torch.nn.Module) -> str:
    base, rest = "module", path
    while rest and rest[0].startswith("node_impls_"):
        # a supernet candidate's scope 'node_impls_<choice>_<i>' is the node
        # '<choice>_cand<i>'
        try:
            spec = model.get_submodule(base)
        except AttributeError:
            spec = None
        key = node_key_of_jax_scope(spec, rest[0]) if isinstance(spec, SpecModule) else None
        base += f".nodes.{key or rest[0][len('node_impls_'):]}"
        rest = rest[1:]
    if collection == "params" and len(rest) == 1 and rest[0].startswith(ARCH_PARAM_PREFIX):
        return f"{base}.{rest[0]}"
    if base == "module" or not rest:
        raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
    try:
        names = getattr(model.get_submodule(base), "jax_names", None)
    except AttributeError:
        raise KeyError(f"JAX variable {collection}/{'/'.join(path)}: the model has no "
                       f"'{base}'") from None
    if names is not None and rest[0] in names and len(rest) == 2:
        leaf = (_SUBMODULE_LEAF if collection == "params" else _STAT_LEAF).get(rest[1])
        if leaf is None:
            raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
        return f"{base}.{names[rest[0]]}.{leaf}"
    if collection == "params" and rest[0] == "op":
        # WeightNorm names its scale by one key with slashes in it
        body = tuple(p for r in rest[1:] for p in r.split("/"))
        wrapped = body[:1] == ("layer_instance",)
        body = body[1:] if wrapped else body
        leaf = _OP_LEAF.get(body[1:] if body[:1] == ("inner",) else body)
        if leaf is None or (leaf == "scale" and not wrapped):
            raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
        return f"{base}.op.{leaf}"
    m = _NORM_RE.match(rest[0])
    table = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    if m and len(rest) == 2 and rest[1] in table:
        return f"{base}.norms.{m.group(1)}.{table[rest[1]]}"
    if collection == "params" and len(rest) == 1 and rest[0] in _NODE_PARAMS:
        return f"{base}.{rest[0]}"
    if collection == "params" and len(rest) == 2 and \
            rest[1] in _SUBMODULE_PARAMS.get(rest[0], ()):
        return f"{base}.{rest[0]}.{rest[1]}"
    if collection == "params" and len(rest) >= 2 and rest[-1] in _SUBMODULE_LEAF:
        return f"{base}.{'.'.join(rest[:-1])}.{_SUBMODULE_LEAF[rest[-1]]}"
    raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")


def _convert(key: str, a: np.ndarray, target: torch.Tensor) -> np.ndarray:
    conv = a.ndim in (4, 5) or (a.ndim == 3 and key.endswith(".weight"))
    if key.rsplit(".", 1)[-1] in _KEPT_LAYOUT:
        pass
    elif conv:                          # (*k, I, O) -> (O, I, *k): HWIO, DHWIO, WIO
        cin = target.shape[1]
        if a.shape[-2] != cin:
            if not (cin < TPU_MIN_CHANNELS and a.shape[-2] == TPU_MIN_CHANNELS):
                raise ValueError(f"{key}: JAX kernel {a.shape} does not fit "
                                 f"{tuple(target.shape)}")
            a = a[..., :cin, :]
        a = a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
    elif a.ndim == 2:                   # dense (in, out) -> (out, in)
        a = a.T
    if tuple(a.shape) != tuple(target.shape):
        raise ValueError(f"{key}: converted shape {a.shape} != {tuple(target.shape)}")
    return a


def _fold_padded_rows(out: Dict[str, torch.Tensor], op: str, full: np.ndarray,
                      eps: float) -> None:
    """Fold the norm of a weight-normed kernel's cut rows into its scale, so
    that ``weight_norm(v_kept, scale')`` equals the JAX ``WeightNorm`` of
    the full kernel on the kept rows."""
    full = full.astype(np.float64)
    kept = full[:, :, :out[f"{op}.weight"].shape[1], :]
    ratio = np.sqrt((kept ** 2).sum((0, 1, 2)) + eps) / np.sqrt((full ** 2).sum((0, 1, 2)) + eps)
    scale = out[f"{op}.scale"]
    out[f"{op}.scale"] = torch.tensor(scale.double().numpy() * ratio, dtype=scale.dtype)


def _parts_state_dict(variables_np: Mapping[str, Any], model: torch.nn.Module,
                      parts) -> Dict[str, torch.Tensor]:
    """A model of several ``DeepcvModule``\\ s (``model.jax_parts``, the
    keypoints ``Autoencoder``'s ``encoder`` and ``decoder``), whose JAX
    variables hold one subtree per part in each collection."""
    for collection, tree in variables_np.items():
        extra = set(tree) - set(parts)
        if extra:
            raise KeyError(f"unmapped JAX variable {collection}/{sorted(extra)[0]}")
    out: Dict[str, torch.Tensor] = {}
    for part in parts:
        sub = {c: tree[part] for c, tree in variables_np.items() if part in tree}
        out.update({f"{part}.{k}": v for k, v in
                    jax_to_torch_state_dict(sub, getattr(model, part)).items()})
    return out


def _flat_state_dict(variables_np: Mapping[str, Any], model: torch.nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """A model whose parameter names are its JAX variables' paths
    (``model.jax_flat``: the video models): ``a/b/kernel`` -> ``a.b.weight``,
    ``scale`` -> ``weight``, ``bias`` -> ``bias``, any other leaf (the
    temporal transformer's ``pos_embedding``) kept by name and layout."""
    targets = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables_np.items():
        for path, arr in _flatten(tree):
            key = ".".join(path[:-1] + (_SUBMODULE_LEAF.get(path[-1], path[-1]),))
            if collection != "params" or key not in targets:
                raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
            t = targets[key]
            out[key] = torch.tensor(_convert(key, arr, t), dtype=t.dtype)
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"no JAX variable for {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out


def jax_to_torch_state_dict(variables_np: Mapping[str, Any],
                            model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``model`` from the JAX variables of the same spec
    (``{'params': ..., 'batch_stats': ...}`` as numpy arrays)."""
    parts = getattr(model, "jax_parts", None)
    if parts:
        return _parts_state_dict(variables_np, model, parts)
    if getattr(model, "jax_flat", False):
        return _flat_state_dict(variables_np, model)
    targets = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    padded: Dict[str, np.ndarray] = {}     # conv kernels whose padded rows were cut
    for collection, tree in variables_np.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unmapped JAX collection '{collection}'")
        for path, arr in _flatten(tree):
            key = _torch_key(collection, path, model)
            if key not in targets:
                raise KeyError(f"JAX variable {collection}/{'/'.join(path)} maps to "
                               f"'{key}', which the model does not have")
            t = targets[key]
            out[key] = torch.tensor(_convert(key, arr, t), dtype=t.dtype)
            if arr.ndim == 4 and arr.shape[2] != t.shape[1]:
                padded[key] = arr
    for key, full in padded.items():
        op = key.rsplit(".", 1)[0]
        if f"{op}.scale" in out and np.any(full[:, :, out[key].shape[1]:, :]):
            _fold_padded_rows(out, op, full, model.get_submodule(op).weight_norm_eps)
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"no JAX variable for {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out


def load_jax_variables(model: torch.nn.Module, variables_np: Mapping[str, Any]):
    """Load JAX variables into ``model`` in place; returns the model."""
    model.load_state_dict(jax_to_torch_state_dict(variables_np, model))
    return model


_NORM_TYPES = (torch.nn.LayerNorm, torch.nn.GroupNorm, torch.nn.modules.batchnorm._NormBase)


def _is_norm(module: torch.nn.Module) -> bool:
    return isinstance(module, _NORM_TYPES) or "Norm" in type(module).__name__


def _jax_path(name: str, model: torch.nn.Module) -> str:
    """The JAX path of one parameter of a spec-engine model, checked by
    mapping it back with :func:`_torch_key`."""
    parts = name.split(".")
    path, i = [], 1     # parts[0] is 'module'
    while i + 1 < len(parts) and parts[i] == "nodes":
        spec = model.get_submodule(".".join(parts[:i]))
        path.append(jax_scope_name(spec, parts[i + 1]) if isinstance(spec, SpecModule)
                    else f"node_impls_{parts[i + 1]}")
        i += 2
    base, rest = ".".join(parts[:i]), parts[i:]
    owner = model.get_submodule(".".join(parts[:-1]))
    names = getattr(model.get_submodule(base), "jax_names", None) or {}
    by_value = {v: k for k, v in names.items()}
    leaf = rest[-1]
    if ".".join(rest[:-1]) in by_value and len(rest) >= 2:
        jax_leaf = {"weight": "scale" if _is_norm(owner) else "kernel"}.get(leaf, leaf)
        if leaf in ("running_mean", "running_var"):
            raise KeyError(name)
        path += [by_value[".".join(rest[:-1])], jax_leaf]
    elif rest[0] == "op":
        weight_norm = hasattr(owner, "scale") and isinstance(owner.scale, torch.nn.Parameter)
        inner = ["inner"] if getattr(owner, "flatten_input", False) else []
        body = {"weight": ["kernel"], "bias": ["bias"], "scale": ["kernel", "scale"]}[leaf]
        path += ["op", *(["layer_instance"] if weight_norm else inner), *body]
    elif rest[0] == "norms":
        path += [f"norms_{rest[1]}", {"weight": "scale"}.get(leaf, leaf)]
    elif len(rest) == 1 or leaf in _KEPT_LAYOUT:
        path += rest
    else:
        path += [*rest[:-1], {"weight": "scale" if _is_norm(owner) else "kernel"}.get(leaf, leaf)]
    back = _torch_key("params", tuple(p for r in path for p in r.split("/")), model)
    if back != name:
        raise KeyError(f"parameter '{name}': JAX path {'/'.join(path)} maps back to '{back}'")
    return "/".join(path)


def jax_param_paths(model: torch.nn.Module) -> Dict[str, str]:
    """Each trainable parameter's name -> its '/'-joined path in the JAX
    package's ``variables['params']`` for the same model (the inverse of the
    mapping :func:`jax_to_torch_state_dict` applies), the paths that
    ``freeze_params`` and ``lr_scales`` match. A model of parts
    (``jax_parts``) prefixes each part's paths with its name; a model named
    by its JAX paths (``jax_flat``) maps ``a.b.weight`` to ``a/b/kernel``
    (``scale`` for a norm); any other model joins its names by '/'."""
    named = dict(model.named_parameters())
    parts = getattr(model, "jax_parts", None)
    if parts:
        return {f"{part}.{k}": f"{part}/{v}" for part in parts
                for k, v in jax_param_paths(getattr(model, part)).items()}
    if getattr(model, "jax_flat", False) or not any(n.startswith("module.nodes.")
                                                    for n in named):
        out = {}
        for n in named:
            *mods, leaf = n.split(".")
            owner = model.get_submodule(".".join(mods))
            if leaf == "weight":
                leaf = "scale" if _is_norm(owner) else "kernel"
            out[n] = "/".join([*mods, leaf])
        return out
    return {n: _jax_path(n, model) for n in named}

"""Submodule-creator registry and the creators the first slice needs.

Counterpart of ``deepcv_tpu/spec/creators.py`` (``CreatorContext``,
``_as_layer``, ``_conv_common``, the conv creator with its kernel hook,
``fully_connected``, ``average_pooling``, ``max_pooling``, ``flatten``,
``activation``, ``residual_link``, ``dense_link``,
``_new_branch_from_tensor``).

A creator maps one spec entry to an ``nn.Module`` or a
:class:`ForwardCallback` (a parameter-free node over the current tensor and
referenced outputs). Unlike flax, torch modules need their input sizes at
construction, so a creator also receives ``in_shape``, the NCHW-logical shape
of the current tensor that the spec engine infers on the meta device.

Every plain stride-1 'same' odd-kernel 2-d conv becomes a
:class:`~deepcv_tpu_torch.ops.nn.FusedConv2d` — the CUDA kernel on a card —
whatever its channel count: the JAX package's >=32-channel gate and its
``DEEPCV_TPU_PALLAS`` opt-in were TPU matters and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.spec.tokens import YamlTokens

__all__ = [
    "CreatorContext", "ForwardCallback", "submodule_creator", "get_creator",
    "check_creator_params", "TENSOR_REDUCTION_FNS", "get_reduction_fn",
    "AvgPool", "MaxPool", "GLOBAL_LAYER_KEYS",
]

Shape = Tuple[int, ...]

# --------------------------------------------------------------------------- #
# Reductions (channel dim is 1 in the port)
# --------------------------------------------------------------------------- #


def _reduce_concat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(tensors), dim=1)


def _reduce_sum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t
    return out


def _reduce_mean(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return _reduce_sum(tensors) / float(len(tensors))


def _reduce_none(tensors: Sequence[torch.Tensor]):
    return list(tensors)


TENSOR_REDUCTION_FNS: Dict[str, Callable] = {
    "concat": _reduce_concat,
    "sum": _reduce_sum,
    "mean": _reduce_mean,
    "none": _reduce_none,
}


def get_reduction_fn(name_or_fn: Union[str, Callable, None], default: str = "concat") -> Callable:
    if name_or_fn is None:
        name_or_fn = default
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn not in TENSOR_REDUCTION_FNS:
        raise ValueError(f"Unknown reduction '{name_or_fn}', expected {list(TENSOR_REDUCTION_FNS)}")
    return TENSOR_REDUCTION_FNS[name_or_fn]


# --------------------------------------------------------------------------- #
# Creator protocol
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class CreatorContext:
    """Build-time context handed to creators."""
    hp: Mapping[str, Any]                      # global model hyperparameters
    submodule_names: Tuple[str, ...] = ()      # names defined so far


@dataclasses.dataclass
class ForwardCallback:
    """A parameter-free graph node applied to (x, referenced outputs).
    ``uses_current=False`` means x is ignored (``_new_branch_from_tensor``)."""
    fn: Callable[[Any, List[torch.Tensor]], Any]
    uses_current: bool = True

    def __call__(self, x, refs):
        return self.fn(x, refs)


#: global hp keys auto-forwarded to layer-producing creators
GLOBAL_LAYER_KEYS = ("act_fn", "dropout_prob", "preactivation") + dnn.NormTechnique.ALL

_CREATORS: Dict[str, Dict[str, Any]] = {}


def submodule_creator(name: str, *, aliases: Sequence[str] = (),
                      global_keys: Sequence[str] = (),
                      allowed: Optional[Sequence[str]] = None,
                      required: Sequence[str] = ()):
    """Register a submodule creator with its allowed/required params."""
    def dec(fn):
        entry = {"fn": fn, "global_keys": tuple(global_keys),
                 "allowed": tuple(allowed) if allowed is not None else None,
                 "required": tuple(required)}
        _CREATORS[name] = entry
        for a in aliases:
            _CREATORS[a] = entry
        return fn
    return dec


def get_creator(name: str) -> Optional[Dict[str, Any]]:
    return _CREATORS.get(name)


def check_creator_params(name: str, params: Mapping[str, Any]):
    """Validate spec params against the creator's allowed/required sets."""
    e = _CREATORS[name]
    keys = {k for k in params if not k.startswith("_")}
    if e["allowed"] is not None:
        extra = keys - set(e["allowed"]) - set(e["global_keys"])
        if extra:
            raise ValueError(f"Submodule creator '{name}': unexpected param(s) {sorted(extra)}; "
                             f"allowed: {sorted(set(e['allowed']) | set(e['global_keys']))}")
    missing = [k for k in e["required"] if params.get(k, None) is None]
    if missing:
        raise ValueError(f"Submodule creator '{name}': missing required param(s) {missing}")


# --------------------------------------------------------------------------- #
# Pooling modules
# --------------------------------------------------------------------------- #

class AvgPool(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x):
        return dnn.avg_pool_nd(x, self.kernel_size, self.stride, self.padding)


class MaxPool(AvgPool):
    def forward(self, x):
        return dnn.max_pool_nd(x, self.kernel_size, self.stride, self.padding)


# --------------------------------------------------------------------------- #
# Layer-unit creator helpers
# --------------------------------------------------------------------------- #

def _norm_specs_from_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    return {t: params[t] for t in dnn.NormTechnique.ALL
            if params.get(t) not in (None, False) and t in params}


def _as_layer(op: nn.Module, params: Mapping[str, Any], in_ch: int, out_ch: int,
              act_in_op: bool = False) -> dnn.Layer:
    """Wrap an op into the ``layer()`` unit with act/norms/dropout; norms see
    ``in_ch`` channels before the op (pre-activation) or ``out_ch`` after."""
    preact = bool(params.get("preactivation", False))
    return dnn.Layer(
        op=op, act_fn=dnn.get_activation(params.get("act_fn")),
        dropout_prob=float(params.get("dropout_prob") or 0.0),
        preactivation=preact,
        norms=dnn.normalization_techniques(_norm_specs_from_params(params),
                                           in_ch if preact else out_ch),
        act_in_op=act_in_op)


def _conv_common(params: Mapping[str, Any], rank: int):
    ks = params["kernel_size"]
    ks = tuple(ks) if isinstance(ks, (list, tuple)) else (int(ks),) * rank
    strides = params.get("stride", params.get("strides", 1))
    strides = tuple(strides) if isinstance(strides, (list, tuple)) else (int(strides),) * len(ks)
    pad = params.get("padding", None)
    if pad is None:
        pad = dnn.get_padding_from_kernel(ks)  # auto 'same'
    if isinstance(pad, str):
        padding = pad.upper()
    else:
        pads = tuple(pad) if isinstance(pad, (list, tuple)) else (int(pad),) * len(ks)
        padding = tuple((int(p), int(p)) for p in pads)
    dilation = params.get("dilation", 1)
    dilation = tuple(dilation) if isinstance(dilation, (list, tuple)) else (int(dilation),) * len(ks)
    return ks, strides, padding, dilation


_CONV_ALLOWED = ("kernel_size", "out_channels", "padding", "stride", "strides",
                 "dilation", "groups", "use_bias", "bias", "output_padding")


def _torch_padding(padding, ks, strides, name):
    """Per-dim symmetric torch padding from the spec's padding."""
    if padding == "VALID":
        return (0,) * len(ks)
    if padding == "SAME":
        if any(s != 1 for s in strides) or any(k % 2 == 0 for k in ks):
            raise NotImplementedError(
                f"Submodule '{name}': padding 'SAME' is ported for stride-1 "
                "odd kernels only; give integer padding")
        return tuple(k // 2 for k in ks)
    return tuple(p for p, _ in padding)


@submodule_creator("conv2d", global_keys=GLOBAL_LAYER_KEYS, allowed=_CONV_ALLOWED,
                   required=("kernel_size", "out_channels"))
def _conv2d(params: Mapping[str, Any], ctx: CreatorContext, name: str,
            in_shape: Shape) -> nn.Module:
    if len(in_shape) != 4:
        raise ValueError(f"Submodule '{name}' (conv2d): input must be 2-d "
                         f"spatial, got shape {list(in_shape)}")
    ks, strides, padding, dilation = _conv_common(params, 2)
    if params.get("output_padding"):
        raise ValueError(f"Submodule '{name}': 'output_padding' only applies "
                         "to transposed convolutions")
    gain = dnn.get_gain(params.get("act_fn"))
    use_bias = bool(params.get("use_bias", params.get("bias", True)))
    in_ch, out_ch = int(in_shape[1]), int(params["out_channels"])
    groups = int(params.get("groups", 1))
    pads = _torch_padding(padding, ks, strides, name)
    # the kernel hook: every plain stride-1 'same' odd-kernel conv; the
    # activation fuses into the kernel's epilogue in post-activation order
    plain = (groups == 1 and strides == (1, 1) and dilation == (1, 1)
             and all(k % 2 == 1 for k in ks)
             and pads == tuple(k // 2 for k in ks))
    if plain:
        preact = bool(params.get("preactivation", False))
        act = None if preact else dnn.get_activation(params.get("act_fn"))
        op = dnn.FusedConv2d(in_ch, out_ch, ks, act=act, use_bias=use_bias, gain=gain)
        return _as_layer(op, params, in_ch, out_ch, act_in_op=not preact)
    op = dnn.Conv2d(in_ch, out_ch, ks, stride=strides, padding=pads,
                    dilation=dilation, groups=groups, use_bias=use_bias, gain=gain)
    return _as_layer(op, params, in_ch, out_ch)


@submodule_creator("fully_connected", aliases=("linear",), global_keys=GLOBAL_LAYER_KEYS,
                   allowed=("out_features", "use_bias", "bias", "flatten_input"))
def _fully_connected(params: Mapping[str, Any], ctx: CreatorContext, name: str,
                     in_shape: Shape) -> nn.Module:
    out_features = params.get("out_features")
    if out_features is None:
        raise ValueError(
            f"Submodule '{name}' (fully_connected): 'out_features' unresolved; "
            "set it explicitly for standalone use.")
    flatten = bool(params.get("flatten_input"))
    in_features = 1
    for d in (in_shape[1:] if flatten else in_shape[1:2]):
        in_features *= int(d)
    op = dnn.Dense(in_features, int(out_features),
                   use_bias=bool(params.get("use_bias", params.get("bias", True))),
                   gain=dnn.get_gain(params.get("act_fn")), flatten_input=flatten)
    return _as_layer(op, params, int(in_shape[1]), int(out_features))


def _pool_params(params):
    ks = tuple(params["kernel_size"])
    stride = params.get("stride")
    stride = tuple(stride) if stride is not None else None
    return ks, stride, params.get("padding", 0)


@submodule_creator("average_pooling", aliases=("avg_pooling", "avg_pool"),
                   allowed=("kernel_size", "stride", "padding"), required=("kernel_size",))
def _avg_pooling(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    return AvgPool(*_pool_params(params))


@submodule_creator("max_pooling", aliases=("max_pool",),
                   allowed=("kernel_size", "stride", "padding"), required=("kernel_size",))
def _max_pooling(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    return MaxPool(*_pool_params(params))


@submodule_creator("flatten", allowed=())
def _flatten(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    return dnn.Flatten()


@submodule_creator("activation", aliases=("act",), global_keys=("act_fn",),
                   allowed=("act_fn",))
def _activation(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Bare activation node — e.g. the post-sum ReLU of a residual block."""
    return dnn.Layer(op=dnn.Identity(), act_fn=dnn.get_activation(params.get("act_fn")))


# --------------------------------------------------------------------------- #
# Callback creators: links and new branches
# --------------------------------------------------------------------------- #

def _maybe_rescale(ref: torch.Tensor, like: torch.Tensor, allow_scaling: bool,
                   name: str) -> torch.Tensor:
    if ref.shape[2:] != like.shape[2:]:
        if not allow_scaling:
            raise ValueError(
                f"Link '{name}': referenced output spatial shape {tuple(ref.shape[2:])} != "
                f"current {tuple(like.shape[2:])} and allow_scaling=False")
        ref = dnn.interpolate(ref, like.shape[2:])
    return ref


_LINK_ALLOWED = ("allow_scaling", "reduction", "scaling_mode",
                 YamlTokens.FROM, YamlTokens.FROM_NAS_INPUT_CHOICE)


@submodule_creator("residual_link", aliases=("add_link",), allowed=_LINK_ALLOWED)
def _residual_link(params, ctx: CreatorContext, name: str, in_shape: Shape) -> ForwardCallback:
    allow_scaling = bool(params.get("allow_scaling", False))
    reduction = get_reduction_fn(params.get("reduction"), default="sum")

    def fn(x, refs):
        if not refs:
            return x
        refs = [_maybe_rescale(r, x, allow_scaling, name) for r in refs]
        combined = reduction(refs) if len(refs) > 1 else refs[0]
        if combined.shape[1] != x.shape[1]:
            raise ValueError(
                f"residual_link '{name}': channel mismatch {combined.shape[1]} vs "
                f"{x.shape[1]} — residual refs must preserve channel count")
        return x + combined.to(x.dtype)

    return ForwardCallback(fn=fn)


@submodule_creator("dense_link", aliases=("concat_link",), allowed=_LINK_ALLOWED)
def _dense_link(params, ctx: CreatorContext, name: str, in_shape: Shape) -> ForwardCallback:
    allow_scaling = bool(params.get("allow_scaling", False))

    def fn(x, refs):
        if not refs:
            return x
        refs = [_maybe_rescale(r, x, allow_scaling, name).to(x.dtype) for r in refs]
        return torch.cat([x, *refs], dim=1)

    return ForwardCallback(fn=fn)


@submodule_creator(YamlTokens.NEW_BRANCH_FROM_TENSOR, aliases=("new_branch_from_tensor",),
                   allowed=("reduction", YamlTokens.FROM, YamlTokens.FROM_NAS_INPUT_CHOICE))
def _new_branch(params, ctx: CreatorContext, name: str, in_shape: Shape) -> ForwardCallback:
    """Start a new branch from referenced output(s), discarding the current
    tensor (e.g. a ResNet projection shortcut)."""
    reduction = get_reduction_fn(params.get("reduction"), default="none")

    def fn(x, refs):
        return reduction(refs) if len(refs) > 1 else refs[0]

    return ForwardCallback(fn=fn, uses_current=False)

"""Submodule-creator registry and the creators the first slice needs.

Counterpart of ``deepcv_tpu/spec/creators.py`` (``CreatorContext``,
``_as_layer``, ``_conv_common``, the ``conv{1,2,3}d`` creators with the
2-d one's kernel hook,
``fully_connected``, ``average_pooling``, ``max_pooling``, ``flatten``,
``activation``, ``residual_link``, ``dense_link``,
``_new_branch_from_tensor``, ``interpolate``, ``fpn``, the HRNet nodes
``hrnet_input_stem``, ``parallel_conv``, ``multiresolution_fusion`` and
``hrnet_repr_head_{v1,v2,vZ,v2p}``, the ViT nodes ``patch_embed``,
``transformer_block`` (with the V-MoE ``moe``), ``take_token`` and
``norm``, the Swin nodes ``swin_block`` and ``patch_merging``, the
squeeze-excitation
cell ``squeeze_cell`` and the ConvNeXt nodes ``convnext_stem``,
``convnext_downsample`` and ``convnext_block``).

A creator maps one spec entry to an ``nn.Module`` or a
:class:`ForwardCallback` (a parameter-free node over the current tensor and
referenced outputs). Unlike flax, torch modules need their input sizes at
construction, so a creator also receives ``in_shape``, the NCHW-logical shape
of the current tensor that the spec engine infers on the meta device (a
list of shapes after a node that outputs parallel streams, as HRNet's do).

Every plain stride-1 'same' odd-kernel 2-d conv becomes a
:class:`~deepcv_tpu_torch.ops.nn.FusedConv2d` — the CUDA kernel on a card —
whatever its channel count: the JAX package's >=32-channel gate and its
``DEEPCV_TPU_PALLAS`` opt-in were TPU matters and are not carried over.

The hp ``weight_norm`` (``{eps: ...}``, ``CreatorContext.weight_norm``)
wraps the op of every layer-unit creator (``conv2d``, ``fully_connected``)
in flax's ``WeightNorm``, as the JAX package's ``_as_layer`` does; a conv
so wrapped still runs the kernel, on the normalised weight. An op that
cannot take it raises, naming its submodule.

Under ``CreatorContext.quantize`` (the model's ``quantize``) the ops the
JAX package overrides with its int8 or fake-quant ops get a
``compression.QuantSpec`` (:func:`_quant`): the conv creators' (which then
never take the kernel hook), ``fully_connected``'s, and the projections of
``patch_embed`` (``proj``), ``transformer_block`` and ``swin_block``
(``attn/qkv``, ``attn/out``, ``mlp/fc1``, ``mlp/fc2``; not the V-MoE
experts) and ``patch_merging`` (``reduce``), each with its calibrated
scale by full node path.
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
#: a tensor's shape, or a stream list's shapes
Shapes = Union[Shape, List[Shape]]

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
    weight_norm: Optional[Mapping[str, Any]] = None   # hp 'weight_norm'
    #: the model's input is a 1-d signal (W, C): its 3-d tensors are NCW maps
    signal_1d: bool = False
    #: 'int8' (w8a8, inference only) or 'int<N>_qat' (fake quant): the conv,
    #: dense and transformer creators set their ops' ``quant``
    quantize: Optional[str] = None
    #: static activation scales by full node path, from
    #: ``compression.calibrate_int8_scales`` (absent nodes quantize dynamically)
    quantize_scales: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: nesting prefix ('<nested name>/'), so that scale keys are full paths
    scope: str = ""
    #: 'fixed' (one candidate per NAS choice) or 'supernet' (all, mixed)
    nas_mode: str = "fixed"
    #: fixed mode's choices by mutable name (nested ones '<nested>/<local>')
    nas_arch: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ForwardCallback:
    """A parameter-free graph node applied to (x, referenced outputs).
    ``uses_current=False`` means x is ignored (``_new_branch_from_tensor``).
    ``apply_in_parallel`` zips the callback over a stream list: stream i
    sees stream i of each referenced stream list (a list with fewer
    streams gives it none) and every referenced single tensor."""
    fn: Callable[[Any, List[torch.Tensor]], Any]
    uses_current: bool = True
    apply_in_parallel: bool = False

    def __call__(self, x, refs):
        if not (self.apply_in_parallel and isinstance(x, (list, tuple))):
            return self.fn(x, refs)
        out = []
        for i, xi in enumerate(x):
            refs_i = [r[i] if isinstance(r, (list, tuple)) else r for r in refs
                      if not isinstance(r, (list, tuple)) or i < len(r)]
            out.append(self.fn(xi, refs_i))
        return out


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


def _as_layer(op: nn.Module, params: Mapping[str, Any], ctx: CreatorContext, name: str,
              in_ch: int, out_ch: int, act_in_op: bool = False) -> dnn.Layer:
    """Wrap an op into the ``layer()`` unit with act/norms/dropout; norms see
    ``in_ch`` channels before the op (pre-activation) or ``out_ch`` after.
    With ``ctx.weight_norm`` the op's weight is reparameterised first (eps
    1e-12 unless given, flax's default)."""
    if ctx.weight_norm:
        add = getattr(op, "add_weight_norm", None)
        if add is None:
            from deepcv_tpu_torch.spec.graph import SpecError
            raise SpecError(f"Submodule '{name}': hp 'weight_norm' cannot wrap its op "
                            f"{type(op).__name__}")
        add(float(ctx.weight_norm.get("eps", 1e-12)))
    preact = bool(params.get("preactivation", False))
    return dnn.Layer(
        op=op, act_fn=dnn.get_activation(params.get("act_fn")),
        dropout_prob=float(params.get("dropout_prob") or 0.0),
        preactivation=preact,
        norms=dnn.normalization_techniques(_norm_specs_from_params(params),
                                           in_ch if preact else out_ch),
        act_in_op=act_in_op)


def _quant(ctx: CreatorContext, name: str, sub: Optional[str] = None):
    """The ``QuantSpec`` of node ``name``'s op (or of its sub-layer ``sub``,
    whose calibrated scale falls back to the node's), None in a float
    build."""
    from deepcv_tpu_torch.compression import QuantSpec
    scale = ctx.quantize_scales.get(ctx.scope + name)
    if sub is not None:
        scale = ctx.quantize_scales.get(f"{ctx.scope}{name}/{sub}", scale)
    return QuantSpec.make(ctx.quantize, scale)


def _quantize_subs(module: nn.Module, ctx: CreatorContext, name: str,
                   subs: Sequence[str]) -> nn.Module:
    """Set the ``quant`` of the Dense ops at the '/'-paths ``subs`` below
    ``module`` (the JAX package's per-sublayer dot overrides)."""
    if ctx.quantize:
        for sub in subs:
            module.get_submodule(sub.replace("/", ".")).quant = _quant(ctx, name, sub)
    return module


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


#: norms a 1-d map (NCW) takes: those over the channel dim 1
_NCW_NORMS = (dnn.NormTechnique.BATCH_NORM, dnn.NormTechnique.GROUP_NORM)


def _make_conv_creator(rank: int):
    """The ``conv<rank>d`` creator. Only rank 2 takes the kernel, as in the
    JAX package (its ``PallasConv`` hook is 2-d only): every plain stride-1
    'same' odd-kernel 2-d conv; a 1-d or 3-d conv is a plain
    :class:`~deepcv_tpu_torch.ops.nn.ConvNd`."""
    def creator(params: Mapping[str, Any], ctx: CreatorContext, name: str,
                in_shape: Shape) -> nn.Module:
        if len(in_shape) != rank + 2:
            raise ValueError(f"Submodule '{name}' (conv{rank}d): input must be {rank}-d "
                             f"spatial, got shape {list(in_shape)}")
        ks, strides, padding, dilation = _conv_common(params, rank)
        if params.get("output_padding"):
            raise ValueError(f"Submodule '{name}': 'output_padding' only applies "
                             "to transposed convolutions")
        if rank == 1:
            bad = [t for t in _norm_specs_from_params(params) if t not in _NCW_NORMS]
            if bad:
                raise ValueError(f"Submodule '{name}' (conv1d): norms {bad} would take "
                                 f"the length as the feature dim; 1-d maps take "
                                 f"{list(_NCW_NORMS)}")
        gain = dnn.get_gain(params.get("act_fn"))
        use_bias = bool(params.get("use_bias", params.get("bias", True)))
        in_ch, out_ch = int(in_shape[1]), int(params["out_channels"])
        groups = int(params.get("groups", 1))
        pads = _torch_padding(padding, ks, strides, name)
        # the kernel hook: every plain stride-1 'same' odd-kernel 2-d conv;
        # the activation fuses into the kernel's epilogue in post-activation
        # order
        plain = (rank == 2 and groups == 1 and strides == (1, 1) and dilation == (1, 1)
                 and all(k % 2 == 1 for k in ks)
                 and pads == tuple(k // 2 for k in ks) and not ctx.quantize)
        if plain:
            preact = bool(params.get("preactivation", False))
            act = None if preact else dnn.get_activation(params.get("act_fn"))
            op = dnn.FusedConv2d(in_ch, out_ch, ks, act=act, use_bias=use_bias, gain=gain)
            return _as_layer(op, params, ctx, name, in_ch, out_ch, act_in_op=not preact)
        cls = dnn.Conv2d if rank == 2 else dnn.ConvNd
        op = cls(in_ch, out_ch, ks, stride=strides, padding=pads, dilation=dilation,
                 groups=groups, use_bias=use_bias, gain=gain)
        op.quant = _quant(ctx, name)
        return _as_layer(op, params, ctx, name, in_ch, out_ch)
    return creator


for _r in (1, 2, 3):
    submodule_creator(f"conv{_r}d", global_keys=GLOBAL_LAYER_KEYS, allowed=_CONV_ALLOWED,
                      required=("kernel_size", "out_channels"))(_make_conv_creator(_r))


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
    if ctx.signal_1d and len(in_shape) == 3 and not flatten:
        raise ValueError(f"Submodule '{name}' (fully_connected): a 1-d map {list(in_shape)} "
                         "takes a dense layer after 'flatten' (or with flatten_input)")
    fdim = _feature_dim(in_shape)
    in_features = 1
    for d in (in_shape[1:] if flatten else in_shape[fdim:fdim + 1]):
        in_features *= int(d)
    op = dnn.Dense(in_features, int(out_features),
                   use_bias=bool(params.get("use_bias", params.get("bias", True))),
                   gain=dnn.get_gain(params.get("act_fn")), flatten_input=flatten)
    op.quant = _quant(ctx, name)
    return _as_layer(op, params, ctx, name, int(in_shape[fdim]), int(out_features))


def _feature_dim(shape: Shape) -> int:
    """:func:`deepcv_tpu_torch.ops.nn.feature_dim` of a tensor of ``shape``."""
    return 1 if len(shape) > 3 else len(shape) - 1


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


_LINK_ALLOWED = ("allow_scaling", "reduction", "apply_in_parallel", "scaling_mode",
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

    return ForwardCallback(fn=fn, apply_in_parallel=bool(params.get("apply_in_parallel", False)))


@submodule_creator("dense_link", aliases=("concat_link",), allowed=_LINK_ALLOWED)
def _dense_link(params, ctx: CreatorContext, name: str, in_shape: Shape) -> ForwardCallback:
    allow_scaling = bool(params.get("allow_scaling", False))

    def fn(x, refs):
        if not refs:
            return x
        refs = [_maybe_rescale(r, x, allow_scaling, name).to(x.dtype) for r in refs]
        return torch.cat([x, *refs], dim=1)

    return ForwardCallback(fn=fn, apply_in_parallel=bool(params.get("apply_in_parallel", False)))


@submodule_creator(YamlTokens.NEW_BRANCH_FROM_TENSOR, aliases=("new_branch_from_tensor",),
                   allowed=("reduction", YamlTokens.FROM, YamlTokens.FROM_NAS_INPUT_CHOICE))
def _new_branch(params, ctx: CreatorContext, name: str, in_shape: Shape) -> ForwardCallback:
    """Start a new branch from referenced output(s), discarding the current
    tensor (e.g. a ResNet projection shortcut)."""
    reduction = get_reduction_fn(params.get("reduction"), default="none")

    def fn(x, refs):
        return reduction(refs) if len(refs) > 1 else refs[0]

    return ForwardCallback(fn=fn, uses_current=False)


@submodule_creator("interpolate", aliases=("upsample", "resize"),
                   allowed=("size", "scale", "method"))
def _interpolate(params, ctx: CreatorContext, name: str, in_shape: Shapes) -> nn.Module:
    """Spatial resize node: to ``size: [h, w]`` or by ``scale: k``,
    ``method: linear`` (bilinear, the default) or ``nearest``."""
    size = params.get("size")
    return dnn.Interpolate(size=size or None, scale=float(params.get("scale") or 0.0),
                           method=str(params.get("method", "linear")))


@submodule_creator("fpn", aliases=("feature_pyramid",), allowed=("channels", "head_outputs"))
def _fpn(params, ctx: CreatorContext, name: str, in_shape: Shapes) -> nn.Module:
    """Feature Pyramid Network over the stream list of a
    ``_new_branch_from_tensor`` gather of named levels (fine to coarse);
    ``head_outputs`` adds the shared 3x3 head and emits the flat (N,
    T_total, head_outputs) dense prediction."""
    if not isinstance(in_shape, list) or len(in_shape) < 2:
        raise ValueError(f"Submodule '{name}': {dnn.FeaturePyramid.NEEDS_LIST}")
    return dnn.FeaturePyramid([int(s[1]) for s in in_shape],
                              channels=int(params.get("channels", 64)),
                              head_outputs=int(params.get("head_outputs", 0)))


# --------------------------------------------------------------------------- #
# HRNet nodes
# --------------------------------------------------------------------------- #

def _stream_shapes(in_shape: Shapes, name: str, creator: str) -> List[Shape]:
    shapes = list(in_shape) if isinstance(in_shape, list) else [in_shape]
    if any(len(s) != 4 for s in shapes):
        raise ValueError(f"Submodule '{name}' ({creator}): streams must be image feature "
                         f"maps, got shapes {shapes}")
    return [tuple(s) for s in shapes]


def _layer_kwargs(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The global layer keys of an HRNet node's layer units."""
    return dict(act_fn=dnn.get_activation(params.get("act_fn")),
                dropout_prob=float(params.get("dropout_prob") or 0.0),
                preactivation=bool(params.get("preactivation", False)),
                norm_specs=_norm_specs_from_params(params))


@submodule_creator("hrnet_input_stem", global_keys=GLOBAL_LAYER_KEYS,
                   allowed=("out_channels", "conv_count"), required=("out_channels",))
def _hrnet_stem(params, ctx: CreatorContext, name: str, in_shape: Shapes) -> nn.Module:
    from deepcv_tpu_torch.ops.hrnet import HRNetInputStem
    return HRNetInputStem(_stream_shapes(in_shape, name, "hrnet_input_stem")[0][1],
                          int(params["out_channels"]),
                          conv_count=int(params.get("conv_count", 2)), **_layer_kwargs(params))


@submodule_creator("parallel_conv", aliases=("parallel_convolution",),
                   global_keys=GLOBAL_LAYER_KEYS,
                   allowed=("kernel_size", "out_channels", "groups"),
                   required=("kernel_size", "out_channels"))
def _parallel_conv(params, ctx: CreatorContext, name: str, in_shape: Shapes) -> nn.Module:
    from deepcv_tpu_torch.ops.hrnet import ParallelConvolution
    return ParallelConvolution([s[1] for s in _stream_shapes(in_shape, name, "parallel_conv")],
                               params["kernel_size"], params["out_channels"],
                               groups=params.get("groups", 1), **_layer_kwargs(params))


@submodule_creator("multiresolution_fusion", global_keys=GLOBAL_LAYER_KEYS,
                   allowed=("create_new_branch", "new_branch_channels",
                            "reuse_scaling_convs"))
def _multires_fusion(params, ctx: CreatorContext, name: str, in_shape: Shapes) -> nn.Module:
    from deepcv_tpu_torch.ops.hrnet import MultiresolutionFusion
    nb = params.get("new_branch_channels")
    return MultiresolutionFusion(
        _stream_shapes(in_shape, name, "multiresolution_fusion"),
        create_new_branch=bool(params.get("create_new_branch", True)),
        new_branch_channels=int(nb) if nb else None,
        reuse_scaling_convs=bool(params.get("reuse_scaling_convs", False)),
        act_fn=dnn.get_activation(params.get("act_fn")))


def _hrnet_head(version: str):
    def creator(params, ctx: CreatorContext, name: str, in_shape: Shapes) -> nn.Module:
        from deepcv_tpu_torch.ops import hrnet
        chans = [s[1] for s in _stream_shapes(in_shape, name, f"hrnet_repr_head_{version}")]
        if version == "v1":
            return hrnet.HRNetV1RepresentationHead()
        oc = params.get("out_channels")
        kw = dict(out_channels=int(oc) if oc else None,
                  act_fn=dnn.get_activation(params.get("act_fn")))
        if version == "v2":
            return hrnet.HRNetV2RepresentationHead(chans, **kw)
        return hrnet.HRNetV2pRepresentationHead(
            chans, pyramid_levels=int(params.get("pyramid_levels", 3)), **kw)
    return creator


submodule_creator("hrnet_repr_head_v1", global_keys=GLOBAL_LAYER_KEYS,
                  allowed=())(_hrnet_head("v1"))
# the reference's YAML writes 'hrnet_repr_head_vZ', an alias of v2
submodule_creator("hrnet_repr_head_v2", aliases=("hrnet_repr_head_vZ",),
                  global_keys=GLOBAL_LAYER_KEYS, allowed=("out_channels",))(_hrnet_head("v2"))
submodule_creator("hrnet_repr_head_v2p", global_keys=GLOBAL_LAYER_KEYS,
                  allowed=("out_channels", "pyramid_levels"))(_hrnet_head("v2p"))


# --------------------------------------------------------------------------- #
# Vision-transformer nodes
# --------------------------------------------------------------------------- #

#: a transformer or Swin block's quantized projections
_BLOCK_SUBS = ("attn/qkv", "attn/out", "mlp/fc1", "mlp/fc2")


@submodule_creator("patch_embed",
                   allowed=("patch_size", "embed_dim", "use_cls_token",
                            "dropout_prob"),
                   required=("patch_size", "embed_dim"))
def _patch_embed(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Patchify + linear embed + [cls] + position table (reshape + one
    Dense, no stride-p conv): feature map in, tokens (N, T, D) out."""
    from deepcv_tpu_torch.ops.attention import PatchEmbed
    if len(in_shape) != 4:
        raise ValueError(f"Submodule '{name}' (patch_embed): input must be an "
                         f"image feature map, got shape {list(in_shape)}")
    return _quantize_subs(PatchEmbed(int(in_shape[1]), (int(in_shape[2]), int(in_shape[3])),
                                     int(params["patch_size"]), int(params["embed_dim"]),
                                     use_cls_token=bool(params.get("use_cls_token", True)),
                                     dropout_prob=float(params.get("dropout_prob") or 0.0)),
                          ctx, name, ("proj",))


@submodule_creator("transformer_block", aliases=("encoder_block",),
                   allowed=("num_heads", "mlp_dim", "dropout_prob",
                            "attn_dropout_prob", "drop_path_prob",
                            "attn_impl", "ln_eps", "moe", "mlp_act", "norm"),
                   required=("num_heads", "mlp_dim"))
def _transformer_block(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Pre-LN transformer encoder block on tokens (N, T, D)
    (``attn_impl: flash`` runs the flash-attention kernels; ``moe:
    {num_experts, k, capacity_factor, router_noise, group_size, mlp_dim}``
    swaps the dense MLP for the V-MoE expert mixture, ops/moe.py)."""
    from deepcv_tpu_torch.ops.attention import TransformerEncoderBlock
    moe = params.get("moe") or None
    if moe is not None and "num_experts" not in moe:
        raise ValueError(f"{name}: moe config requires num_experts (got {dict(moe)})")
    if len(in_shape) != 3:
        raise ValueError(f"Submodule '{name}' (transformer_block): input must be "
                         f"tokens (N, T, D), got shape {list(in_shape)}")
    block = TransformerEncoderBlock(
        int(in_shape[2]), int(params["num_heads"]), int(params["mlp_dim"]),
        dropout_prob=float(params.get("dropout_prob") or 0.0),
        attn_dropout_prob=float(params.get("attn_dropout_prob") or 0.0),
        drop_path_prob=float(params.get("drop_path_prob") or 0.0),
        attn_impl=str(params.get("attn_impl", "xla")),
        ln_eps=float(params.get("ln_eps", 1e-6)),
        norm=str(params.get("norm", "layer_norm")),
        mlp_act=str(params.get("mlp_act", "gelu")),
        moe=dict(moe) if moe else None)
    # the V-MoE experts and the attention products stay float, as in the JAX
    # package
    return _quantize_subs(block, ctx, name, ("attn/qkv", "attn/out") if moe else
                          _BLOCK_SUBS)


@submodule_creator("swin_block",
                   allowed=("num_heads", "window", "shift", "mlp_ratio",
                            "drop_path_prob", "ln_eps", "norm"),
                   required=("num_heads",))
def _swin_block(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Swin transformer block on a feature map (arXiv:2103.14030):
    (shifted-)window attention with relative-position bias + exact-GELU
    MLP; ``shift: window // 2`` gives the SW-MSA variant."""
    from deepcv_tpu_torch.ops.attention import SwinBlock
    block = SwinBlock(_feature_map_channels(in_shape, name, "swin_block"),
                     (int(in_shape[2]), int(in_shape[3])), int(params["num_heads"]),
                     window=int(params.get("window", 7)), shift=int(params.get("shift", 0)),
                     mlp_ratio=float(params.get("mlp_ratio", 4.0)),
                     drop_path_prob=float(params.get("drop_path_prob") or 0.0),
                     ln_eps=float(params.get("ln_eps", 1e-5)),
                     norm=str(params.get("norm", "layer_norm")))
    return _quantize_subs(block, ctx, name, _BLOCK_SUBS)


@submodule_creator("patch_merging", allowed=("ln_eps",))
def _patch_merging(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Swin between-stage downsampling: 2x2 concat + LN + bias-free
    Linear to 2C."""
    from deepcv_tpu_torch.ops.attention import PatchMerging
    return _quantize_subs(PatchMerging(_feature_map_channels(in_shape, name, "patch_merging"),
                                       ln_eps=float(params.get("ln_eps", 1e-5))),
                          ctx, name, ("reduce",))


@submodule_creator("take_token", allowed=("index",))
def _take_token(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """(N, T, D) -> (N, D): pick one token ([cls] by default)."""
    from deepcv_tpu_torch.ops.attention import TakeToken
    return TakeToken(int(params.get("index", 0)))


@submodule_creator("norm", aliases=("normalization",),
                   allowed=dnn.NormTechnique.ALL)
def _norm_node(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Bare normalization node, e.g. a ViT's final LayerNorm
    (``{layer_norm: {eps: 1e-6}}``), over the feature dim."""
    norms = dnn.normalization_techniques(_norm_specs_from_params(params),
                                         int(in_shape[_feature_dim(in_shape)]))
    if not norms:
        raise ValueError(f"Submodule '{name}' (norm): no normalization technique "
                         f"given; expected one of {list(dnn.NormTechnique.ALL)}")
    return dnn.Layer(op=dnn.Identity(), norms=norms)



# --------------------------------------------------------------------------- #
# Cells of the CNN zoo
# --------------------------------------------------------------------------- #

@submodule_creator("squeeze_cell", aliases=("squeeze_excitation", "se_cell"),
                   global_keys=("act_fn",),
                   allowed=("reduction_ratio", "hidden_channels", "gate_fn"))
def _squeeze_cell(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """Squeeze-excitation cell over the feature dim. ``act_fn`` (global)
    is its inner activation; ``hidden_channels`` pins the squeeze width
    (MobileNetV3's multiple-of-8 rounding); ``gate_fn`` swaps the sigmoid
    gate (MobileNetV3: 'hard_sigmoid')."""
    return dnn.SqueezeExcitation(
        int(in_shape[_feature_dim(in_shape)]),
        reduction_ratio=int(params.get("reduction_ratio", 4)),
        act_fn=dnn.get_activation(params.get("act_fn")),
        hidden_channels=int(params.get("hidden_channels", 0)),
        gate_fn=dnn.get_activation(params.get("gate_fn")))


def _feature_map_channels(in_shape: Shape, name: str, creator: str) -> int:
    if len(in_shape) != 4:
        raise ValueError(f"Submodule '{name}' ({creator}): input must be an image "
                         f"feature map, got shape {list(in_shape)}")
    return int(in_shape[1])


@submodule_creator("convnext_stem", allowed=("dim", "patch", "ln_eps"), required=("dim",))
def _convnext_stem(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """ConvNeXt patchify stem (reshape + Dense + LayerNorm)."""
    return dnn.ConvNeXtStem(_feature_map_channels(in_shape, name, "convnext_stem"),
                            int(params["dim"]), patch=int(params.get("patch", 4)),
                            ln_eps=float(params.get("ln_eps", 1e-6)))


@submodule_creator("convnext_downsample", allowed=("dim", "ln_eps"), required=("dim",))
def _convnext_downsample(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """ConvNeXt between-stage LayerNorm + 2x2 stride-2 conv."""
    return dnn.ConvNeXtDownsample(_feature_map_channels(in_shape, name, "convnext_downsample"),
                                  int(params["dim"]), ln_eps=float(params.get("ln_eps", 1e-6)))


@submodule_creator("convnext_block",
                   allowed=("drop_path_prob", "layer_scale_init", "ln_eps", "norm"))
def _convnext_block(params, ctx: CreatorContext, name: str, in_shape: Shape) -> nn.Module:
    """ConvNeXt block: dw7x7 -> LayerNorm (or rms_norm) -> 4C MLP (exact
    GELU) -> layer scale -> drop path -> residual."""
    return dnn.ConvNeXtBlock(
        _feature_map_channels(in_shape, name, "convnext_block"),
        drop_path_prob=float(params.get("drop_path_prob") or 0.0),
        layer_scale_init=float(params.get("layer_scale_init", 1e-6)),
        ln_eps=float(params.get("ln_eps", 1e-6)),
        norm=str(params.get("norm", "layer_norm")))

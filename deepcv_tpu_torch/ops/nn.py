"""NN building blocks of the port: activations, init, pooling, norms and the
``Layer`` unit.

Counterpart of ``deepcv_tpu/ops/nn.py`` (``get_activation``, ``get_gain``,
``xavier_normal_with_gain``, ``avg_pool_nd``, ``max_pool_nd``, ``BatchNorm``,
``make_token_norm``, ``normalization_techniques``, ``Layer``, ``DropPath``,
``Flatten``, ``SqueezeExcitation``, ``ConvNeXtStem``, ``ConvNeXtDownsample``,
``ConvNeXtBlock``, ``MeanOnlyBatchNorm``, ``Interpolate``,
``FeaturePyramid``) and of flax's
``WeightNorm`` around an op (:func:`weight_norm`,
:meth:`Conv2d.add_weight_norm`). Feature maps inside
a model are NCHW-logical in
``torch.channels_last`` memory, so their channel dim is 1 (the JAX package's
-1); token sequences (N, T, D) and rows (N, F) keep their features last, as
in the JAX package (:func:`feature_dim`). ``Flatten`` keeps the JAX
package's H*W*C order so dense kernels map 1:1.

Modules are built on the meta device (the spec engine infers shapes there)
and initialised afterwards by ``init_parameters(generator)``; nothing here
pads channels for the TPU (``pad_channels_for_tpu`` is not carried over).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch import compression
from deepcv_tpu_torch.ops.kernels import int8_conv as int8_kernel
from deepcv_tpu_torch.ops.kernels.fused_layer import (
    EPILOGUE_ACTS, LEAKY_RELU_SLOPE, fused_conv2d_bias_act, pack_weight)
from deepcv_tpu_torch.utils import get_by_identifier, register

__all__ = [
    "ACTIVATION_FNS", "XAVIER_GAINS", "get_activation", "activation_name",
    "get_gain", "xavier_normal_with_gain", "xavier_uniform_with_gain",
    "avg_pool_nd", "max_pool_nd", "interpolate", "NormTechnique", "BatchNorm",
    "MeanOnlyBatchNorm", "GroupNorm", "LayerNorm", "RMSNorm", "make_token_norm",
    "normalization_techniques", "weight_norm", "Conv2d", "ConvNd", "LecunConv2d", "FusedConv2d",
    "Dense", "Layer", "Identity", "Interpolate", "Flatten", "Dropout", "DropPath",
    "feature_dim", "gelu_exact", "gelu_tanh", "get_padding_from_kernel", "SqueezeExcitation",
    "ConvNeXtStem", "ConvNeXtDownsample", "ConvNeXtBlock", "FeaturePyramid",
]


def _leaky_relu(x):
    return F.leaky_relu(x, LEAKY_RELU_SLOPE)


def gelu_exact(x):
    """Exact (erf) GELU: ``torch.nn.GELU()`` and the JAX package's
    ``gelu_exact``."""
    return F.gelu(x)


def gelu_tanh(x):
    """The tanh approximation of GELU: ``jax.nn.gelu``'s default, registered
    as ``gelu`` in both packages."""
    return F.gelu(x, approximate="tanh")


def feature_dim(x: torch.Tensor) -> int:
    """The feature dim of a tensor inside a model: 1 for NCHW-logical feature
    maps (4-d and up), the last dim for token sequences and rows."""
    return 1 if x.dim() > 3 else x.dim() - 1


def _identity(x):
    return x


#: name -> activation callable (the subset of the JAX package's table that
#: torch computes identically)
ACTIVATION_FNS: Dict[str, Callable] = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "hard_swish": F.hardswish,
    "hard_sigmoid": F.hardsigmoid,
    "leaky_relu": _leaky_relu,
    "gelu_exact": gelu_exact,
    "gelu": gelu_tanh,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "elu": F.elu,
    "identity": _identity,
    "linear": _identity,
}

#: torch.nn.init.calculate_gain parity — per-activation Xavier gain
XAVIER_GAINS: Dict[str, float] = {
    "relu": math.sqrt(2.0),
    "relu6": math.sqrt(2.0),
    "hard_swish": math.sqrt(2.0),
    "leaky_relu": math.sqrt(2.0 / (1.0 + 0.01 ** 2)),
    "sigmoid": 1.0,
    "hard_sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "gelu": math.sqrt(2.0),
    "gelu_exact": math.sqrt(2.0),
    "silu": math.sqrt(2.0),
    "elu": 1.0,
    "identity": 1.0,
    "linear": 1.0,
}

for _n, _f in ACTIVATION_FNS.items():
    register(_n, _f)


def get_activation(act: Union[None, str, Callable]) -> Optional[Callable]:
    """Resolve an activation spec (name / callable / TaggedFactory / None)."""
    if act is None:
        return None
    resolve = getattr(act, "resolve", None)
    if resolve is not None:  # TaggedFactory from YAML
        return resolve()
    if callable(act) and not isinstance(act, str):
        return act
    return get_by_identifier(str(act))


def activation_name(fn: Optional[Callable]) -> Optional[str]:
    """The registered name of an activation callable (None for None or an
    unregistered callable)."""
    for name, f in ACTIVATION_FNS.items():
        if fn is f:
            return name
    return None


def get_gain(act: Union[None, str, Callable]) -> float:
    """Xavier gain for an activation spec."""
    if act is None:
        return 1.0
    name = act if isinstance(act, str) else getattr(act, "identifier", None) \
        or activation_name(act) or getattr(act, "__name__", "")
    name = str(name).rsplit(".", 1)[-1].lower()
    return XAVIER_GAINS.get(name, 1.0)


def _xavier_fans(shape) -> tuple:
    """(fan_in, fan_out) of a torch weight (out, in, *kernel)."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def xavier_normal_with_gain(gain: float = 1.0):
    """In-place Xavier-normal init: std = gain * sqrt(2 / (fan_in + fan_out))
    (the JAX package's conv init)."""
    def init(t: torch.Tensor, generator: torch.Generator):
        fan_in, fan_out = _xavier_fans(t.shape)
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return t.normal_(0.0, std, generator=generator)
    return init


def xavier_uniform_with_gain(gain: float = 1.0):
    """In-place Xavier-uniform init: limit = gain * sqrt(6 / (fan_in + fan_out))
    (the JAX package's dense init)."""
    def init(t: torch.Tensor, generator: torch.Generator):
        fan_in, fan_out = _xavier_fans(t.shape)
        limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return t.uniform_(-limit, limit, generator=generator)
    return init


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """In-place flax default kernel init: a normal truncated at 2 std,
    scaled so that the std after the truncation is sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / _xavier_fans(t.shape)[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def get_padding_from_kernel(kernel_size: Sequence[int]) -> tuple:
    """'same' padding from odd kernel sizes."""
    if any(k % 2 == 0 for k in kernel_size):
        raise ValueError(f"Cannot infer 'same' padding for even kernel {kernel_size}")
    return tuple(k // 2 for k in kernel_size)


def _pool_args(x, kernel_size, stride, padding):
    nd = x.dim() - 2
    k = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) else (kernel_size,) * nd
    s = tuple(stride) if isinstance(stride, (tuple, list)) else ((stride,) * nd if stride else k)
    p = tuple(padding) if isinstance(padding, (tuple, list)) else (int(padding or 0),) * nd
    if any(isinstance(v, (tuple, list)) for v in p):
        raise NotImplementedError("asymmetric pooling padding is not ported")
    return nd, k, s, p


def avg_pool_nd(x: torch.Tensor, kernel_size, stride=None, padding=0) -> torch.Tensor:
    """Average pooling over the spatial dims of an NC... tensor; padded zeros
    count in the mean, as in flax's ``avg_pool``."""
    nd, k, s, p = _pool_args(x, kernel_size, stride, padding)
    fn = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[nd]
    return fn(x, k, s, p, count_include_pad=True)


def max_pool_nd(x: torch.Tensor, kernel_size, stride=None, padding=0) -> torch.Tensor:
    """Max pooling over the spatial dims; padding is -inf."""
    nd, k, s, p = _pool_args(x, kernel_size, stride, padding)
    fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
    return fn(x, k, s, p)


def interpolate(x: torch.Tensor, target_shape: Sequence[int],
                method: str = "linear") -> torch.Tensor:
    """Resize the spatial dims to ``target_shape`` as the JAX package's
    ``jax.image.resize(..., method, antialias=False)`` does: 'linear' is
    (bi/tri)linear with half-pixel centres (``align_corners=False``);
    'nearest' takes the source pixel whose centre is nearest the output
    pixel's half-pixel centre, which is torch's ``'nearest-exact'`` (its
    ``'nearest'`` floors from the corners instead). Other methods raise."""
    if method not in ("linear", "nearest"):
        raise NotImplementedError(f"interpolate method '{method}' is not ported "
                                  "(ported: 'linear', 'nearest')")
    target = tuple(int(t) for t in target_shape)
    if tuple(x.shape[2:]) == target:
        return x
    if method == "nearest":
        return F.interpolate(x, size=target, mode="nearest-exact")
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[x.dim() - 2]
    return F.interpolate(x, size=target, mode=mode, align_corners=False)


# --------------------------------------------------------------------------- #
# Normalization
# --------------------------------------------------------------------------- #

class NormTechnique:
    """Normalization technique names (the JAX package's NormTechnique)."""
    BATCH_NORM = "batch_norm"
    LAYER_NORM = "layer_norm"
    INSTANCE_NORM = "instance_norm"
    GROUP_NORM = "group_norm"
    LOCAL_RESPONSE_NORM = "local_response_norm"
    LAYER_NRM_AND_MEAN_BATCH_NRM = "layer_nrm_and_mean_batch_nrm"
    RMS_NORM = "rms_norm"

    ALL = (BATCH_NORM, LAYER_NORM, INSTANCE_NORM, GROUP_NORM,
           LOCAL_RESPONSE_NORM, LAYER_NRM_AND_MEAN_BATCH_NRM, RMS_NORM)
    #: the techniques this port builds so far
    PORTED = (BATCH_NORM, GROUP_NORM, LAYER_NORM, RMS_NORM, LAYER_NRM_AND_MEAN_BATCH_NRM)


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class BatchNorm(nn.Module):
    """Batch normalization with torch semantics, as the JAX package's
    ``BatchNorm``: momentum ``running = (1 - m) * running + m * batch``, the
    biased variance to normalize and the Bessel-corrected one for the running
    update, statistics in float32, ``weight`` initialised uniform[0, 1).
    Eval mode folds the running statistics into one per-channel multiply-add
    in the input's dtype."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.num_features = int(num_features)
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.affine = bool(affine)
        if self.affine:
            self.weight = nn.Parameter(torch.empty(self.num_features))
            self.bias = nn.Parameter(torch.empty(self.num_features))
        self.register_buffer("running_mean", torch.empty(self.num_features))
        self.register_buffer("running_var", torch.empty(self.num_features))

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            if self.affine:
                self.weight.uniform_(0.0, 1.0, generator=generator)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            xf = x.float()
            n = x.numel() // x.shape[1]
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + self.eps)
        b = -mean * a
        if self.affine:
            a, b = a * self.weight, b * self.weight + self.bias
        a, b = _channel_view(a.to(x.dtype), x.dim()), _channel_view(b.to(x.dtype), x.dim())
        return torch.addcmul(b, x, a)


class MeanOnlyBatchNorm(nn.Module):
    """Mean-only batch normalization (the JAX package's ``MeanOnlyBatchNorm``,
    half of ``layer_nrm_and_mean_batch_nrm``): subtract the per-channel
    batch mean, taken in float32, in training and update ``running = (1 -
    m) * running + m * batch``; subtract the running mean in eval. No
    variance, no affine."""

    def __init__(self, num_features: int, momentum: float = 0.1):
        super().__init__()
        self.num_features, self.momentum = int(num_features), float(momentum)
        self.register_buffer("running_mean", torch.empty(self.num_features))

    def init_parameters(self, generator: torch.Generator):
        self.running_mean.zero_()

    def forward(self, x):
        fdim = feature_dim(x)
        if self.training:
            mean = x.float().mean([d for d in range(x.dim()) if d != fdim])
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
        else:
            mean = self.running_mean
        shape = [1] * x.dim()
        shape[fdim] = -1
        return x - mean.to(x.dtype).reshape(shape)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with the port's init protocol (ones/zeros)."""

    def init_parameters(self, generator: torch.Generator):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()


class LayerNorm(nn.Module):
    """Layer normalization over the feature dim (:func:`feature_dim`), as
    flax's ``LayerNorm`` over the last axis: statistics in float32, output
    in the input's dtype, ``weight`` ones and ``bias`` zeros."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.num_features, self.eps = int(num_features), float(eps)
        self.weight = nn.Parameter(torch.empty(self.num_features)) if affine else None
        self.bias = nn.Parameter(torch.empty(self.num_features)) if affine else None

    def init_parameters(self, generator: torch.Generator):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.num_features,), self.weight, self.bias, self.eps)

    def forward(self, x):
        dim = feature_dim(x)
        y = x.float().movedim(dim, -1)
        y = self._normalize(y).movedim(-1, dim)
        return y.to(x.dtype)


class RMSNorm(LayerNorm):
    """RMS normalization (flax ``RMSNorm``): x / sqrt(mean(x^2) + eps) *
    weight over the feature dim, no mean subtraction and no bias."""

    def __init__(self, num_features: int, eps: float = 1e-6, affine: bool = True):
        super().__init__(num_features, eps, affine)
        self.bias = None

    def init_parameters(self, generator: torch.Generator):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return y if self.weight is None else y * self.weight.float()


def make_token_norm(norm: str, eps: float, num_features: int) -> nn.Module:
    """The transformer block's last-axis norm: 'layer_norm' or 'rms_norm'."""
    if norm == NormTechnique.LAYER_NORM:
        return LayerNorm(num_features, eps)
    if norm == NormTechnique.RMS_NORM:
        return RMSNorm(num_features, eps)
    raise ValueError(f"norm must be 'layer_norm' or 'rms_norm', got {norm!r}")


def normalization_techniques(norm_specs: Mapping[str, Optional[Mapping[str, Any]]],
                             num_features: int) -> List[nn.Module]:
    """Norm modules from spec dicts (torch-style kwargs), for
    ``num_features`` channels. Ported: batch_norm, group_norm, layer_norm,
    rms_norm and layer_nrm_and_mean_batch_nrm (a :class:`MeanOnlyBatchNorm`
    then a :class:`LayerNorm`, both over the channels of each position)."""
    mods: List[nn.Module] = []
    for tech, spec in (norm_specs or {}).items():
        if spec is None or spec is False:
            continue
        spec = dict(spec) if isinstance(spec, Mapping) else {}
        if tech == NormTechnique.BATCH_NORM:
            mods.append(BatchNorm(num_features,
                                  momentum=float(spec.get("momentum", 0.1)),
                                  eps=float(spec.get("eps", 1e-5)),
                                  affine=bool(spec.get("affine", True))))
        elif tech == NormTechnique.GROUP_NORM:
            mods.append(GroupNorm(int(spec.get("num_groups", 32)), num_features,
                                  eps=float(spec.get("eps", 1e-5)),
                                  affine=bool(spec.get("affine", True))))
        elif tech == NormTechnique.LAYER_NORM:
            mods.append(LayerNorm(num_features, eps=float(spec.get("eps", 1e-5)),
                                  affine=bool(spec.get("elementwise_affine", True))))
        elif tech == NormTechnique.RMS_NORM:
            mods.append(RMSNorm(num_features, eps=float(spec.get("eps", 1e-6)),
                                affine=bool(spec.get("elementwise_affine", True))))
        elif tech == NormTechnique.LAYER_NRM_AND_MEAN_BATCH_NRM:
            mods.append(MeanOnlyBatchNorm(num_features, momentum=float(spec.get("momentum", 0.1))))
            mods.append(LayerNorm(num_features, eps=float(spec.get("eps", 1e-5)),
                                  affine=bool(spec.get("elementwise_affine", True))))
        elif tech in NormTechnique.ALL:
            raise NotImplementedError(
                f"normalization technique '{tech}' is not ported yet "
                f"(ported: {NormTechnique.PORTED})")
        else:
            raise ValueError(f"Unknown normalization technique '{tech}'; "
                             f"expected one of {NormTechnique.ALL}")
    return mods


# --------------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------------- #

def weight_norm(v: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``WeightNorm`` of a weight ``v`` (out, ...): ``v *
    rsqrt(sum(v**2 over every axis but the output one) + eps) * scale``, in
    float32. Not ``torch.nn.utils.weight_norm``, whose gain starts at ``|v|``
    and which has no eps."""
    vf = v.float()
    dims = tuple(range(1, v.dim()))
    return vf * torch.rsqrt(vf.square().sum(dims, keepdim=True) + eps) \
        * scale.float().reshape((-1,) + (1,) * (v.dim() - 1))


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """Autocast's dtype where it is on for x's device, else x's."""
    dev = x.device.type
    if dev in ("cpu", "cuda") and torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def no_autocast(device: torch.device):
    """For the kernels, their plain versions and the quantized ops, which
    pick their own dtypes."""
    if device.type in ("cpu", "cuda"):
        return torch.autocast(device.type, enabled=False)
    return contextlib.nullcontext()


class _WeightOp(nn.Module):
    """An op with a ``weight`` (out, ...) that flax's ``WeightNorm`` can wrap
    (:meth:`add_weight_norm`): then ``weight`` is the direction ``v`` and the
    op computes with :func:`weight_norm` of it and ``scale``.

    ``quant`` (a :class:`~deepcv_tpu_torch.compression.QuantSpec`, set by
    the spec engine under hp ``quantize``) makes the op compute in w8a8
    int8 or fake quant: input and weight are cast to the compute dtype
    (autocast's) first, as flax casts to the layer's ``dtype`` before its
    op, then quantized; the bias is added after, in that dtype. A real-int8
    op keeps its weight codes per weight version (:meth:`_per_version`)."""

    def __init__(self):
        super().__init__()
        self.register_parameter("scale", None)
        self.weight_norm_eps: Optional[float] = None
        self.quant: Optional[compression.QuantSpec] = None
        self._derived = None
        self._derived_key = None

    def _per_version(self, w: torch.Tensor, make: Callable):
        """``make(w)`` of the weight ``w`` this forward computes with (a
        kernel's packing of it, its int8 codes), kept once per version of
        ``weight`` and dtype. Under weight norm ``w`` is a new tensor every
        forward (a new tensor's version is 0 and may take the last one's
        address), so it is made every time."""
        if self.scale is not None:
            with torch.no_grad():
                return make(w)
        version = -1 if self.weight.is_inference() else self.weight._version
        key = (self.weight.data_ptr(), version, w.device, w.dtype)
        if self._derived_key != key:
            with torch.no_grad():
                self._derived = make(w)
            self._derived_key = key
        return self._derived

    def _quant_operands(self, x: torch.Tensor):
        dt = _compute_dtype(x)
        w = self.effective_weight().to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), w, b

    def add_weight_norm(self, eps: float) -> None:
        """Reparameterise the weight as flax's ``WeightNorm`` with its
        defaults (the kernel alone, per output feature, ``scale`` ones)."""
        self.weight_norm_eps = float(eps)
        self.scale = nn.Parameter(torch.empty(self.weight.shape[0], device=self.weight.device))

    def _init_scale(self):
        if self.scale is not None:
            self.scale.fill_(1.0)

    def effective_weight(self) -> torch.Tensor:
        """The weight the op computes with."""
        if self.scale is None:
            return self.weight
        return weight_norm(self.weight, self.scale, self.weight_norm_eps)


def _conv_codes(w: torch.Tensor, groups: int):
    """A conv weight's int8 codes, scales and, on a card, the packing of the
    codes that the conv's kernel reads (``int8_kernel.route``)."""
    wq, sw = compression.quantize_weight(w)
    return wq, sw, int8_kernel.pack_weight_for(wq, groups) if w.device.type == "cuda" else None


class Conv2d(_WeightOp):
    """Any 2-d convolution (strided, dilated, grouped): plain ``F.conv2d``,
    as the JAX package leaves these to XLA. Weight (Cout, Cin/groups, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1,
                 use_bias: bool = True, gain: float = 1.0):
        super().__init__()
        self.stride, self.padding = tuple(stride), padding
        self.dilation, self.groups = tuple(dilation), int(groups)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // self.groups, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.gain = float(gain)

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            xavier_normal_with_gain(self.gain)(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()
            self._init_scale()

    def _quant_forward(self, x):
        x, w, b = self._quant_operands(x)
        q = self.quant
        with no_autocast(x.device):
            if q.real_int8:
                wq, sw, packed = self._per_version(
                    w, functools.partial(_conv_codes, groups=self.groups))
                y = compression.int8_conv_nd(x, w, self.stride, self.padding, self.dilation,
                                             self.groups, q.act_scale, w_quant=(wq, sw),
                                             w_packed=packed)
            else:
                y = compression.fake_quant_conv_nd(x, w, self.stride, self.padding,
                                                   self.dilation, self.groups, q.act_scale,
                                                   q.bits)
            return y if b is None else y + b.reshape(1, -1, *(1,) * (y.dim() - 2))

    def forward(self, x):
        if self.quant is not None:
            return self._quant_forward(x)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.effective_weight().to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvNd(Conv2d):
    """A 1-d or 3-d convolution (the spec's ``conv1d`` and ``conv3d``) on an
    NCW or NCDHW tensor: plain ``F.conv1d``/``F.conv3d``, as the JAX package
    leaves them to XLA. Weight (Cout, Cin/groups, *kernel), Xavier-normal."""

    def forward(self, x):
        if self.quant is not None:
            return self._quant_forward(x)
        fn = {3: F.conv1d, 5: F.conv3d}[self.weight.dim()]
        b = None if self.bias is None else self.bias.to(x.dtype)
        return fn(x, self.effective_weight().to(x.dtype), b, self.stride, self.padding,
                  self.dilation, self.groups)


class LecunConv2d(Conv2d):
    """A Conv2d initialised as flax's ``Conv`` default (the JAX package's
    HRNet scaling and mixing convs): :func:`lecun_normal_` kernel, zero
    bias."""

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            lecun_normal_(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()
            self._init_scale()


class FusedConv2d(Conv2d):
    """Stride-1 'same' conv with an odd kernel, bias and activation in one
    call of :func:`fused_conv2d_bias_act` — the CUDA kernel on a card, its
    plain version on the CPU. The counterpart of the JAX package's
    ``PallasConv``; every conv that qualifies is routed here, whatever its
    channel count. Under autocast it runs in autocast's dtype. The weight is
    packed for the kernel once per weight version and dtype
    (:meth:`_per_version`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 act: Optional[Callable] = None, use_bias: bool = True,
                 gain: float = 1.0):
        pad = get_padding_from_kernel(kernel_size)
        super().__init__(in_channels, out_channels, kernel_size, padding=pad,
                         use_bias=use_bias, gain=gain)
        name = activation_name(act)
        # the kernel's epilogue takes EPILOGUE_ACTS by name; any other
        # activation runs after the kernel
        self.act = None if name in ("identity", "linear") else (
            name if name and name in EPILOGUE_ACTS else act)

    def forward(self, x):
        # autocast does not reach into the kernel's autograd.Function, so the
        # conv takes autocast's dtype here, as the JAX package's PallasConv
        # casts x, kernel and bias to the model's compute dtype
        x = x.to(_compute_dtype(x)).contiguous(memory_format=torch.channels_last)
        w = self.effective_weight().to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        packed = self._per_version(w, pack_weight) if x.device.type == "cuda" else None
        return fused_conv2d_bias_act(x, w, b, self.act, w_packed=packed)


class Dense(_WeightOp):
    """Fully-connected op, weight (out, in), Xavier-uniform init, zero bias.
    A feature map or a token sequence is transformed per position along its
    feature dim (the JAX package's Dense on the last axis) unless
    ``flatten_input``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 gain: float = 1.0, flatten_input: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.gain = float(gain)
        self.flatten_input = bool(flatten_input)

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            xavier_uniform_with_gain(self.gain)(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()
            self._init_scale()

    def _linear(self, x, w, b):
        q = self.quant
        if q is None:
            return F.linear(x, w, b)
        with no_autocast(x.device):
            if q.real_int8:
                y = compression.int8_dense(x, w, q.act_scale,
                                           w_quant=self._per_version(w, compression.quantize_weight))
            else:
                y = compression.fake_quant_dense(x, w, q.act_scale, q.bits)
            return y if b is None else y + b

    def forward(self, x):
        if self.flatten_input:
            x = Flatten.hwc(x)
        if self.quant is not None:
            x, w, b = self._quant_operands(x)
        else:
            b = None if self.bias is None else self.bias.to(x.dtype)
            w = self.effective_weight().to(x.dtype)
        if feature_dim(x) == x.dim() - 1:
            return self._linear(x, w, b)
        return self._linear(x.movedim(1, -1), w, b).movedim(-1, 1)


class Identity(nn.Module):
    def forward(self, x):
        return x


class Interpolate(nn.Module):
    """Spatial resize node (the JAX package's ``Interpolate``): to ``size``,
    or by ``scale`` (each spatial dim times ``scale``, rounded half to
    even, as Python's ``round``), with :func:`interpolate`."""

    def __init__(self, size: Optional[Sequence[int]] = None, scale: float = 0.0,
                 method: str = "linear"):
        super().__init__()
        if size is None and not scale:
            raise ValueError("Interpolate needs 'size' or 'scale'")
        self.size = None if size is None else tuple(int(s) for s in size)
        self.scale, self.method = float(scale), method

    def forward(self, x):
        target = self.size or tuple(int(round(s * self.scale)) for s in x.shape[2:])
        return interpolate(x, target, self.method)


class Dropout(nn.Module):
    """Train-mode dropout with an explicit generator: zero each entry with
    probability ``p`` and scale the survivors by 1/(1-p); identity in eval
    mode. ``generator`` is set by the training loop (None draws from
    torch's default generator of the device)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= float(p) < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def _drop(self, x: torch.Tensor, mask_shape) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty(mask_shape, dtype=torch.float32, device=x.device)
        keep.bernoulli_(1.0 - self.p, generator=self.generator)
        return x * (keep / (1.0 - self.p)).to(x.dtype)

    def forward(self, x):
        return self._drop(x, x.shape)


class DropPath(Dropout):
    """Stochastic depth (Huang et al., arXiv:1603.09382): drop a residual
    branch per sample with probability ``p`` in training, rescaling the
    survivors by 1/(1-p) — one draw per sample, broadcast over every other
    dim (the JAX package's ``DropPath``)."""

    def forward(self, x):
        return self._drop(x, (x.shape[0],) + (1,) * (x.dim() - 1))


class Flatten(nn.Module):
    """Flatten all non-batch dims in H*W*C order (the JAX package's NHWC
    flatten), so dense kernels carried across map 1:1."""

    @staticmethod
    def hwc(x: torch.Tensor) -> torch.Tensor:
        return x.movedim(1, -1).reshape(x.shape[0], -1) if x.dim() > 2 else x

    def forward(self, x):
        return self.hwc(x)


class Layer(nn.Module):
    """The ``layer()`` unit: dropout -> op -> act -> norms (post-activation,
    the default) or dropout -> norms -> act -> op (pre-activation).
    ``act_in_op``: the op already applied the activation (fused conv)."""

    def __init__(self, op: nn.Module, act_fn: Optional[Callable] = None,
                 dropout_prob: float = 0.0, preactivation: bool = False,
                 norms: Sequence[nn.Module] = (), act_in_op: bool = False):
        super().__init__()
        self.op = op
        self.act_fn = act_fn
        self.dropout = Dropout(float(dropout_prob)) if dropout_prob and dropout_prob > 0 else None
        self.preactivation = bool(preactivation)
        self.norms = nn.ModuleList(norms)
        self.act_in_op = bool(act_in_op)

    def forward(self, x):
        if self.dropout is not None:
            x = self.dropout(x)
        if self.preactivation:
            for m in self.norms:
                x = m(x)
            if self.act_fn is not None:
                x = self.act_fn(x)
            return self.op(x)
        x = self.op(x)
        if self.act_fn is not None and not self.act_in_op:
            x = self.act_fn(x)
        for m in self.norms:
            x = m(x)
        return x


# --------------------------------------------------------------------------- #
# Cells of the CNN zoo: squeeze-excitation and ConvNeXt
# --------------------------------------------------------------------------- #

class LecunDense(Dense):
    """A Dense initialised as flax's ``Dense`` default
    (:func:`lecun_normal_` kernel, zero bias)."""

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            lecun_normal_(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()
            self._init_scale()


class UniformConv2d(Conv2d):
    """A Conv2d initialised Xavier-uniform (the JAX package's ConvNeXt convs,
    ``kernel_init=xavier_uniform_with_gain(1.0)``), zero bias."""

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            xavier_uniform_with_gain(self.gain)(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()
            self._init_scale()


class SqueezeExcitation(nn.Module):
    """Squeeze-and-Excitation cell (arXiv:1709.01507): the mean over every
    spatial position (H and W of an NCHW-logical map), Dense ``reduce`` to
    ``hidden_channels`` (``channels // reduction_ratio`` when 0), ``act_fn``
    (relu when None), Dense ``expand`` back to ``channels``, ``gate_fn``
    (sigmoid when None), and the input scaled per channel by the gate. The
    Denses start as flax's default."""

    def __init__(self, channels: int, reduction_ratio: int = 4,
                 act_fn: Optional[Callable] = None, hidden_channels: int = 0,
                 gate_fn: Optional[Callable] = None):
        super().__init__()
        hidden = int(hidden_channels) or max(1, int(channels) // int(reduction_ratio))
        self.reduce = LecunDense(int(channels), hidden)
        self.expand = LecunDense(hidden, int(channels))
        self.act_fn = act_fn or torch.relu
        self.gate_fn = gate_fn or torch.sigmoid

    def forward(self, x):
        fdim = feature_dim(x)
        squeezed = x.mean([d for d in range(1, x.dim()) if d != fdim])    # (N, C)
        scale = self.gate_fn(self.expand(self.act_fn(self.reduce(squeezed))))
        shape = [x.shape[0]] + [1] * (x.dim() - 1)
        shape[fdim] = x.shape[fdim]
        return x * scale.to(x.dtype).reshape(shape)


class ConvNeXtStem(nn.Module):
    """ConvNeXt patchify stem (Liu et al., arXiv:2201.03545): the 4x4
    stride-4 conv as a reshape of each patch, flattened in (row, column,
    channel) order, and one Dense ``proj``, then a LayerNorm ``ln`` (eps
    1e-6) over the channels. NCHW-logical map in and out."""

    def __init__(self, in_channels: int, dim: int, patch: int = 4, ln_eps: float = 1e-6):
        super().__init__()
        self.patch = int(patch)
        self.proj = Dense(self.patch * self.patch * int(in_channels), int(dim))
        self.ln = LayerNorm(int(dim), eps=ln_eps)

    def forward(self, x):
        n, c, hgt, wid = x.shape
        p = self.patch
        if hgt % p or wid % p:
            raise ValueError(f"input {hgt}x{wid} not divisible by patch {p}")
        gh, gw = hgt // p, wid // p
        x = x.movedim(1, -1).reshape(n, gh, p, gw, p, c).transpose(2, 3)
        x = self.proj(x.reshape(n, gh * gw, p * p * c))       # tokens (N, T, D)
        return self.ln(x.reshape(n, gh, gw, -1).movedim(-1, 1))


class ConvNeXtDownsample(nn.Module):
    """ConvNeXt between-stage downsampling: LayerNorm ``ln`` over the
    channels, then the 2x2 stride-2 conv ``conv`` (``F.conv2d``)."""

    def __init__(self, in_channels: int, dim: int, ln_eps: float = 1e-6):
        super().__init__()
        self.ln = LayerNorm(int(in_channels), eps=ln_eps)
        self.conv = UniformConv2d(int(in_channels), int(dim), (2, 2), stride=(2, 2))

    def forward(self, x):
        return self.conv(self.ln(x))


class ConvNeXtBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7 conv ``dwconv`` (``F.conv2d``) ->
    ``ln`` (LayerNorm, or ``rms_norm``) over the channels -> Dense ``fc1``
    to 4C -> exact GELU -> Dense ``fc2`` to C -> per-channel
    ``layer_scale`` (init ``layer_scale_init``) -> drop path -> residual
    add. The norm and the MLP work on the channels-last bytes, so no
    permute copies."""

    def __init__(self, channels: int, drop_path_prob: float = 0.0,
                 layer_scale_init: float = 1e-6, ln_eps: float = 1e-6,
                 norm: str = "layer_norm"):
        super().__init__()
        c = int(channels)
        self.dwconv = UniformConv2d(c, c, (7, 7), padding=(3, 3), groups=c)
        self.ln = make_token_norm(norm, ln_eps, c)
        self.fc1 = Dense(c, 4 * c)
        self.fc2 = Dense(4 * c, c)
        self.layer_scale = nn.Parameter(torch.empty(c))
        self.layer_scale_init = float(layer_scale_init)
        self.drop_path = DropPath(drop_path_prob)

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.layer_scale.fill_(self.layer_scale_init)

    def forward(self, x):
        y = self.fc2(gelu_exact(self.fc1(self.ln(self.dwconv(x)))))
        y = y * _channel_view(self.layer_scale.to(y.dtype), y.dim())
        return x + self.drop_path(y)


class FeaturePyramid(nn.Module):
    """Feature Pyramid Network (Lin et al., arXiv:1612.03144), the JAX
    package's ``FeaturePyramid``: over a list of feature maps ordered fine
    to coarse, 1x1 laterals to ``channels``, a top-down pathway that adds
    the nearest-upsampled coarser level to each lateral, and a 3x3 conv
    smoothing each sum. Returns the list of P-levels; with
    ``head_outputs`` one shared 3x3 head conv is applied to every level and
    the levels are flattened and concatenated to (N, sum of H*W,
    head_outputs), each level in NHWC row-major order (cell (y, x), then
    channels), the flat layout of the JAX package's dense targets.

    Its convs are plain ``F.conv2d`` (the JAX module's are flax's ``Conv``
    in XLA, not its kernel), initialised as flax's default."""

    #: the JAX module's refusal of anything but a stream list
    NEEDS_LIST = ("FeaturePyramid expects a list of >=2 feature maps (fine -> coarse); "
                  "wire it after a _new_branch_from_tensor gather of named nodes")

    def __init__(self, in_channels: Sequence[int], channels: int = 64, head_outputs: int = 0):
        super().__init__()
        if len(in_channels) < 2:
            raise ValueError(self.NEEDS_LIST)
        c = int(channels)
        self.levels, self.head_outputs = len(in_channels), int(head_outputs)
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", LecunConv2d(int(cin), c, (1, 1)))
        for i in range(self.levels):
            self.add_module(f"smooth{i}", LecunConv2d(c, c, (3, 3), padding=(1, 1)))
        self.shared_head = LecunConv2d(c, self.head_outputs, (3, 3), padding=(1, 1)) \
            if self.head_outputs else None

    def forward(self, xs):
        if not isinstance(xs, (list, tuple)) or len(xs) != self.levels:
            raise ValueError(self.NEEDS_LIST)
        lat = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(xs)]
        merged = list(lat)
        for i in range(self.levels - 2, -1, -1):
            merged[i] = lat[i] + interpolate(merged[i + 1], lat[i].shape[2:], method="nearest")
        outs = [getattr(self, f"smooth{i}")(m) for i, m in enumerate(merged)]
        if self.shared_head is None:
            return outs
        return torch.cat([self.shared_head(o).permute(0, 2, 3, 1).reshape(
            o.shape[0], -1, self.head_outputs) for o in outs], dim=1)

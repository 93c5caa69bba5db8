"""NN building blocks of the port: activations, init, pooling, norms and the
``Layer`` unit.

Counterpart of ``deepcv_tpu/ops/nn.py`` (``get_activation``, ``get_gain``,
``xavier_normal_with_gain``, ``avg_pool_nd``, ``max_pool_nd``, ``BatchNorm``,
``normalization_techniques``, ``Layer``, ``Flatten``). Tensors inside a model
are NCHW-logical in ``torch.channels_last`` memory, so the channel dim is 1
(the JAX package's -1). ``Flatten`` keeps the JAX package's H*W*C order so
dense kernels map 1:1.

Modules are built on the meta device (the spec engine infers shapes there)
and initialised afterwards by ``init_parameters(generator)``; nothing here
pads channels for the TPU (``pad_channels_for_tpu`` is not carried over).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch.ops.kernels.fused_layer import (
    LEAKY_RELU_SLOPE, fused_conv2d_bias_act, pack_weight)
from deepcv_tpu_torch.utils import get_by_identifier, register

__all__ = [
    "ACTIVATION_FNS", "XAVIER_GAINS", "get_activation", "activation_name",
    "get_gain", "xavier_normal_with_gain", "xavier_uniform_with_gain",
    "avg_pool_nd", "max_pool_nd", "interpolate", "NormTechnique", "BatchNorm",
    "GroupNorm", "normalization_techniques", "Conv2d", "FusedConv2d",
    "Dense", "Layer", "Identity", "Flatten", "get_padding_from_kernel",
]


def _leaky_relu(x):
    return F.leaky_relu(x, LEAKY_RELU_SLOPE)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


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
    "gelu_exact": F.gelu,
    "gelu": _gelu_tanh,
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


def interpolate(x: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """Resize the spatial dims to ``target_shape`` with (bi/tri)linear
    interpolation, half-pixel centres and no antialiasing (the JAX package's
    ``jax.image.resize(..., 'linear', antialias=False)``)."""
    target = tuple(int(t) for t in target_shape)
    if tuple(x.shape[2:]) == target:
        return x
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
    PORTED = (BATCH_NORM, GROUP_NORM)


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


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with the port's init protocol (ones/zeros)."""

    def init_parameters(self, generator: torch.Generator):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()


def normalization_techniques(norm_specs: Mapping[str, Optional[Mapping[str, Any]]],
                             num_features: int) -> List[nn.Module]:
    """Norm modules from spec dicts (torch-style kwargs), for
    ``num_features`` channels. Ported: batch_norm and group_norm."""
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

class Conv2d(nn.Module):
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

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class FusedConv2d(Conv2d):
    """Stride-1 'same' conv with an odd kernel, bias and activation in one
    call of :func:`fused_conv2d_bias_act` — the CUDA kernel on a card, its
    plain version on the CPU. The counterpart of the JAX package's
    ``PallasConv``; every conv that qualifies is routed here, whatever its
    channel count. The weight is packed for the kernel once per weight
    version and dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 act: Optional[Callable] = None, use_bias: bool = True,
                 gain: float = 1.0):
        pad = get_padding_from_kernel(kernel_size)
        super().__init__(in_channels, out_channels, kernel_size, padding=pad,
                         use_bias=use_bias, gain=gain)
        name = activation_name(act)
        # the kernel's epilogue takes these by name; any other activation
        # runs after the kernel
        self.act = None if name in ("identity", "linear") else (
            name if name in ("relu", "leaky_relu") else act)
        self._packed = None
        self._packed_key = None

    def _packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        key = (w.data_ptr(), w._version, w.device, dtype)
        if self._packed_key != key:
            with torch.no_grad():
                self._packed = pack_weight(w.to(dtype))
            self._packed_key = key
        return self._packed

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        packed = self._packed_weight(x.dtype) if x.device.type == "cuda" else None
        return fused_conv2d_bias_act(x, w, b, self.act, w_packed=packed)


class Dense(nn.Module):
    """Fully-connected op, weight (out, in), Xavier-uniform init. A tensor
    with spatial dims is transformed per position along its channel dim
    (the JAX package's Dense on the last axis) unless ``flatten_input``."""

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

    def forward(self, x):
        if self.flatten_input:
            x = Flatten.hwc(x)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if x.dim() == 2:
            return F.linear(x, self.weight.to(x.dtype), b)
        return F.linear(x.movedim(1, -1), self.weight.to(x.dtype), b).movedim(-1, 1)


class Identity(nn.Module):
    def forward(self, x):
        return x


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
        self.dropout = nn.Dropout(float(dropout_prob)) if dropout_prob and dropout_prob > 0 else None
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

"""Model compression: magnitude pruning (AGP schedule), int8 post-training
quantization, w8a8 int8 ops with calibrated scales, and quantization-aware
training (fake quant with a straight-through estimator).

Counterpart of ``deepcv_tpu/compression.py``, all of it:

* :func:`magnitude_prune_masks`, :func:`apply_masks`, :func:`prune_gradients`,
  :func:`sparsity_of`, :class:`AGPSchedule` and :func:`make_pruning_hook`
  act on a module's named parameters or on a mapping of name -> tensor (a
  ``state_dict``). The JAX rule "prune kernels only, never biases, scales or
  other tables" is "prune parameters named ``weight`` of two or more dims":
  conv and dense weights, not norm weights (1-d), biases, position tables,
  the Swin bias table or the V-MoE router and experts;
* :func:`quantize_int8` / :func:`dequantize_int8`: symmetric per-tensor
  int8 of every tensor of a mapping;
* :func:`int8_conv_nd` (``int8_conv_general_dilated``) and
  :func:`int8_dense` (``int8_dot_general``): w8a8 with a per-tensor
  activation scale (dynamic, or static from calibration) and per-output-
  channel weight scales, int32 sums, float rescale. The conv runs
  :func:`deepcv_tpu_torch.ops.kernels.int8_conv.int8_conv` (the CUDA kernel
  on a card); the dense contraction is ``torch._int_mm`` (int8 x int8 ->
  int32) on a card, as the JAX package leaves it to XLA's ``dot_general``,
  and float64 on the CPU (exact, as the conv's plain version);
* :func:`calibrate_int8_scales`: the float model's max |input| of every conv
  and dense op on calibration batches, under forward pre-hooks, keyed as the
  JAX package keys them (see the function);
* :func:`fake_quant_conv_nd` and :func:`fake_quant_dense`: the QAT ops.

The arithmetic is the JAX package's, to the bit where it is integer: codes
are ``clip(round_half_even(x_f32 / scale), -127, 127)`` with true float32
divisions, here and where the scales are computed (every divisor is a
tensor on the operand's device: PyTorch on CUDA turns a division by a host
scalar into a product by its reciprocal, an ulp away at times); the
dynamic scale is ``max(amax, 1e-12) / 127`` over the whole tensor; the
weight scale is taken per output channel over every other dim (dims 1...
of the port's (O, I/g, *k) and (out, in) weights, the JAX package's HWIO and
(in, out) out-last); the rescale is ``float32(acc) * (s_act * s_w)``. The
ops compute in their inputs' dtype: the layers cast input and weight to
the compute dtype first (autocast's, in a bfloat16 model), as flax casts
to the layer's ``dtype`` before the op.

One difference is deliberate. The JAX package zero-pads a conv's input to 8
channels on the TPU (``pad_channels_for_tpu``), so a 3-channel stem kernel
has 5 padded rows, and its int8 weight scale is taken over those rows too.
The port has no padded rows (``interop`` cuts them), so its scale is the max
over the real rows: the two grids agree where the padded rows are zero.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch.ops.kernels import int8_conv as _k

__all__ = ["magnitude_prune_masks", "AGPSchedule", "apply_masks",
           "prune_gradients", "make_pruning_hook", "sparsity_of",
           "quantize_int8", "dequantize_int8", "quantize_weight",
           "activation_codes", "int8_conv_nd", "int8_dense", "calibrate_int8_scales",
           "fake_quant_conv_nd", "fake_quant_dense", "QuantSpec", "qat_bits",
           "INFERENCE_ONLY_ERROR"]

_logger = logging.getLogger(__name__)

Params = Union[nn.Module, Mapping[str, torch.Tensor]]

#: raised when a real-int8 build is asked to train (the JAX package's words)
INFERENCE_ONLY_ERROR = ("quantize={!r} models are inference-only (round/clip kills "
                        "gradients); train the float or 'int8_qat' build and rebuild "
                        "with quantize for serving")


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _is_weight(name: str, w: torch.Tensor) -> bool:
    """A conv or dense weight: named ``weight``, two or more dims."""
    return name.rsplit(".", 1)[-1] == "weight" and w.dim() >= 2


# --------------------------------------------------------------------------- #
# Pruning
# --------------------------------------------------------------------------- #

def magnitude_prune_masks(params: Params, sparsity: float,
                          only_weights: bool = True) -> Dict[str, torch.Tensor]:
    """Boolean masks by name, True = keep: a per-tensor magnitude threshold
    at ``sparsity`` ('level' pruner). Tensors that are not weights, and
    tensors of fewer than 2 dims, keep everything."""
    sparsity = float(np.clip(sparsity, 0.0, 0.999))
    masks = {}
    for name, w in _named(params).items():
        w = w.detach()
        keep_all = (only_weights and not _is_weight(name, w)) or w.dim() < 2
        k = int(round(sparsity * w.numel()))
        if keep_all or k <= 0:
            masks[name] = torch.ones_like(w, dtype=torch.bool)
            continue
        thresh = torch.sort(w.abs().reshape(-1)).values[k - 1]
        masks[name] = w.abs() > thresh
    return masks


def apply_masks(params: Params, masks: Mapping[str, torch.Tensor]):
    """Zero the pruned entries: in place on a module's parameters (returns
    the module), or a new mapping."""
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.mul_(masks[name].to(p.dtype))
        return params
    return {k: w * masks[k].to(w.dtype) for k, w in params.items()}


def prune_gradients(grads: Params, masks: Mapping[str, torch.Tensor]):
    """Zero the gradient of pruned entries (keeps them pruned): in place on
    a module's ``.grad``\\ s (returns the module), or a new mapping."""
    if isinstance(grads, nn.Module):
        with torch.no_grad():
            for name, p in grads.named_parameters():
                if p.grad is not None:
                    p.grad.mul_(masks[name].to(p.grad.dtype))
        return grads
    return {k: g * masks[k].to(g.dtype) for k, g in grads.items()}


def sparsity_of(params: Optional[Params], masks: Optional[Mapping[str, torch.Tensor]] = None
                ) -> float:
    """Fraction of exactly-zero entries (or of masked-off ones when
    ``masks`` are given)."""
    if masks is not None:
        kept = sum(int(m.sum()) for m in masks.values())
        total = sum(m.numel() for m in masks.values())
        return 1.0 - kept / max(1, total)
    tensors = list(_named(params).values())
    zeros = sum(int((w == 0).sum()) for w in tensors)
    total = sum(w.numel() for w in tensors)
    return zeros / max(1, total)


class AGPSchedule:
    """Automated gradual pruning sparsity ramp (Zhu & Gupta, arXiv:1710.01878):

        s_t = s_f + (s_i - s_f) * (1 - (t - t0) / (t1 - t0))^3   for t in [t0, t1]
    """

    def __init__(self, final_sparsity: float, begin_step: int = 0,
                 end_step: int = 1000, initial_sparsity: float = 0.0):
        self.s_i = float(initial_sparsity)
        self.s_f = float(final_sparsity)
        self.t0 = int(begin_step)
        self.t1 = int(end_step)

    def __call__(self, step: int) -> float:
        if step <= self.t0:
            return self.s_i
        if step >= self.t1:
            return self.s_f
        frac = (step - self.t0) / max(1, self.t1 - self.t0)
        return self.s_f + (self.s_i - self.s_f) * (1.0 - frac) ** 3


def make_pruning_hook(schedule: AGPSchedule, state_box: Dict[str, Any],
                      every_epochs: int = 1) -> Callable:
    """An epoch-end hook that recomputes the masks of ``state.model`` at the
    schedule's sparsity for ``state.step`` (the training loop's
    :class:`~deepcv_tpu_torch.train.training.TrainState`) and writes
    ``{'masks': ..., 'sparsity': ...}`` into ``state_box``, which the caller
    shares with its train step."""
    def hook(count: int, state=None, **_):
        if count % every_epochs or state is None:
            return
        s = schedule(int(state.step))
        masks = magnitude_prune_masks(state.model, s)
        state_box["masks"] = masks
        state_box["sparsity"] = s
        _logger.info("pruning masks updated: target sparsity %.3f (actual %.3f)",
                     s, sparsity_of(None, masks))

    return hook


# --------------------------------------------------------------------------- #
# Post-training quantization (symmetric per-tensor int8)
# --------------------------------------------------------------------------- #

def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as a true division on every device: PyTorch on CUDA turns a
    division by a host scalar into a product by its reciprocal, which can
    land an ulp away from XLA's quotient."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def quantize_int8(params: Params) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(int8 values, float32 scales) by name; ``w ~= values * scale``."""
    values, scales = {}, {}
    for name, w in _named(params).items():
        w = w.detach()
        scale = _div(torch.clamp_min(w.abs().amax(), 1e-12), 127.0)
        values[name] = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        scales[name] = scale
    return values, scales


def dequantize_int8(values: Mapping[str, torch.Tensor], scales: Mapping[str, torch.Tensor],
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) * scales[k].to(dtype) for k, v in values.items()}


# --------------------------------------------------------------------------- #
# int8 compute (w8a8)
# --------------------------------------------------------------------------- #

def _codes(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def _quant_sym(x: torch.Tensor, dims: Optional[Tuple[int, ...]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``dims`` (None: the whole tensor); returns the
    codes and the float32 scale (keepdim)."""
    x32 = x.float()
    amax = x32.abs().amax() if dims is None else x32.abs().amax(dim=dims, keepdim=True)
    scale = _div(torch.clamp_min(amax, 1e-12), 127.0)
    return _codes(x32, scale), scale


def _quant_static(x: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    s = torch.tensor(float(scale), dtype=torch.float32, device=x.device)
    return _codes(x.float(), s), s


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of a weight (O, ...): codes and (O,) float32
    scales, over every dim but the first."""
    q, s = _quant_sym(w, tuple(range(1, w.dim())))
    return q, s.reshape(-1)


def activation_codes(x: torch.Tensor, act_scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An op's per-tensor activation codes and float32 scale: dynamic
    (``act_scale`` None) or static."""
    return _quant_sym(x) if act_scale is None else _quant_static(x, act_scale)


def int8_conv_nd(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, dilation=1,
                 groups: int = 1, act_scale: Optional[float] = None,
                 w_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w8a8 convolution of x (N, C, *spatial), 1-3 spatial dims, and a float
    weight (O, C / groups, *kernel): per-tensor activation codes (dynamic,
    or static at ``act_scale``), per-output-channel weight codes, int32
    sums, the float rescale; the output takes x's dtype. ``w_quant``
    (:func:`quantize_weight` of ``weight``) and ``w_packed`` (its codes
    through ``pack_weight_for``) reuse a layer's cached codes."""
    xq, sa = activation_codes(x, act_scale)
    wq, sw = quantize_weight(weight) if w_quant is None else w_quant
    return _k.int8_conv(xq, wq, sa, sw, stride, padding, dilation, groups,
                        out_dtype=x.dtype, w_packed=w_packed)


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int32 (M, N) = int8 a (M, K) @ int8 b_t.T, b_t (N, K). On a card
    ``torch._int_mm`` (cuBLASLt) with the operands zero-padded to its shape
    rules (M > 16, K and N multiples of 8; the zeros add nothing); on the CPU
    float64 products, exact as the conv's plain version."""
    if a.device.type != "cuda":
        return (a.double() @ b_t.double().t()).to(torch.int32)
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n]


def int8_dense(x: torch.Tensor, weight: torch.Tensor, act_scale: Optional[float] = None,
               w_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """w8a8 Dense: x (..., in) against a weight (out, in), the contraction
    of x's last dim with the weight's input dim, in int8 with int32 sums;
    the output (..., out) takes x's dtype. Any other contraction raises
    NotImplementedError, as the JAX package's ``int8_dot_general``."""
    if weight.dim() != 2 or x.shape[-1] != weight.shape[1]:
        raise NotImplementedError(
            "int8_dense supports the Dense contraction only (x's last dim with a "
            f"weight (out, in)); got x {tuple(x.shape)} and weight {tuple(weight.shape)}")
    xq, sa = activation_codes(x, act_scale)
    wq, sw = quantize_weight(weight) if w_quant is None else w_quant
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    scale = sa.reshape(()) * sw.reshape(-1)
    y = (acc.float() * scale).to(x.dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


# --------------------------------------------------------------------------- #
# Calibration
# --------------------------------------------------------------------------- #

def _calibration_keys(model: nn.Module, qualname: str, op: nn.Module) -> Tuple[str, ...]:
    """The JAX package's keys for one op: the spec-node path ('nested/local'
    for nested modules) and, for an op below the node's own layer unit,
    '<node>/<sub/path>' by the op's JAX name (a node's ``jax_names`` maps
    its convs' JAX names to the port's; flax's ``WeightNorm`` and
    ``FlattenThen`` wrap the op as ``op/layer_instance`` and ``op/inner``,
    which the JAX package records too)."""
    parts = qualname.split(".")
    if parts[:1] != ["module"]:
        return ()
    i, nodes = 1, []
    while i + 1 < len(parts) and parts[i] == "nodes":
        nodes.append(parts[i + 1])
        i += 2
    if not nodes:
        return ()
    key, tail = "/".join(nodes), parts[i:]
    names = getattr(model.get_submodule(".".join(parts[:i])), "jax_names", None) or {}
    flat = ".".join(tail)
    tail = next(([j] for j, port in names.items() if port == flat), tail)
    if tail == ["op"]:
        wrap = []
        if getattr(op, "scale", None) is not None:
            wrap.append("layer_instance")
        if getattr(op, "flatten_input", False):
            wrap.append("inner")
        return (key,) if not wrap else (key, "/".join([key, "op", *wrap]))
    if not tail or (len(tail) == 1 and tail[0].endswith("_op")):
        return (key,)
    return key, "/".join([key, *tail])


def calibrate_int8_scales(model: nn.Module, batches: Iterable[Any]) -> Dict[str, float]:
    """Static activation scales: ``max(max |input|, 1e-12) / 127`` of every
    conv and dense op over the calibration ``batches`` (NHWC arrays or
    tensors), the float model in eval mode, by the JAX package's keys: the
    full spec-node path, plus '<node>/<sub>' for ops below a node's layer
    unit (the transformer blocks' ``attn/qkv``, ``attn/out``, ``mlp/fc1``,
    ``mlp/fc2``, ``patch_embed``'s ``proj``, ``patch_merging``'s
    ``reduce``). The result feeds ``DeepcvModule(..., quantize='int8',
    quantize_scales=...)``."""
    from deepcv_tpu_torch.ops import nn as dnn

    amax: Dict[str, torch.Tensor] = {}

    def record(keys, _module, args):
        v = args[0].detach().abs().amax().float()
        for k in keys:
            amax[k] = torch.maximum(amax[k], v) if k in amax else v

    hooks = []
    for qualname, op in model.named_modules():
        if isinstance(op, (dnn.Conv2d, dnn.Dense)):
            keys = _calibration_keys(model, qualname, op)
            if keys:
                hooks.append(op.register_forward_pre_hook(
                    lambda m, a, keys=keys: record(keys, m, a)))
    was_training = model.training
    device = next(model.parameters()).device
    try:
        model.eval()
        with torch.no_grad():
            for x in batches:
                x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
                model(x.to(device))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return {k: max(float(v), 1e-12) / 127.0 for k, v in amax.items()}


# --------------------------------------------------------------------------- #
# Quantization-aware training (fake quant + straight-through estimator)
# --------------------------------------------------------------------------- #

def _fake_quant_ste(x: torch.Tensor, scale: torch.Tensor, levels: int) -> torch.Tensor:
    """quantize -> dequantize with straight-through gradients."""
    q = torch.clamp(torch.round(x / scale), -levels, levels) * scale
    return x + (q - x).detach()


def _fq_tensor(x: torch.Tensor, levels: int, act_scale: Optional[float] = None):
    if act_scale is not None:
        scale = torch.tensor(np.float32(act_scale * (127.0 / levels)),
                             device=x.device).to(x.dtype)
    else:
        scale = _div(torch.clamp_min(x.detach().abs().amax(), 1e-12), levels)
    return _fake_quant_ste(x, scale, levels)


def _fq_per_channel(w: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-output-channel fake quant (the port's out-first weights), as the
    real int8 ops quantize weights."""
    amax = w.detach().abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    return _fake_quant_ste(w, _div(torch.clamp_min(amax, 1e-12), levels), levels)


def fake_quant_conv_nd(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0,
                       dilation=1, groups: int = 1, act_scale: Optional[float] = None,
                       bits: int = 8) -> torch.Tensor:
    """A float convolution of both operands fake-quantized to the int grid
    of ``bits`` (8 -> +-127): the QAT forward and, through the
    straight-through estimator, its backward."""
    levels = 2 ** (bits - 1) - 1
    fn = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[x.dim()]
    return fn(_fq_tensor(x, levels, act_scale), _fq_per_channel(weight, levels), None,
              stride, padding, dilation, groups)


def fake_quant_dense(x: torch.Tensor, weight: torch.Tensor, act_scale: Optional[float] = None,
                     bits: int = 8) -> torch.Tensor:
    """``F.linear`` with fake quantization (the QAT Dense path)."""
    if weight.dim() != 2 or x.shape[-1] != weight.shape[1]:
        raise NotImplementedError(
            "fake_quant_dense supports the Dense contraction only; got x "
            f"{tuple(x.shape)} and weight {tuple(weight.shape)}")
    levels = 2 ** (bits - 1) - 1
    return F.linear(_fq_tensor(x, levels, act_scale), _fq_per_channel(weight, levels))


# --------------------------------------------------------------------------- #
# The spec engine's hook: one op's quantization
# --------------------------------------------------------------------------- #

def qat_bits(quantize: Optional[str]) -> Optional[int]:
    """'int8_qat' -> 8, 'int4_qat' -> 4, anything else -> None."""
    m = re.fullmatch(r"int(\d+)_qat", str(quantize or ""))
    return int(m.group(1)) if m else None


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How one conv or dense op computes under hp ``quantize``: real int8
    (``bits`` None) or fake quant at ``bits``, with a static activation
    scale or None (dynamic)."""
    bits: Optional[int] = None
    act_scale: Optional[float] = None

    @staticmethod
    def make(quantize: Optional[str], act_scale: Optional[float] = None
             ) -> Optional["QuantSpec"]:
        """None for a float build; raises on an unknown mode."""
        if not quantize:
            return None
        if quantize == "int8":
            return QuantSpec(None, act_scale)
        bits = qat_bits(quantize)
        if bits is None or not 2 <= bits <= 8:
            raise ValueError(f"unknown quantize mode {quantize!r} (known: 'int8', "
                             "'int<N>_qat' with N in 2..8)")
        return QuantSpec(bits, act_scale)

    @property
    def real_int8(self) -> bool:
        return self.bits is None

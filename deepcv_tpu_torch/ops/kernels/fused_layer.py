"""Fused stride-1 'same' conv2d + bias + activation: wrapper, plain version,
and the weight packing the CUDA kernel reads.

Counterpart of ``deepcv_tpu/ops/pallas/fused_layer.py`` (the TPU kernel
``_kernel``, reached through ``fused_conv2d_bias_act``). The CUDA source is
``deepcv_tpu_torch/csrc/fused_conv2d_bias_act.cu``; its header note says what
bounds it on an H100 and what this design does about it.

Layout: ``x`` is NCHW-logical in ``torch.channels_last`` memory (NHWC bytes),
``w`` is the PyTorch conv weight (Cout, Cin, kh, kw), packed once to
(kh*kw*Cin, Cout), the order of ``w.reshape`` in the TPU kernel's
``_forward_pallas``. The output has ``x``'s dtype and memory format.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or raises);
a CPU tensor takes :func:`plain_conv2d_bias_act`; a meta tensor (shape
inference at model build) takes the plain version too, which computes no
values there.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["EPILOGUE_ACTS", "LEAKY_RELU_SLOPE", "pack_weight",
           "plain_conv2d_bias_act", "fused_conv2d_bias_act"]

#: activations the kernel applies in its epilogue, by launcher code
EPILOGUE_ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
#: the slope of deepcv_tpu's registered leaky_relu (ops/nn.py ACTIVATION_FNS)
LEAKY_RELU_SLOPE = 0.01

_ACT_NAMES = {code: name for name, code in EPILOGUE_ACTS.items()}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "fused_conv2d_bias_act"

Act = Union[None, str, Callable[[torch.Tensor], torch.Tensor]]


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) -> contiguous (kh*kw*Cin, Cout), row index
    (i*kw + j)*Cin + c: the kernel's reduction order."""
    cout, cin, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout).contiguous()


def _apply_act(y: torch.Tensor, act: Act) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, LEAKY_RELU_SLOPE)
    return act(y)


def plain_conv2d_bias_act(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None,
                          act: Act = None) -> torch.Tensor:
    """The same function in plain PyTorch: conv, bias and activation in
    float32, cast back to ``x``'s dtype, in channels_last memory."""
    kh, kw = w.shape[-2:]
    y = F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                 padding=(kh // 2, kw // 2))
    y = _apply_act(y, act)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _check(x, w, b, w_packed):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected 4-d x and w, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    n, cin, h, wd = x.shape
    cout, wcin, kh, kw = w.shape
    if wcin != cin:
        raise ValueError(f"weight has {wcin} input channels, x has {cin}")
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel {kh}x{kw}: only odd kernels have a "
                         "symmetric 'same' padding")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {x.dtype} not supported (float32 or bfloat16)")
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise TypeError("x, w and b must share one dtype")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({cout},)")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (NHWC memory)")
    for t in (w, b, w_packed):
        if t is not None and t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if w_packed is not None:
        if tuple(w_packed.shape) != (kh * kw * cin, cout) \
                or w_packed.dtype != x.dtype or not w_packed.is_contiguous():
            raise ValueError("w_packed must be pack_weight(w): contiguous "
                             f"({kh * kw * cin}, {cout}) in {x.dtype}")


def _launcher():
    """The kernel's C launcher, built and loaded on first use."""
    from deepcv_tpu_torch.ops.kernels import _build

    fn = _build.load(_KERNEL).fused_conv2d_bias_act_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _run_kernel(x: torch.Tensor, w: torch.Tensor, w_packed: torch.Tensor,
                b: Optional[torch.Tensor], act_code: int) -> torch.Tensor:
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_packed.data_ptr(),
                 None if b is None else b.data_ptr(), y.data_ptr(),
                 n, h, wd, cin, cout, kh, kw,
                 x.stride(0), x.stride(2), x.stride(3),
                 y.stride(0), y.stride(2), y.stride(3),
                 _DTYPE_CODES[x.dtype], act_code, LEAKY_RELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)})")
    fused_conv2d_bias_act.launches += 1
    return y


class _FusedConvFn(torch.autograd.Function):
    """Kernel forward; the backward is autograd of the plain version, as the
    TPU kernel's custom VJP (``_bwd``) differentiates the XLA conv."""

    @staticmethod
    def forward(ctx, x, w, b, w_packed, act_code):
        ctx.save_for_backward(x, w, b)
        ctx.act_code = act_code
        return _run_kernel(x, w, w_packed, b, act_code)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xi = x.detach().requires_grad_(need[0])
            wi = w.detach().requires_grad_(need[1])
            bi = None if b is None else b.detach().requires_grad_(need[2])
            y = plain_conv2d_bias_act(xi, wi, bi, _ACT_NAMES[ctx.act_code])
            wanted = [t for t in (xi, wi, bi) if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        gx, gw, gb = (next(grads) if t is not None and t.requires_grad else None
                      for t in (xi, wi, bi))
        return gx, gw, gb, None, None


def fused_conv2d_bias_act(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, act: Act = None,
                          *, w_packed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``act(conv2d(x, w, padding='same') + b)`` for an odd kernel at stride 1.

    ``act`` is None, ``"relu"`` or ``"leaky_relu"`` (applied in the kernel's
    epilogue) or any other callable (the kernel runs without an activation
    and the callable is applied afterwards). ``w_packed`` is
    :func:`pack_weight` of ``w``, passed by callers that keep it; it is
    packed here otherwise. On a CUDA tensor this launches the kernel and
    adds one to ``fused_conv2d_bias_act.launches``; a failed launch raises.
    """
    _check(x, w, b, w_packed)
    fused = act if isinstance(act, str) or act is None else None
    if fused not in EPILOGUE_ACTS:
        raise ValueError(f"unknown activation name {act!r}; pass a callable "
                         f"or one of {sorted(k for k in EPILOGUE_ACTS if k)}")
    if x.device.type == "cuda":
        if w_packed is None:
            with torch.no_grad():
                w_packed = pack_weight(w)
        y = _FusedConvFn.apply(x, w, b, w_packed, EPILOGUE_ACTS[fused])
        return y if fused is not None or act is None else act(y)
    if x.device.type in ("cpu", "meta"):
        return plain_conv2d_bias_act(x, w, b, act)
    raise RuntimeError(f"no {_KERNEL} for device {x.device}")


#: launches of the CUDA kernel in this process (the wrapper adds one per
#: successful launch and nowhere else)
fused_conv2d_bias_act.launches = 0

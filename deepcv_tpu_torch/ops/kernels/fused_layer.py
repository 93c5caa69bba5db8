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

On the card both dtypes run a tensor-core kernel whose output tile
:func:`tc_plan` fits to the conv's shape: bfloat16 by mma.sync m16n8k16,
float32 by 3xTF32 (every operand split into TF32 hi and lo, three m16n8k8
products summed in f32), which keeps f32 accuracy whatever
``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``
say.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or raises);
a CPU tensor takes :func:`plain_conv2d_bias_act`; a meta tensor (shape
inference at model build) takes the plain version too, which computes no
values there. Where a gradient is recorded the launch is the dispatcher op
``torch.ops.deepcv.fused_conv2d_bias_act`` (``torch.library``), called
from the autograd Function that gives it its backward, so that selective
activation checkpointing (``remat: dots``) sees it and keeps its output
instead of launching it again in the backward pass; a call that records
no gradient launches the kernel directly.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["EPILOGUE_ACTS", "LEAKY_RELU_SLOPE", "TcPlan", "tc_plan", "pack_weight",
           "plain_conv2d_bias_act", "fused_conv2d_bias_act"]

#: activations the kernel applies in its epilogue, by launcher code
EPILOGUE_ACTS = {None: 0, "relu": 1, "leaky_relu": 2, "relu6": 3, "hard_swish": 4,
                 "silu": 5}
#: the slope of deepcv_tpu's registered leaky_relu (ops/nn.py ACTIVATION_FNS)
LEAKY_RELU_SLOPE = 0.01

_ACT_NAMES = {code: name for name, code in EPILOGUE_ACTS.items()}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "fused_conv2d_bias_act"

Act = Union[None, str, Callable[[torch.Tensor], torch.Tensor]]

#: the tensor-core kernels' output tile widths along Cout, and output pixels
#: per block by tile width (4 warps of 4 m16 tiles for the narrow ones, else
#: of 2); input channels per chunk by element size (bf16 down to one k16
#: step, f32 down to one k8 step); bytes of a weight stage they aim for; the
#: shared memory a block may use, and an SM holds with the 1 KB it reserves
#: per block (csrc header note)
TC_BN = (8, 16, 32, 64, 128)
#: the f32 kernel's tile widths: at most 64 (csrc header note)
F32_TC_BN = (8, 16, 32, 64)
TC_BM = {8: 256, 16: 256, 32: 128, 64: 128, 128: 128}
TC_CHUNKS = {2: (64, 32, 16), 4: (64, 32, 16, 8)}
TC_WSTAGE_BYTES = 24 * 1024
TC_SMEM_MAX = 227 * 1024
SM_SMEM_BYTES = 228 * 1024
#: blocks per SM the f32 kernel's registers leave room for, by BN (its
#: __launch_bounds__), which its plan aims to fill with shared memory
F32_TC_BLOCKS = {8: 4, 16: 4, 32: 3, 64: 3}


class TcPlan(NamedTuple):
    """A tensor-core kernel's tiling of one conv shape; the first seven
    fields are what the launcher takes."""
    bn: int          # output channels per block
    flat: bool       # 1x1: bm consecutive pixels per block, across images
    ti: int          # spatial: images x rows x columns of output per block
    th: int
    tw: int
    ck: int          # input channels per chunk (Cin padded to one k step)
    tg: int          # taps per weight stage
    bm: int          # output pixels a block holds (TC_BM[bn])
    smem_bytes: int  # dynamic shared memory per block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of ``smem_bytes`` dynamic shared memory one SM holds."""
    return SM_SMEM_BYTES // (smem_bytes + 1024)


@functools.lru_cache(maxsize=1024)
def tc_plan(n: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
            itemsize: int = 2) -> TcPlan:
    """The tile of the tensor-core kernel for an (N, H, W, Cin) -> Cout conv
    with a kh x kw kernel, in bf16 (``itemsize`` 2) or f32 (4): BN is the
    smallest of :data:`TC_BN` (f32: :data:`F32_TC_BN`) at or above Cout, the
    widest above that; a 1x1 conv takes flat tiles
    of BM pixels; a map of at most BM pixels takes whole images, as many as
    fit; otherwise the TH x TW rectangle of at most BM pixels with the least
    tiles x (BM x taps + patch pixels): the tile pixels the products pay
    for, plus the halo the loads pay for. Cin is padded to one k step (16
    channels in bf16, 8 in f32). bf16 takes the widest channel chunk (64,
    32, 16) whose patch and weight stages fit in shared memory; f32, whose
    stages are twice the bytes, the chunk (64 down to 8) that lets the most
    blocks share an SM (up to :data:`F32_TC_BLOCKS`) at the least cost, the
    widest of those. Raises ValueError when nothing fits."""
    widths = TC_BN if itemsize == 2 else F32_TC_BN
    bn = next((b for b in widths if b >= cout), widths[-1])
    bm = TC_BM[bn]
    if itemsize == 2:
        ldb, kstep = (8 if bn == 8 else bn + 8), 16
    else:
        ldb, kstep = bn + 4, 8
    cp = _cdiv(cin, kstep) * kstep
    taps = kh * kw
    if kh == kw == 1:
        cands = [(True, 1, 1, bm)]
    elif h * w <= bm:
        cands = [(False, min(n, bm // (h * w)), h, w)]
    else:
        cands = [(False, 1, min(h, bm // tw), tw) for tw in range(1, min(w, bm) + 1)]
    plans = []
    for ck in (c for c in TC_CHUNKS[itemsize] if c <= cp):
        # patch rows padded by 8 elements (none for f32 at ck 8: see csrc)
        lda = ck if (itemsize == 4 and ck == 8) else ck + 8
        nchunks = _cdiv(cp, ck)
        tap_bytes = itemsize * ck * ldb
        tg = max(1, min(taps, TC_WSTAGE_BYTES // tap_bytes))
        wbytes = (2 if nchunks * _cdiv(taps, tg) > 1 else 1) * tg * tap_bytes
        best = None
        for flat, ti, th, tw in cands:
            pph, ppw = (1, bm) if flat else (th + kh - 1, tw + kw - 1)
            smem = (2 if nchunks > 1 else 1) * itemsize * ti * pph * ppw * lda + wbytes
            if smem > TC_SMEM_MAX:
                continue
            tiles = (_cdiv(n * h * w, bm) if flat
                     else _cdiv(n, ti) * _cdiv(h, th) * _cdiv(w, tw))
            cost = tiles * (bm * taps + ti * pph * ppw)
            if best is None or cost < best[0]:
                best = (cost, TcPlan(bn, flat, ti, th, tw, ck, tg, bm, smem))
        if best is not None:
            if itemsize == 2:
                return best[1]
            plans.append(best)
    if plans:
        cap = F32_TC_BLOCKS[bn]
        return min(plans, key=lambda cp_: (-min(blocks_per_sm(cp_[1].smem_bytes), cap),
                                           cp_[0], -cp_[1].ck))[1]
    raise ValueError(f"no {'bf16' if itemsize == 2 else 'f32'} tile fits shared memory "
                     f"for a {kh}x{kw} conv at ({n}, {h}, {w}, {cin}) -> {cout}")


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) -> contiguous (kh*kw*Cin, Cout), row index
    (i*kw + j)*Cin + c: the kernel's reduction order."""
    cout, cin, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout).contiguous()


#: the epilogue's activations in plain PyTorch: the JAX package's
#: definitions (relu6 ``min(max(x, 0), 6)``, hard_swish ``x * relu6(x + 3) /
#: 6``, silu ``x * sigmoid(x)``)
_PLAIN_ACTS = {"relu": torch.relu, "leaky_relu": lambda y: F.leaky_relu(y, LEAKY_RELU_SLOPE),
               "relu6": F.relu6, "hard_swish": F.hardswish, "silu": F.silu}


def _apply_act(y: torch.Tensor, act: Act) -> torch.Tensor:
    if act is None:
        return y
    return _PLAIN_ACTS[act](y) if isinstance(act, str) else act(y)


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
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
    plan = tc_plan(n, h, wd, cin, cout, kh, kw, x.element_size())[:7]
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_packed.data_ptr(),
                 None if b is None else b.data_ptr(), y.data_ptr(),
                 n, h, wd, cin, cout, kh, kw,
                 x.stride(0), x.stride(2), x.stride(3),
                 y.stride(0), y.stride(2), y.stride(3),
                 _DTYPE_CODES[x.dtype], act_code, LEAKY_RELU_SLOPE,
                 *(int(v) for v in plan), stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)})")
    fused_conv2d_bias_act.launches += 1
    fused_conv2d_bias_act.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    fused_conv2d_bias_act.launches_by_act[_ACT_NAMES[act_code] or "none"] += 1
    return y


@torch.library.custom_op("deepcv::fused_conv2d_bias_act", mutates_args=(), device_types="cuda")
def _kernel_op(x: torch.Tensor, w: torch.Tensor, w_packed: torch.Tensor,
               b: Optional[torch.Tensor], act_code: int) -> torch.Tensor:
    """The kernel's launch as a dispatcher op, so that selective activation
    checkpointing (``remat: dots``) sees it and keeps its output."""
    return _run_kernel(x, w, w_packed, b, act_code)


@_kernel_op.register_fake
def _(x, w, w_packed, b, act_code):
    n, _, h, wd = x.shape
    return torch.empty((n, w.shape[0], h, wd), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


class _FusedConvFn(torch.autograd.Function):
    """The kernel's op forward; the backward is autograd of the plain
    version, as the TPU kernel's custom VJP (``_bwd``) differentiates the
    XLA conv. (On an H100, a backward registered on the op itself took
    twice the host time a call and 15 % of bench.py config 7's streaming
    throughput.)"""

    @staticmethod
    def forward(ctx, x, w, b, w_packed, act_code):
        ctx.save_for_backward(x, w, b)
        ctx.act_code = act_code
        return _kernel_op(x, w, w_packed, b, act_code)

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

    ``act`` is None, a name of :data:`EPILOGUE_ACTS` (``"relu"``,
    ``"leaky_relu"``, ``"relu6"``, ``"hard_swish"``, ``"silu"``: applied in
    the kernel's epilogue, in float32 before the rounding to ``x``'s dtype)
    or any other callable (the kernel runs without an activation and the
    callable is applied afterwards). ``w_packed`` is :func:`pack_weight` of
    ``w``, passed by callers that keep it; it is packed here otherwise. On a
    CUDA tensor this launches the kernel (bfloat16: the bf16 tensor-core
    kernel; float32: the 3xTF32 one) and adds one to
    ``fused_conv2d_bias_act.launches``, to
    ``fused_conv2d_bias_act.launches_by_dtype[dtype name]`` and to
    ``fused_conv2d_bias_act.launches_by_act[activation name or "none"]``; a
    failed launch raises.
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
        code = EPILOGUE_ACTS[fused]
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
            y = _FusedConvFn.apply(x, w, b, w_packed, code)
        else:
            y = _run_kernel(x, w, w_packed, b, code)
        return y if fused is not None or act is None else act(y)
    if x.device.type in ("cpu", "meta"):
        return plain_conv2d_bias_act(x, w, b, act)
    raise RuntimeError(f"no {_KERNEL} for device {x.device}")


#: launches of the CUDA kernel in this process, in all, by input dtype and
#: by epilogue activation (the wrapper adds one to each per successful launch
#: and nowhere else)
fused_conv2d_bias_act.launches = 0
fused_conv2d_bias_act.launches_by_dtype = {"float32": 0, "bfloat16": 0}
fused_conv2d_bias_act.launches_by_act = {name or "none": 0 for name in EPILOGUE_ACTS}

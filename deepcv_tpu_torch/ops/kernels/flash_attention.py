"""Flash attention kernels K3 (forward), K4 (dQ) and K5 (dK, dV): wrappers
and their plain PyTorch versions.

Counterparts of the TPU kernels in ``deepcv_tpu/ops/attention.py``:
``_flash_kernel`` (reached through ``_flash_fwd_impl``),
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` (both through
``_flash_bwd_impl``). The CUDA source is
``deepcv_tpu_torch/csrc/flash_attention.cu``; its header note says what bounds
the kernels on an H100 and what this design does about it. The
``torch.autograd.Function`` that chains them is
``deepcv_tpu_torch.ops.attention.flash_attention``.

Layout: q, k, v, o, dO (N, H, T, Dh) in float32 or bfloat16; lse and delta
(N, H, T) float32. Outputs take the input's dtype.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or raises);
a CPU or meta tensor takes the plain version, which computes the same
function in float32 with the (T, T) scores materialised. On the card, K3, K4
and K5 run on the tensor cores in both dtypes: for bfloat16 in bf16
products, for float32 by 3xTF32 (each operand split into two TF32 parts,
three products accumulated in f32), which keeps float32 accuracy and does
not depend on ``torch.backends.cuda.matmul.allow_tf32``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

__all__ = ["HEAD_DIMS", "plain_flash_fwd", "plain_flash_bwd_dq",
           "plain_flash_bwd_dkv", "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv"]

#: head dims the CUDA kernels are instantiated for: every head dim of the
#: zoo's ViTs (64, and 80 for ViT-H/14) and the powers of two around them
HEAD_DIMS = (16, 32, 64, 80, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "flash_attention"


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def plain_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o = softmax(q kᵀ / sqrt(Dh)) v in q's dtype, lse the
    per-row logsumexp of the scaled scores in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse.unsqueeze(-1)), v.float())
    return o.to(q.dtype), lse


def _grad_scores(q, k, v, dout, lse, delta):
    """p = exp(q kᵀ·scale − lse) and dS = p ⊙ (dO vᵀ − δ), in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.unsqueeze(-1)), scale


def plain_flash_bwd_dq(q, k, v, dout, lse, delta) -> torch.Tensor:
    """dQ = scale · dS k, in q's dtype."""
    _, ds, scale = _grad_scores(q, k, v, dout, lse, delta)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def plain_flash_bwd_dkv(q, k, v, dout, lse, delta
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``: dK = scale · dSᵀ q and dV = pᵀ dO, in k's and v's dtype."""
    p, ds, scale = _grad_scores(q, k, v, dout, lse, delta)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# Checks and launchers
# --------------------------------------------------------------------------- #

def _check(tensors, rows=()):
    """``tensors``: same-shape (N, H, T, Dh) operands of one dtype;
    ``rows``: (N, H, T) float32 statistics. All on one device."""
    ref = tensors[0]
    if ref.dim() != 4:
        raise ValueError(f"expected (N, H, T, Dh) tensors, got {tuple(ref.shape)}")
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {ref.dtype} not supported (float32 or bfloat16)")
    for t in tensors[1:]:
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shapes {tuple(t.shape)} and {tuple(ref.shape)} differ")
        if t.dtype != ref.dtype:
            raise TypeError(f"dtypes {t.dtype} and {ref.dtype} differ")
    for t in rows:
        if tuple(t.shape) != tuple(ref.shape[:3]) or t.dtype != torch.float32:
            raise ValueError(f"lse/delta must be float32 {tuple(ref.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for t in (*tensors, *rows):
        if t.device != ref.device:
            raise ValueError(f"tensors on {t.device} and {ref.device}")


def _launcher(name: str, n_ptrs: int):
    """One C launcher of the library, built and loaded on first use."""
    from deepcv_tpu_torch.ops.kernels import _build

    fn = getattr(_build.load(_KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, wrapper, args, q: torch.Tensor) -> None:
    n, h, t, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} has no kernel (built for {HEAD_DIMS})")
    for a in args:
        if a.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    fn = _launcher(name, len(args))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(a.data_ptr() for a in args), n * h, t, dh,
                 1.0 / math.sqrt(dh), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} (q {tuple(q.shape)}, "
                           f"{q.dtype})")
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(q.dtype).removeprefix("torch.")] += 1


def _dispatch(device: torch.device, name: str):
    if device.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"no {name} for device {device}")
    return device.type == "cuda"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(o, lse)`` of :func:`plain_flash_fwd`. On a CUDA tensor this
    launches the kernel (bfloat16: ``flash_fwd_tc_kernel``; float32:
    ``flash_fwd_f32tc_kernel``, 3xTF32; both on the tensor cores) and adds
    one to ``flash_attention_fwd.launches`` and to
    ``flash_attention_fwd.launches_by_dtype[dtype name]``."""
    _check((q, k, v))
    if not _dispatch(q.device, "flash_attention_fwd"):
        return plain_flash_fwd(q, k, v)
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd_launch", flash_attention_fwd, (q, k, v, o, lse), q)
    return o, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta) -> torch.Tensor:
    """K4: dQ of :func:`plain_flash_bwd_dq`. On a CUDA tensor this launches
    the kernel (bfloat16: ``flash_bwd_dq_tc_kernel``; float32:
    ``flash_bwd_dq_f32tc_kernel``, 3xTF32; both on the tensor cores) and
    counts it in ``flash_attention_bwd_dq.launches`` and
    ``.launches_by_dtype``."""
    _check((q, k, v, dout), (lse, delta))
    if not _dispatch(q.device, "flash_attention_bwd_dq"):
        return plain_flash_bwd_dq(q, k, v, dout, lse, delta)
    q, k, v, dout, lse, delta = (t.contiguous() for t in (q, k, v, dout, lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq_launch", flash_attention_bwd_dq,
            (q, k, v, dout, lse, delta, dq), q)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(dK, dV)`` of :func:`plain_flash_bwd_dkv`. On a CUDA tensor
    this launches the kernel (bfloat16: ``flash_bwd_dkv_tc_kernel``; float32:
    ``flash_bwd_dkv_f32tc_kernel``, 3xTF32; both on the tensor cores) and
    counts it in ``flash_attention_bwd_dkv.launches`` and
    ``.launches_by_dtype``."""
    _check((q, k, v, dout), (lse, delta))
    if not _dispatch(q.device, "flash_attention_bwd_dkv"):
        return plain_flash_bwd_dkv(q, k, v, dout, lse, delta)
    q, k, v, dout, lse, delta = (t.contiguous() for t in (q, k, v, dout, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_dkv_launch", flash_attention_bwd_dkv,
            (q, k, v, dout, lse, delta, dk, dv), q)
    return dk, dv


#: launches of each CUDA kernel in this process, in all and by input dtype
#: (each wrapper adds one to both per successful launch and nowhere else)
for _wrapper in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.launches_by_dtype = {"float32": 0, "bfloat16": 0}
del _wrapper

"""int8 w8a8 convolution: wrapper and plain version.

A kernel of the port only: the JAX package computes its w8a8 convolutions
(``deepcv_tpu/compression.py``, ``int8_conv_general_dilated``) with XLA's
``lax.conv_general_dilated`` on int8 operands, and no Pallas kernel lies on
that path; PyTorch has no int8 convolution on CUDA. The CUDA source is
``deepcv_tpu_torch/csrc/int8_conv.cu``; its header note says what bounds it
on an H100 and what this first design does about it.

It takes int8 codes: activations ``xq`` (N, C, *spatial) over 1-3 spatial
dims (channels-last memory keeps the call free of copies), weights ``wq``
(O, C / groups, *kernel), with stride, zero padding, dilation and groups.
It sums each window's products in int32 and returns ``float32(acc) *
(s_act * s_w[o])`` in ``out_dtype`` (float32 or bfloat16), or the
int32 sums themselves with ``return_acc``. Quantizing the float operands
to those codes is :mod:`deepcv_tpu_torch.compression`'s work.

The plain version casts the codes to float64 and convolves with
``F.conv1d/2d/3d``: exact, since every sum is at most 127^2 * K (K the
products per output) and far below 2^53. It is used on the CPU (and for
shapes on the meta device) and by the tests; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["int8_conv", "plain_int8_conv", "pack_weight", "conv_output_shape",
           "launch_plan"]

_KERNEL = "int8_conv"
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CONV_FNS = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}
#: x, w, s_act, s_w, y, acc_out, dims (host int64[22]), vec, oct, out dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

IntOrSeq = Union[int, Sequence[int]]


def _per_dim(v: IntOrSeq, rank: int, what: str) -> Tuple[int, ...]:
    t = (int(v),) * rank if isinstance(v, int) else tuple(int(e) for e in v)
    if len(t) != rank:
        raise ValueError(f"{what} {v!r} does not fit {rank} spatial dims")
    return t


def conv_output_shape(spatial: Sequence[int], kernel: Sequence[int], stride, padding,
                      dilation) -> Tuple[int, ...]:
    """Output spatial size of a zero-padded convolution."""
    return tuple((s + 2 * p - d * (k - 1) - 1) // st + 1
                 for s, k, st, p, d in zip(spatial, kernel, stride, padding, dilation))


def launch_plan(cin_g: int, cout_g: int) -> Tuple[int, int]:
    """(vec, oct): input channels a load (16, 4 or 1 bytes) and output
    channels a thread (8, 4 or 1), each dividing the group's channels;
    16-byte loads only with 8 or 4 output channels a thread."""
    oct_ = next(o for o in (8, 4, 1) if cout_g % o == 0)
    vec = next(v for v in (16, 4, 1) if cin_g % v == 0 and (v < 16 or oct_ > 1))
    return vec, oct_


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """(O, C / groups, *kernel) int8 -> the kernel's (O, *kernel, C / groups)."""
    return wq.movedim(1, -1).contiguous()


def plain_int8_conv(xq: torch.Tensor, wq: torch.Tensor, s_act: torch.Tensor,
                    s_w: torch.Tensor, stride: IntOrSeq = 1, padding: IntOrSeq = 0,
                    dilation: IntOrSeq = 1, groups: int = 1,
                    out_dtype: torch.dtype = torch.float32,
                    return_acc: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the codes in float64 through
    ``F.conv*d``, the int32 sums, then the rescale."""
    acc = _CONV_FNS[xq.dim()](xq.double(), wq.double(), None, stride, padding, dilation,
                              groups).to(torch.int32)
    if return_acc:
        return acc
    scale = s_act.float().reshape(()) * s_w.float().reshape(-1)
    return (acc.float() * scale.reshape(1, -1, *(1,) * (acc.dim() - 2))).to(out_dtype)


def _check(xq, wq, s_act, s_w, groups, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 codes, got {xq.dtype} and {wq.dtype}")
    if xq.dim() not in _CONV_FNS or wq.dim() != xq.dim():
        raise ValueError(f"int8_conv takes (N, C, *spatial) over 1-3 spatial dims and a "
                         f"weight of the same rank, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    o, cin_g = wq.shape[:2]
    if xq.shape[1] != cin_g * groups or o % groups:
        raise ValueError(f"channels do not fit: input {xq.shape[1]}, weight "
                         f"{tuple(wq.shape)}, groups {groups}")
    if s_w.numel() != o or s_act.numel() != 1:
        raise ValueError(f"scales: one activation scale and {o} weight scales expected, "
                         f"got {s_act.numel()} and {s_w.numel()}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"out_dtype {out_dtype} not supported "
                        f"({', '.join(str(d) for d in _OUT_CODES)})")
    for t in (wq, s_act, s_w):
        if t.device != xq.device:
            raise ValueError(f"operands on {t.device} and {xq.device}")


def _launcher():
    """The kernel's C launcher, built and loaded on first use."""
    from deepcv_tpu_torch.ops.kernels import _build

    fn = _build.load(_KERNEL).int8_conv_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _as_3d(t: Tuple[int, ...], fill: int) -> Tuple[int, ...]:
    return (fill,) * (3 - len(t)) + tuple(t)


def _run_kernel(xq, wq, s_act, s_w, stride, padding, dilation, groups, out_dtype,
                return_acc, w_packed):
    rank = xq.dim() - 2
    n, c = xq.shape[:2]
    o, cin_g, *k = wq.shape
    osp = conv_output_shape(xq.shape[2:], k, stride, padding, dilation)
    if min(osp) <= 0:
        raise ValueError(f"int8_conv: empty output {osp} for input {tuple(xq.shape)}")
    x = xq.movedim(1, -1).contiguous()             # no copy on channels-last memory
    w = pack_weight(wq) if w_packed is None else w_packed
    if tuple(w.shape) != (o, *k, cin_g) or not w.is_contiguous():
        raise ValueError(f"w_packed must be pack_weight(wq), got {tuple(w.shape)}")
    sa = s_act.reshape(1).float().contiguous()
    sw = s_w.reshape(-1).float().contiguous()
    out = torch.empty((n, *osp, o), dtype=torch.int32 if return_acc else out_dtype,
                      device=xq.device)
    vec, oct_ = launch_plan(cin_g, o // groups)
    dims = (n, *_as_3d(tuple(xq.shape[2:]), 1), c, o, *_as_3d(osp, 1), *_as_3d(tuple(k), 1),
            *_as_3d(stride, 1), *_as_3d(padding, 0), *_as_3d(dilation, 1), groups)
    host = (ctypes.c_longlong * len(dims))(*dims)
    fn = _launcher()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), sa.data_ptr(), sw.data_ptr(),
                 None if return_acc else out.data_ptr(),
                 out.data_ptr() if return_acc else None,
                 ctypes.cast(host, ctypes.c_void_p), vec, oct_,
                 _OUT_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err} (input "
                           f"{tuple(xq.shape)}, weight {tuple(wq.shape)}, groups {groups})")
    int8_conv.launches += 1
    if rank == 1:
        return out.movedim(-1, 1).contiguous()
    return out.movedim(-1, 1)                        # channels-last memory


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, s_act: torch.Tensor, s_w: torch.Tensor,
              stride: IntOrSeq = 1, padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
              groups: int = 1, out_dtype: torch.dtype = torch.float32,
              return_acc: bool = False,
              w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w8a8 convolution of int8 codes ``xq`` (N, C, *spatial) and ``wq`` (O,
    C / groups, *kernel): ``float32(int32 sums) * (s_act * s_w[o])`` in
    ``out_dtype``, or the int32 sums with ``return_acc``. ``s_act`` is one
    float32, ``s_w`` (O,) float32. ``w_packed``, :func:`pack_weight` of
    ``wq``, saves the kernel's weight repack. On a CUDA tensor this launches
    the kernel and adds one to ``int8_conv.launches``; a failed launch
    raises. On the CPU (or the meta device) the plain version runs."""
    groups = int(groups)
    _check(xq, wq, s_act, s_w, groups, out_dtype)
    rank = xq.dim() - 2
    stride = _per_dim(stride, rank, "stride")
    padding = _per_dim(padding, rank, "padding")
    dilation = _per_dim(dilation, rank, "dilation")
    if xq.device.type == "cuda":
        return _run_kernel(xq, wq, s_act, s_w, stride, padding, dilation, groups,
                           out_dtype, return_acc, w_packed)
    if xq.device.type in ("cpu", "meta"):
        return plain_int8_conv(xq, wq, s_act, s_w, stride, padding, dilation, groups,
                               out_dtype, return_acc)
    raise RuntimeError(f"no {_KERNEL} for device {xq.device}")


#: launches of the CUDA kernel in this process
int8_conv.launches = 0

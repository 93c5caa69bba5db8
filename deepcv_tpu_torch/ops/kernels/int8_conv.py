"""int8 w8a8 convolution: wrapper, plain version and the kernels' packing.

A kernel of the port only: the JAX package computes its w8a8 convolutions
(``deepcv_tpu/compression.py``, ``int8_conv_general_dilated``) with XLA's
``lax.conv_general_dilated`` on int8 operands, and no Pallas kernel lies on
that path; PyTorch has no int8 convolution on CUDA. The CUDA source is
``deepcv_tpu_torch/csrc/int8_conv.cu``; its header note says what bounds it
on an H100 at bench.py config 8's shapes and how each route meets that.

It takes int8 codes: activations ``xq`` (N, C, *spatial) over 1-3 spatial
dims (channels-last memory keeps the call free of copies), weights ``wq``
(O, C / groups, *kernel), with stride, zero padding, dilation and groups.
It sums each window's products in int32 and returns ``float32(acc) *
(s_act * s_w[o])`` in ``out_dtype`` (float32 or bfloat16), or the
int32 sums themselves with ``return_acc``. Quantizing the float operands
to those codes is :mod:`deepcv_tpu_torch.compression`'s work.

Two routes, by the groups alone (:func:`route`): an ungrouped conv runs on
the tensor cores (``int8_conv_tc_kernel``: an implicit GEMM on
``mma.sync`` m16n8k32 s8, the weight packed by :func:`pack_weight_tc`,
the tile from :func:`tc_plan`); a grouped one (depthwise, grouped) on the
CUDA cores (``int8_conv_kernel``, ``__dp4a``, the weight packed by
:func:`pack_weight`, the work split by :func:`launch_plan`). Both give the
int32 sums exactly, so their outputs are the plain version's to the bit.

The plain version casts the codes to float64 and convolves with
``F.conv1d/2d/3d``: exact, since every sum is at most 127^2 * K (K the
products per output) and far below 2^53. It is used on the CPU (and for
shapes on the meta device) and by the tests; a CUDA tensor launches a
kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["int8_conv", "plain_int8_conv", "pack_weight", "pack_weight_tc",
           "pack_weight_for", "conv_output_shape", "launch_plan", "route", "TcPlan",
           "tc_plan", "tc_smem_bytes", "launch_args", "ROUTES"]

_KERNEL = "int8_conv"
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CONV_FNS = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}
#: x, w, s_act, s_w, y, acc_out, dims (host int64[22]), then vec, oct (dp4a)
#: or kpad, bn (tensor cores), out dtype, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: the two routes, as ``int8_conv.launches_by_route`` counts them
ROUTES = ("tensor_core", "dp4a")
#: the tensor-core kernel: output pixels a block, bytes of K a stage (the
#: packed weight's rows are padded to it), ring stages, output channels a
#: block (csrc header note)
TC_BM = 128
TC_BK = 64
TC_STAGES = 4
TC_BN = (128, 64)

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


def route(groups: int) -> str:
    """The kernel a conv takes on the card: the tensor cores when it is
    ungrouped, ``__dp4a`` on the CUDA cores when it is grouped."""
    return "tensor_core" if int(groups) == 1 else "dp4a"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_weight_tc(wq: torch.Tensor) -> torch.Tensor:
    """(O, C, *kernel) int8 -> the tensor-core kernel's (O, kpad): each row
    the taps x C codes in :func:`pack_weight`'s order (kernel positions,
    then channels), zero from taps x C to kpad, its multiple of
    :data:`TC_BK`."""
    o, k = wq.shape[0], wq[0].numel()
    rows = wq.movedim(1, -1).reshape(o, k)
    kpad = _cdiv(k, TC_BK) * TC_BK
    out = torch.zeros((o, kpad), dtype=wq.dtype, device=wq.device)
    out[:, :k] = rows
    return out


def pack_weight_for(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """The packing of ``wq`` that :func:`route` ``(groups)``'s kernel reads."""
    return pack_weight_tc(wq) if route(groups) == "tensor_core" else pack_weight(wq)


class TcPlan(NamedTuple):
    """The tensor-core kernel's tiling of one conv, as its launcher takes it."""
    bn: int            # output channels a block (128 or 64)
    kpad: int          # taps x C rounded up to TC_BK


def tc_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of a tensor-core block: the ring of stages, or
    the int32 tile staged for the stores (rows padded by 8 words), the
    larger."""
    return max(TC_STAGES * (TC_BM + bn) * TC_BK, TC_BM * (bn + 8) * 4)


def tc_plan(cout: int, kdim: int) -> TcPlan:
    """The tile of an ungrouped conv with ``cout`` output channels and
    ``kdim`` = taps x C products an output: the channel block of
    :data:`TC_BN` that pads O the least (128 on a tie), so that a 64-channel
    layer does not compute half a tile of zeros, and K padded to whole
    stages. The launcher covers the output pixels with 128-pixel tiles."""
    bn = min(TC_BN, key=lambda b: (_cdiv(cout, b) * b, -b))
    return TcPlan(bn, _cdiv(kdim, TC_BK) * TC_BK)


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


def _launcher(name: str):
    """A C launcher of the kernel library (``int8_conv_launch`` or
    ``int8_conv_tc_launch``), built and loaded on first use."""
    from deepcv_tpu_torch.ops.kernels import _build

    fn = getattr(_build.load(_KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _as_3d(t: Tuple[int, ...], fill: int) -> Tuple[int, ...]:
    return (fill,) * (3 - len(t)) + tuple(t)


def launch_args(x_shape: Sequence[int], w_shape: Sequence[int], stride: Tuple[int, ...],
                padding: Tuple[int, ...], dilation: Tuple[int, ...], groups: int
                ) -> Tuple[str, Tuple[int, ...], Tuple[int, ...], Tuple[int, int]]:
    """What the wrapper passes a launcher for input (N, C, *spatial) and
    weight (O, C / groups, *kernel): the route, the output's spatial size,
    the 22 geometry values (spatial dims filled to 3 from the front) and
    the route's two ints, (kpad, bn) from :func:`tc_plan` or (vec, oct)
    from :func:`launch_plan`."""
    n, c, *sp = (int(v) for v in x_shape)
    o, cin_g, *k = (int(v) for v in w_shape)
    osp = conv_output_shape(sp, k, stride, padding, dilation)
    if min(osp) <= 0:
        raise ValueError(f"int8_conv: empty output {osp} for input {tuple(x_shape)}")
    dims = (n, *_as_3d(tuple(sp), 1), c, o, *_as_3d(osp, 1), *_as_3d(tuple(k), 1),
            *_as_3d(stride, 1), *_as_3d(padding, 0), *_as_3d(dilation, 1), groups)
    r = route(groups)
    if r == "tensor_core":
        plan = tc_plan(o, cin_g * math.prod(k))
        return r, osp, dims, (plan.kpad, plan.bn)
    return r, osp, dims, launch_plan(cin_g, o // groups)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes (a
    view into a larger tensor): both kernels load up to 16 bytes at a
    time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run_kernel(xq, wq, s_act, s_w, stride, padding, dilation, groups, out_dtype,
                return_acc, w_packed):
    rank = xq.dim() - 2
    o = wq.shape[0]
    r, osp, dims, ints = launch_args(xq.shape, wq.shape, stride, padding, dilation, groups)
    x = xq.movedim(1, -1).contiguous()             # no copy on channels-last memory
    if r == "tensor_core":
        w = pack_weight_tc(wq) if w_packed is None else w_packed
        want, what = (o, ints[0]), "pack_weight_tc(wq)"
    else:
        w = pack_weight(wq) if w_packed is None else w_packed
        want, what = (o, *wq.shape[2:], wq.shape[1]), "pack_weight(wq)"
    if tuple(w.shape) != want or not w.is_contiguous():
        raise ValueError(f"w_packed must be {what}, {want}, got {tuple(w.shape)}")
    x, w = _aligned(x), _aligned(w)
    sa = s_act.reshape(1).float().contiguous()
    sw = s_w.reshape(-1).float().contiguous()
    out = torch.empty((xq.shape[0], *osp, o), dtype=torch.int32 if return_acc else out_dtype,
                      device=xq.device)
    host = (ctypes.c_longlong * len(dims))(*dims)
    fn = _launcher("int8_conv_tc_launch" if r == "tensor_core" else "int8_conv_launch")
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), sa.data_ptr(), sw.data_ptr(),
                 None if return_acc else out.data_ptr(),
                 out.data_ptr() if return_acc else None,
                 ctypes.cast(host, ctypes.c_void_p), *ints,
                 _OUT_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed ({r}): CUDA error {err} (input "
                           f"{tuple(xq.shape)}, weight {tuple(wq.shape)}, groups {groups})")
    int8_conv.launches += 1
    int8_conv.launches_by_route[r] += 1
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
    float32, ``s_w`` (O,) float32. ``w_packed``, :func:`pack_weight_for`
    of ``wq`` and ``groups``, saves the kernel's weight repack. On a CUDA
    tensor this launches the kernel of :func:`route` and adds one to
    ``int8_conv.launches`` and to that route's count in
    ``int8_conv.launches_by_route``; a failed build or launch raises. On the
    CPU (or the meta device) the plain version runs."""
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


#: launches of the CUDA kernels in this process, in all and by route
int8_conv.launches = 0
int8_conv.launches_by_route = dict.fromkeys(ROUTES, 0)

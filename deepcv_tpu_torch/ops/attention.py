"""Attention ops and the vision-transformer building blocks (the ViT subset).

Counterpart of ``deepcv_tpu/ops/attention.py``: ``attention_xla``,
``flash_attention``, ``scaled_dot_product_attention``,
``MultiHeadSelfAttention``, ``MlpBlock``, ``TransformerEncoderBlock``,
``PatchEmbed``, ``TakeToken``, ``resize_pos_embedding`` and the Swin blocks
(``WindowAttention``, ``SwinBlock``, ``PatchMerging``, with their numpy
helpers ``_window_partition``, ``_window_reverse``,
``_relative_position_index`` and ``_shift_attention_mask``). The V-MoE
expert MLP is :class:`deepcv_tpu_torch.ops.moe.MoEMlp`.

Numerics follow the JAX package: the packed qkv projection's output columns
are ``[q | k | v]`` (``nn.MultiheadAttention.in_proj_weight`` rows), heads
are contiguous Dh chunks, the encoder block is torchvision's pre-LN
``EncoderBlock``, the MLP uses exact (erf) GELU unless ``mlp_act:
gelu_tanh``, and softmax statistics are float32 whatever the input type.

``flash_attention`` is a ``torch.autograd.Function`` over the kernels of
:mod:`deepcv_tpu_torch.ops.kernels.flash_attention`: K3 forward returning
``(o, lse)``; a backward that computes delta = rowsum(dO ⊙ O) in plain
torch, then K4 (dQ) and K5 (dK, dV). The large matmuls (qkv, out
projection, MLP) stay ``F.linear``, as the JAX package leaves them to XLA.

Swin's windowed attention reaches no kernel in the JAX package (plain
einsums under XLA), so here it is plain torch too: ``torch.matmul`` for
both products and ``torch.softmax``, the scores, the relative-position bias,
the shift mask and the softmax in float32 (q and k are upcast, as the JAX
einsum's ``preferred_element_type=float32``), the probabilities cast to v's
dtype for the second product.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)

__all__ = [
    "attention_xla", "flash_attention", "scaled_dot_product_attention",
    "MultiHeadSelfAttention", "MlpBlock", "TransformerEncoderBlock",
    "PatchEmbed", "TakeToken", "resize_pos_embedding", "ATTENTION_IMPLS",
    "WindowAttention", "SwinBlock", "PatchMerging",
]

ATTENTION_IMPLS = ("xla", "flash")


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference scaled-dot-product attention, (N, H, T, Dh) -> same: the
    (T, T) scores materialised, softmax statistics in float32, the
    probabilities cast to v's dtype for the second product."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


_no_autocast = dnn.no_autocast


class _FlashAttention(torch.autograd.Function):
    """K3 forward; K4 and K5 backward from the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v):
        with _no_autocast(q.device):
            o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with _no_autocast(q.device):
            do = do.to(q.dtype)
            delta = (do.float() * o.float()).sum(-1)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention (Dao et al., arXiv:2205.14135), (N, H, T, Dh) -> same:
    the online-softmax forward (K3) and the two-kernel backward (K4, K5)
    never hold the (T, T) scores. q, k and v share one dtype (float32 or
    bfloat16); on the CPU the kernels' plain versions run instead."""
    if q.device.type == "meta":
        o, _ = flash_attention_fwd(q, k, v)
        return o
    return _FlashAttention.apply(q, k, v)


def scaled_dot_product_attention(q, k, v, impl: str = "xla") -> torch.Tensor:
    """Dispatch: 'xla' (:func:`attention_xla`) or 'flash'
    (:func:`flash_attention`)."""
    if impl == "flash":
        return flash_attention(q, k, v)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} "
                         f"(known: {', '.join(repr(i) for i in ATTENTION_IMPLS)})")
    return attention_xla(q, k, v)


# --------------------------------------------------------------------------- #
# Transformer modules
# --------------------------------------------------------------------------- #

class MultiHeadSelfAttention(nn.Module):
    """Self-attention with ``nn.MultiheadAttention`` packing: one Dense to
    3*D whose output columns are ``[q | k | v]``, heads as contiguous Dh
    chunks, a Dense out projection. ``dropout_prob`` drops entries of the
    softmaxed probability matrix, which needs it materialised: with
    ``attn_impl='flash'`` it raises in training."""

    def __init__(self, dim: int, num_heads: int, dropout_prob: float = 0.0,
                 attn_impl: str = "xla"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} not divisible by {num_heads} heads")
        if attn_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r} "
                             f"(known: {', '.join(repr(i) for i in ATTENTION_IMPLS)})")
        self.num_heads, self.attn_impl = int(num_heads), attn_impl
        self.qkv = dnn.Dense(dim, 3 * dim)
        self.out = dnn.Dense(dim, dim)
        self.dropout = dnn.Dropout(dropout_prob) if dropout_prob > 0.0 else None

    def forward(self, x):
        n, t, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(n, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        if self.dropout is not None and self.training:
            if self.attn_impl == "flash":
                raise ValueError(
                    "attention-probability dropout needs materialized "
                    "probabilities; use attn_impl='xla' when "
                    "attn_dropout > 0 (flash never forms the (T, T) matrix)")
            s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d // h)
            p = self.dropout(torch.softmax(s, dim=-1))
            o = torch.matmul(p.to(v.dtype), v)
        else:
            o = scaled_dot_product_attention(q, k, v, impl=self.attn_impl)
        return self.out(o.transpose(1, 2).reshape(n, t, d))


class MlpBlock(nn.Module):
    """Transformer MLP: Dense(mlp_dim) -> act -> dropout -> Dense(d) ->
    dropout (torchvision ``MLPBlock``)."""

    def __init__(self, dim: int, mlp_dim: int, dropout_prob: float = 0.0,
                 act_fn: Callable = dnn.gelu_exact):
        super().__init__()
        self.fc1 = dnn.Dense(dim, mlp_dim)
        self.fc2 = dnn.Dense(mlp_dim, dim)
        self.act_fn = act_fn
        self.dropout = dnn.Dropout(dropout_prob) if dropout_prob > 0.0 else None

    def forward(self, x):
        y = self.act_fn(self.fc1(x))
        if self.dropout is not None:
            y = self.dropout(y)
        y = self.fc2(y)
        return y if self.dropout is None else self.dropout(y)


#: the MLP activation by ``mlp_act``: exact erf GELU (torch parity) or tanh
MLP_ACTS = {"gelu": dnn.gelu_exact, "gelu_tanh": dnn.gelu_tanh}


class TransformerEncoderBlock(nn.Module):
    """Pre-LN encoder block, torchvision ``EncoderBlock`` wiring:
    x + drop_path(drop(attn(ln_1(x)))); then x + drop_path(mlp(ln_2(x))).
    ``drop_path_prob`` is stochastic depth on both residual branches.
    ``moe`` (``{num_experts, k, capacity_factor, router_noise, group_size,
    mlp_dim}``) swaps the dense MLP for a V-MoE mixture of experts,
    :class:`~deepcv_tpu_torch.ops.moe.MoEMlp`, named ``moe_mlp``."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dropout_prob: float = 0.0, attn_dropout_prob: float = 0.0,
                 drop_path_prob: float = 0.0, attn_impl: str = "xla",
                 ln_eps: float = 1e-6, norm: str = "layer_norm",
                 mlp_act: str = "gelu", moe: Optional[Mapping] = None):
        super().__init__()
        if mlp_act not in MLP_ACTS:
            raise ValueError(f"mlp_act must be 'gelu' or 'gelu_tanh', got {mlp_act!r}")
        self.ln_1 = dnn.make_token_norm(norm, ln_eps, dim)
        self.attn = MultiHeadSelfAttention(dim, num_heads, attn_dropout_prob, attn_impl)
        self.dropout = dnn.Dropout(dropout_prob) if dropout_prob > 0.0 else None
        self.ln_2 = dnn.make_token_norm(norm, ln_eps, dim)
        self.uses_moe = bool(moe)
        if moe:
            from deepcv_tpu_torch.ops.moe import MoEMlp
            self.moe_mlp = MoEMlp(
                dim, int(moe["num_experts"]), int(moe.get("mlp_dim", mlp_dim)),
                k=int(moe.get("k", 1)),
                capacity_factor=float(moe.get("capacity_factor", 1.25)),
                router_noise=float(moe.get("router_noise", 0.0)),
                group_size=int(moe.get("group_size", 0)), mlp_act=mlp_act)
        else:
            self.mlp = MlpBlock(dim, mlp_dim, dropout_prob, MLP_ACTS[mlp_act])
        self.drop_path = dnn.DropPath(drop_path_prob) if drop_path_prob > 0.0 else None

    def _branch(self, y):
        return y if self.drop_path is None else self.drop_path(y)

    def forward(self, x):
        y = self.attn(self.ln_1(x))
        if self.dropout is not None:
            y = self.dropout(y)
        x = x + self._branch(y)
        mlp = self.moe_mlp if self.uses_moe else self.mlp
        return x + self._branch(mlp(self.ln_2(x)))


class PatchEmbed(nn.Module):
    """Patchify + linear embed + [cls] token + learned position table.

    Each p x p patch is flattened in (row, column, channel) order and goes
    through one Dense to ``embed_dim`` (a reshape, no convolution). The
    position table is sized from the input's token count. Input: an
    NCHW-logical feature map; output: tokens (N, T, D)."""

    def __init__(self, in_channels: int, image_hw: Tuple[int, int], patch_size: int,
                 embed_dim: int, use_cls_token: bool = True, dropout_prob: float = 0.0):
        super().__init__()
        p = int(patch_size)
        hgt, wid = image_hw
        if hgt % p or wid % p:
            raise ValueError(f"input {hgt}x{wid} not divisible by patch_size={p}")
        self.patch_size, self.embed_dim = p, int(embed_dim)
        self.proj = dnn.Dense(p * p * int(in_channels), self.embed_dim)
        t = (hgt // p) * (wid // p) + (1 if use_cls_token else 0)
        self.cls_token = nn.Parameter(torch.empty(1, 1, self.embed_dim)) \
            if use_cls_token else None
        self.pos_embedding = nn.Parameter(torch.empty(1, t, self.embed_dim))
        self.dropout = dnn.Dropout(dropout_prob) if dropout_prob > 0.0 else None

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            if self.cls_token is not None:
                self.cls_token.zero_()
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        n, c, hgt, wid = x.shape
        p = self.patch_size
        x = x.movedim(1, -1).reshape(n, hgt // p, p, wid // p, p, c)
        x = x.transpose(2, 3).reshape(n, (hgt // p) * (wid // p), p * p * c)
        x = self.proj(x)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(n, 1, -1), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        return x if self.dropout is None else self.dropout(x)


class TakeToken(nn.Module):
    """(N, T, D) -> (N, D): one token (the [cls] head input)."""

    def __init__(self, index: int = 0):
        super().__init__()
        self.index = int(index)

    def forward(self, x):
        return x[:, self.index]


# --------------------------------------------------------------------------- #
# Position-table resampling
# --------------------------------------------------------------------------- #

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (``jax.image.resize`` 'cubic')."""
    x = np.abs(x)
    return np.where(x <= 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
                    np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(method='cubic')`` along
    one axis: half-pixel centres, the kernel widened by the scale when
    shrinking (antialiasing), weights renormalised over the in-range
    samples."""
    scale = n_out / n_in
    kscale = min(scale, 1.0)
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    w = _keys_cubic((np.arange(n_in)[None, :] - centres[:, None]) * kscale)
    total = w.sum(axis=1, keepdims=True)
    return np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                    w / np.where(total != 0, total, 1), 0.0)


def resize_pos_embedding(state_dict: Mapping[str, torch.Tensor], new_hw: int,
                         patch_size: int, embed_node: str = "embed"
                         ) -> dict:
    """Fine-tune a trained ViT at a new resolution: resample the learned
    position table's grid part to the new token count with
    ``jax.image.resize``'s cubic kernel (the [cls] slot is kept). Returns a
    new ``state_dict``; every other entry is shared. ``new_hw`` is the new
    square input size; the new grid is (new_hw // patch_size)^2."""
    key = f"module.nodes.{embed_node}.pos_embedding"
    pos = state_dict[key]
    has_cls = f"module.nodes.{embed_node}.cls_token" in state_dict
    grid = pos[:, 1:] if has_cls else pos
    t_old = grid.shape[1]
    side_old = int(round(math.sqrt(t_old)))
    if side_old * side_old != t_old:
        raise ValueError(f"position table's grid part has {t_old} tokens — "
                         "not square; cannot infer the old grid")
    if int(new_hw) % int(patch_size):
        raise ValueError(f"new_hw={new_hw} not divisible by patch_size={patch_size}")
    side_new = int(new_hw) // int(patch_size)
    d = pos.shape[-1]
    w = torch.as_tensor(_resize_weights(side_old, side_new), dtype=torch.float32)
    g = grid.float().reshape(side_old, side_old, d)
    g = torch.einsum("ih,hwd->iwd", w, g)
    g = torch.einsum("jw,iwd->ijd", w, g).reshape(1, side_new * side_new, d)
    new = torch.cat([pos[:, :1].float(), g], dim=1) if has_cls else g
    out = dict(state_dict)
    out[key] = new.to(pos.dtype)
    return out


# --------------------------------------------------------------------------- #
# Windowed attention (Swin: Liu et al., arXiv:2103.14030)
# --------------------------------------------------------------------------- #

def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(N, H, W, C) -> (N * nH * nW, w*w, C): windows in (image, row,
    column) order, tokens row-major inside each."""
    n, h, wid, c = x.shape
    x = x.reshape(n, h // w, w, wid // w, w, c).transpose(2, 3)
    return x.reshape(-1, w * w, c)


def _window_reverse(win: torch.Tensor, w: int, h: int, wid: int) -> torch.Tensor:
    """Inverse of :func:`_window_partition`."""
    c = win.shape[-1]
    x = win.reshape(-1, h // w, wid // w, w, w, c).transpose(2, 3)
    return x.reshape(-1, h, wid, c)


def _relative_position_index(w: int) -> np.ndarray:
    """Static (w*w, w*w) index into the (2w-1)^2 relative-bias table
    (Swin's construction)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)   # (2, w*w)
    rel = coords[:, :, None] - coords[:, None, :]                  # (2, T, T)
    rel = rel.transpose(1, 2, 0) + (w - 1)                         # to >= 0
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def _shift_attention_mask(h: int, wid: int, w: int, shift: int) -> np.ndarray:
    """Static additive mask (nWindows, w*w, w*w) for shifted windows: -1e9
    between tokens of different regions of the shifted map (the rows and
    columns [0, -w), [-w, -shift) and [-shift, 0), Swin's labels), so that
    content wrapped around by the cyclic shift attends only to itself."""
    img = np.zeros((h, wid), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // w, w, wid // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)                                   # (nW, T)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """(Shifted-)window multi-head self-attention on an (N, H, W, C) map
    (Swin W-MSA / SW-MSA): attention inside non-overlapping w x w windows
    with a learned relative-position bias ``rel_pos_bias``, a
    ((2w-1)^2, heads) table indexed as Swin's; ``shift`` rolls the map by
    (-shift, -shift) first (``torch.roll``), adds the static -1e9 mask in
    float32 and rolls back. When the map is no larger than the window the
    window is clamped to it and the shift dropped (Swin's convention), so
    the map size ``map_hw`` is fixed at construction. The bias index and
    the mask are static: built from the numpy helpers on first use on a
    device and kept per device, so that a model built on the meta device
    and given its weights by ``load_state_dict`` needs no
    ``init_parameters``."""

    def __init__(self, dim: int, map_hw: Tuple[int, int], num_heads: int,
                 window: int = 7, shift: int = 0):
        super().__init__()
        h, wid = (int(s) for s in map_hw)
        nh = int(num_heads)
        w = min(int(window), h, wid)
        shift = int(shift) if w < min(h, wid) else 0
        if h % w or wid % w:
            raise ValueError(f"feature map {h}x{wid} not divisible by window={w}")
        if dim % nh:
            raise ValueError(f"dim {dim} not divisible by {nh} heads")
        self.map_hw, self.num_heads, self.window, self.shift = (h, wid), nh, w, shift
        t = w * w
        self.qkv = dnn.Dense(dim, 3 * dim)
        self.out = dnn.Dense(dim, dim)
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * w - 1) ** 2, nh))
        self._static = {}

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.rel_pos_bias.normal_(0.0, 0.02, generator=generator)

    def static_tensors(self, device: torch.device):
        """The bias index, (w*w * w*w,) long, and the shift mask,
        (nWindows, w*w, w*w) float32 (None unshifted), on ``device``."""
        if device not in self._static:
            w = self.window
            index = torch.from_numpy(_relative_position_index(w).reshape(-1).astype(np.int64))
            mask = torch.from_numpy(_shift_attention_mask(*self.map_hw, w, self.shift)) \
                if self.shift else None
            self._static[device] = (index.to(device),
                                    None if mask is None else mask.to(device))
        return self._static[device]

    def forward(self, x):
        n, h, wid, c = x.shape
        if (h, wid) != self.map_hw:
            raise ValueError(f"WindowAttention built for a {self.map_hw[0]}x"
                             f"{self.map_hw[1]} map, got {h}x{wid}")
        nh, w, shift = self.num_heads, self.window, self.shift
        dh, t = c // nh, w * w
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        win = _window_partition(x, w)                               # (B, T, C)
        q, k, v = self.qkv(win).reshape(-1, t, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0)
        index, mask = self.static_tensors(x.device)
        with _no_autocast(x.device):
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
            bias = self.rel_pos_bias.float()[index].reshape(t, t, nh)
            s = s + bias.permute(2, 0, 1)
            if shift:
                nw = mask.shape[0]
                s = (s.reshape(n, nw, nh, t, t) + mask[None, :, None])
                s = s.reshape(-1, nh, t, t)
            p = torch.softmax(s, dim=-1)
        o = torch.matmul(p.to(v.dtype), v).transpose(1, 2).reshape(-1, t, c)
        x = _window_reverse(self.out(o), w, h, wid)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x


class SwinBlock(nn.Module):
    """Pre-LN Swin transformer block on an NCHW-logical map: x + drop_path(
    (S)W-MSA(ln_1(x))); x + drop_path(MLP(ln_2(x))), the MLP exact-GELU at
    ``mlp_ratio`` x C, the norms (``layer_norm`` or ``rms_norm``) over the
    channels. The attention takes the map's NHWC view, which is the
    channels-last bytes (no copy), and hands back the NCHW view."""

    def __init__(self, dim: int, map_hw: Tuple[int, int], num_heads: int,
                 window: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path_prob: float = 0.0, ln_eps: float = 1e-5,
                 norm: str = "layer_norm"):
        super().__init__()
        self.ln_1 = dnn.make_token_norm(norm, ln_eps, dim)
        self.attn = WindowAttention(dim, map_hw, num_heads, window, shift)
        self.ln_2 = dnn.make_token_norm(norm, ln_eps, dim)
        self.mlp = MlpBlock(dim, int(round(dim * float(mlp_ratio))))
        self.drop_path = dnn.DropPath(drop_path_prob)

    def forward(self, x):
        y = self.attn(self.ln_1(x).movedim(1, -1)).movedim(-1, 1)
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.ln_2(x)))


class PatchMerging(nn.Module):
    """Swin's between-stage downsampling: concatenate each 2x2
    neighbourhood (C -> 4C) in torch's order (x0 = h0w0, x1 = h1w0, x2 =
    h0w1, x3 = h1w1: the h offset varies fastest), LayerNorm ``ln``, then
    the bias-free Dense ``reduce`` to 2C. NCHW-logical map in and out."""

    def __init__(self, dim: int, ln_eps: float = 1e-5):
        super().__init__()
        self.ln = dnn.LayerNorm(4 * int(dim), eps=ln_eps)
        self.reduce = dnn.Dense(4 * int(dim), 2 * int(dim), use_bias=False)

    def forward(self, x):
        n, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"feature map {h}x{w} not divisible by 2")
        x = x.movedim(1, -1).reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        x = self.reduce(self.ln(x.reshape(n, (h // 2) * (w // 2), 4 * c)))
        return x.reshape(n, h // 2, w // 2, 2 * c).movedim(-1, 1)

"""Attention ops and the vision-transformer building blocks (the ViT subset).

Counterpart of ``deepcv_tpu/ops/attention.py``: ``attention_xla``,
``flash_attention``, ``scaled_dot_product_attention``,
``MultiHeadSelfAttention``, ``MlpBlock``, ``TransformerEncoderBlock``,
``PatchEmbed``, ``TakeToken`` and ``resize_pos_embedding``. The Swin blocks
(``WindowAttention``, ``SwinBlock``, ``PatchMerging``) and the MoE MLP are
not ported yet.

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
"""
from __future__ import annotations

import contextlib
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
]

ATTENTION_IMPLS = ("xla", "flash")


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference scaled-dot-product attention, (N, H, T, Dh) -> same: the
    (T, T) scores materialised, softmax statistics in float32, the
    probabilities cast to v's dtype for the second product."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _no_autocast(device: torch.device):
    """The kernels and their plain versions pick their own precision."""
    if device.type in ("cpu", "cuda"):
        return torch.autocast(device.type, enabled=False)
    return contextlib.nullcontext()


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
    ``drop_path_prob`` is stochastic depth on both residual branches."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dropout_prob: float = 0.0, attn_dropout_prob: float = 0.0,
                 drop_path_prob: float = 0.0, attn_impl: str = "xla",
                 ln_eps: float = 1e-6, norm: str = "layer_norm",
                 mlp_act: str = "gelu"):
        super().__init__()
        if mlp_act not in MLP_ACTS:
            raise ValueError(f"mlp_act must be 'gelu' or 'gelu_tanh', got {mlp_act!r}")
        self.ln_1 = dnn.make_token_norm(norm, ln_eps, dim)
        self.attn = MultiHeadSelfAttention(dim, num_heads, attn_dropout_prob, attn_impl)
        self.dropout = dnn.Dropout(dropout_prob) if dropout_prob > 0.0 else None
        self.ln_2 = dnn.make_token_norm(norm, ln_eps, dim)
        self.mlp = MlpBlock(dim, mlp_dim, dropout_prob, MLP_ACTS[mlp_act])
        self.drop_path = dnn.DropPath(drop_path_prob) if drop_path_prob > 0.0 else None

    def _branch(self, y):
        return y if self.drop_path is None else self.drop_path(y)

    def forward(self, x):
        y = self.attn(self.ln_1(x))
        if self.dropout is not None:
            y = self.dropout(y)
        x = x + self._branch(y)
        return x + self._branch(self.mlp(self.ln_2(x)))


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

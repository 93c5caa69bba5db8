"""K3, K4, K5 in the port: the flash-attention kernels' plain versions
against the JAX package's Pallas kernels (interpret mode on the CPU, as
tests/test_attention.py runs them), the port's ``flash_attention``
autograd.Function against ``jax.grad`` of the JAX one, the wrappers'
dispatch and checks, the attention modules against their JAX counterparts
the CUDA source's interface, and emulations of the bf16 tensor-core
kernels' arithmetic (the forward, K3, and the backward, K4 and K5, each in
bf16 and in 3xTF32 for f32), and F3: every head dim of the zoo's ViTs has a
kernel. The CUDA kernels themselves run only on a card
(tests/test_torch_port_gpu.py)."""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.ops import attention as jatt
from deepcv_tpu_torch.ops import attention as tatt
from deepcv_tpu_torch.ops import nn as tnn
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.ops.kernels.flash_attention import (
    HEAD_DIMS, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    plain_flash_bwd_dkv, plain_flash_bwd_dq, plain_flash_fwd)
from deepcv_tpu_torch.spec.zoo import VIT_SETTINGS

KERNEL_TOL = 1e-5  # f32: the plain versions vs the Pallas kernels
GRAD_RTOL = 1e-3   # gradients through the autograd.Function vs jax.grad
MODULE_TOL = 1e-4  # module outputs, the bound of tests/test_torch_parity.py
# K3 on bf16 (the tensor-core kernel's arithmetic) vs the plain version,
# relative to max|ref|: o is rounded to bf16 once and P once before P.V,
# within a bf16 ulp (2**-7); lse is f32 throughout, another sum order
FLASH_BF16_TOL = 1e-2
LSE_TOL = 2e-5
# K3 on f32 (3xTF32, the tensor-core kernel's arithmetic) vs the plain
# version, relative to max|ref|: the f32 bound of chip_smoke.py and the GPU tests
FLASH_F32_TOL = 2e-5


def _qkv(t, dh=16, n=2, h=3, seed=0, k=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, h, t, dh)).astype(np.float32) for _ in range(k))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("t", [1, 17, 128, 197])
def test_plain_fwd_matches_pallas_interpret(t):
    q, k, v = _qkv(t, k=3)
    o_j, lse_j = jatt._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), return_lse=True)
    o, lse = plain_flash_fwd(*_t(q, k, v))
    assert o.dtype == torch.float32 and lse.shape == (2, 3, t)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=KERNEL_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=KERNEL_TOL, rtol=0)


@pytest.mark.parametrize("t", [17, 130, 197])
def test_plain_bwd_matches_pallas_interpret(t):
    q, k, v, g = _qkv(t, seed=1)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o_j, lse_j = jatt._flash_fwd_impl(jq, jk, jv, return_lse=True)
    dq_j, dk_j, dv_j = jatt._flash_bwd_impl(jq, jk, jv, o_j, lse_j, jg)
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = plain_flash_fwd(tq, tk, tv)
    delta = (tg * o).sum(-1)
    dq = plain_flash_bwd_dq(tq, tk, tv, tg, lse, delta)
    dk, dv = plain_flash_bwd_dkv(tq, tk, tv, tg, lse, delta)
    for got, ref in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=KERNEL_TOL, rtol=0)


@pytest.mark.parametrize("t", [17, 197])
def test_flash_attention_gradients_match_jax(t):
    q, k, v = _qkv(t, seed=2, k=3)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jatt.flash_attention(q, k, v)))

    gj = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    torch.sin(tatt.flash_attention(tq, tk, tv)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(np.asarray(ref)).max())


def test_flash_attention_bf16_keeps_dtype_and_tracks_f32():
    q, k, v = _t(*_qkv(33, seed=3, k=3))
    qb, kb, vb = (x.to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    o = tatt.flash_attention(qb, kb, vb)
    (o.float() ** 2).sum().backward()
    assert o.dtype == qb.grad.dtype == torch.bfloat16
    ref = tatt.attention_xla(q, k, v)
    np.testing.assert_allclose(o.detach().float().numpy(), ref.numpy(), atol=2e-2, rtol=0)


def test_xla_and_sdpa_match_jax():
    q, k, v = _qkv(19, seed=4, k=3)
    ref = np.asarray(jatt.attention_xla(*map(jnp.asarray, (q, k, v))))
    for impl in ("xla", "flash"):
        got = tatt.scaled_dot_product_attention(*_t(q, k, v), impl=impl)
        np.testing.assert_allclose(got.numpy(), ref, atol=KERNEL_TOL, rtol=0)
    with pytest.raises(ValueError, match="unknown attention impl 'fused'"):
        tatt.scaled_dot_product_attention(*_t(q, k, v), impl="fused")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v, g = _t(*_qkv(9, seed=5))
    wrappers = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [f.launches for f in wrappers]
    by_dtype = [dict(f.launches_by_dtype) for f in wrappers]
    o, lse = flash_attention_fwd(q, k, v)
    o_p, lse_p = plain_flash_fwd(q, k, v)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (g * o).sum(-1)
    assert torch.equal(flash_attention_bwd_dq(q, k, v, g, lse, delta),
                       plain_flash_bwd_dq(q, k, v, g, lse, delta))
    for a, b in zip(flash_attention_bwd_dkv(q, k, v, g, lse, delta),
                    plain_flash_bwd_dkv(q, k, v, g, lse, delta)):
        assert torch.equal(a, b)
    assert [f.launches for f in wrappers] == before
    assert [f.launches_by_dtype for f in wrappers] == by_dtype


def test_wrappers_check_their_operands():
    q, k, v, g = _t(*_qkv(9, seed=6))
    with pytest.raises(ValueError, match="differ"):
        flash_attention_fwd(q, k[:, :, :5], v)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="lse/delta"):
        flash_attention_bwd_dq(q, k, v, g, torch.zeros(2, 3, 9, dtype=torch.float64),
                               torch.zeros(2, 3, 9))
    with pytest.raises(ValueError, match=r"\(N, H, T, Dh\)"):
        flash_attention_fwd(q[0], k[0], v[0])


def test_meta_tensors_give_shapes_only():
    q = torch.empty(2, 3, 11, 64, device="meta")
    o = tatt.flash_attention(q, q, q)
    assert o.device.type == "meta" and o.shape == q.shape


def test_cuda_source_exports_the_three_launchers_with_the_wrappers_arity():
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    assert "#include <torch" not in src and "ATen" not in src
    arity = {"flash_attention_fwd_launch": 11, "flash_attention_bwd_dq_launch": 13,
             "flash_attention_bwd_dkv_launch": 14}
    for name, n in arity.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == n, name
    assert "-1e30f" in src and "sm_90a" in " ".join(_build.NVCC_FLAGS)


# --------------------------------------------------------------------------- #
# K3 on bf16: the tensor-core kernel's arithmetic, emulated
# --------------------------------------------------------------------------- #

def _emulate_tc_fwd(q, k, v, rows=64, keys=64):
    """What ``flash_fwd_tc_kernel`` (csrc/flash_attention.cu) computes for
    bf16 (N, H, T, Dh) inputs, in torch: blocks of 64 q rows, 64-key tiles
    padded past T with the score -1e30 and zero V rows, the online
    recurrence on raw f32 scores with the scale folded with log2(e) into
    exp2, l summing the f32 p, P rounded to bf16 before P.V; o in bf16,
    lse = m * scale + log(l) in f32."""
    n, h, t, dh = q.shape
    scale = np.float32(1.0 / math.sqrt(dh))
    sl2 = float(scale * np.float32(1.4426950408889634))
    qf, kf, vf = (x.float() for x in (q, k, v))
    o = torch.empty(n, h, t, dh)
    lse = torch.empty(n, h, t)
    for r0 in range(0, t, rows):
        qb = qf[:, :, r0:r0 + rows]
        m = torch.full(qb.shape[:3], -math.inf)
        l = torch.zeros(qb.shape[:3])
        acc = torch.zeros(qb.shape)
        for k0 in range(0, t, keys):
            kt, vt = kf[:, :, k0:k0 + keys], vf[:, :, k0:k0 + keys]
            s = torch.matmul(qb, kt.transpose(-1, -2))
            pad = keys - kt.shape[2]
            s = torch.nn.functional.pad(s, (0, pad), value=-1e30)
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - mx) * sl2)
            p = torch.exp2(s * sl2 - (mx * sl2).unsqueeze(-1))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha.unsqueeze(-1) + torch.matmul(p.bfloat16().float(), vt)
            m = mx
        o[:, :, r0:r0 + rows] = acc / l.unsqueeze(-1)
        lse[:, :, r0:r0 + rows] = m * float(scale) + torch.log(l)
    return o.bfloat16(), lse


def _bf16_qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
                 for _ in range(3))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", [(1, 2, 197, 64)]
                         + [(1, 2, t, 64) for t in (1, 5, 64, 65, 130)]
                         + [(1, 2, 197, dh) for dh in (16, 32, 128, 80)])
def test_tensor_core_fwd_arithmetic_matches_plain(shape):
    q, k, v = _bf16_qkv(shape, seed=10)
    o, lse = _emulate_tc_fwd(q, k, v)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    assert o.dtype == o_ref.dtype == torch.bfloat16 and lse.shape == shape[:3]
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert _rel(o.float(), o_ref.float()) <= FLASH_BF16_TOL
    assert _rel(lse, lse_ref) <= LSE_TOL


def test_tensor_core_fwd_arithmetic_matches_pallas_interpret():
    q, k, v = _bf16_qkv((1, 2, 197, 64), seed=11)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16) for x in (q, k, v))
    o_j, lse_j = jatt._flash_fwd_impl(jq, jk, jv, return_lse=True)
    assert o_j.dtype == jnp.bfloat16
    o, lse = _emulate_tc_fwd(q, k, v)
    assert _rel(o.float(), np.asarray(o_j, np.float32)) <= FLASH_BF16_TOL
    assert _rel(lse, np.asarray(lse_j)) <= LSE_TOL


# --------------------------------------------------------------------------- #
# K3 on f32: the tensor-core kernel's 3xTF32 arithmetic, emulated
# --------------------------------------------------------------------------- #

def _tf32_split(x):
    """``(hi, lo)``: x rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds, and x − hi rounded the
    same way; by bit operations on the float32 view (adding half a TF32 ulp
    to the magnitude bits and clearing the 13 low bits), as the kernel's
    ``rna_tf32`` does."""
    def rna(v):
        b = v.float().contiguous().view(torch.int32)
        return ((b + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x.float() - hi)


# m16n8k8 tf32 fragments (PTX ISA): lane l holds A register i at (row, k),
# B register i at (k, n) and accumulator register i at (row, col)
_LANE = torch.arange(32)
_G, _C = _LANE // 4, _LANE % 4


def _a_at(i):
    return _G + 8 * (i & 1), _C + 4 * (i >> 1)


def _b_at(i):
    return _C + 4 * i, _G


def _acc_at(i):
    return _G + 8 * (i >> 1), 2 * _C + (i & 1)


#: flash_fwd_f32tc_kernel's choices (csrc/flash_attention.cu): where each
#: lane reads its A and B registers from, in a 16x8 block of Q (rows, dims),
#: an 8x8 block of K (keys, dims), the 16x8 S accumulator (rows, keys) and an
#: 8x8 block of V (keys, dims). Q K^T: k c <- dim 2c, k c + 4 <- dim 2c + 1
#: (8-byte loads); P V: P's A register i is accumulator register (0, 2, 1,
#: 3)[i], so k c <- key 2c, k c + 4 <- key 2c + 1, and V's B register i is
#: key 2c + i at dim g.
_Q_FROM = [(_G + 8 * (i & 1), 2 * _C + (i >> 1)) for i in range(4)]
_K_FROM = [(_G, 2 * _C + i) for i in range(2)]
_P_FROM = [_acc_at(j) for j in (0, 2, 1, 3)]
_V_FROM = [(2 * _C + i, _G) for i in range(2)]


def _operand(x, regs_at, src, rows):
    """The (rows, 8) matrix an mma sees as its A (rows 16) or B (rows 8,
    indexed (k, n)) operand when each lane loads register i of its fragment
    from ``x[..., src[i]]`` (x's last two dims a 16x8 or 8x8 block)."""
    out = torch.zeros((*x.shape[:-2], rows, 8), dtype=x.dtype)
    for i, (sr, sc) in enumerate(src):
        r, k = regs_at(i)
        out[..., r, k] = x[..., sr, sc]
    return out


def _mma_tf32(a, b, products=3):
    """Σ_k a b over the k8 steps of a product, as the kernel's three TF32
    mmas give it: lo·hi + hi·lo + hi·hi, each product exact, sums in f32
    (``products=1``: hi·hi alone, one TF32 mma)."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    if products == 1:
        return torch.matmul(ah, bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _blocks(x, r):
    """(..., R, C) -> (..., R / r, C / 8, r, 8): r x 8 blocks."""
    *lead, rr, cc = x.shape
    return x.reshape(*lead, rr // r, r, cc // 8, 8).transpose(-3, -2)


def _emulate_f32tc_fwd(q, k, v, keys=32, products=3):
    """What ``flash_fwd_f32tc_kernel`` (csrc/flash_attention.cu) computes for
    f32 (N, H, T, Dh) inputs, in torch, fragment by fragment: q rows padded
    to m16 tiles and keys to 32-key tiles (zero rows); per tile, S = Q Kᵀ
    and O += P V from the operands each lane loads (``_Q_FROM``, ``_K_FROM``,
    ``_P_FROM``, ``_V_FROM``), each product by 3xTF32; keys past T get the
    score -1e30 and p = 0; the online recurrence on raw f32 scores with the
    scale folded with log2(e) into exp2, l summing the f32 p; o = acc / l,
    lse = m · scale + log(l)."""
    n, h, t, dh = q.shape
    scale = np.float32(1.0 / math.sqrt(dh))
    sl2 = float(scale * np.float32(1.4426950408889634))
    tq, tk = -(-t // 16) * 16, -(-t // keys) * keys
    pad = torch.nn.functional.pad
    qf = pad(q.float(), (0, 0, 0, tq - t))
    kf, vf = (pad(x.float(), (0, 0, 0, tk - t)) for x in (k, v))
    qa = _operand(_blocks(qf, 16), _a_at, _Q_FROM, 16)       # (n, h, m, ks, 16, 8)
    m = torch.full((n, h, tq), -math.inf)
    l = torch.zeros((n, h, tq))
    acc = torch.zeros((n, h, tq, dh))
    for k0 in range(0, tk, keys):
        kb = _operand(_blocks(kf[:, :, k0:k0 + keys], 8), _b_at, _K_FROM, 8)  # (n, h, j, ks, 8k, 8n)
        # S[m, j] = Σ_kk A(Q)[m, kk] B(K)[j, kk]: one 16x8 accumulator each
        sacc = _mma_tf32(qa.unsqueeze(3), kb.unsqueeze(2), products).sum(-3)      # (n, h, m, j, 16, 8)
        s = sacc.transpose(-3, -2).reshape(n, h, tq, keys)
        live = torch.arange(k0, k0 + keys) < t
        s = torch.where(live, s, torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * sl2)
        p = torch.where(live, torch.exp2(s * sl2 - (mx * sl2).unsqueeze(-1)), torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        # O += P V: P's A operand from its accumulator registers, V's B
        # operand from keys 2c and 2c + 1 of each k8 step
        pa = _operand(_blocks(p, 16), _a_at, _P_FROM, 16)    # (n, h, m, j, 16, 8)
        vb = _operand(_blocks(vf[:, :, k0:k0 + keys], 8), _b_at, _V_FROM, 8)  # (n, h, j, nd, 8, 8)
        pv = _mma_tf32(pa.unsqueeze(3), vb.transpose(2, 3).unsqueeze(2), products).sum(-3)  # (n, h, m, nd, 16, 8)
        acc = acc * alpha.unsqueeze(-1) + pv.transpose(-3, -2).reshape(n, h, tq, dh)
        m = mx
    o = (acc / l.unsqueeze(-1))[:, :, :t]
    lse = (m * float(scale) + torch.log(l))[:, :, :t]
    return o, lse


def test_tf32_split_rounds_to_nearest_away_and_keeps_f32_accuracy():
    rng = np.random.default_rng(20)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, size=4096),
        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 2 ** -30, 0.0]]).astype(np.float32))
    hi, lo = _tf32_split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # ties go away from zero: 1 + 2^-11 is half a TF32 ulp above 1
    assert hi[-5].item() == 1 + 2 ** -10 and hi[-4].item() == -(1 + 2 ** -10)
    assert hi[-3].item() == 1 + 2 ** -9 and lo[-5].item() == -(2 ** -11)
    # one TF32 product is not f32-accurate; the split is
    assert ((x.double() - hi.double()).abs() > 2.0 ** -21 * x.double().abs()).any()


def test_f32tc_fragment_loads_give_the_products():
    """The kernel's fragment choices are a permutation of each k8 step's k
    index, the same on both operands: the mma of the loaded operands is the
    product itself (exactly, in float64)."""
    rng = np.random.default_rng(21)
    q, kt, p = (torch.from_numpy(rng.normal(size=sh)) for sh in ((16, 8), (8, 8), (16, 8)))
    v = torch.from_numpy(rng.normal(size=(8, 8)))
    qa, kb = _operand(q, _a_at, _Q_FROM, 16), _operand(kt, _b_at, _K_FROM, 8)
    pa, vb = _operand(p, _a_at, _P_FROM, 16), _operand(v, _b_at, _V_FROM, 8)
    torch.testing.assert_close(qa @ kb, q @ kt.T, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(pa @ vb, p @ v, rtol=1e-12, atol=1e-12)
    # P's A operand is a permutation of the accumulator's columns, not them:
    # the unpermuted pairing (a_i from accumulator register i) is wrong
    wrong = _operand(p, _a_at, [_acc_at(j) for j in range(4)], 16)
    assert not torch.allclose(wrong @ vb, p @ v)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 5, 64, 65, 130, 197])
def test_f32_tensor_core_fwd_arithmetic_matches_plain(t, dh):
    q, k, v = _t(*_qkv(t, dh=dh, n=1, h=2, seed=14, k=3))
    o, lse = _emulate_f32tc_fwd(q, k, v)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    assert o.dtype == torch.float32 and o.shape == o_ref.shape and lse.shape == (1, 2, t)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _rel(o, o_ref) <= FLASH_F32_TOL
    assert _rel(lse, lse_ref) <= LSE_TOL


@pytest.mark.parametrize("dh", [64, 80])
def test_f32_tensor_core_fwd_arithmetic_matches_pallas_interpret(dh):
    q, k, v = _qkv(197, dh=dh, n=1, h=2, seed=15, k=3)
    o_j, lse_j = jatt._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), return_lse=True)
    o, lse = _emulate_f32tc_fwd(*_t(q, k, v))
    assert _rel(o, np.asarray(o_j)) <= FLASH_F32_TOL
    assert _rel(lse, np.asarray(lse_j)) <= LSE_TOL


def test_one_tf32_product_would_miss_the_f32_bound():
    """Why 3xTF32: the same recurrence with one TF32 product per mma (hi·hi
    only) misses the 2e-5 bound at ViT's shape (by some 20 times)."""
    q, k, v = _t(*_qkv(197, dh=64, n=1, h=2, seed=16, k=3))
    o, _ = _emulate_f32tc_fwd(q, k, v, products=1)
    assert _rel(o, plain_flash_fwd(q, k, v)[0]) > FLASH_F32_TOL


# --------------------------------------------------------------------------- #
# F3: every head dim of the zoo's ViTs has a kernel
# --------------------------------------------------------------------------- #

def test_every_vit_setting_head_dim_has_a_kernel():
    dims = {name: hidden // heads for name, (_, _, heads, hidden, _) in VIT_SETTINGS.items()}
    assert all(hidden % heads == 0 for _, _, heads, hidden, _ in VIT_SETTINGS.values())
    assert set(dims.values()) <= set(HEAD_DIMS), dims
    assert dims["h_14"] == 80


def test_cuda_dispatch_covers_head_dims():
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    body = re.search(r"cudaError_t dispatch_dh\(.*?\n}\n", src, re.S).group(0)
    cases = [(int(a), int(b)) for a, b in
             re.findall(r"case (\d+): return launch<T, (\d+)>", body)]
    assert [a for a, _ in cases] == [b for _, b in cases] == list(HEAD_DIMS)


@pytest.mark.parametrize("t", [65, 197])
def test_plain_flash_matches_pallas_interpret_at_head_dim_80(t):
    q, k, v, g = _qkv(t, dh=80, n=1, h=2, seed=17)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o_j, lse_j = jatt._flash_fwd_impl(jq, jk, jv, return_lse=True)
    dq_j, dk_j, dv_j = jatt._flash_bwd_impl(jq, jk, jv, o_j, lse_j, jg)
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = plain_flash_fwd(tq, tk, tv)
    delta = (tg * o).sum(-1)
    grads = (plain_flash_bwd_dq(tq, tk, tv, tg, lse, delta),
             *plain_flash_bwd_dkv(tq, tk, tv, tg, lse, delta))
    for got, ref in ((o, o_j), (lse, lse_j), *zip(grads, (dq_j, dk_j, dv_j))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=KERNEL_TOL, rtol=0)


# --------------------------------------------------------------------------- #
# K4 and K5 on bf16: the tensor-core kernels' arithmetic, emulated
# --------------------------------------------------------------------------- #

def _emulate_tc_bwd(q, k, v, do, lse, delta, step=16):
    """What ``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkv_tc_kernel``
    (csrc/flash_attention.cu) compute for bf16 (N, H, T, Dh) inputs, in
    torch: raw f32 scores S = q kᵀ and dP = dO vᵀ; P = exp2(S · scale ·
    log2(e) − lse · log2(e)) and dS = P (dP − δ) in f32; P and dS rounded
    to bf16 as the A operands of dQ += dS k, dK += dSᵀ q and dV += Pᵀ dO,
    accumulated in f32 over the kernels' 16-row steps (keys for dQ, q rows
    for dK and dV) of their 64-row tiles; dQ · scale, dK · scale and dV
    rounded to bf16. Rows past T are the tiles' zero padding, whose P is 0,
    so they add nothing and are left out."""
    t, dh = q.shape[-2:]
    scale = np.float32(1.0 / math.sqrt(dh))
    log2e = np.float32(1.4426950408889634)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p = torch.exp2(s * float(scale * log2e) - (lse * float(log2e)).unsqueeze(-1))
    ds = p * (dp - delta.unsqueeze(-1))
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(qf.shape), torch.zeros(qf.shape)
    for j in range(0, t, step):
        sl = slice(j, j + step)
        dq += torch.matmul(dsb[..., sl], kf[:, :, sl])
        dk += torch.matmul(dsb[:, :, sl].transpose(-1, -2), qf[:, :, sl])
        dv += torch.matmul(pb[:, :, sl].transpose(-1, -2), dof[:, :, sl])
    return (dq * float(scale)).bfloat16(), (dk * float(scale)).bfloat16(), dv.bfloat16()


def _bf16_bwd_inputs(shape, seed):
    """bf16 q, k, v, dO and, from the plain forward, lse and
    δ = rowsum(dO ⊙ o) with o rounded to bf16, as the autograd.Function
    hands them to K4 and K5."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
                   for _ in range(4))
    o, lse = plain_flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta


def _bwd_err(got, ref):
    """Error relative to max|ref|; absolute where the reference is zero up to
    rounding (dQ and dK at T = 1, where the softmax has one entry)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    diff, top = np.abs(got - ref).max(), np.abs(ref).max()
    return diff / top if top > 1e-6 else diff


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 80])
@pytest.mark.parametrize("t", [1, 5, 64, 65, 130, 197])
def test_tensor_core_bwd_arithmetic_matches_plain(t, dh):
    q, k, v, do, lse, delta = _bf16_bwd_inputs((1, 2, t, dh), seed=12)
    dq, dk, dv = _emulate_tc_bwd(q, k, v, do, lse, delta)
    refs = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        assert _bwd_err(got.float(), ref.float()) <= FLASH_BF16_TOL


def test_tensor_core_bwd_arithmetic_matches_pallas_interpret():
    q, k, v, do, _, _ = _bf16_bwd_inputs((1, 2, 197, 64), seed=13)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
                       for x in (q, k, v, do))
    o_j, lse_j = jatt._flash_fwd_impl(jq, jk, jv, return_lse=True)
    grads_j = jatt._flash_bwd_impl(jq, jk, jv, o_j, lse_j, jdo)
    assert all(g.dtype == jnp.bfloat16 for g in grads_j)
    # the kernels' inputs from the same forward: JAX's o (bf16) and lse
    lse = torch.from_numpy(np.array(lse_j))
    delta = (do.float() * torch.from_numpy(np.asarray(o_j, np.float32))).sum(-1)
    for got, ref in zip(_emulate_tc_bwd(q, k, v, do, lse, delta), grads_j):
        assert _bwd_err(got.float(), np.asarray(ref, np.float32)) <= FLASH_BF16_TOL


# --------------------------------------------------------------------------- #
# K4 and K5 on f32: the tensor-core kernels' 3xTF32 arithmetic, emulated
# --------------------------------------------------------------------------- #

#: flash_bwd_dq_f32tc_kernel's and flash_bwd_dkv_f32tc_kernel's fragment
#: choices for their second products (dQ += dS K, dV += Pᵀ dO, dK += dSᵀ Q):
#: the A operand is the S or dP accumulator with K3 f32's permutation
#: (``_P_FROM``) and the B operand lane reads rows 2c and 2c + 1 of the
#: streamed tile at head dim g, as K3 f32 reads V (``_V_FROM``). The first
#: products (S = Q Kᵀ, dP = dO Vᵀ; K5: Sᵀ = K Qᵀ, dPᵀ = V dOᵀ) read both
#: operands as K3 f32's Q Kᵀ does (``_Q_FROM``, ``_K_FROM``).
_ROWS_FROM = _V_FROM


def _scores_f32tc(a, b, products):
    """A Bᵀ for (n, h, R, Dh) a (R a multiple of 16) and (n, h, C, Dh) b (C
    a multiple of 8), fragment by fragment: a's 16x8 A fragments, b's 8x8
    B fragments, each k8 step's three products summed from zero, the steps
    over the head dim summed in f32."""
    n, h, r, _ = a.shape
    aa = _operand(_blocks(a, 16), _a_at, _Q_FROM, 16)   # (n, h, m, ks, 16, 8)
    bb = _operand(_blocks(b, 8), _b_at, _K_FROM, 8)     # (n, h, j, ks, 8k, 8n)
    acc = _mma_tf32(aa.unsqueeze(3), bb.unsqueeze(2), products).sum(-3)  # (n, h, m, j, 16, 8)
    return acc.transpose(-3, -2).reshape(n, h, r, b.shape[2])


def _long_sum_f32tc(x, y, products):
    """Σ_i x[:, :, :, i] y[:, :, i] for (n, h, R, T) x and (n, h, T, Dh) y, as
    the backward kernels sum over T: one k8 step of 8 rows of T at a time,
    x's A fragments from its accumulator (``_P_FROM``), y's B fragments from
    rows 2c and 2c + 1 (``_ROWS_FROM``); each step's three products summed
    from zero, then added to the f32 accumulator in order of T."""
    n, h, r, t = x.shape
    dh = y.shape[-1]
    xa = _operand(_blocks(x, 16), _a_at, _P_FROM, 16)        # (n, h, m, j, 16, 8)
    yb = _operand(_blocks(y, 8), _b_at, _ROWS_FROM, 8)       # (n, h, j, nd, 8k, 8n)
    acc = torch.zeros((n, h, r // 16, dh // 8, 16, 8))
    for j in range(t // 8):
        acc = acc + _mma_tf32(xa[:, :, :, j].unsqueeze(3), yb[:, :, j].unsqueeze(2), products)
    return acc.transpose(-3, -2).reshape(n, h, r, dh)


def _emulate_f32tc_bwd(q, k, v, do, lse, delta, products=3):
    """What ``flash_bwd_dq_f32tc_kernel`` and ``flash_bwd_dkv_f32tc_kernel``
    (csrc/flash_attention.cu) compute for f32 (N, H, T, Dh) inputs, in torch,
    fragment by fragment: the blocks' rows padded to m16 tiles and the
    streamed rows to 32-row tiles (zero rows); S = Q Kᵀ and dP = dO Vᵀ
    (K5: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, its own products) by 3xTF32 over the
    head dim; P = exp2(S · scale · log2(e) − lse · log2(e)), 0 past T, and
    dS = P (dP − δ) in f32; then dQ += dS K, dV += Pᵀ dO and dK += dSᵀ Q
    by 3xTF32 over T (``_long_sum_f32tc``). In every product each k8
    step's three products sum from zero and are added to the f32 sum, as
    the kernels add them; dQ · scale, dK · scale, dV.
    ``products=1``: hi·hi alone, one TF32 mma per product."""
    n, h, t, dh = q.shape
    scale = np.float32(1.0 / math.sqrt(dh))
    log2e = np.float32(1.4426950408889634)
    sl2 = float(scale * log2e)
    tb, tt = -(-t // 16) * 16, -(-t // 32) * 32     # a block's m16 rows; streamed tiles
    pad = torch.nn.functional.pad
    rows = lambda x, r: pad(x.float(), (0, 0, 0, r - t))  # noqa: E731
    stat = lambda x, r: pad(x.float(), (0, r - t))        # noqa: E731
    live = torch.arange(tt) < t
    zero = torch.tensor(0.0)

    # K4: a block's q rows against the streamed keys
    s = _scores_f32tc(rows(q, tb), rows(k, tt), products)            # (n, h, tb, tt)
    dp = _scores_f32tc(rows(do, tb), rows(v, tt), products)
    lb = (stat(lse, tb) * float(log2e)).unsqueeze(-1)
    p = torch.where(live, torch.exp2(s * sl2 - lb), zero)
    ds = p * (dp - stat(delta, tb).unsqueeze(-1))
    dq = _long_sum_f32tc(ds, rows(k, tt), products) * float(scale)

    # K5: a block's key rows against the streamed q rows, lse and δ per column
    st = _scores_f32tc(rows(k, tb), rows(q, tt), products)           # (n, h, tb, tt)
    dpt = _scores_f32tc(rows(v, tb), rows(do, tt), products)
    pt = torch.where(live, torch.exp2(st * sl2 - (stat(lse, tt) * float(log2e)).unsqueeze(-2)),
                     zero)
    dst = pt * (dpt - stat(delta, tt).unsqueeze(-2))
    dk = _long_sum_f32tc(dst, rows(q, tt), products) * float(scale)
    dv = _long_sum_f32tc(pt, rows(do, tt), products)
    return dq[:, :, :t], dk[:, :, :t], dv[:, :, :t]


def _f32_bwd_inputs(t, dh, seed):
    """f32 q, k, v, dO and, from the plain forward, lse and δ = rowsum(dO ⊙ o),
    as the autograd.Function hands them to K4 and K5."""
    q, k, v, do = _t(*_qkv(t, dh=dh, n=1, h=2, seed=seed))
    o, lse = plain_flash_fwd(q, k, v)
    return q, k, v, do, lse, (do * o).sum(-1)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 5, 16, 31, 32, 33, 64, 65, 130, 197])
def test_f32_tensor_core_bwd_arithmetic_matches_plain(t, dh):
    q, k, v, do, lse, delta = _f32_bwd_inputs(t, dh, seed=18)
    got = _emulate_f32tc_bwd(q, k, v, do, lse, delta)
    refs = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    for g, ref in zip(got, refs):
        assert g.dtype == ref.dtype == torch.float32 and g.shape == ref.shape
        assert torch.isfinite(g).all()
        assert _bwd_err(g, ref) <= FLASH_F32_TOL


@pytest.mark.parametrize("dh", [64, 80])
def test_f32_tensor_core_bwd_arithmetic_matches_pallas_interpret(dh):
    q, k, v, do = _qkv(197, dh=dh, n=1, h=2, seed=19)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_j, lse_j = jatt._flash_fwd_impl(jq, jk, jv, return_lse=True)
    grads_j = jatt._flash_bwd_impl(jq, jk, jv, o_j, lse_j, jdo)
    # the kernels' inputs from the same forward: JAX's o and lse
    tq, tk, tv, tdo = _t(q, k, v, do)
    lse = torch.from_numpy(np.array(lse_j))
    delta = (tdo * torch.from_numpy(np.array(o_j))).sum(-1)
    for got, ref in zip(_emulate_f32tc_bwd(tq, tk, tv, tdo, lse, delta), grads_j):
        assert _bwd_err(got, np.asarray(ref)) <= FLASH_F32_TOL


def test_one_tf32_product_would_miss_the_f32_bound_in_the_backward():
    """Why 3xTF32 in K4 and K5: the same arithmetic with one TF32 product per
    mma (hi·hi only) misses the 2e-5 bound at ViT's shape in each of dQ,
    dK and dV."""
    q, k, v, do, lse, delta = _f32_bwd_inputs(197, 64, seed=20)
    got = _emulate_f32tc_bwd(q, k, v, do, lse, delta, products=1)
    refs = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    for g, ref in zip(got, refs):
        assert _bwd_err(g, ref) > FLASH_F32_TOL


def _f32_swz(r):
    """f32_swz of csrc/flash_attention.cu: rows 4-7 of every 8 store their
    8-column groups swapped in pairs."""
    return (r & 4) << 1


def _banks_conflict_free(addrs, width):
    """Whether one shared-memory request of 4-byte (``width`` 1) or 8-byte
    (``width`` 2) loads, one float address per lane, needs one wavefront:
    8-byte loads go by half warps, each lane's two banks distinct."""
    group = 32 // width
    for h0 in range(0, 32, group):
        banks = [(a + i) % 32 for a in addrs[h0:h0 + group] for i in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_f32_bwd_tiles_are_read_both_ways_without_bank_conflicts(dh):
    """The f32 backward's streamed tiles (stride Dh + 8 floats, swizzled) are
    read two ways: 8-byte loads of columns 2c, 2c + 1 from rows g (the first
    products' fragments) and 4-byte loads of column g from rows 2c and
    2c + 1 (the second products' B fragments). With the swizzle neither
    conflicts, at every head dim and 8-column group; without it the second
    read would (rows 0 and 4 share banks)."""
    ld = dh + 8
    g, c = np.arange(32) // 4, np.arange(32) % 4
    for grp in range(dh // 8):
        rows8 = [r * ld + ((grp * 8 + 2 * cc) ^ _f32_swz(r)) for r, cc in zip(g, c)]
        assert _banks_conflict_free(rows8, 2)
        for i in (0, 1):
            r = 2 * c + i
            cols = [rr * ld + ((grp * 8 + gg) ^ _f32_swz(rr)) for rr, gg in zip(r, g)]
            assert _banks_conflict_free(cols, 1)
            plain = [rr * ld + grp * 8 + gg for rr, gg in zip(r, g)]
            assert not _banks_conflict_free(plain, 1)
    # the swizzle keeps each row a permutation of its columns, pairs intact
    for r in range(8):
        cols = sorted((d ^ _f32_swz(r)) for d in range(dh))
        assert cols == list(range(dh))
        assert all((d ^ _f32_swz(r)) + 1 == ((d + 1) ^ _f32_swz(r)) for d in range(0, dh, 2))


# --------------------------------------------------------------------------- #
# Modules vs JAX
# --------------------------------------------------------------------------- #

def _dense(mod, p):
    mod.weight.data = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
    mod.bias.data = torch.from_numpy(np.asarray(p["bias"]).copy())


def _affine(mod, p):
    mod.weight.data = torch.from_numpy(np.asarray(p["scale"]).copy())
    if "bias" in p:
        mod.bias.data = torch.from_numpy(np.asarray(p["bias"]).copy())


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("norm,mlp_act", [("layer_norm", "gelu"),
                                          ("rms_norm", "gelu_tanh")])
def test_encoder_block_matches_jax(impl, norm, mlp_act):
    x = np.random.default_rng(7).normal(size=(2, 17, 32)).astype(np.float32)
    jm = jatt.TransformerEncoderBlock(num_heads=4, mlp_dim=64, attn_impl=impl,
                                      norm=norm, mlp_act=mlp_act)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = tatt.TransformerEncoderBlock(32, 4, 64, attn_impl=impl, norm=norm,
                                      mlp_act=mlp_act)
    _affine(tm.ln_1, p["ln_1"])
    _affine(tm.ln_2, p["ln_2"])
    for name in ("qkv", "out"):
        _dense(getattr(tm.attn, name), p["attn"][name])
    for name in ("fc1", "fc2"):
        _dense(getattr(tm.mlp, name), p["mlp"][name])
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=MODULE_TOL, rtol=0)


def test_gelu_forms_are_pinned():
    """The MLP's default is exact erf GELU (the JAX package's gelu_exact);
    'gelu_tanh' and the registered name 'gelu' are the tanh form, which is
    where the config alias torch.nn.GELU -> 'gelu' lands, as in the JAX
    package."""
    from deepcv_tpu.config import REFERENCE_NAME_ALIASES as JAX_ALIASES
    from deepcv_tpu_torch.config import REFERENCE_NAME_ALIASES

    x = np.linspace(-4, 4, 101).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tatt.MLP_ACTS["gelu"](tx).numpy(),
                               np.asarray(jatt.gelu_exact(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(tatt.MLP_ACTS["gelu_tanh"](tx).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)
    assert tnn.ACTIVATION_FNS["gelu"] is tnn.gelu_tanh
    assert tnn.ACTIVATION_FNS["gelu_exact"] is tnn.gelu_exact
    assert not np.allclose(tnn.gelu_exact(tx).numpy(), tnn.gelu_tanh(tx).numpy(), atol=1e-5)
    assert REFERENCE_NAME_ALIASES["torch.nn.GELU"] == JAX_ALIASES["torch.nn.GELU"] == "gelu"
    with pytest.raises(ValueError, match="mlp_act"):
        tatt.TransformerEncoderBlock(32, 4, 64, mlp_act="relu")


def test_flash_with_attention_dropout_raises_in_training_only():
    m = tatt.MultiHeadSelfAttention(24, 4, dropout_prob=0.5, attn_impl="flash")
    x = torch.randn(2, 6, 24)
    with pytest.raises(ValueError, match="materialized"):
        m(x)
    m.eval()
    assert m(x).shape == x.shape
    xla = tatt.MultiHeadSelfAttention(24, 4, dropout_prob=0.5, attn_impl="xla")
    g = torch.Generator().manual_seed(0)
    xla.dropout.generator = g
    assert not torch.equal(xla(x), xla(x))


def test_drop_path_and_dropout_draw_from_their_generator():
    x = torch.ones(64, 5, 8)
    dp = tnn.DropPath(0.5)
    dp.generator = torch.Generator().manual_seed(3)
    y = dp(x)
    per_sample = y.reshape(64, -1)
    assert set(per_sample.min(1).values.tolist()) <= {0.0, 2.0}
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    dp.generator = torch.Generator().manual_seed(3)
    assert torch.equal(dp(x), y)
    dp.eval()
    assert torch.equal(dp(x), x)
    d = tnn.Dropout(0.25)
    d.generator = torch.Generator().manual_seed(1)
    z = d(x)
    assert set(torch.unique(z).tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}


def test_patch_embed_and_take_token_match_jax():
    x = np.random.default_rng(8).normal(size=(2, 16, 24, 3)).astype(np.float32)
    jm = jatt.PatchEmbed(patch_size=8, embed_dim=32)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = tatt.PatchEmbed(3, (16, 24), 8, 32)
    _dense(tm.proj, p["proj"])
    tm.cls_token.data = torch.from_numpy(np.asarray(p["cls_token"]).copy())
    tm.pos_embedding.data = torch.from_numpy(np.asarray(p["pos_embedding"]).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tm(xt).detach()
    assert got.shape == (2, 7, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=MODULE_TOL, rtol=0)
    np.testing.assert_array_equal(tatt.TakeToken(0)(got).numpy(), got[:, 0].numpy())


@pytest.mark.parametrize("new_hw", [32, 8])
def test_resize_pos_embedding_matches_jax(new_hw):
    rng = np.random.default_rng(9)
    pos = rng.normal(size=(1, 17, 8)).astype(np.float32)
    cls = np.zeros((1, 1, 8), np.float32)
    jv = {"params": {"node_impls_embed": {"pos_embedding": jnp.asarray(pos),
                                         "cls_token": jnp.asarray(cls)}}}
    ref = np.asarray(jatt.resize_pos_embedding(jv, new_hw, 4)["params"]
                     ["node_impls_embed"]["pos_embedding"])
    sd = {"module.nodes.embed.pos_embedding": torch.from_numpy(pos),
          "module.nodes.embed.cls_token": torch.from_numpy(cls)}
    got = tatt.resize_pos_embedding(sd, new_hw, 4)["module.nodes.embed.pos_embedding"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

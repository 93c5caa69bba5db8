"""K2 in the port: the fused conv+bias+act wrapper's plain version against the
JAX package's Pallas kernel (interpret mode, as tests/test_pallas.py runs
it on the CPU), the tensor-core kernels' tiling and arithmetic (bf16, and
f32 by 3xTF32) emulated in torch, the wrapper's checks and dispatch, and
the CUDA source's interface. The CUDA kernel itself runs only on a card
(tests/test_torch_port_gpu.py)."""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.ops.pallas.fused_layer import fused_conv2d_bias_act as jax_fused
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.ops.kernels.fused_layer import (
    F32_TC_BLOCKS, F32_TC_BN, TC_BM, TC_BN, TC_SMEM_MAX, blocks_per_sm,
    fused_conv2d_bias_act, pack_weight, plain_conv2d_bias_act, tc_plan)

TOL = 1e-5  # the repo's bound for the Pallas kernel (tests/test_pallas.py)
#: relative to max|ref|: the kernel and the plain version each round one f32
#: result to bf16, so they differ by at most one ulp, 2**-7 of the largest
#: value (chip_smoke.py's bound)
BF16_TOL = 1e-2


def _case(k, cin=8, cout=16, n=2, h=8, w=8, seed=0):
    rng = np.random.default_rng(seed + k)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (0.1 * rng.normal(size=(k, k, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    return x, wt, b


def _to_port(x, wt, b):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)          # NHWC bytes, channels_last
    wtt = torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()   # HWIO -> OIHW
    return xt, wtt, torch.from_numpy(b)


#: the epilogue's activations by name, as the JAX package defines them
#: (deepcv_tpu/ops/nn.py ACTIVATION_FNS)
JAX_ACTS = {None: None, "relu": jax.nn.relu, "relu6": jax.nn.relu6,
            "hard_swish": jax.nn.hard_swish, "silu": jax.nn.silu}


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("act", sorted(JAX_ACTS, key=str))
@pytest.mark.parametrize("bias", [False, True])
def test_plain_version_matches_pallas_interpret(k, act, bias):
    x, wt, b = _case(k)
    if act in ("relu6", "hard_swish"):
        x = 4.0 * x            # reach both of relu6's corners, and hard_swish's
    if not bias:
        b = np.zeros_like(b)   # the Pallas kernel always adds a bias
    y_jax = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                 JAX_ACTS[act], 2, True))
    xt, wtt, bt = _to_port(x, wt, b)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = fused_conv2d_bias_act(xt, wtt, bt if bias else None, act)
    y_plain = plain_conv2d_bias_act(xt, wtt, bt if bias else None, act)
    assert torch.equal(y, y_plain)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), y_jax, atol=TOL, rtol=0)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, wt, b = _to_port(*_case(3))
    before = fused_conv2d_bias_act.launches
    y = fused_conv2d_bias_act(x, wt, b, torch.sigmoid)
    assert fused_conv2d_bias_act.launches == before
    ref = torch.sigmoid(torch.nn.functional.conv2d(x, wt, b, padding=1))
    torch.testing.assert_close(y, ref, atol=1e-6, rtol=0)
    yb = fused_conv2d_bias_act(x.bfloat16(), wt.bfloat16(), b.bfloat16(), "leaky_relu")
    assert yb.dtype == torch.bfloat16
    assert yb.is_contiguous(memory_format=torch.channels_last)


def test_pack_weight_is_the_tpu_kernels_reshape_order():
    _, wt, _ = _case(3, cin=5, cout=7)
    packed = pack_weight(torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous())
    np.testing.assert_array_equal(packed.numpy(), wt.reshape(3 * 3 * 5, 7))
    assert packed.is_contiguous()


@pytest.mark.parametrize("bad,exc,match", [
    ("nchw", ValueError, "channels_last"),
    ("float64", TypeError, "not supported"),
    ("even", ValueError, "odd"),
    ("bias_shape", ValueError, "bias shape"),
    ("cin", ValueError, "input channels"),
    ("act_name", ValueError, "unknown activation"),
    ("w_packed", ValueError, "w_packed"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc, match):
    x, wt, b = _to_port(*_case(3))
    kw = {}
    act = None
    if bad == "nchw":
        x = x.contiguous()
    elif bad == "float64":
        x, wt, b = x.double(), wt.double(), b.double()
    elif bad == "even":
        wt = wt[:, :, :2, :2]
    elif bad == "bias_shape":
        b = b[:3]
    elif bad == "cin":
        wt = wt[:, :4]
    elif bad == "act_name":
        act = "gelu"
    elif bad == "w_packed":
        kw["w_packed"] = pack_weight(wt).t()
    with pytest.raises(exc, match=match):
        fused_conv2d_bias_act(x, wt, b, act, **kw)


def test_cuda_source_has_a_plain_c_launcher_and_no_torch_header():
    src = (_build.CSRC_DIR / "fused_conv2d_bias_act.cu").read_text()
    assert not re.search(r"#include\s*[<\"](torch|ATen|c10|pybind11)", src)
    assert 'extern "C" int fused_conv2d_bias_act_launch(' in src
    assert "deepcv_tpu/ops/pallas/fused_layer.py::_kernel" in src
    # x, w, b, y; 7 sizes; 6 strides; dtype, act, slope; the 7 ints of the
    # bf16 tile plan; the stream: as many as the wrapper's ctypes signature
    m = re.search(r'extern "C" int fused_conv2d_bias_act_launch\(([^)]*)\)', src)
    assert len(m.group(1).split(",")) == 28
    # both dtypes go to a tensor-core kernel (f32 by 3xTF32); no CUDA-core
    # kernel is left
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "fused_conv2d_bias_act_f32tc_kernel" in src
    assert "launch<" not in src and "fused_conv2d_bias_act_kernel" not in src
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def test_library_path_follows_the_source_and_lives_in_the_build_dir():
    p = _build.library_path("fused_conv2d_bias_act")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p == _build.library_path("fused_conv2d_bias_act")
    with pytest.raises(FileNotFoundError):
        _build.library_path("no_such_kernel")


def test_build_without_nvcc_raises_a_clear_error():
    if _build.find_nvcc() is not None:
        pytest.skip("nvcc is installed here; the error path is moot")
    if _build.library_path("fused_conv2d_bias_act").is_file():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fused_conv2d_bias_act")


# --------------------------------------------------------------------------- #
# K2 on the tensor cores (bf16, and f32 by 3xTF32): tiling and arithmetic,
# emulated
# --------------------------------------------------------------------------- #

def _emulate_tiles(x, w, b, act, itemsize, k_step):
    """The tiles of :func:`tc_plan` for ``itemsize`` (flat runs of BM pixels
    for 1x1, else TI images x TH x TW output pixels with a (TH+kh-1) x
    (TW+kw-1) input patch, zero outside the image); channels zero-padded to
    one k step (16 channels in bf16, 8 in f32) and cut into chunks of
    ``ck``; Cout zero-padded to whole BN blocks; per tile, an f32 accumulator
    that ``k_step(acc, a, b)`` advances in the kernel's k order, (chunk, tap,
    k step), with a the tile's (pixels, k) slice of the patch and b the (k,
    Cout) slice of the weight; then bias, activation and one rounding to x's
    dtype, stored for the pixels inside the image only."""
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    plan = tc_plan(n, h, wd, cin, cout, kh, kw, itemsize)
    ks = 16 if itemsize == 2 else 8
    cp = -(-cin // ks) * ks
    coutp = -(-cout // plan.bn) * plan.bn
    xf = torch.zeros(n, h, wd, cp)
    xf[..., :cin] = x.permute(0, 2, 3, 1).float()
    wk = torch.zeros(kh * kw, cp, coutp)
    wk[:, :cin, :cout] = pack_weight(w).float().reshape(kh * kw, cin, cout)
    bias = torch.zeros(coutp)
    if b is not None:
        bias[:cout] = b.float()
    y = torch.zeros(n, h, wd, coutp)
    chunks = range(0, cp, plan.ck)

    def accumulate(patch_at):
        acc = torch.zeros(patch_at(0, 0, 0).shape[0], coutp)
        for c0 in chunks:
            for tap in range(kh * kw):
                for k0 in range(c0, min(c0 + plan.ck, cp), ks):
                    acc = k_step(acc, patch_at(tap // kw, tap % kw, k0), wk[tap, k0:k0 + ks])
        out = acc + bias
        if act == "relu":
            out = torch.relu(out)
        elif act == "leaky_relu":
            out = torch.nn.functional.leaky_relu(out, 0.01)
        return out.to(x.dtype).float()

    if plan.flat:
        flat_x, flat_y = xf.reshape(-1, cp), y.view(-1, coutp)
        for m0 in range(0, flat_x.shape[0], plan.bm):
            rows = flat_x[m0:m0 + plan.bm]
            flat_y[m0:m0 + plan.bm] = accumulate(lambda r, q, k0: rows[:, k0:k0 + ks])
    else:
        ph, pw = kh // 2, kw // 2
        xp = torch.zeros(n + plan.ti, h + plan.th + kh, wd + plan.tw + kw, cp)
        xp[:n, ph:ph + h, pw:pw + wd] = xf
        for i0 in range(0, n, plan.ti):
            for oh in range(0, h, plan.th):
                for ow in range(0, wd, plan.tw):
                    patch = xp[i0:i0 + plan.ti, oh:oh + plan.th + kh - 1,
                               ow:ow + plan.tw + kw - 1]
                    out = accumulate(lambda r, q, k0: patch[
                        :, r:r + plan.th, q:q + plan.tw, k0:k0 + ks].reshape(-1, ks))
                    out = out.reshape(plan.ti, plan.th, plan.tw, coutp)
                    ni, nh, nw = min(plan.ti, n - i0), min(plan.th, h - oh), min(plan.tw, wd - ow)
                    y[i0:i0 + ni, oh:oh + nh, ow:ow + nw] = out[:ni, :nh, :nw]
    return y[..., :cout].permute(0, 3, 1, 2).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def _emulate_tc_conv(x, w, b=None, act=None):
    """What ``fused_conv2d_bias_act_tc_kernel`` (csrc/fused_conv2d_bias_act.cu)
    computes for bf16 inputs, in torch: :func:`_emulate_tiles` with each k16
    step's product of bf16 operands added to the f32 accumulator."""
    return _emulate_tiles(x, w, b, act, 2, lambda acc, a, bb: acc + a @ bb)


def _tf32_split(x):
    """``(hi, lo)``: x rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds, and x − hi rounded the
    same way; by bit operations on the float32 view (adding half a TF32 ulp
    to the magnitude bits and clearing the 13 low bits), as the kernel's
    ``rna_tf32`` does. (A copy of tests/test_torch_port_attention.py's.)"""
    def rna(v):
        bits = v.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x.float() - hi)


#: fused_conv2d_bias_act_f32tc_kernel's fragment loads (csrc): in an m16n8k8
#: tf32 mma, lane l (g = l / 4, c = l % 4) holds A register i at (row g +
#: 8 (i & 1), k c + 4 (i >> 1)) and B register i at (k c + 4 i, column g).
#: The kernel loads A register i from channel 2c + (i >> 1) of the pixel
#: under that row and B register i from weight row (channel) 2c + i: mma k
#: c <- channel 2c, k c + 4 <- channel 2c + 1, the same in both operands.
_LANE = torch.arange(32)
_G, _C = _LANE // 4, _LANE % 4
K8_CHANNEL = [0, 2, 4, 6, 1, 3, 5, 7]     # mma k -> channel of the k8 step


def _a_operand(a8):
    """The 16x8 A operand (rows, mma k) an mma sees when each lane loads its
    four registers from a (16 pixels, 8 channels) block as the kernel does."""
    out = torch.zeros(16, 8, dtype=a8.dtype)
    for i in range(4):
        out[_G + 8 * (i & 1), _C + 4 * (i >> 1)] = a8[_G + 8 * (i & 1), 2 * _C + (i >> 1)]
    return out


def _b_operand(b8):
    """The 8x8 B operand (mma k, columns) from an (8 channels, 8 columns)
    block of the weight, loaded as the kernel does."""
    out = torch.zeros(8, 8, dtype=b8.dtype)
    for i in range(2):
        out[_C + 4 * i, _G] = b8[2 * _C + i, _G]
    return out


def _emulate_f32tc_conv(x, w, b=None, act=None, products=3):
    """What ``fused_conv2d_bias_act_f32tc_kernel`` computes for f32 inputs, in
    torch: :func:`_emulate_tiles` of the f32 plan (Cin padded to 8, chunks of
    ``ck``), each k8 step's operands permuted as the fragment loads permute
    them (:data:`K8_CHANNEL`), split into TF32 hi and lo, the three products
    lo·hi + hi·lo + hi·hi summed from zero and the step's sum added to the
    f32 accumulator (``products=1``: hi·hi alone, one TF32 mma)."""
    def k_step(acc, a, bb):
        (ah, al), (bh, bl) = _tf32_split(a[:, K8_CHANNEL]), _tf32_split(bb[K8_CHANNEL])
        if products == 1:
            return acc + ah @ bh
        d = al @ bh
        d = d + ah @ bl
        d = d + ah @ bh
        return acc + d
    return _emulate_tiles(x, w, b, act, 4, k_step)


def _bf16_case(n, h, w, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(cout, cin, k, k))
                           / math.sqrt(cin * k * k)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(cout,))).astype(np.float32))
    return x.permute(0, 3, 1, 2).bfloat16(), wt.bfloat16(), b.bfloat16()


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


#: image_classifier's four conv shapes at batch 2 (Cin 3 and 4, Cout 4 and 16,
#: 5x5 and 3x3); 1x1 in one chunk and in two (Cin 80 > 64) with Cout across
#: two BN blocks; a 7x7 kernel; H and W that leave partial tiles (13x13,
#: 17x13), Cin 5 and 33 (the 2-byte loads), whole 6x6 images stacked in one
#: tile with Cout 129; the dense head (1x1, 32 -> 4: Cout below every tile
#: width) and U-Net's first conv (3 -> 32) and decoder convs on concatenated
#: inputs (96 -> 32, 768 -> 256 over twelve 64-channel chunks); the
#: single-grid detector's head (1x1, 32 -> 8), the detectors' and the
#: autoencoder's stem (3 -> 16), the autoencoder's last conv (16 -> 3) and
#: config 12's FPN c4 conv (64 -> 128 on 8x8)
TC_SHAPES = [(2, 32, 32, 3, 4, 5), (2, 32, 32, 4, 4, 5), (2, 16, 16, 4, 16, 3),
             (2, 16, 16, 16, 16, 3), (2, 9, 11, 16, 24, 1), (1, 12, 10, 80, 136, 1),
             (1, 12, 10, 8, 24, 7), (3, 13, 13, 5, 7, 5), (1, 17, 13, 33, 64, 5),
             (3, 6, 6, 65, 129, 7), (2, 8, 8, 32, 4, 1), (1, 16, 16, 3, 32, 3),
             (1, 16, 16, 96, 32, 3), (1, 4, 4, 768, 256, 3),
             (2, 8, 8, 32, 8, 1), (2, 16, 16, 3, 16, 3), (1, 16, 16, 16, 3, 3),
             (1, 8, 8, 64, 128, 3)]


@pytest.mark.parametrize("act,bias", [("relu", True), ("leaky_relu", False)])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_conv_arithmetic_matches_plain(shape, act, bias):
    x, wt, b = _bf16_case(*shape)
    b = b if bias else None
    got = _emulate_tc_conv(x, wt, b, act)
    ref = plain_conv2d_bias_act(x, wt, b, act)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= BF16_TOL


def test_tensor_core_conv_arithmetic_matches_pallas_interpret():
    x, wt, b = _bf16_case(2, 16, 16, 4, 16, 3, seed=3)
    jx = jnp.asarray(x.permute(0, 2, 3, 1).float().numpy(), dtype=jnp.bfloat16)
    jw = jnp.asarray(wt.permute(2, 3, 1, 0).float().numpy(), dtype=jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy(), dtype=jnp.bfloat16)
    y_jax = jax_fused(jx, jw, jb, jax.nn.relu, 2, True)
    assert y_jax.dtype == jnp.bfloat16
    got = _emulate_tc_conv(x, wt, b, "relu")
    assert _rel(got.permute(0, 2, 3, 1), torch.from_numpy(np.asarray(y_jax, np.float32))) \
        <= BF16_TOL


#: relative to max|ref|: the f32 kernel and the plain version both sum in
#: f32, in another order (chip_smoke.py's bound)
F32_TOL = 2e-5


def _f32_case(n, h, w, cin, cout, k, seed=0):
    """f32 inputs with all 24 mantissa bits (TF32's 10 do not hold them)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(cout, cin, k, k))
                           / math.sqrt(cin * k * k)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(cout,))).astype(np.float32))
    return x.permute(0, 3, 1, 2), wt, b


@pytest.mark.parametrize("act,bias", [("relu", True), ("leaky_relu", False)])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_f32_tensor_core_conv_arithmetic_matches_plain(shape, act, bias):
    x, wt, b = _f32_case(*shape)
    b = b if bias else None
    got = _emulate_f32tc_conv(x, wt, b, act)
    ref = plain_conv2d_bias_act(x, wt, b, act)
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= F32_TOL


def test_f32_tensor_core_conv_arithmetic_matches_pallas_interpret():
    x, wt, b = _f32_case(2, 9, 11, 24, 40, 3, seed=5)
    y_jax = jax_fused(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                      jnp.asarray(wt.permute(2, 3, 1, 0).numpy()), jnp.asarray(b.numpy()),
                      jax.nn.relu, 2, True)
    assert y_jax.dtype == jnp.float32
    got = _emulate_f32tc_conv(x, wt, b, "relu")
    assert _rel(got.permute(0, 2, 3, 1), torch.from_numpy(np.asarray(y_jax))) <= F32_TOL


def test_f32tc_conv_fragment_loads_give_the_products():
    """The kernel's fragment loads permute each k8 step's channels the same
    way in A and B: the mma of the loaded operands is the product itself
    (exactly, in float64), and :data:`K8_CHANNEL` is that permutation."""
    rng = np.random.default_rng(22)
    a8 = torch.from_numpy(rng.normal(size=(16, 8)))
    b8 = torch.from_numpy(rng.normal(size=(8, 8)))
    a_op, b_op = _a_operand(a8), _b_operand(b8)
    torch.testing.assert_close(a_op @ b_op, a8 @ b8, rtol=1e-12, atol=1e-12)
    assert torch.equal(a_op, a8[:, K8_CHANNEL]) and torch.equal(b_op, b8[K8_CHANNEL])
    # the unpermuted pairing (B register i from channel c + 4 i) is wrong
    wrong = torch.zeros(8, 8, dtype=b8.dtype)
    for i in range(2):
        wrong[_C + 4 * i, _G] = b8[_C + 4 * i, _G]
    assert not torch.allclose(a_op @ wrong, a8 @ b8)


def test_one_tf32_product_would_miss_the_f32_bound():
    """Why 3xTF32: one TF32 product per mma (hi·hi only) misses the 2e-5
    bound at a deep reduction (3x3 over 512 channels, K = 4,608); the three
    products hold it."""
    x, wt, b = _f32_case(1, 3, 3, 512, 8, 3, seed=6)
    ref = plain_conv2d_bias_act(x, wt, b)
    assert _rel(_emulate_f32tc_conv(x, wt, b, products=1), ref) > F32_TOL
    assert _rel(_emulate_f32tc_conv(x, wt, b), ref) <= F32_TOL


#: every stride-1 conv of a resnet_spec(50) forward at the serving batch
RESNET50_SHAPES = [
    (64, 56, 56, 64, 64, 1), (64, 56, 56, 64, 64, 3), (64, 56, 56, 64, 256, 1),
    (64, 56, 56, 256, 64, 1), (64, 56, 56, 256, 128, 1), (64, 28, 28, 128, 512, 1),
    (64, 28, 28, 512, 128, 1), (64, 28, 28, 128, 128, 3), (64, 28, 28, 512, 256, 1),
    (64, 14, 14, 256, 1024, 1), (64, 14, 14, 1024, 256, 1), (64, 14, 14, 256, 256, 3),
    (64, 14, 14, 1024, 512, 1), (64, 7, 7, 512, 2048, 1), (64, 7, 7, 2048, 512, 1),
    (64, 7, 7, 512, 512, 3)]


@pytest.mark.parametrize("shape", TC_SHAPES + RESNET50_SHAPES + [
    (32, 32, 32, 3, 4, 5), (32, 16, 16, 16, 16, 3), (1, 1, 1, 512, 2048, 1)])
def test_f32_tc_plan_fits_the_tile_to_cout_and_the_map(shape):
    """The f32 plan: BN from Cout up to 64, the bf16 plan's pixel tiling (no
    extra tiles), Cin padded to 8 in chunks that fit 227 KB, and at
    ResNet-50's shapes room for at least 2 blocks an SM (3, the most its
    registers allow at BN 64)."""
    n, h, w, cin, cout, k = shape
    plan = tc_plan(n, h, w, cin, cout, k, k, 4)
    assert plan.bn == min(b for b in F32_TC_BN if b >= min(cout, 64))
    assert plan.bm == TC_BM[plan.bn] and plan.ti * plan.th * plan.tw <= plan.bm
    assert plan.smem_bytes <= TC_SMEM_MAX
    assert plan.ck in (8, 16, 32, 64) and plan.ck <= -(-cin // 8) * 8
    assert 1 <= plan.tg <= k * k
    bf16 = tc_plan(n, h, w, cin, cout, k, k)
    if bf16.bm == plan.bm:
        assert (plan.flat, plan.ti, plan.th, plan.tw) == (bf16.flat, bf16.ti, bf16.th, bf16.tw)
    if shape in RESNET50_SHAPES:
        assert min(blocks_per_sm(plan.smem_bytes), F32_TC_BLOCKS[plan.bn]) >= 2
        assert blocks_per_sm(plan.smem_bytes) >= F32_TC_BLOCKS[plan.bn]


@pytest.mark.parametrize("shape", TC_SHAPES + [
    (64, 56, 56, 64, 64, 3), (64, 28, 28, 128, 128, 3), (64, 7, 7, 512, 512, 3),
    (64, 7, 7, 512, 2048, 1), (4096, 32, 32, 3, 4, 5), (1, 1, 1, 512, 2048, 1)])
def test_tc_plan_fits_the_tile_to_cout_and_the_map(shape):
    n, h, w, cin, cout, k = shape
    plan = tc_plan(n, h, w, cin, cout, k, k)
    assert plan.bn == min(b for b in TC_BN if b >= min(cout, 128))
    assert plan.flat == (k == 1)
    assert plan.bm == TC_BM[plan.bn] and plan.ti * plan.th * plan.tw <= plan.bm
    assert plan.smem_bytes <= TC_SMEM_MAX
    assert plan.ck in (16, 32, 64) and plan.ck <= -(-cin // 16) * 16 and 1 <= plan.tg <= k * k
    if not plan.flat:
        assert plan.th <= h and plan.tw <= w and plan.ti <= n
        if h * w <= plan.bm:
            assert (plan.th, plan.tw) == (h, w)     # whole images, stacked

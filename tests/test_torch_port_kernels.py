"""K2 in the port: the fused conv+bias+act wrapper's plain version against the
JAX package's Pallas kernel (interpret mode, as tests/test_pallas.py runs
it on the CPU), the bf16 tensor-core kernel's tiling and arithmetic emulated
in torch, the wrapper's checks and dispatch, and the CUDA source's
interface. The CUDA kernel itself runs only on a card
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
    TC_BM, TC_BN, TC_SMEM_MAX, fused_conv2d_bias_act, pack_weight,
    plain_conv2d_bias_act, tc_plan)

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


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_version_matches_pallas_interpret(k, act, bias):
    x, wt, b = _case(k)
    if not bias:
        b = np.zeros_like(b)   # the Pallas kernel always adds a bias
    y_jax = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                 jax.nn.relu if act else None, 2, True))
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
    # bf16 goes to the tensor-core kernel only; the CUDA-core kernel stays f32
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "launch<__nv_bfloat16>" not in src and "launch<float>" in src
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
# K2 on bf16: the tensor-core kernel's tiling and arithmetic, emulated
# --------------------------------------------------------------------------- #

def _emulate_tc_conv(x, w, b=None, act=None):
    """What ``fused_conv2d_bias_act_tc_kernel`` (csrc/fused_conv2d_bias_act.cu)
    computes for bf16 inputs, in torch: the tiles of :func:`tc_plan` (flat
    runs of BM pixels for 1x1, else TI images x TH x TW output pixels with a
    (TH+kh-1) x (TW+kw-1) input patch, zero outside the image); channels
    zero-padded to a multiple of 16 and cut into chunks of ``ck``; Cout
    zero-padded to whole BN blocks; per tile, an f32 accumulator summed in
    the kernel's k order, (chunk, tap, 16 channels), over bf16 operands; then
    bias, activation and one bf16 rounding, stored for the pixels inside the
    image only."""
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    plan = tc_plan(n, h, wd, cin, cout, kh, kw)
    cp = -(-cin // 16) * 16
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
                for k0 in range(c0, min(c0 + plan.ck, cp), 16):
                    acc += patch_at(tap // kw, tap % kw, k0) @ wk[tap, k0:k0 + 16]
        out = acc + bias
        if act == "relu":
            out = torch.relu(out)
        elif act == "leaky_relu":
            out = torch.nn.functional.leaky_relu(out, 0.01)
        return out.bfloat16().float()

    if plan.flat:
        flat_x, flat_y = xf.reshape(-1, cp), y.view(-1, coutp)
        for m0 in range(0, flat_x.shape[0], plan.bm):
            rows = flat_x[m0:m0 + plan.bm]
            flat_y[m0:m0 + plan.bm] = accumulate(lambda r, q, k0: rows[:, k0:k0 + 16])
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
                        :, r:r + plan.th, q:q + plan.tw, k0:k0 + 16].reshape(-1, 16))
                    out = out.reshape(plan.ti, plan.th, plan.tw, coutp)
                    ni, nh, nw = min(plan.ti, n - i0), min(plan.th, h - oh), min(plan.tw, wd - ow)
                    y[i0:i0 + ni, oh:oh + nh, ow:ow + nw] = out[:ni, :nh, :nw]
    return y[..., :cout].permute(0, 3, 1, 2).bfloat16().contiguous(
        memory_format=torch.channels_last)


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
#: tile with Cout 129
TC_SHAPES = [(2, 32, 32, 3, 4, 5), (2, 32, 32, 4, 4, 5), (2, 16, 16, 4, 16, 3),
             (2, 16, 16, 16, 16, 3), (2, 9, 11, 16, 24, 1), (1, 12, 10, 80, 136, 1),
             (1, 12, 10, 8, 24, 7), (3, 13, 13, 5, 7, 5), (1, 17, 13, 33, 64, 5),
             (3, 6, 6, 65, 129, 7)]


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

"""K2 in the port: the fused conv+bias+act wrapper's plain version against the
JAX package's Pallas kernel (interpret mode, as tests/test_pallas.py runs
it on the CPU), the wrapper's checks and dispatch, and the CUDA source's
interface. The CUDA kernel itself runs only on a card
(tests/test_torch_port_gpu.py)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.ops.pallas.fused_layer import fused_conv2d_bias_act as jax_fused
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.ops.kernels.fused_layer import (
    fused_conv2d_bias_act, pack_weight, plain_conv2d_bias_act)

TOL = 1e-5  # the repo's bound for the Pallas kernel (tests/test_pallas.py)


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

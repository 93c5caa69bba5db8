"""GPU tests of the port's CUDA kernel and of the model on the card.

They need a CUDA card and skip without one. This file imports no JAX, so on
a machine without it run it apart from the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepcv_tpu_torch.ops.kernels.fused_layer import (
    fused_conv2d_bias_act, plain_conv2d_bias_act)

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4   # relative to max|ref|: f32 accumulation, another sum order
BF16_TOL = 2e-2  # bf16 output rounding


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, h, w, cin, cout, k, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, cin, h, w), generator=g, device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((cout, cin, k, k), generator=g, device=dev) / (cin * k * k) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((cout,), generator=g, device=dev)).to(dtype)
    return x, wt, b


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shape", [(2, 9, 11, 3, 5, 1), (2, 9, 11, 16, 70, 3),
                                   (1, 17, 13, 33, 64, 5), (3, 6, 6, 65, 129, 7),
                                   (1, 1, 1, 512, 2048, 1)])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu", torch.sigmoid])
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_matches_plain(cuda, dtype, tol, shape, act, bias):
    x, wt, b = _inputs(cuda, *shape, dtype)
    b = b if bias else None
    before = fused_conv2d_bias_act.launches
    got = fused_conv2d_bias_act(x, wt, b, act)
    ref = plain_conv2d_bias_act(x, wt, b, act)
    torch.cuda.synchronize()
    assert fused_conv2d_bias_act.launches == before + 1
    assert got.dtype == dtype and got.shape == ref.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, ref) <= tol


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, wt, b = _inputs(cuda, 2, 8, 8, 8, 16, 3, torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        fused_conv2d_bias_act(x.contiguous(), wt, b, "relu")
    with pytest.raises(TypeError):
        fused_conv2d_bias_act(x, wt.half(), b, "relu")
    with pytest.raises(ValueError, match="odd"):
        fused_conv2d_bias_act(x, wt[:, :, :2, :2], b, None)
    with pytest.raises(ValueError, match="devices|tensors on"):
        fused_conv2d_bias_act(x, wt.cpu(), b, None)


def test_kernel_backward_matches_plain(cuda):
    x, wt, b = _inputs(cuda, 2, 8, 8, 8, 16, 3, torch.float32)
    grads = []
    for fn in (fused_conv2d_bias_act, plain_conv2d_bias_act):
        xi, wi, bi = (t.detach().clone().requires_grad_() for t in (x, wt, b))
        (fn(xi, wi, bi, "relu") ** 2).sum().backward()
        grads.append([t.grad for t in (xi, wi, bi)])
    for gk, gp in zip(*grads):
        assert _rel(gk, gp) <= 1e-4


def test_narrow_resnet50_on_card_matches_cpu(cuda):
    from deepcv_tpu_torch.serve import Predictor
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import resnet_spec

    hp = resnet_spec(50, width=8, num_classes=10, pool_kernel=2)
    cpu = DeepcvModule((64, 64, 3), hp, device="cpu").eval()
    gpu = DeepcvModule((64, 64, 3), hp).eval()              # default device: cuda
    assert gpu.device.type == "cuda"
    x = np.random.default_rng(0).integers(0, 256, (5, 64, 64, 3)).astype(np.uint8)
    pre = lambda t: t.float() / 255.0  # noqa: E731
    ref = Predictor(cpu, batch_size=4, preprocess=pre, device="cpu")(x)
    pred = Predictor(gpu, batch_size=4, preprocess=pre)
    before = fused_conv2d_bias_act.launches
    got = pred(x)
    assert fused_conv2d_bias_act.launches - before == 46 * pred.forwards == 46 * 2
    assert got.shape == ref.shape == (5, 10)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())

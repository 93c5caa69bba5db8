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


# --------------------------------------------------------------------------- #
# K3, K4, K5: flash attention
# --------------------------------------------------------------------------- #

FLASH_F32_TOL = 2e-5  # relative to max|ref|: both accumulate in f32, another order
FLASH_BF16_TOL = 1e-2  # both round one f32 result to bf16: within a bf16 ulp


def _flash_err(got, ref):
    """Error relative to max|ref|; absolute where the reference is zero up to
    rounding (dQ and dK at T = 1, where the softmax has one entry)."""
    diff = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return diff / top if top > 1e-6 else diff


def _flash_inputs(dev, n, h, t, dh, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((n, h, t, dh), generator=g, device=dev).to(dtype)
                   for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FLASH_F32_TOL),
                                       (torch.bfloat16, FLASH_BF16_TOL)])
@pytest.mark.parametrize("shape", [(2, 3, 1, 64), (2, 3, 17, 64), (4, 12, 197, 64),
                                   (1, 2, 1024, 64), (2, 2, 77, 16), (2, 2, 130, 32),
                                   (1, 2, 200, 128)])
def test_flash_kernels_match_plain(cuda, dtype, tol, shape):
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
        plain_flash_bwd_dkv, plain_flash_bwd_dq, plain_flash_fwd)

    q, k, v, do = _flash_inputs(cuda, *shape, dtype)
    counts = [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse_ref, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta)
    refs = (o_ref, plain_flash_bwd_dq(q, k, v, do, lse_ref, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse_ref, delta))
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkv)] == [c + 1 for c in counts]
    assert lse.dtype == torch.float32 and lse.shape == shape[:3]
    assert _flash_err(lse, lse_ref) <= FLASH_F32_TOL
    for got, ref in zip((o, dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        assert _flash_err(got, ref) <= tol


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    from deepcv_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd

    q, k, v, _ = _flash_inputs(cuda, 1, 2, 9, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="tensors on"):
        flash_attention_fwd(q, k.cpu(), v)


def test_flash_attention_autograd_on_card_matches_cpu(cuda):
    from deepcv_tpu_torch.ops.attention import flash_attention

    q, k, v, do = _flash_inputs(cuda, 2, 4, 197, 64, torch.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        qi, ki, vi = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        o = flash_attention(qi, ki, vi)
        o.backward(do.to(dev))
        grads.append([o.detach().cpu()] + [t.grad.cpu() for t in (qi, ki, vi)])
    for g_card, g_cpu in zip(*grads):
        assert _rel(g_card, g_cpu) <= 1e-4


def test_vit_on_card_matches_cpu(cuda):
    from deepcv_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
    from deepcv_tpu_torch.serve import Predictor
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import vit_spec

    hp = vit_spec("b_16", num_classes=10, attn_impl="flash")
    hp["architecture"] = hp["architecture"][:3] + hp["architecture"][-3:]
    cpu = DeepcvModule((64, 64, 3), hp, device="cpu").eval()
    gpu = DeepcvModule((64, 64, 3), hp).eval()
    x = np.random.default_rng(0).integers(0, 256, (5, 64, 64, 3)).astype(np.uint8)
    pre = lambda t: t.float() / 255.0  # noqa: E731
    ref = Predictor(cpu, batch_size=4, preprocess=pre, device="cpu")(x)
    pred = Predictor(gpu, batch_size=4, preprocess=pre)
    before = flash_attention_fwd.launches
    got = pred(x)
    assert flash_attention_fwd.launches - before == 2 * pred.forwards == 4
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())

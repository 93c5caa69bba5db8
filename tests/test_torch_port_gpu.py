"""GPU tests of the port's CUDA kernel and of the model on the card, and of
the training runtime there (each optimizer's step against the CPU's, the
pinned prefetch, K2's launches under remat, the streaming path's losses).

They need a CUDA card and skip without one. This file imports no JAX, so on
a machine without it run it apart from the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepcv_tpu_torch.ops.kernels.flash_attention import HEAD_DIMS
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


#: (N, H, W, Cin, Cout, k): ragged channel counts and kernels, then
#: image_classifier's four convs at batch 8 (Cin 3 and 4 with Cout 4 at 5x5,
#: 4 -> 16 and 16 -> 16 at 3x3), ResNet-50's 7x7 map, and a map that leaves a
#: partial bf16 tile on both axes (37x23 in 10x12 tiles); then each width of
#: the f32 loads (Cin 5 and Cout 7: 4-byte, Cin 6: 8-byte, Cin 8: 16-byte
#: with Cout 5: 4-byte)
K2_SHAPES = [(2, 9, 11, 3, 5, 1), (2, 9, 11, 16, 70, 3), (1, 17, 13, 33, 64, 5),
             (3, 6, 6, 65, 129, 7), (1, 1, 1, 512, 2048, 1),
             (8, 32, 32, 3, 4, 5), (8, 32, 32, 4, 4, 5), (8, 16, 16, 4, 16, 3),
             (8, 16, 16, 16, 16, 3), (4, 7, 7, 512, 512, 3), (2, 37, 23, 8, 32, 3),
             (2, 9, 11, 5, 7, 3), (2, 9, 11, 6, 5, 3), (2, 9, 11, 8, 5, 5)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("shape", K2_SHAPES)
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


#: K2's f32 route against its plain version at the f32 bound (relative to
#: max|ref|, chip_smoke.py's): each load width of x and the weight (Cin 3,
#: 5, 6, 8; Cout 5, 7), a 1x1, and reductions of K = 4,608 (3x3 over 512
#: channels) in one and in several Cout blocks
K2_F32_TOL = 2e-5
K2_F32_SHAPES = [(2, 9, 11, 3, 5, 3), (2, 9, 11, 5, 7, 3), (2, 9, 11, 6, 5, 3),
                 (2, 9, 11, 6, 7, 1), (2, 9, 11, 8, 7, 5), (1, 7, 7, 512, 64, 3),
                 (4, 7, 7, 512, 512, 3), (2, 14, 14, 512, 96, 3)]


@pytest.mark.parametrize("shape", K2_F32_SHAPES)
@pytest.mark.parametrize("act", [None, "relu"])
def test_k2_f32_holds_the_f32_bound(cuda, shape, act):
    x, wt, b = _inputs(cuda, *shape, torch.float32)
    got = fused_conv2d_bias_act(x, wt, b, act)
    ref = plain_conv2d_bias_act(x, wt, b, act)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= K2_F32_TOL


def test_k2_f32_ignores_allow_tf32(cuda):
    """3xTF32 is the kernel's own arithmetic: with both TF32 switches on
    (cuDNN's and cuBLAS's), the kernel gives the same bits as with them off
    and stays within the f32 bound of a float64 reference, at K = 4,608."""
    x, wt, b = _inputs(cuda, 2, 7, 7, 512, 64, 3, torch.float32, seed=4)
    ref = torch.relu(F.conv2d(x.double(), wt.double(), b.double(), padding=1))
    y_off = fused_conv2d_bias_act(x, wt, b, "relu")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_on = fused_conv2d_bias_act(x, wt, b, "relu")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert torch.equal(y_on, y_off)
    assert _rel(y_on, ref) <= K2_F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_counts_launches_by_dtype(cuda, dtype):
    """Each dtype launches its tensor-core kernel (float32 by 3xTF32); each
    launch adds one to ``launches`` and to its dtype's count."""
    x, wt, b = _inputs(cuda, 8, 32, 32, 4, 4, 5, dtype)
    name = str(dtype).removeprefix("torch.")
    total, by_dtype = fused_conv2d_bias_act.launches, dict(fused_conv2d_bias_act.launches_by_dtype)
    for _ in range(3):
        y = fused_conv2d_bias_act(x, wt, b, "relu")
    torch.cuda.synchronize()
    assert fused_conv2d_bias_act.launches == total + 3
    assert fused_conv2d_bias_act.launches_by_dtype == {**by_dtype, name: by_dtype[name] + 3}
    assert _rel(y, plain_conv2d_bias_act(x, wt, b, "relu")) <= (
        BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


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


def _flash_err(got, ref, zero=1e-6):
    """Error relative to max|ref|; absolute where the reference is zero up to
    rounding, max|ref| <= ``zero`` (dQ and dK at T = 1, where the softmax has
    one entry)."""
    diff = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return diff / top if top > zero else diff


def _flash_inputs(dev, n, h, t, dh, dtype, seed=0, permuted=False):
    """q, k, v, dO (N, H, T, Dh); ``permuted``: as non-contiguous views of
    (N, T, H, Dh) tensors, as a packed qkv projection gives them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, t, h, dh) if permuted else (n, h, t, dh)
    xs = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    return tuple(x.permute(0, 2, 1, 3) if permuted else x for x in xs)


#: both dtypes; (2, 16, 197, 80) is ViT-H/14's attention (16 heads of 80)
FLASH_SHAPES = [(2, 3, 1, 64), (2, 3, 17, 64), (4, 12, 197, 64), (1, 2, 1024, 64),
                (2, 2, 77, 16), (2, 2, 130, 32), (1, 2, 200, 128), (2, 16, 197, 80)]
#: bf16 (K3, K4 and K5 on the tensor cores): T around the 16-row warp tiles,
#: the 64-row blocks and 64-row tiles, and their n8 fragments, at every head dim
FLASH_BF16_SHAPES = [(1, 2, t, dh) for dh in HEAD_DIMS
                     for t in (1, 5, 16, 63, 64, 65, 128, 197, 1000)]
#: f32 (K3, K4 and K5 on the tensor cores by 3xTF32): T around the 16-row
#: warp tiles, the 32-row tiles, the 64-row blocks (63, 64, 65) and the n8
#: fragments, at every head dim
FLASH_F32_SHAPES = [(1, 2, t, dh) for dh in HEAD_DIMS
                    for t in (1, 5, 16, 31, 32, 33, 63, 64, 65, 197)]
FLASH_CASES = ([(torch.float32, FLASH_F32_TOL, s, False)
                for s in FLASH_SHAPES + FLASH_F32_SHAPES]
               + [(torch.bfloat16, FLASH_BF16_TOL, s, False)
                  for s in FLASH_SHAPES + FLASH_BF16_SHAPES]
               + [(torch.bfloat16, FLASH_BF16_TOL, (2, 12, 197, 64), True)])


@pytest.mark.parametrize("dtype,tol,shape,permuted", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, tol, shape, permuted):
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
        plain_flash_bwd_dkv, plain_flash_bwd_dq, plain_flash_fwd)

    q, k, v, do = _flash_inputs(cuda, *shape, dtype, permuted=permuted)
    assert q.is_contiguous() != permuted
    wrappers = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    counts = [f.launches for f in wrappers]
    by_dtype = [dict(f.launches_by_dtype) for f in wrappers]
    name = str(dtype).removeprefix("torch.")
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse_ref, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta)
    refs = (o_ref, plain_flash_bwd_dq(q, k, v, do, lse_ref, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse_ref, delta))
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [c + 1 for c in counts]
    assert [f.launches_by_dtype for f in wrappers] == [{**d, name: d[name] + 1}
                                                       for d in by_dtype]
    assert lse.dtype == torch.float32 and lse.shape == shape[:3]
    assert torch.isfinite(lse).all()
    assert _flash_err(lse, lse_ref) <= FLASH_F32_TOL
    for got, ref in zip((o, dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        assert _flash_err(got, ref) <= tol


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 65, 129])
def test_flash_fwd_bf16_padded_key_tiles_give_no_nan(cuda, t, dh):
    """The last (at T = 1 the only) 64-key tile holds one key and 63 of
    padding: 7 of its 8 n8 fragments skipped, 7 keys masked in the eighth.
    Scaled scores have a standard deviation of 64 (|s| up to a few hundred),
    whose exp overflows f32 unless the running max is subtracted."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, plain_flash_fwd)

    q, k, v, _ = _flash_inputs(cuda, 2, 3, t, dh, torch.float32, seed=1)
    q, k = (x * 8.0 for x in (q, k))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    o, lse = flash_attention_fwd(q, k, v)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert _flash_err(o, o_ref) <= FLASH_BF16_TOL
    assert _flash_err(lse, lse_ref) <= FLASH_F32_TOL


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 33, 65, 129])
def test_flash_fwd_f32_padded_key_tiles_give_no_nan(cuda, t, dh):
    """K3 on f32 (3xTF32) where the last (at T = 1 the only) 32-key tile
    holds one key: 3 of its 4 n8 fragments skipped, 7 keys masked in the
    first. Scaled scores with a standard deviation of 64 overflow exp in f32
    unless the running max is subtracted. They also amplify the rounding of
    the scores past the f32 bound: the f32 plain version itself is up to
    ~3e-5 from the exact result here, and the kernel (3xTF32 products
    summed inside the tensor cores) up to 1.5 times that (2.9e-5 against
    2.0e-5 at T 129, Dh 128 on an H100). So both are held against a float64
    reference: the kernel to the f32 bound or to twice the plain version's
    own error, whichever is larger."""
    import math

    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, plain_flash_fwd)

    q, k, v, _ = _flash_inputs(cuda, 2, 3, t, dh, torch.float32, seed=1)
    q, k = (x * 8.0 for x in (q, k))
    o, lse = flash_attention_fwd(q, k, v)
    o_plain, lse_plain = plain_flash_fwd(q, k, v)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(dh)
    lse_ref = torch.logsumexp(s, dim=-1)
    o_ref = torch.matmul(torch.exp(s - lse_ref.unsqueeze(-1)), v.double())
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _flash_err(o, o_ref) <= max(FLASH_F32_TOL, 2 * _flash_err(o_plain, o_ref))
    assert _flash_err(lse, lse_ref) <= max(FLASH_F32_TOL, 2 * _flash_err(lse_plain, lse_ref))


def test_flash_fwd_f32_ignores_allow_tf32(cuda):
    """3xTF32 is the kernel's own arithmetic: with cuBLAS's TF32 switch on,
    the kernel still holds the f32 bound against the plain version computed
    with it off, and gives the same bits as with it off."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, plain_flash_fwd)

    q, k, v, _ = _flash_inputs(cuda, 2, 12, 197, 64, torch.float32, seed=3)
    o_ref, lse_ref = plain_flash_fwd(q, k, v)
    o_off, lse_off = flash_attention_fwd(q, k, v)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        o_on, lse_on = flash_attention_fwd(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert torch.equal(o_on, o_off) and torch.equal(lse_on, lse_off)
    assert _flash_err(o_on, o_ref) <= FLASH_F32_TOL
    assert _flash_err(lse_on, lse_ref) <= FLASH_F32_TOL


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 65, 129])
def test_flash_bwd_bf16_padded_tiles_give_no_nan(cuda, t, dh):
    """K4 and K5 on the tensor cores where the last (at T = 1 the only)
    64-row tile holds one live row: the keys (K4) and q rows (K5) past T are
    zero padding whose P must be 0. Scaled scores with a standard deviation
    of 64 put exp(s - lse) far outside f32 for the padding unless it is
    masked; lse comes from the plain forward. At T = 1, dQ and dK are zero
    up to the rounding of dP − δ, which k and q, 8 times larger here, carry
    into the plain version's output at up to ~1e-5; the gradients of the
    other cases are of order 1, so 1e-4 tells the two apart."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, plain_flash_bwd_dkv,
        plain_flash_bwd_dq, plain_flash_fwd)

    q, k, v, do = _flash_inputs(cuda, 2, 3, t, dh, torch.float32, seed=2)
    q, k = (x * 8.0 for x in (q, k))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    o_ref, lse = plain_flash_fwd(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = (flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    refs = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    for g, ref in zip(got, refs):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        assert _flash_err(g, ref, zero=1e-4) <= FLASH_BF16_TOL


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 33, 65, 129])
def test_flash_bwd_f32_padded_tiles_give_no_nan(cuda, t, dh):
    """K4 and K5 on f32 (3xTF32) where the last (at T = 1 the only) 32-row
    tile holds one live row: the keys (K4) and q rows (K5) past T are zero
    padding whose P must be 0, and scaled scores with a standard deviation
    of 64 put exp(s - lse) far outside f32 for the padding unless it is
    masked. As in the f32 forward's test, the large scores amplify the
    rounding of both versions, so both are held against a float64
    reference from the same lse and delta: the kernels to the f32 bound or
    to twice the plain version's own error, whichever is larger. At T = 1,
    dQ and dK are zero up to rounding (errors absolute below 1e-4)."""
    import math

    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, plain_flash_bwd_dkv,
        plain_flash_bwd_dq, plain_flash_fwd)

    q, k, v, do = _flash_inputs(cuda, 2, 3, t, dh, torch.float32, seed=2)
    q, k = (x * 8.0 for x in (q, k))
    o, lse = plain_flash_fwd(q, k, v)
    delta = (do * o).sum(-1)
    got = (flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    plain = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
             *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    p = torch.exp(torch.matmul(q64, k64.transpose(-1, -2)) / math.sqrt(dh)
                  - lse.double().unsqueeze(-1))
    ds = p * (torch.matmul(do64, v64.transpose(-1, -2)) - delta.double().unsqueeze(-1))
    refs = (torch.matmul(ds, k64) / math.sqrt(dh),
            torch.matmul(ds.transpose(-1, -2), q64) / math.sqrt(dh),
            torch.matmul(p.transpose(-1, -2), do64))
    torch.cuda.synchronize()
    for g, pl, ref in zip(got, plain, refs):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert _flash_err(g, ref, zero=1e-4) <= max(FLASH_F32_TOL,
                                                    2 * _flash_err(pl, ref, zero=1e-4))


def test_flash_bwd_f32_ignores_allow_tf32(cuda):
    """3xTF32 is K4's and K5's own arithmetic too: with cuBLAS's TF32 switch
    on, both give the same bits as with it off and hold the f32 bound
    against the plain versions computed with it off."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, plain_flash_bwd_dkv,
        plain_flash_bwd_dq, plain_flash_fwd)

    q, k, v, do = _flash_inputs(cuda, 2, 12, 197, 64, torch.float32, seed=4)
    o, lse = plain_flash_fwd(q, k, v)
    delta = (do * o).sum(-1)
    refs = (plain_flash_bwd_dq(q, k, v, do, lse, delta),
            *plain_flash_bwd_dkv(q, k, v, do, lse, delta))
    off = (flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = (flash_attention_bwd_dq(q, k, v, do, lse, delta),
              *flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    for g_on, g_off, ref in zip(on, off, refs):
        assert torch.equal(g_on, g_off)
        assert _flash_err(g_on, ref) <= FLASH_F32_TOL


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


def test_flash_attention_bf16_autograd_on_card_matches_cpu(cuda):
    """K3, then K4 and K5 from its o and lse, all on the tensor cores, against
    the plain versions on the CPU. The card's o may differ from the CPU's by one
    bf16 ulp, which reaches the gradients through delta = rowsum(dO o)."""
    from deepcv_tpu_torch.ops.attention import flash_attention
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)

    wrappers = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    q, k, v, do = _flash_inputs(cuda, 2, 12, 197, 64, torch.bfloat16)
    before = [w.launches_by_dtype["bfloat16"] for w in wrappers]
    grads = []
    for dev in ("cuda", "cpu"):
        qi, ki, vi = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        o = flash_attention(qi, ki, vi)
        o.backward(do.to(dev))
        grads.append([o.detach().cpu()] + [t.grad.cpu() for t in (qi, ki, vi)])
    assert [w.launches_by_dtype["bfloat16"] for w in wrappers] == [b + 1 for b in before]
    for g_card, g_cpu in zip(*grads):
        assert g_card.dtype == torch.bfloat16 and torch.isfinite(g_card.float()).all()
        assert _flash_err(g_card, g_cpu) <= FLASH_BF16_TOL


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


def test_vit_train_step_f32_on_card_matches_cpu(cuda):
    """One SGD step of a two-block ViT-B/16 (flash) in float32 on the card and
    on the CPU from the same weights: the loss within 1e-4 and every
    gradient within the port's first-step bound (rtol 1e-3 of the largest
    entry, tests/test_torch_parity.py). On the card the step launches K3,
    K4 and K5 twice each (once per block), all on float32 inputs, so all on
    the 3xTF32 kernels."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import vit_spec
    from deepcv_tpu_torch.train.losses import WeightedLosses, cross_entropy_loss
    from deepcv_tpu_torch.train.training import TrainState, build_optimizer, train_step

    hp = vit_spec("b_16", num_classes=10, attn_impl="flash")
    hp["architecture"] = hp["architecture"][:3] + hp["architecture"][-3:]
    cpu = DeepcvModule((64, 64, 3), hp, device="cpu")
    gpu = DeepcvModule((64, 64, 3), hp)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((4, 64, 64, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(4,)))
    wrappers = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [dict(w.launches_by_dtype) for w in wrappers]
    results = []
    for model in (gpu, cpu):
        dev = next(model.parameters()).device
        state = TrainState(model, build_optimizer("sgd", {"lr": 0.1, "momentum": 0.9},
                                                  model.parameters()),
                           0, torch.Generator(device=dev).manual_seed(0))
        model.train()
        out = train_step(state, WeightedLosses(cross_entropy_loss), {}, x.to(dev), y.to(dev),
                         dtype=torch.float32)
        results.append((out["main_loss"].item(),
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
    torch.cuda.synchronize()
    assert [{k: w.launches_by_dtype[k] - b[k] for k in b} for w, b in zip(wrappers, before)] \
        == [{"float32": 2, "bfloat16": 0}] * 3
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    assert set(g_gpu) == set(g_cpu)
    for name, ref in g_cpu.items():
        np.testing.assert_allclose(g_gpu[name].numpy(), ref.numpy(), rtol=1e-3,
                                   atol=1e-3 * ref.abs().max().item(), err_msg=name)


def test_vit_h14_on_card_matches_cpu(cuda):
    """F3: ViT-H/14's head dim 80 (1280 / 16) runs on the card. Two blocks
    at 112x112 (T = 65: two 64-row blocks, three 32-key tiles)."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
    from deepcv_tpu_torch.serve import Predictor
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import vit_spec

    hp = vit_spec("h_14", num_classes=10, attn_impl="flash")
    hp["architecture"] = hp["architecture"][:3] + hp["architecture"][-3:]
    cpu = DeepcvModule((112, 112, 3), hp, device="cpu").eval()
    gpu = DeepcvModule((112, 112, 3), hp).eval()
    x = np.random.default_rng(0).integers(0, 256, (5, 112, 112, 3)).astype(np.uint8)
    pre = lambda t: t.float() / 255.0  # noqa: E731
    ref = Predictor(cpu, batch_size=4, preprocess=pre, device="cpu")(x)
    pred = Predictor(gpu, batch_size=4, preprocess=pre)
    before = dict(flash_attention_fwd.launches_by_dtype)
    got = pred(x)
    assert flash_attention_fwd.launches_by_dtype["float32"] - before["float32"] \
        == 2 * pred.forwards == 4
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


# --------------------------------------------------------------------------- #
# K1: fused augment + normalize; F1 on the card
# --------------------------------------------------------------------------- #

AUG_TOL = 1e-5  # absolute, noise off: the same integer grey level and quotients
MEAN, STD = (0.491, 0.482, 0.447), (0.247, 0.243, 0.261)


def _aug_inputs(dev, n, h, w, seed=0):
    from deepcv_tpu_torch.data import transforms  # noqa: F401  (registers names)
    g = torch.Generator(device=dev).manual_seed(seed)
    u8 = torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
    facs = [0.6 + 0.8 * torch.rand((n,), generator=g, device=dev) for _ in range(3)]
    facs.append(torch.exp(0.2 * torch.randn((n,), generator=g, device=dev)))
    return u8, facs


#: (N, H, W): 1x1, a ragged size, 32x32 (the warp plan, with a partial
#: block of 8 images at N = 9), 31x33 and 25x41 (1,023 and 1,025 pixels, each
#: side of the plans' threshold, images off 16 bytes), 224x224 (the block
#: plan) and the augment_train batch
K1_SHAPES = [(1, 1, 1), (3, 5, 7), (16, 32, 32), (9, 32, 32), (8, 31, 33), (8, 25, 41),
             (2, 224, 224), (4096, 32, 32)]


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_matches_plain(cuda, shape):
    from deepcv_tpu_torch.ops.kernels.fused_augment import (
        fused_augment_normalize, plain_fused_augment_normalize)

    u8, facs = _aug_inputs(cuda, *shape)
    before = fused_augment_normalize.launches
    got = fused_augment_normalize(u8, *facs, None, MEAN, STD)
    ref = plain_fused_augment_normalize(u8, *facs, None, MEAN, STD)
    torch.cuda.synchronize()
    assert fused_augment_normalize.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= AUG_TOL
    half = fused_augment_normalize(u8, *facs, None, MEAN, STD, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    # one bf16 rounding of values within AUG_TOL of each other: the float32
    # result rounded once
    assert (half.float() - ref).abs().max().item() <= 2 ** -8 * ref.abs().max().item() + AUG_TOL
    assert torch.equal(half, got.to(torch.bfloat16))


def test_k1_neutral_factors_are_pure_preprocess_on_card(cuda):
    from deepcv_tpu_torch.data.transforms import normalize, to_tensor
    from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize

    u8, _ = _aug_inputs(cuda, 8, 17, 19)
    ones = [torch.ones(8, device=cuda)] * 4
    got = fused_augment_normalize(u8, *ones, None, MEAN, STD)
    assert (got - normalize(to_tensor(u8), MEAN, STD)).abs().max().item() <= AUG_TOL


@pytest.mark.parametrize("n,hw", [(512, 32), (16, 224)])  # the warp plan, the block plan
def test_k1_noise_statistics_and_seeding(cuda, n, hw):
    from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize

    grey = torch.full((n, hw, hw, 3), 128, dtype=torch.uint8, device=cuda)
    ones = [torch.ones(n, device=cuda)] * 4
    sigma = torch.full((n,), 0.1, device=cuda)
    sigma[n // 2:] = 0.0
    zero, one = (0.0,) * 3, (1.0,) * 3
    clean = fused_augment_normalize(grey, *ones, None, zero, one)
    a = fused_augment_normalize(grey, *ones, sigma, zero, one, seed=3)
    b = fused_augment_normalize(grey, *ones, sigma, zero, one,
                                seed=torch.tensor([3], device=cuda))
    c = fused_augment_normalize(grey, *ones, sigma, zero, one, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[n // 2:], clean[n // 2:])
    d = (a - clean)[: n // 2].double()
    # 786,432 (1,204,224) draws: the mean's std is 1.1e-4 (9e-5), the std's
    # relative error 8e-4 (6e-4)
    assert abs(d.mean().item()) < 6e-4 and abs(d.std().item() / 0.1 - 1) < 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_noise_is_keyed_by_element_not_by_plan(cuda, dtype):
    """Element e of image i draws word e % 4 of Philox call (e // 4, 0, i, 0)
    under either plan: the first 3,072 elements of a 32x32 image (the warp
    plan) and of a 25x41 one (1,025 pixels, the block plan) get the same
    noise from the same seed."""
    from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize

    n, zero, one = 8, (0.0,) * 3, (1.0,) * 3
    ones = [torch.ones(n, device=cuda)] * 4
    sigma = torch.full((n,), 0.1, device=cuda)
    noise = {}
    for h, w in ((32, 32), (25, 41)):
        grey = torch.full((n, h, w, 3), 128, dtype=torch.uint8, device=cuda)
        clean = fused_augment_normalize(grey, *ones, None, zero, one, out_dtype=dtype)
        noisy = fused_augment_normalize(grey, *ones, sigma, zero, one, seed=5, out_dtype=dtype)
        noise[h] = (noisy.float() - clean.float()).reshape(n, -1)[:, :32 * 32 * 3]
    assert noise[32].abs().max().item() > 0.2
    assert torch.equal(noise[32], noise[25])


def test_k1_refuses_what_it_does_not_take_on_card(cuda):
    from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize

    u8, facs = _aug_inputs(cuda, 2, 4, 4)
    with pytest.raises(ValueError, match="3-channel"):
        fused_augment_normalize(u8[..., :1].contiguous(), *facs, None, MEAN[:1], STD[:1])
    with pytest.raises(ValueError, match="images on"):
        fused_augment_normalize(u8, facs[0].cpu(), *facs[1:], None, MEAN, STD)


def test_k1_route_on_card_launches_once_per_batch(cuda):
    from deepcv_tpu_torch.data.augmentation import apply_augmentation_recipe
    from deepcv_tpu_torch.data.preprocess import (
        PreprocessedDataset, parse_transforms_specification)
    from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize

    recipe = apply_augmentation_recipe({"transforms": [
        {"brightness": 0.2}, {"contrast": 0.1}, {"tweak_colors": 0.1}, {"gamma": 0.05},
        {"noise": 0.1}]})
    ds = PreprocessedDataset(None, parse_transforms_specification(
        ["to_tensor", {"normalize": {"mean": list(MEAN), "std": list(STD)}}]), recipe)
    u8, _ = _aug_inputs(cuda, 64, 32, 32)
    before = fused_augment_normalize.launches
    routes = dict(PreprocessedDataset.batch_transform.routes)
    for step in range(3):
        y = ds.batch_transform(u8, torch.Generator(device=cuda).manual_seed(step))
    torch.cuda.synchronize()
    assert fused_augment_normalize.launches == before + 3
    assert PreprocessedDataset.batch_transform.routes["K1"] == routes["K1"] + 3
    assert y.shape == u8.shape and torch.isfinite(y).all()


def test_f1_bf16_backbone_launches_k2_in_bf16(cuda, monkeypatch):
    from deepcv_tpu_torch.ops import nn as port_nn
    from deepcv_tpu_torch.spec import DeepcvModule

    hp = {"act_fn": "relu", "group_norm": {"num_groups": 4, "eps": 1e-5}, "architecture": [
        {"conv2d": {"kernel_size": [5, 5], "out_channels": 4, "padding": 2}},
        {"avg_pooling": ["pool1", {"kernel_size": [2, 2], "stride": [2, 2]}]},
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 16, "padding": 1}},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"dense_link": {"_from": "pool1", "allow_scaling": True}}]}
    seen = []
    real = port_nn.fused_conv2d_bias_act

    def spy(x, w, b=None, act=None, *, w_packed=None):
        seen.append((x.dtype, w.dtype, b.dtype))
        return real(x, w, b, act, w_packed=w_packed)
    model = DeepcvModule((32, 32, 3), hp, dtype="bfloat16")
    monkeypatch.setattr(port_nn, "fused_conv2d_bias_act", spy)
    before = fused_conv2d_bias_act.launches
    y = model(torch.rand(8, 32, 32, 3, device=cuda))
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert fused_conv2d_bias_act.launches == before + 2
    assert seen == [(torch.bfloat16,) * 3] * 2


# --------------------------------------------------------------------------- #
# The wide classifiers and weight norm
# --------------------------------------------------------------------------- #

WIDE_MODELS = ("wide_classifier_model", "wide_classifier_gn_model", "wide_classifier_ws_model")


def _wide_hp(key):
    import os

    from deepcv_tpu_torch.config import load_yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hp = dict(load_yaml(os.path.join(repo, "conf/base/parameters.yml"))[key])
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    return hp


@pytest.mark.parametrize("act_fn", ["leaky_relu", "silu"])
@pytest.mark.parametrize("key", WIDE_MODELS)
def test_wide_model_on_card_matches_cpu(cuda, key, act_fn):
    """The conf's model at full width, batch 4, float32 (K2 by 3xTF32 on the
    card, its plain version on the CPU): a training forward and backward and
    an eval forward, 6 K2 launches each. Gradients are held with silu in
    place of leaky_relu only: a pre-activation within rounding of zero
    takes the other slope on the other device and moves a gradient by more
    than the bound."""
    from deepcv_tpu_torch.spec import DeepcvModule

    hp = dict(_wide_hp(key), act_fn=act_fn)
    cpu = DeepcvModule((32, 32, 3), hp, device="cpu")
    gpu = DeepcvModule((32, 32, 3), hp)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32))
    before = fused_conv2d_bias_act.launches
    outs = []
    for model, xx in ((cpu, x), (gpu, x.to(cuda))):
        model.train()
        y = model(xx)
        (y.square().mean()).backward()
        model.eval()
        with torch.no_grad():
            outs.append((y.detach().cpu(), model(xx).cpu(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()}))
    torch.cuda.synchronize()
    assert fused_conv2d_bias_act.launches - before == 2 * 6
    (y_c, e_c, g_c), (y_g, e_g, g_g) = outs
    assert _rel(y_g, y_c) <= F32_TOL and _rel(e_g, e_c) <= F32_TOL
    assert set(g_g) == set(g_c) and all(torch.isfinite(g).all() for g in g_g.values())
    if act_fn == "silu":
        for k in g_c:
            assert _rel(g_g[k], g_c[k]) <= 1e-3, k


def test_weight_norm_fused_conv_repacks_after_scale_or_load(cuda):
    """A weight-normed FusedConv2d packs the normalised weight for K2: its
    output follows an in-place edit of ``scale`` alone, of ``weight`` alone,
    and a ``load_state_dict``, each time equal to the CPU path."""
    from deepcv_tpu_torch.ops.nn import FusedConv2d

    conv = FusedConv2d(16, 32, (3, 3), act="leaky_relu")
    conv.add_weight_norm(1e-6)
    conv.init_parameters(torch.Generator().manual_seed(0))
    ref = FusedConv2d(16, 32, (3, 3), act="leaky_relu")
    ref.add_weight_norm(1e-6)
    conv.to(cuda)
    x = torch.randn(2, 16, 9, 9, generator=torch.Generator().manual_seed(1))
    xg = x.to(cuda).contiguous(memory_format=torch.channels_last)

    def check():
        ref.load_state_dict({k: v.cpu() for k, v in conv.state_dict().items()})
        with torch.no_grad():
            got, want = conv(xg).cpu(), ref(x)
        assert _rel(got, want) <= F32_TOL
        return got

    outs = [check()]
    with torch.no_grad():
        conv.scale[3] *= 4.0
    outs.append(check())
    with torch.no_grad():
        conv.weight[5].neg_()
    outs.append(check())
    state = {k: v.clone() for k, v in conv.state_dict().items()}
    state["scale"] = torch.linspace(0.5, 2.0, 32, device=cuda)
    conv.load_state_dict(state)
    outs.append(check())
    for a, b in zip(outs, outs[1:]):
        assert (a - b).abs().max() > 1e-3


def test_k2_bf16_at_a_wide_shape_matches_plain(cuda):
    """K2's bf16 route at one of the wide classifiers' convs at batch 1024:
    16x16, 128 -> 128 channels, bias and leaky_relu."""
    x, wt, b = _inputs(cuda, 1024, 16, 16, 128, 128, 3, torch.bfloat16)
    got = fused_conv2d_bias_act(x, wt, b, "leaky_relu")
    ref = plain_conv2d_bias_act(x, wt, b, "leaky_relu")
    assert got.dtype == torch.bfloat16 and _rel(got, ref) <= BF16_TOL


# --------------------------------------------------------------------------- #
# The CNN zoo: K2's epilogue activations and the models on the card
# --------------------------------------------------------------------------- #

#: one bf16 ulp of the largest value: both round one f32 result to bf16
BF16_ULP = 2.0 ** -7
#: K2's shapes in the zoo (N, H, W, Cin, Cout, k) at batch 2: MobileNetV2's
#: 1x1 expands, projections and head (Cin 16 and Cout 24, 40-ish, 160 and
#: 320 against the tile widths), and DenseNet's 3x3 128 -> 32
ZOO_K2_SHAPES = [(2, 112, 112, 16, 96, 1), (2, 112, 112, 32, 16, 1), (2, 56, 56, 144, 24, 1),
                 (2, 28, 28, 32, 192, 1), (2, 14, 14, 384, 64, 1), (2, 14, 14, 576, 96, 1),
                 (2, 7, 7, 960, 160, 1), (2, 7, 7, 960, 320, 1), (2, 7, 7, 320, 1280, 1),
                 (2, 56, 56, 128, 32, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ZOO_K2_SHAPES)
@pytest.mark.parametrize("act", ["relu6", "hard_swish", "silu"])
def test_k2_epilogue_zoo_act_matches_plain(cuda, dtype, shape, act):
    """Each epilogue code the zoo adds, in both routes, against the plain
    version: f32 within K2's f32 bound, bf16 within one bf16 ulp of the
    largest value; inputs scaled so that relu6 and hard_swish meet both
    corners. Each launch counts once under its activation."""
    x, wt, b = _inputs(cuda, *shape, dtype)
    x = (4.0 * x.float()).to(dtype).contiguous(memory_format=torch.channels_last)
    before = dict(fused_conv2d_bias_act.launches_by_act)
    got = fused_conv2d_bias_act(x, wt, b, act)
    ref = plain_conv2d_bias_act(x, wt, b, act)
    torch.cuda.synchronize()
    assert fused_conv2d_bias_act.launches_by_act == {**before, act: before[act] + 1}
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _rel(got, ref) <= (K2_F32_TOL if dtype == torch.float32 else BF16_ULP)
    if act != "silu":
        assert (ref.float() >= 6.0).any() or act == "hard_swish"
        assert (ref == 0).any()


#: zoo family -> (builder, arguments, K2 launches per forward by activation)
ZOO_MODELS = {
    "mobilenet_v2": ("mobilenet_v2_spec", {}, {"relu6": 17, "none": 17}),
    "mobilenet_v3": ("mobilenet_v3_spec", {"variant": "large"},
                     {"hard_swish": 10, "relu": 5, "none": 15}),
    "efficientnet_b0": ("efficientnet_b0_spec", {}, {"silu": 16, "none": 16}),
    "densenet": ("densenet_spec", {"depth": 121}, {"none": 119}),
    "convnext": ("convnext_spec", {"variant": "tiny"}, {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(ZOO_MODELS))
def test_zoo_model_on_card_matches_cpu(cuda, family, dtype):
    """Each family at full width, 224x224, batch 2, eval, weights from one
    seed: the card's forward against the CPU path's, within 1e-3 of the
    largest logit in float32 and 1e-2 under bf16 autocast (bf16 on both);
    K2 launches per forward by activation, all in the forward's dtype."""
    from deepcv_tpu_torch.spec import DeepcvModule, zoo

    name, kw, per_act = ZOO_MODELS[family]
    hp = getattr(zoo, name)(num_classes=10, **kw)
    cpu = DeepcvModule((224, 224, 3), hp, device="cpu", dtype=dtype).eval()
    gpu = DeepcvModule((224, 224, 3), hp, dtype=dtype).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 224, 224, 3))
                         .astype(np.float32))
    by_act = dict(fused_conv2d_bias_act.launches_by_act)
    by_dtype = dict(fused_conv2d_bias_act.launches_by_dtype)
    with torch.no_grad():
        got = gpu(x.to(cuda)).float().cpu()
        ref = cpu(x).float()
    torch.cuda.synchronize()
    launched = {k: v - by_act[k] for k, v in fused_conv2d_bias_act.launches_by_act.items()
                if v != by_act[k]}
    assert launched == per_act
    n = sum(per_act.values())
    assert fused_conv2d_bias_act.launches_by_dtype == {**by_dtype, dtype: by_dtype[dtype] + n}
    assert got.shape == ref.shape == (2, 10) and torch.isfinite(got).all()
    assert _rel(got, ref) <= (1e-3 if dtype == "float32" else 1e-2)


# --------------------------------------------------------------------------- #
# Swin and V-MoE on the card
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin_on_card_matches_cpu(cuda, dtype):
    """swin_spec('t') at full width, window 4 on 64x64 images (maps 16, 8,
    4, 2: shifted windows in stages 1 and 2, the clamp in stage 3), batch 2,
    eval, weights from one seed: within 1e-3 of the largest logit in float32
    and 1e-2 under bf16 autocast; no kernel is launched (Swin's windowed
    attention reaches no kernel)."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import swin_spec

    hp = swin_spec("t", num_classes=10, window=4, pool_kernel=2)
    cpu = DeepcvModule((64, 64, 3), hp, device="cpu", dtype=dtype).eval()
    gpu = DeepcvModule((64, 64, 3), hp, dtype=dtype).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 64, 64, 3))
                         .astype(np.float32))
    k2, k3 = fused_conv2d_bias_act.launches, flash_attention_fwd.launches
    with torch.no_grad():
        got = gpu(x.to(cuda)).float().cpu()
        ref = cpu(x).float()
    assert (fused_conv2d_bias_act.launches, flash_attention_fwd.launches) == (k2, k3)
    assert got.shape == ref.shape == (2, 10) and torch.isfinite(got).all()
    assert _rel(got, ref) <= (1e-3 if dtype == "float32" else 1e-2)


def _vmoe_hp(layers=4):
    """ViT-B/16 (flash) with 4 experts on every 2nd block, top-2, groups of
    2 images of 17 tokens (64x64 images), cut to its last ``layers``
    blocks."""
    from deepcv_tpu_torch.spec.zoo import vit_spec

    hp = vit_spec("b_16", num_classes=10, attn_impl="flash", moe_experts=4, moe_every=2,
                  moe_k=2, moe_group_size=34)
    hp["architecture"] = hp["architecture"][:1] + hp["architecture"][13 - layers:]
    return hp


def test_vmoe_on_card_matches_cpu_with_the_same_routing(cuda):
    """Four blocks, two with experts, batch 6 in float32 (TF32 off), the same
    weights: logits within 1e-3 of the largest, every routing choice the
    same on both, and K3 launched once per block."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
    from deepcv_tpu_torch.ops.moe import MoEMlp
    from deepcv_tpu_torch.spec import DeepcvModule

    cpu = DeepcvModule((64, 64, 3), _vmoe_hp(), device="cpu").eval()
    gpu = DeepcvModule((64, 64, 3), _vmoe_hp()).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 64, 64, 3))
                         .astype(np.float32))
    before = flash_attention_fwd.launches
    with torch.no_grad():
        got = gpu(x.to(cuda)).cpu()
        ref = cpu(x)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches - before == 4
    assert _rel(got, ref) <= 1e-3
    routes = [[m.routing for m in model.modules() if isinstance(m, MoEMlp)]
              for model in (gpu, cpu)]
    assert len(routes[0]) == 2
    for (e_gpu, k_gpu), (e_cpu, k_cpu) in zip(*routes):
        assert e_gpu.shape == (3, 34, 2)
        assert torch.equal(e_gpu.cpu(), e_cpu) and torch.equal(k_gpu.cpu(), k_cpu)


def test_vmoe_train_step_bf16_counts_the_flash_launches(cuda):
    """One SGD step of the four-block V-MoE under bf16 autocast with
    ``moe_aux_weight`` 0.01: K3, K4 and K5 once per block, all on bfloat16
    inputs; the loss is CE + 0.01 x the mean aux, which is in (0, 4]."""
    from deepcv_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.train.losses import WeightedLosses, cross_entropy_loss
    from deepcv_tpu_torch.train.training import TrainState, build_optimizer, train_step

    model = DeepcvModule((64, 64, 3), _vmoe_hp(), dtype="bfloat16").train()
    state = TrainState(model, build_optimizer("sgd", {"lr": 0.1, "momentum": 0.9},
                                              model.parameters()),
                       0, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((6, 64, 64, 3), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 10, size=(6,))).to(cuda)
    wrappers = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [dict(w.launches_by_dtype) for w in wrappers]
    out = train_step(state, WeightedLosses(cross_entropy_loss), {}, x, y,
                     dtype=torch.bfloat16, moe_aux_weight=0.01)
    torch.cuda.synchronize()
    assert [{k: w.launches_by_dtype[k] - b[k] for k in b} for w, b in zip(wrappers, before)] \
        == [{"float32": 0, "bfloat16": 4}] * 3
    aux = out["moe_aux"].item()
    assert 0.0 < aux <= 4.0
    assert abs(out["main_loss"].item() - (out["loss"].item() + 0.01 * aux)) <= 1e-5


# --------------------------------------------------------------------------- #
# dense prediction on the card
# --------------------------------------------------------------------------- #

def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


class _Set:
    """The ``datasets['trainset']`` view that ``create_segmenter`` reads."""

    def __init__(self, image_shape):
        self.classes, self.image_shape = None, image_shape
        self.dataset = self


def test_unet_bf16_on_card_matches_cpu(cuda):
    """``unet_spec()`` at full width (depth 4, base 32) with the 4-class
    head through ``create_segmenter``, 64x64, batch 2, eval, weights from
    one seed, under bf16 autocast (as ``train()`` runs a ``dtype:
    bfloat16`` hp): 19 K2 launches on the card, all bf16. bf16 itself costs
    the CPU path rel L2 4.5e-2 against its float32 forward at this seed
    (19 convs on bf16 inputs and weights, each normalised after); the
    card's bf16 forward is within that of the CPU's bf16 forward (2.0e-2 on
    an H100), and off the CPU's float32 forward by at most 1.25 times
    it."""
    from deepcv_tpu_torch.pipelines.segmentation import create_segmenter
    from deepcv_tpu_torch.spec.zoo import unet_spec

    datasets = {"trainset": _Set((64, 64, 3))}
    cpu = create_segmenter(datasets, unet_spec(), device="cpu").eval()
    gpu = create_segmenter(datasets, unet_spec()).eval()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 64, 64, 3))
                         .astype(np.float32))
    before = dict(fused_conv2d_bias_act.launches_by_dtype)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        got = gpu(x.to(cuda)).float().cpu()
    torch.cuda.synchronize()
    with torch.no_grad():
        ref = cpu(x)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            ref_bf16 = cpu(x).float()
    assert fused_conv2d_bias_act.launches_by_dtype == {**before,
                                                      "bfloat16": before["bfloat16"] + 19}
    assert got.shape == ref.shape == (2, 64, 64, 4) and torch.isfinite(got).all()
    bf16_cost = _rel_l2(ref_bf16, ref)
    assert _rel_l2(got, ref_bf16) <= bf16_cost
    assert _rel_l2(got, ref) <= 1.25 * bf16_cost


def test_hrnet_segmenter_f32_on_card_matches_cpu(cuda):
    """The conf's semantic_segmentation_model (hrnet_backbone) through
    ``create_segmenter`` at 32x32, batch 8, float32 (TF32 off), the same
    weights: one f32 K2 launch (the head) in eval and in train mode, within
    rel L2 1e-3 of the CPU path in both."""
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.pipelines.segmentation import create_segmenter

    hp = load_yaml("conf/base/parameters.yml")["semantic_segmentation_model"]
    datasets = {"trainset": _Set((32, 32, 3))}
    cpu = create_segmenter(datasets, hp, device="cpu")
    gpu = create_segmenter(datasets, hp)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 32, 32, 3))
                         .astype(np.float32))
    for train in (False, True):
        before = dict(fused_conv2d_bias_act.launches_by_dtype)
        with torch.no_grad():
            got = gpu.train(train)(x.to(cuda)).cpu()
            ref = cpu.train(train)(x)
        torch.cuda.synchronize()
        assert fused_conv2d_bias_act.launches_by_dtype == {**before,
                                                          "float32": before["float32"] + 1}
        assert got.shape == ref.shape == (8, 32, 32, 4) and torch.isfinite(got).all()
        assert _rel_l2(got, ref) <= 1e-3


class _Targets:
    """The ``datasets['trainset']`` view ``create_fpn_detector`` reads."""

    def __init__(self, image_shape, targets):
        self.image_shape, self.targets = image_shape, targets
        self.dataset = self


def test_fpn_detector_f32_on_card_matches_cpu(cuda):
    """Config 12's FPN detector (64x64, grids (16, 8), 3 classes) through
    ``create_fpn_detector``, batch 8, float32 (TF32 off), the same weights:
    4 f32 K2 launches a forward, the flat (8, 320, 8) output within rel L2
    1e-3 of the CPU path."""
    from chip_smoke import FPN_BACKBONE
    from deepcv_tpu_torch.pipelines.detection import create_fpn_detector

    datasets = {"trainset": _Targets((64, 64, 3), np.zeros((1, 320, 8), np.float32))}
    cpu = create_fpn_detector(datasets, FPN_BACKBONE, device="cpu").eval()
    gpu = create_fpn_detector(datasets, FPN_BACKBONE).eval()
    assert gpu.capacity() == 221_064
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(8, 64, 64, 3))
                         .astype(np.float32))
    before = dict(fused_conv2d_bias_act.launches_by_dtype)
    with torch.no_grad():
        got = gpu(x.to(cuda)).cpu()
        ref = cpu(x)
    torch.cuda.synchronize()
    assert fused_conv2d_bias_act.launches_by_dtype == {**before,
                                                      "float32": before["float32"] + 4}
    assert got.shape == ref.shape == (8, 320, 8) and torch.isfinite(got).all()
    assert _rel_l2(got, ref) <= 1e-3


def test_nms_and_map_on_card_equal_the_cpu(cuda):
    """``decode_detections_flat`` with class-aware NMS and ``map50_flat`` on
    the same logits on the card and on the CPU: the same kept candidates,
    classes and mAP (boxes and scores within 1e-6)."""
    from deepcv_tpu_torch.pipelines.detection import (
        decode_detections_flat, generate_shapes_dataset_fpn, map50_flat)

    grids = (16, 8)
    target = torch.from_numpy(generate_shapes_dataset_fpn(
        n=64, image_size=64, grids=grids, seed=3).targets)
    rng = np.random.default_rng(7)
    pred = torch.from_numpy(rng.normal(size=target.shape).astype(np.float32))
    pred[..., 0] += 4.0 * (target[..., 0] - 0.5)
    got = [t.cpu() for t in decode_detections_flat(pred.to(cuda), grids, nms_iou=0.5)]
    ref = decode_detections_flat(pred, grids, nms_iou=0.5)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[1] > 0, ref[1] > 0)
    assert (got[0] - ref[0]).abs().max() <= 1e-6 and (got[1] - ref[1]).abs().max() <= 1e-6
    m_got = float(map50_flat(pred.to(cuda), target.to(cuda), grids))
    m_ref = float(map50_flat(pred, target, grids))
    assert 0.0 < m_ref < 1.0 and abs(m_got - m_ref) <= 1e-6


def test_keypoint_chain_on_card_agrees_with_cpu(cuda):
    """bench.py config 4's chain (the conf's encoder at 64x64, float32,
    K = 256, 4 pairs) on the card and on the CPU with the same weights and
    images: one K2 launch an encoder forward, the keypoints, matched
    indices and AdaLAM masks (the same Gumbel draws) agreeing for at least
    99 % of the keypoints."""
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.pipelines import keypoints as kp
    from deepcv_tpu_torch.spec import DeepcvModule

    hp = load_yaml("conf/base/parameters.yml")["keypoints_encoder_model"]
    cpu = DeepcvModule((64, 64, 3), hp, device="cpu").eval()
    gpu = DeepcvModule((64, 64, 3), hp).eval()
    rng = np.random.default_rng(8)
    xa = torch.from_numpy(rng.uniform(size=(4, 64, 64, 3)).astype(np.float32))
    xb = xa + 0.02 * torch.from_numpy(rng.normal(size=xa.shape).astype(np.float32))
    gumbel = torch.from_numpy(rng.gumbel(size=(4, 32, 16, 256)).astype(np.float32))

    def chain(enc, a, b):
        fa, fb = enc(a), enc(b)
        ka, _ = kp.extract_keypoints(fa.abs().mean(-1), k=256)
        kb, _ = kp.extract_keypoints(fb.abs().mean(-1), k=256)
        da, db = kp.extract_dense_descriptors(fa), kp.extract_dense_descriptors(fb)
        sa = da.gather(1, (ka[..., 0] * 64 + ka[..., 1])[..., None].expand(-1, -1, 16))
        sb = db.gather(1, (kb[..., 0] * 64 + kb[..., 1])[..., None].expand(-1, -1, 16))
        m, v = kp.match_descriptors(sa, sb)
        masks = torch.stack([kp.filter_matches_adalam(ka[i], kb[i], m[i], v[i],
                                                      gumbel=gumbel[i].to(a.device))
                             for i in range(len(a))])
        return [t.cpu() for t in (ka, kb, m, v, masks)]

    before = fused_conv2d_bias_act.launches
    with torch.no_grad():
        got = chain(gpu, xa.to(cuda), xb.to(cuda))
        ref = chain(cpu, xa, xb)
    assert fused_conv2d_bias_act.launches == before + 2
    assert float((got[0] == ref[0]).all(-1).float().mean()) >= 0.99
    assert float(((got[2] == ref[2]) & (got[3] == ref[3])).float().mean()) >= 0.99
    assert float((got[4] == ref[4]).float().mean()) >= 0.99
    assert ref[3].any() and ref[4].any()


class _Clips:
    """The ``datasets['trainset']`` view the video model creators read."""

    def __init__(self, image_shape, num_classes):
        self.image_shape, self.num_classes = image_shape, num_classes


#: the four video models chip_smoke.py trains: (creator, conf key, overrides,
#: input shape, classes)
VIDEO_MODELS = {"flow": ("create_flow_model", "optical_flow_model", {}, (32, 32, 6), None),
                "conv3d": ("create_model", "video_classifier_model", {}, (6, 12, 12, 3), 4),
                "gru": ("create_temporal_model", "temporal_classifier_model", {},
                        (6, 12, 12, 3), 4),
                "transformer": ("create_temporal_model", "temporal_classifier_model",
                                {"temporal": "transformer"}, (6, 12, 12, 3), 4)}


@pytest.mark.parametrize("name", sorted(VIDEO_MODELS))
def test_video_model_f32_on_card_matches_cpu(cuda, name):
    """The conf's optical-flow, conv3d and temporal (gru and transformer)
    models, batch 8, float32 (TF32 off), the same weights, in eval and in
    train mode: within rel L2 1e-3 of the CPU path, no K2 launch."""
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.pipelines import classification, video

    creator, key, extra, shape, classes = VIDEO_MODELS[name]
    create = getattr(video if hasattr(video, creator) else classification, creator)
    hp = {**load_yaml("conf/base/parameters.yml")[key], **extra}
    datasets = {"trainset": _Clips(shape, classes)}
    cpu = create(datasets, hp, device="cpu")
    gpu = create(datasets, hp)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(9).uniform(size=(8, *shape)).astype(np.float32))
    for train in (False, True):
        before = fused_conv2d_bias_act.launches
        with torch.no_grad():
            got = gpu.train(train)(x.to(cuda)).cpu()
            ref = cpu.train(train)(x)
        torch.cuda.synchronize()
        assert fused_conv2d_bias_act.launches == before
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel_l2(got, ref) <= 1e-3


def test_track_sequence_on_card_equals_the_cpu(cuda):
    """A jittered clip of 60 frames, 12 objects in lanes, births, deaths and
    dropped detections: the ids and ``mot_metrics`` on CUDA equal the CPU's."""
    from chip_smoke import tracking_clip
    from deepcv_tpu_torch.pipelines.tracking import mot_metrics, track_sequence

    boxes, mask, gt_ids = tracking_clip(frames=60, objects=12, rows=16, seed=3)
    got = track_sequence(boxes.to(cuda), mask.to(cuda), max_tracks=32).cpu()
    ref = track_sequence(boxes, mask, max_tracks=32)
    assert torch.equal(got, ref) and (ref[mask] >= 0).all()
    m_got = mot_metrics(boxes.to(cuda), gt_ids.to(cuda), mask.to(cuda), boxes.to(cuda),
                        got.to(cuda), mask.to(cuda))
    m_ref = mot_metrics(boxes, gt_ids, mask, boxes, ref, mask)
    assert {k: v.item() for k, v in m_got.items()} == {k: v.item() for k, v in m_ref.items()}


# --------------------------------------------------------------------------- #
# int8_conv: the port-only w8a8 conv kernel, and the int8 builds on the card
# --------------------------------------------------------------------------- #

#: (N, Cin, spatial, Cout, kernel, stride, padding, dilation, groups): every
#: load width (16, 4 and 1 input channels a load) and output tile (8, 4 and
#: 1 channels a thread), strides, dilation, groups, depthwise, a ResNet stem,
#: 1-d and 3-d
INT8_SHAPES = [(2, 64, (9, 11), 64, (3, 3), 1, 1, 1, 1), (2, 64, (9, 11), 128, (3, 3), 2, 1, 1, 1),
               (3, 3, (17, 15), 64, (7, 7), 2, 3, 1, 1), (2, 12, (10, 10), 20, (3, 3), 1, 2, 2, 1),
               (2, 32, (8, 9), 32, (3, 3), 1, 1, 1, 2), (2, 24, (8, 9), 24, (3, 3), 2, 1, 1, 24),
               (2, 256, (7, 7), 512, (1, 1), 2, 0, 1, 1), (2, 5, (6, 6), 7, (3, 3), 1, 1, 1, 1),
               (3, 6, (13,), 10, (5,), 2, 2, 1, 1), (2, 8, (4, 6, 5), 12, (3, 3, 3), 1, 1, 1, 2),
               (2, 32, (5, 7), 3, (3, 3), 1, 1, 1, 1),
               # the tensor-core route's edges: pixels not a multiple of the
               # 128-pixel tile, 72 and 8 channels out, 3 in at 7x7 and 3x3,
               # dilation 2, 1-d and 3-d, a 1x1 over several K stages
               (3, 64, (13, 17), 128, (3, 3), 1, 1, 1, 1), (2, 64, (9, 13), 72, (3, 3), 1, 1, 1, 1),
               (2, 64, (9, 11), 8, (3, 3), 1, 1, 1, 1), (3, 3, (29, 31), 64, (7, 7), 2, 3, 1, 1),
               (4, 3, (32, 32), 64, (3, 3), 1, 1, 1, 1), (2, 64, (10, 9), 64, (3, 3), 1, 2, 2, 1),
               (3, 16, (37,), 40, (5,), 2, 2, 1, 1), (2, 16, (4, 6, 5), 8, (3, 3, 3), 1, 1, 1, 1),
               (2, 1024, (7, 7), 256, (1, 1), 1, 0, 1, 1)]


def _int8_operands(dev, n, cin, spatial, cout, ks, groups, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(-127, 128, (n, cin, *spatial), generator=g, device=dev,
                       dtype=torch.int8)
    if xq.dim() in (4, 5):
        xq = xq.contiguous(memory_format=torch.channels_last if xq.dim() == 4
                           else torch.channels_last_3d)
    wq = torch.randint(-127, 128, (cout, cin // groups, *ks), generator=g, device=dev,
                       dtype=torch.int8)
    s_act = torch.rand((), generator=g, device=dev) * 0.1
    s_w = torch.rand((cout,), generator=g, device=dev) * 0.01
    return xq, wq, s_act, s_w


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_conv_kernel_equals_plain(cuda, shape, out_dtype):
    """The int32 sums bit-equal, and the rescaled output equal to the bit:
    both take float32(acc) * (s_act * s_w[o]) and one rounding to the
    output type."""
    from deepcv_tpu_torch.ops.kernels.int8_conv import int8_conv, plain_int8_conv

    n, cin, spatial, cout, ks, stride, pad, dil, groups = shape
    xq, wq, s_act, s_w = _int8_operands(cuda, n, cin, spatial, cout, ks, groups)
    before = int8_conv.launches
    acc = int8_conv(xq, wq, s_act, s_w, stride, pad, dil, groups, return_acc=True)
    y = int8_conv(xq, wq, s_act, s_w, stride, pad, dil, groups, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 2
    ref_acc = plain_int8_conv(xq, wq, s_act, s_w, stride, pad, dil, groups, return_acc=True)
    ref = plain_int8_conv(xq, wq, s_act, s_w, stride, pad, dil, groups, out_dtype=out_dtype)
    assert acc.dtype == torch.int32 and torch.equal(acc, ref_acc)
    assert y.dtype == out_dtype and y.shape == ref.shape and torch.equal(y, ref)


def test_int8_conv_largest_sums(cuda):
    """K = 3 x 3 x 512 = 4,608 with every code at -127: the interior sums are
    127^2 x 4,608 = 74,322,432, the largest config 8 reaches, bit-equal."""
    from deepcv_tpu_torch.ops.kernels.int8_conv import int8_conv, plain_int8_conv

    xq = torch.full((2, 512, 7, 7), -127, dtype=torch.int8, device=cuda)
    xq = xq.contiguous(memory_format=torch.channels_last)
    wq = torch.full((512, 512, 3, 3), -127, dtype=torch.int8, device=cuda)
    s_act, s_w = torch.full((), 0.01, device=cuda), torch.full((512,), 0.02, device=cuda)
    acc = int8_conv(xq, wq, s_act, s_w, 1, 1, return_acc=True)
    assert int(acc.max()) == 127 ** 2 * 4608
    assert torch.equal(acc, plain_int8_conv(xq, wq, s_act, s_w, 1, 1, return_acc=True))
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(int8_conv(xq, wq, s_act, s_w, 1, 1, out_dtype=dtype),
                           plain_int8_conv(xq, wq, s_act, s_w, 1, 1, out_dtype=dtype))


def test_int8_conv_routes_and_unaligned_views(cuda):
    """groups 1 launches the tensor-core kernel, groups > 1 the dp4a one, each
    counted in launches_by_route; codes that are a view starting off a
    16-byte boundary are copied, not read misaligned; a w_packed of the
    other route's layout is refused."""
    from deepcv_tpu_torch.ops.kernels.int8_conv import (int8_conv, pack_weight,
                                                         pack_weight_tc, plain_int8_conv)

    g = torch.Generator(device=cuda).manual_seed(4)
    flat = torch.randint(-127, 128, (1 + 2 * 6 * 7 * 32,), generator=g, device=cuda,
                         dtype=torch.int8)
    xq = flat[1:].view(2, 6, 7, 32).permute(0, 3, 1, 2)         # channels last, offset 1
    assert xq.data_ptr() % 16 and xq.is_contiguous(memory_format=torch.channels_last)
    s_act = torch.full((), 0.03, device=cuda)
    for groups in (1, 2):
        wq = torch.randint(-127, 128, (16, 32 // groups, 3, 3), generator=g, device=cuda,
                           dtype=torch.int8)
        s_w = torch.rand((16,), generator=g, device=cuda)
        before = dict(int8_conv.launches_by_route)
        acc = int8_conv(xq, wq, s_act, s_w, 1, 1, 1, groups, return_acc=True)
        route = "tensor_core" if groups == 1 else "dp4a"
        assert {r: int8_conv.launches_by_route[r] - before[r] for r in before} == \
            {r: int(r == route) for r in before}
        assert torch.equal(acc, plain_int8_conv(xq, wq, s_act, s_w, 1, 1, 1, groups,
                                                return_acc=True))
        wrong = pack_weight(wq) if groups == 1 else pack_weight_tc(wq)
        with pytest.raises(ValueError, match="w_packed must be"):
            int8_conv(xq, wq, s_act, s_w, 1, 1, 1, groups, w_packed=wrong)


def _config8_model(name, dev, dtype):
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import resnet_spec

    if name == "wide":
        hp = dict(load_yaml("conf/base/parameters.yml")["wide_classifier_model"])
        hp["architecture"][-1]["fully_connected"]["out_features"] = 10
        shape = (32, 32, 3)
    else:
        hp, shape = resnet_spec(50, num_classes=1000, pool_kernel=7), (224, 224, 3)
    m = DeepcvModule(shape, hp, device=dev, dtype=dtype,
                     generator=torch.Generator().manual_seed(3)).eval()
    return m, shape


@pytest.mark.parametrize("name,convs", [("wide", 6), ("resnet50", 53)])
def test_int8_config8_forward_runs_on_the_tensor_cores(cuda, name, convs):
    """One bf16 int8 forward of each config 8 model (static scales): 6 and 53
    int8_conv launches, every one on the tensor cores, no K2, finite."""
    from deepcv_tpu_torch.compression import calibrate_int8_scales
    from deepcv_tpu_torch.ops.kernels.int8_conv import int8_conv

    model, shape = _config8_model(name, cuda, torch.bfloat16)
    x = torch.randn((4, *shape), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(torch.bfloat16)
    scales = calibrate_int8_scales(model, [x.float()])
    served = model.with_options(quantize="int8", quantize_scales=scales)
    before, k2 = dict(int8_conv.launches_by_route), fused_conv2d_bias_act.launches
    with torch.inference_mode():
        y = served(x)
    torch.cuda.synchronize()
    assert {r: int8_conv.launches_by_route[r] - before[r] for r in before} == \
        {"tensor_core": convs, "dp4a": 0}
    assert fused_conv2d_bias_act.launches == k2
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_int8_wide_bf16_ops_on_card_equal_cpu(cuda):
    """config 8's bf16 wide classifier, static scales: each int8 op (codes,
    the tensor-core conv's int32 sums and rescale, the bias in bf16; the
    dense on torch._int_mm) on the CPU path's own input to it gives the CPU
    op's output to the bit."""
    from deepcv_tpu_torch.compression import calibrate_int8_scales

    cpu, _ = _config8_model("wide", "cpu", torch.bfloat16)
    x = torch.randn(32, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    scales = calibrate_int8_scales(cpu, [x])
    cpu8 = cpu.with_options(quantize="int8", quantize_scales=scales)
    _, ref_inputs = _int8_op_inputs(cpu8, x.to(torch.bfloat16))
    gpu8 = _config8_model("wide", "cpu", torch.bfloat16)[0].to(cuda).with_options(
        quantize="int8", quantize_scales=scales)
    assert len(ref_inputs) == 7
    with torch.no_grad():
        for q, (op, xin) in ref_inputs.items():
            got = dict(gpu8.named_modules())[q](xin.to(cuda)).cpu()
            ref = op(xin)
            assert got.dtype == ref.dtype == torch.bfloat16 and torch.equal(got, ref), q


def _wide_int8(dev, dtype=None):
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.spec import DeepcvModule

    hp = dict(load_yaml("conf/base/parameters.yml")["wide_classifier_model"])
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    m = DeepcvModule((32, 32, 3), hp, device="cpu", dtype=dtype,
                     generator=torch.Generator().manual_seed(3)).eval()
    return m


def _int8_op_inputs(model, x):
    """The model's output on ``x`` and each int8 op's input to it, {op name:
    (op, input)} in the order the ops ran."""
    seen = {}
    hooks = [op.register_forward_pre_hook(
        lambda m, a, q=q: seen.__setitem__(q, (m, a[0].detach())))
        for q, op in model.named_modules() if getattr(op, "quant", None) is not None]
    with torch.no_grad():
        out = model(x)
    for h in hooks:
        h.remove()
    return out, seen


def _tie_flips(ref_inputs, got_inputs):
    """Differing activation codes of each op, each path's from its own input
    to it. In the first op where any differ, every difference is one step at
    a rounding tie of the CPU input (|x / s - k - 1/2| < 1e-3); ops after it
    see inputs that the flip moved."""
    from deepcv_tpu_torch.compression import activation_codes

    flips = 0
    for q, (op, xr) in ref_inputs.items():
        cr, sr = activation_codes(xr, op.quant.act_scale)
        cg = activation_codes(got_inputs[q][1], op.quant.act_scale)[0].cpu()
        diff = cr != cg
        if diff.any() and flips == 0:
            assert (cr.int() - cg.int()).abs().max().item() == 1, q
            ratio = xr.double()[diff] / float(sr)
            assert (((ratio - ratio.trunc()).abs() - 0.5).abs() < 1e-3).all(), (q, ratio)
        flips += int(diff.sum())
    return flips


@pytest.mark.parametrize("static", [False, True])
def test_int8_wide_classifier_on_card_matches_cpu(cuda, static):
    """float32, TF32 off: the six convs on int8_conv (no K2), the dense on
    torch._int_mm. Every int8 op on the CPU path's own input to it equals
    the CPU op. The codes of each op, each path's from its own input, differ
    only where an activation, a few ulps apart after the two paths' float
    batch norms, sits on a rounding tie and takes the other code: the
    first op where any differ differs by one step at a tie. With no flipped
    code the forwards agree within rel L2 1e-3; past a flip within 2e-2,
    the CPU tests' bound past a tie, with the top-1 class equal on at least
    95 % of the rows."""
    from deepcv_tpu_torch.compression import calibrate_int8_scales
    from deepcv_tpu_torch.ops.kernels.int8_conv import int8_conv

    cpu = _wide_int8("cpu")
    x = torch.randn(64, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    scales = calibrate_int8_scales(cpu, [x]) if static else None
    cpu8 = cpu.with_options(quantize="int8", quantize_scales=scales)
    ref, ref_inputs = _int8_op_inputs(cpu8, x)
    gpu8 = _wide_int8("cpu").to(cuda).with_options(quantize="int8", quantize_scales=scales)
    k2 = fused_conv2d_bias_act.launches
    before = int8_conv.launches
    got, got_inputs = _int8_op_inputs(gpu8, x.to(cuda))
    torch.cuda.synchronize()
    assert int8_conv.launches - before == 6 and fused_conv2d_bias_act.launches == k2
    assert len(ref_inputs) == 7 and list(got_inputs) == list(ref_inputs)
    with torch.no_grad():
        for q, (op, xin) in ref_inputs.items():
            assert torch.equal(got_inputs[q][0](xin.to(cuda)).cpu(), op(xin)), q
    flips = _tie_flips(ref_inputs, got_inputs)
    rel = ((got.cpu() - ref).norm() / ref.norm()).item()
    assert rel <= (1e-3 if flips == 0 else 2e-2), (rel, flips)
    if flips:
        assert (got.cpu().argmax(-1) == ref.argmax(-1)).float().mean() >= 0.95


def test_int8_dense_on_card_equals_cpu(cuda):
    from deepcv_tpu_torch.compression import _int_mm, int8_dense

    g = torch.Generator().manual_seed(2)
    for m, k, n in ((5, 24, 10), (300, 4096, 10), (64, 768, 2304)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        assert torch.equal(_int_mm(a.to(cuda), b.to(cuda)).cpu(), _int_mm(a, b))
    x = torch.randn(7, 33, generator=g)
    w = torch.randn(12, 33, generator=g)
    assert torch.equal(int8_dense(x.to(cuda), w.to(cuda)).cpu(), int8_dense(x, w))


# --------------------------------------------------------------------------- #
# The rest of augmentation, the classical-vision modules, Y4M predict
# --------------------------------------------------------------------------- #

AUG_SHAPE = (256, 32, 32, 3)


def _aug_batch():
    g = torch.Generator().manual_seed(20)
    return torch.randint(0, 256, AUG_SHAPE, generator=g, dtype=torch.uint8).float() / 255


def _levels_apart(got, ref):
    d = (got.cpu().float() - ref.float()).abs() * 255
    return float(d.max()), float((d > 0.5).float().mean())


@pytest.mark.parametrize("name", ["autocontrast", "equalize", "posterize", "rotate",
                                  "solarize", "shear_x", "shear_y", "translate_x",
                                  "translate_y", "color", "contrast", "brightness",
                                  "sharpness"])
def test_augmix_op_on_card_matches_cpu(cuda, name):
    """Each of the 13 ops on the same images and draws: at most one u8
    level apart, on at most 0.1 % of the values."""
    from deepcv_tpu_torch.data import augmentation as A

    x = _aug_batch()
    g = torch.Generator().manual_seed(21)
    n, h, w, _ = AUG_SHAPE
    op = A.OPS[name]
    values = op.param(A._levels(n, g, 8.0), A._signs(n, g), h, w)
    most, share = _levels_apart(op.apply(x.to(cuda), values.to(cuda)), op.apply(x, values))
    assert most <= 1.0 and share <= 1e-3, (most, share)


def test_augmentation_draws_and_batches_on_card_match_cpu(cuda):
    """AugMix, RandAugment, random erasing, mixup, CutMix and the float
    transforms with the same draws; the draws themselves on the card's
    generator have the right shapes and devices."""
    from deepcv_tpu_torch.data import augmentation as A
    from deepcv_tpu_torch.data import transforms as T

    x = _aug_batch()
    n, h, w, _ = AUG_SHAPE
    g = torch.Generator().manual_seed(22)
    d = A.draw_augment_and_mix(n, h, w, g)
    got = A.augment_and_mix_apply(x.to(cuda), **{k: v.to(cuda) for k, v in d.items()})
    diff = (got.cpu() - A.augment_and_mix_apply(x, **d)).abs()
    assert float(diff.max()) <= 1 / 255 + 1e-5 and float((diff > 1e-5).float().mean()) <= 1e-3
    choice, values = A.draw_rand_augment(n, h, w, g, 2, 5.0)
    assert _levels_apart(A.rand_augment_apply(x.to(cuda), choice.to(cuda), values.to(cuda)),
                         A.rand_augment_apply(x, choice, values))[1] <= 1e-3
    m = torch.eye(2, 3).repeat(n, 1, 1) + 0.1 * torch.randn(n, 2, 3, generator=g)
    for fn in (lambda t: T.affine_transform(t, m.to(t.device)),
               lambda t: T.resize(t, 24), lambda t: T.adjust_hue(t, 0.2),
               lambda t: A.mixup_apply(t, *[v.to(t.device) for v in A.draw_mixup(
                   n, torch.Generator().manual_seed(3))])[0],
               lambda t: A.cutmix_apply(t, *[v.to(t.device) for v in A.draw_cutmix(
                   n, h, w, torch.Generator().manual_seed(4))])[0]):
        torch.testing.assert_close(fn(x.to(cuda)).cpu(), fn(x), rtol=0, atol=1e-5)
    gc = torch.Generator(device=cuda).manual_seed(5)
    draws = A.draw_augment_and_mix(n, h, w, gc)
    assert all(v.device.type == "cuda" for v in draws.values())
    lam = A.beta(0.2, 0.2, (4096,), gc)
    assert lam.device.type == "cuda" and abs(float(lam.mean()) - 0.5) < 0.03
    recipe = A.apply_augmentation_recipe({"transforms": [{"rotate": [-0.4, 0.4]},
                                                         {"posterize": 0.05}],
                                          "augmix": {"augmentation_chains_count": 2},
                                          "random_erasing": {}})
    out = recipe(x.to(cuda), gc)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_classical_match_and_geometry_on_card_match_cpu(cuda):
    from deepcv_tpu_torch.pipelines import classical_features as C
    from deepcv_tpu_torch.pipelines import geometry as G

    g = torch.Generator().manual_seed(30)
    img = F.avg_pool2d(torch.rand(4, 3, 68, 68, generator=g), 5, stride=1).permute(0, 2, 3, 1)
    c, d, v = C.detect_and_describe(img.to(cuda), k=64)
    rc, rd, rv = C.detect_and_describe(img, k=64)
    assert (c.cpu() == rc).all(-1).float().mean() >= 0.99
    same = (c.cpu() == rc).all(-1)
    assert (d.cpu() != rd)[same].float().mean() <= 1e-3
    pa = torch.rand(256, 2, generator=g) * 200
    pb = pa + torch.tensor([5.0, -3.0])
    pb[200:] += torch.rand(56, 2, generator=g) * 50
    sets = G.ransac_sets(256, None, g)
    h, inl = G.ransac_homography(pa.to(cuda), pb.to(cuda), sets=sets)
    rh, rinl = G.ransac_homography(pa, pb, sets=sets)
    assert torch.equal(inl.cpu(), rinl)
    torch.testing.assert_close(h.cpu() / h[2, 2].cpu(), rh / rh[2, 2], rtol=0, atol=1e-4)
    frames = torch.rand(16, 32, 32, 3, generator=g)
    for got, ref in zip(G.remove_watermark(frames.to(cuda)), G.remove_watermark(frames)):
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    base = F.avg_pool2d(torch.rand(1, 3, 44, 44, generator=g), 5, stride=1)[0].permute(1, 2, 0)
    clip = torch.stack([torch.roll(base, (s, -s), (0, 1))[4:36, 4:36] for s in range(6)])
    got, traj = G.stabilize_video(clip.to(cuda))
    ref, rtraj = G.stabilize_video(clip)
    assert torch.equal(traj.cpu(), rtraj)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)


def test_predict_on_a_y4m_clip_on_card_matches_cpu(cuda, tmp_path, capsys):
    import json

    import numpy as np

    from deepcv_tpu_torch import cli
    from deepcv_tpu_torch.data.video_io import write_y4m
    from deepcv_tpu_torch.serve import save_model_bundle
    from deepcv_tpu_torch.spec import DeepcvModule

    hp = {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 8}},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}}, {"flatten": {}},
        {"fully_connected": {"out_features": 5}}]}
    save_model_bundle(tmp_path / "bundle", DeepcvModule((16, 16, 3), hp, device="cpu"))
    rng = np.random.default_rng(6)
    write_y4m(tmp_path / "clip.y4m", rng.integers(0, 256, (12, 16, 16, 3), dtype=np.uint8))
    k2 = fused_conv2d_bias_act.launches
    for dev in ("cuda", "cpu"):
        assert cli.main(["predict", "--bundle", str(tmp_path / "bundle"), "--input",
                         str(tmp_path / "clip.y4m"), "--output", str(tmp_path / f"{dev}.npy"),
                         "--to-tensor", "--batch-size", "4", "--device", dev]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["inputs"] == 12
        if dev == "cuda":
            assert fused_conv2d_bias_act.launches - k2 == 3
    got, ref = np.load(tmp_path / "cuda.npy"), np.load(tmp_path / "cpu.npy")
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-4


# --------------------------------------------------------------------------- #
# The training runtime: optimizers, the streaming input path, remat
# --------------------------------------------------------------------------- #

#: each optimizer's one step, card vs CPU on the same float32 gradients
#: (TF32 off): the largest difference relative to max|update|
RUNTIME_OPT_TOL = 1e-5
#: torch's Adam and AdamW, whose card kernel rounds the parameter otherwise
#: (an FMA) than the CPU's: held past one float32 ulp of the parameter
FMA_ROUNDED = ("adam", "adamw")
RUNTIME_OPTS = {"adamw": {"lr": 1e-3}, "adam": {"lr": 1e-3},
                "sgd": {"lr": 0.05, "momentum": 0.9, "nesterov": True},
                "rmsprop": {"lr": 1e-3}, "lamb": {"lr": 1e-3, "weight_decay": 1e-2},
                "lars": {"lr": 0.1}, "adafactor": {"lr": 1e-2},
                "lion": {"lr": 1e-4, "weight_decay": 0.1},
                "muon": {"lr": 0.02, "weight_decay": 1e-2},
                "schedule_free_adamw": {"lr": 1e-3, "warmup_steps": 2}}
_TINY_CLASSIFIER = {
    "act_fn": "leaky_relu", "dropout_prob": 0.0,
    "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
    "architecture": [{"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
                     {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
                     {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
                     {"flatten": {}},
                     {"fully_connected": {"out_features": 130, "act_fn": None,
                                          "batch_norm": None}}]}


@pytest.mark.parametrize("name", sorted(RUNTIME_OPTS))
def test_optimizer_step_on_card_matches_cpu(cuda, name):
    """One step on the card and on the CPU from the same parameters and
    gradients: the parameters equal within RUNTIME_OPT_TOL of max|update|;
    for FMA_ROUNDED past one float32 ulp of the parameter (a parameter near
    1 holds a 1e-3 update only to 6e-8)."""
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.train.optimizers import build_optimizer

    model = DeepcvModule((16, 16, 3), _TINY_CLASSIFIER, device="cpu")
    gen = torch.Generator().manual_seed(3)
    named = [(n, p.detach().clone()) for n, p in model.named_parameters()]
    grads = [torch.randn(p.shape, generator=gen) * 0.01 for _, p in named]
    after = []
    for dev in ("cpu", cuda):
        params = [(n, torch.nn.Parameter(p.to(dev).clone())) for n, p in named]
        opt = build_optimizer(name, RUNTIME_OPTS[name], params)
        for (_, p), g in zip(params, grads):
            p.grad = g.to(dev).clone()
        opt.step()
        after.append([p.detach().cpu() for _, p in params])
    top = max(float((a - p0).abs().max()) for a, (_, p0) in zip(after[0], named))
    inf = torch.tensor(float("inf"))
    for a, b in zip(*after):
        ulp = torch.nextafter(a.abs(), inf) - a.abs() if name in FMA_ROUNDED else 0.0
        assert float(((b - a).abs() - ulp).clamp(min=0).max()) <= RUNTIME_OPT_TOL * top


def test_prefetch_to_device_yields_the_host_batches(cuda):
    from deepcv_tpu_torch.data.pipeline import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (64, 8, 8, 3), dtype=np.uint8),
                rng.integers(0, 10, 64).astype(np.int32)) for _ in range(7)]
    got = []
    for x, y in prefetch_to_device(iter(batches), size=2, device=cuda):
        assert x.device.type == "cuda"
        torch.cuda._sleep(2_000_000)        # the consumer busy while copies queue
        got.append((x.cpu().numpy(), y.cpu().numpy()))
    assert len(got) == len(batches)
    for (a, b), (c, d) in zip(got, batches):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


@pytest.mark.parametrize("mode,per_step", [(False, 5), (True, 10), ("dots", 5)])
def test_k2_launches_per_step_under_remat(cuda, tmp_path, mode, per_step):
    """image_classifier in bf16: 5 K2 launches a training step, 10 when the
    backward recomputes the forward, 5 when remat keeps the convs' outputs."""
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.data.datasets import ArrayDataset
    from deepcv_tpu_torch.data.preprocess import preprocess
    from deepcv_tpu_torch.pipelines.classification import create_model
    from deepcv_tpu_torch.train.losses import cross_entropy_loss
    from deepcv_tpu_torch.train.training import train

    rng = np.random.default_rng(0)
    data = preprocess({"trainset": ArrayDataset(
        rng.integers(0, 256, (80, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, 80).astype(np.int64), classes=[str(i) for i in range(10)])},
        {"seed": 0, "split_dataset": {"validset_ratio": 0.2}, "transforms": ["to_tensor"]})
    hp = load_yaml("conf/base/parameters.yml")["image_classifier_model"]
    model = create_model(data, {**hp, "dtype": "bfloat16"}, device=cuda)
    before = fused_conv2d_bias_act.launches
    _, h = train({"epochs": 1, "batch_size": 16, "optimizer_opts": {"lr": 1e-3},
                  "save_every_iters": 0, "validate_every_epochs": 1000, "remat": mode,
                  "output_path": str(tmp_path), "handle_preemption": False},
                 model, cross_entropy_loss, data)
    assert h["steps"] == 4
    assert fused_conv2d_bias_act.launches - before == per_step * h["steps"]


def test_streaming_train_first_losses_on_card_match_cpu(cuda, tmp_path):
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.data.datasets import load_dataset
    from deepcv_tpu_torch.data.preprocess import preprocess
    from deepcv_tpu_torch.pipelines.classification import create_model
    from deepcv_tpu_torch.train.losses import cross_entropy_loss
    from deepcv_tpu_torch.train.training import TrainingEvents, train

    rng = np.random.default_rng(1)
    np.save(tmp_path / "images.npy", rng.integers(0, 256, (600, 32, 32, 3), dtype=np.uint8))
    np.save(tmp_path / "targets.npy", rng.integers(0, 10, 600).astype(np.int32))
    data = preprocess({"trainset": load_dataset({"type": "memmap", "root": str(tmp_path),
                                                 "classes": [str(i) for i in range(10)]})},
                      {"seed": 0, "split_dataset": {"validset_ratio": 0.03},
                       "transforms": ["to_tensor"]})
    hp = load_yaml("conf/base/parameters.yml")["image_classifier_model"]
    init = create_model(data, hp, device="cpu").state_dict()
    losses = {}
    for dev in ("cpu", cuda):
        model = create_model(data, {**hp, "dtype": "bfloat16"}, device=dev)
        model.load_state_dict(init)
        events, seen = TrainingEvents(), []
        events.on("iteration_completed", lambda state, metrics, _s=seen:
                  _s.append(float(metrics["main_loss"])))
        _, h = train({"epochs": 1, "batch_size": 128, "optimizer_opts": {"lr": 1e-3},
                      "save_every_iters": 0, "validate_every_epochs": 1000,
                      "dtype": "bfloat16", "output_path": str(tmp_path),
                      "handle_preemption": False}, model, cross_entropy_loss, data,
                     events=events)
        assert h["input_path"] == "streaming"
        losses[str(dev)] = seen
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=BF16_TOL)


@pytest.mark.parametrize("sampling", ["softmax", "sampled", "uniform"])
def test_supernet_step_on_card_matches_cpu(cuda, sampling):
    """One float32 SGD step of the NAS supernet on the card and on the CPU
    from the same weights and draws (one CPU generator seeded alike): the
    loss, every gradient (the arch__ logits' among them, but under uniform
    sampling) and the updated parameters within F32_TOL of their largest."""
    from chip_smoke import nas_classifier_hp
    from deepcv_tpu_torch.spec import DeepcvModule

    hp = nas_classifier_hp(32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 16))
    init = DeepcvModule((32, 32, 3), hp, nas_mode="supernet", nas_sampling=sampling,
                        device="cpu").state_dict()
    out = {}
    for dev in ("cpu", cuda):
        m = DeepcvModule((32, 32, 3), hp, nas_mode="supernet", nas_sampling=sampling,
                         device=dev)
        m.load_state_dict(init)
        inner = m.module.nodes["_submodule_0_nested"]
        inner.generator = torch.Generator().manual_seed(0)    # the same draws on both
        loss = F.cross_entropy(m(x.to(dev)), y.to(dev))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()
                 if p.grad is not None}
        with torch.no_grad():
            for p in m.parameters():
                if p.grad is not None:
                    p -= 0.1 * p.grad
        out[str(dev)] = (float(loss), grads, {k: v.cpu() for k, v in m.state_dict().items()})
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= F32_TOL * abs(lc)
    assert set(gg) == set(gc)
    # uniform (SPOS) paths give the logits no gradient; the other two do
    assert any("arch__" in k for k in gc) == (sampling != "uniform")
    for k, ref in gc.items():
        assert _rel(gg[k], ref) <= F32_TOL or float(ref.abs().max()) == 0.0, k
    for k, ref in sc.items():
        if ref.is_floating_point() and float(ref.abs().max()) > 0:
            assert _rel(sg[k], ref) <= F32_TOL, k


def test_supernet_forward_launches_k2_once_per_candidate_conv(cuda):
    """A supernet forward runs every candidate: one K2 launch per stride-1
    odd conv of the spec, each mutable_layer_1 candidate included (13)."""
    from chip_smoke import nas_classifier_hp
    from deepcv_tpu_torch.ops.nn import FusedConv2d
    from deepcv_tpu_torch.spec import DeepcvModule

    for mode, convs in (("supernet", 13), ("fixed", 11)):
        m = DeepcvModule((32, 32, 3), nas_classifier_hp(32), nas_mode=mode, device=cuda,
                         dtype="bfloat16").eval()
        assert sum(isinstance(mod, FusedConv2d) for mod in m.modules()) == convs
        before = fused_conv2d_bias_act.launches
        with torch.no_grad():
            m(torch.zeros(8, 32, 32, 3, device=cuda))
        torch.cuda.synchronize()
        assert fused_conv2d_bias_act.launches - before == convs


# --------------------------------------------------------------------------- #
# The data plane: the wire codec, the C++ loader, the codec, SinGAN, WFC
# --------------------------------------------------------------------------- #

def _walk_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, (n, 32, 32, 3)).astype(np.int16)
    walk = np.cumsum(steps, axis=2) + rng.integers(0, 256, (n, 32, 1, 3))
    x = np.abs(walk % 510 - 255).astype(np.uint8)
    spikes = rng.random(x.shape) < 0.01
    x[spikes] = 255 - x[spikes]
    return x


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_wire_decode_on_card_equals_the_host_batch(cuda, bits):
    from deepcv_tpu_torch.data.wirecodec import decode_u8, device_decode, encode_u8

    x = _walk_batch(seed=bits)
    payload = encode_u8(x, bits=bits, axis=-2)
    assert payload is not None and np.count_nonzero(payload["overflow"])
    got = device_decode(payload, cuda)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), torch.from_numpy(x))
    cpu = decode_u8(torch.from_numpy(payload["packed"]), torch.from_numpy(payload["overflow"]),
                    payload["shape"], bits, payload["axis"])
    assert torch.equal(got.cpu(), cpu)


def test_prefetch_with_the_wire_codec_yields_the_host_batches(cuda):
    from deepcv_tpu_torch.data.pipeline import prefetch_to_device, wire_stats

    rng = np.random.default_rng(0)
    batches = [(_walk_batch(seed=i), rng.integers(0, 10, 64).astype(np.int32))
               for i in range(5)]
    batches.append((rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8),
                    rng.integers(0, 10, 64).astype(np.int32)))     # noise: shipped raw
    wire_stats.clear()
    got = []
    for x, y in prefetch_to_device(iter(batches), size=2, device=cuda,
                                   wire_codec={"bits": 3, "axis": -2}):
        torch.cuda._sleep(1_000_000)
        got.append((x.cpu().numpy(), y.cpu().numpy()))
    assert wire_stats["coded"] == 5 and wire_stats["raw"] == 1
    for (a, b), (c, d) in zip(got, batches):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


def test_streaming_train_on_card_takes_the_cxx_loader_and_the_codec(cuda, tmp_path):
    from deepcv_tpu_torch.config import load_yaml
    from deepcv_tpu_torch.data.datasets import load_dataset
    from deepcv_tpu_torch.data.pipeline import wire_stats
    from deepcv_tpu_torch.data.preprocess import preprocess
    from deepcv_tpu_torch.pipelines.classification import create_model
    from deepcv_tpu_torch.train.losses import cross_entropy_loss
    from deepcv_tpu_torch.train.training import train

    np.save(tmp_path / "images.npy", _walk_batch(600))
    np.save(tmp_path / "targets.npy", np.random.default_rng(1).integers(0, 10, 600)
            .astype(np.int32))
    data = preprocess({"trainset": load_dataset({"type": "memmap", "root": str(tmp_path),
                                                 "classes": [str(i) for i in range(10)]})},
                      {"seed": 0, "split_dataset": {"validset_ratio": 0.03},
                       "transforms": ["to_tensor"]})
    hp = load_yaml("conf/base/parameters.yml")["image_classifier_model"]
    init = create_model(data, hp, device="cpu").state_dict()
    runs = {}
    for wire in (False, True):
        model = create_model(data, {**hp, "dtype": "bfloat16"}, device=cuda)
        model.load_state_dict(init)
        wire_stats.clear()
        _, h = train({"epochs": 1, "batch_size": 128, "optimizer_opts": {"lr": 1e-3},
                      "save_every_iters": 0, "validate_every_epochs": 1000,
                      "dtype": "bfloat16", "output_path": str(tmp_path),
                      "handle_preemption": False, "wire_compression": wire},
                     model, cross_entropy_loss, data)
        assert h["input_path"] == "streaming" and h["host_loader"] == "native"
        assert wire_stats["coded"] == (h["steps"] if wire else 0)
        runs[wire] = [e["main_loss"] for e in h["train"]]
    np.testing.assert_allclose(runs[True], runs[False], rtol=BF16_TOL)


def test_codec_roundtrips_on_card_with_the_native_coder(cuda):
    from deepcv_tpu_torch.codec import LosslessCodec

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:16, 0:16]
    imgs = ((yy + xx)[None, ..., None] * rng.integers(2, 6, (12, 1, 1, 1)) % 64 + 96
            + rng.integers(0, 4, (12, 16, 16, 3))).astype(np.uint8)
    codec = LosslessCodec((16, 16, 3), n_scales=2, hidden=8, seed=0, coding_batch=4,
                          device=cuda)
    codec.fit(imgs[:8], steps=30, batch_size=8, seed=0)
    assert codec.native_coder
    blobs = codec.encode_batch(imgs[8:])
    assert np.array_equal(codec.decode_batch(blobs), imgs[8:])
    cpu = LosslessCodec((16, 16, 3), n_scales=2, hidden=8, seed=0, coding_batch=4,
                        device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in codec.model.state_dict().items()})
    assert codec.bits_per_dim(imgs[8:]) == pytest.approx(cpu.bits_per_dim(imgs[8:]), rel=1e-4)


def test_singan_and_wfc_on_card(cuda):
    from deepcv_tpu_torch.data import wfc
    from deepcv_tpu_torch.data.singan import ConvStack, train_singan

    stack = ConvStack(3, 8, 3, final_act="tanh")
    stack.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((2, 12, 10, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = stack(x)
        got = stack.to(cuda)(x.to(cuda)).cpu()
    assert _rel(got, ref) <= F32_TOL
    img = (np.add.outer(np.arange(16), np.arange(16))[..., None] * [8, 4, 2] % 256
           ).astype(np.uint8)
    model, hist = train_singan(img, n_scales=2, steps_per_scale=20, features=8, device=cuda)
    assert all(s["rec_last"] < s["rec_first"] for s in hist["scales"])
    assert model.reconstruct().device.type == "cuda"
    exemplar = np.array([[0, 0, 1, 2, 2], [0, 1, 1, 2, 2], [1, 1, 2, 2, 2]], np.int32)
    adj, w = wfc.adjacency_from_exemplar(exemplar)
    maps = wfc.sample_tilemaps(adj, w, (12, 12), 4, torch.Generator(device=cuda).manual_seed(0),
                               device=cuda)
    assert all(wfc.validate_tilemap(m, adj) for m in maps)


# --------------------------------------------------------------------------- #
# Active learning, boosting, Reptile and profiling on the card
# --------------------------------------------------------------------------- #

def _tiny_gn_hp(classes=4):
    return {"act_fn": "relu", "group_norm": {"num_groups": 2, "eps": 1e-5},
            "architecture": [
                {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
                {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
                {"flatten": {}},
                {"fully_connected": {"out_features": classes, "act_fn": None,
                                     "group_norm": None}}]}


def _pair(hp, shape, cuda):
    from deepcv_tpu_torch.spec import DeepcvModule

    gpu = DeepcvModule(shape, hp, device=cuda)
    cpu = DeepcvModule(shape, hp, device="cpu")
    return gpu, cpu


def _rel_l2_state(got, ref):
    """||got - ref|| / ||ref|| over all of the models' tensors at once: the
    conv biases ahead of group norm stay near 0 and take noise-level
    gradients, so a tensor-wise relative error would read their noise."""
    r = ref.state_dict()
    diff = sum(float((t.double().cpu() - r[k].double()).square().sum())
               for k, t in got.state_dict().items())
    return (diff / sum(float(t.double().square().sum()) for t in r.values())) ** 0.5


def test_reptile_meta_steps_on_card_match_cpu(cuda):
    """In-place inner steps keep K2's packed weights current: the card's
    meta parameters equal the CPU's after 2 meta-steps, with 2 K2 launches
    per forward."""
    from deepcv_tpu_torch.train import meta_learning as meta

    rng = np.random.default_rng(0)
    images = rng.normal(size=(60, 12, 12, 3)).astype(np.float32)
    labels = np.repeat(np.arange(6), 10)
    gpu, cpu = _pair(_tiny_gn_hp(), (12, 12, 3), cuda)
    kw = dict(n_way=4, k_shot=3, q_queries=2, meta_steps=2, meta_batch=3, inner_steps=3,
              inner_lr=0.1, seed=1)
    before = fused_conv2d_bias_act.launches
    meta.reptile_train(gpu, images, labels, **kw)
    assert fused_conv2d_bias_act.launches - before == 2 * 2 * 3 * (3 + 1)
    meta.reptile_train(cpu, images, labels, **kw)
    assert _rel_l2_state(gpu, cpu) <= F32_TOL
    adapted = meta.adapt(gpu, images[:8], labels[:8] % 4, steps=2, lr=0.1)
    ref = meta.adapt(cpu, images[:8], labels[:8] % 4, steps=2, lr=0.1)
    assert _rel_l2_state(adapted, ref) <= F32_TOL


def test_boosting_round_and_scoring_on_card_match_cpu(cuda):
    from deepcv_tpu_torch.data.datasets import ArrayDataset
    from deepcv_tpu_torch.data.preprocess import PreprocessedDataset, \
        parse_transforms_specification
    from deepcv_tpu_torch.train import active_learning as al
    from deepcv_tpu_torch.train import boosting

    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, (40, 12, 12, 3), dtype=np.uint8)
    y = torch.from_numpy(rng.integers(0, 4, 40))
    gpu, cpu = _pair(_tiny_gn_hp(), (12, 12, 3), cuda)
    batches = [torch.from_numpy(rng.integers(0, 40, 16)) for _ in range(3)]
    fitted = []
    for m in (gpu, cpu):
        dev = next(m.parameters()).device
        x = torch.from_numpy(raw).float().div(255).to(dev)
        w = torch.full((40,), 1 / 40, device=dev)
        boosting._train_round(m, x, y.to(dev), w, batches, lr=0.05, momentum=0.9,
                              generator=torch.Generator(device=dev))
        fitted.append(boosting._reweight(w, boosting._predict(m, None, x, 16), y.to(dev), 4))
    assert _rel_l2_state(gpu, cpu) <= F32_TOL
    assert float(fitted[0][1]) == pytest.approx(float(fitted[1][1]), rel=F32_TOL)
    pool = PreprocessedDataset(ArrayDataset(raw, y.numpy()),
                               parse_transforms_specification(["to_tensor"]))
    p_gpu = al.mc_class_probabilities(gpu, pool, np.arange(13), n_samples=2, batch_size=5)
    p_cpu = al.mc_class_probabilities(cpu, pool, np.arange(13), n_samples=2, batch_size=5)
    assert np.abs(p_gpu - p_cpu).max() <= F32_TOL


def test_profile_op_breakdown_lists_k2_on_card(cuda):
    from deepcv_tpu_torch import profiling

    gpu, _ = _pair(_tiny_gn_hp(), (12, 12, 3), cuda)
    x = torch.randn(8, 12, 12, 3, device=cuda)
    with torch.no_grad():
        rows = profiling.profile_op_breakdown(gpu, x, iters=3, top=0)
    k2 = [r for r in rows if "fused_conv2d_bias_act" in r["op"]]
    assert sum(r["count"] for r in k2) == 2 * 3 and all(r["plane"].startswith("GPU") for r in k2)
    assert profiling.model_flops(gpu, batch_size=2)["flops_per_image"] == \
        2 * (12 * 12 * 3 * 8 * 9 + 12 * 12 * 8 * 8 * 9 + 12 * 12 * 8 * 4)
    assert profiling.check_determinism(lambda t: gpu(t), x) == 0.0
    assert "cuda:0" in profiling.device_memory_stats()

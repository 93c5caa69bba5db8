"""The port's compression (``deepcv_tpu_torch/compression.py`` and the spec
engine's ``quantize``) against the JAX package, on the CPU.

* the plain version of the ``int8_conv`` kernel against JAX's
  ``int8_conv_general_dilated`` (codes and int32 sums equal; outputs within
  1e-6 relative in float32, one bfloat16 ulp in bfloat16), and the int8
  dense against ``int8_dot_general``;
* ``calibrate_int8_scales``: JAX's key set, values within 1e-6 relative, on
  a narrow wide classifier, a 2-stage ResNet, a 2-block ViT and a 1-stage
  Swin (with ``reduce``);
* whole int8 builds (static and dynamic scales) against the JAX builds in
  float32 within rel L2 1e-4, and the one deliberate difference, the
  padded stem rows' share of the weight scale;
* QAT (``int8_qat``, ``int4_qat``): forward within 1e-4 and first-step
  gradients within rtol 1e-3 (``tests/test_torch_parity.py``'s bounds);
  the inference-only refusals;
* pruning and per-tensor PTQ equal to JAX's.
"""
import copy
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from deepcv_tpu import compression as jc
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu_torch import compression as tc
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.ops.kernels import int8_conv as k8
from deepcv_tpu_torch.pipelines.classification import create_model
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import resnet_spec, swin_spec, vit_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
INT8_TOL = 1e-4       # whole int8 builds, rel L2, float32
OP_RTOL = 1e-6        # one int8 op in float32: the same codes, the same rescale
CAL_RTOL = 1e-6       # calibrated scales: float forwards a few ulps apart
BF16_ULP = 2.0 ** -7  # one bfloat16 ulp, relative
TIE_TOL = 2e-2        # whole int8 builds where an activation code sat on a rounding tie


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


# --------------------------------------------------------------------------- #
# The int8 conv and dense ops against JAX's
# --------------------------------------------------------------------------- #

#: (spatial, channels, out, kernel, stride, padding, dilation, groups[,
#: label]); the labelled ones are edge shapes of the tensor-core route
#: (groups 1): a 3-channel 3x3 (byte-by-byte A), 72 channels out on 3 x 9 x
#: 13 pixels (neither a multiple of its tile), a 1x1 at 64 -> 128 (16-byte
#: A, one stage of K), dilation 2 at 16 channels (four taps a stage), 3-d
CONV_CASES = [
    ((9, 11), 8, 16, (3, 3), 1, 1, 1, 1),
    ((9, 11), 8, 16, (3, 3), 2, 1, 1, 1),
    ((10, 10), 12, 8, (3, 3), 1, 2, 2, 1),
    ((8, 9), 8, 12, (3, 3), 1, 1, 1, 2),
    ((8, 9), 16, 16, (3, 3), 2, 1, 1, 16),          # depthwise
    ((16, 16), 3, 8, (7, 7), 2, 3, 1, 1),           # a stem
    ((8, 8), 16, 32, (1, 1), 2, 0, 1, 1),           # a downsample 1x1
    ((13,), 6, 10, (5,), 2, 2, 1, 1),               # 1-d
    ((4, 6, 5), 4, 6, (3, 3, 3), (1, 2, 2), 1, 1, 2),  # 3-d, grouped
    ((9, 11), 3, 16, (3, 3), 1, 1, 1, 1, "c3"),
    ((9, 13), 16, 72, (3, 3), 1, 1, 1, 1, "o72"),
    ((8, 8), 64, 128, (1, 1), 1, 0, 1, 1, "1x1"),
    ((10, 9), 16, 24, (3, 3), 1, 2, 2, 1, "c16"),
    ((4, 6, 5), 16, 8, (3, 3, 3), 1, 1, 1, 1, "tc"),
]


def _case_id(c):
    return f"{len(c[0])}d-s{c[4]}-d{c[6]}-g{c[7]}" + (f"-{c[8]}" if len(c) > 8 else "")
_DN = {1: ("NWC", "WIO", "NWC"), 2: ("NHWC", "HWIO", "NHWC"), 3: ("NDHWC", "DHWIO", "NDHWC")}


def _conv_operands(case, dtype, seed=0):
    spatial, cin, cout, ks, *_ = case
    groups = case[7]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, *spatial, cin)).astype(np.float32)
    w = (rng.normal(size=(*ks, cin // groups, cout)) * 0.2).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        w = w.astype(ml_dtypes.bfloat16)
    return x, w


def _torch(a):
    """numpy (float32 or bfloat16) -> tensor of the same dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_layout(x, w):
    """NHWC / HWIO numpy -> the port's (N, C, *sp) and (O, I/g, *k) tensors."""
    rank = x.ndim - 2
    return _torch(x).movedim(-1, 1), _torch(w).permute(rank + 1, rank, *range(rank))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=_case_id)
def test_plain_int8_conv_matches_jax(case, dtype):
    spatial, cin, cout, ks, stride, pad, dil, groups = case[:8]
    rank = len(spatial)
    stride = (stride,) * rank if isinstance(stride, int) else stride
    x, w = _conv_operands(case, dtype)
    tx, tw = _port_layout(x, w)
    for act_scale in (None, 0.021):
        # the codes
        if act_scale is None:
            jq, js = jc._quant_sym(jnp.asarray(x), axes=None)
            tq, ts = tc._quant_sym(tx)
        else:
            jq, js = jc._quant_static(jnp.asarray(x), act_scale)
            tq, ts = tc._quant_static(tx, act_scale)
        np.testing.assert_array_equal(tq.movedim(1, -1).numpy(), np.asarray(jq))
        assert float(ts) == float(np.asarray(js).reshape(()))
        jwq, jws = jc._quant_sym(jnp.asarray(w), axes=tuple(range(rank + 1)))
        twq, tws = tc.quantize_weight(tw)
        np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).transpose(
            rank + 1, rank, *range(rank)))
        np.testing.assert_array_equal(tws.numpy(), np.asarray(jws).reshape(-1))
        # the int32 sums
        jacc = jax.lax.conv_general_dilated(
            jq, jwq, stride, [(pad, pad)] * rank, rhs_dilation=(dil,) * rank,
            dimension_numbers=_DN[rank], feature_group_count=groups,
            preferred_element_type=jnp.int32)
        tacc = k8.int8_conv(tq, twq, ts, tws, stride, pad, dil, groups, return_acc=True)
        assert tacc.dtype == torch.int32
        np.testing.assert_array_equal(tacc.movedim(1, -1).numpy(), np.asarray(jacc))
        # the op
        ref = np.asarray(jc.int8_conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), stride, [(pad, pad)] * rank,
            rhs_dilation=(dil,) * rank, dimension_numbers=_DN[rank],
            feature_group_count=groups, act_scale=act_scale)).astype(np.float32)
        got = tc.int8_conv_nd(tx, tw, stride, pad, dil, groups, act_scale)
        assert got.dtype == tx.dtype
        got = got.float().movedim(1, -1).numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=OP_RTOL, atol=0)
        else:
            np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(5,), (2, 7)], ids=["rows", "tokens"])
def test_int8_dense_matches_jax(lead, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(*lead, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 10)) * 0.3).astype(np.float32)
    if dtype == "bfloat16":
        x, w = x.astype(ml_dtypes.bfloat16), w.astype(ml_dtypes.bfloat16)
    tx, tw = _torch(x), _torch(w).t()
    dn = (((x.ndim - 1,), (0,)), ((), ()))
    for act_scale in (None, 0.017):
        jq, js = (jc._quant_sym(jnp.asarray(x), axes=None) if act_scale is None
                  else jc._quant_static(jnp.asarray(x), act_scale))
        jwq, _ = jc._quant_sym(jnp.asarray(w), axes=(0,))
        jacc = jax.lax.dot_general(jq, jwq, dn, preferred_element_type=jnp.int32)
        tq, _ = tc._quant_sym(tx) if act_scale is None else tc._quant_static(tx, act_scale)
        twq, _ = tc.quantize_weight(tw)
        np.testing.assert_array_equal(twq.t().numpy(), np.asarray(jwq))
        tacc = tc._int_mm(tq.reshape(-1, 24), twq).reshape(*lead, 10)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        ref = np.asarray(jc.int8_dot_general(jnp.asarray(x), jnp.asarray(w), dn,
                                             act_scale=act_scale)).astype(np.float32)
        got = tc.int8_dense(tx, tw, act_scale)
        assert got.dtype == tx.dtype
        tol = OP_RTOL if dtype == "float32" else BF16_ULP
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=0)


def test_int8_dense_refuses_other_contractions_as_jax_does():
    x = jnp.ones((4, 6), jnp.float32)
    with pytest.raises(NotImplementedError, match="Dense contraction only"):
        jc.int8_dot_general(x, jnp.ones((5, 6)), (((1,), (1,)), ((), ())))
    with pytest.raises(NotImplementedError, match="Dense contraction only"):
        tc.int8_dense(torch.ones(4, 6), torch.ones(6, 5, 2))
    with pytest.raises(NotImplementedError, match="Dense contraction only"):
        tc.int8_dense(torch.ones(4, 6), torch.ones(5, 4))
    with pytest.raises(NotImplementedError, match="Dense contraction only"):
        tc.fake_quant_dense(torch.ones(4, 6), torch.ones(5, 4))


def test_int8_conv_wrapper_checks_its_operands():
    xq = torch.zeros(1, 4, 5, 5, dtype=torch.int8)
    wq = torch.zeros(8, 4, 3, 3, dtype=torch.int8)
    s = torch.ones(()), torch.ones(8)
    assert k8.int8_conv(xq, wq, *s, padding=1).shape == (1, 8, 5, 5)
    with pytest.raises(TypeError, match="int8 codes"):
        k8.int8_conv(xq.float(), wq, *s)
    with pytest.raises(ValueError, match="channels do not fit"):
        k8.int8_conv(xq, wq, *s, groups=2)
    with pytest.raises(ValueError, match="scales"):
        k8.int8_conv(xq, wq, torch.ones(()), torch.ones(4))
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="out_dtype"):
            k8.int8_conv(xq, wq, *s, out_dtype=dtype)
    assert k8.launch_plan(64, 64) == (16, 8) and k8.launch_plan(3, 64) == (1, 8)
    assert k8.launch_plan(1, 1) == (1, 1) and k8.launch_plan(12, 12) == (4, 4)
    assert k8.launch_plan(32, 3) == (4, 1)        # no 16-byte loads at one channel
    assert k8.pack_weight(wq).shape == (8, 3, 3, 4)


# --------------------------------------------------------------------------- #
# The tensor-core route's packing, tiling and index arithmetic
# --------------------------------------------------------------------------- #

def _kpos(k, c, kh, kw):
    """csrc KPos.decode: K position -> (channel, kx, ky, kz)."""
    tap, cc = divmod(k, c)
    return cc, tap % kw, (tap // kw) % kh, tap // (kw * kh)


def _kpos_advance(pos, c, kh, kw):
    """csrc KPos.advance: 64 channels on, across taps."""
    cc, kx, ky, kz = pos
    cc += k8.TC_BK
    while cc >= c:
        cc -= c
        kx += 1
        if kx == kw:
            kx, ky = 0, ky + 1
            if ky == kh:
                ky, kz = 0, kz + 1
    return cc, kx, ky, kz


def _emulate_tc_acc(xq, wq, stride, padding, dilation):
    """The tensor-core kernel's int32 sums by its own index arithmetic (csrc
    RowPos, KPos, the loader's 16-byte chunks with zero fill, the K tail):
    A (pixels, kpad) gathered from the channels-last codes, times
    pack_weight_tc's rows. A channel count that is a multiple of 16 walks
    each chunk's K position by KPos.advance, as the 16-byte loader does,
    and it must equal the decode of the position."""
    route, osp, dims, (kpad, bn) = k8.launch_args(xq.shape, wq.shape, stride, padding,
                                                  dilation, 1)
    assert route == "tensor_core" and kpad % k8.TC_BK == 0
    n, d, h, w, c, o, od, oh, ow, kd, kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw, _ = dims
    x = xq.movedim(1, -1).reshape(-1).numpy().astype(np.int64)
    m = np.arange(n * od * oh * ow)
    ox, r = m % ow, m // ow
    oy, r = r % oh, r // oh
    oz, nb = r % od, r // od
    iz0, iy0, ix0 = oz * sd - pd, oy * sh - ph, ox * sw - pw
    base = (((nb * d + iz0) * h + iy0) * w + ix0) * c
    kdim = c * kd * kh * kw
    a = np.zeros((len(m), kpad), np.int64)
    for chunk in range(4):                         # the loader's 16-byte column
        pos = _kpos(16 * chunk, c, kh, kw)
        for k0 in range(16 * chunk, kpad, k8.TC_BK):
            for b in range(16):
                k = k0 + b
                if k >= kdim:
                    continue
                cc, kx, ky, kz = _kpos(k, c, kh, kw)
                if c % 16 == 0 and b == 0:
                    assert pos == (cc, kx, ky, kz), (k, pos)
                dz, dy, dx = kz * dd, ky * dh, kx * dw
                inside = ((0 <= iz0 + dz) & (iz0 + dz < d) & (0 <= iy0 + dy) & (iy0 + dy < h)
                          & (0 <= ix0 + dx) & (ix0 + dx < w))
                off = base + ((dz * h + dy) * w + dx) * c + cc
                a[inside, k] = x[off[inside]]
            if c % 16 == 0:
                pos = _kpos_advance(pos, c, kh, kw)
    wt = k8.pack_weight_tc(wq).numpy().astype(np.int64)
    acc = a @ wt.T
    return torch.from_numpy(acc.reshape(n, *osp, o)).movedim(-1, 1).to(torch.int32)


@pytest.mark.parametrize("case", [c for c in CONV_CASES if c[7] == 1], ids=_case_id)
def test_tc_route_arithmetic_equals_plain(case):
    """The kernel's gather, K order and packing give the plain version's
    int32 sums, codes at both ends of the range."""
    spatial, cin, cout, ks, stride, pad, dil, _ = case[:8]
    rank = len(spatial)
    stride = (stride,) * rank if isinstance(stride, int) else stride
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, cin, *spatial)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, *ks)).astype(np.int8))
    xq.view(-1)[:7] = -127
    s = torch.ones(()), torch.ones(cout)
    args = (stride, (pad,) * rank, (dil,) * rank)
    ref = k8.plain_int8_conv(xq, wq, *s, stride, pad, dil, 1, return_acc=True)
    assert torch.equal(_emulate_tc_acc(xq, wq, *args), ref)


def test_tc_packing():
    """pack_weight_tc: (O, kpad), K in pack_weight's order, zeros in the K
    tail; equal to pack_weight's rows where taps x C is a multiple of the
    stage depth; pack_weight_for follows the route."""
    rng = np.random.default_rng(6)
    for shape in ((8, 3, 7, 7), (72, 16, 3, 3), (16, 64, 1, 1), (8, 16, 3, 3, 3), (10, 6, 5),
                  (4, 512, 3, 3)):
        wq = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        o, kdim = shape[0], int(np.prod(shape[1:]))
        packed = k8.pack_weight_tc(wq)
        kpad = -(-kdim // k8.TC_BK) * k8.TC_BK
        assert packed.shape == (o, kpad) and packed.dtype == torch.int8
        assert packed.is_contiguous() and kpad - kdim < k8.TC_BK
        assert torch.equal(packed[:, :kdim], k8.pack_weight(wq).reshape(o, kdim))
        assert not packed[:, kdim:].any()
        if kdim % k8.TC_BK == 0:
            assert torch.equal(packed, k8.pack_weight(wq).reshape(o, kdim))
        assert torch.equal(k8.pack_weight_for(wq, 1), packed)
    dw = torch.zeros((16, 1, 3, 3), dtype=torch.int8)
    assert torch.equal(k8.pack_weight_for(dw, 16), k8.pack_weight(dw))
    assert k8.pack_weight_for(dw, 16).shape == (16, 3, 3, 1)


def test_tc_plan_fits_the_channel_block():
    """BN pads O the least, 128 on a tie: the 64-channel layers take 64; K
    pads to whole 64-byte stages; the shared memory is the ring or the
    staged int32 tile, whichever is larger."""
    assert k8.tc_plan(64, 27) == (64, 64) and k8.tc_plan(64, 147) == (64, 192)
    assert k8.tc_plan(128, 576) == (128, 576) and k8.tc_plan(512, 4608) == (128, 4608)
    assert k8.tc_plan(72, 144).bn == 128                      # 128 padded either way
    assert k8.tc_plan(8, 64).bn == 64 and k8.tc_plan(192, 64).bn == 64
    assert k8.tc_plan(256, 64).bn == 128 and k8.tc_plan(2048, 64).bn == 128
    assert {bn: k8.tc_smem_bytes(bn) for bn in k8.TC_BN} == {128: 69632, 64: 49152}


def _config8_convs(name):
    """(input shape, weight shape, stride, padding, dilation, groups) of each
    int8 conv of one config 8 forward, from the meta device, as
    chip_smoke.int8_model_convs reads them."""
    if name == "wide":
        hp = copy.deepcopy(dict(load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))
                                ["wide_classifier_model"]))
        hp["architecture"][-1]["fully_connected"]["out_features"] = 10
        shape, batch = (32, 32, 3), 4096
    else:
        hp, shape, batch = resnet_spec(50, num_classes=1000, pool_kernel=7), (224, 224, 3), 256
    model = DeepcvModule(shape, hp, device="meta", quantize="int8")
    convs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: convs.append((tuple(a[0].shape), tuple(mod.weight.shape), mod.stride,
                                     mod.padding, mod.dilation, mod.groups)))
        for m in model.modules() if isinstance(m, dnn.Conv2d) and m.quant is not None]
    with torch.no_grad():
        model(torch.empty((batch, *shape), device="meta"))
    for hk in hooks:
        hk.remove()
    return convs


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@pytest.mark.parametrize("name,count,bn64", [("wide", 6, 2), ("resnet50", 53, 7)])
def test_config8_convs_take_the_tensor_cores(name, count, bn64):
    """Every conv of config 8's two int8 forwards is ungrouped and takes the
    tensor-core route, BN 64 exactly where O is 64 (the wide's first two,
    ResNet-50's stem and its six 64-channel convs), kpad the taps x C
    rounded up to 64 (the stems' 27 and 147 -> 64 and 192)."""
    convs = _config8_convs(name)
    assert len(convs) == count
    bns = []
    for xs, ws, stride, pad, dil, groups in convs:
        r, osp, dims, (kpad, bn) = k8.launch_args(xs, ws, _pair(stride), _pair(pad),
                                                  _pair(dil), groups)
        kdim = int(np.prod(ws[1:]))
        assert r == "tensor_core" and groups == 1
        assert kpad == -(-kdim // 64) * 64 and bn == (64 if ws[0] == 64 else 128)
        assert dims[21] == 1 and dims[1] == dims[9] == 1         # 2-d: D = KD = 1
        bns.append(bn)
    assert bns.count(64) == bn64
    stem = k8.launch_args(*convs[0][:2], _pair(convs[0][2]), _pair(convs[0][3]),
                          _pair(convs[0][4]), 1)[3]
    assert stem == ((64, 64) if name == "wide" else (192, 64))


def test_grouped_convs_take_dp4a():
    """A grouped or depthwise conv keeps the __dp4a kernel and its plan."""
    for xs, ws, groups, plan in (((2, 144, 56, 56), (144, 1, 3, 3), 144, (1, 1)),
                                 ((2, 32, 8, 9), (32, 16, 3, 3), 2, (16, 8)),
                                 ((2, 8, 4, 6, 5), (12, 4, 3, 3, 3), 2, (4, 1))):
        rank = len(xs) - 2
        r, _, dims, ints = k8.launch_args(xs, ws, (1,) * rank, (1,) * rank, (1,) * rank, groups)
        assert (r, ints, dims[21]) == ("dp4a", plan, groups)
    assert k8.route(1) == "tensor_core" and k8.route(2) == "dp4a"
    assert k8.ROUTES == ("tensor_core", "dp4a")
    assert k8.int8_conv.launches_by_route == {"tensor_core": 0, "dp4a": 0}


# --------------------------------------------------------------------------- #
# Four models: calibration and whole int8 builds
# --------------------------------------------------------------------------- #

def _wide_hp():
    hp = copy.deepcopy(dict(load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))
                            ["wide_classifier_model"]))
    for entry in hp["architecture"]:
        conv = entry.get("conv2d")
        if conv:
            conv["out_channels"] //= 8                  # 64-256 -> 8-32
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    return hp


def _resnet_hp():
    """ResNet-18 at width 8 cut to its stem and first two stages."""
    hp = resnet_spec(18, width=8, num_classes=5, pool_kernel=4)
    keep = [e for e in hp["architecture"] if isinstance(next(iter(e.values())), list)
            and next(iter(e.values()))[0][:2] in ("st", "s0", "s1")]
    hp["architecture"] = keep + hp["architecture"][-3:]
    return hp


def _vit_hp():
    hp = vit_spec("b_16", num_classes=5)
    arch = [hp["architecture"][0]] + hp["architecture"][1:3] + hp["architecture"][-3:]
    arch[0]["patch_embed"][1].update(patch_size=8, embed_dim=32)
    for row in arch[1:3]:
        row["transformer_block"][1].update(num_heads=4, mlp_dim=64)
    hp["architecture"] = arch
    return hp


def _swin_hp():
    """swin_spec('t') cut to the stem, stage 0 and its patch merging."""
    hp = swin_spec("t", num_classes=5, window=4, stochastic_depth=0.0, pool_kernel=4)
    keep = []
    for entry in hp["architecture"]:
        (key, val), = entry.items()
        if key == "convnext_stem":
            val[1]["dim"] = 16
        if key == "swin_block":
            if not val[0].startswith("s0"):
                continue
            val[1]["num_heads"] = 2
        if key == "patch_merging" and val[0] != "merge1":
            continue
        keep.append(entry)
    hp["architecture"] = keep
    return hp


MODELS = {"wide": _wide_hp, "resnet": _resnet_hp, "vit": _vit_hp, "swin": _swin_hp}


def _stem_node(hp):
    """The flax node of the spec's first layer: ``node_impls_<name>``, or
    ``node_impls__submodule_0_<creator>`` for an unnamed one."""
    (creator, args), = hp["architecture"][0].items()
    return "node_impls_" + (args[0] if isinstance(args, list) else f"_submodule_0_{creator}")


def _zero_padded_stem_rows(jv, hp):
    """The JAX stem kernel's TPU padding rows (input channels 3-7 of an
    image conv) set to 0: inert in float (they meet zero inputs), so no
    float output changes; under int8 they would enter the stem's weight
    scale (see the next test). Only the stem: a later conv's 8 input
    channels are all real."""
    k = jv["params"].get(_stem_node(hp), {}).get("op", {}).get("kernel")
    if k is not None and k.ndim == 4 and k.shape[2] == 8:
        k[:, :, 3:, :] = 0.0
    return jv


def _move_batch_stats(v, seed):
    rng = np.random.default_rng(seed)

    def move(d):
        for k, x in d.items():
            if isinstance(x, dict):
                move(x)
            elif k == "mean":
                d[k] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
            elif k == "var":
                d[k] = rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
    move(v.get("batch_stats", {}))
    return v


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    hp = MODELS[request.param]()
    jm = JaxModule((32, 32, 3), copy.deepcopy(hp))
    jv = _zero_padded_stem_rows(_move_batch_stats(
        _numpy(jm.init(jax.random.PRNGKey(3))), 4), hp)
    tm = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="cpu").eval()
    load_jax_variables(tm, jv)
    x = np.random.default_rng(5).normal(size=(4, 32, 32, 3)).astype(np.float32)
    return request.param, hp, jm, jv, tm, x


def test_calibration_gives_the_jax_keys_and_scales(pair):
    name, hp, jm, jv, tm, x = pair
    jscales = jc.calibrate_int8_scales(jm, jv, [x[:2], x[2:]])
    tscales = tc.calibrate_int8_scales(tm, [x[:2], torch.from_numpy(x[2:])])
    assert set(tscales) == set(jscales)
    for k, v in jscales.items():
        assert abs(tscales[k] - v) <= CAL_RTOL * v, (k, tscales[k], v)
    subs = {k.split("/", 1)[1] for k in jscales if "/" in k}
    expected = {"wide": set(), "resnet": set(), "vit": {"proj", "attn/qkv", "attn/out",
                                                        "mlp/fc1", "mlp/fc2"},
                "swin": {"attn/qkv", "attn/out", "mlp/fc1", "mlp/fc2", "reduce", "proj"}}
    assert subs == expected[name]
    assert not tm.training


def _jax_op_inputs(jq, jv, x, train=False):
    """The input of every conv/dense op of a JAX build, by its spec-node path
    and sub-path (the calibration's key rule)."""
    import flax.linen as fnn

    seen = {}

    def interceptor(next_fn, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and isinstance(mod, (fnn.Conv, fnn.Dense)):
            path = list(mod.path)
            nodes = [c[len("node_impls_"):] for c in path if c.startswith("node_impls_")]
            last = max(i for i, c in enumerate(path) if c.startswith("node_impls_"))
            tail = [c for c in path[last + 1:] if c != "op" and not c.endswith("_op")]
            seen["/".join(nodes + tail)] = np.asarray(args[0])
        return next_fn(*args, **kwargs)

    import flax.linen as fnn
    with fnn.intercept_methods(interceptor):
        out = jq.apply(jv, jnp.asarray(x), train=train)
    return np.asarray(out[0] if train else out), seen


def _port_op_inputs(tq, x):
    seen, hooks = {}, []
    for qualname, op in tq.named_modules():
        if getattr(op, "quant", None) is not None:
            key = tc._calibration_keys(tq, qualname, op)[-1]
            hooks.append(op.register_forward_pre_hook(
                lambda m, a, key=key: seen.__setitem__(key, (m, a[0].detach()))))
    with torch.no_grad():
        out = tq(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    return out, seen


def _code_flips(key, jx, op, tx, first, levels=127):
    """Differing codes of one op's activations, the JAX ones from its own
    float input, the port's from its. In the ``first`` op where any differ,
    every difference is one step at a rounding tie (|x / s - k - 1/2| <
    1e-3); ops after it see inputs that the flip moved. ``levels`` below 127
    is a QAT grid (dynamic scales: max|x| / levels)."""
    if tx.dim() >= 4 or isinstance(op, dnn.Conv2d):   # a feature map: channels last
        tx = tx.movedim(1, -1)
    jx = jx[..., :tx.shape[-1]]                  # the TPU padding channels
    tx = tx.reshape(*jx.shape[:-1], tx.shape[-1])  # patch merging: tokens vs map
    s = op.quant.act_scale
    if levels != 127:
        def grid(v):
            v = np.asarray(v, np.float32)
            sc = np.float32(max(np.abs(v).max(), 1e-12)) / np.float32(levels)
            return np.clip(np.round(v / sc), -levels, levels), sc

        (jq, js), (tq, _) = grid(jx), grid(tx.numpy())
    else:
        jq, js = jc._quant_sym(jnp.asarray(jx), None) if s is None else \
            jc._quant_static(jnp.asarray(jx), s)
        tq, _ = tc._quant_sym(tx) if s is None else tc._quant_static(tx, s)
        tq = tq.numpy()
    jq, tq = np.asarray(jq, np.int32), np.asarray(tq).astype(np.int32)
    diff = jq != tq
    if diff.any() and first:
        assert np.abs(jq - tq).max() == 1
        ratio = jx[diff].astype(np.float64) / float(np.asarray(js).reshape(()))
        assert np.all(np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-3), (key, ratio)
    return int(diff.sum())


def test_int8_model_matches_jax_with_static_and_dynamic_scales(pair):
    """Every op's activation codes equal JAX's but for rounding ties, where
    the two packages' float inputs (a few ulps apart, as any float forward
    of the two) fall on either side of k + 1/2; with no such tie the outputs
    agree within rel L2 1e-4. A tie moves its op's output by one code step,
    so the outputs are then held to TIE_TOL."""
    name, hp, jm, jv, tm, x = pair
    scales = jc.calibrate_int8_scales(jm, jv, [x])
    for quantize_scales in (None, scales):
        jq = JaxModule((32, 32, 3), copy.deepcopy(hp), quantize="int8",
                       quantize_scales=quantize_scales)
        ref, jinputs = _jax_op_inputs(jq, jv, x)
        tq = tm.with_options(quantize="int8", quantize_scales=quantize_scales)
        assert not tq.training and not any(isinstance(m, dnn.FusedConv2d)
                                           for m in tq.modules())
        got, tinputs = _port_op_inputs(tq, x)
        assert tinputs and set(tinputs) <= set(jinputs)     # the convnext stem stays float
        flips = 0
        for key, (op, tx) in tinputs.items():          # in the order they ran
            flips += _code_flips(key, jinputs[key], op, tx, first=flips == 0)
        tol = INT8_TOL if flips == 0 else TIE_TOL
        assert _rel(got, ref) <= tol, (name, quantize_scales is not None, flips)
        # the float model is untouched: with_options shares its tensors
        assert tq.state_dict()[next(iter(tq.state_dict()))].data_ptr() == \
            tm.state_dict()[next(iter(tm.state_dict()))].data_ptr()


def test_int8_ops_sit_where_the_jax_package_puts_them():
    """conv/dense creators and the transformer projections; not the MoE
    experts, and no K2 under any quantize."""
    vit = DeepcvModule((32, 32, 3), _vit_hp(), device="meta", quantize="int8")
    quant = {n for n, m in vit.named_modules() if getattr(m, "quant", None) is not None}
    assert quant == {"module.nodes.embed.proj", "module.nodes._submodule_5_fully_connected.op",
                     *(f"module.nodes.enc{i}.{s}" for i in range(2)
                       for s in ("attn.qkv", "attn.out", "mlp.fc1", "mlp.fc2"))}
    hp = vit_spec("b_16", num_classes=5, moe_experts=2, moe_every=2)
    moe_block = [e for e in hp["architecture"] if "transformer_block" in e][1]
    arch = [hp["architecture"][0], moe_block] + hp["architecture"][-3:]
    arch[0]["patch_embed"][1].update(patch_size=16, embed_dim=32)
    arch[1]["transformer_block"][1].update(num_heads=2, mlp_dim=32)
    arch[1]["transformer_block"][1]["moe"].update(mlp_dim=32)
    m = DeepcvModule((32, 32, 3), {**hp, "architecture": arch}, device="meta",
                     quantize="int8_qat")
    block = [mod for mod in m.modules() if hasattr(mod, "uses_moe")][0]
    assert block.uses_moe and block.attn.qkv.quant.bits == 8
    assert not any(getattr(mod, "quant", None) for mod in block.moe_mlp.modules())
    wide = DeepcvModule((32, 32, 3), _wide_hp(), device="meta", quantize="int8_qat")
    assert not any(isinstance(mod, dnn.FusedConv2d) for mod in wide.modules())
    assert {mod.quant.bits for mod in wide.modules() if getattr(mod, "quant", None)} == {8}
    with pytest.raises(ValueError, match="unknown quantize mode"):
        DeepcvModule((32, 32, 3), _wide_hp(), device="meta", quantize="int3")


def test_nested_scales_use_the_full_node_path():
    hp = {"act_fn": "relu", "architecture": [
        {"conv2d": ["c0", {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}]},
        {"_nested_deepcv_module": {"_name": "inner", "act_fn": "relu", "architecture": [
            {"conv2d": ["c0", {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}]}]}},
        {"flatten": {}},
        {"fully_connected": ["head", {"out_features": 3}]}]}
    jm = JaxModule((8, 8, 8), copy.deepcopy(hp))
    jv = _numpy(jm.init(jax.random.PRNGKey(0)))
    tm = DeepcvModule((8, 8, 8), copy.deepcopy(hp), device="cpu").eval()
    load_jax_variables(tm, jv)
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 8)).astype(np.float32)
    scales = tc.calibrate_int8_scales(tm, [x])
    assert set(scales) == set(jc.calibrate_int8_scales(jm, jv, [x])) == \
        {"c0", "inner/c0", "head"}
    tq = tm.with_options(quantize="int8", quantize_scales=scales)
    assert tq.module.nodes["inner"].nodes["c0"].op.quant.act_scale == scales["inner/c0"]
    assert tq.module.nodes["c0"].op.quant.act_scale == scales["c0"]
    ref = JaxModule((8, 8, 8), copy.deepcopy(hp), quantize="int8",
                    quantize_scales=scales).apply(jv, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(tq(torch.from_numpy(x)).numpy(), ref) <= INT8_TOL


def test_weight_normed_ops_quantize_the_normalised_kernel():
    hp = dict(_wide_hp(), weight_norm={"eps": 1e-6})
    hp.pop("batch_norm")
    jm = JaxModule((32, 32, 3), copy.deepcopy(hp))
    jv = _zero_padded_stem_rows_wn(_numpy(jm.init(jax.random.PRNGKey(1))))
    tm = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="cpu").eval()
    load_jax_variables(tm, jv)
    x = np.random.default_rng(2).normal(size=(3, 32, 32, 3)).astype(np.float32)
    jscales = jc.calibrate_int8_scales(jm, jv, [x])
    assert set(tc.calibrate_int8_scales(tm, [x])) == set(jscales)
    ref = JaxModule((32, 32, 3), copy.deepcopy(hp), quantize="int8",
                    quantize_scales=jscales).apply(jv, jnp.asarray(x))
    with torch.no_grad():
        got = tm.with_options(quantize="int8", quantize_scales=jscales)(torch.from_numpy(x))
    assert _rel(got.numpy(), ref) <= INT8_TOL


def _zero_padded_stem_rows_wn(jv):
    op = jv["params"]["node_impls__submodule_0_conv2d"]["op"]["layer_instance"]
    op["kernel"][:, :, 3:, :] = 0.0
    return jv


def test_stem_weight_scale_leaves_out_the_jax_padding_rows():
    """The one deliberate difference: the JAX package's stem kernel has 5
    padded input rows (``pad_channels_for_tpu``), and its int8 weight scale
    is taken over them too; the port's is the max over the 3 real rows. At
    JAX's own init (padded rows not zero) the two grids differ."""
    hp = _wide_hp()
    jm = JaxModule((32, 32, 3), copy.deepcopy(hp))
    jv = _numpy(jm.init(jax.random.PRNGKey(3)))
    kernel = jv["params"]["node_impls__submodule_0_conv2d"]["op"]["kernel"]
    assert kernel.shape == (3, 3, 8, 8) and np.abs(kernel[:, :, 3:]).max() > 0
    tm = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="cpu")
    load_jax_variables(tm, jv)
    _, port_scale = tc.quantize_weight(tm.module.nodes["_submodule_0_conv2d"].op.weight.detach())
    _, jax_scale = jc._quant_sym(jnp.asarray(kernel), axes=(0, 1, 2))
    _, real_rows = jc._quant_sym(jnp.asarray(kernel[:, :, :3]), axes=(0, 1, 2))
    jax_scale, real_rows = np.asarray(jax_scale).reshape(-1), np.asarray(real_rows).reshape(-1)
    np.testing.assert_array_equal(port_scale.numpy(), real_rows)
    np.testing.assert_array_equal(port_scale.numpy(),
                                  np.abs(kernel[:, :, :3]).max((0, 1, 2)) / np.float32(127))
    assert (jax_scale > port_scale.numpy()).any()
    assert (jax_scale >= port_scale.numpy()).all()


# --------------------------------------------------------------------------- #
# QAT
# --------------------------------------------------------------------------- #

def _zero_rows_3_to_7(jv):
    """Rows 3-7 of every JAX conv kernel with 8 input rows set to 0: the
    stem's TPU padding and five real input channels of each 8-channel conv.
    On these weights neither package's fake-quant codes meet a rounding
    tie, so the forward and the first-step gradients are held to the parity
    bounds. On the full weights one code sits on a tie, and
    :func:`test_qat_codes_on_full_weights_differ_only_at_ties` holds the
    forward there."""
    for node in jv["params"].values():
        k = node.get("op", {}).get("kernel") if isinstance(node, dict) else None
        if k is not None and k.ndim == 4 and k.shape[2] == 8:
            k[:, :, 3:, :] = 0.0
    return jv


def _qat_case(quantize, weights):
    hp = dict(_wide_hp(), act_fn="silu")
    jm = JaxModule((32, 32, 3), copy.deepcopy(hp), quantize=quantize)
    jv = _numpy(jm.init(jax.random.PRNGKey(6)))
    jv = _zero_rows_3_to_7(jv) if weights == "rows_3_to_7_zero" else \
        _zero_padded_stem_rows(jv, hp)
    tm = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="cpu", quantize=quantize)
    load_jax_variables(tm, jv)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(6,))
    return jm, jv, tm, x, y


@pytest.mark.parametrize("quantize", ["int8_qat", "int4_qat"])
def test_qat_forward_and_first_step_gradients_match_jax(quantize):
    """With silu: at leaky_relu's kink the JAX package's own float32 first
    step gradients differ from its float64 ones by about 1e-2 (see
    ``tests/test_torch_port_wide.py``), with silu within 1e-5."""
    jm, jv, tm, x, y = _qat_case(quantize, "rows_3_to_7_zero")
    stats = {"batch_stats": jv["batch_stats"]}
    tm.eval()
    with torch.no_grad():
        assert _rel(tm(torch.from_numpy(x)).numpy(), jm.apply(jv, jnp.asarray(x))) <= FWD_TOL

    def loss_fn(params):
        logits, _ = jm.apply({"params": params, **stats}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jv["params"])
    tm.train()
    tloss = F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL * abs(float(jloss))
    ref = jax_to_torch_state_dict({"params": _numpy(jgrads), **stats}, tm)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("quantize", ["int8_qat", "int4_qat"])
def test_qat_codes_on_full_weights_differ_only_at_ties(quantize, train):
    """On the full weights (only the stem's padding rows zero) each op's
    fake-quant codes equal JAX's, each from its own float input to the op,
    but where that input sits on a rounding tie: the first op where any
    differ differs by one step at a tie (int8_qat: one code, in the fourth
    conv in eval and the fifth in training). With no flipped code the
    outputs agree within 1e-4, past a flip within TIE_TOL."""
    jm, jv, tm, x, _ = _qat_case(quantize, "full")
    tm.train(train)
    ref, jinputs = _jax_op_inputs(jm, jv, x, train=train)
    got, tinputs = _port_op_inputs(tm, x)
    levels, flips = 2 ** (tc.qat_bits(quantize) - 1) - 1, 0
    for key, (op, tx) in tinputs.items():
        flips += _code_flips(key, jinputs[key], op, tx, first=flips == 0, levels=levels)
    assert _rel(got, ref) <= (FWD_TOL if flips == 0 else TIE_TOL), flips


def test_qat_static_scales_and_int_grid():
    x = torch.linspace(-1, 1, 11, requires_grad=True)
    y = tc._fq_tensor(x, 7, act_scale=0.1)              # grid step 0.1 * 127 / 7
    step = np.float32(0.1 * (127.0 / 7))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.clip(np.round(x.detach().numpy() / step), -7, 7) * step,
                               rtol=1e-6)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(11))   # straight through
    j = jc._fq_tensor(jnp.asarray(x.detach().numpy()), 7, act_scale=0.1)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(j))


def test_real_int8_builds_are_inference_only():
    hp = _wide_hp()
    m = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="cpu", quantize="int8")
    assert not m.training and m.inference_only
    with pytest.raises(ValueError, match="inference-only"):
        m.train()
    m.training = True
    with pytest.raises(ValueError, match="inference-only"):
        m(torch.zeros(1, 32, 32, 3))
    qat = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="cpu", quantize="int8_qat")
    assert qat.training and not qat.inference_only
    qat(torch.zeros(2, 32, 32, 3)).sum().backward()
    with pytest.raises(ValueError, match="inference-only"):
        JaxModule((32, 32, 3), copy.deepcopy(hp), quantize="int8").apply(
            JaxModule((32, 32, 3), copy.deepcopy(hp)).init(jax.random.PRNGKey(0)),
            jnp.zeros((1, 32, 32, 3)), train=True)


class _Set:
    image_shape = (32, 32, 3)
    num_classes = 10


def test_model_hp_quantize_makes_qat_or_inference_builds():
    hp = _wide_hp()
    hp["architecture"][-1]["fully_connected"]["out_features"] = None
    qat = create_model({"trainset": _Set()}, {**copy.deepcopy(hp), "quantize": "int8_qat"},
                       device="cpu")
    assert qat.quantize == "int8_qat" and qat.training
    int8 = create_model({"trainset": _Set()}, {**copy.deepcopy(hp), "quantize": "int8"},
                        device="cpu")
    assert int8.inference_only
    from deepcv_tpu_torch.data.datasets import ArrayDataset
    from deepcv_tpu_torch.data.preprocess import preprocess
    from deepcv_tpu_torch.train.training import train
    rng = np.random.default_rng(0)
    data = preprocess({"trainset": ArrayDataset(
        rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8), np.arange(8) % 10)},
        {"split_dataset": {"validset_ratio": 0.25}, "transforms": ["to_tensor"]})
    with pytest.raises(ValueError, match="inference-only"):
        train({"epochs": 1, "batch_size": 2, "optimizer_opts": {"lr": 0.1},
               "save_every_iters": 0}, int8, "cross_entropy", data)


# --------------------------------------------------------------------------- #
# Pruning and per-tensor PTQ
# --------------------------------------------------------------------------- #

def _prune_pair():
    """A conv net on 8 input channels (no TPU padding rows: the JAX
    threshold would count them) and a 2-block ViT."""
    hp = {"act_fn": "relu", "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
          "architecture": [
              {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
              {"conv2d": {"kernel_size": [3, 3], "out_channels": 16, "padding": 1,
                          "stride": 2}},
              {"flatten": {}},
              {"fully_connected": {"out_features": 4, "batch_norm": None}}]}
    for spec, shape in ((hp, (8, 8, 8)), (_vit_hp(), (32, 32, 3))):
        jm = JaxModule(shape, copy.deepcopy(spec))
        jv = _numpy(jm.init(jax.random.PRNGKey(2)))
        tm = DeepcvModule(shape, copy.deepcopy(spec), device="cpu")
        load_jax_variables(tm, jv)
        yield jv, tm


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_magnitude_masks_equal_jax(sparsity):
    for jv, tm in _prune_pair():
        jmasks = jc.magnitude_prune_masks(jv["params"], sparsity)
        tmasks = tc.magnitude_prune_masks(tm, sparsity)
        ref = jax_to_torch_state_dict(
            {"params": jax.tree_util.tree_map(lambda m: np.asarray(m, np.float32), jmasks),
             **{k: v for k, v in jv.items() if k != "params"}}, tm)
        assert set(tmasks) == set(dict(tm.named_parameters()))
        for k, m in tmasks.items():
            np.testing.assert_array_equal(m.numpy(), ref[k].numpy() > 0.5, err_msg=k)
            if not k.endswith(".weight") or m.dim() < 2:
                assert m.all(), k              # biases, norms, tables: never pruned
        assert abs(tc.sparsity_of(None, tmasks) - jc.sparsity_of(None, jmasks)) < 1e-12
        pruned = tc.apply_masks(dict(tm.named_parameters()), tmasks)
        jpruned = jc.apply_masks(jv["params"], jmasks)
        assert abs(tc.sparsity_of(pruned) - jc.sparsity_of(jpruned)) < 1e-12


def test_masks_apply_in_place_and_hold_gradients():
    _, tm = next(_prune_pair())
    masks = tc.magnitude_prune_masks(tm, 0.5)
    tm(torch.ones(2, 8, 8, 8)).sum().backward()
    tc.prune_gradients(tm, masks)
    tc.apply_masks(tm, masks)
    for k, p in tm.named_parameters():
        assert not p.detach()[~masks[k]].any() and not p.grad[~masks[k]].any(), k
    grads = tc.prune_gradients({k: torch.ones_like(p) for k, p in tm.named_parameters()}, masks)
    assert all(torch.equal(g, masks[k].float()) for k, g in grads.items())


def test_agp_schedule_and_hook_equal_jax():
    for args in ((0.8,), (0.9, 100, 300, 0.1)):
        js, ts = jc.AGPSchedule(*args), tc.AGPSchedule(*args)
        for step in (-5, 0, 1, 99, 100, 150, 299, 300, 1000):
            assert ts(step) == js(step)
    _, tm = next(_prune_pair())
    box = {}

    class _State:
        model, step = tm, 500
    hook = tc.make_pruning_hook(tc.AGPSchedule(0.5, 0, 1000), box, every_epochs=2)
    hook(1, state=_State())
    assert box == {}
    hook(2, state=_State())
    assert box["sparsity"] == jc.AGPSchedule(0.5, 0, 1000)(500)
    assert set(box["masks"]) == set(dict(tm.named_parameters()))


def test_quantize_int8_and_dequantize_equal_jax():
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": (rng.normal(size=(11,)) * 3).astype(np.float32),
            "z": np.zeros((3,), np.float32)}
    jv, js = jc.quantize_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    tv, ts = tc.quantize_int8({k: torch.from_numpy(v) for k, v in tree.items()})
    for k in tree:
        assert tv[k].dtype == torch.int8
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
        assert float(ts[k]) == float(js[k])
    jd = jc.dequantize_int8(jv, js)
    td = tc.dequantize_int8(tv, ts)
    for k in tree:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))

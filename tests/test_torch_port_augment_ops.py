"""The rest of the port's augmentation against the JAX package's, on the
CPU: the geometric and colour transforms, the 13 AugMix ops, AugMix,
RandAugment, TrivialAugment, random erasing, mixup and CutMix with the JAX
draws fed in, the port's own draws by their statistics, the recipe's
sections, and the training loop's mixed and JSD losses. Inputs come from a
numpy seed; 8 images of 16x16."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepcv_tpu.data import augmentation as JA
from deepcv_tpu.data import transforms as JT
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.train import losses as JL
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data import augmentation as A
from deepcv_tpu_torch.data import preprocess as P
from deepcv_tpu_torch.data import transforms as T
from deepcv_tpu_torch.data.datasets import load_dataset
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train import losses as L
from deepcv_tpu_torch.train import training

TOL = 1e-5            # the transforms bound of tests/test_pallas.py
FLIP_SHARE = 1e-3     # PIL-exact ops: one u8 level on at most 0.1 % of pixels
LOSS_TOL = 1e-6
GRAD_RTOL = 1e-3      # first-step gradients (tests/test_torch_parity.py:11-12)
N, H, W = 8, 16, 16
N_STAT = 4096


def _images(seed=0, shape=(N, H, W, 3), u8_grid=False):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    return (np.round(x * 255) / 255).astype(np.float32) if u8_grid else x


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _assert_u8_close(ours, ref):
    """Equal, or one u8 level apart on at most ``FLIP_SHARE`` of the pixels."""
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64)) * 255.0
    assert d.max() <= 1.0 + 1e-3, d.max()
    assert (d > 0.5).mean() <= FLIP_SHARE, (d > 0.5).mean()


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module", autouse=True)
def jax_random_warm():
    """The first call of each ``jax.random`` draw compiles it; pay that once
    for the file."""
    key = jax.random.PRNGKey(0)
    for k in jax.random.split(key, 3):
        jax.random.randint(k, (), 0, 4)
        jax.random.uniform(k, (1,), minval=0.1, maxval=3.0)
        jax.random.bernoulli(k, 0.5, (1,))
    jax.random.dirichlet(key, jnp.ones((2,)), (4,))
    jax.random.beta(key, 1.0, 1.0, (4,))


# --------------------------------------------------------------------------- #
# The JAX draws, replayed from its keys as its ops draw them
# --------------------------------------------------------------------------- #

def _jax_op_value(name, key, level, n, h, w):
    """The per-image value JAX's op ``name`` draws from ``key``."""
    if name in ("autocontrast", "equalize"):
        return np.zeros(n, np.float32)
    if name == "posterize":
        return np.asarray(4 - JA._int_param(JA._sample_level(key, level, n), 4))
    if name == "solarize":
        return np.asarray(256.0 - JA._int_param(JA._sample_level(key, level, n), 256))
    if name in ("color", "contrast", "brightness", "sharpness"):
        return np.asarray(JA._enhance_factor(key, level, n))
    k1, k2 = jax.random.split(key)
    sample, sign = JA._sample_level(k1, level, n), JA._rand_sign(k2, n)
    if name in ("shear_x", "shear_y"):
        return np.asarray(JA._float_param(sample, 0.3) * sign)
    if name in ("translate_x", "translate_y"):
        return np.asarray(JA._int_param(sample, (w if name == "translate_x" else h) / 3.0)
                          * sign)
    return np.asarray(JA._int_param(sample, 30) * sign)          # rotate


def _jax_augmix_draws(key, n, h, w, severity, width, depth, alpha, ops):
    max_depth = depth if depth > 0 else 3
    k_w, k_m, k_chain = jax.random.split(key, 3)
    ws = np.asarray(jax.random.dirichlet(k_w, jnp.full((width,), alpha), (n,)))
    m = np.asarray(jax.random.beta(k_m, alpha, alpha, (n,)))
    depths = np.zeros((n, width), np.int64)
    op_idx = np.zeros((n, width, max_depth), np.int64)
    values = np.zeros((n, width, max_depth), np.float32)
    for i, ck in enumerate(jax.random.split(k_chain, n)):
        for c, cck in enumerate(jax.random.split(ck, width)):
            ks = jax.random.split(cck, max_depth * 2 + 1)
            depths[i, c] = max_depth if depth > 0 else int(jax.random.randint(ks[0], (), 1, 4))
            for s in range(max_depth):
                j = int(jax.random.randint(ks[1 + 2 * s], (), 0, len(ops)))
                op_idx[i, c, s] = j
                values[i, c, s] = _jax_op_value(ops[j], ks[2 + 2 * s], severity, 1, h, w)[0]
    return {"ws": _t(ws), "m": _t(m), "depths": _t(depths), "op_idx": _t(op_idx),
            "values": _t(values)}


def _jax_rand_augment_draws(key, n, h, w, rounds, magnitude, ops):
    choices, values = [], []
    for _ in range(rounds):
        kr, ks, key = jax.random.split(key, 3)
        choice = np.asarray(jax.random.randint(ks, (n,), 0, len(ops)))
        per_op = [_jax_op_value(name, jax.random.fold_in(kr, i), magnitude, n, h, w)
                  for i, name in enumerate(ops)]
        choices.append(choice)
        values.append(np.asarray([per_op[c][i] for i, c in enumerate(choice)], np.float32))
    return _t(np.stack(choices)), _t(np.stack(values))


# --------------------------------------------------------------------------- #
# Transforms
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size,method,antialias", [
    ((8, 8), "bilinear", True), ((24, 20), "bilinear", True), ((16, 8), "linear", False),
    ((7, 9), "cubic", True), ((10, 12), "lanczos3", False), ((12, 6), "lanczos5", True),
    ((5, 32), "nearest", True), (12, "bilinear", True)])
def test_resize_matches_jax_image_resize(size, method, antialias):
    x = _images(1)
    ours = T.resize(_t(x), size, method, antialias)
    ref = JT.resize(jnp.asarray(x), size, method, antialias)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", [
    ("center_crop", {"size": 10}), ("center_crop", {"size": (7, 12)}),
    ("pad", {"padding": 2}), ("pad", {"padding": (1, 3), "value": 0.5}),
    ("pad", {"padding": 2, "mode": "reflect"}), ("pad", {"padding": (3, 1), "mode": "edge"}),
    ("pad", {"padding": 2, "mode": "wrap"}),
    ("denormalize", {"mean": [0.4, 0.5, 0.6], "std": [0.2, 0.3, 0.25]})])
def test_deterministic_transforms_match_jax(case):
    name, kw = case
    x = _images(2)
    ours = T.TRANSFORM_REGISTRY[name](_t(x), **kw)
    ref = JT.TRANSFORM_REGISTRY[name](jnp.asarray(x), **kw)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("scalar", [True, False])
def test_adjust_hue_matches_jax(scalar):
    x = _images(3)
    f = 0.23 if scalar else np.random.default_rng(4).uniform(-0.5, 0.5, N).astype(np.float32)
    ours = T.adjust_hue(_t(x), f if scalar else _t(f))
    ref = JT.adjust_hue(jnp.asarray(x), f if scalar else jnp.asarray(f))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_color_jitter_with_the_jax_draws_matches_jax():
    x, key = _images(5), jax.random.PRNGKey(6)
    jitter = {"brightness": 0.4, "contrast": 0.3, "saturation": 0.2, "hue": 0.1}
    ks = jax.random.split(key, 4)
    factors = {}
    for i, name in enumerate(("brightness", "contrast", "saturation")):
        v = jitter[name]
        factors[name] = _t(jax.random.uniform(ks[i], (N,), minval=max(0.0, 1 - v),
                                              maxval=1 + v))
    factors["hue"] = _t(jax.random.uniform(ks[3], (N,), minval=-0.1, maxval=0.1))
    ours = T.apply_color_jitter(_t(x), factors)
    ref = JT.color_jitter(jnp.asarray(x), key, **jitter)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def _affines(seed, n=N):
    m = np.random.default_rng(seed).normal(0, 0.3, (n, 2, 3)).astype(np.float32)
    m[:, 0, 0] += 1
    m[:, 1, 1] += 1
    m[:, :, 2] *= 8
    return m


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cval", [0.0, 0.5])
def test_affine_transform_matches_jax(seed, cval):
    x, m = _images(seed), _affines(seed + 10)
    ours = T.affine_transform(_t(x), _t(m), cval=cval)
    ref = JT.affine_transform(jnp.asarray(x), jnp.asarray(m), cval=cval)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_affine_transform_pil_exact_matches_jax(seed):
    x, m = _images(seed, u8_grid=True), _affines(seed + 20)
    ours = T.affine_transform(_t(x), _t(m), pil_exact_u8=True)
    ref = JT.affine_transform(jnp.asarray(x), jnp.asarray(m), pil_exact_u8=True)
    _assert_u8_close(ours.numpy(), ref)


def test_center_affine_and_the_random_geometric_transforms_with_jax_draws():
    x, key = _images(7), jax.random.PRNGKey(8)
    # rotate: theta from the key as random_rotate draws it
    theta = jnp.deg2rad(jax.random.uniform(key, (N,), minval=-30.0, maxval=45.0))
    ours = T.affine_transform(_t(x), T.rotate_matrices(_t(theta), H, W))
    np.testing.assert_allclose(ours.numpy(), np.asarray(JT.random_rotate(
        jnp.asarray(x), key, (-30.0, 45.0))), atol=TOL, rtol=0)
    # translate
    k1, k2 = jax.random.split(key)
    tx = jax.random.uniform(k1, (N,), minval=-0.2, maxval=0.2) * W
    ty = jax.random.uniform(k2, (N,), minval=-0.2, maxval=0.2) * H
    ours = T.affine_transform(_t(x), T.translate_matrices(_t(tx), _t(ty), H, W))
    np.testing.assert_allclose(ours.numpy(), np.asarray(JT.random_translate(
        jnp.asarray(x), key, 0.2)), atol=TOL, rtol=0)
    # scale
    s = jax.random.uniform(key, (N,), minval=0.8, maxval=1.2)
    ours = T.affine_transform(_t(x), T.scale_matrices(_t(s), H, W))
    np.testing.assert_allclose(ours.numpy(), np.asarray(JT.random_scale(
        jnp.asarray(x), key, 0.2)), atol=TOL, rtol=0)
    # crop with padding
    top = jax.random.randint(k1, (N,), 0, H + 4 - 12 + 1)
    left = jax.random.randint(k2, (N,), 0, W + 4 - 12 + 1)
    ours = T.crop(T.pad(_t(x), 2), _t(top), _t(left), (12, 12))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(JT.random_crop(
        jnp.asarray(x), key, 12, padding=2)))
    # flips
    chosen = jax.random.bernoulli(key, 0.3, (N,))
    for dim, fn in ((2, JT.random_horizontal_flip), (1, JT.random_vertical_flip)):
        np.testing.assert_array_equal(T.flip(_t(x), _t(chosen), dim).numpy(),
                                      np.asarray(fn(jnp.asarray(x), key, p=0.3)))


def test_the_registry_has_every_jax_name_and_compose_threads_the_generator():
    assert set(T.TRANSFORM_REGISTRY) == set(JT.TRANSFORM_REGISTRY)
    comp = T.Compose([(T.random_crop, {"size": 12, "padding": 2}), T.to_tensor,
                      (T.random_horizontal_flip, {"p": 0.5})])
    a, b = comp(_t(_images(9)), _gen(3)), comp(_t(_images(9)), _gen(3))
    assert tuple(a.shape) == (N, 12, 12, 3) and torch.equal(a, b)
    with pytest.raises(ValueError, match="random_crop needs a torch.Generator"):
        comp(_t(_images(9)))
    assert "random_crop" in repr(comp)


def test_preprocess_takes_any_registered_transform_and_its_image_shape_follows():
    entry = {"type": "synthetic", "n": 20, "image_shape": [16, 16, 3], "num_classes": 4}
    sets = P.preprocess({"trainset": load_dataset(entry)}, {
        "seed": 0, "split_dataset": {"validset_ratio": 0.2},
        "transforms": ["to_tensor", {"center_crop": {"size": 12}},
                       {"resize": {"size": [8, 8]}}, {"hflip": {"p": 0.5}}, "normalize"]})
    assert sets["trainset"].image_shape == (8, 8, 3)
    raw = torch.from_numpy(sets["trainset"].dataset.images[:4])
    out = sets["trainset"].batch_transform(raw, _gen(1))
    assert tuple(out.shape) == (4, 8, 8, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="Unknown transform 'no_such'"):
        P.parse_transforms_specification(["no_such"])


# --------------------------------------------------------------------------- #
# The 13 AugMix ops
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(JA.AUGMENTATION_OPS))
@pytest.mark.parametrize("channels", [3, 1])
def test_augmix_op_with_the_jax_draws_matches_jax(name, channels):
    x = _images(11, (N, H, W, channels))
    key, level = jax.random.PRNGKey(12), 7
    value = _jax_op_value(name, key, level, N, H, W)
    ours = A.OPS[name].apply(_t(x), _t(value))
    ref = JA.AUGMENTATION_OPS[name](jnp.asarray(x), key, level)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    _assert_u8_close(ours.numpy(), ref)


@pytest.mark.parametrize("name", ["color", "contrast", "brightness", "sharpness"])
def test_blend_ops_are_pils_integer_arithmetic(name):
    """Pillow's grey, the integer mean grey, the SMOOTH sums and the floor,
    at factors that land on and beside integer levels."""
    x = _images(13, u8_grid=True)
    f = np.array([0.0, 0.1, 0.5, 1.0, 1.3, 1.9, 0.25, 1.75], np.float32)
    ours = A.OPS[name].apply(_t(x), _t(f)).numpy()
    ref = np.asarray({"color": JA.color_with_factor, "contrast": JA.contrast_with_factor,
                      "brightness": JA.brightness_with_factor,
                      "sharpness": JA.sharpness_with_factor}[name](jnp.asarray(x),
                                                                  jnp.asarray(f)))
    _assert_u8_close(ours, ref)
    np.testing.assert_array_equal(np.round(ours * 255), ours * 255)   # on the u8 grid


def test_equalize_keeps_flat_channels_and_the_last_bin_rule():
    x = _images(14, u8_grid=True)
    x[0] = 0.5                          # one level: step 0, identity
    x[1, ..., 0] = np.where(np.arange(W) < 3, 0.2, 0.9)[None, :]   # two levels
    x[2, :8] = 1.0                      # a heavy last bin
    ours = A.equalize(_t(x)).numpy()
    ref = np.asarray(JA.equalize(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)


# --------------------------------------------------------------------------- #
# AugMix, RandAugment, TrivialAugment, random erasing, mixup, CutMix
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ops,width,depth,alpha", [
    (("posterize", "solarize"), 2, -1, 1.0),
    (("contrast", "brightness"), 1, 2, 0.3)])
def test_augment_and_mix_with_the_jax_draws_matches_jax(ops, width, depth, alpha):
    x, key = _images(15, (4, H, W, 3)), jax.random.PRNGKey(16)
    draws = _jax_augmix_draws(key, 4, H, W, 3, width, depth, alpha, ops)
    ours = A.augment_and_mix_apply(_t(x), ops=ops, **draws)
    ref = JA.augment_and_mix(jnp.asarray(x), key, severity=3, width=width, depth=depth,
                             alpha=alpha, ops=ops)
    # the mix of PIL-exact chains: one u8 level of a chain moves the mix by
    # at most its weight / 255
    d = np.abs(ours.numpy() - np.asarray(ref))
    assert d.max() <= 1.0 / 255 + TOL and (d > TOL).mean() <= FLIP_SHARE


def test_augment_and_mix_runs_each_op_on_the_images_that_chose_it():
    """Every op of the table in the chains: the batched application equals
    each image's chain run op by op (each op held to JAX's above)."""
    x = _t(_images(29, (6, H, W, 3)))
    d = A.draw_augment_and_mix(6, H, W, _gen(10), severity=3, width=3, depth=-1, alpha=1.0)
    d["op_idx"] = torch.arange(6 * 3 * 3).reshape(6, 3, 3) % 13
    d["depths"] = torch.tensor([1, 2, 3]).repeat(6, 1)
    ours = A.augment_and_mix_apply(x, **d)
    names = list(A.OPS)
    for i in range(6):
        mixed = torch.zeros_like(x[i:i + 1])
        for c in range(3):
            cur = x[i:i + 1]
            for s in range(int(d["depths"][i, c])):
                op = A.OPS[names[int(d["op_idx"][i, c, s])]]
                cur = op.apply(cur, d["values"][i:i + 1, c, s])
            mixed = mixed + d["ws"][i, c] * cur
        want = (1 - d["m"][i]) * x[i:i + 1] + d["m"][i] * mixed
        torch.testing.assert_close(ours[i:i + 1], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rounds,magnitude,ops", [
    (2, 5.0, None), (1, 10.0, ("equalize", "rotate", "sharpness"))])
def test_rand_augment_with_the_jax_draws_matches_jax(rounds, magnitude, ops):
    x, key = _images(17), jax.random.PRNGKey(18)
    names = list(ops or JA.AUGMENTATION_OPS)
    choice, values = _jax_rand_augment_draws(key, N, H, W, rounds, magnitude, names)
    ours = A.rand_augment_apply(_t(x), choice, values, names)
    ref = JA.rand_augment_batch(jnp.asarray(x), key, n=rounds, magnitude=magnitude, ops=ops)
    _assert_u8_close(ours.numpy(), ref)


def test_trivial_augment_is_one_round_at_magnitude_ten():
    x, key = _images(19), jax.random.PRNGKey(20)
    names = list(JA.AUGMENTATION_OPS)
    choice, values = _jax_rand_augment_draws(key, N, H, W, 1, 10.0, names)
    _assert_u8_close(A.rand_augment_apply(_t(x), choice, values).numpy(),
                     JA.trivial_augment_batch(jnp.asarray(x), key))
    a = A.trivial_augment_batch(_t(x), _gen(1))
    b = A.rand_augment_batch(_t(x), _gen(1), n=1, magnitude=10.0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("value", [None, 0.25])
def test_random_erasing_with_the_jax_draws_matches_jax(value):
    x, key = _images(21), jax.random.PRNGKey(22)
    scale, ratio = (0.02, 0.33), (0.3, 3.3)
    k_gate, k_area, k_ratio, k_y, k_x, k_fill = jax.random.split(key, 6)
    draws = {"gate": _t(jax.random.bernoulli(k_gate, 0.7, (N,))),
             "area": _t(jax.random.uniform(k_area, (N,), minval=scale[0], maxval=scale[1])
                        * (H * W)),
             "log_r": _t(jax.random.uniform(k_ratio, (N,), minval=jnp.log(ratio[0]),
                                            maxval=jnp.log(ratio[1]))),
             "uy": _t(jax.random.uniform(k_y, (N,))), "ux": _t(jax.random.uniform(k_x, (N,))),
             "fill": None if value is not None else _t(jax.random.uniform(k_fill, x.shape))}
    ours = A.random_erasing_apply(_t(x), value=value, **draws)
    ref = JA.random_erasing_batch(jnp.asarray(x), key, p=0.7, value=value)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_with_the_jax_draws_matches_jax(alpha):
    x, key = _images(23), jax.random.PRNGKey(24)
    kperm, klam = jax.random.split(key)
    perm, lam = jax.random.permutation(kperm, N), jax.random.beta(klam, alpha, alpha)
    xm, p, lm = A.mixup_apply(_t(x), _t(perm), _t(lam))
    jx, jp, jl = JA.mixup_batch(jnp.asarray(x), key, alpha)
    np.testing.assert_allclose(xm.numpy(), np.asarray(jx), atol=TOL, rtol=0)
    assert float(lm) == pytest.approx(float(jl), abs=0) and float(lm) >= 0.5
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("seed", range(3))
def test_cutmix_with_the_jax_draws_matches_jax(seed):
    x, key = _images(25), jax.random.PRNGKey(seed)
    kperm, klam, kc = jax.random.split(key, 3)
    draws = (_t(jax.random.permutation(kperm, N)), _t(jax.random.beta(klam, 1.0, 1.0)),
             _t(jax.random.uniform(kc, (), minval=0.0, maxval=float(H))),
             _t(jax.random.uniform(jax.random.fold_in(kc, 1), (), minval=0.0,
                                   maxval=float(W))))
    xm, _, lam = A.cutmix_apply(_t(x), *draws)
    jx, _, jl = JA.cutmix_batch(jnp.asarray(x), key, 1.0)
    np.testing.assert_array_equal(xm.numpy(), np.asarray(jx))
    assert float(lam) == pytest.approx(float(jl), abs=1e-7)


# --------------------------------------------------------------------------- #
# The port's own draws, by their statistics (4,096 draws; means within four
# standard errors)
# --------------------------------------------------------------------------- #

def _within(samples, mean, var):
    se = np.sqrt(var / len(samples))
    assert abs(float(np.mean(samples)) - mean) <= 4 * se, (np.mean(samples), mean, se)


@pytest.mark.parametrize("alpha", [0.2, 0.3, 1.0, 2.5])
def test_gamma_and_beta_draws_have_their_moments(alpha):
    g = A.gamma(alpha, N_STAT, _gen(int(alpha * 10))).numpy()
    assert (g >= 0).all() and np.isfinite(g).all()
    _within(g, alpha, alpha)
    _within(g * g, alpha * (alpha + 1), alpha * (alpha + 1) * (4 * alpha + 6))
    b = A.beta(alpha, alpha, N_STAT, _gen(7)).numpy()
    _within(b, 0.5, 1.0 / (4 * (2 * alpha + 1)))


def test_dirichlet_rows_sum_to_one_with_the_symmetric_mean():
    d = A.dirichlet(0.3, N_STAT, 3, _gen(2)).numpy()
    np.testing.assert_allclose(d.sum(-1), 1.0, atol=1e-5)
    var = (1 / 3) * (2 / 3) / (0.9 + 1)
    for k in range(3):
        _within(d[:, k], 1 / 3, var)


def test_augmix_draws_have_their_distribution():
    d = A.draw_augment_and_mix(N_STAT, H, W, _gen(3), severity=3, width=3, depth=-1,
                               alpha=1.0)
    assert set(np.unique(d["depths"].numpy())) == {1, 2, 3}
    _within(d["depths"].numpy().ravel().astype(float), 2.0, 2 / 3)
    _within(d["op_idx"].numpy().ravel().astype(float), 6.0, (13 ** 2 - 1) / 12)
    _within(d["m"].numpy(), 0.5, 1 / 12)
    assert d["values"].shape == (N_STAT, 3, 3)


def test_rand_augment_erasing_and_mixing_draws_have_their_distribution():
    choice, values = A.draw_rand_augment(N_STAT, H, W, _gen(4), 2, 5.0)
    _within(choice.numpy().ravel().astype(float), 6.0, (13 ** 2 - 1) / 12)
    post = values[choice == 2].numpy()               # posterize: 4 - floor(U(0.1, 5) * 0.4)
    assert set(np.unique(post)) <= {2.0, 3.0, 4.0}
    d = A.draw_random_erasing((N_STAT, H, W, 3), _gen(5), p=0.3)
    _within(d["gate"].numpy().astype(float), 0.3, 0.21)
    _within(d["area"].numpy() / (H * W), 0.175, 0.31 ** 2 / 12)
    lams = np.array([float(A.mixup_apply(torch.zeros(2, 1, 1, 1), *A.draw_mixup(
        2, _gen(s), 0.2))[2]) for s in range(256)])
    assert (lams >= 0.5).all() and (lams <= 1.0).all()
    picks = [training.mix_batch(torch.zeros(4, 4, 4, 3), _gen(s), 0.2, 1.0)[2]
             for s in range(400)]
    # lam of CutMix at 4x4 is a multiple of 1/16; mixup's almost never is
    cut = np.mean([abs(float(l) * 16 - round(float(l) * 16)) < 1e-6 for l in picks])
    assert 0.4 <= cut <= 0.62


# --------------------------------------------------------------------------- #
# The recipe
# --------------------------------------------------------------------------- #

def _conf_recipe(name):
    doc = load_yaml("conf/base/parameters.yml")
    return {k: v for d in doc["augmentations_recipes"] for k, v in d.items()}[name]


@pytest.mark.parametrize("name", ["basic_augmentation", "augmix_augmentation"])
def test_the_conf_recipes_compile_like_jax_and_take_the_eager_route(name):
    recipe = _conf_recipe(name)
    ours, ref = A.apply_augmentation_recipe(recipe), JA.apply_augmentation_recipe(recipe)
    assert ours.steps == ref.steps == ["brightness", "contrast", "tweak_colors", "gamma",
                                       "posterize", "noise", "rotate", "translate", "scale"]
    assert ours.gate_p == ref.gate_p
    assert (ours.augmix_spec, ours.rand_augment, ours.random_erasing) == \
        (ref.augmix_spec, ref.rand_augment, ref.random_erasing)
    assert not ours.fits_k1()
    assert pickle.loads(pickle.dumps(ours)).severities == ours.severities
    u8 = torch.from_numpy((_images(26) * 255).astype(np.uint8))
    ds = P.PreprocessedDataset(None, P.parse_transforms_specification(["to_tensor"]), ours)
    before = dict(P.PreprocessedDataset.batch_transform.routes)
    out = ds.batch_transform(u8, _gen(6))
    assert P.PreprocessedDataset.batch_transform.routes["eager"] == before["eager"] + 1
    assert P.PreprocessedDataset.batch_transform.routes["K1"] == before["K1"]
    assert tuple(out.shape) == (N, H, W, 3) and 0 <= float(out.min()) <= float(out.max()) <= 1


@pytest.mark.parametrize("recipe", [
    {"transforms": [{"hflip": 0.5}, {"vflip": 0.3}, {"scale": 0.1}],
     "trivial_augment": {"ops": ["rotate", "equalize"]}},
    {"transforms": [], "rand_augment": True, "random_erasing": [{"p": 0.4},
                                                               {"value": 0.0}]},
    {"transforms": [{"translate": 0.1}], "augmix": {"augmentation_chains_count": 2,
                                                    "transform_chains_dirichlet": 0.5}}])
def test_every_section_compiles_like_jax_and_runs(recipe):
    ours, ref = A.apply_augmentation_recipe(recipe), JA.apply_augmentation_recipe(recipe)
    assert ours.steps == ref.steps and ours.gate_p == ref.gate_p
    assert (ours.augmix_spec, ours.rand_augment, ours.random_erasing) == \
        (ref.augmix_spec, ref.rand_augment, ref.random_erasing)
    x = _t(_images(27))
    a, b = ours(x, _gen(8)), ours(x, _gen(8))
    assert torch.equal(a, b) and tuple(a.shape) == tuple(x.shape)


@pytest.mark.parametrize("recipe,match", [
    ({"transforms": [], "rand_augment": {"m": 3}}, "rand_augment: unknown keys"),
    ({"transforms": [], "rand_augment": {"ops": ["warp"]}}, "rand_augment: unknown ops"),
    ({"transforms": [], "rand_augment": 3}, "rand_augment: expected a mapping"),
    ({"transforms": [], "rand_augment": {}, "trivial_augment": {}}, "exclusive"),
    ({"transforms": [], "trivial_augment": {"n": 1}}, "trivial_augment: unknown keys"),
    ({"transforms": [], "random_erasing": {"size": 3}}, "random_erasing: unknown keys")])
def test_section_validation_messages_are_jaxs(recipe, match):
    for mod in (A, JA):
        with pytest.raises(ValueError, match=match):
            mod.apply_augmentation_recipe(recipe)


def test_transforms_additional_still_raises_saying_jax_never_reads_it():
    with pytest.raises(NotImplementedError, match="never reads it"):
        A.apply_augmentation_recipe({"transforms": [], "transforms_additional": [
            {"brightness": 0.1}]})


def test_recipe_draw_order_is_steps_then_sections():
    """The eager chain's draws: per step the gate, then its draws; then
    RandAugment, AugMix and erasing, from one generator."""
    recipe = A.apply_augmentation_recipe({"transforms": [{"posterize": 0.2}],
                                          "augmentation_ops_depth": [2, 2],
                                          "random_erasing": {"p": 1.0, "value": 0.0}})
    x = _t(_images(28))
    g = _gen(9)
    gate = A._gate(N, g, recipe.gate_p)
    step = A.AUGMENTATION_OPS["posterize"](x, g, 2.0)
    want = torch.where(gate.reshape(-1, 1, 1, 1), step, x)
    want = A.random_erasing_batch(want, g, p=1.0, value=0.0)
    assert recipe.gate_p == 1.0 and torch.equal(recipe(x, _gen(9)), want)


# --------------------------------------------------------------------------- #
# Losses and the training loop
# --------------------------------------------------------------------------- #

def _logits(seed, n=N, c=5):
    return np.random.default_rng(seed).normal(0, 2, (n, c)).astype(np.float32)


@pytest.mark.parametrize("views", [1, 2, 3])
def test_jsd_consistency_loss_matches_jax(views):
    logits = [_logits(30 + k) for k in range(views + 1)]
    ours = L.jensen_shannon_divergence_consistency_loss(*map(_t, logits))
    ref = JL.jensen_shannon_divergence_consistency_loss(*map(jnp.asarray, logits))
    assert float(ours) == pytest.approx(float(ref), abs=LOSS_TOL)
    assert L.LOSS_FNS["jsd_consistency"] is L.jensen_shannon_divergence_consistency_loss


def test_jsd_gradient_stops_at_the_clean_logits():
    clean, aug = (_t(_logits(40)).requires_grad_(), _t(_logits(41)).requires_grad_())
    L.jensen_shannon_divergence_consistency_loss(clean, aug).backward()
    assert clean.grad is None or float(clean.grad.abs().max()) == 0.0
    assert float(aug.grad.abs().max()) > 0


def test_mixed_loss_given_perm_and_lam_matches_the_jax_combination():
    logits, y = _logits(42), np.random.default_rng(43).integers(0, 5, N)
    perm, lam = np.random.default_rng(44).permutation(N), np.float32(0.73)
    losses = L.WeightedLosses({"ce": L.cross_entropy_loss, "ce2": (L.cross_entropy_loss, 3.0)})
    main, terms = training.mixed_losses(losses, _t(logits), _t(y), _t(perm), torch.tensor(lam))
    jl = JL.WeightedLosses({"ce": JL.cross_entropy_loss, "ce2": (JL.cross_entropy_loss, 3.0)})
    ma, ta = jl(jnp.asarray(logits), jnp.asarray(y))
    mb, tb = jl(jnp.asarray(logits), jnp.asarray(y)[perm])
    assert float(main) == pytest.approx(float(lam * ma + (1 - lam) * mb), abs=LOSS_TOL)
    for k in ta:
        assert float(terms[k]) == pytest.approx(float(lam * ta[k] + (1 - lam) * tb[k]),
                                                abs=LOSS_TOL)


def _small_classifier():
    return {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 4}},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}}, {"flatten": {}},
        {"fully_connected": {"out_features": 5}}]}


@pytest.fixture(scope="module")
def jax_and_port_classifiers():
    """A small JAX classifier and the port's with its weights (built once:
    the first JAX and spec builds of a process take seconds)."""
    jm = JaxModule((H, W, 3), _small_classifier())
    jv = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(5)))
    jax.value_and_grad(lambda p: jm.apply({"params": p}, jnp.zeros((N, H, W, 3)),
                                          train=True).sum())(jv["params"])
    return jm, jv


@pytest.mark.parametrize("kind", ["mixup", "cutmix"])
def test_first_step_gradients_under_mixing_match_jax(kind, jax_and_port_classifiers):
    jm, jv = jax_and_port_classifiers
    tm = DeepcvModule((H, W, 3), _small_classifier(), device="cpu")
    load_jax_variables(tm, jv)
    x, y = _images(45), np.random.default_rng(46).integers(0, 5, N)
    key = jax.random.PRNGKey(47)
    if kind == "mixup":
        jx, perm, lam = JA.mixup_batch(jnp.asarray(x), key, 0.2)
        kperm, klam = jax.random.split(key)
        tx, tperm, tlam = A.mixup_apply(_t(x), _t(jax.random.permutation(kperm, N)),
                                        _t(jax.random.beta(klam, 0.2, 0.2)))
    else:
        jx, perm, lam = JA.cutmix_batch(jnp.asarray(x), key, 1.0)
        kperm, klam, kc = jax.random.split(key, 3)
        tx, tperm, tlam = A.cutmix_apply(
            _t(x), _t(jax.random.permutation(kperm, N)), _t(jax.random.beta(klam, 1.0, 1.0)),
            _t(jax.random.uniform(kc, (), minval=0.0, maxval=float(H))),
            _t(jax.random.uniform(jax.random.fold_in(kc, 1), (), minval=0.0,
                                  maxval=float(W))))

    def loss_fn(params):
        logits = jm.apply({"params": params}, jx, train=True)
        ce = optax.softmax_cross_entropy_with_integer_labels
        return lam * ce(logits, jnp.asarray(y)).mean() + \
            (1 - lam) * ce(logits, jnp.asarray(y)[perm]).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jv["params"])
    tm.train()
    main, _ = training.mixed_losses(L.WeightedLosses(L.cross_entropy_loss), tm(tx), _t(y),
                                    tperm, tlam)
    main.backward()
    assert float(main.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.array, jgrads)}, tm)
    grads = dict(tm.named_parameters())
    for k, g in ref.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=k)


def _train_sets(recipe=None):
    entry = {"type": "synthetic", "n": 20, "image_shape": [16, 16, 3], "num_classes": 5}
    return P.preprocess({"trainset": load_dataset(entry)},
                        {"seed": 0, "split_dataset": {"validset_ratio": 0.2},
                         "transforms": ["to_tensor", "normalize"],
                         "augmentation_recipe": recipe})


def _train_hp(tmp_path, **kw):
    return {"epochs": 1, "batch_size": 8, "optimizer": "adamw", "optimizer_opts": {"lr": 1e-3},
            "save_every_iters": 0, "handle_preemption": False, "output_path": str(tmp_path),
            **kw}


def _bn_classifier():
    hp = _small_classifier()
    hp["architecture"][0] = {"conv2d": {"kernel_size": [3, 3], "out_channels": 4,
                                        "batch_norm": {}}}
    return hp


@pytest.mark.parametrize("extra", [
    {"mixup_alpha": 0.2}, {"cutmix_alpha": 1.0}, {"mixup_alpha": 0.2, "cutmix_alpha": 1.0},
    {"augmix_jsd": {"weight": 12.0, "views": 2, "width": 2}}])
def test_train_accepts_mixup_cutmix_and_augmix_jsd(extra, tmp_path):
    model = DeepcvModule((H, W, 3), _bn_classifier(), device="cpu")
    sets = _train_sets(_conf_recipe("basic_augmentation"))
    state, hist = training.train(_train_hp(tmp_path, **extra), model, L.cross_entropy_loss,
                                 sets)
    assert state.step == 2 and np.isfinite(hist["train"][-1]["main_loss"])
    if "augmix_jsd" in extra:
        assert "jsd_consistency" in hist["train"][-1]


def test_jsd_views_leave_the_running_statistics_to_the_clean_forward(tmp_path, monkeypatch):
    model = DeepcvModule((H, W, 3), _bn_classifier(), device="cpu")
    seen = []
    real = training.jensen_shannon_divergence_consistency_loss

    def spy(*logits):
        seen.append([b.clone() for b in model.buffers()])
        return real(*logits)
    monkeypatch.setattr(training, "jensen_shannon_divergence_consistency_loss", spy)
    x = _t(_images(48))
    state = training.TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0), 0, _gen())
    losses = L.WeightedLosses(L.cross_entropy_loss)
    before = [b.clone() for b in model.buffers()]
    training.train_step(state, losses, {}, x, torch.zeros(N, dtype=torch.long),
                        views=[x.flip(2), x.flip(1)], jsd_weight=12.0)
    clean_only = DeepcvModule((H, W, 3), _bn_classifier(), device="cpu")
    clean_only.load_state_dict({k: v for k, v in model.state_dict().items()}, strict=False)
    for b, saved in zip(clean_only.buffers(), before):
        b.copy_(saved)
    clean_only.train()(x)
    for got, want in zip(seen[0], clean_only.buffers()):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mixing_with_augmix_jsd_is_refused_as_in_jax(tmp_path):
    model = DeepcvModule((H, W, 3), _small_classifier(), device="cpu")
    with pytest.raises(ValueError, match="cannot combine with augmix_jsd"):
        training.train(_train_hp(tmp_path, mixup_alpha=0.2, augmix_jsd={"weight": 1.0}),
                       model, L.cross_entropy_loss, _train_sets())

"""The port's augmentation path against the JAX package's, on the CPU: the
photometric transforms, K1's plain version against the Pallas kernel in
interpret mode, the recipe (its steps, gate, refusals and draws), and
``batch_transform``'s choice between the K1 route and the eager chain.
Inputs come from a numpy seed; the JAX side runs as its own tests run it."""
import ctypes
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.data import augmentation as JA
from deepcv_tpu.data import transforms as JT
from deepcv_tpu.ops.pallas.fused_augment import fused_augment_normalize as pallas_k1
from deepcv_tpu_torch.data import augmentation as A
from deepcv_tpu_torch.data import preprocess as P
from deepcv_tpu_torch.data import transforms as T
from deepcv_tpu_torch.data.datasets import load_dataset
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.ops.kernels import fused_augment as K1
from deepcv_tpu_torch.ops.kernels.fused_augment import (
    fused_augment_normalize, plain_fused_augment_normalize)
from deepcv_tpu_torch.utils import get_by_identifier

TOL = 1e-5  # the transforms bound of tests/test_pallas.py
MEAN, STD = [0.491, 0.482, 0.447], [0.247, 0.243, 0.261]
#: bench.py config 1's recipe, in K1's order
BENCH_RECIPE = {"augmentation_ops_depth": [1, 4],
                "transforms": [{"brightness": 0.2}, {"contrast": 0.1},
                               {"tweak_colors": 0.1}, {"gamma": 0.05}, {"noise": 0.1}]}


def _images(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape).astype(dtype)


def _factors(seed, n, lo=0.6, hi=1.4):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


# --------------------------------------------------------------------------- #
# Photometric transforms
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["adjust_brightness", "adjust_contrast", "adjust_saturation",
                                  "adjust_color", "tweak_colors", "adjust_gamma", "gamma"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (2, 4, 4, 1), (2, 3, 6, 4)])
@pytest.mark.parametrize("scalar", [False, True])
def test_photometric_transform_matches_jax(name, shape, scalar):
    x = _images(0, shape)
    fac = 1.3 if scalar else _factors(1, shape[0])
    ours = get_by_identifier(name)(torch.from_numpy(x), fac if scalar else torch.from_numpy(fac))
    ref = JT.TRANSFORM_REGISTRY[name](jnp.asarray(x), fac if scalar else jnp.asarray(fac))
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("keep", [True, False])
def test_rgb_to_grayscale_matches_jax(channels, keep):
    x = _images(2, (2, 5, 3, channels))
    ours = T.rgb_to_grayscale(torch.from_numpy(x), keep_channels=keep)
    ref = JT.rgb_to_grayscale(jnp.asarray(x), keep_channels=keep)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_to_tensor_and_normalize_match_jax_exactly():
    u8 = _images(3, (2, 4, 4, 3), np.uint8)
    ours = T.normalize(T.to_tensor(torch.from_numpy(u8)), MEAN, STD)
    ref = JT.normalize(JT.to_tensor(jnp.asarray(u8)), MEAN, STD)
    np.testing.assert_array_equal(T.to_tensor(torch.from_numpy(u8)).numpy(),
                                  np.asarray(JT.to_tensor(jnp.asarray(u8))))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_contrast_grey_level_is_exact_integer_rounding():
    """Half-way means round up, as PIL's ``int(mean + 0.5)``: an image whose
    luma is half 10 and half 11 gets grey 11."""
    x = torch.zeros((1, 2, 1, 1))
    x[0, 0], x[0, 1] = 10 / 255, 11 / 255
    out = T.adjust_contrast(x, 0.0)
    assert torch.all(out * 255 == 11)


def test_gaussian_noise_statistics_and_generator():
    x = torch.full((4, 64, 64, 3), 0.5)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a, b = T.gaussian_noise(x, g1, 0.1), T.gaussian_noise(x, g2, 0.1)
    assert torch.equal(a, b)
    d = (a - x).flatten()
    # 49,152 draws: the mean's std is 0.1 / 222 = 4.5e-4, the std's 3.2e-4
    assert abs(d.mean().item()) < 3e-3 and abs(d.std().item() - 0.1) < 3e-3
    per_image = T.gaussian_noise(x, g1, torch.tensor([0.0, 0.05, 0.1, 0.2]))
    stds = (per_image - x).flatten(1).std(1)
    assert stds[0] == 0 and torch.allclose(stds[1:], torch.tensor([0.05, 0.1, 0.2]),
                                           rtol=0.05)


def test_transforms_are_registered_under_the_jax_names():
    for name, fn in JT.TRANSFORM_REGISTRY.items():
        ported = getattr(T, fn.__name__, None)
        if ported is not None:
            assert get_by_identifier(name) is ported, name
    assert get_by_identifier("tweak_colors") is T.adjust_saturation
    assert get_by_identifier("noise") is T.gaussian_noise


# --------------------------------------------------------------------------- #
# K1's plain version against the Pallas kernel
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(4, 8, 8, 3), (6, 5, 9, 3), (2, 32, 32, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_matches_pallas_kernel_in_interpret_mode(shape, seed):
    n = shape[0]
    u8 = _images(seed, shape, np.uint8)
    facs = [_factors(seed * 10 + i, n) for i in range(4)]
    ref = pallas_k1(jnp.asarray(u8), *map(jnp.asarray, facs), None, MEAN, STD,
                    batch_tile=2, interpret=True)
    ours = fused_augment_normalize(torch.from_numpy(u8), *map(torch.from_numpy, facs),
                                   None, MEAN, STD)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    chain = JT.normalize(JT.adjust_gamma(JT.adjust_saturation(JT.adjust_contrast(
        JT.adjust_brightness(JT.to_tensor(jnp.asarray(u8)), facs[0]), facs[1]), facs[2]),
        facs[3]), MEAN, STD)
    np.testing.assert_allclose(ours.numpy(), np.asarray(chain), atol=TOL, rtol=0)


def test_k1_neutral_factors_are_pure_preprocess():
    u8 = _images(5, (2, 8, 8, 3), np.uint8)
    ones = np.ones((2,), np.float32)
    ref = pallas_k1(jnp.asarray(u8), *[jnp.asarray(ones)] * 4, None, [0.5] * 3, [0.25] * 3,
                    batch_tile=2, interpret=True)
    ours = fused_augment_normalize(torch.from_numpy(u8), *[torch.from_numpy(ones)] * 4,
                                   None, [0.5] * 3, [0.25] * 3)
    pure = T.normalize(T.to_tensor(torch.from_numpy(u8)), [0.5] * 3, [0.25] * 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(ours.numpy(), pure.numpy(), atol=TOL, rtol=0)


def test_k1_wrapper_on_the_cpu_takes_the_plain_version_and_launches_nothing():
    u8 = torch.from_numpy(_images(6, (3, 6, 6, 3), np.uint8))
    f = torch.from_numpy(_factors(7, 3))
    before = fused_augment_normalize.launches
    got = fused_augment_normalize(u8, f, f, f, f, None, MEAN, STD, out_dtype=torch.bfloat16)
    ref = plain_fused_augment_normalize(u8, f, f, f, f, None, MEAN, STD)
    assert fused_augment_normalize.launches == before
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.to(torch.bfloat16), atol=0, rtol=0)


def test_k1_noise_is_keyed_by_the_seed():
    u8 = torch.full((2, 16, 16, 3), 128, dtype=torch.uint8)
    one = torch.ones(2)
    sigma = torch.tensor([0.1, 0.0])
    run = lambda s: fused_augment_normalize(u8, one, one, one, one, sigma, [0.0] * 3,
                                            [1.0] * 3, seed=s)
    a, b, c = run(3), run(torch.tensor([3])), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    clean = fused_augment_normalize(u8, one, one, one, one, None, [0.0] * 3, [1.0] * 3)
    assert torch.equal(a[1], clean[1])           # sigma 0: no noise
    d = (a[0] - clean[0]).flatten()
    assert abs(d.mean().item()) < 0.01 and abs(d.std().item() - 0.1) < 0.01


@pytest.mark.parametrize("bad,err", [
    (dict(images=torch.zeros((2, 4, 4, 1), dtype=torch.uint8)), ValueError),
    (dict(images=torch.zeros((2, 4, 4, 3))), TypeError),
    (dict(brightness=torch.ones(3)), ValueError),
    (dict(brightness=torch.ones(2, dtype=torch.float64)), ValueError),
    (dict(mean=[0.5, 0.5]), ValueError),
    (dict(out_dtype=torch.float16), TypeError),
    (dict(seed=torch.tensor([1.0])), ValueError),
])
def test_k1_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    args = dict(images=torch.zeros((2, 4, 4, 3), dtype=torch.uint8), brightness=torch.ones(2),
                mean=[0.5] * 3, out_dtype=torch.float32, seed=0)
    args.update(bad)
    one = torch.ones(2)
    with pytest.raises(err):
        fused_augment_normalize(args["images"], args["brightness"], one, one, one, None,
                                args["mean"], [0.25] * 3, seed=args["seed"],
                                out_dtype=args["out_dtype"])


# --------------------------------------------------------------------------- #
# K1's CUDA kernel on the CPU: a model of its plans and work split, its
# byte tables, its C interface (the kernel itself runs only on the card)
# --------------------------------------------------------------------------- #

K1_SRC = (_build.CSRC_DIR / "fused_augment.cu").read_text()


def _k1_constants():
    """The kernel's ``constexpr int`` constants, read from its source."""
    c = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", K1_SRC):
        c[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(c))  # C ints
    return c


C = _k1_constants()
WARP_MAX = C["kWarpPlanMaxPixels"]


def _k1_plan(n, hw):
    """The launcher's plan: (warp plan, blocks, dynamic shared memory)."""
    if hw <= WARP_MAX:
        slot = C["kTableBytes"] + C["kStageBytes"] + (3 * hw + 15) // 16 * 16
        return True, -(-n // C["kWarps"]), C["kWarps"] * slot
    return False, n, C["kBlockPlanSmem"]


def _k1_work(n, hw, pix, warp_plan):
    """The kernel's loops for lanes of ``pix`` pixels (4 for float32 out, 8
    for bfloat16), under the plan given: the flat pixels pass 1 sums, the
    flat output elements pass 2 stores (stage position -> element), and
    (image, element, Philox counter, word) of every noise draw a lane keeps."""
    ch, lanes = 32 * pix, np.arange(32)
    blocks = -(-n // C["kWarps"]) if warp_plan else n
    luma, stores, noise = [], [], []
    for b in range(blocks):
        for warp in range(C["kWarps"]):
            if warp_plan:
                img, first, stride = b * C["kWarps"] + warp, 0, 1
                if img >= n:
                    continue
            else:
                img, first, stride = b, warp, C["kWarps"]
            for q0 in range(first * ch, hw, stride * ch):
                p = q0 + lanes * pix
                valid = 3 * np.minimum(pix, hw - p)
                for k in range(pix):                      # pass 1
                    luma.append(img * hw + (p + k)[3 * k < valid])
                i = np.arange(3 * pix)                    # pass 2: lane's elements
                e = 3 * p[:, None] + i                    # element in the image
                keep = i < valid[:, None]
                j = 3 * p[:, None] // 4 + i // 4          # j0 + i / 4
                noise.append(np.stack([np.full(e[keep].shape, img), e[keep], j[keep],
                                       (i % 4 * np.ones_like(e))[keep]], 1))
                # lane L writes its element i to stage uint4 3L + i // pix,
                # word i % pix: stage position (3L + i // pix) * pix + i % pix;
                # the warp stores positions 0 .. nvalid - 1 to 3 * q0 + position
                pos = (3 * lanes[:, None] + i // pix) * pix + i % pix
                nvalid = 3 * min(ch, hw - q0)
                assert np.array_equal(pos, e - 3 * q0)
                stores.append(img * hw * 3 + 3 * q0 + np.arange(nvalid))
    return np.concatenate(luma), np.concatenate(stores), np.concatenate(noise)


#: 224x224, 13x29, 1x1, and the plans' threshold (32x32) and 1 pixel each side of it
K1_HW = [224 * 224, 13 * 29, 1, WARP_MAX - 1, WARP_MAX, WARP_MAX + 1]


@pytest.mark.parametrize("pix", [4, 8])
@pytest.mark.parametrize("hw", K1_HW)
def test_k1_work_split_writes_each_element_once_and_sums_each_pixel_once(hw, pix):
    n = 2 if hw > 4 * WARP_MAX else 11          # 11: a partial block of warps
    warp_plan, blocks, smem = _k1_plan(n, hw)
    assert warp_plan == (hw <= 1024) and blocks == (-(-n // 8) if warp_plan else n)
    assert smem <= 48 * 1024 and smem % 16 == 0  # no opt-in; cp.async lands on 16 bytes
    luma, stores, _ = _k1_work(n, hw, pix, warp_plan)
    assert np.array_equal(np.bincount(luma, minlength=n * hw), np.ones(n * hw))
    assert np.array_equal(np.bincount(stores, minlength=n * hw * 3), np.ones(n * hw * 3))


@pytest.mark.parametrize("hw", [32 * 32, 13 * 29, WARP_MAX + 1, 3 * 1000 + 7])
def test_k1_noise_counter_is_keyed_by_element_under_both_plans(hw):
    n = 10
    draws = [_k1_work(n, hw, pix, plan)[2] for plan in (True, False) for pix in (4, 8)]
    img, e, j, word = draws[0].T
    assert np.array_equal(j, e // 4) and np.array_equal(word, e % 4)
    assert len(np.unique(img * 3 * hw + e)) == len(e) == n * hw * 3
    key = lambda d: d[np.lexsort((d[:, 1], d[:, 0]))]  # noqa: E731
    for d in draws[1:]:
        assert np.array_equal(key(d), key(draws[0]))


def _edge_factors():
    """Brightness factors that put some byte's A[u] * 255 within an ulp of a
    rint tie (k + 0.5), each with its float32 neighbours, and plain ones."""
    out = [1.0, 0.6, 1.4, 0.0, 2.5]
    for k, u in ((127, 200), (64, 129), (200, 255), (3, 17), (254, 255), (100, 101)):
        f = np.float32((k + 0.5) / u)
        out += [f, np.nextafter(f, np.float32(0)), np.nextafter(f, np.float32(2))]
    return [np.float32(f) for f in out]


@pytest.mark.parametrize("fb", _edge_factors())
def test_k1_byte_tables_are_bit_identical_to_the_per_element_chain(fb):
    """The kernel's tables, emulated in numpy float32 with its operations
    (an IEEE quotient, one rounding a product, rint half to even): A[u] and
    Q[u] against the plain version's brightness and its rounding to uint8,
    B[u] against its contrast blend, at every byte, bit for bit."""
    u = np.arange(256, dtype=np.float32)
    a = np.clip(fb * (u / np.float32(255)), 0, 1)
    q = np.rint(a * np.float32(255)).astype(np.int32)
    x = T.adjust_brightness(T.to_tensor(torch.arange(256, dtype=torch.uint8)
                                        .reshape(1, 256, 1, 1).expand(1, 256, 1, 3)),
                            torch.tensor([fb]))
    assert np.array_equal(a.view(np.int32), x[0, :, 0, 0].numpy().view(np.int32))
    assert np.array_equal(q, torch.round(x * 255.0).to(torch.int32)[0, :, 0, 0].numpy())
    for level, fc in ((0, 0.7), (128, np.float32(1.1)), (255, np.float32(0.9)), (77, 1.0)):
        grey = np.float32(level) / np.float32(255)
        b = np.clip(grey + np.float32(fc) * (a - grey), 0, 1)
        ref = T._blend(x, torch.tensor(grey).reshape(1, 1, 1, 1), torch.tensor([fc],
                                                                            dtype=torch.float32))
        assert np.array_equal(b.view(np.int32), ref[0, :, 0, 0].numpy().view(np.int32))


def test_k1_edge_factors_reach_rint_ties():
    """At least one byte of each constructed edge factor lands within 2 ulp
    of a rint tie, so the table test above tests rounding where it bites."""
    u = np.arange(256, dtype=np.float32)
    for fb in _edge_factors()[5:]:
        y = np.clip(fb * (u / np.float32(255)), 0, 1) * np.float32(255)
        gap = np.abs(y - (np.floor(y) + np.float32(0.5)))
        assert gap.min() <= 2 * np.spacing(np.float32(255))


def test_k1_c_launcher_takes_the_wrappers_argtypes():
    assert not re.search(r"#include\s*[<\"](torch|ATen|c10|pybind11)", K1_SRC)
    assert "deepcv_tpu/ops/pallas/fused_augment.py::_kernel" in K1_SRC
    m = re.search(r'extern "C" int fused_augment_normalize_launch\(([^)]*)\)', K1_SRC)
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    assert [ctype[p] for p in params] == list(K1._ARGTYPES)
    # one kernel template, two instantiations; no cluster launch, no switch
    assert K1_SRC.count("__global__") == 1
    assert "cudaLaunchKernelEx" not in K1_SRC and "cluster" not in K1_SRC.lower()
    assert "#if" not in K1_SRC and "getenv" not in K1_SRC


# --------------------------------------------------------------------------- #
# The recipe
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("recipe", [
    BENCH_RECIPE,
    {"transforms": [{"brightness": 0.2}, {"contrast": False}, {"gamma": 0},
                    {"smooth_non_linear_deformation": True}, "noise"]},
    {"augmentation_ops_depth": [2, 2], "transforms": [{"tweak_colors": 0.3}]},
    {"augmentation_ops_depth": [0, 1], "transforms": [{"gamma": 0.05}, {"contrast": 0.1},
                                                      {"brightness": 0.2}]},
    {"transforms": []},
])
def test_recipe_steps_and_gate_match_jax(recipe):
    ours, ref = A.apply_augmentation_recipe(recipe), JA.apply_augmentation_recipe(recipe)
    assert ours.steps == ref.steps
    assert ours.severities == [(n, float(s)) for n, s in ref._steps]
    assert ours.gate_p == pytest.approx(ref.gate_p, abs=0)
    assert pickle.loads(pickle.dumps(ours)).severities == ours.severities


@pytest.mark.parametrize("recipe,match", [
    ({"transforms": [{"posterize": 0.05}]}, "posterize"),
    ({"transforms": [{"rotate": [-0.4, 0.4]}]}, "rotate"),
    ({"transforms": [{"crop": 0.1}]}, "crop"),
    ({"transforms": [{"brightness": 0.2}], "augmix": [{"augmentation_chains_count": [1, 3]}]},
     "augmix"),
    ({"transforms": [{"brightness": 0.2}], "rand_augment": {"n": 2}}, "rand_augment"),
    ({"transforms": [{"brightness": 0.2}], "random_erasing": {"p": 0.5}}, "random_erasing"),
])
def test_unported_recipe_entries_raise_naming_them(recipe, match):
    """These entries were refused until the rest of augmentation was ported;
    now each compiles to the JAX package's steps, gate and sections, and
    leaves K1's route."""
    ours, ref = A.apply_augmentation_recipe(recipe), JA.apply_augmentation_recipe(recipe)
    assert ours.steps == ref.steps
    assert ours.gate_p == pytest.approx(ref.gate_p, abs=0)
    assert (ours.augmix_spec, ours.rand_augment, ours.random_erasing) == \
        (ref.augmix_spec, ref.rand_augment, ref.random_erasing)
    assert match in ours.steps or getattr(ours, {"augmix": "augmix_spec"}.get(match, match))
    assert not ours.fits_k1()


def test_unknown_recipe_entries_are_value_errors_in_both_packages():
    for mod in (A, JA):
        with pytest.raises(ValueError, match="no_such_op"):
            mod.apply_augmentation_recipe({"transforms": [{"no_such_op": 0.1}]})


def test_fits_k1_is_the_subsequence_rule():
    assert A.apply_augmentation_recipe(BENCH_RECIPE).fits_k1()
    assert A.apply_augmentation_recipe({"transforms": [{"gamma": 0.1}]}).fits_k1()
    assert not A.apply_augmentation_recipe(
        {"transforms": [{"contrast": 0.1}, {"brightness": 0.2}]}).fits_k1()
    assert not A.apply_augmentation_recipe(
        {"transforms": [{"brightness": 0.1}, {"brightness": 0.2}]}).fits_k1()


N_STAT = 4096
#: a two-level colour image: left column (60, 120, 200), right (180, 90, 30)
_LO, _HI = np.array([60, 120, 200], np.uint8), np.array([180, 90, 30], np.uint8)


def _stat_batch():
    u8 = np.empty((N_STAT, 2, 2, 3), np.uint8)
    u8[:, :, 0], u8[:, :, 1] = _LO, _HI
    return u8


def _recovered(step, out, x0):
    """(share of images the one-step recipe changed, the factors it drew on
    them): a ratio of differences for the blends, a log ratio for gamma,
    and for noise the pooled deviations."""
    moved = np.abs(out - x0).reshape(len(out), -1).max(1) > 1e-6
    o, x = out[moved], x0[moved]
    if step == "brightness":
        f = o[:, 0, 0, 0] / x[:, 0, 0, 0]
    elif step == "contrast":         # blends with one grey: right minus left
        f = (o[:, 0, 1, 0] - o[:, 0, 0, 0]) / (x[:, 0, 1, 0] - x[:, 0, 0, 0])
    elif step == "tweak_colors":     # blends with the pixel's grey: blue minus red
        f = (o[:, 0, 0, 2] - o[:, 0, 0, 0]) / (x[:, 0, 0, 2] - x[:, 0, 0, 0])
    elif step == "gamma":
        f = np.log(o[:, 0, 0, 0]) / np.log(x[:, 0, 0, 0])
    else:
        f = (o - x).ravel()
    return moved.mean(), f


@pytest.mark.parametrize("step,sev", [("brightness", 0.2), ("contrast", 0.1),
                                      ("tweak_colors", 0.1), ("gamma", 0.05), ("noise", 0.1)])
def test_recipe_gate_rate_and_factor_distribution_match_jax(step, sev):
    """torch and jax.random draw different bits: compare the gate rate and
    the factors' mean and spread. With ops depth [0, 1] and one step the
    gate is 0.5; 4,096 images put the rate's std at 0.008 and the spread's
    relative error near 1.6 %. The JAX recipe, the port's eager chain and
    the port's K1 route (plain version on the CPU) all pass."""
    recipe = {"augmentation_ops_depth": [0, 1], "transforms": [{step: sev}]}
    u8 = _stat_batch()
    x0 = u8.astype(np.float32) / 255.0
    ref = np.asarray(JA.apply_augmentation_recipe(recipe)(
        JT.to_tensor(jnp.asarray(u8)), jax.random.PRNGKey(0)))
    eager = A.apply_augmentation_recipe(recipe)(
        T.to_tensor(torch.from_numpy(u8)), torch.Generator().manual_seed(0)).numpy()
    ds = P.PreprocessedDataset(None, P.parse_transforms_specification(["to_tensor"]),
                               A.apply_augmentation_recipe(recipe))
    k1 = ds.batch_transform(torch.from_numpy(u8), torch.Generator().manual_seed(1)).numpy()
    for label, out in (("jax", ref), ("eager", eager), ("k1", k1)):
        rate, f = _recovered(step, out, x0)
        assert abs(rate - 0.5) < 0.04, (label, rate)
        if step == "noise":          # clipping at 0 and 1 trims the spread a little
            assert abs(f.mean()) < 2e-3 and abs(f.std() - sev) < 0.05 * sev, (label, f.std())
        elif step == "gamma":        # log g = sev * N(0, 1)
            assert abs(np.log(f).mean()) < 0.1 * sev, (label, np.log(f).mean())
            assert abs(np.log(f).std() - sev) < 0.1 * sev, (label, np.log(f).std())
        else:                        # f = 1 + sev * N(0, 1)
            assert abs(f.mean() - 1.0) < 0.1 * sev, (label, f.mean())
            assert abs(f.std() - sev) < 0.1 * sev, (label, f.std())


# --------------------------------------------------------------------------- #
# batch_transform: the K1 route and the eager chain
# --------------------------------------------------------------------------- #

def _dataset(recipe, transforms=("to_tensor", {"normalize": {"mean": MEAN, "std": STD}})):
    entry = {"type": "synthetic", "n": 8, "image_shape": [6, 6, 3], "num_classes": 2}
    return P.PreprocessedDataset(load_dataset(entry),
                                 P.parse_transforms_specification(list(transforms)),
                                 A.apply_augmentation_recipe(recipe) if recipe else None)


@pytest.fixture
def k1_calls(monkeypatch):
    calls = []

    def fake(images, *args, **kw):
        calls.append((images, args, kw))
        return plain_fused_augment_normalize(images, *args, **kw)
    monkeypatch.setattr(P, "fused_augment_normalize", fake)
    return calls


def _routes():
    return dict(P.PreprocessedDataset.batch_transform.routes)


def test_k1_route_for_a_uint8_rgb_batch_with_a_k1_order_recipe(k1_calls):
    ds = _dataset(BENCH_RECIPE)
    x = torch.from_numpy(ds.dataset.images)
    before = _routes()
    y = ds.batch_transform(x, torch.Generator().manual_seed(0))
    assert _routes() == {"K1": before["K1"] + 1, "eager": before["eager"]}
    (images, args, kw), = k1_calls
    assert images is x
    assert args[5:7] == (MEAN, STD)               # K1 does the normalize
    assert args[4] is not None and kw["seed"].dtype == torch.int64   # noise on
    assert y.shape == x.shape and y.dtype == torch.float32


@pytest.mark.parametrize("case", ["other_order", "one_channel", "float_batch"])
def test_eager_route_otherwise(k1_calls, case):
    recipe = {"transforms": [{"contrast": 0.1}, {"brightness": 0.2}]} \
        if case == "other_order" else BENCH_RECIPE
    ds = _dataset(recipe, ["to_tensor"])
    x = torch.from_numpy(ds.dataset.images)
    if case == "one_channel":
        x = x[..., :1].contiguous()
    elif case == "float_batch":
        x = x.float() / 255
    before = _routes()
    y = ds.batch_transform(x, torch.Generator().manual_seed(0))
    assert not k1_calls
    assert _routes() == {"K1": before["K1"], "eager": before["eager"] + 1}
    assert y.shape == x.shape and 0 <= y.min() and y.max() <= 1


def test_k1_route_leaves_other_transforms_after_it(k1_calls):
    norm = {"normalize": {"mean": MEAN, "std": STD}}
    ds = _dataset({"transforms": [{"gamma": 0.05}]}, ["to_tensor", norm, norm])
    x = torch.from_numpy(ds.dataset.images)
    y = ds.batch_transform(x, torch.Generator().manual_seed(0))
    (_, args, kw), = k1_calls
    assert args[4] is None and args[5:7] == ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    plain = plain_fused_augment_normalize(x, *args[:5], (0.0,) * 3, (1.0,) * 3)
    torch.testing.assert_close(y, T.normalize(T.normalize(plain, MEAN, STD), MEAN, STD))


def test_k1_route_equals_the_eager_chain_without_noise():
    """Both routes draw, per step, the gates and then the factors from the
    generator, so without noise they give the same batch up to the float
    rounding of a gated-off step."""
    recipe = {"augmentation_ops_depth": [1, 3], "transforms": BENCH_RECIPE["transforms"][:4]}
    ds = _dataset(recipe)
    x = torch.from_numpy(_images(9, (64, 8, 8, 3), np.uint8))
    k1 = ds.batch_transform(x, torch.Generator().manual_seed(5))
    eager = ds.transform(ds.augmentation(T.to_tensor(x), torch.Generator().manual_seed(5)))
    np.testing.assert_allclose(k1.numpy(), eager.numpy(), atol=TOL, rtol=0)
    assert not torch.allclose(k1, ds.batch_transform(x, augment=False))


def test_batch_transform_needs_a_generator_to_augment_and_not_to_validate():
    ds = _dataset(BENCH_RECIPE)
    x = torch.from_numpy(ds.dataset.images)
    with pytest.raises(ValueError, match="Generator"):
        ds.batch_transform(x)
    torch.testing.assert_close(ds.batch_transform(x, augment=False),
                               T.normalize(T.to_tensor(x), MEAN, STD))


def test_preprocess_augments_the_trainset_only_and_takes_the_reference_spelling():
    entry = {"type": "synthetic", "n": 30, "image_shape": [6, 6, 3], "num_classes": 4}
    params = {"seed": 0, "split_dataset": {"validset_ratio": 0.2},
              "transforms": ["to_tensor"], "augmentation_reciepe": BENCH_RECIPE}
    out = P.preprocess({"trainset": load_dataset(entry)}, params)
    assert out["trainset"].augmentation.steps == [list(d)[0] for d in
                                                  BENCH_RECIPE["transforms"]]
    assert out["validset"].augmentation is None

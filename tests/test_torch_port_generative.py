"""SinGAN, wave function collapse and the visualisation helpers of the port
against the JAX package, on the CPU: SinGAN's pyramid shapes, resize and
conv stack, and one D and G iteration from carried weights and fed-in
noise; WFC's adjacency and propagation fixpoint, generations that satisfy
their constraints, the growing grid, the learned tiles and their rendering;
``make_grid``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepcv_tpu.data import singan as jsingan
from deepcv_tpu.data import viz as jviz
from deepcv_tpu.data import wfc as jwfc
from deepcv_tpu_torch.data import singan as tsingan
from deepcv_tpu_torch.data import viz as tviz
from deepcv_tpu_torch.data import wfc as twfc
from deepcv_tpu_torch.interop import load_jax_variables

#: resize and the conv stack, port against JAX
OP_TOL = 1e-5
#: one SinGAN iteration's losses and weights from carried weights
STEP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread here: the suite runs several workers at once,
    and a thread pool on these small tensors only contends with them (a
    SinGAN fit ran 150 times slower with the default pool under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# sea (0), coast (1), land (2): land never touches sea in the exemplar
TERRAIN = np.array([[0, 0, 1, 2, 2],
                    [0, 1, 1, 2, 2],
                    [1, 1, 2, 2, 2],
                    [0, 1, 1, 1, 2],
                    [0, 0, 1, 2, 2]], dtype=np.int32)


# --------------------------------------------------------------------------- #
# SinGAN
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("hw,n,f,m", [((16, 16), 3, 0.5, 6), ((50, 37), 4, 0.75, 6),
                                      ((9, 30), 2, 0.5, 8)])
def test_pyramid_shapes_equal_jax(hw, n, f, m):
    assert tsingan.pyramid_shapes(*hw, n, f, m) == jsingan._pyramid_shapes(*hw, n, f, m)


@pytest.mark.parametrize("src,dst", [((12, 10), (6, 5)), ((12, 10), (25, 18)), ((7, 9), (9, 4))])
def test_resize_equals_jax(src, dst):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(np.float32)
    ref = np.asarray(jsingan._resize(jnp.asarray(x), *dst))
    np.testing.assert_allclose(tsingan._resize(torch.from_numpy(x), *dst).numpy(), ref,
                               atol=OP_TOL)


def _stacks(features=8, seed=0):
    real = jnp.asarray(np.random.default_rng(seed).uniform(-1, 1, (1, 12, 10, 3))
                       .astype(np.float32))
    g = jsingan._ConvStack(features=features, out_channels=3, final_act="tanh")
    d = jsingan._ConvStack(features=features, out_channels=1)
    gv, dv = g.init(jax.random.PRNGKey(seed), real), d.init(jax.random.PRNGKey(seed + 1), real)
    tg = tsingan.ConvStack(3, features, 3, final_act="tanh")
    td = tsingan.ConvStack(3, features, 1)
    load_jax_variables(tg, jax.tree.map(np.asarray, gv))
    load_jax_variables(td, jax.tree.map(np.asarray, dv))
    return real, (g, gv, tg), (d, dv, td)


@pytest.mark.parametrize("which", ("generator", "discriminator"))
def test_conv_stack_equals_jax(which):
    real, gen, dsc = _stacks()
    mod, v, port = gen if which == "generator" else dsc
    x = jnp.asarray(np.random.default_rng(3).normal(0, 2, (2, 12, 10, 3)).astype(np.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(got, np.asarray(mod.apply(v, x)), atol=OP_TOL)
    assert port.GroupNorm_0.eps == 1e-6


def test_singan_step_from_carried_weights_and_fed_noise():
    """Two iterations of train_singan's step, written as the JAX package's
    scan body is, against :func:`singan_step` on the same weights and
    noise."""
    real, (g, gv, tg), (d, dv, td) = _stacks()
    rng = np.random.default_rng(5)
    prev = jnp.asarray(rng.uniform(-1, 1, real.shape).astype(np.float32))
    zs = [jnp.asarray(0.3 * rng.standard_normal(real.shape).astype(np.float32))
          for _ in range(2)]
    z_rec, lr, rec_weight = jnp.zeros_like(real), 5e-4, 10.0
    g_tx, d_tx = optax.adam(lr, b1=0.5), optax.adam(lr, b1=0.5)
    g_opt, d_opt = g_tx.init(gv), d_tx.init(dv)

    def fake_fn(gp, z, prev):
        return prev + g.apply(gp, prev + z)

    def d_loss(dp, gp, z, prev):
        fake = jax.lax.stop_gradient(fake_fn(gp, z, prev))
        return jnp.mean((d.apply(dp, real) - 1.0) ** 2) + jnp.mean(d.apply(dp, fake) ** 2)

    def g_loss(gp, dp, z, prev):
        adv = jnp.mean((d.apply(dp, fake_fn(gp, z, prev)) - 1.0) ** 2)
        rec = jnp.mean((fake_fn(gp, z_rec, prev) - real) ** 2)
        return adv + rec_weight * rec, rec

    @jax.jit
    def step(gv, dv, g_opt, d_opt, z):
        du, d_opt = d_tx.update(jax.grad(d_loss)(dv, gv, z, prev), d_opt)
        dv = optax.apply_updates(dv, du)
        (gl, rec), gg = jax.value_and_grad(g_loss, has_aux=True)(gv, dv, z, prev)
        gu, g_opt = g_tx.update(gg, g_opt)
        return optax.apply_updates(gv, gu), dv, g_opt, d_opt, gl, rec

    ref = []
    for z in zs:
        gv, dv, g_opt, d_opt, gl, rec = step(gv, dv, g_opt, d_opt, z)
        ref.append((float(gl), float(rec)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    g_adam, d_adam = tsingan._adam(tg, lr), tsingan._adam(td, lr)
    got = [tuple(float(v) for v in tsingan.singan_step(tg, td, g_adam, d_adam, t(real), t(prev),
                                                        t(z), t(prev), t(z_rec), rec_weight))
           for z in zs]
    np.testing.assert_allclose(got, ref, rtol=STEP_TOL, atol=STEP_TOL)
    for port, v in ((tg, gv), (td, dv)):
        want = tsingan.ConvStack(3, 8, port.Conv_4.out_channels)
        load_jax_variables(want, jax.tree.map(np.asarray, v))
        for k, val in want.state_dict().items():
            np.testing.assert_allclose(port.state_dict()[k].numpy(), val.numpy(), atol=STEP_TOL,
                                       err_msg=k)


@pytest.fixture(scope="module")
def trained():
    y, x = np.mgrid[0:16, 0:16]
    img = np.stack([x / 15.0, y / 15.0, ((x // 4 + y // 4) % 2).astype(float)], -1)
    img = (img * 255).astype(np.uint8)
    return img, tsingan.train_singan(img, n_scales=2, steps_per_scale=20, features=8, seed=0,
                                     device="cpu")


def test_train_singan_reconstructs_and_samples(trained):
    img, (model, hist) = trained
    assert [s["shape"] for s in hist["scales"]] == [(8, 8), (16, 16)]
    assert hist["scales"][0]["noise_amp"] == 1.0 and hist["scales"][1]["noise_amp"] > 0
    for s in hist["scales"]:
        assert np.isfinite([s["g_loss_first"], s["g_loss_last"]]).all()
        assert s["rec_last"] < s["rec_first"]
    rec = model.reconstruct()
    assert rec.shape == (1, 16, 16, 3) and float(rec.min()) >= 0 and float(rec.max()) <= 1
    again = tsingan.train_singan(img, n_scales=2, steps_per_scale=20, features=8, seed=0,
                                 device="cpu")[0].reconstruct()
    assert torch.equal(rec, again)                    # seeded: the same pyramid
    gen = torch.Generator().manual_seed(1)
    samples = model.sample(n=3, start_scale=1, generator=gen)
    assert samples.shape == (3, 16, 16, 3) and not torch.equal(samples[0], samples[1])


def test_harmonize_and_augmentation(trained):
    img, (model, _) = trained
    edited = img.astype(np.float32) / 255.0
    mask = np.zeros((16, 16, 1), np.float32)
    mask[4:8, 4:8] = 1.0
    out = model.harmonize(edited, start_scale=1, mask=mask)
    assert out.shape == (16, 16, 3)
    np.testing.assert_allclose(out.numpy()[mask[..., 0] == 0], edited[mask[..., 0] == 0])
    with pytest.raises(ValueError, match="start_scale"):
        model.harmonize(edited, start_scale=2)
    variants = tsingan.distilled_singan_augmentation(img, n_variants=2, n_scales=2,
                                                     steps_per_scale=4, features=8,
                                                     device="cpu")
    assert variants.shape == (2, 16, 16, 3)


# --------------------------------------------------------------------------- #
# Wave function collapse
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("wrap", (False, True))
def test_adjacency_equals_jax(wrap):
    for ex in (TERRAIN, (np.add.outer(np.arange(6), np.arange(6)) % 2).astype(np.int32)):
        got, ref = twfc.adjacency_from_exemplar(ex, wrap=wrap), \
            jwfc.adjacency_from_exemplar(ex, wrap=wrap)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(ValueError, match="2-D"):
        twfc.adjacency_from_exemplar(np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="range"):
        twfc.adjacency_from_exemplar(TERRAIN, n_tiles=2)


@pytest.mark.parametrize("wrap", (False, True))
@pytest.mark.parametrize("seed", (0, 1))
def test_propagation_fixpoint_equals_jax(seed, wrap):
    adj, _ = twfc.adjacency_from_exemplar(TERRAIN)
    wave = np.random.default_rng(seed).random((6, 7, 3)) > 0.3
    ref = np.asarray(jwfc._propagate(jnp.asarray(wave), jnp.asarray(adj, jnp.float32), wrap))
    got = twfc.propagate(torch.from_numpy(wave)[None], torch.from_numpy(adj).float(), wrap)[0]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("wrap", (False, True))
def test_every_generated_tilemap_satisfies_the_constraints(wrap):
    adj, w = twfc.adjacency_from_exemplar(TERRAIN, wrap=wrap)
    gen = torch.Generator().manual_seed(0)
    grids = twfc.sample_tilemaps(adj, w, (9, 11), 6, gen, wrap=wrap, device="cpu")
    assert grids.shape == (6, 9, 11) and grids.dtype == np.int32
    assert all(twfc.validate_tilemap(g, adj, wrap=wrap) for g in grids)
    assert all(jwfc.validate_tilemap(g, adj, wrap=wrap) for g in grids)
    assert len({g.tobytes() for g in grids}) > 1
    one = twfc.wave_function_collapse(adj, w, (5, 6), gen, wrap=wrap, device="cpu")
    assert one.shape == (5, 6) and twfc.validate_tilemap(one, adj, wrap=wrap)
    board = (np.add.outer(np.arange(6), np.arange(6)) % 2).astype(np.int32)
    cadj, cw = twfc.adjacency_from_exemplar(board)
    g = twfc.wave_function_collapse(cadj, cw, (7, 7), gen, device="cpu")
    assert len(np.unique((g + np.add.outer(np.arange(7), np.arange(7))) % 2)) == 1


def test_contradiction_raises():
    adj = np.zeros((4, 2, 2), bool)
    adj[0] = adj[1] = [[False, True], [True, False]]
    adj[2] = adj[3] = [[True, False], [False, True]]
    adj[2][1, 1] = adj[3][1, 1] = False              # tile 1 has no vertical partner
    w = np.array([0.01, 0.99], np.float32)
    with pytest.raises(RuntimeError, match="contradiction"):
        twfc.wave_function_collapse(adj, w, (4, 4), torch.Generator().manual_seed(0),
                                    max_restarts=1, device="cpu")
    with pytest.raises(ValueError, match="adjacency"):
        twfc.wave_function_collapse(adj[:, :1], w, (4, 4), device="cpu")


def test_growing_grid_equals_jax():
    data = np.random.default_rng(1).random((60, 5)).astype(np.float32)
    got = twfc.growing_grid(data, max_units=9, seed=2, device="cpu")
    ref = jwfc.growing_grid(data, max_units=9, seed=2)
    assert got[1] == ref[1]
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-6)


def test_learned_tiles_and_rendering_equal_jax():
    """On pixels in [0, 1]; at the 0-255 scale the float32 distances cancel
    enough that near-ties round differently in the two packages."""
    img = np.random.default_rng(3).random((16, 16, 3)).astype(np.float32)
    got = twfc.learn_tiles(img, tile_size=4, max_tiles=6, seed=0, device="cpu")
    ref = jwfc.learn_tiles(img, tile_size=4, max_tiles=6, seed=0)
    assert got["grid_shape"] == ref["grid_shape"]
    np.testing.assert_array_equal(got["tilemap"], ref["tilemap"])
    np.testing.assert_allclose(got["codebook"], ref["codebook"], atol=1e-5)
    np.testing.assert_array_equal(twfc.render_tilemap(ref["tilemap"], ref["codebook"]),
                                  jwfc.render_tilemap(ref["tilemap"], ref["codebook"]))
    tex = twfc.generate_texture(img, (5, 7), torch.Generator().manual_seed(0), tile_size=4,
                                max_tiles=6, device="cpu")
    assert tex.shape == (20, 28, 3) and np.isfinite(tex).all()
    with pytest.raises(ValueError, match="divisible"):
        twfc.learn_tiles(img[:15], tile_size=4, device="cpu")


# --------------------------------------------------------------------------- #
# Visualisation
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ("unit", "u8", "normalised", "gray"))
def test_make_grid_equals_jax(kind, tmp_path):
    rng = np.random.default_rng(0)
    x = {"unit": rng.random((5, 6, 7, 3)).astype(np.float32),
         "u8": rng.integers(0, 256, (5, 6, 7, 3), dtype=np.uint8),
         "normalised": rng.normal(0, 1, (5, 6, 7, 3)).astype(np.float32),
         "gray": rng.random((3, 6, 7, 1)).astype(np.float32)}[kind]
    if kind == "normalised":
        mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
        np.testing.assert_array_equal(tviz.to_uint8(x, mean, std), jviz.to_uint8(x, mean, std))
    np.testing.assert_array_equal(tviz.make_grid(x, n_cols=3), jviz.make_grid(x, n_cols=3))
    np.testing.assert_array_equal(tviz.make_grid(torch.from_numpy(np.asarray(x, np.float32))),
                                  jviz.make_grid(x))
    path = tviz.save_image_grid(x, tmp_path / "g" / "grid.png", n_cols=3,
                                labels=list(range(len(x))))
    from PIL import Image
    assert Image.open(path).size[::-1] == jviz.make_grid(x, n_cols=3).shape[:2]

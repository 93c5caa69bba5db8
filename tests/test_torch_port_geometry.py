"""The port's classical-vision modules against the JAX package's, on the
CPU: ORB features (Harris, BRIEF, orientations, descriptors, Hamming
matching, the scoring harness), geometry (phase correlation, stabilisation,
homographies and RANSAC fed the JAX point sets, stitching, sequence and
audio synchronisation, watermark removal) and Y4M video I/O with
``process_video``. Inputs come from a numpy seed, at small sizes: 32x32
images, clips of 4-8 frames."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.data import video_io as JV
from deepcv_tpu.pipelines import classical_features as JC
from deepcv_tpu.pipelines import geometry as JG
from deepcv_tpu_torch.data import video_io as V
from deepcv_tpu_torch.pipelines import classical_features as C
from deepcv_tpu_torch.pipelines import geometry as G

TOL = 1e-5            # harris (relative to its largest value), watermark
H_TOL = 1e-4          # homographies after H[2, 2] = 1
S = 32


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _blurred(seed, shape=(S, S, 3), sigma=1.5):
    """Smooth random images: corners and textures at a few pixels' scale."""
    x = np.random.default_rng(seed).random(shape)
    for axis in range(len(shape) - (1 if shape[-1] <= 4 else 0)):
        k = np.exp(-0.5 * (np.arange(-4, 5) / sigma) ** 2)
        x = np.apply_along_axis(lambda v: np.convolve(v, k / k.sum(), "same"), axis, x)
    return x.astype(np.float32)


# --------------------------------------------------------------------------- #
# Classical features
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["harris", "shi_tomasi"])
@pytest.mark.parametrize("window", [3, 5])
def test_harris_response_matches_jax(method, window):
    g = _blurred(0, (3, S, S), 1.2)
    ours = C.harris_response(_t(g), window=window, method=method).numpy()
    ref = np.asarray(JC.harris_response(jnp.asarray(g), window=window, method=method))
    assert np.abs(ours - ref).max() <= TOL * np.abs(ref).max()
    single = C.harris_response(_t(g[1]), window=window, method=method).numpy()
    np.testing.assert_array_equal(single, ours[1])


def test_brief_pattern_is_jaxs_bit_for_bit_and_bad_inputs_raise():
    np.testing.assert_array_equal(C.brief_pattern(), JC.brief_pattern())
    np.testing.assert_array_equal(C.brief_pattern(64, 15, 3), JC.brief_pattern(64, 15, 3))
    with pytest.raises(ValueError, match="odd"):
        C.harris_response(torch.zeros(8, 8), window=4)
    with pytest.raises(ValueError, match="harris"):
        C.harris_response(torch.zeros(8, 8), method="fast")


@pytest.mark.parametrize("seed", range(3))
def test_detect_and_describe_equals_jax(seed):
    img = _blurred(seed + 1)
    ca, da, va = C.detect_and_describe(_t(img), k=48, n_tests=128)
    jca, jda, jva = JC.detect_and_describe(jnp.asarray(img), k=48, n_tests=128)
    np.testing.assert_array_equal(ca.numpy(), np.asarray(jca))
    np.testing.assert_array_equal(va.numpy(), np.asarray(jva))
    np.testing.assert_array_equal(da.numpy(), np.asarray(jda))
    g = img.mean(-1)
    theta = C.intensity_orientations(_t(g), ca).numpy()
    np.testing.assert_allclose(theta, np.asarray(JC.intensity_orientations(
        jnp.asarray(g), jnp.asarray(ca.numpy()))), atol=1e-4, rtol=0)


def test_batched_detect_and_describe_is_each_images():
    imgs = np.stack([_blurred(s) for s in (5, 6, 7)])
    cb, db, vb = C.detect_and_describe(_t(imgs), k=32, n_tests=64)
    for i in range(3):
        c, d, v = C.detect_and_describe(_t(imgs[i]), k=32, n_tests=64)
        assert torch.equal(cb[i], c) and torch.equal(db[i], d) and torch.equal(vb[i], v)


def test_orb_descriptors_with_jax_orientations_and_without():
    g = _blurred(8, (S, S))
    coords = np.random.default_rng(9).integers(0, S, (20, 2))
    theta = np.random.default_rng(10).uniform(-np.pi, np.pi, 20).astype(np.float32)
    for th in (theta, None):
        ours = C.orb_descriptors(_t(g), _t(coords), None if th is None else _t(th), n_tests=96)
        ref = JC.orb_descriptors(jnp.asarray(g), jnp.asarray(coords),
                                 None if th is None else jnp.asarray(th), n_tests=96)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mutual,max_hamming", [(True, None), (False, 40)])
def test_match_hamming_and_the_orb_matcher_score_as_jax(mutual, max_hamming):
    a = _blurred(11, (40, 40, 3))
    img_a, img_b = a[4:36, 4:36], a[6:38, 3:35]          # b = a shifted by (-2, +1)
    h_true = np.array([[1, 0, -1], [0, 1, -2], [0, 0, 1]], np.float32)
    ours = C.evaluate_matchers(_t(img_a), _t(img_b), _t(h_true), {
        "orb": C.orb_matcher(k=48, n_tests=128, mutual=mutual, max_hamming=max_hamming)})
    ref = JC.evaluate_matchers(jnp.asarray(img_a), jnp.asarray(img_b), jnp.asarray(h_true), {
        "orb": JC.orb_matcher(k=48, n_tests=128, mutual=mutual, max_hamming=max_hamming)})
    assert ours == ref and ours["orb"]["n_correct"] > 0
    _, da, _ = C.detect_and_describe(_t(img_a), k=48, n_tests=128)
    _, db, _ = C.detect_and_describe(_t(img_b), k=48, n_tests=128)
    m, v = C.match_hamming(da, db, mutual=mutual, max_hamming=max_hamming)
    jm, jv = JC.match_hamming(jnp.asarray(da.numpy()), jnp.asarray(db.numpy()),
                              mutual=mutual, max_hamming=max_hamming)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_matching_precision_batched_is_per_pair():
    rng = np.random.default_rng(12)
    ca, cb = rng.integers(0, S, (2, 16, 2)), rng.integers(0, S, (2, 16, 2))
    m, v = rng.integers(0, 16, (2, 16)), rng.random((2, 16)) < 0.7
    h = np.eye(3, dtype=np.float32)
    batch = C.matching_precision(_t(ca), _t(cb), _t(m), _t(v), _t(h), tol=20.0)
    for i in range(2):
        ref = JC.matching_precision(jnp.asarray(ca[i]), jnp.asarray(cb[i]), jnp.asarray(m[i]),
                                    jnp.asarray(v[i]), jnp.asarray(h), tol=20.0)
        for k in ref:
            assert float(batch[k][i]) == pytest.approx(float(ref[k]), abs=1e-7), k


# --------------------------------------------------------------------------- #
# Geometry
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shift", [(0, 0), (3, -2), (-5, 7), (15, -16)])
def test_phase_correlation_shifts_equal_jax(shift):
    base = _blurred(13, (S, S), 1.0)
    a = np.roll(base, shift, (0, 1))
    ours = G.phase_correlation(_t(a), _t(base)).numpy()
    ref = np.asarray(JG.phase_correlation(jnp.asarray(a), jnp.asarray(base)))
    np.testing.assert_array_equal(ours, ref)
    wrapped = [s % S - S if s % S > S // 2 else s % S for s in shift]   # in (-S/2, S/2]
    assert tuple(ours) == tuple(float(s) for s in wrapped)


def test_stabilize_video_matches_jax():
    base = _blurred(14, (48, 48, 3))
    jitter = [(0, 0), (2, -1), (-1, 3), (3, 1), (0, -2), (1, 1)]
    clip = np.stack([np.roll(base, j, (0, 1))[8:40, 8:40] for j in jitter])
    ours, traj = G.stabilize_video(_t(clip), smoothing=3)
    rf, rtraj = JG.stabilize_video(jnp.asarray(clip), smoothing=3)
    np.testing.assert_array_equal(traj.numpy(), np.asarray(rtraj))
    np.testing.assert_allclose(ours.numpy(), np.asarray(rf), atol=TOL, rtol=0)


def _homography_pts(seed, n=40, outliers=10):
    rng = np.random.default_rng(seed)
    h = np.array([[1.05, 0.02, 3.0], [0.01, 0.98, -2.0], [1e-4, 2e-4, 1.0]], np.float32)
    pa = rng.uniform(0, 64, (n, 2)).astype(np.float32)
    ph = np.concatenate([pa, np.ones((n, 1), np.float32)], 1) @ h.T
    pb = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
    pb[n - outliers:] += rng.uniform(-20, 20, (outliers, 2)).astype(np.float32)
    return pa, pb


def _norm(h):
    h = np.asarray(h, np.float64)
    return h / h[2, 2]


def test_estimate_homography_matches_jax_weighted_and_batched():
    pa, pb = _homography_pts(15, outliers=0)
    w = np.random.default_rng(16).uniform(0.5, 1.5, len(pa)).astype(np.float32)
    for weights in (None, w):
        ours = G.estimate_homography(_t(pa), _t(pb), None if weights is None else _t(weights))
        ref = JG.estimate_homography(jnp.asarray(pa), jnp.asarray(pb),
                                     None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(_norm(ours.numpy()), _norm(ref), atol=H_TOL, rtol=0)
    batch = G.estimate_homography(_t(np.stack([pa[:10], pa[10:20]])),
                                  _t(np.stack([pb[:10], pb[10:20]])))
    for i, sl in enumerate((slice(0, 10), slice(10, 20))):
        np.testing.assert_allclose(_norm(batch[i].numpy()), _norm(JG.estimate_homography(
            jnp.asarray(pa[sl]), jnp.asarray(pb[sl]))), atol=H_TOL, rtol=0)


def _jax_sets(key, n, valid=None, n_iters=128, sample_size=6):
    v = jnp.ones((n,), bool) if valid is None else jnp.asarray(valid)
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key, (n_iters, n), minval=1e-6,
                                                  maxval=1.0)))
    return _t(jax.lax.top_k(jnp.where(v[None, :], gumbel, -jnp.inf), sample_size)[1])


@pytest.mark.parametrize("seed", range(2))
def test_ransac_homography_with_the_jax_sets_matches_jax(seed):
    pa, pb = _homography_pts(17 + seed)
    valid = np.ones(len(pa), bool)
    valid[:3] = False
    key = jax.random.PRNGKey(seed)
    h, inl = G.ransac_homography(_t(pa), _t(pb), _t(valid), sets=_jax_sets(key, len(pa), valid))
    jh, jinl = JG.ransac_homography(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid),
                                    key=key)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(_norm(h.numpy()), _norm(jh), atol=H_TOL, rtol=0)
    assert int(inl.sum()) == 27


def test_ransac_draws_their_own_sets_over_valid_points():
    valid = torch.arange(30) % 3 != 0
    sets = G.ransac_sets(30, valid, torch.Generator().manual_seed(1), 256, 6)
    assert sets.shape == (256, 6) and bool(valid[sets].all())
    assert all(len(set(r.tolist())) == 6 for r in sets)
    pa, pb = _homography_pts(19)
    h, inl = G.ransac_homography(_t(pa), _t(pb), generator=torch.Generator().manual_seed(2))
    assert bool(inl[:30].all()) and int(inl.sum()) <= 32


def test_stitch_pair_with_the_jax_sets_matches_jax():
    base = _blurred(20, (S, 48, 3), 1.2)
    img_a, img_b = base[:, :S], base[:, 12:12 + S]
    key = jax.random.PRNGKey(3)
    jpano, jh, jinl = JG.stitch_pair(jnp.asarray(img_a), jnp.asarray(img_b), k=64, key=key)
    pano, h, inl = G.stitch_pair(_t(img_a), _t(img_b), k=64,
                                 sets=_jax_sets(key, 64, None))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(_norm(h.numpy()), _norm(jh), atol=H_TOL, rtol=0)
    np.testing.assert_allclose(pano.numpy(), np.asarray(jpano), atol=H_TOL, rtol=0)


@pytest.mark.parametrize("lag", [0, 3, -5])
def test_synchronize_sequences_lag_equals_jax(lag):
    emb = np.random.default_rng(21).normal(size=(40, 6)).astype(np.float32)
    a, b = emb[8:32], emb[8 + lag:32 + lag] + 0.01
    ours, scores = G.synchronize_sequences(_t(a), _t(b), max_lag=8)
    ref, rscores = JG.synchronize_sequences(jnp.asarray(a), jnp.asarray(b), max_lag=8)
    assert ours == ref == lag
    np.testing.assert_allclose(scores.numpy(), np.asarray(rscores), atol=TOL, rtol=0)


def test_audio_envelope_and_synchronize_audio_match_jax():
    rng = np.random.default_rng(22)
    sr, fps = 2000, 25
    wav = rng.normal(0, 0.05, sr * 2).astype(np.float32)
    for onset in (500, 1700, 2900):
        wav[onset:onset + 100] += np.sin(np.arange(100) * 0.3).astype(np.float32)
    shift = 3 * (sr // fps)
    a, b = wav[:sr * 3 // 2], wav[shift:shift + sr * 3 // 2]
    env = G.audio_onset_envelope(_t(a), sr, fps=fps)
    ref = JG.audio_onset_envelope(jnp.asarray(a), sr, fps=fps)
    np.testing.assert_allclose(env.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    stereo = G.audio_onset_envelope(_t(np.stack([a, a], -1)), sr, fps=fps)
    np.testing.assert_allclose(stereo.numpy(), env.numpy(), atol=1e-6, rtol=0)
    ours = G.synchronize_audio(_t(a), _t(b), sr, fps=fps, max_lag_s=0.4)
    jref = JG.synchronize_audio(jnp.asarray(a), jnp.asarray(b), sr, fps=fps, max_lag_s=0.4)
    assert ours[:2] == jref[:2] and ours[0] == 3          # b[t] ~ a[t + 3]


def test_remove_watermark_matches_jax():
    rng = np.random.default_rng(23)
    t, h, w = 24, 16, 16
    clip = rng.random((t, h, w, 3)).astype(np.float32)
    alpha = np.zeros((h, w), np.float32)
    alpha[4:10, 3:12] = 0.5
    mark = np.array([0.9, 0.2, 0.4], np.float32)
    frames = (1 - alpha[..., None]) * clip + alpha[..., None] * mark
    ours = G.remove_watermark(_t(frames))
    ref = JG.remove_watermark(jnp.asarray(frames))
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert float(ours[1][5, 5]) > 0.3 and float(ours[1][0, 0]) == 0.0
    with pytest.raises(ValueError, match="T>=2"):
        G.remove_watermark(torch.zeros(1, 4, 4, 3))


# --------------------------------------------------------------------------- #
# Y4M video I/O
# --------------------------------------------------------------------------- #

def _clip(seed=24, t=4, h=8, w=10):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


def test_ycbcr_conversions_equal_jaxs():
    x = _clip()
    np.testing.assert_array_equal(V.rgb_to_ycbcr(x), JV.rgb_to_ycbcr(x))
    np.testing.assert_array_equal(V.ycbcr_to_rgb(x), JV.ycbcr_to_rgb(x))


@pytest.mark.parametrize("chroma", ["420jpeg", "444"])
def test_y4m_files_are_byte_equal_and_read_both_ways(chroma, tmp_path):
    clip = _clip()
    mo = V.write_y4m(tmp_path / "port.y4m", clip, fps=(30000, 1001), chroma=chroma)
    mj = JV.write_y4m(tmp_path / "jax.y4m", iter(clip), fps=(30000, 1001), chroma=chroma)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()
    assert (mo.width, mo.height, mo.fps, mo.chroma) == (mj.width, mj.height, mj.fps, mj.chroma)
    for name in ("port.y4m", "jax.y4m"):
        ours, meta = V.read_y4m(tmp_path / name)
        ref, jmeta = JV.read_y4m(tmp_path / name)
        np.testing.assert_array_equal(ours, ref)
        assert meta.fps == jmeta.fps == (30000, 1001) and meta.chroma == jmeta.chroma
    np.testing.assert_array_equal(V.read_y4m(tmp_path / "port.y4m", limit=2)[0], ours[:2])
    mm = V.y4m_to_memmap(tmp_path / "port.y4m", tmp_path / "port.npy")
    np.testing.assert_array_equal(np.asarray(mm), ours)


@pytest.mark.parametrize("header,match", [
    (b"YUV4MPEG2 W8 H8 F25:1 It C420jpeg\n", "interlaced"),
    (b"YUV4MPEG2 W8 H8 C420p10\n", "unsupported Y4M chroma"),
    (b"YUV4MPEG2 H8 C444\n", "missing W/H"),
    (b"MPEG W8 H8\n", "not a YUV4MPEG2")])
def test_y4m_header_refusals_match_jax(header, match, tmp_path):
    (tmp_path / "bad.y4m").write_bytes(header)
    for mod in (V, JV):
        with pytest.raises(ValueError, match=match):
            mod.read_y4m(tmp_path / "bad.y4m")


def test_y4m_reads_the_other_420_sitings_and_comment_tags(tmp_path):
    V.write_y4m(tmp_path / "a.y4m", _clip(25, 2))
    data = (tmp_path / "a.y4m").read_bytes().replace(b"C420jpeg", b"C420mpeg2 XCOMMENT=1 I?")
    (tmp_path / "b.y4m").write_bytes(data)
    ours, meta = V.read_y4m(tmp_path / "b.y4m")
    ref, _ = JV.read_y4m(tmp_path / "b.y4m")
    np.testing.assert_array_equal(ours, ref)
    assert meta.chroma == "420mpeg2" and meta.interlace == "?"
    with pytest.raises(ValueError, match="even"):
        V.write_y4m(tmp_path / "c.y4m", _clip(26, 1, 7, 8))


@pytest.mark.parametrize("as_iterator", [False, True])
def test_process_video_pads_the_tail_and_matches_the_function(as_iterator):
    clip = _clip(27, t=11)
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x.float().mean((1, 2))

    frames = iter(clip) if as_iterator else clip
    out = V.process_video(frames, fn, batch_size=4, device="cpu",
                          preprocess=lambda b: b[..., ::-1])
    np.testing.assert_allclose(out, clip[..., ::-1].astype(np.float32).mean((1, 2)),
                               rtol=1e-6)
    assert calls == [(4, 8, 10, 3)] * 3
    with pytest.raises(NotImplementedError, match="mesh"):
        V.process_video(clip, fn, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no frames"):
        V.process_video(iter(()), fn, device="cpu")

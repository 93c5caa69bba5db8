"""The learned lossless codec of the port against the JAX package, on the
CPU: the range coder's streams (native, built from ``runtime/deepcv_rc.cpp``,
and the Python mirror) byte for byte, ``quantize_cdf``, the pyramid model
with carried parameters (phase logits, bits), five ``fit`` steps, lossless
coding with streams of JAX's length, progressive decoding, the video codec
and the ``.dvv`` container."""
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu import codec as jcodec
from deepcv_tpu.data import video_io as jvideo
from deepcv_tpu.runtime import range_coder as jrc
from deepcv_tpu_torch import codec as tcodec
from deepcv_tpu_torch.data import video_io as tvideo
from deepcv_tpu_torch.interop import load_jax_variables
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.runtime import range_coder as trc

#: phase logits and the model's bits with carried parameters
MODEL_TOL = 1e-5
#: the loss history of five fit steps
FIT_TOL = 1e-4
#: stream length, port against JAX, relative
LENGTH_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread here: the suite runs several workers at once,
    and a thread pool on these small tensors only contends with them (a
    SinGAN fit ran 150 times slower with the default pool under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_cdfs(rng, n, k, concentration=0.3):
    probs = rng.dirichlet(np.full(k, concentration), size=n)
    return probs, jcodec.quantize_cdf(probs)


def _smooth_images(n, size=16, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = (yy[None] * rng.integers(2, 8, (n, 1, 1)) + xx[None] * rng.integers(2, 8, (n, 1, 1)))
    img = base[..., None] % 64 + 96 + rng.normal(0, 3, (n, size, size, 3))
    return img.clip(0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# The range coder and the CDF tables
# --------------------------------------------------------------------------- #

def test_quantize_cdf_equals_jax():
    rng = np.random.default_rng(0)
    for k, conc in ((256, 0.3), (16, 5.0), (2, 0.1)):
        probs = rng.dirichlet(np.full(k, conc), size=200)
        probs[0] = 0.0
        probs[0, 3 % k] = 1.0                      # a one-hot row: zero mass elsewhere
        np.testing.assert_array_equal(tcodec.quantize_cdf(probs), jcodec.quantize_cdf(probs))
    cdf = tcodec.quantize_cdf(probs)
    assert cdf.dtype == np.uint32 and (cdf[:, -1] == trc.TOTAL).all()
    assert np.diff(cdf.astype(np.int64), axis=1).min() >= 1


@pytest.mark.parametrize("k", (2, 16, 256))
@pytest.mark.parametrize("coder", ("native", "python"))
def test_rc_encode_bytes_equal_jax(coder, k):
    rng = np.random.default_rng(k)
    n = 800
    probs, cdf = _random_cdfs(rng, n, k)
    syms = np.array([rng.choice(k, p=probs[i]) for i in range(n)], np.uint16)
    python = coder == "python"
    if not python:
        assert trc.rc_native_available()
    blob = trc.rc_encode(syms, cdf, force_python=python)
    assert blob == jrc.rc_encode(syms, cdf, force_python=python)
    assert blob == jrc.rc_encode(syms, cdf, force_python=not python)
    np.testing.assert_array_equal(trc.rc_decode(blob, n, cdf, force_python=python), syms)
    np.testing.assert_array_equal(trc.rc_decode(blob, n, cdf, force_python=not python), syms)


def test_the_range_coder_is_built_from_the_port_source():
    assert trc.rc_native_available()
    path = _build.host_library_path("deepcv_rc")
    assert path.is_file() and path.parent == _build.BUILD_DIR
    empty = tcodec.quantize_cdf(np.full((1, 4), 0.25))[:0]
    assert trc.rc_decode(trc.rc_encode(np.empty(0, np.uint16), empty), 0, empty).size == 0
    with pytest.raises(ValueError, match="cdf"):
        trc.rc_encode(np.zeros(3, np.uint16), np.zeros(3, np.uint32))


# --------------------------------------------------------------------------- #
# The pyramid model with carried parameters
# --------------------------------------------------------------------------- #

def _pair(hidden=8, coding_batch=4, seed=0, shape=(16, 16, 3)):
    jc = jcodec.LosslessCodec(shape, n_scales=2, hidden=hidden, seed=seed,
                              coding_batch=coding_batch)
    tc = tcodec.LosslessCodec(shape, n_scales=2, hidden=hidden, seed=seed,
                              coding_batch=coding_batch, device="cpu")
    load_jax_variables(tc.model, {"params": jax.tree.map(np.asarray, jc.params)})
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("phase", (0, 1, 2))
def test_phase_logits_with_carried_params(pair, phase):
    jc, tc = pair
    rng = np.random.default_rng(phase)
    known = [rng.integers(0, 256, (3, 4, 4, 3), dtype=np.uint8) for _ in range(phase + 1)]
    ref = np.asarray(jc.model.apply({"params": jc.params}, [jnp.asarray(k) for k in known],
                                    phase, method=jcodec._PyramidModel.phase_logits))
    with torch.no_grad():
        got = tc.model.phase_logits([torch.from_numpy(k) for k in known], phase).numpy()
    assert got.shape == ref.shape == (3, 4, 4, 3, 256)
    np.testing.assert_allclose(got, ref, rtol=MODEL_TOL, atol=MODEL_TOL)


def test_model_bits_with_carried_params(pair):
    jc, tc = pair
    imgs = _smooth_images(5, seed=1)
    assert tc.bits_per_dim(imgs) == pytest.approx(jc.bits_per_dim(imgs), rel=MODEL_TOL)
    with torch.no_grad():
        got = float(tc.model(torch.from_numpy(imgs)))
    assert got == pytest.approx(float(jc._jit_bits(jc.params, jnp.asarray(imgs))), rel=MODEL_TOL)


def test_five_fit_steps_follow_jax():
    jc, tc = _pair(hidden=8)
    train = _smooth_images(24, seed=2)
    ref = jc.fit(train, steps=5, batch_size=8, lr=3e-3, seed=1)
    got = tc.fit(train, steps=5, batch_size=8, lr=3e-3, seed=1)
    np.testing.assert_allclose(got, ref, rtol=FIT_TOL, atol=FIT_TOL)
    after = jax.tree.map(np.asarray, jc.params)
    sd = tc.model.state_dict()
    ref_k = after["phase1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)
    np.testing.assert_allclose(sd["phase1.Conv_0.weight"].numpy(), ref_k, atol=FIT_TOL)


@pytest.fixture(scope="module")
def fitted():
    jc, tc = _pair(hidden=8)
    train = _smooth_images(32, seed=3)
    jc.fit(train, steps=20, batch_size=16, seed=1)
    tc.fit(train, steps=20, batch_size=16, seed=1)
    return jc, tc, _smooth_images(5, seed=4)


def test_lossless_roundtrip_and_stream_length_of_jax(fitted):
    jc, tc, test = fitted
    ours, theirs = tc.encode_batch(test), jc.encode_batch(test)
    assert all(b[:10] == t[:10] for b, t in zip(ours, theirs))       # the header and magic
    for b, t in zip(ours, theirs):
        assert abs(len(b) - len(t)) <= LENGTH_TOL * len(t)
    np.testing.assert_array_equal(tc.decode_batch(ours), test)
    # batch-size invariant: each image alone gives its stream in the batch
    assert [tc.encode(img) for img in test[:2]] == ours[:2]
    np.testing.assert_array_equal(tc.decode(ours[3]), test[3])
    report = tc.evaluate(test, n_code=2)
    assert report["coded_bits_per_dim"] == pytest.approx(report["bits_per_dim"], abs=1.0)
    assert report["vs_png"] > 0 and tc.native_coder


def test_progressive_and_partial_decode(fitted):
    _, tc, test = fitted
    blob = tc.encode(test[0])
    outs = list(tc.decode_progressive(blob))
    assert [o["level"] for o in outs] == [2, 1, 0] and outs[-1]["final"]
    consumed = [o["bytes_consumed"] for o in outs]
    assert consumed == sorted(consumed) and consumed[-1] == len(blob)
    np.testing.assert_array_equal(outs[-1]["image"], test[0])
    np.testing.assert_array_equal(outs[0]["image"][::4, ::4], test[0][::4, ::4])
    preview, level = tc.decode_partial(blob[:consumed[1] + 3])
    assert level == 1 and preview.shape == test[0].shape
    np.testing.assert_array_equal(preview, outs[1]["image"])
    with pytest.raises(ValueError, match="truncated"):
        tc.decode_partial(blob[:20])


def test_codec_refuses_bad_inputs(fitted):
    _, tc, test = fitted
    with pytest.raises(ValueError, match="divisible"):
        tcodec.LosslessCodec((18, 16, 3), n_scales=2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tc.encode_batch(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="not a deepcv codec stream"):
        tc.decode(b"XXXX" + tc.encode(test[0])[4:])
    other = tcodec.LosslessCodec((32, 32, 3), n_scales=2, hidden=4, device="cpu")
    with pytest.raises(ValueError, match="codec is"):
        other.decode(tc.encode(test[0]))


def test_png_baseline_is_a_png_near_pils_size():
    from PIL import Image

    for img in list(_smooth_images(2, seed=5)) + [np.zeros((8, 8, 1), np.uint8)]:
        buf = io.BytesIO()
        mode_img = img if img.shape[-1] == 3 else img[..., 0]
        Image.fromarray(mode_img).save(buf, format="PNG", optimize=True)
        ours = tcodec.png_bytes(img)
        assert abs(ours - buf.getbuffer().nbytes) <= 0.1 * buf.getbuffer().nbytes + 8


def test_lossless_codec_is_exported_lazily():
    import deepcv_tpu_torch

    assert deepcv_tpu_torch.LosslessCodec is tcodec.LosslessCodec
    with pytest.raises(AttributeError):
        deepcv_tpu_torch.NoSuchThing  # noqa: B018


# --------------------------------------------------------------------------- #
# Video and the .dvv container
# --------------------------------------------------------------------------- #

def _toy_clips(n=3, t=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    clips = np.full((n, t, s, s, 3), 40, np.uint8)
    for i in range(n):
        y, x = rng.integers(0, s - 3, 2)
        for f in range(t):
            clips[i, f, (y + f) % (s - 3):(y + f) % (s - 3) + 3, x:x + 3] = 220
    return clips


@pytest.fixture(scope="module")
def video_pair():
    clips = _toy_clips()
    jv = jcodec.LosslessVideoCodec((16, 16, 3), n_scales=2, hidden=4, seed=0, coding_batch=4)
    tv = tcodec.LosslessVideoCodec((16, 16, 3), n_scales=2, hidden=4, seed=0, coding_batch=4,
                                   device="cpu")
    tv.fit(clips[:2], steps=6, batch_size=8, seed=0)
    return jv, tv, clips


def test_video_codec_roundtrip_and_modes(video_pair):
    _, tv, clips = video_pair
    blob = tv.encode_clip(clips[2])
    assert blob[:4] == b"DCVV" and struct.unpack_from("<BI", blob, 6)[0] == 0
    np.testing.assert_array_equal(tv.decode_clip(blob), clips[2])
    report = tv.evaluate(clips[2:], n_code=1)
    assert 0.0 <= report["inter_frame_share"] <= 1.0
    with pytest.raises(ValueError, match="clip"):
        tv.encode_clip(clips[0, 0])
    with pytest.raises(ValueError, match="video codec stream"):
        tv.decode_clip(b"XXXX" + blob[4:])


def test_dvv_header_equals_jax_and_the_container_roundtrips(video_pair, tmp_path):
    jv, tv, clips = video_pair
    assert tvideo.write_dvv(tmp_path / "a.dvv", clips[:2], tv) == 2
    assert jvideo.write_dvv(tmp_path / "b.dvv", clips[:1], jv) == 1
    ours, theirs = (tmp_path / "a.dvv").read_bytes(), (tmp_path / "b.dvv").read_bytes()
    assert ours[:10] == theirs[:10] == b"DCVF" + struct.pack("<BHHB", 2, 16, 16, 3)
    np.testing.assert_array_equal(tvideo.read_dvv(tmp_path / "a.dvv", tv), clips[:2])
    assert [c.shape for c in tvideo.iter_dvv(tmp_path / "a.dvv", tv)] == [clips[0].shape] * 2
    (tmp_path / "cut.dvv").write_bytes(ours[:-5])
    with pytest.raises(ValueError, match="truncated"):
        list(tvideo.iter_dvv(tmp_path / "cut.dvv", tv))
    other = tcodec.LosslessVideoCodec((8, 8, 3), n_scales=2, hidden=4, device="cpu")
    with pytest.raises(ValueError, match="container is"):
        list(tvideo.iter_dvv(tmp_path / "a.dvv", other))
    (tmp_path / "empty.dvv").write_bytes(ours[:10])
    with pytest.raises(ValueError, match="no clips"):
        tvideo.read_dvv(tmp_path / "empty.dvv", tv)

"""The port's data plane against the JAX package, on the CPU: the wire codec
(payloads byte for byte, decodes, the two pinned differences), the host
runtime built from ``runtime/deepcv_io.cpp`` (gathers, the ring-buffer
loader's batches over two epochs, a memmap passed without a copy), the
streaming epoch's choice of loader, and ``train()`` streaming through the C++
loader and through the wire codec."""
import copy

import jax
import numpy as np
import pytest
import torch

from deepcv_tpu.data import datasets as jds
from deepcv_tpu.data import pipeline as jpipeline
from deepcv_tpu.data import wirecodec as jwire
from deepcv_tpu.data.preprocess import preprocess as jax_preprocess
from deepcv_tpu.runtime import native as jnative
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.train.backend import BackendConfig as JaxBackendConfig
from deepcv_tpu.train.losses import cross_entropy_loss as jax_ce
from deepcv_tpu.train.training import train as jax_train
from deepcv_tpu_torch.data import datasets as tds
from deepcv_tpu_torch.data import pipeline as tpipeline
from deepcv_tpu_torch.data import wirecodec as twire
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import load_jax_variables
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.runtime import native as tnative
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train import training
from deepcv_tpu_torch.train.losses import cross_entropy_loss
from deepcv_tpu_torch.train.training import train

#: first streamed losses, port against JAX, from the same weights
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread here: the suite runs several workers at once,
    and a thread pool on these small tensors only contends with them (a
    SinGAN fit ran 150 times slower with the default pool under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(shape, seed=0, step=3):
    """Smooth random walks along W, steps U[-step, step] (config 7's kind of
    image at step 3)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-step, step + 1, shape).astype(np.int16)
    walk = np.cumsum(steps, axis=-2) + rng.integers(0, 256, shape[:-2] + (1, shape[-1]))
    return np.abs(walk % 510 - 255).astype(np.uint8)


def _escapes(shape, seed=0):
    """A smooth batch with a spike on one pixel in 40: many escapes, still
    smaller coded than raw."""
    x = _walk(shape, seed, step=1)
    rng = np.random.default_rng(seed + 1)
    spikes = rng.random(shape) < 0.025
    x[spikes] = rng.integers(0, 256, int(spikes.sum()), dtype=np.uint8)
    return x


INPUTS = {"smooth": lambda shape: _walk(shape, step=1), "escapes": _escapes}


# --------------------------------------------------------------------------- #
# The wire codec
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("bits", (2, 3, 4))
def test_encode_payload_is_byte_equal_to_jax(bits, kind):
    x = INPUTS[kind]((6, 16, 16, 3))
    got, ref = twire.encode_u8(x, bits=bits), jwire.encode_u8(x, bits=bits)
    assert ref is not None and got is not None
    assert got["packed"].tobytes() == ref["packed"].tobytes()
    assert got["overflow"].tobytes() == ref["overflow"].tobytes()
    assert (got["shape"], got["bits"], got["axis"]) == (ref["shape"], ref["bits"], ref["axis"])
    assert twire.wire_bytes(got) == jwire.wire_bytes(ref) < x.nbytes
    if kind == "escapes":
        assert np.count_nonzero(got["overflow"]) > 0


@pytest.mark.parametrize("axis", (-2, 1, 0))
@pytest.mark.parametrize("bits", (2, 3, 4))
def test_decode_equals_jax_and_the_input(bits, axis):
    x = np.ascontiguousarray(np.moveaxis(_escapes((3, 8, 24, 3), seed=bits), -2, axis))
    payload = twire.encode_u8(x, bits=bits, axis=axis)
    assert payload is not None
    got = twire.decode_u8(torch.from_numpy(payload["packed"]),
                          torch.from_numpy(payload["overflow"]), payload["shape"], bits,
                          payload["axis"])
    ref = np.asarray(jwire.decode_u8(payload["packed"], payload["overflow"], payload["shape"],
                                     bits, payload["axis"]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(twire.device_decode(payload, "cpu").numpy(), x)


@pytest.mark.parametrize("case", ["zeros", "ramp", "wrap", "one_row", "odd_length"])
def test_roundtrip_edge_patterns(case):
    x = {"zeros": np.zeros((2, 8, 8, 3), np.uint8),
         "ramp": np.tile(np.arange(256, dtype=np.uint8), (4, 1)),
         "wrap": np.tile(np.array([0, 255], np.uint8), (3, 64)),
         "one_row": np.full((1, 200), 7, np.uint8),
         "odd_length": np.zeros((1, 203), np.uint8)}[case]
    for bits in (2, 3, 4):
        payload = twire.encode_u8(x, bits=bits)
        ref = jwire.encode_u8(x, bits=bits)
        if payload is None:
            continue
        assert ref is not None and payload["packed"].tobytes() == ref["packed"].tobytes()
        np.testing.assert_array_equal(twire.device_decode(payload, "cpu").numpy(), x)


def test_incompressible_batch_ships_raw():
    x = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    assert twire.encode_u8(x, bits=3) is None and jwire.encode_u8(x, bits=3) is None
    assert twire.wire_bytes(None) == 0
    with pytest.raises(ValueError, match="bits"):
        twire.encode_u8(x, bits=5)
    with pytest.raises(ValueError, match="uint8"):
        twire.encode_u8(x.astype(np.int16))


def test_packed_size_decides_raw_or_coded_unlike_jax():
    """105 bytes, 2 escapes, bits 3: the JAX package estimates 40 + 64 bytes
    from the unpadded size and ships 42 + 64 = 106 coded; the port counts
    the packed 42 and ships the 105 raw."""
    x = np.zeros(105, np.uint8)
    x[50] = 200
    ref = jwire.encode_u8(x, bits=3)
    assert ref is not None and jwire.wire_bytes(ref) == 106 > x.nbytes
    assert twire.encode_u8(x, bits=3) is None
    assert twire.packed_bytes(105, 3) == 42 and twire.packed_bytes(105, 2) == 27
    # where the padding does not cross the line, both code it alike
    y = np.zeros(400, np.uint8)
    assert twire.encode_u8(y, bits=3)["packed"].tobytes() == \
        jwire.encode_u8(y, bits=3)["packed"].tobytes()


def test_only_the_image_leaf_is_coded_unlike_jax(monkeypatch):
    """A batch of (uint8 images, uint8 masks, labels): the JAX package tries
    the codec on both uint8 leaves; the port on the NHWC image leaf only."""
    images = _walk((4, 8, 8, 3))
    masks = np.zeros((4, 8, 8), np.uint8)
    labels = np.arange(4)
    tried = []
    real = jwire.encode_u8
    monkeypatch.setattr(jwire, "encode_u8", lambda a, **kw: tried.append(a.shape) or real(a, **kw))
    jax_out = list(jpipeline.prefetch_to_device(iter([(images, masks, labels)]),
                                                wire_codec={"bits": 3, "axis": -2}))
    assert sorted(tried) == [(4, 8, 8), (4, 8, 8, 3)]
    tpipeline.wire_stats.clear()
    got = list(tpipeline.prefetch_to_device(iter([(images, masks, labels)]), device="cpu",
                                            wire_codec={"bits": 3, "axis": -2}))
    assert tpipeline.wire_stats["coded"] == 1 and tpipeline.wire_stats["raw"] == 0
    assert tpipeline.wire_stats["image_bytes"] == images.nbytes
    assert tpipeline.wire_stats["wire_bytes"] < images.nbytes
    for g, j in zip(got[0], jax_out[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


# --------------------------------------------------------------------------- #
# The host runtime
# --------------------------------------------------------------------------- #

def test_the_runtime_is_built_from_the_port_sources_with_cxx():
    assert tnative.native_available()
    path = _build.host_library_path("deepcv_io")
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libdeepcv_io-")
    assert set(_build.CXX_FLAGS) >= {"-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"}
    src = (_build.RUNTIME_DIR / "deepcv_io.cpp").read_text()
    ref = (_build.RUNTIME_DIR.parents[1] / "deepcv_tpu" / "runtime" / "deepcv_io.cpp").read_text()
    assert src[src.index("#include <atomic>"):] == ref[ref.index("#include <atomic>"):]


@pytest.mark.parametrize("threads", (0, 1, 3))
def test_gather_equals_jax_and_numpy(threads):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (50, 4, 4, 3), dtype=np.uint8)
    idx = rng.integers(0, 50, 17)
    got = tnative.gather_batch(data, idx, n_threads=threads)
    np.testing.assert_array_equal(got, data[idx])
    np.testing.assert_array_equal(got, jnative.gather_batch(data, idx, n_threads=threads))
    out = np.empty_like(got)
    assert tnative.gather_batch(data, idx, out=out) is out


@pytest.mark.parametrize("seed", (0, 7))
def test_loader_batches_equal_jax_over_two_epochs(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (37, 4, 4, 3), dtype=np.uint8)
    targets = rng.integers(0, 10, 37).astype(np.int32)
    ours = tnative.NativeBatchLoader(images, targets, 8, depth=3, seed=seed)
    theirs = jnative.NativeBatchLoader(images, targets, 8, depth=3, seed=seed)
    try:
        assert ours.steps_per_epoch == theirs.steps_per_epoch == 4
        seen = []
        for _ in range(2 * ours.steps_per_epoch):
            (a, b), (c, d) = next(ours), next(theirs)
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
            seen.append(b)
        # each epoch draws 32 distinct samples of the 37
        assert len(set(np.concatenate(seen[:4]).tolist())) <= 32
    finally:
        ours.close()
        theirs.close()
    with pytest.raises(StopIteration):
        next(ours)


def test_loader_takes_a_memmap_without_a_copy(tmp_path):
    images = np.lib.format.open_memmap(tmp_path / "x.npy", mode="w+", dtype=np.uint8,
                                       shape=(64, 4, 4, 3))
    images[:] = np.arange(64, dtype=np.uint8)[:, None, None, None]
    images.flush()
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    view = mm[8:56]                      # a split: a contiguous slice of the file
    loader = tnative.NativeBatchLoader(view, np.arange(48, dtype=np.int64), 16, seed=3)
    try:
        assert np.shares_memory(loader.images, mm) and np.shares_memory(loader.images, view)
        imgs, tgts = next(loader)
        np.testing.assert_array_equal(imgs[:, 0, 0, 0], tgts + 8)
    finally:
        loader.close()
    with pytest.raises(RuntimeError, match="deepcv_loader_create"):
        tnative.NativeBatchLoader(view[:4], np.arange(4), 16)


def _splits(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = _walk((n, 8, 8, 3), seed)
    y = rng.integers(0, 3, n).astype(np.int64)
    pp = {"seed": 0, "split_dataset": {"validset_ratio": 0.2}, "transforms": ["to_tensor"]}
    return (jax_preprocess({"trainset": jds.ArrayDataset(x, y, classes=list("abc"))}, pp),
            preprocess({"trainset": tds.ArrayDataset(x, y, classes=list("abc"))}, pp))


def test_host_batches_choose_the_loader_and_skip(monkeypatch):
    _, td = _splits()
    it = tpipeline.BatchIterator(td["trainset"], 8, shuffle=True, seed=2)
    kind, native = training.host_batches(it, td["trainset"], 1, 0, {}, 2)
    native = list(native)
    assert kind == "native" and len(native) == it.num_batches == 4
    data = tpipeline.unwrap_dataset(td["trainset"])
    ref = tnative.NativeBatchLoader(data.images, data.targets, 8, seed=3)
    try:
        for got in native:
            np.testing.assert_array_equal(got[0], next(ref)[0])
    finally:
        ref.close()
    kind, skipped = training.host_batches(it, td["trainset"], 1, 3, {"native_loader": True}, 2)
    assert kind == "native"
    np.testing.assert_array_equal(list(skipped)[0][0], native[3][0])
    kind, numpy_batches = training.host_batches(it, td["trainset"], 1, 1,
                                                {"native_loader": False}, 2)
    assert kind == "numpy"
    np.testing.assert_array_equal(list(numpy_batches)[0][0], list(it.epoch(1))[1][0])
    with pytest.raises(ValueError, match="native_loader"):
        training.host_batches(it, td["trainset"], 0, 0, {"native_loader": "yes"}, 2)
    monkeypatch.setattr(tnative, "_state", {"lib": None, "tried": True})
    assert training.host_batches(it, td["trainset"], 0, 0, {}, 2)[0] == "numpy"
    with pytest.raises(RuntimeError, match="native_loader"):
        training.host_batches(it, td["trainset"], 0, 0, {"native_loader": True}, 2)


TINY_HP = {"act_fn": "leaky_relu", "dropout_prob": 0.0,
           "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
           "architecture": [{"conv2d": {"kernel_size": [3, 3], "out_channels": 4, "padding": 1}},
                            {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
                            {"flatten": {}},
                            {"fully_connected": {"out_features": 3, "act_fn": None,
                                                 "batch_norm": None}}]}


@pytest.fixture(scope="module")
def streamed_pair(tmp_path_factory):
    """The JAX package's streaming train() under the default native_loader
    (its C++ loader), 2 epochs of 4 batches of 8, and the weights it
    started from."""
    jd, td = _splits()
    jm = JaxModule((8, 8, 3), copy.deepcopy(TINY_HP))
    v = jm.init(jax.random.PRNGKey(0))
    hp = {"epochs": 2, "batch_size": 8, "optimizer": "sgd",
          "optimizer_opts": {"lr": 0.05, "momentum": 0.9}, "save_every_iters": 0,
          "log_progress_every_iters": 1, "seed": 1, "handle_preemption": False,
          "device_resident_dataset": False,
          "output_path": str(tmp_path_factory.mktemp("jax_stream"))}
    assert jnative.native_available()
    _, jh = jax_train(hp, jm, jax_ce, jd, init_variables=v,
                      backend_conf=JaxBackendConfig(n_devices=1))
    return hp, v, td, [e["main_loss"] for e in jh["train"]]


def _port_model(v):
    tm = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
    return load_jax_variables(tm, jax.tree.map(np.asarray, v))


@pytest.mark.parametrize("native_loader", ["auto", True])
def test_streaming_train_through_the_cxx_loader_matches_jax(streamed_pair, tmp_path,
                                                            native_loader):
    hp, v, td, jax_losses = streamed_pair
    hp = dict(hp, output_path=str(tmp_path), native_loader=native_loader)
    _, h = train(hp, _port_model(v), cross_entropy_loss, td)
    assert h["input_path"] == "streaming" and h["host_loader"] == "native"
    assert h["steps"] == len(jax_losses) == 8
    np.testing.assert_allclose([e["main_loss"] for e in h["train"]], jax_losses,
                               rtol=LOSS_TOL, atol=LOSS_TOL)


def test_streaming_train_with_wire_compression_equals_the_raw_run(streamed_pair, tmp_path):
    """The codec is lossless: the same losses bit for bit, every batch coded
    (the splits are smooth walks)."""
    hp, v, td, _ = streamed_pair
    _, raw = train(dict(hp, output_path=str(tmp_path / "raw")), _port_model(v),
                   cross_entropy_loss, td)
    tpipeline.wire_stats.clear()
    _, coded = train(dict(hp, output_path=str(tmp_path / "coded"), wire_compression=True),
                     _port_model(v), cross_entropy_loss, td)
    assert [e["main_loss"] for e in coded["train"]] == [e["main_loss"] for e in raw["train"]]
    assert tpipeline.wire_stats["coded"] == 8 and tpipeline.wire_stats["raw"] == 0
    assert tpipeline.wire_stats["wire_bytes"] < tpipeline.wire_stats["image_bytes"]
    assert training._wire_codec({"wire_compression": True}) == {"bits": 3, "axis": -2}
    assert training._wire_codec({"wire_compression": {"bits": 4}}) == {"bits": 4}
    assert training._wire_codec({}) is None
    assert "wire_compression" not in training.UNPORTED_HP

"""The port's serving path on the CPU: bundles, ``Predictor``,
``MicroBatcher``/``InferenceServer`` and the ``serve`` CLI."""
import http.client
import io
import json

import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu_torch.cli import main as cli_main
from deepcv_tpu_torch.data.transforms import normalize, to_tensor
from deepcv_tpu_torch.serve import Predictor, load_model_bundle, save_model_bundle
from deepcv_tpu_torch.server import InferenceServer, MicroBatcher
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import resnet_spec

SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def model():
    hp = resnet_spec(50, width=8, num_classes=10, pool_kernel=1)
    return DeepcvModule(SHAPE, hp, device="cpu",
                        generator=torch.Generator().manual_seed(5)).eval()


def _pre(x):
    return normalize(to_tensor(x), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *SHAPE), dtype=np.uint8)


def test_transforms_match_the_reference_formulas():
    x = _images(2)
    ref = (x.astype(np.float32) / 255.0 - np.float32([0.485, 0.456, 0.406])) \
        / np.float32([0.229, 0.224, 0.225])
    np.testing.assert_allclose(_pre(torch.from_numpy(x)).numpy(), ref, atol=1e-6)
    assert to_tensor(torch.ones(2, dtype=torch.float64)).dtype == torch.float32


def test_predictor_pads_the_ragged_tail_and_returns_n_rows(model):
    pred = Predictor(model, batch_size=4, preprocess=_pre, device="cpu")
    x = _images(7)
    y = pred(x)
    assert y.shape == (7, 10) and y.dtype == np.float32 and pred.forwards == 2
    with torch.no_grad():
        ref = model(_pre(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(y, ref, atol=1e-5, rtol=0)   # eval BN: rows independent
    assert pred(x[:0]).shape == (0, 10)


def test_predictor_flip_tta_averages_the_mirrored_batch(model):
    x = _images(3, seed=1)
    plain = Predictor(model, batch_size=4, preprocess=_pre, device="cpu")
    tta = Predictor(model, batch_size=4, preprocess=_pre, device="cpu", tta="flip")
    np.testing.assert_allclose(tta(x), 0.5 * (plain(x) + plain(x[:, :, ::-1])),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="tta"):
        Predictor(model, tta="rot90", device="cpu")


def test_bundle_round_trip_is_bit_exact_and_readable_by_the_jax_package(model, tmp_path):
    save_model_bundle(tmp_path, model)
    back = load_model_bundle(tmp_path, device="cpu")
    sd, sd2 = model.state_dict(), back.state_dict()
    assert list(sd) == list(sd2)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert not back.training
    x = torch.from_numpy(_images(2)).float()
    with torch.no_grad():
        assert torch.equal(model(x), back(x))
    meta = yaml.safe_load((tmp_path / "model.yaml").read_text())
    assert meta["input_shape"] == list(SHAPE) and meta["nas_mode"] == "fixed"
    JaxModule(tuple(meta["input_shape"]), meta["hp"])   # the same spec builds there


def test_microbatcher_coalesces_queued_requests(model):
    calls = []

    def fn(x):
        calls.append(len(x))
        return x.reshape(len(x), -1).sum(1)

    mb = MicroBatcher(fn, max_batch=16, max_wait_ms=50, start=False)
    futs = [mb.submit(np.full((n, 2), i, np.float32)) for i, n in enumerate((1, 3, 2))]
    mb.start()
    try:
        outs = [f.result(timeout=30) for f in futs]
    finally:
        mb.close()
    assert calls == [6] and mb.stats["batches"] == 1
    assert [o.tolist() for o in outs] == [[0.0], [2.0] * 3, [4.0] * 2]
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros((1, 2)))


def _request(server, method, path, body=None, ctype=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_inference_server_answers_npy_json_health_and_stats(model):
    pred = Predictor(model, batch_size=4, preprocess=_pre, device="cpu")
    x = _images(5, seed=2)
    ref = pred(x)
    server = InferenceServer(pred, port=0, max_batch=4, input_shape=SHAPE)
    with server:
        status, body = _request(server, "GET", "/healthz")
        assert status == 200 and json.loads(body) == {"ok": True, "ready": False}
        server.warmup()
        assert json.loads(_request(server, "GET", "/healthz")[1])["ready"] is True
        buf = io.BytesIO()
        np.save(buf, x, allow_pickle=False)
        status, body = _request(server, "POST", "/predict", buf.getvalue(),
                                "application/x-npy")
        assert status == 200
        np.testing.assert_allclose(np.load(io.BytesIO(body)), ref, atol=1e-5, rtol=0)
        status, body = _request(server, "POST", "/predict",
                                json.dumps({"images": x[1].tolist()}).encode(),
                                "application/json")
        assert status == 200
        np.testing.assert_allclose(json.loads(body)["outputs"], ref[1], atol=1e-5)
        assert _request(server, "POST", "/predict", b"not json")[0] == 400
        bad = io.BytesIO()
        np.save(bad, np.zeros((1, 8, 8, 3), np.uint8))
        assert _request(server, "POST", "/predict", bad.getvalue())[0] == 400
        assert _request(server, "GET", "/nope")[0] == 404
        stats = json.loads(_request(server, "GET", "/stats")[1])
        assert stats["requests"] == 3 and stats["items"] == 1 + 5 + 1
        assert "latency_p50_ms" in stats


def test_cli_serve_refuses_quantize_and_non_bundles(model, tmp_path, capsys):
    """``--quantize int8`` serves (tests/test_torch_port_serving.py); any
    other mode is refused, as are directories that are not bundles."""
    save_model_bundle(tmp_path, model)
    with pytest.raises(SystemExit) as e:
        cli_main(["serve", "--bundle", str(tmp_path), "--quantize", "int4",
                  "--device", "cpu"])
    assert e.value.code == 2 and "invalid choice: 'int4'" in capsys.readouterr().err
    assert cli_main(["serve", "--bundle", str(tmp_path / "nope"), "--device", "cpu"]) == 2
    assert cli_main(["serve", "--bundle", str(tmp_path), "--normalize", "1,2",
                     "--device", "cpu"]) == 2

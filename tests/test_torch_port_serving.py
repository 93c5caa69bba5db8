"""The rest of the port's serving path against the JAX package, on the CPU:
``load_model_bundle(quantize=...)``, ``Predictor.from_checkpoint``
(best-k), MC-dropout, ``EnsemblePredictor``, ``StackedEnsemble``,
distillation targets and loss, the ``predict`` command (float,
``--quantize int8 --calibrate``, ``--decode segmentation`` and
``--decode detection:...``) held against JAX's ``_cmd_predict`` on the same
weights, ``serve --quantize int8``, and ``DeepcvClassifier``."""
import argparse
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu import cli as jcli
from deepcv_tpu import compression as jc
from deepcv_tpu import serve as jserve
from deepcv_tpu.sklearn_api import DeepcvClassifier as JaxClassifier
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.train import losses as jlosses
from deepcv_tpu_torch import cli as tcli
from deepcv_tpu_torch import serve as tserve
from deepcv_tpu_torch.data.datasets import ArrayDataset
from deepcv_tpu_torch.interop import load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.sklearn_api import DEFAULT_CNN_HP, DeepcvClassifier
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train import losses as tlosses
from deepcv_tpu_torch.train.checkpoint import CheckpointManager

FWD_TOL = 1e-4        # float forwards, rel L2 (tests/test_torch_parity.py)
INT8_TOL = 1e-4       # int8 forwards on carried weights, rel L2
ENS_TOL = 1e-6        # ensembles on the same member outputs
STACK_TOL = 1e-4      # stacker weights after 300 full-batch Adam steps
LOSS_TOL = 1e-6       # distillation loss and accuracy
TIE_TOL = 2e-2        # int8 outputs where an activation code sat on a rounding tie


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _conv_hp(out=6, dropout=0.0, bn=True, head="fully_connected"):
    """A small conv net: a classifier head or a fully convolutional map of
    ``out`` channels (segmentation, a single-grid detector)."""
    arch = [{"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
            {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1,
                        "dropout_prob": dropout}}]
    if head == "fully_connected":
        arch += [{"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
                 {"flatten": {}},
                 {"fully_connected": {"out_features": out, "act_fn": None,
                                      "batch_norm": None, "dropout_prob": dropout}}]
    else:
        arch += [{"conv2d": {"kernel_size": [1, 1], "out_channels": out, "act_fn": None,
                             "batch_norm": None}}]
    hp = {"act_fn": "silu", "architecture": arch}
    if bn:
        hp["batch_norm"] = {"affine": True, "eps": 1e-5, "momentum": 0.1}
    return hp


def _zero_padded_stem_rows(jv, hp):
    """Zero the JAX stem's kernel rows for the 5 channels padded onto the
    3-channel input: inert in float, but they enter JAX's int8 weight scale
    and the port has no such rows. Only the stem, the spec's first layer:
    later convs take 8 real channels."""
    (creator, args), = hp["architecture"][0].items()
    name = args[0] if isinstance(args, list) else f"_submodule_0_{creator}"
    k = jv["params"][f"node_impls_{name}"]["op"]["kernel"]
    assert k.shape[2] == 8, k.shape
    k[:, :, 3:, :] = 0.0
    return jv


def _pair(hp, shape=(8, 8, 3), seed=0):
    jm = JaxModule(shape, copy.deepcopy(hp))
    jv = _zero_padded_stem_rows(_numpy(jm.init(jax.random.PRNGKey(seed))), hp)
    tm = DeepcvModule(shape, copy.deepcopy(hp), device="cpu").eval()
    load_jax_variables(tm, jv)
    return jm, jv, tm


def _images(n, shape=(8, 8, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


def _to_tensor(x):
    return x.float() / 255.0


# --------------------------------------------------------------------------- #
# bundles, checkpoints, MC-dropout
# --------------------------------------------------------------------------- #

def test_int8_bundle_equals_a_direct_int8_build(tmp_path):
    _, _, tm = _pair(_conv_hp())
    tserve.save_model_bundle(tmp_path, tm)
    x = torch.from_numpy(_images(5, seed=1)).float() / 255.0
    direct = tm.with_options(quantize="int8")
    scales = {"_submodule_0_conv2d": 0.01}
    for kw, ref_model in (({"quantize": "int8"}, direct),
                          ({"quantize": "int8", "quantize_scales": scales},
                           tm.with_options(quantize="int8", quantize_scales=scales))):
        loaded = tserve.load_model_bundle(tmp_path, device="cpu", **kw)
        assert loaded.quantize == "int8" and not loaded.training
        assert loaded.module.nodes["_submodule_0_conv2d"].op.quant.act_scale == \
            kw.get("quantize_scales", {}).get("_submodule_0_conv2d")
        with torch.no_grad():
            np.testing.assert_array_equal(loaded(x).numpy(), ref_model(x).numpy())
    bf16 = tserve.load_model_bundle(tmp_path, device="cpu", dtype="bfloat16")
    assert bf16.dtype == torch.bfloat16


def test_from_checkpoint_restores_the_best_k_step(tmp_path):
    _, _, tm = _pair(_conv_hp())
    mgr = CheckpointManager(tmp_path, best_k=2)
    states = {}
    for step, metric in ((10, 0.3), (20, 0.9), (30, 0.5)):
        m = DeepcvModule((8, 8, 3), _conv_hp(), device="cpu",
                         generator=torch.Generator().manual_seed(step))
        states[step] = {"step": step, "model": m.state_dict()}
        mgr.save(step, states[step])
        mgr.update_best(step, metric, states[step])
    assert mgr.best_checkpoints() == {"20": 0.9, "30": 0.5}
    x = _images(3)
    for best, step in ((True, 20), (False, 30)):
        pred = tserve.Predictor.from_checkpoint(tm, tmp_path, best=best, batch_size=4,
                                                preprocess=_to_tensor, device="cpu")
        ref = DeepcvModule((8, 8, 3), _conv_hp(), device="cpu")
        ref.load_state_dict(states[step]["model"])
        with torch.no_grad():
            np.testing.assert_array_equal(pred(x), ref.eval()(_to_tensor(
                torch.from_numpy(x))).numpy())
    assert CheckpointManager(tmp_path, mode="min").restore_best()["step"] == 30


def test_mc_dropout_spread_and_untouched_running_statistics():
    x = _images(6, seed=2)
    _, _, plain = _pair(_conv_hp(bn=False))
    pred = tserve.Predictor(plain, batch_size=4, preprocess=_to_tensor, device="cpu")
    mean, std = pred.predict_with_uncertainty(x, n_samples=3)
    assert mean.shape == std.shape == (6, 6) and std.max() <= 1e-6   # float noise only
    np.testing.assert_allclose(mean, pred(x), rtol=1e-6, atol=1e-6)
    _, _, tm = _pair(_conv_hp(dropout=0.3))
    for m in tm.modules():
        if isinstance(m, dnn.BatchNorm):
            m.running_mean.uniform_(-0.1, 0.1)
    before = {k: v.clone() for k, v in tm.named_buffers()}
    pred = tserve.Predictor(tm, batch_size=4, preprocess=_to_tensor, device="cpu", tta="flip")
    mean, std = pred.predict_with_uncertainty(x, n_samples=4, seed=3)
    assert (std > 0).mean() > 0.9 and np.isfinite(mean).all()
    again = pred.predict_with_uncertainty(x, n_samples=4, seed=3)
    np.testing.assert_array_equal(again[0], mean)          # seeded
    for k, v in tm.named_buffers():
        assert torch.equal(v, before[k]), k
    assert not tm.training and all(m.generator is None for m in tm.modules()
                                   if isinstance(m, dnn.Dropout))
    with pytest.raises(ValueError, match="inference-only"):
        tserve.Predictor(tm.with_options(quantize="int8"), device="cpu") \
            .predict_with_uncertainty(x)


# --------------------------------------------------------------------------- #
# ensembles, stacking, distillation
# --------------------------------------------------------------------------- #

def _fixed_outputs(m=3, n=12, c=4, seed=4):
    return np.random.default_rng(seed).normal(size=(m, n, c)).astype(np.float32) * 2


@pytest.mark.parametrize("mode", ["prob", "mean"])
def test_ensemble_matches_jax_on_the_same_member_outputs(mode):
    outs = _fixed_outputs()
    w = [1.0, 2.0, 0.5]
    _, jv, tm = _pair(_conv_hp(out=4))
    jm = JaxModule((8, 8, 3), _conv_hp(out=4))
    jens = jserve.EnsemblePredictor([(jm, jv)] * 3, mode=mode, weights=w)
    tens = tserve.EnsemblePredictor([tm] * 3, mode=mode, weights=w, device="cpu")
    jens.member_outputs = tens.member_outputs = lambda images: outs
    np.testing.assert_allclose(tens(None), jens(None), rtol=0, atol=ENS_TOL)
    # and through the members themselves, on carried weights
    x = _images(5, seed=6).astype(np.float32) / 255.0
    jens2 = jserve.EnsemblePredictor([(jm, jv)], mode=mode, batch_size=8)
    tens2 = tserve.EnsemblePredictor([tm], mode=mode, batch_size=8, device="cpu")
    assert _rel(tens2(x), jens2(x)) <= FWD_TOL
    with pytest.raises(ValueError, match="one per member"):
        tserve.EnsemblePredictor([tm], weights=[1, 2], device="cpu")


def test_stacked_ensemble_fit_matches_jax():
    outs = _fixed_outputs()
    labels = np.random.default_rng(5).integers(0, 4, size=12)
    jm = JaxModule((8, 8, 3), _conv_hp(out=4))
    _, jv, tm = _pair(_conv_hp(out=4))
    jst = jserve.StackedEnsemble([(jm, jv)] * 3)
    tst = tserve.StackedEnsemble([tm] * 3, device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        tst(None)
    jst.member_outputs = tst.member_outputs = lambda images: outs
    jloss = jst.fit(None, labels)
    tloss = tst.fit(None, labels)
    assert abs(tloss - jloss) <= STACK_TOL * abs(jloss)
    for k in ("w", "b"):
        np.testing.assert_allclose(tst._stack_params[k].numpy(),
                                   np.asarray(jst._stack_params[k]), rtol=0, atol=STACK_TOL)
    np.testing.assert_allclose(tst(None), np.asarray(jst(None)), rtol=0, atol=STACK_TOL)
    with pytest.raises(ValueError, match="labels"):
        tst.fit(None, labels[:5])


def test_distillation_targets_loss_and_accuracy_match_jax():
    from deepcv_tpu.data.datasets import ArrayDataset as JaxArrayDataset

    x = _images(6, seed=7)
    labels = np.arange(6) % 4
    jm, jv, tm = _pair(_conv_hp(out=4))
    jds = jserve.distill_targets(jm, jv, JaxArrayDataset(x, labels), batch_size=4,
                                 preprocess=lambda b: b.astype(jnp.float32) / 255.0)
    tds = tserve.distill_targets(tm, ArrayDataset(x, labels), batch_size=4,
                                 preprocess=_to_tensor, device="cpu")
    assert tds.targets.shape == (6, 5) and tds.classes == [f"class_{i}" for i in range(4)]
    np.testing.assert_array_equal(tds.targets[:, 0], labels)
    np.testing.assert_allclose(tds.targets, jds.targets, rtol=0, atol=1e-5)
    ens = tserve.ensemble_distill_targets([tm, tm], ArrayDataset(x, labels), batch_size=4,
                                          preprocess=_to_tensor, device="cpu")
    np.testing.assert_allclose(np.exp(ens.targets[:, 1:]).sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="integer class targets"):
        tserve.distill_targets(tm, ArrayDataset(x, np.zeros((6, 2))), device="cpu")
    rng = np.random.default_rng(8)
    student = rng.normal(size=(6, 4)).astype(np.float32)
    targets = jds.targets.astype(np.float32)
    for t, alpha in ((4.0, 0.5), (2.0, 0.1), (1.0, 1.0)):
        ref = float(jlosses.distillation_loss(jnp.asarray(student), jnp.asarray(targets),
                                              temperature=t, alpha=alpha))
        got = float(tlosses.distillation_loss(torch.from_numpy(student),
                                              torch.from_numpy(targets), t, alpha))
        assert abs(got - ref) <= LOSS_TOL * max(1.0, abs(ref))
    hard = float(tlosses.cross_entropy_loss(torch.from_numpy(student),
                                            torch.from_numpy(labels)))
    assert abs(float(tlosses.distillation_loss(torch.from_numpy(student),
                                               torch.from_numpy(targets), alpha=1.0))
               - hard) <= LOSS_TOL
    same = np.concatenate([labels[:, None], student], axis=1).astype(np.float32)
    assert abs(float(tlosses.distillation_loss(torch.from_numpy(student),
                                               torch.from_numpy(same), alpha=0.0))) <= LOSS_TOL
    assert float(tlosses.distill_accuracy(torch.from_numpy(student), torch.from_numpy(targets))) \
        == float(jlosses.distill_accuracy(jnp.asarray(student), jnp.asarray(targets)))
    assert tlosses.LOSS_FNS["distillation"] is tlosses.distillation_loss


# --------------------------------------------------------------------------- #
# the predict and serve commands
# --------------------------------------------------------------------------- #

def _pyramid_hp():
    """Three levels (8x8, 4x4, 2x2 on 8x8 images) under a shared head of
    7 = 5 + 2 classes: the flat (N, 84, 7) detection layout."""
    return {"act_fn": "relu", "architecture": [
        {"conv2d": ["c3", {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}]},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"conv2d": ["c4", {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}]},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"conv2d": ["c5", {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}]},
        {"_new_branch_from_tensor": {"_from": ["c3", "c4", "c5"]}},
        {"feature_pyramid": {"channels": 8, "head_outputs": 7}}]}


def _bundles(tmp_path, hp, name):
    """The same JAX weights as a JAX bundle and as a port bundle."""
    jm, jv, tm = _pair(hp)
    jdir, tdir = tmp_path / f"{name}_jax", tmp_path / f"{name}_port"
    jserve.save_model_bundle(jdir, jm, jv)
    tserve.save_model_bundle(tdir, tm)
    return jdir, tdir


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run the CLIs outside the repo: JAX's reads ``conf/base/logging.yml``
    from the working directory and would replace the test's log handlers."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _predict_both(capfd, tmp_path, jdir, tdir, *extra):
    x = _images(10, seed=9)
    np.save(tmp_path / "x.npy", x)
    outs = []
    for main, bundle, out in ((jcli.main, jdir, "jax"), (tcli.main, tdir, "port")):
        argv = ["predict", "--bundle", str(bundle), "--input", str(tmp_path / "x.npy"),
                "--output", str(tmp_path / f"{out}.npy"), "--batch-size", "4",
                "--to-tensor", *extra]
        assert main(argv + (["--device", "cpu"] if out == "port" else [])) == 0
        outs.append(json.loads(capfd.readouterr().out.strip().splitlines()[-1]))
    return outs


def _jax_eager_int8(jv, images, batch_size, quantize_scales=None):
    """JAX's int8 build applied op by op (no jit) to the predictor's zero-
    padded chunks, after ``to_tensor``; dynamic scales, or the static
    ``quantize_scales``."""
    jq = JaxModule((8, 8, 3), _conv_hp(), quantize="int8", quantize_scales=quantize_scales)
    outs = []
    for lo in range(0, len(images), batch_size):
        chunk = images[lo:lo + batch_size]
        pad = batch_size - len(chunk)
        chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
        y = np.asarray(jq.apply(jv, jnp.asarray(chunk.astype(np.float32) / 255.0)))
        outs.append(y[:batch_size - pad])
    return np.concatenate(outs)


def test_cli_predict_float_and_int8_match_jax(in_tmp, capfd):
    tmp_path = in_tmp
    """float within 1e-4 of JAX's ``predict``. In int8, dynamic and with
    ``--calibrate 16``, the port equals JAX's build run op by op within
    1e-4, the latter under the scales JAX's calibration gives on the same
    preprocessed images (all 10 here); the two JAX outputs lie further
    apart than that, so the bound tells them apart. JAX's ``predict`` runs
    the build jitted, and XLA's fused program rounds a few activations to
    the other code than XLA's own op-by-op run (by 5.6e-3 rel L2 on this
    model), so against it the bound is TIE_TOL, the one for rounding ties."""
    jm, jv, _ = _pair(_conv_hp())
    jdir, tdir = _bundles(tmp_path, _conv_hp(), "cls")
    jout, tout = _predict_both(capfd, tmp_path, jdir, tdir)
    assert tout == {**jout, "output": tout["output"]} and tout["output_shape"] == [10, 6]
    assert _rel(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")) <= FWD_TOL
    x = _images(10, seed=9)
    scales = jc.calibrate_int8_scales(jm, jv, [jnp.asarray(x[:16].astype(np.float32) / 255.0)])
    eager = {False: _jax_eager_int8(jv, x, 4), True: _jax_eager_int8(jv, x, 4, scales)}
    assert _rel(eager[True], eager[False]) > 100 * INT8_TOL
    for extra in (("--quantize", "int8"), ("--quantize", "int8", "--calibrate", "16")):
        _predict_both(capfd, tmp_path, jdir, tdir, *extra)
        got = np.load(tmp_path / "port.npy")
        assert _rel(got, np.load(tmp_path / "jax.npy")) <= TIE_TOL
        assert _rel(got, eager["--calibrate" in extra]) <= INT8_TOL, extra


def test_cli_predict_decodes_segmentation_and_detection_as_jax(in_tmp, capfd):
    tmp_path = in_tmp
    jdir, tdir = _bundles(tmp_path, _conv_hp(out=3, head="conv"), "seg")
    jout, tout = _predict_both(capfd, tmp_path, jdir, tdir, "--decode", "segmentation")
    assert tout["mask_shape"] == [10, 8, 8] and tout["classes_present"] == jout["classes_present"]
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    for hp, decode in ((_conv_hp(out=7, head="conv"), "detection"),
                       (_pyramid_hp(), "detection:8,4,2")):
        jdir, tdir = _bundles(tmp_path, hp, decode.replace(":", "_").replace(",", "_"))
        jout, tout = _predict_both(capfd, tmp_path, jdir, tdir, "--decode", decode,
                                   "--top-k", "5", "--nms-iou", "0.5")
        assert tout["detections_kept"] == jout["detections_kept"]
        got, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
        np.testing.assert_array_equal(got["classes"], ref["classes"])
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)


def test_cli_predict_y4m_matches_jax(in_tmp, capfd):
    """``predict --input clip.y4m``: both CLIs read the clip's RGB frames (4
    frames of 8x8, written by the JAX package's writer) and predict them
    within 1e-4 of each other."""
    from deepcv_tpu.data.video_io import write_y4m

    tmp_path = in_tmp
    jdir, tdir = _bundles(tmp_path, _conv_hp(), "cls")
    write_y4m(tmp_path / "clip.y4m", _images(4, seed=10), chroma="444")
    outs = []
    for main, bundle, out in ((jcli.main, jdir, "jax"), (tcli.main, tdir, "port")):
        argv = ["predict", "--bundle", str(bundle), "--input", str(tmp_path / "clip.y4m"),
                "--output", str(tmp_path / f"{out}.npy"), "--to-tensor"]
        assert main(argv + (["--device", "cpu"] if out == "port" else [])) == 0
        outs.append(json.loads(capfd.readouterr().out.strip().splitlines()[-1]))
    assert outs[0]["inputs"] == outs[1]["inputs"] == 4
    assert outs[1]["output_shape"] == [4, 6]
    assert _rel(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")) <= FWD_TOL


def test_cli_predict_refusals(in_tmp, capfd):
    tmp_path = in_tmp
    _, tdir = _bundles(tmp_path, _conv_hp(), "cls")
    np.save(tmp_path / "x.npy", _images(2))
    base = ["predict", "--bundle", str(tdir), "--device", "cpu"]
    assert tcli.main(base + ["--input", str(tmp_path / "missing.npy")]) == 2
    assert tcli.main(base + ["--input", str(tmp_path / "x.npy"), "--decode", "boxes"]) == 2
    assert tcli.main(base + ["--input", str(tmp_path / "x.npy"), "--batch-size", "0"]) == 2
    assert tcli.main(["predict", "--bundle", str(tmp_path), "--input",
                      str(tmp_path / "x.npy"), "--device", "cpu"]) == 2
    assert "not a model bundle" in capfd.readouterr().err


def test_cli_serve_quantize_builds_the_int8_predictor(tmp_path):
    _, _, tm = _pair(_conv_hp())
    tserve.save_model_bundle(tmp_path, tm)
    args = argparse.Namespace(bundle=str(tmp_path), quantize="int8", to_tensor=True,
                              normalize=None, batch_size=4, dtype=None, device="cpu")
    pred = tcli.serving_predictor(args)
    assert pred.model.quantize == "int8" and not pred.model.quantize_scales
    x = _images(3, seed=3)
    with torch.no_grad():
        ref = tm.with_options(quantize="int8")(_to_tensor(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(pred(x), ref)


# --------------------------------------------------------------------------- #
# DeepcvClassifier
# --------------------------------------------------------------------------- #

def _blobs(n=48, seed=0):
    """Two classes told apart by brightness."""
    rng = np.random.default_rng(seed)
    y = np.array(["cat", "dog"])[np.arange(n) % 2]
    x = rng.integers(0, 120, (n, 8, 8, 3)) + (y == "dog")[:, None, None, None] * 120
    return x.astype(np.uint8), y


def test_classifier_estimator_protocol_and_fit():
    clf = DeepcvClassifier(epochs=3, batch_size=8, lr=3e-3, validset_ratio=0.25, device="cpu",
                           hp={"log_progress_every_iters": 1})
    params = clf.get_params()
    assert params["epochs"] == 3 and set(params) == set(DeepcvClassifier._PARAM_NAMES)
    assert clf.set_params(lr=1e-2) is clf and clf.lr == 1e-2
    with pytest.raises(ValueError, match="Invalid parameter"):
        clf.set_params(nope=1)
    with pytest.raises(RuntimeError, match="not fitted"):
        clf.predict(np.zeros((1, 8, 8, 3), np.uint8))
    x, y = _blobs()
    clf.fit(x, y)
    np.testing.assert_array_equal(clf.classes_, ["cat", "dog"])
    losses = [e["loss"] for e in clf.history_["train"]]
    assert len(losses) == 12 and np.mean(losses[-3:]) < np.mean(losses[:3])
    proba = clf.predict_proba(x)
    assert proba.shape == (48, 2) and np.allclose(proba.sum(1), 1, atol=1e-6)
    assert set(clf.predict(x)) <= {"cat", "dog"} and 0.0 <= clf.score(x, y) <= 1.0
    clf.fine_tune(x[:16], y[:16], epochs=1)
    with pytest.raises(ValueError, match="not in classes_"):
        clf.fine_tune(x[:2], np.array(["cat", "emu"]))
    with pytest.raises(ValueError, match="at least 2 classes"):
        DeepcvClassifier(device="cpu").fit(x[:4], np.array(["cat"] * 4))


def test_classifier_predict_proba_matches_jax_on_carried_weights():
    hp = copy.deepcopy(DEFAULT_CNN_HP)
    hp["architecture"][-1]["fully_connected"]["out_features"] = 2
    jm, jv, tm = _pair(hp)
    x, _ = _blobs(10, seed=1)
    classes = np.array(["cat", "dog"])
    jclf = JaxClassifier(batch_size=4)
    jclf.classes_, jclf.model_, jclf.variables_, jclf._predictor = classes, jm, jv, None
    jclf._batch_transform = lambda b, augment=False: b.astype(jnp.float32) / 255.0
    tclf = DeepcvClassifier(batch_size=4, device="cpu")
    tclf.classes_, tclf.model_, tclf.history_, tclf._predictor = classes, tm, {}, None
    tclf._batch_transform = _to_tensor
    assert _rel(tclf.predict_proba(x), jclf.predict_proba(x)) <= FWD_TOL
    np.testing.assert_array_equal(tclf.predict(x), jclf.predict(x))

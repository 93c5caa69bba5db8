"""The keypoints slice of the port against the JAX package, on the CPU: the
conf's autoencoder (forward, parameter count, one ``self_supervised_target:
input`` step's losses, first-step gradients), keypoint extraction, dense
descriptors, mutual-NN matching, AdaLAM filtering fed the JAX package's own
Gumbel draws, the refusal of another self-supervised target, and
``train_keypoint_detector`` through ``run``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.pipelines import keypoints as jk
from deepcv_tpu.train.losses import mse_loss as jax_mse_loss
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data.datasets import ArrayDataset
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines import keypoints as tk
from deepcv_tpu_torch.train.losses import mse_loss
from deepcv_tpu_torch.train.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
STEP_TOL = 1e-5       # one training step's loss through a whole model
TOL = 1e-6


def _draw(shapes, seed):
    """Variables for the shapes of a JAX init: kernels normal with variance
    1 / fan-in, norm scales and running variances in [0.5, 1.5), biases and
    running means normal with std 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name or "var" in name:
            a = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _datasets(n=20, size=16, seed=0):
    rng = np.random.default_rng(seed)
    raw = ArrayDataset(rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8),
                       rng.integers(0, 10, n).astype(np.int64), classes=[str(i) for i in range(10)])
    return preprocess({"trainset": raw}, {"seed": 7, "transforms": ["to_tensor"],
                                          "split_dataset": {"validset_ratio": 0.2}})


@pytest.fixture(scope="module")
def autoencoder():
    path = os.path.join(REPO, "conf/base/parameters.yml")
    t_conf, j_conf = load_yaml(path), jax_load_yaml(path)
    datasets = _datasets()
    tm = tk.create_autoencoder(datasets, t_conf["keypoints_encoder_model"],
                               t_conf["keypoints_decoder_model"], device="cpu")
    jm = jk.create_autoencoder(datasets, j_conf["keypoints_encoder_model"],
                               j_conf["keypoints_decoder_model"])
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 1)
    load_jax_variables(tm, jv)
    return datasets, jm, jv, tm


def test_autoencoder_count_and_k2_convs(autoencoder):
    """3,987 parameters in JAX, the port's the same less the encoder stem's
    720 zero-padded kernel rows; three K2 convs (3 -> 16, 16 -> 16 and the
    16 -> 3 whose sigmoid runs after the kernel)."""
    _, _, jv, tm = autoencoder
    assert sum(a.size for a in jax.tree_util.tree_leaves(jv["params"])) == 3_987
    assert tm.capacity() == 3_267
    convs = [m for m in tm.modules() if isinstance(m, dnn.FusedConv2d)]
    assert [tuple(m.weight.shape[:2]) for m in convs] == [(16, 3), (16, 16), (3, 16)]
    assert [m.act for m in convs] == ["relu", "relu", torch.sigmoid]


@pytest.mark.parametrize("train_mode", [False, True])
def test_autoencoder_forward_matches_jax(autoencoder, train_mode):
    _, jm, jv, tm = autoencoder
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    x = np.random.default_rng(2).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    ref = jm.apply(jv, jnp.asarray(x), train=train_mode)
    ref = np.asarray(ref[0] if isinstance(ref, tuple) else ref)
    with torch.no_grad():
        code = tm.eval().encode(torch.from_numpy(x)).numpy()
        got = tm.train(train_mode)(torch.from_numpy(x)).numpy()
    tm.load_state_dict(state)
    assert got.shape == ref.shape == (2, 16, 16, 3) and _rel(got, ref) <= FWD_TOL
    assert code.shape == (2, 16, 16, 16)
    assert _rel(code, jm.encode(jv, jnp.asarray(x))) <= FWD_TOL


def test_self_supervised_step_matches_jax_mse(autoencoder, tmp_path):
    """One ``train_autoencoder`` step (16 images, one batch, learning rate
    0) and its validation: the step's loss is the JAX ``mse_loss`` of the
    JAX model's train-mode reconstruction against the transformed batch,
    and the validation loss the eval-mode one with the running statistics
    that step left, each within 1e-5."""
    datasets, jm, jv, tm = autoencoder
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    hp = {"epochs": 1, "batch_size": 16, "optimizer": "adamw",
          "optimizer_opts": {"lr": 0.0, "weight_decay": 1e-2}, "save_every_iters": 0,
          "log_progress_every_iters": 1, "output_path": str(tmp_path)}
    h = tk.train_autoencoder(datasets, tm, hp)["history"]
    tm.load_state_dict(state)

    def images(name):
        return jnp.asarray(datasets[name].dataset.images.astype(np.float32) / np.float32(255.0))

    x = images("trainset")
    out, new = jm.apply(jv, x, train=True)
    want = float(jax_mse_loss(out, x))
    assert abs(h["train"][0]["loss"] - want) <= STEP_TOL * want
    assert h["train"][0]["reconstruction_mse"] == h["train"][0]["loss"]
    xv = images("validset")
    out_v = jm.apply({"params": jv["params"], "batch_stats": new["batch_stats"]}, xv)
    want_v = float(jax_mse_loss(out_v, xv))
    assert abs(h["valid"][0]["valid_loss"] - want_v) <= STEP_TOL * want_v
    assert h["valid"][0]["valid_reconstruction_mse"] == h["valid"][0]["valid_loss"]


def test_other_self_supervised_target_raises_naming_the_key(autoencoder, tmp_path):
    datasets, _, _, tm = autoencoder
    hp = {"epochs": 1, "batch_size": 16, "optimizer_opts": {"lr": 0.0},
          "output_path": str(tmp_path), "self_supervised_target": "target"}
    with pytest.raises(ValueError, match="hp 'self_supervised_target' = 'target'"):
        train(hp, tm, mse_loss, datasets)


def test_autoencoder_first_step_gradients_match_jax(autoencoder):
    """Train mode: the reconstruction MSE of one batch against itself and
    every parameter's gradient within rtol 1e-3 and 1e-3 of its tensor's
    largest entry."""
    _, jm, jv, tm = autoencoder
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    x = np.random.default_rng(3).uniform(size=(4, 16, 16, 3)).astype(np.float32)

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, jnp.asarray(x),
                          train=True)
        return jax_mse_loss(out, jnp.asarray(x))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jv["params"])
    grads = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                     "batch_stats": jv["batch_stats"]}, tm)
    got = dict(tm.named_parameters())
    ref = {k: v for k, v in grads.items() if k in got}
    tm.train()
    for p in tm.parameters():
        p.grad = None
    tloss = mse_loss(tm(torch.from_numpy(x)), torch.from_numpy(x))
    tloss.backward()
    tm.load_state_dict(state)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = want.numpy()
        np.testing.assert_allclose(got[key].grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()) + 1e-8,
                                   err_msg=key)


# --------------------------------------------------------------------------- #
# keypoints, descriptors, matching, AdaLAM
# --------------------------------------------------------------------------- #

def _score_maps():
    """Random maps with plateaus (ties at a peak) and a smooth map with one
    peak, far fewer than k: its other entries rank as -inf by index."""
    rng = np.random.default_rng(4)
    s = rng.integers(0, 6, size=(3, 12, 14)).astype(np.float32) / 5.0
    yy, xx = np.mgrid[0:12, 0:14]
    s[2] = np.exp(-((yy - 5) ** 2 + (xx - 6) ** 2) / 20.0)
    return s


@pytest.mark.parametrize("window", [3, 4, 5])
@pytest.mark.parametrize("min_score", [0.0, 0.5])
def test_extract_keypoints_matches_jax(window, min_score):
    s = _score_maps()
    tc, ts = tk.extract_keypoints(torch.from_numpy(s[..., None]), k=24, nms_window=window,
                                  min_score=min_score)
    jc, js = jk.extract_keypoints(jnp.asarray(s[..., None]), k=24, nms_window=window,
                                  min_score=min_score)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    js = np.asarray(js)
    np.testing.assert_array_equal(np.isinf(ts.numpy()), np.isinf(js))
    fin = np.isfinite(js)
    assert np.abs(ts.numpy()[fin] - js[fin]).max() <= TOL
    assert np.isfinite(ts.numpy()[2]).sum() == 1


def test_dense_descriptors_match_jax():
    f = np.random.default_rng(5).normal(size=(2, 6, 5, 16)).astype(np.float32)
    for norm in (True, False):
        got = tk.extract_dense_descriptors(torch.from_numpy(f), norm).numpy()
        ref = np.asarray(jk.extract_dense_descriptors(jnp.asarray(f), norm))
        assert got.shape == (2, 30, 16) and np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("mutual,max_distance", [(True, None), (True, 0.9), (False, 0.8)])
def test_match_descriptors_matches_jax(mutual, max_distance):
    """A batch of 4 pairs in one call against the JAX function vmapped over
    them: indices and masks equal."""
    rng = np.random.default_rng(6)
    da = rng.normal(size=(4, 32, 16)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    db = da[:, ::-1] + 0.4 * rng.normal(size=da.shape).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    bt, vt = tk.match_descriptors(torch.from_numpy(da), torch.from_numpy(db), mutual,
                                  max_distance)
    bj, vj = jax.vmap(lambda a, b: jk.match_descriptors(a, b, mutual, max_distance))(da, db)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert 0 < vt.sum() < vt.numel()


def _adalam_case(seed):
    """96 keypoints in a 96x96 image, their matches under a similarity
    transform (rotation 0.3, scale 1.1, shift 5) on rounded pixels, every
    fourth match replaced by a random one, a tenth invalid."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 96, size=(96, 2)).astype(np.int32)
    ang = 0.3
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    b = np.round(a @ rot.T * 1.1 + 5).astype(np.int32)
    b[::4] = rng.integers(0, 96, size=b[::4].shape)
    perm = rng.permutation(96)
    matches = np.argsort(perm)
    return (a, b[perm], matches, rng.uniform(size=96) > 0.1,
            rng.uniform(size=96).astype(np.float32))


@pytest.mark.parametrize("with_scores", [False, True])
def test_filter_matches_adalam_matches_jax_with_its_draws(with_scores):
    """Fed the JAX package's Gumbel draws (``jax.random.split(key, S)``, then
    ``jax.random.gumbel`` per seed), the refined mask equals the JAX one,
    outliers dropped and inliers kept."""
    a, b, m, valid, scores = _adalam_case(7)
    sc = scores if with_scores else None
    key = jax.random.PRNGKey(11)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (16, 96)))
                       for k in jax.random.split(key, 32)])
    ref = np.asarray(jk.filter_matches_adalam(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), jnp.asarray(valid),
        None if sc is None else jnp.asarray(sc), key=key))
    got = tk.filter_matches_adalam(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m), torch.from_numpy(valid),
        None if sc is None else torch.from_numpy(sc), gumbel=torch.from_numpy(gumbel)).numpy()
    np.testing.assert_array_equal(got, ref)
    inlier = (np.arange(96) % 4 != 0) & valid
    assert got[inlier].mean() > 0.9 and got[~inlier].mean() < 0.2
    assert not (got & ~valid).any()


def test_filter_matches_adalam_draws_its_own_and_checks_the_shape():
    a, b, m, valid, _ = _adalam_case(8)
    args = [torch.from_numpy(t) for t in (a, b, m, valid)]
    got = tk.filter_matches_adalam(*args)
    again = tk.filter_matches_adalam(*args, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, again) and got.sum() > 48
    with pytest.raises(ValueError, match="gumbel must be"):
        tk.filter_matches_adalam(*args, gumbel=torch.zeros(32, 8, 96))


# --------------------------------------------------------------------------- #
# the pipeline
# --------------------------------------------------------------------------- #

def test_train_keypoint_detector_runs_end_to_end_on_cpu(tmp_path):
    """The conf's encoder, decoder and hp (AdamW, the warm-up schedule) on
    the CIFAR-10 entries cut to 40 + 8 synthetic images, one epoch at batch
    8: finite reconstruction MSE in training and validation."""
    root = tmp_path / "project"
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "cifar10_train": {"type": "synthetic", "n": 40, "image_shape": [32, 32, 3],
                          "num_classes": 10},
        "cifar10_test": {"type": "synthetic", "train": False, "n": 8,
                         "image_shape": [32, 32, 3], "num_classes": 10}}))
    p = "train_keypoint_detector"
    store = cli_run([f"--pipeline={p}", "--project-path", str(root), "--device", "cpu",
                     "--params", f"{p}.epochs:1,{p}.batch_size:8,{p}.save_every_iters:0,"
                                 f"{p}.output_path:{tmp_path / 'out'}"])
    h = store["train_results"]["history"]
    assert h["steps"] == len(store["datasets"]["trainset"]) // 8 > 0
    assert np.isfinite([e["reconstruction_mse"] for e in h["train"]]).all()
    assert np.isfinite(h["valid"][-1]["valid_reconstruction_mse"])
    assert store["model"].capacity() == 3_267 and store["model"].device.type == "cpu"

"""The port's active learning, boosting, Reptile meta-learning and training
metadata against the JAX package, on the CPU at the JAX tests' sizes (8x8
and 12x12 images, narrow convs): acquisitions bit-equal on the same stack
and rng, the MC scorer (batch norm, a ragged tail) and a two-round loop from
carried weights, SAMME's loss, reweighting and one round fed JAX's index
draws, the ensemble's votes, episodes bit-equal and two Reptile meta-steps,
the experiment record and the spec hashes."""
import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.data import datasets as jds
from deepcv_tpu.data.training_metadata import MetaTracker as JaxMetaTracker
from deepcv_tpu.hyperparams import Hyperparameters as JaxHyperparameters
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.train import active_learning as jal
from deepcv_tpu.train import boosting as jboost
from deepcv_tpu.train import meta_learning as jmeta
from deepcv_tpu.train.backend import BackendConfig as JaxBackendConfig
from deepcv_tpu.train.losses import cross_entropy_loss as jax_ce
from deepcv_tpu_torch import train as ttrain_pkg
from deepcv_tpu_torch.data import datasets as tds
from deepcv_tpu_torch.data.training_metadata import MetaTracker
from deepcv_tpu_torch.hyperparams import Hyperparameters
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train import active_learning as tal
from deepcv_tpu_torch.train import boosting as tboost
from deepcv_tpu_torch.train import meta_learning as tmeta
from deepcv_tpu_torch.train import training as ttraining
from deepcv_tpu_torch.train.losses import cross_entropy_loss

jpre = importlib.import_module("deepcv_tpu.data.preprocess")
tpre = importlib.import_module("deepcv_tpu_torch.data.preprocess")

#: one forward of f32 probabilities, port vs JAX from the same weights
PROB_ATOL = 1e-5
#: whole train() runs: metrics (the runtime tests' parameter bound)
METRIC_ATOL = 1e-4
#: SAMME's scalar arithmetic, f32
SCALAR_TOL = 1e-6
#: parameters after a boosting round of SGD (relative to max|ref|)
ROUND_RTOL = 1e-4
#: parameters after two Reptile meta-steps (relative to max|ref|)
REPTILE_RTOL = 1e-5


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(hp, shape, variables):
    """The port's CPU model of ``hp`` holding the JAX ``variables``."""
    return load_jax_variables(DeepcvModule(shape, copy.deepcopy(hp), device="cpu"),
                              _numpy(variables))


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / max(float(ref.abs().max()), 1e-30))


def _assert_params(model, jax_variables, rtol):
    ref = jax_to_torch_state_dict(_numpy(jax_variables), model)
    got = model.state_dict()
    for k, v in ref.items():
        assert _max_rel(got[k], v) <= rtol, k


# --------------------------------------------------------------------------- #
# Active learning
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["entropy", "bald", "margin", "variation_ratio", "random"])
def test_acquisitions_equal_jax(name):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 24, 3)) * 2
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    got = tal.acquisition_scores(probs, name, np.random.default_rng(5))
    ref = jal.acquisition_scores(probs, name, np.random.default_rng(5))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    with pytest.raises(ValueError, match="unknown acquisition"):
        tal.acquisition_scores(probs, "nope")
    assert set(tal.ACQUISITION_FNS) == set(jal.ACQUISITION_FNS)


BN_HP = {"act_fn": "relu", "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
         "architecture": [
             {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
             {"flatten": {}},
             {"fully_connected": {"out_features": 2, "act_fn": None, "batch_norm": None}}]}


def _brightness_pools(n_pure=28, n_boundary=8, seed=0):
    """The JAX test's binary brightness task in both packages: pure dark and
    bright images plus mid-brightness boundary ones."""
    rng = np.random.default_rng(seed)

    def imgs(n, level):
        return np.clip(rng.normal(level, 12, (n, 8, 8, 3)), 0, 255).astype(np.uint8)

    images = np.concatenate([imgs(n_pure, 40), imgs(n_pure, 210), imgs(n_boundary, 125)])
    targets = np.concatenate([np.zeros(n_pure), np.ones(n_pure),
                              rng.random(n_boundary) < 0.5]).astype(np.int64)
    vimages = np.concatenate([imgs(8, 40), imgs(8, 210)])
    vtargets = np.concatenate([np.zeros(8), np.ones(8)]).astype(np.int64)
    out = []
    for ds, pre in ((jds, jpre), (tds, tpre)):
        tf = pre.parse_transforms_specification(["to_tensor"])
        out.append({"poolset": pre.PreprocessedDataset(
                        ds.ArrayDataset(images, targets, classes=["d", "b"], name="pool"),
                        transform=tf),
                    "validset": pre.PreprocessedDataset(
                        ds.ArrayDataset(vimages, vtargets, classes=["d", "b"], name="valid"),
                        transform=tf)})
    return out


def test_mc_class_probabilities_match_jax_with_batch_norm_and_a_ragged_tail():
    """Train-mode batch norm normalises each chunk by its own statistics, so
    the tail of 2 (of chunks of 4) pins the JAX scorer's padding by the last
    real row; the port's running statistics come back unchanged."""
    jd, td = _brightness_pools()
    jm = JaxModule((8, 8, 3), copy.deepcopy(BN_HP))
    v = jm.init(jax.random.PRNGKey(3))
    tm = _carry(BN_HP, (8, 8, 3), v)
    tm.eval()
    before = {k: b.clone() for k, b in tm.named_buffers()}
    idx = np.arange(50, 60)
    ref = jal.mc_class_probabilities(jm, v, jd["poolset"], idx, n_samples=2, batch_size=4)
    got = tal.mc_class_probabilities(tm, td["poolset"], idx, n_samples=2, batch_size=4)
    assert got.shape == ref.shape == (2, 10, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL)
    assert not tm.training
    assert all(torch.equal(b, before[k]) for k, b in tm.named_buffers())


def test_mc_samples_draw_from_their_own_generators():
    """With dropout the samples differ from each other, the same seed gives
    the same stack, and the model's own generators are put back."""
    hp = copy.deepcopy(BN_HP)
    hp["dropout_prob"] = 0.3
    _, td = _brightness_pools()
    tm = DeepcvModule((8, 8, 3), hp, device="cpu")
    a = tal.mc_class_probabilities(tm, td["poolset"], np.arange(6), n_samples=3, seed=1)
    b = tal.mc_class_probabilities(tm, td["poolset"], np.arange(6), n_samples=3, seed=1)
    assert np.array_equal(a, b) and np.abs(a[0] - a[1]).max() > 1e-6
    np.testing.assert_allclose(a.sum(-1), 1.0, rtol=1e-5)
    assert all(m.generator is None for m in tm.modules() if hasattr(m, "generator"))


def test_active_learning_loop_matches_jax(tmp_path, monkeypatch):
    """Two rounds from carried weights (the JAX loop inits every round from
    the same key), the JAX epoch orders fed to the port's resident sampler:
    the acquired sets, the labeled indices and every round's metrics."""
    jd, td = _brightness_pools()
    seed = 3
    jm = JaxModule((8, 8, 3), copy.deepcopy(BN_HP))
    v = jm.init(jax.random.split(jax.random.PRNGKey(seed))[0])

    def carried(shape, hp, device=None, generator=None):
        return _carry(hp, shape, v)

    def jax_order(s, epoch, n):
        key = jax.random.fold_in(jax.random.PRNGKey(s ^ 0x5EED), epoch)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, n)).astype(np.int64))

    monkeypatch.setattr(tal, "DeepcvModule", carried)
    monkeypatch.setattr(ttraining, "epoch_permutation", jax_order)
    hp = {"epochs": 3, "batch_size": 16, "optimizer": "sgd",
          "optimizer_opts": {"lr": 0.05, "momentum": 0.9}, "validate_every_epochs": 3,
          "log_progress_every_iters": 0, "handle_preemption": False,
          "device_resident_dataset": True}
    kw = dict(rounds=2, acquire_per_round=8, init_labeled=16, acquisition="entropy",
              n_mc=2, seed=seed, score_batch_size=16)
    ref = jal.active_learning_loop((8, 8, 3), copy.deepcopy(BN_HP),
                                   {**hp, "output_path": str(tmp_path / "jax")}, jax_ce, jd,
                                   backend_conf=JaxBackendConfig(n_devices=1), **kw)
    got = tal.active_learning_loop((8, 8, 3), copy.deepcopy(BN_HP),
                                   {**hp, "output_path": str(tmp_path / "port")},
                                   cross_entropy_loss, td, device="cpu", **kw)
    assert [r["n_labeled"] for r in got["rounds"]] == [16, 24]
    assert np.array_equal(got["labeled_indices"], ref["labeled_indices"])
    for g, r in zip(got["rounds"], ref["rounds"]):
        assert g["acquired"] == r["acquired"]
        for k in ("valid_loss", "valid_accuracy"):
            assert g[k] == pytest.approx(r[k], abs=METRIC_ATOL), k
    assert got["final"] == pytest.approx(ref["final"], abs=METRIC_ATOL)
    with pytest.raises(ValueError, match="unknown acquisition"):
        tal.active_learning_loop((8, 8, 3), BN_HP, hp, cross_entropy_loss, td,
                                 acquisition="nope", device="cpu")


# --------------------------------------------------------------------------- #
# Boosting
# --------------------------------------------------------------------------- #

C = 3


def _cluster_dataset(n_per=40, size=8, noise=1.4, seed=0):
    """The JAX test's three-class task: a bright patch at one of three rows."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(C):
        for _ in range(n_per):
            img = rng.normal(0.0, noise, (size, size, 3))
            r = 1 + c * 2
            img[r:r + 2, 2:6] += 1.0
            xs.append(img)
            ys.append(c)
    order = rng.permutation(len(xs))
    return np.asarray(xs, np.float32)[order], np.asarray(ys, np.int64)[order]


def _weak_hp(batch_norm=False):
    conv = {"kernel_size": [3, 3], "out_channels": 4, "stride": 2}
    if batch_norm:
        conv = dict(conv, batch_norm={})
    return {"act_fn": "relu", "architecture": [
        {"conv2d": conv}, {"flatten": {}},
        {"fully_connected": {"out_features": C, "act_fn": None}}]}


def _jax_reweight(w, pred, labels, c):
    """The JAX package's SAMME update (the ``reweight`` closure of
    ``adaboost_train``), written out."""
    wrong = (pred != labels).astype(jnp.float32)
    err = jnp.sum(w * wrong) / (jnp.sum(w) + 1e-12)
    alpha = jnp.log((1.0 - err) / jnp.maximum(err, 1e-12)) + np.log(c - 1)
    w2 = w * jnp.exp(alpha * wrong)
    return w2 / (jnp.sum(w2) + 1e-12), err, alpha


def test_weighted_ce_reweighting_and_alpha_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(64, C)).astype(np.float32) * 3
    y = rng.integers(0, C, 64)
    w = rng.random(64).astype(np.float32)
    got = tboost._weighted_ce(torch.from_numpy(logits), torch.from_numpy(y),
                              torch.from_numpy(w))
    ref = jboost._weighted_ce(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w))
    assert float(got) == pytest.approx(float(ref), rel=SCALAR_TOL)
    pred = rng.integers(0, C, 64)
    w /= w.sum()
    g_w, g_err, g_alpha = tboost._reweight(torch.from_numpy(w), torch.from_numpy(pred),
                                           torch.from_numpy(y), C)
    r_w, r_err, r_alpha = _jax_reweight(jnp.asarray(w), jnp.asarray(pred), jnp.asarray(y), C)
    assert float(g_err) == pytest.approx(float(r_err), rel=SCALAR_TOL)
    assert float(g_alpha) == pytest.approx(float(r_alpha), rel=SCALAR_TOL)
    np.testing.assert_allclose(g_w.numpy(), np.asarray(r_w), rtol=SCALAR_TOL)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "batch_norm"])
def test_boosting_round_fed_jax_draws_matches_jax(batch_norm):
    """JAX's round 0 (its init key, its index draws ``randint(fold_in(k,
    1))``) against the port's ``_train_round`` on the carried init and the
    same index batches: the fitted member, its weighted error and alpha."""
    images, labels = _cluster_dataset()
    hp = _weak_hp(batch_norm)
    jm = JaxModule((8, 8, 3), copy.deepcopy(hp))
    steps, bs, lr, seed = 6, 32, 0.03, 0
    ens, hist = jboost.adaboost_train(jm, images, labels, rounds=1, num_classes=C,
                                      inner_steps=steps, batch_size=bs, lr=lr, seed=seed)
    init_key, train_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    index_batches = [torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.fold_in(k, 1), (bs,), 0, len(images))).astype(np.int64))
        for k in jax.random.split(train_key, steps)]
    tm = _carry(hp, (8, 8, 3), jm.init(init_key))
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    w = torch.full((len(images),), 1.0 / len(images))
    tboost._train_round(tm, x, y, w, index_batches, lr=lr, momentum=0.9,
                        generator=torch.Generator())
    _assert_params(tm, ens.members[0], ROUND_RTOL)
    _, err, alpha = tboost._reweight(w, tboost._predict(tm, None, x, 512), y, C)
    assert float(err) == pytest.approx(hist["err"][0], rel=SCALAR_TOL)
    assert float(alpha) == pytest.approx(hist["alpha"][0], rel=SCALAR_TOL)


def test_vote_scores_equal_jax():
    """An ensemble of JAX's members carried into the port votes as JAX's."""
    images, labels = _cluster_dataset()
    hp = _weak_hp()
    jm = JaxModule((8, 8, 3), copy.deepcopy(hp))
    ens, hist = jboost.adaboost_train(jm, images, labels, rounds=3, num_classes=C,
                                      inner_steps=10, batch_size=32, lr=0.03, seed=2)
    tm = DeepcvModule((8, 8, 3), copy.deepcopy(hp), device="cpu")
    members = [jax_to_torch_state_dict(_numpy(m), tm) for m in ens.members]
    port = tboost.BoostedEnsemble(tm, members, ens.alphas, C, eval_batch=7)
    assert np.array_equal(port.vote_scores(images), ens.vote_scores(images))
    assert port.accuracy(images, labels) == ens.accuracy(images, labels)
    with pytest.raises(ValueError, match="alpha per member"):
        tboost.BoostedEnsemble(tm, [], [], C)


def test_adaboost_train_runs_its_rounds_and_validates():
    images, labels = _cluster_dataset(n_per=30)
    model = DeepcvModule((8, 8, 3), _weak_hp(batch_norm=True), device="cpu")
    ens, hist = tboost.adaboost_train(model, images, labels, rounds=3, num_classes=C,
                                      inner_steps=8, batch_size=32, lr=0.03, seed=1)
    assert 1 <= len(ens.members) == len(ens.alphas) == len(hist["err"]) <= 3
    assert all(0 < a <= tboost.ALPHA_CAP for a in ens.alphas)
    assert all(e < 1 - 1 / C for e in hist["err"])
    assert hist["vote_accuracy"][-1] == pytest.approx(ens.accuracy(images, labels))
    assert any("running_mean" in k for k in ens.members[0])
    votes = ens.vote_scores(images[:5])
    np.testing.assert_allclose(votes.sum(-1), sum(ens.alphas), rtol=1e-5)
    with pytest.raises(ValueError, match="rounds"):
        tboost.adaboost_train(model, images, labels, rounds=0)


# --------------------------------------------------------------------------- #
# Reptile
# --------------------------------------------------------------------------- #

N_WAY, K_SHOT, Q = 4, 5, 5


def _square_dataset(n_classes=6, per_class=12, size=12, seed=0):
    """The JAX test's few-shot task: class c is a bright square at grid cell c."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        r, col = divmod(c, 4)
        for _ in range(per_class):
            img = rng.normal(0.1, 0.05, (size, size, 3))
            rr, cc = 1 + r * 3, 1 + col * 3
            img[rr:rr + 3, cc:cc + 3] += rng.uniform(0.7, 1.0)
            xs.append(img)
            ys.append(c)
    order = rng.permutation(len(xs))
    return np.asarray(xs, np.float32)[order], np.asarray(ys, np.int64)[order]


META_HP = {"act_fn": "relu", "group_norm": {"num_groups": 2, "eps": 1e-5},
           "architecture": [
               {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}},
               {"conv2d": {"kernel_size": [3, 3], "out_channels": 8, "stride": 2}},
               {"flatten": {}},
               {"fully_connected": {"out_features": N_WAY, "act_fn": None,
                                    "group_norm": None}}]}


def test_sample_episodes_bit_equal_and_validated():
    images, labels = _square_dataset()
    got = tmeta.sample_episodes(images, labels, n_way=N_WAY, k_shot=K_SHOT, q_queries=Q,
                                n_episodes=3, rng=np.random.default_rng(4))
    ref = jmeta.sample_episodes(images, labels, n_way=N_WAY, k_shot=K_SHOT, q_queries=Q,
                                n_episodes=3, rng=np.random.default_rng(4))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="need >= 10 classes"):
        tmeta.sample_episodes(images, labels, n_way=10, k_shot=1, q_queries=1,
                              n_episodes=1, rng=rng)
    with pytest.raises(ValueError, match="episodes need"):
        tmeta.sample_episodes(images, labels, n_way=2, k_shot=10, q_queries=10,
                              n_episodes=1, rng=rng)


def test_reptile_meta_steps_adapt_and_accuracy_match_jax():
    """Two meta-steps of 3 episodes (K2's convs among the ops, the 'same'
    one on the plain route here) from carried weights: the meta parameters,
    each step's adapted query accuracy, then ``adapt`` and
    ``episode_accuracy`` on a held-out episode."""
    images, labels = _square_dataset()
    jm = JaxModule((12, 12, 3), copy.deepcopy(META_HP))
    v = jm.init(jax.random.PRNGKey(7))
    kw = dict(n_way=N_WAY, k_shot=K_SHOT, q_queries=Q, meta_steps=2, meta_batch=3,
              inner_steps=3, inner_lr=0.08, meta_lr=0.5, meta_lr_final=0.1, seed=1)
    ref_vars, ref_hist = jmeta.reptile_train(jm, images, labels, variables=v, **kw)
    tm = _carry(META_HP, (12, 12, 3), v)
    got_model, got_hist = tmeta.reptile_train(tm, images, labels, **kw)
    assert got_model is tm and tm.training
    _assert_params(tm, ref_vars, REPTILE_RTOL)
    assert got_hist["query_accuracy"] == ref_hist["query_accuracy"]
    np.testing.assert_allclose(got_hist["meta_lr"], ref_hist["meta_lr"], rtol=1e-7)

    sx, sy, qx, qy = jmeta.sample_episodes(images, labels, n_way=N_WAY, k_shot=K_SHOT,
                                           q_queries=Q, n_episodes=1,
                                           rng=np.random.default_rng(9))
    ref_adapted = jmeta.adapt(jm, ref_vars, sx[0], sy[0], steps=3, lr=0.08)
    before = {k: p.clone() for k, p in tm.state_dict().items()}
    adapted = tmeta.adapt(tm, sx[0], sy[0], steps=3, lr=0.08)
    assert all(torch.equal(p, before[k]) for k, p in tm.state_dict().items())
    _assert_params(adapted, ref_adapted, REPTILE_RTOL)
    assert tmeta.episode_accuracy(adapted, qx[0], qy[0]) == \
        jmeta.episode_accuracy(jm, ref_adapted, qx[0], qy[0])


def test_batch_stats_models_are_refused():
    hp = {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 4, "batch_norm": {}}},
        {"flatten": {}}, {"fully_connected": {"out_features": N_WAY, "act_fn": None}}]}
    model = DeepcvModule((12, 12, 3), hp, device="cpu")
    images, labels = _square_dataset()
    with pytest.raises(ValueError, match="few-shot BN failure"):
        tmeta.reptile_train(model, images, labels, n_way=N_WAY, meta_steps=1)
    with pytest.raises(ValueError, match="few-shot BN failure"):
        tmeta.adapt(model, images[:4], labels[:4])


# --------------------------------------------------------------------------- #
# Training metadata and the spec hash
# --------------------------------------------------------------------------- #

CONF = jax_load_yaml("conf/base/parameters.yml")
CONF_MODELS = sorted(k for k, v in CONF.items() if k.endswith("_model") and isinstance(v, dict))


@pytest.mark.parametrize("key", CONF_MODELS)
def test_spec_hash_equals_jax_for_the_conf_models(key):
    assert Hyperparameters(copy.deepcopy(CONF[key])).spec_hash() == \
        JaxHyperparameters(copy.deepcopy(CONF[key])).spec_hash()


def _drop_ids(d):
    if isinstance(d, dict):
        return {k: _drop_ids(v) for k, v in d.items() if k not in ("uuid", "created_at")}
    if isinstance(d, (list, tuple)):
        return [_drop_ids(v) for v in d]
    return d


def test_metatracker_record_equals_jax_but_ids_times_and_the_stem_padding(tmp_path):
    """The conf's image classifier at 32x32x3: the record of the same
    training summary in both stores. The capacities differ by the zero
    kernel rows of the JAX convs whose input channels are padded to 8: the
    5x5 stem from 3 (5 x 5 x 5 x 4), the two 5x5 and the 3x3 from 4 (2 x 5 x
    5 x 4 x 4 and 3 x 3 x 4 x 16), 1,876 weights."""
    hp = copy.deepcopy(CONF["image_classifier_model"])
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    jm = JaxModule((32, 32, 3), copy.deepcopy(hp))
    tm = DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="meta")
    x = np.random.default_rng(0).integers(0, 256, (20, 32, 32, 3), dtype=np.uint8)
    y = np.arange(20) % 10
    hist = {"valid": [{"epoch": 2, "valid_accuracy": 0.75, "valid_loss": 0.5}], "steps": 12,
            "total_time_s": 3.5}
    training_hp = dict(CONF["train_image_classifier"])
    stored = []
    for tracker_cls, model, ds in (
            (JaxMetaTracker, jm, jds.ArrayDataset(x, y, name="cifar")),
            (MetaTracker, tm, tds.ArrayDataset(x, y, name="cifar"))):
        tracker = tracker_cls(tmp_path / tracker_cls.__module__)
        tracker.store(tracker_cls.experiment_from_training(model, training_hp, hist, ds))
        stored.append(tracker.load_all())
        assert tracker.scaling_triplets() == [{"capacity": float(model.capacity()),
                                              "trainset_size": 20.0, "val_error": 0.25}]
    (ref,), (got,) = stored
    assert ref["model_capacity"] - got["model_capacity"] == \
        5 * 5 * 5 * 4 + 2 * 5 * 5 * 4 * 4 + 3 * 3 * 4 * 16 == 1876
    assert got["model_capacity"] == tm.capacity()
    got["model_capacity"] = ref["model_capacity"]
    assert got["uuid"] != ref["uuid"]
    assert _drop_ids(got) == _drop_ids(ref)
    assert got["model_spec_hash"] == jm.hp.spec_hash()


def test_train_package_reexports_the_jax_names():
    import deepcv_tpu.train as jtrain
    public = {n for n in vars(jtrain) if not n.startswith("_")
              and not isinstance(getattr(jtrain, n), type(jtrain))}
    assert public <= set(vars(ttrain_pkg))

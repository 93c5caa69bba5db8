"""``train_image_classifier`` in the port against the JAX package, on the
CPU: the nested-module spec and the sigmoid head with the same weights
(carried across by ``deepcv_tpu_torch.interop``), forward and first-step
gradients; the CIFAR/MNIST loaders and their synthetic stand-ins; the
repairs F1 (K2 in autocast's dtype) and F2 (``deterministic``); and the
pipeline end to end through the port's ``run``."""
import gzip
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml

from deepcv_tpu.data import datasets as JD
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data import datasets as D
from deepcv_tpu_torch.data.preprocess import PreprocessedDataset, preprocess
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.ops.kernels.fused_augment import fused_augment_normalize
from deepcv_tpu_torch.pipelines.classification import create_model
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train import training
from deepcv_tpu_torch.train.losses import cross_entropy_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
CONVS = 5             # image_classifier's stride-1 convs, all in K2


def _classifier_hp(num_classes=10):
    hp = dict(load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))["image_classifier_model"])
    hp["architecture"][-1]["fully_connected"]["out_features"] = num_classes
    return hp


def _tree_numpy(tree, seed=None):
    """JAX variables as writable numpy; with ``seed``, every batch-stats leaf
    is moved off its init value so eval-mode BatchNorm is exercised."""
    out = jax.tree_util.tree_map(np.array, tree)
    if seed is not None and "batch_stats" in out:
        rng = np.random.default_rng(seed)

        def move(d):
            for k, v in d.items():
                if isinstance(v, dict):
                    move(v)
                elif k == "mean":
                    d[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
                elif k == "var":
                    d[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        move(out["batch_stats"])
    return out


def _pair(hp, shape=(32, 32, 3), seed=3):
    jm = JaxModule(shape, hp)
    jv = _tree_numpy(jm.init(jax.random.PRNGKey(seed)), seed)
    tm = DeepcvModule(shape, hp, device="cpu").eval()
    load_jax_variables(tm, jv)
    return jm, jv, tm


# --------------------------------------------------------------------------- #
# The model: nested module, sigmoid head
# --------------------------------------------------------------------------- #

def test_image_classifier_spec_builds_with_the_nested_backbone():
    m = DeepcvModule((32, 32, 3), _classifier_hp(), device="meta")
    nested = m.module.nodes["_submodule_0_nested"]
    assert [meta.creator for meta in m.module.node_metas] == \
        ["nested", "flatten", "fully_connected"]
    # the backbone's own hp: relu fused into K2 and group_norm, not the outer
    # leaky_relu and batch_norm
    convs = [mod for mod in nested.modules() if isinstance(mod, dnn.FusedConv2d)]
    assert len(convs) == CONVS and all(c.act == "relu" for c in convs)
    norms = [type(n).__name__ for c in nested.nodes.values() if hasattr(c, "norms")
             for n in c.norms]
    assert norms == ["GroupNorm"] * CONVS
    head = m.module.nodes["_submodule_2_fully_connected"]
    assert head.act_fn is torch.sigmoid and len(head.norms) == 0
    assert m.node_shapes["_submodule_0_nested"] == (1, 8, 8, 20)
    assert m.capacity() == 16_922


def test_image_classifier_forward_matches_jax():
    jm, jv, tm = _pair(_classifier_hp())
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=FWD_TOL, rtol=0)
    assert ref.std() > 1e-3          # the sigmoid does not saturate everything


def test_image_classifier_first_step_gradients_match_jax():
    jm, jv, tm = _pair(_classifier_hp())
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,))

    def loss_fn(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jv["params"])
    tm.train()
    tloss = F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y).long())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    ref = jax_to_torch_state_dict({"params": _tree_numpy(jgrads)}, tm)
    grads = dict(tm.named_parameters())
    assert set(ref) == set(grads)
    for k, g in ref.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=k)


def test_nested_batch_stats_names_and_forms_carry_across():
    """A nested module with batch_norm, an explicit name and the list form of
    its sub-hp: parameters and running statistics map 1:1 from JAX."""
    inner = [{"conv2d": {"kernel_size": [3, 3], "out_channels": 4}},
             {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}}]
    hp = {"act_fn": "relu", "architecture": [
        {"_nested_deepcv_module": {"_name": "backbone", "act_fn": "leaky_relu",
                                   "batch_norm": {"momentum": 0.1, "eps": 1e-5},
                                   "architecture": inner}},
        {"_nested_deepcvmodule": inner},
        {"flatten": {}},
        {"fully_connected": {"out_features": 3}}]}
    jm, jv, tm = _pair(hp, (8, 8, 2))
    assert "module.nodes.backbone.nodes._submodule_0_conv2d.norms.0.running_var" \
        in tm.state_dict()
    assert "module.nodes._submodule_1_nested.nodes._submodule_0_conv2d.op.weight" \
        in tm.state_dict()
    x = np.random.default_rng(2).normal(size=(3, 8, 8, 2)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=FWD_TOL, rtol=0)
    bad = {"params": {"node_impls_backbone": {"node_impls_ghost": {"op": {"kernel": 0}}}}}
    with pytest.raises(KeyError, match="ghost"):
        jax_to_torch_state_dict(bad, tm)


def test_create_model_injects_the_class_count_into_a_nested_head():
    class _Set:
        image_shape, num_classes = (8, 8, 3), 7

    hp = {"act_fn": "relu", "architecture": [
        {"_nested_deepcvmodule": {"act_fn": "relu", "architecture": [
            {"flatten": {}}, {"fully_connected": {}}]}}]}
    m = create_model({"trainset": _Set()}, hp, device="cpu")
    assert m.output_shape == (1, 7)
    m = create_model({"trainset": _Set()}, {**_classifier_hp(None)}, device="cpu")
    assert m.output_shape == (1, 7)


# --------------------------------------------------------------------------- #
# F1 and F2
# --------------------------------------------------------------------------- #

def _record_kernel_dtypes(monkeypatch):
    seen = []
    real = dnn.fused_conv2d_bias_act

    def spy(x, w, b=None, act=None, *, w_packed=None):
        seen.append((x.dtype, w.dtype, None if b is None else b.dtype))
        return real(x, w, b, act, w_packed=w_packed)
    monkeypatch.setattr(dnn, "fused_conv2d_bias_act", spy)
    return seen


def test_f1_fused_conv_takes_the_autocast_dtype(monkeypatch):
    seen = _record_kernel_dtypes(monkeypatch)
    conv = dnn.FusedConv2d(3, 4, (5, 5), act="relu")
    conv.init_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 8, 8)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = conv(x)
    assert seen == [(torch.bfloat16,) * 3] and y.dtype == torch.bfloat16
    conv(x)
    assert seen[-1] == (torch.float32,) * 3


def test_f1_bf16_image_classifier_runs_every_conv_in_bf16(monkeypatch):
    """The image enters in float32 and group_norm hands float32 on; each of
    the five convs must still see bfloat16, as the JAX package's
    PallasConv computes in the model's dtype."""
    seen = _record_kernel_dtypes(monkeypatch)
    m = DeepcvModule((32, 32, 3), _classifier_hp(), device="cpu", dtype="bfloat16")
    seen.clear()                     # shape inference ran the convs on the meta device
    m(torch.rand(2, 32, 32, 3))
    assert seen == [(torch.bfloat16,) * 3] * CONVS


def _tiny_sets(n=24, recipe=None):
    entry = {"type": "synthetic", "n": n, "image_shape": [8, 8, 3], "num_classes": 3}
    params = {"seed": 0, "split_dataset": {"validset_ratio": 0.25},
              "transforms": ["to_tensor"], "augmentation_recipe": recipe}
    return preprocess({"trainset": D.load_dataset(entry)}, params)


def _tiny_hp(**kw):
    return {"epochs": 1, "batch_size": 6, "optimizer": "adamw",
            "optimizer_opts": {"lr": 1e-3}, "save_every_iters": 0,
            "handle_preemption": False, **kw}


def _tiny_model():
    return DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 4}}, {"flatten": {}},
        {"fully_connected": {"out_features": 3}}]}, device="cpu")


@pytest.mark.parametrize("crash", [False, True])
def test_f2_deterministic_sets_cudnn_flags_for_the_run_and_restores_them(monkeypatch, crash):
    cudnn = torch.backends.cudnn
    seen = []
    real = training.train_step

    def spy(*a, **kw):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return real(*a, **kw)
    monkeypatch.setattr(training, "train_step", spy)
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    hp = _tiny_hp(deterministic=True, crash_iteration=2 if crash else -1)
    if crash:
        with pytest.raises(training.CrashIteration):
            training.train(hp, _tiny_model(), cross_entropy_loss, _tiny_sets())
    else:
        training.train(hp, _tiny_model(), cross_entropy_loss, _tiny_sets())
    assert seen and all(s == (True, False) for s in seen)
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    seen.clear()
    training.train(_tiny_hp(deterministic=False), _tiny_model(), cross_entropy_loss,
                   _tiny_sets())
    assert seen and all(s == (False, True) for s in seen)


def test_train_augments_each_step_from_a_generator_keyed_by_seed_and_step(monkeypatch):
    calls = []
    real = PreprocessedDataset.batch_transform

    def spy(self, images, generator=None, augment=True):
        calls.append((augment, None if generator is None else generator.initial_seed()))
        return real(self, images, generator, augment)
    monkeypatch.setattr(PreprocessedDataset, "batch_transform", spy)
    sets = _tiny_sets(recipe={"transforms": [{"brightness": 0.2}, {"noise": 0.1}]})
    training.train(_tiny_hp(epochs=2, seed=5), _tiny_model(), cross_entropy_loss, sets)
    train_calls = [c for c in calls if c[0]]
    assert [s for _, s in train_calls] == [training.step_generator(5, k, "cpu").initial_seed()
                                          for k in range(len(train_calls))]
    assert len(set(s for _, s in train_calls)) == len(train_calls) == 6
    assert [c for c in calls if not c[0]] == [(False, None)] * 2   # validation


# --------------------------------------------------------------------------- #
# Datasets
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name,train", [("cifar10", True), ("cifar10", False),
                                        ("mnist", False)])
def test_synthetic_stand_in_is_the_jax_packages_bit_for_bit(name, train):
    ours, ref = D._synthetic_like(name, train), JD._synthetic_like(name, train)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.targets, ref.targets)
    assert ours.images.dtype == ref.images.dtype and ours.targets.dtype == ref.targets.dtype
    assert (ours.name, ours.classes, ours.provenance) == (ref.name, ref.classes, "synthetic")


def test_cifar10_catalog_entries_load_the_tracked_arrays_like_jax():
    """The repository's data/01_raw holds the synthetic CIFAR-10 stand-ins;
    both packages load them as they are."""
    for train in (False, True):
        entry = {"type": "cifar10", "train": train, "root": os.path.join(REPO, "data/01_raw")}
        ours, ref = D.load_dataset(entry), JD.load_dataset(entry)
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.targets, ref.targets)
        assert ours.name == ref.name and ours.classes == ref.classes
        assert ours.image_shape == (32, 32, 3) and ours.num_classes == 10


def test_synthetic_fallback_generates_and_caches_like_jax(tmp_path):
    ours = D.load_dataset({"type": "fashion_mnist", "train": False, "root": tmp_path / "a"})
    ref = JD.load_dataset({"type": "fashion_mnist", "train": False, "root": tmp_path / "b"})
    np.testing.assert_array_equal(ours.images, ref.images)
    assert (tmp_path / "a" / "fashion_mnist_test_synthetic.npz").exists()
    again = D.load_dataset({"type": "fashion_mnist", "train": False, "root": tmp_path / "a"})
    np.testing.assert_array_equal(again.images, ours.images)
    assert again.provenance == "synthetic" and again.name == ours.name


def _write_cifar(root, name):
    rng = np.random.default_rng(0)
    if name == "cifar10":
        d = root / "cifar-10-batches-py"
        files, key, meta, names = ([f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"],
                                   b"labels", "batches.meta", b"label_names")
        ncls = 10
    else:
        d = root / "cifar-100-python"
        files, key, meta, names = ["train", "test"], b"fine_labels", "meta", b"fine_label_names"
        ncls = 100
    d.mkdir(parents=True)
    for f in files:
        with open(d / f, "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         key: list(rng.integers(0, ncls, 3))}, fh)
    with open(d / meta, "wb") as fh:
        pickle.dump({names: [f"c{i}".encode() for i in range(ncls)]}, fh)


def _write_idx(path, arr, gz):
    head = bytes([0, 0, 8, arr.ndim]) + b"".join(int(s).to_bytes(4, "big") for s in arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(data)


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "mnist", "fashion_mnist"])
def test_on_disk_formats_parse_and_cache_like_jax(tmp_path, name):
    if name.startswith("cifar"):
        _write_cifar(tmp_path / "src", name)
    else:
        d = tmp_path / "src" / ("MNIST" if name == "mnist" else "FashionMNIST") / "raw"
        d.mkdir(parents=True)
        rng = np.random.default_rng(1)
        for prefix, gz in (("train", False), ("t10k", True)):
            ext = ".gz" if gz else ""
            _write_idx(d / f"{prefix}-images-idx3-ubyte{ext}", rng.integers(0, 256, (4, 28, 28)), gz)
            _write_idx(d / f"{prefix}-labels-idx1-ubyte{ext}", rng.integers(0, 10, (4,)), gz)
    for train in (True, False):
        ours = D.load_dataset({"type": name, "train": train, "root": tmp_path / "src"})
        ref = JD._parse_local(name, tmp_path / "src", train)
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.targets, ref.targets)
        assert ours.classes == ref.classes and ours.provenance == "real"
        cached = D.load_dataset({"type": name, "train": train, "root": tmp_path / "src"})
        np.testing.assert_array_equal(cached.images, ours.images)
        assert cached.classes == ours.classes


# --------------------------------------------------------------------------- #
# The pipelines through run
# --------------------------------------------------------------------------- #

def test_train_image_classifier_runs_on_cpu(monkeypatch, tmp_path):
    """The slice's done criterion: one epoch at batch 1024 on the CIFAR-10
    entries of the repository's catalog, with the conf's own model."""
    monkeypatch.chdir(REPO)
    routes = dict(PreprocessedDataset.batch_transform.routes)
    store = cli_run(["--pipeline=train_image_classifier", "--device", "cpu", "--no-persist",
                     "--params",
                     "train_image_classifier.epochs:1,train_image_classifier.batch_size:1024,"
                     f"train_image_classifier.output_path:{tmp_path}"])
    h = store["train_results"]["history"]
    n_train = len(store["datasets"]["trainset"])
    assert n_train == 40000 and h["steps"] == n_train // 1024
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert h["valid"] and 0 <= h["valid"][-1]["valid_accuracy"] <= 1
    assert PreprocessedDataset.batch_transform.routes == routes     # no recipe
    assert store["model"].module.node_metas[0].creator == "nested"


def test_augment_train_takes_the_k1_route_every_step(monkeypatch, tmp_path):
    """bench.py config 1's recipe through --params (flow YAML with nested
    brackets): every training batch goes through one K1 call (its plain
    version here), validation through none."""
    monkeypatch.chdir(REPO)
    routes = dict(PreprocessedDataset.batch_transform.routes)
    recipe = ("{augmentation_ops_depth: [1, 4], transforms: [{brightness: 0.2}, "
              "{contrast: 0.1}, {tweak_colors: 0.1}, {gamma: 0.05}, {noise: 0.1}]}")
    params = [f"cifar10_preprocessing.augmentation_recipe:{recipe}",
              "cifar10_preprocessing.split_dataset.validset_ratio:0.05",
              "train_image_classifier.epochs:1", "train_image_classifier.batch_size:2048",
              "train_image_classifier.dtype:bfloat16",
              "train_image_classifier.deterministic:false",
              "train_image_classifier.scheduler:null",
              "train_image_classifier.save_every_iters:0",
              f"train_image_classifier.output_path:{tmp_path}"]
    before = fused_augment_normalize.launches
    store = cli_run(["--pipeline=train_image_classifier", "--device", "cpu", "--no-persist",
                     "--params", ",".join(params)])
    h = store["train_results"]["history"]
    assert store["datasets"]["trainset"].augmentation.steps == \
        ["brightness", "contrast", "tweak_colors", "gamma", "noise"]
    assert h["steps"] == 47500 // 2048
    assert PreprocessedDataset.batch_transform.routes == \
        {"K1": routes["K1"] + h["steps"], "eager": routes["eager"]}
    assert fused_augment_normalize.launches == before          # no card here
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()


def test_preprocess_pipelines_run_on_cpu(monkeypatch, tmp_path):
    """preprocess_cifar10 on the repository's catalog; preprocess_mnist on a
    catalog whose root is empty, so the synthetic stand-in is generated."""
    monkeypatch.chdir(REPO)
    sets = cli_run(["--pipeline=preprocess_cifar10", "--device", "cpu",
                    "--no-persist"])["datasets"]
    assert {k: len(v) for k, v in sets.items()} == \
        {"trainset": 40000, "validset": 10000, "testset": 10000}
    x = sets["validset"].batch_transform(torch.from_numpy(sets["validset"].dataset.images[:4]))
    assert tuple(x.shape) == (4, 32, 32, 3) and x.dtype == torch.float32
    root = tmp_path / "project"
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        f"mnist_{s}": {"type": "mnist", "train": s == "train", "root": str(tmp_path / "raw")}
        for s in ("train", "test")}))
    sets = cli_run(["--pipeline=preprocess_mnist", "--project-path", str(root),
                    "--device", "cpu"])["datasets"]
    assert sets["trainset"].dataset.provenance == "synthetic"
    assert (tmp_path / "raw" / "mnist_train_synthetic.npz").exists()
    x = sets["validset"].batch_transform(torch.from_numpy(sets["validset"].dataset.images[:4]))
    assert tuple(x.shape) == (4, 28, 28, 1)
    np.testing.assert_allclose(x.numpy(), (sets["validset"].dataset.images[:4] / 255.0
                                           - 0.1307) / 0.3081, atol=1e-5)

"""The port's training runtime against the JAX package: datasets and splits,
preprocessing, losses, metrics, schedules and optimizers, and the first
SGD steps of a ViT on the same batches. Then ``train_vit`` end to end
through the port's ``run`` on the CPU at a tiny size: a falling loss, the
history keys, checkpoints and an exact resume; and the refusals of what
this slice does not carry."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from deepcv_tpu.data.datasets import load_dataset as jax_load_dataset
from deepcv_tpu.data.datasets import split_dataset as jax_split
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec.zoo import vit_spec as jax_vit_spec
from deepcv_tpu.train import schedules as jsched
from deepcv_tpu.train.losses import cross_entropy_loss as jax_ce
from deepcv_tpu.train.training import build_optimizer as jax_build_optimizer
from deepcv_tpu_torch.cli import main as cli_main
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.data.datasets import load_dataset, split_dataset
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import load_jax_variables
from deepcv_tpu_torch.pipelines.classification import UNPORTED_ZOO, create_model
from deepcv_tpu_torch.serve import load_model_bundle
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import vit_spec
from deepcv_tpu_torch.train import schedules as tsched
from deepcv_tpu_torch.train.losses import WeightedLosses, cross_entropy_loss
from deepcv_tpu_torch.train.metrics import accuracy
from deepcv_tpu_torch.train.training import (
    UNPORTED_HP, TrainState, build_optimizer, epoch_permutation, train, train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: losses of the first SGD steps, port vs JAX, both f32: the gradients agree
#: to ~1e-6 relative, and three updates at lr 0.1 keep the losses within
STEP_LOSS_RTOL = 1e-4


def _tiny_vit(spec_fn, attn_impl="flash", num_classes=5, hidden=32, heads=4, mlp=64,
              patch=8, layers=2):
    hp = spec_fn(variant="b_16", num_classes=num_classes, attn_impl=attn_impl)
    arch = [hp["architecture"][0]] + hp["architecture"][1:1 + layers] \
        + hp["architecture"][-3:]
    arch[0]["patch_embed"][1].update(patch_size=patch, embed_dim=hidden)
    for row in arch[1:1 + layers]:
        row["transformer_block"][1].update(num_heads=heads, mlp_dim=mlp)
    hp["architecture"] = arch
    return hp


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #

def test_synthetic_catalog_entry_and_split_are_the_jax_ones():
    entry = {"type": "synthetic", "n": 40, "image_shape": [8, 8, 3], "num_classes": 7}
    for train_flag in (True, False):
        a = load_dataset(dict(entry, train=train_flag))
        b = jax_load_dataset(dict(entry, train=train_flag))
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.targets, b.targets)
        assert a.classes == b.classes and a.provenance == "synthetic"
    tr, te = load_dataset(entry), load_dataset(dict(entry, train=False))
    ours = split_dataset(tr, te, validset_ratio=0.2, seed=3)
    theirs = jax_split(jax_load_dataset(entry), jax_load_dataset(dict(entry, train=False)),
                       validset_ratio=0.2, seed=3)
    assert set(ours) == set(theirs) == {"trainset", "validset", "testset"}
    for k in ours:
        np.testing.assert_array_equal(ours[k].images, theirs[k].images)
        np.testing.assert_array_equal(ours[k].targets, theirs[k].targets)
    with pytest.raises(FileNotFoundError, match="image_folder root not found"):
        load_dataset({"type": "image_folder", "root": "no/such/dir"})


def test_preprocess_matches_jax(tmp_path):
    from deepcv_tpu.data.preprocess import preprocess as jax_preprocess

    entry = {"type": "synthetic", "n": 30, "image_shape": [6, 6, 3], "num_classes": 4}
    params = {"seed": 0, "split_dataset": {"validset_ratio": 0.1},
              "transforms": ["to_tensor", "normalize"]}
    ours = preprocess({"trainset": load_dataset(entry)}, params)
    theirs = jax_preprocess({"trainset": jax_load_dataset(entry)}, params,
                            cache_dir=tmp_path)
    for k in ("trainset", "validset"):
        x = ours[k].dataset.images[:5]
        got = ours[k].batch_transform(torch.from_numpy(x)).numpy()
        ref = np.asarray(theirs[k].batch_transform(jnp.asarray(x), augment=False))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    augmented = preprocess({"trainset": load_dataset(entry)},
                           dict(params, augmentation_recipe={"transforms": [{"posterize": 0.05}]}))
    assert augmented["trainset"].augmentation.steps == ["posterize"]
    assert augmented["validset"].augmentation is None
    with_targets = preprocess({"trainset": load_dataset(entry)},
                              dict(params, target_transforms=["to_tensor"]))
    y = torch.full((3,), 255, dtype=torch.uint8)
    assert torch.equal(with_targets["trainset"].transform_targets(y), torch.ones(3))
    assert torch.equal(ours["trainset"].transform_targets(y), y)
    for prep, load in ((preprocess, load_dataset), (jax_preprocess, jax_load_dataset)):
        with pytest.raises(ValueError, match="no_such_transform"):
            prep({"trainset": load(entry)}, dict(params, transforms=["no_such_transform"]))


# --------------------------------------------------------------------------- #
# Losses, metrics, schedules, optimizers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_and_accuracy_match_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(9, 6)).astype(np.float32)
    labels = rng.integers(-1, 6, size=(9,)).astype(np.int64)   # -1 rows ignored
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    onehot = np.eye(6, dtype=np.float32)[np.clip(labels, 0, 5)]
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(onehot), smoothing)
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(onehot), smoothing)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    assert accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).item() == \
        pytest.approx(float(np.mean(logits.argmax(-1) == labels)))
    main, terms = WeightedLosses(cross_entropy_loss)(torch.from_numpy(logits),
                                                      torch.from_numpy(labels))
    assert set(terms) == {"loss", "main_loss"} and torch.equal(main, terms["loss"])


def test_schedules_match_jax():
    pts = [[0, 0.0], [10, 0.5], [30, 0.05]]
    ours, theirs = tsched.piecewise_linear(pts), jsched.piecewise_linear(pts)
    for c in (0, 3, 10, 17, 30, 45):
        assert ours(c) == pytest.approx(float(theirs(c)), rel=1e-6)
    (olr, omom), (jlr, jmom) = tsched.one_cycle(0.4, 50), jsched.one_cycle(0.4, 50)
    for c in (0, 7, 15, 16, 33, 50, 60):
        assert olr(c) == pytest.approx(float(jlr(c)), rel=1e-5, abs=1e-9)
        assert omom(c) == pytest.approx(float(jmom(c)), rel=1e-5)
    assert tsched.build_schedules(None, {}, 10) == {}
    spec = {"type": "piecewise_linear", "eval_args": ["milestones_values"],
            "kwargs": {"milestones_values":
                       "[[0, 0.0], [int(0.5 * hp['epochs'] * iterations), "
                       "hp['optimizer_opts']['lr']], [hp['epochs'] * iterations, 0.0]]"}}
    hp = {"epochs": 4, "optimizer_opts": {"lr": 0.2}}
    o, j = tsched.build_schedules(spec, hp, 5), jsched.build_schedules(spec, hp, 5)
    assert set(o) == set(j) == {"lr"}
    for c in range(0, 22, 3):
        assert o["lr"](c) == pytest.approx(float(j["lr"](c)), rel=1e-6, abs=1e-9)
    assert set(tsched.build_schedules("one_cycle", {"epochs": 2, "optimizer_opts": {"lr": 1}},
                                      5)) == {"lr", "momentum"}
    cos = {"type": "cosine", "kwargs": {"init_value": 0.2, "decay_steps": 12, "alpha": 0.1}}
    o, j = tsched.build_schedules(cos, hp, 5), jsched.build_schedules(cos, hp, 5)
    for c in range(0, 16, 3):
        assert o["lr"](c) == pytest.approx(float(j["lr"](c)), rel=1e-6, abs=1e-9)
    with pytest.raises(ValueError, match="Disallowed"):
        tsched.safe_eval_milestones("[i for i in hp]", {"hp": []})


@pytest.mark.parametrize("name,opts", [
    ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-2, "nesterov": True}),
    ("sgd", {"lr": 0.05}),
    ("adamw", {"lr": 1e-2, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 1e-2}),
    ("adam", {"lr": 1e-2}),
    ("rmsprop", {"lr": 0.1}), ("lamb", {"lr": 0.1}), ("lars", {"lr": 0.1}),
    ("adafactor", {"lr": 0.1}), ("lion", {"lr": 0.1}), ("muon", {"lr": 0.1}),
    ("schedule_free_adamw", {"lr": 0.1})])
def test_optimizers_step_like_jax(name, opts):
    rng = np.random.default_rng(9)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    tx = jax_build_optimizer(name, opts)
    p = jnp.asarray(w0)
    st = tx.init(p)
    for g in grads:
        u, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, u)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    # named 'w', not '*.weight': a 2-d parameter in the JAX (in, out) layout
    opt = build_optimizer(name, opts, [("w", tw)])
    for g in grads:
        tw.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(p), rtol=1e-5, atol=1e-6)


def test_scheduled_sgd_momentum_follows_one_cycle():
    w = torch.nn.Parameter(torch.zeros(3))
    lr, mom = tsched.one_cycle(0.3, 10)
    opt = build_optimizer("sgd", {"lr": 0.3, "momentum": 0.9}, [w], {"lr": lr, "momentum": mom})
    assert opt.param_groups[0]["lr"] == pytest.approx(lr(0))
    assert opt.param_groups[0]["momentum"] == pytest.approx(mom(0))


def test_first_sgd_steps_track_jax():
    """train_step on the same three batches from the same weights: the
    losses track the JAX package's optax SGD steps (f32, flash attention's
    plain backward)."""
    hp_j = _tiny_vit(jax_vit_spec)
    jm = JaxModule((16, 16, 3), hp_j)
    jv = jm.init(jax.random.PRNGKey(4))
    tm = DeepcvModule((16, 16, 3), _tiny_vit(vit_spec), device="cpu")
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, jv))
    opts = {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}
    rng = np.random.default_rng(5)
    batches = [(rng.random((6, 16, 16, 3), dtype=np.float32),
                rng.integers(0, 5, size=(6,))) for _ in range(3)]

    tx = jax_build_optimizer("sgd", opts)
    params, st = jv["params"], tx.init(jv["params"])
    jax_losses = []
    for x, y in batches:
        loss, g = jax.value_and_grad(
            lambda p: jax_ce(jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y)))(params)
        u, st = tx.update(g, st, params)
        params = optax.apply_updates(params, u)
        jax_losses.append(float(loss))

    state = TrainState(tm, build_optimizer("sgd", opts, tm.parameters()), 0,
                       torch.Generator().manual_seed(0))
    tm.train()
    ours = [train_step(state, WeightedLosses(cross_entropy_loss), {"accuracy": accuracy},
                       torch.from_numpy(x), torch.from_numpy(y))["main_loss"].item()
            for x, y in batches]
    assert state.step == 3
    assert len(set(ours)) == 3
    np.testing.assert_allclose(ours, jax_losses, rtol=STEP_LOSS_RTOL)


def test_epoch_permutation_is_keyed_by_seed_and_epoch():
    a = epoch_permutation(3, 1, 50)
    assert torch.equal(a, epoch_permutation(3, 1, 50))
    assert sorted(a.tolist()) == list(range(50))
    assert not torch.equal(a, epoch_permutation(3, 2, 50))
    assert not torch.equal(a, epoch_permutation(4, 1, 50))


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #

def _tiny_datasets():
    entry = {"type": "synthetic", "n": 20, "image_shape": [16, 16, 3], "num_classes": 5}
    return preprocess({"trainset": load_dataset(entry)},
                      {"seed": 0, "split_dataset": {"validset_ratio": 0.2},
                       "transforms": ["to_tensor"]})


_ON = {"nni_compression": {"sparsity": 0.5},
       "max_epochs_per_dispatch": 2, "sync_every_dispatches": 2, "runtime_lr": True,
       "flatten_optimizer": True, "flat_params": True,
       "train_arch_params": False, "backend_conf": {"n_devices": 2}}


@pytest.mark.parametrize("key", sorted(UNPORTED_HP) + ["backend_conf"])
def test_unported_hp_keys_raise_naming_the_key(key, tmp_path):
    model = DeepcvModule((16, 16, 3), _tiny_vit(vit_spec), device="cpu")
    hp = {"epochs": 1, "batch_size": 4, "optimizer": "sgd", "optimizer_opts": {"lr": 0.1},
          "output_path": str(tmp_path), key: _ON[key]}
    with pytest.raises(NotImplementedError, match=f"hp '{key}'"):
        train(hp, model, cross_entropy_loss, _tiny_datasets())


@pytest.mark.parametrize("zoo", ("swin", "lenet"))
def test_unported_zoo_builders_raise(zoo):
    """No zoo builder is left unported, and an unknown one raises. Swin is
    built now: on these 16x16 images its fourth stage would merge a 1x1 map,
    which the port refuses as the JAX package does."""
    assert UNPORTED_ZOO == ()
    match = "feature map 1x1 not divisible by 2" if zoo == "swin" else zoo
    with pytest.raises(ValueError, match=match):
        create_model(_tiny_datasets(), {"zoo": zoo}, device="cpu")


# --------------------------------------------------------------------------- #
# train_vit end to end through `run`, on the CPU
# --------------------------------------------------------------------------- #

def _write_project(root, model_dtype):
    """conf/base linked to the repo's; conf/local shrinking the imagenet224
    catalog entries to 17 + 8 images of 32x32 (16 to train, one to validate)
    and ViT-B/16 to a two-block, 32-wide spec of the same topology (attn_impl
    flash) computing in ``model_dtype``."""
    (root / "conf").mkdir()
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    local = root / "conf" / "local"
    local.mkdir()
    shape = [32, 32, 3]
    (local / "catalog.yml").write_text(yaml.safe_dump({
        "imagenet224_train": {"type": "synthetic", "n": 17, "image_shape": shape,
                              "num_classes": 3},
        "imagenet224_test": {"type": "synthetic", "train": False, "n": 8,
                             "image_shape": shape, "num_classes": 3}}))
    arch = _tiny_vit(vit_spec, hidden=32, heads=2, mlp=64, patch=8)["architecture"]
    arch[-1]["fully_connected"]["out_features"] = None
    (local / "parameters.yml").write_text(yaml.safe_dump({
        "vit_model": {"zoo": "vit", "variant": "b_16", "attn_impl": "flash",
                      "dtype": model_dtype, "architecture": arch}}))
    return root


@pytest.fixture(scope="module")
def tiny_project(tmp_path_factory):
    """A project whose conf is the repo's, shrunk by :func:`_write_project`,
    the model in float32."""
    return _write_project(tmp_path_factory.mktemp("project"), "float32")


@pytest.fixture(scope="module")
def bf16_project(tmp_path_factory):
    """The same, with the repo conf's compute dtypes: bfloat16 for the model
    (as ``vit_model`` in conf/base) and for training (``train_resnet50`` in
    conf/base, not overridden)."""
    return _write_project(tmp_path_factory.mktemp("project_bf16"), "bfloat16")


def _run_args(root, out, *extra):
    params = ",".join([f"train_resnet50.output_path:{out}", "train_resnet50.batch_size:8",
                       "train_resnet50.epochs:15", "train_resnet50.save_every_iters:10",
                       "train_resnet50.log_progress_every_iters:1",
                       "train_resnet50.dtype:float32", "train_resnet50.run_dir:run",
                       "train_resnet50.optimizer_opts.lr:0.003", *extra])
    return ["--pipeline=train_vit", "--project-path", str(root), "--device", "cpu",
            "--params", params]


def test_train_vit_runs_end_to_end_on_cpu(tiny_project, tmp_path, capsys):
    assert cli_main(["run", *_run_args(tiny_project, tmp_path / "a"),
                     "--export", str(tmp_path / "bundle")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["pipeline"] == "train_vit" and summary["steps"] == 30
    store = cli_run(_run_args(tiny_project, tmp_path / "b"))
    h = store["train_results"]["history"]
    assert {"train", "valid", "throughput_img_s", "run_dir", "total_time_s", "steps",
            "output_path"} <= set(h)
    assert h["steps"] == 30 and len(h["throughput_img_s"]) == 15
    assert [v["epoch"] for v in h["valid"]] == list(range(1, 16))
    assert {"valid_loss", "valid_main_loss", "valid_accuracy"} <= set(h["valid"][-1])
    assert {"loss", "main_loss", "grad_norm", "accuracy"} <= set(h["train"][0])
    losses = [e["main_loss"] for e in h["train"]]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < 0.9 * np.mean(losses[:6])
    ckpts = tmp_path / "b" / "run" / "checkpoints"
    assert sorted(p.name for p in (ckpts / "steps").iterdir()) == ["10.pt", "20.pt", "30.pt"]
    assert json.loads((ckpts / "best" / "index.json").read_text())
    assert store["model"].device.type == "cpu"
    assert store["train_results"]["model"].dtype is None
    served = load_model_bundle(tmp_path / "bundle", device="cpu")
    assert served.capacity() == store["model"].capacity()


def test_resume_reproduces_the_uninterrupted_run_exactly(tiny_project, tmp_path):
    full = cli_run(_run_args(tiny_project, tmp_path / "full"))
    h_full = full["train_results"]["history"]
    ckpt = tmp_path / "full" / "run" / "checkpoints" / "steps" / "20.pt"
    resumed = cli_run(_run_args(tiny_project, tmp_path / "resumed",
                                f"train_resnet50.resume_from:{ckpt}"))
    h_res = resumed["train_results"]["history"]
    assert [e["step"] for e in h_res["train"]] == list(range(21, 31))
    assert [e["main_loss"] for e in h_res["train"]] == \
        [e["main_loss"] for e in h_full["train"][20:]]
    a = full["train_results"]["model"].state_dict()
    b = resumed["train_results"]["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_crash_then_resume_from_the_run_directory(tiny_project, tmp_path):
    from deepcv_tpu_torch.train.training import CrashIteration

    with pytest.raises(CrashIteration):
        cli_run(_run_args(tiny_project, tmp_path, "train_resnet50.crash_iteration:12"))
    ckpts = tmp_path / "run" / "checkpoints"
    store = cli_run(_run_args(tiny_project, tmp_path, f"train_resnet50.resume_from:{ckpts}"))
    h = store["train_results"]["history"]
    assert h["steps"] == 30 and h["train"][0]["step"] == 11


def test_preemption_checkpoints_and_resumes(tiny_project, tmp_path):
    from deepcv_tpu_torch.train.training import Preempted, request_preemption

    request_preemption()
    with pytest.raises(Preempted, match="step 0"):
        cli_run(_run_args(tiny_project, tmp_path))
    ckpts = tmp_path / "run" / "checkpoints"
    assert [p.name for p in (ckpts / "steps").iterdir()] == ["0.pt"]
    store = cli_run(_run_args(tiny_project, tmp_path, f"train_resnet50.resume_from:{ckpts}"))
    assert store["train_results"]["history"]["steps"] == 30


def test_cli_reports_config_errors_with_exit_code_2(tiny_project, tmp_path, capsys):
    args = _run_args(tiny_project, tmp_path)
    assert cli_main(["run", *args[:-1], "bogus_entry"]) == 2
    assert "must be 'dotted.key:value'" in capsys.readouterr().err
    assert cli_main(["run", *args[:-1], args[-1] + ",vit_model.architecture:null"]) == 2
    assert "architecture" in capsys.readouterr().err


#: chip_smoke.py's vit_train_f32 overrides: train_vit in float32
F32_TRAIN_OVERRIDES = ("vit_model.dtype:float32", "train_resnet50.dtype:float32")


@pytest.mark.parametrize("dtype,overrides", [("bfloat16", ()), ("float32", F32_TRAIN_OVERRIDES)])
def test_train_vit_dtype_overrides_set_the_flash_kernels_dtype(bf16_project, tmp_path,
                                                               monkeypatch, dtype, overrides):
    """Over a conf that says bfloat16 (as conf/base does), the float32
    overrides make train_vit compute in float32 with no autocast: the model's
    compute dtype is None and every flash call (K3 per block per forward, K4
    and K5 per block per step) takes float32 operands, the f32 routes;
    without them every call takes bfloat16 ones. On the CPU the calls take
    the plain versions and count no kernel launch."""
    from deepcv_tpu_torch.ops import attention as tatt
    from deepcv_tpu_torch.ops.kernels import flash_attention as kfa

    seen = []
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        def spy(q, *args, _fn=getattr(tatt, name), _name=name):
            if q.device.type != "meta":   # not the shape inference of the model's build
                seen.append((_name, str(q.dtype).removeprefix("torch.")))
            return _fn(q, *args)
        monkeypatch.setattr(tatt, name, spy)
    wrappers = (kfa.flash_attention_fwd, kfa.flash_attention_bwd_dq, kfa.flash_attention_bwd_dkv)
    before = [(w.launches, dict(w.launches_by_dtype)) for w in wrappers]
    params = ",".join([f"train_resnet50.output_path:{tmp_path}", "train_resnet50.batch_size:8",
                       "train_resnet50.epochs:1", "train_resnet50.save_every_iters:0",
                       "train_resnet50.run_dir:run", *overrides])
    store = cli_run(["--pipeline=train_vit", "--project-path", str(bf16_project),
                     "--device", "cpu", "--params", params])
    h = store["train_results"]["history"]
    assert h["steps"] == 2 and len(h["valid"]) == 1
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert store["train_results"]["model"].dtype == (None if dtype == "float32"
                                                     else torch.bfloat16)
    # two blocks: K3 per step and per validation forward, K4 and K5 per step
    counts = {name: sum(1 for n, _ in seen if n == name) for name, _ in seen}
    assert counts == {"flash_attention_fwd": 2 * 3, "flash_attention_bwd_dq": 2 * 2,
                      "flash_attention_bwd_dkv": 2 * 2}
    assert {d for _, d in seen} == {dtype}
    assert [(w.launches, dict(w.launches_by_dtype)) for w in wrappers] == before


def test_jax_package_reads_the_same_dtype_key_for_the_vit():
    """The JAX package's create_model takes the ViT's compute dtype from the
    same ``vit_model.dtype`` key: float32 with the override, bfloat16 as
    conf/base has it (its training reads ``train_resnet50.dtype``, the key
    the port's ``train()`` reads)."""
    import types

    from deepcv_tpu.pipelines.classification import create_model as jax_create_model

    datasets = {"trainset": types.SimpleNamespace(image_shape=(32, 32, 3), num_classes=5)}
    params = {"zoo": "vit", "variant": "b_16", "attn_impl": "flash"}
    for dtype in ("float32", "bfloat16"):
        jm = jax_create_model(datasets, {**params, "dtype": dtype})
        tm = create_model(_tiny_datasets(), {**params, "dtype": dtype}, device="cpu")
        assert jm.dtype == jnp.dtype(dtype)
        assert tm.dtype == (None if dtype == "float32" else torch.bfloat16)


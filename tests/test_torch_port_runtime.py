"""The port's training runtime against the JAX package, on the CPU at tiny
sizes: the seven optimizers written from optax's rules (on the port's
layouts, at a factoring shape, scheduled, the schedule-free evaluation
point), the four schedules, the clip, the parameter paths that
``freeze_params`` and ``lr_scales`` match, whole ``train()`` runs with the
update chain, ``remat``, the streaming input path (``BatchIterator``'s
batches, ``train()`` on it, exact resume), UDA's terms, the dataset
loaders and converters, the two losses, the loggers and the tracker, the
backend, and the pipelines' partial runs from the intermediate cache."""
import contextlib
import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from deepcv_tpu.data import datasets as jds
from deepcv_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from deepcv_tpu.data.preprocess import preprocess as jax_preprocess
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.train import loggers as jlog
from deepcv_tpu.train.backend import BackendConfig as JaxBackendConfig
from deepcv_tpu.train import schedules as jsched
from deepcv_tpu.train.losses import cross_entropy_loss as jax_ce
from deepcv_tpu.train.losses import label_smoothing_xentropy_loss as jax_ls
from deepcv_tpu.train.losses import triplet_margin_loss as jax_triplet
from deepcv_tpu.train.training import build_optimizer as jax_build_optimizer
from deepcv_tpu.train.training import train as jax_train
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.data import datasets as tds
from deepcv_tpu_torch.data.pipeline import BatchIterator, DeviceDataset, prefetch_to_device
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import jax_param_paths, jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train import loggers as tlog
from deepcv_tpu_torch.train import schedules as tsched
from deepcv_tpu_torch.train.backend import BackendConfig
from deepcv_tpu_torch.train.losses import (LOSS_FNS, cross_entropy_loss,
                                           label_smoothing_xentropy_loss, triplet_margin_loss)
from deepcv_tpu_torch.train.optimizers import build_optimizer, clip_by_global_norm
from deepcv_tpu_torch.train.training import (CrashIteration, TrainingEvents, remat_forward,
                                             train, train_with_retries, uda_terms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: optimizer updates, port vs optax: the existing optimizer tests' bound
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
#: whole train() runs, f32: parameters and losses against the JAX package's
PARAM_ATOL, LOSS_RTOL = 1e-4, 1e-5

# --------------------------------------------------------------------------- #
# Optimizers on the port's layouts
# --------------------------------------------------------------------------- #

#: parameter shapes in the JAX layout: a dense kernel (in, out) at a shape
#: adafactor factors, a conv kernel HWIO, a bias, a small dense kernel
SHAPES = {"fc": (128, 130), "conv": (3, 3, 4, 6), "b": (6,), "head": (5, 3)}


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return a.T.copy()
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1).copy()
    return a.copy()


def _run_both(name, opts, steps=4, jax_tx=None, schedules=None, seed=0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    tx = jax_tx or jax_build_optimizer(name, opts)
    p = jax.tree.map(jnp.asarray, p0)
    st = tx.init(p)
    for g in grads:
        u, st = tx.update(jax.tree.map(jnp.asarray, g), st, p)
        p = optax.apply_updates(p, u)
    tp = {k: torch.nn.Parameter(torch.from_numpy(_to_torch_layout(v))) for k, v in p0.items()}
    named = [(f"{k}.weight" if v.dim() > 1 else f"{k}.bias", v) for k, v in tp.items()]
    opt = build_optimizer(name, opts, named, schedules)
    from deepcv_tpu_torch.train.optimizers import apply_schedules
    for i, g in enumerate(grads):
        for k in tp:
            tp[k].grad = torch.from_numpy(_to_torch_layout(g[k]))
        apply_schedules(opt, schedules or {}, i)
        opt.step()
    return tp, {k: _to_torch_layout(np.asarray(v)) for k, v in p.items()}, opt, st


@pytest.mark.parametrize("name,opts", [
    ("rmsprop", {"lr": 0.01, "momentum": 0.9, "alpha": 0.9}),
    ("lamb", {"lr": 0.01, "weight_decay": 0.01}),
    ("lars", {"lr": 0.1, "weight_decay": 1e-3, "nesterov": True}),
    ("adafactor", {"lr": 0.01}),
    ("adafactor", {"lr": 0.01, "weight_decay": 0.01, "momentum": 0.9}),
    ("lion", {"lr": 0.001, "weight_decay": 0.1}),
    ("muon", {"lr": 0.02, "weight_decay": 0.01}),
    ("muon", {"lr": 0.02, "nesterov": False, "adam_weight_decay": 0.1}),
    ("schedule_free_adamw", {"lr": 0.01, "warmup_steps": 2, "weight_decay": 0.01})])
def test_optimizers_on_port_layouts_match_optax(name, opts):
    """Linear weights as (out, in), conv kernels as OIHW: each update equals
    optax's on the JAX layout (muon's out/in factor, adafactor's factored
    moments at 128x130)."""
    tp, ref, _, _ = _run_both(name, opts)
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), ref[k], rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["lamb", "lion"])
def test_scheduled_momentum_and_weight_decay_match_jax(name):
    """lamb and lion with beta1 and weight decay on schedules (the JAX
    package's inject_hyperparams path)."""
    mom = tsched.piecewise_linear([[0, 0.85], [3, 0.95]])
    wd = tsched.piecewise_linear([[0, 0.0], [3, 0.1]])
    jtx = jax_build_optimizer(name, {"lr": 0.01}, None,
                              extra_schedules={"momentum": jsched.piecewise_linear(
                                  [[0, 0.85], [3, 0.95]]),
                                  "weight_decay": jsched.piecewise_linear([[0, 0.0], [3, 0.1]])})
    tp, ref, _, _ = _run_both(name, {"lr": 0.01}, jax_tx=jtx,
                              schedules={"momentum": mom, "weight_decay": wd})
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), ref[k], rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=k)
    with pytest.raises(ValueError, match="momentum/weight_decay schedules"):
        build_optimizer("rmsprop", {"lr": 0.1}, [torch.nn.Parameter(torch.zeros(2))],
                        {"momentum": mom})


def test_schedule_free_evaluation_point_matches_jax():
    from optax.contrib import schedule_free_eval_params

    tp, _, opt, st = _run_both("schedule_free_adamw", {"lr": 0.02, "weight_decay": 0.01})
    ev = opt.eval_params()
    tx = jax_build_optimizer("schedule_free_adamw", {"lr": 0.02, "weight_decay": 0.01})
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(4)]
    p, s = jax.tree.map(jnp.asarray, p0), None
    s = tx.init(p)
    for g in grads:
        u, s = tx.update(jax.tree.map(jnp.asarray, g), s, p)
        p = optax.apply_updates(p, u)
    ref = schedule_free_eval_params(s, p)
    for k in tp:
        np.testing.assert_allclose(ev[tp[k]].numpy(), _to_torch_layout(np.asarray(ref[k])),
                                   rtol=OPT_RTOL, atol=OPT_ATOL)
    with pytest.raises(ValueError, match="replaces the LR schedule"):
        build_optimizer("schedule_free_adamw", {"lr": 0.1}, [torch.nn.Parameter(torch.zeros(2))],
                        {"lr": tsched.constant(0.1)})


def test_optimizer_factory_and_unknown_name():
    seen = {}

    def factory(opts, params, lr_schedule):
        seen["args"] = (dict(opts), lr_schedule)
        return torch.optim.SGD(params, lr=opts["lr"])

    w = torch.nn.Parameter(torch.zeros(3))
    opt = build_optimizer(factory, {"lr": 0.5}, [w])
    assert isinstance(opt, torch.optim.SGD) and seen["args"] == ({"lr": 0.5}, None)
    with pytest.raises(ValueError, match="cannot combine with a custom optimizer factory"):
        build_optimizer(factory, {"lr": 0.5}, [w], {"momentum": tsched.constant(0.9)})
    with pytest.raises(ValueError, match="Unknown optimizer 'nadam'"):
        build_optimizer("nadam", {"lr": 0.5}, [w])


# --------------------------------------------------------------------------- #
# Schedules and the clip
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("spec", [
    {"type": "constant", "kwargs": {"value": 0.3}},
    {"type": "cosine", "kwargs": {"init_value": 0.5, "decay_steps": 20, "alpha": 0.05}},
    {"type": "warmup_cosine", "kwargs": {"peak_value": 0.4, "warmup_steps": 5,
                                         "decay_steps": 25, "init_value": 0.01}},
    {"type": "exponential", "kwargs": {"init_value": 0.2, "transition_steps": 4,
                                       "decay_rate": 0.5}}])
def test_schedules_match_optax(spec):
    o, j = tsched.build_schedules(spec, {}, 10), jsched.build_schedules(spec, {}, 10)
    for c in (0, 1, 4, 5, 6, 13, 25, 40):
        assert o["lr"](c) == pytest.approx(float(j["lr"](c)), rel=1e-5, abs=1e-9), c   # optax: f32


@pytest.mark.parametrize("max_norm", [100.0, 0.5])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in gs], None)
    ts = [torch.from_numpy(g.copy()) for g in gs]
    norm = clip_by_global_norm(ts, max_norm)
    assert float(norm) == pytest.approx(float(optax.global_norm(gs)), rel=1e-6)
    for t, r, g in zip(ts, ref, gs):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
        if max_norm == 100.0:
            assert np.array_equal(t.numpy(), g)   # below the bound: untouched


# --------------------------------------------------------------------------- #
# Parameter paths
# --------------------------------------------------------------------------- #

def _conf_model(key):
    from deepcv_tpu_torch.config import load_yaml

    hp = copy.deepcopy(load_yaml(os.path.join(REPO, "conf", "base", "parameters.yml"))[key])
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    return hp


def _zoo(name):
    from deepcv_tpu.spec import zoo as jz

    return {"vit": lambda: jz.vit_spec(variant="b_16", num_classes=10),
            "resnet18": lambda: jz.resnet_spec(18, num_classes=10, pool_kernel=1),
            "swin": lambda: jz.swin_spec("t", num_classes=5, window=4, pool_kernel=1)}[name]()


@pytest.mark.parametrize("model", ["image_classifier_model", "wide_classifier_ws_model",
                                   "vit", "resnet18", "swin"])
def test_param_paths_equal_the_jax_trees(model):
    hp = _conf_model(model) if model.endswith("_model") else _zoo(model)
    v = jax.eval_shape(lambda: JaxModule((32, 32, 3), copy.deepcopy(hp)).init(
        jax.random.PRNGKey(0)))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path)
           for path, _ in jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    paths = jax_param_paths(DeepcvModule((32, 32, 3), copy.deepcopy(hp), device="meta"))
    assert set(paths.values()) == ref


# --------------------------------------------------------------------------- #
# Whole train() runs against the JAX package's
# --------------------------------------------------------------------------- #

#: image_classifier's layers at a tiny size: conv + BN + leaky_relu, pool, head
TINY_HP = {"act_fn": "leaky_relu", "dropout_prob": 0.0,
           "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
           "architecture": [{"conv2d": {"kernel_size": [3, 3], "out_channels": 4, "padding": 1}},
                            {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
                            {"flatten": {}},
                            {"fully_connected": {"out_features": 3, "act_fn": None,
                                                 "batch_norm": None}}]}
PP = {"seed": 0, "split_dataset": {"validset_ratio": 0.2}, "transforms": ["to_tensor"]}


def _data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8),
            rng.integers(0, 3, n).astype(np.int64))


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny classifier in both packages from the same JAX init, and the
    two packages' preprocessed splits of the same 20 images (16 to train)."""
    x, y = _data()
    jd = jax_preprocess({"trainset": jds.ArrayDataset(x, y, classes=list("abc"))}, PP)
    td = preprocess({"trainset": tds.ArrayDataset(x, y, classes=list("abc"))}, PP)
    jm = JaxModule((8, 8, 3), copy.deepcopy(TINY_HP))
    v = jm.init(jax.random.PRNGKey(0))
    return jm, v, jd, td


def _torch_model(v):
    tm = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
    return load_jax_variables(tm, jax.tree.map(np.asarray, v))


def _hp(tmp_path, **extra):
    return {"epochs": 4, "batch_size": 16, "optimizer": "adamw",
            "optimizer_opts": {"lr": 0.05}, "save_every_iters": 0,
            "log_progress_every_iters": 1, "seed": 1, "output_path": str(tmp_path),
            "handle_preemption": False, **extra}


def _assert_same_run(jres, tres, tm, ema=False):
    (js, jh), (ts, th) = jres, tres
    np.testing.assert_allclose([e["main_loss"] for e in th["train"]],
                               [e["main_loss"] for e in jh["train"]], rtol=LOSS_RTOL)
    assert [e["step"] for e in th["train"]] == [e["step"] for e in jh["train"]]
    ref = jax_to_torch_state_dict(jax.tree.map(np.asarray, js.variables(ema=ema)), tm)
    got = tm.state_dict() if not ema else {**tm.state_dict(), **ts.ema}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL, err_msg=k)
    assert th["valid"][-1]["valid_loss"] == pytest.approx(jh["valid"][-1]["valid_loss"],
                                                          rel=LOSS_RTOL)


@pytest.mark.parametrize("extra", [
    {"gradient_clip_norm": 0.5},
    {"freeze_params": "submodule_0", "lr_scales": {"fully_connected": 0.5, ".*": 0.1}},
    {"grad_accumulation_steps": 2,
     "scheduler": {"type": "cosine", "kwargs": {"init_value": 0.05, "decay_steps": 2}}},
    {"ema_decay": 0.9}], ids=["clip", "freeze_lr_scales", "accumulation", "ema"])
def test_train_with_the_update_chain_matches_jax(tiny_pair, tmp_path, extra):
    """One batch holds the whole trainset, so the shuffles cannot change a
    step: losses, parameters, BN statistics and validation (at the EMA
    with ema_eval) against the JAX package's train()."""
    jm, v, jd, td = tiny_pair
    hp = _hp(tmp_path, device_resident_dataset=True, **extra)
    jres = jax_train(hp, jm, jax_ce, jd, init_variables=v)
    tm = _torch_model(v)
    tres = train(hp, tm, cross_entropy_loss, td)
    _assert_same_run(jres, tres, tm, ema="ema_decay" in extra)
    if "freeze_params" in extra:
        frozen = [k for k in tm.state_dict() if "_submodule_0_" in k and "running" not in k
                  and "num_batches" not in k]
        init = _torch_model(v).state_dict()
        assert frozen and all(torch.equal(tm.state_dict()[k], init[k]) for k in frozen)


def test_streaming_train_matches_jax_streaming_train(tiny_pair, tmp_path):
    """device_resident_dataset: false on both sides (the JAX package's numpy
    BatchIterator: native_loader false): 2 epochs of 4 batches of 4."""
    jm, v, jd, td = tiny_pair
    hp = _hp(tmp_path, epochs=2, batch_size=4, device_resident_dataset=False,
             native_loader=False, optimizer="sgd",
             optimizer_opts={"lr": 0.05, "momentum": 0.9})
    jres = jax_train(hp, jm, jax_ce, jd, init_variables=v,
                     backend_conf=JaxBackendConfig(n_devices=1))
    tm = _torch_model(v)
    tres = train(hp, tm, cross_entropy_loss, td)
    assert tres[1]["input_path"] == "streaming" and tres[1]["steps"] == 8
    _assert_same_run(jres, tres, tm)


def _memmap_splits(tmp_path, n=40):
    x, y = _data(n, seed=2)
    np.save(tmp_path / "images.npy", x)
    np.save(tmp_path / "targets.npy", y)
    raw = tds.load_dataset({"type": "memmap", "root": str(tmp_path)})
    assert isinstance(raw.images, np.memmap)
    return preprocess({"trainset": raw}, PP)


@pytest.mark.parametrize("accum", [1, 2])
def test_streaming_resume_is_exact(tmp_path, accum):
    """auto picks streaming for a memmap; a crash at step 3 (in the middle
    of an accumulation when accum is 2) resumed from its checkpoint ends
    where the uninterrupted run ends."""
    data = _memmap_splits(tmp_path)
    hp = _hp(tmp_path, epochs=2, batch_size=8, save_every_iters=1, run_dir="full",
             grad_accumulation_steps=accum, optimizer="lamb", optimizer_opts={"lr": 0.01})
    init = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu").state_dict()
    full_model = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
    _, h_full = train(hp, full_model, cross_entropy_loss, data, init_variables=init)
    assert h_full["input_path"] == "streaming" and h_full["steps"] == 8
    model = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
    with pytest.raises(CrashIteration):
        train(dict(hp, run_dir="cut", crash_iteration=3), model, cross_entropy_loss, data,
              init_variables=init)
    ckpt = tmp_path / "cut" / "checkpoints"
    model = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
    _, h = train(dict(hp, run_dir="cut", resume_from=str(ckpt)), model, cross_entropy_loss,
                 data)
    assert [e["main_loss"] for e in h["train"]] == [e["main_loss"] for e in h_full["train"][3:]]
    a, b = full_model.state_dict(), model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_with_replacement_sampling_is_keyed_and_resumes(tmp_path):
    x, y = _data(24, seed=5)
    data = preprocess({"trainset": tds.ArrayDataset(x, y, classes=list("abc"))}, PP)
    hp = _hp(tmp_path, epochs=3, batch_size=6, sampling="with_replacement",
             save_every_iters=1, run_dir="a")
    init = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu").state_dict()
    runs = []
    for run_dir in ("a", "b"):
        m = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
        runs.append(train(dict(hp, run_dir=run_dir), m, cross_entropy_loss, data,
                          init_variables=init)[1])
    assert runs[0]["input_path"] == "resident" and runs[0]["steps"] == 9
    assert [e["main_loss"] for e in runs[0]["train"]] == [e["main_loss"] for e in runs[1]["train"]]
    m = DeepcvModule((8, 8, 3), copy.deepcopy(TINY_HP), device="cpu")
    _, h = train(dict(hp, run_dir="c", resume_from=str(tmp_path / "a" / "checkpoints" / "steps"
                                                      / "7.pt")), m, cross_entropy_loss, data)
    assert [e["main_loss"] for e in h["train"]] == [e["main_loss"] for e in runs[0]["train"][7:]]
    dd = DeviceDataset(data["trainset"], 6, "cpu")
    xb, yb = dd.batch_for_step(torch.Generator().manual_seed(0))
    assert xb.shape == (6, 8, 8, 3) and yb.dtype == torch.int64


# --------------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", [True, "dots"])
def test_remat_equals_no_remat_with_dropout(mode):
    """A model with dropout drawing from the loop's generator: loss,
    gradients, BN statistics and the generator's state after the step are
    those of the plain forward."""
    hp = copy.deepcopy(TINY_HP)
    hp["dropout_prob"] = 0.3
    x = torch.from_numpy(np.random.default_rng(0).random((6, 8, 8, 3), dtype=np.float32))
    y = torch.tensor([0, 1, 2, 0, 1, 2])
    results = []
    init = DeepcvModule((8, 8, 3), copy.deepcopy(hp), device="cpu").state_dict()
    for remat in (None, mode):
        m = DeepcvModule((8, 8, 3), copy.deepcopy(hp), device="cpu")
        m.load_state_dict(init)
        gen = torch.Generator().manual_seed(7)
        for mod in m.modules():
            if hasattr(mod, "generator"):
                mod.generator = gen
        m.train()
        fwd = remat_forward(m, remat, gen) if remat else m
        loss = cross_entropy_loss(fwd(x), y)
        with fwd.backward_guard() if remat else contextlib.nullcontext():
            loss.backward()
        grads = {n: p.grad.clone() for n, p in m.named_parameters()}
        results.append((loss.item(), grads, gen.get_state(),
                        {k: v.clone() for k, v in m.state_dict().items()}))
    (l0, g0, s0, sd0), (l1, g1, s1, sd1) = results
    assert l1 == pytest.approx(l0, abs=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), atol=1e-6, err_msg=n)
    assert torch.equal(s0, s1)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    with pytest.raises(ValueError, match="remat must be"):
        remat_forward(m, "sometimes", None)


def test_remat_runs_in_train(tiny_pair, tmp_path):
    jm, v, jd, td = tiny_pair
    hp = _hp(tmp_path, device_resident_dataset=True, remat="dots")
    tm = _torch_model(v)
    _, h = train(hp, tm, cross_entropy_loss, td)
    tm2 = _torch_model(v)
    _, h2 = train(dict(hp, remat=False), tm2, cross_entropy_loss, td)
    np.testing.assert_allclose([e["main_loss"] for e in h["train"]],
                               [e["main_loss"] for e in h2["train"]], rtol=1e-6)


# --------------------------------------------------------------------------- #
# The input pipeline
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["array", "memmap", "wrap"])
def test_batch_iterator_equals_jax(tmp_path, case):
    x, y = _data(30 if case != "wrap" else 7, seed=4)
    if case == "memmap":
        np.save(tmp_path / "x.npy", x)
        x = np.load(tmp_path / "x.npy", mmap_mode="r")
    kw = dict(seed=11, shuffle_chunk=8 if case == "memmap" else None,
              drop_last=case != "wrap")
    ours = BatchIterator(tds.ArrayDataset(x, y), 4 if case != "wrap" else 5, **kw)
    theirs = JaxBatchIterator(jds.ArrayDataset(x, y), 4 if case != "wrap" else 5, **kw)
    assert len(ours) == len(theirs)
    for epoch in (0, 1):
        pairs = list(zip(ours.epoch(epoch), theirs.epoch(epoch)))
        assert len(pairs) == len(theirs)
        for (a, b), (c, d) in pairs:
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    for pc in (2,):
        a = [b for b, _ in BatchIterator(tds.ArrayDataset(x, y), 2, seed=1, process_index=1,
                                         process_count=pc, drop_last=False).epoch(0)]
        b = [b for b, _ in JaxBatchIterator(jds.ArrayDataset(x, y), 2, seed=1, process_index=1,
                                            process_count=pc, drop_last=False).epoch(0)]
        assert all(np.array_equal(u, w) for u, w in zip(a, b)) and len(a) == len(b)


def test_prefetch_on_the_cpu_and_refusals():
    x, y = _data(8)
    got = list(prefetch_to_device(iter([(x[:4], y[:4]), (x[4:], y[4:])]), size=2, device="cpu"))
    assert len(got) == 2 and torch.equal(got[1][0], torch.from_numpy(x[4:]))
    # the wire codec decodes on the device (here the CPU) to the host batch,
    # a coded one (a smooth batch) and a raw one (noise)
    smooth = np.broadcast_to(x[:, :1], x.shape).copy()
    got = list(prefetch_to_device(iter([(smooth, y), (x, y)]), device="cpu",
                                  wire_codec={"bits": 3}))
    assert torch.equal(got[0][0], torch.from_numpy(smooth))
    assert torch.equal(got[1][0], torch.from_numpy(x)) and torch.equal(got[1][1],
                                                                       torch.from_numpy(y))
    with pytest.raises(ValueError, match="smaller than one global batch"):
        BatchIterator(tds.ArrayDataset(x, y), 16)


# --------------------------------------------------------------------------- #
# UDA
# --------------------------------------------------------------------------- #

def _jax_uda_terms(logits, student_logits, y, cfg):
    """The JAX loop's UDA arithmetic (deepcv_tpu/train/training.py, loss_fn)
    on given logits."""
    t_logits = jax.lax.stop_gradient(logits).astype(jnp.float32)
    p_teacher = jax.nn.softmax(t_logits / float(cfg.get("temperature", 0.4)), axis=-1)
    conf = jnp.max(jax.nn.softmax(t_logits, axis=-1), axis=-1)
    unlabeled = y < 0
    m = (unlabeled & (conf >= float(cfg.get("confidence_threshold", 0.0)))).astype(jnp.float32)
    logq = jax.nn.log_softmax(student_logits.astype(jnp.float32), -1)
    kl = jnp.sum(p_teacher * (jnp.log(jnp.maximum(p_teacher, 1e-12)) - logq), axis=-1)
    lm = (~unlabeled).astype(jnp.float32)
    hits = (jnp.argmax(logits, -1) == jnp.maximum(y, 0)).astype(jnp.float32)
    return {"uda_consistency": jnp.sum(kl * m) / jnp.maximum(jnp.sum(m), 1.0),
            "uda_masked_frac": jnp.mean(m),
            "labeled_accuracy": jnp.sum(hits * lm) / jnp.maximum(jnp.sum(lm), 1.0)}


@pytest.mark.parametrize("cfg", [{}, {"temperature": 0.7, "confidence_threshold": 0.45}])
def test_uda_terms_match_the_jax_formula(cfg):
    rng = np.random.default_rng(8)
    lg, st = (rng.normal(size=(12, 5)).astype(np.float32) * 2 for _ in range(2))
    y = rng.integers(-1, 5, 12)
    ref = _jax_uda_terms(jnp.asarray(lg), jnp.asarray(st), jnp.asarray(y), cfg)
    got = uda_terms(torch.from_numpy(lg), torch.from_numpy(st), torch.from_numpy(y), cfg)
    for k in ref:
        assert got[k].item() == pytest.approx(float(ref[k]), rel=1e-5, abs=1e-7), k


def test_uda_trains_with_an_unlabeled_set(tiny_pair, tmp_path):
    _, v, _, td = tiny_pair
    unl = _data(8, seed=9)[0]
    data = {**td, "unlabeledset": tds.ArrayDataset(unl, np.zeros(8, np.int64))}
    hp = _hp(tmp_path, batch_size=8, uda={"weight": 1.0, "ops": ["autocontrast", "posterize"]})
    tm = _torch_model(v)
    _, h = train(hp, tm, cross_entropy_loss, data)
    assert h["steps"] == 12   # (16 + 8) / 8 a epoch
    assert {"uda_consistency", "uda_masked_frac", "labeled_accuracy"} <= set(h["train"][0])
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    with pytest.raises(ValueError, match="device-resident"):
        train(dict(hp, device_resident_dataset=False), _torch_model(v), cross_entropy_loss, data)
    with pytest.raises(ValueError, match="unlabeledset"):
        train(_hp(tmp_path), _torch_model(v), cross_entropy_loss, data)


# --------------------------------------------------------------------------- #
# Datasets
# --------------------------------------------------------------------------- #

def test_memmap_split_and_random_subset_equal_jax(tmp_path):
    x, y = _data(30, seed=6)
    np.save(tmp_path / "images.npy", x)
    np.save(tmp_path / "targets.npy", y)
    ours = tds.load_dataset({"type": "memmap", "root": str(tmp_path)})
    theirs = jds.load_dataset({"type": "memmap", "root": str(tmp_path)})
    for a, b in zip(tds.split_dataset(ours, validset_ratio=0.2, testset_ratio=0.1).items(),
                    jds.split_dataset(theirs, validset_ratio=0.2, testset_ratio=0.1).items()):
        assert a[0] == b[0] and isinstance(a[1].images, np.memmap)
        np.testing.assert_array_equal(a[1].images, b[1].images)
    for size in (0.3, 7):
        np.testing.assert_array_equal(tds.get_random_subset(ours, size, seed=2).targets,
                                      jds.get_random_subset(theirs, size, seed=2).targets)


def test_tar_shards_round_trip_across_packages(tmp_path):
    x, y = _data(11, seed=7)
    tds.write_tar_shards(tds.ArrayDataset(x, y, classes=list("abc")), tmp_path / "ours",
                         shard_size=4)
    jds.write_tar_shards(jds.ArrayDataset(x, y, classes=list("abc")), tmp_path / "jax",
                         shard_size=4)
    for src in ("ours", "jax"):
        a = tds.load_dataset({"type": "tar_shards", "root": str(tmp_path / src)})
        b = jds.load_dataset({"type": "tar_shards", "root": str(tmp_path / src)})
        for ds in (a, b):
            np.testing.assert_array_equal(ds.images, x)
            np.testing.assert_array_equal(ds.targets, y)
            assert ds.classes == list("abc")
    mm = tds.tar_shards_to_memmap(tmp_path / "jax", tmp_path / "mm")
    assert isinstance(mm.images, np.memmap)
    np.testing.assert_array_equal(mm.images, x)
    jds.tar_shards_to_memmap(tmp_path / "ours", tmp_path / "mm2")
    for f in ("images.npy", "targets.npy", "classes.txt"):
        assert (tmp_path / "mm" / f).read_bytes() == (tmp_path / "mm2" / f).read_bytes()
    with pytest.raises(ValueError, match="uint8 raw pixels"):
        tds.write_tar_shards(tds.ArrayDataset(x.astype(np.float32), y), tmp_path / "f")


def test_image_folder_and_its_memmap_equal_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for c in ("cat", "dog"):
        (tmp_path / "tree" / c).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)).save(
                tmp_path / "tree" / c / f"{i}.png")
    spec = {"type": "image_folder", "root": str(tmp_path / "tree"), "image_size": 6}
    a, b = tds.load_dataset(spec), jds.load_dataset(spec)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert a.classes == b.classes == ["cat", "dog"] and a.images.shape == (6, 6, 6, 3)
    m1 = tds.materialize_image_folder_to_memmap(tmp_path / "tree", tmp_path / "m1", image_size=6)
    m2 = jds.materialize_image_folder_to_memmap(tmp_path / "tree", tmp_path / "m2", image_size=6)
    np.testing.assert_array_equal(m1.images, m2.images)
    np.testing.assert_array_equal(m1.targets, m2.targets)


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #

def test_label_smoothing_and_triplet_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 7)
    assert label_smoothing_xentropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                         0.2).item() == \
        pytest.approx(float(jax_ls(jnp.asarray(logits), jnp.asarray(labels), 0.2)), rel=1e-6)
    a, p, n = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3))
    for kw in ({}, {"margin": 0.3, "p": 1}, {"margin": 2.0, "p": 3}):
        got = triplet_margin_loss(*(torch.from_numpy(t) for t in (a, p, n)), **kw).item()
        assert got == pytest.approx(float(jax_triplet(*(jnp.asarray(t) for t in (a, p, n)),
                                                      **kw)), rel=1e-5)
    assert LOSS_FNS["triplet_margin"] is triplet_margin_loss
    assert LOSS_FNS["label_smoothing_xentropy"] is label_smoothing_xentropy_loss


# --------------------------------------------------------------------------- #
# Loggers, events, backend
# --------------------------------------------------------------------------- #

def _records(path):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("time", None)
        out.append(rec)
    return out


def test_loggers_and_tracker_write_the_jax_records(tmp_path):
    for pkg, name in ((tlog, "ours"), (jlog, "jax")):
        lg = pkg.MetricsJsonlLogger(tmp_path / name / "m.jsonl")
        lg.log_params({"a": {"b": 1}, "c": (1, 2)})
        lg.log_metrics({"loss": np.float32(0.5)}, step=3)
        lg.set_tags({"t": "x"})
        lg.log_artifact(tmp_path / "f")
        lg.close()
        tr = pkg.ExperimentTracker(root=tmp_path / name / "exp", experiment="e", run_name="r")
        tr.log_params({"lr": 0.1, "opt": {"b": [1, 2]}})
        tr.log_metrics({"acc": 0.25}, step=2)
        tr.set_tags({"pipeline": "p"})
        (tmp_path / name / "art.txt").write_text("hi")
        tr.log_artifact(tmp_path / name / "art.txt")
        tr.end_run()
    assert _records(tmp_path / "ours" / "m.jsonl") == _records(tmp_path / "jax" / "m.jsonl")
    (ours,), (theirs,) = ((tmp_path / n / "exp" / "e").iterdir() for n in ("ours", "jax"))
    assert _records(ours / "metrics.jsonl") == _records(theirs / "metrics.jsonl")
    assert json.loads((ours / "params.json").read_text()) == \
        json.loads((theirs / "params.json").read_text())
    ma, mb = (json.loads((d / "meta.json").read_text()) for d in (ours, theirs))
    for m in (ma, mb):
        m.pop("start_time"), m.pop("end_time")
    assert ma == {**mb, "run_name": ma["run_name"]} and (ours / "artifacts" / "art.txt").exists()
    assert set(tlog.git_metadata(REPO)) == set(jlog.git_metadata(REPO))


def test_events_histograms_regularizer_and_init_variables(tiny_pair, tmp_path):
    _, v, _, td = tiny_pair
    events, fired = TrainingEvents(), []
    for ev in ("iteration_completed", "epoch_completed", "validation_completed", "completed"):
        events.on(ev, lambda _ev=ev, **ctx: fired.append(_ev))

    class Hist:
        names = []

        def log_metrics(self, *_a, **_k):
            pass

        def log_histogram(self, name, values, step):
            self.names.append(name)

    tm = _torch_model(v)
    init = {k: t.clone() for k, t in tm.state_dict().items()}
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    reg = lambda params: 0.0 * sum(p.sum() for p in params.values())  # noqa: E731
    _, h = train(_hp(tmp_path, epochs=2, log_param_histograms=True), tm, cross_entropy_loss, td,
                 loggers=[Hist()], events=events, param_regularizer=reg, init_variables=init)
    assert fired.count("iteration_completed") == 2 and fired.count("epoch_completed") == 2
    assert fired.count("validation_completed") == 2 and fired[-1] == "completed"
    assert "['node_impls__submodule_0_conv2d']['op']['kernel']" in Hist.names
    assert h["train"][0]["main_loss"] > 0.5    # started from init, not from zeros


def test_backend_config_and_run_dir(tiny_pair, tmp_path):
    b = BackendConfig(device="cpu", dist_backend="nccl", local_rank=0, ngpus=1)
    assert str(b) == "cpu-x1" and b.rank == 0 and b.process_count == 1 and b.n_devices == 1
    for kw in ({"n_devices": 2}, {"tensor_parallel": 2}, {"zero": True}, {"mesh_shape": [1]},
               {"slices": 2}, {"distributed": True}):
        with pytest.raises(NotImplementedError, match="P15"):
            BackendConfig(device="cpu", **kw)
    _, v, _, td = tiny_pair
    hp = _hp(tmp_path, epochs=1, backend_conf={"n_devices": 2})
    _, h = train(hp, _torch_model(v), cross_entropy_loss, td, backend_conf=b)
    assert os.path.basename(h["run_dir"]).endswith("_cpu-x1")


def test_train_with_retries_resumes_after_a_crash(tiny_pair, tmp_path):
    _, v, _, td = tiny_pair
    hp = _hp(tmp_path, epochs=3, save_every_iters=1, crash_iteration=2)
    state, h = train_with_retries(hp, _torch_model(v), cross_entropy_loss, td)
    assert h["steps"] == 3 and state.step == 3
    with pytest.raises(ValueError, match="save_every_iters"):
        train_with_retries(dict(hp, save_every_iters=0), _torch_model(v), cross_entropy_loss, td)


def test_schedule_free_validates_at_its_average_and_refuses_ema(tiny_pair, tmp_path):
    _, v, _, td = tiny_pair
    hp = _hp(tmp_path, epochs=2, optimizer="schedule_free_adamw",
             optimizer_opts={"lr": 0.05})
    tm = _torch_model(v)
    state, h = train(hp, tm, cross_entropy_loss, td)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    with state.eval_weights():
        swapped = {k: t.clone() for k, t in tm.state_dict().items()}
    assert any(not torch.equal(before[k], swapped[k]) for k in before)
    assert all(torch.equal(before[k], tm.state_dict()[k]) for k in before)
    with pytest.raises(ValueError, match="ema_decay"):
        train(dict(hp, ema_decay=0.9), _torch_model(v), cross_entropy_loss, td)


# --------------------------------------------------------------------------- #
# Partial runs and the intermediate cache
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def both_registries():
    from deepcv_tpu.pipelines.registry import create_pipelines as jax_pipelines
    from deepcv_tpu_torch.pipelines.registry import create_pipelines

    return create_pipelines(None), jax_pipelines(None)


def test_pipeline_filter_selects_the_jax_nodes(both_registries):
    ours, theirs = both_registries
    common = sorted(set(ours) & set(theirs))
    assert len(common) >= 20
    for name in common:
        names = [n.name for n in theirs[name].nodes]
        assert [n.name for n in ours[name].nodes] == names, name
        tags = sorted({t for n in theirs[name].nodes for t in n.tags})
        selections = [dict(from_nodes=names[-1:]), dict(to_nodes=names[:1]),
                      dict(only_nodes=names[::2]), dict(tags=tags[:1]),
                      dict(from_nodes=names[:1], to_nodes=names[-1:], tags=tags[-1:])]
        for sel in selections:
            if sel.get("tags") == []:
                continue
            try:
                want = [n.name for n in theirs[name].filter(**sel).nodes]
            except ValueError:
                with pytest.raises(ValueError):
                    ours[name].filter(**sel)
                continue
            assert [n.name for n in ours[name].filter(**sel).nodes] == want, (name, sel)
    with pytest.raises(KeyError, match="has no node 'nope'"):
        ours[common[0]].filter(from_nodes=["nope"])


def _tiny_cifar_project(root):
    (root / "conf").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    (root / "conf" / "local").mkdir()
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "cifar10_train": {"type": "synthetic", "n": 48, "image_shape": [16, 16, 3],
                          "num_classes": 10},
        "cifar10_test": {"type": "synthetic", "train": False, "n": 8,
                         "image_shape": [16, 16, 3], "num_classes": 10}}))
    return root


def test_partial_run_from_the_cache_equals_the_full_run(tmp_path, monkeypatch):
    """--to-nodes create_model writes the intermediates; --from-nodes train
    reads them and trains as the full run does; a train-tagged run leaves a
    tracker run with the JAX package's files."""
    root = _tiny_cifar_project(tmp_path / "proj")
    monkeypatch.chdir(tmp_path)
    params = ",".join(["train_image_classifier.epochs:1", "train_image_classifier.batch_size:16",
                       "train_image_classifier.save_every_iters:0",
                       f"train_image_classifier.output_path:{tmp_path / 'out'}",
                       "train_image_classifier.log_progress_every_iters:1"])
    base = ["--pipeline=train_image_classifier", "--project-path", str(root), "--device", "cpu",
            "--params", params]
    full = cli_run([*base, "--no-persist"])
    first = cli_run([*base, "--to-nodes", "create_model"])
    assert "train_results" not in first
    cache = root / "data" / "02_intermediate" / "train_image_classifier"
    assert sorted(p.name for p in cache.iterdir()) == ["datasets.pkl", "model.pkl"]
    rest = cli_run([*base, "--from-nodes", "train"])
    lf = [e["main_loss"] for e in full["train_results"]["history"]["train"]]
    lr = [e["main_loss"] for e in rest["train_results"]["history"]["train"]]
    assert len(lf) == 2 and lr == lf
    runs = sorted((tmp_path / "data" / "04_training" / "experiments" /
                   "train_image_classifier").iterdir())
    meta = json.loads((runs[-1] / "meta.json").read_text())
    assert meta["status"] == "FINISHED" and meta["tags"]["pipeline"] == "train_image_classifier"
    assert json.loads((runs[-1] / "params.json").read_text()) == {"pipeline_nodes": ["train"]}
    assert [json.loads(x)["step"] for x in (runs[-1] / "metrics.jsonl").read_text().splitlines()
            ][:2] == [1, 2]
    with pytest.raises(KeyError, match="persisted intermediate"):
        cli_run([*base, "--from-nodes", "train", "--no-persist"])


def test_partial_run_refuses_a_cache_the_jax_package_wrote(tmp_path, monkeypatch):
    """The JAX package keeps its intermediates at the same project path; a
    partial run refuses them by the first class from outside the port, torch
    and numpy, before that class's module is imported."""
    root = _tiny_cifar_project(tmp_path / "proj")
    monkeypatch.chdir(tmp_path)
    cache = root / "data" / "02_intermediate" / "train_image_classifier"
    cache.mkdir(parents=True)
    (cache / "model.pkl").write_bytes(pickle.dumps({"loss": jax_ce}))
    base = ["--pipeline=train_image_classifier", "--project-path", str(root), "--device", "cpu",
            "--from-nodes", "train", "--params", "train_image_classifier.epochs:1"]
    for planted, match in [(pickle.dumps({"trainset": jnp.arange(4)}), r"datasets\.pkl holds jax"),
                           (b"cdeepcv_tpu.no_such_module\nThing\n.",
                            r"holds deepcv_tpu\.no_such_module\.Thing")]:
        (cache / "datasets.pkl").write_bytes(planted)
        with pytest.raises(pickle.UnpicklingError, match=match):
            cli_run(base)
    (cache / "datasets.pkl").write_bytes(pickle.dumps({"n": np.arange(3)}))
    with pytest.raises(pickle.UnpicklingError, match=r"model\.pkl holds deepcv_tpu\.train"):
        cli_run(base)

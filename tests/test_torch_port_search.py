"""Search in the port against the JAX package, on the CPU: the hp spaces and
tuners, the runner, the NAS choice points (fixed and supernet: forwards,
first-step gradients with the ``arch__*`` logits, forced architectures),
classic and single-shot NAS, the cost table, the ENAS controllers, the
generalization fit, the hp embedding, the LR finder, ``runtime_lr`` and
``train_arch_params``, NAS bundles, and the CLI's ``search`` and
``lr-find``. Sizes are the JAX tests' (``tests/test_search.py``): 8x8 to
16x16 images, 96 of them, 8 channels."""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml

from chip_smoke import nas_classifier_hp
from deepcv_tpu import hyperparams as jhp
from deepcv_tpu import search as jsearch
from deepcv_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from deepcv_tpu.data.preprocess import preprocess as jax_preprocess
from deepcv_tpu.search import hp_embedding as jemb
from deepcv_tpu.search import nas as jnas
from deepcv_tpu.search import nni_compat as jnni
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec.graph import clone_with_forced_arch as jax_forced
from deepcv_tpu.train.lr_finder import run_lr_range_test as jax_lr_range_test
from deepcv_tpu_torch import hyperparams as thp
from deepcv_tpu_torch import search as tsearch
from deepcv_tpu_torch.cli import main as cli_main
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data.datasets import ArrayDataset
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import jax_param_paths, jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.pipelines.framework import ProjectContext
from deepcv_tpu_torch.search import hp_embedding as temb
from deepcv_tpu_torch.search import nas as tnas
from deepcv_tpu_torch.search import nni_compat as tnni
from deepcv_tpu_torch.serve import load_model_bundle, save_model_bundle
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.graph import SpecError
from deepcv_tpu_torch.train import training
from deepcv_tpu_torch.train.lr_finder import run_lr_range_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
NUM_TOL = 1e-5        # numpy-side and small-module bound

NAS_YML = """
act_fn: relu
architecture:
  - conv2d: ["p1", { kernel_size: [3, 3], out_channels: 8, padding: 1 }]
  - conv2d: ["c1", { kernel_size: [3, 3], out_channels: 8, padding: 1 }]
  - avg_pooling: { kernel_size: [2, 2], stride: [2, 2] }
  - _nas_layer_choice:
      _name: "mut1"
      _candidates:
        - conv2d: { kernel_size: [3, 3], out_channels: 8, padding: 1 }
        - conv2d: { kernel_size: [5, 5], out_channels: 8, padding: 2 }
  - residual_link: ["res1", { _from_nas_input_choice: ["p1", "c1"], reduction: "mean", allow_scaling: true }]
"""

#: a nested choice and a head, as in the conf's classifier
NESTED_YML = """
act_fn: relu
architecture:
  - conv2d: { kernel_size: [3, 3], out_channels: 8, padding: 1 }
  - _nested_deepcvmodule:
      _name: "inner"
      act_fn: relu
      architecture:
        - _nas_layer_choice:
            _name: "m1"
            _candidates:
              - conv2d: { kernel_size: [3, 3], out_channels: 8, padding: 1 }
              - conv2d: { kernel_size: [7, 7], out_channels: 8, padding: 3 }
  - flatten: {}
  - fully_connected: { out_features: 4, act_fn: null }
"""

CHOICE_HEAD_YML = """
act_fn: relu
architecture:
  - conv2d: { kernel_size: [3, 3], out_channels: 8, padding: 1 }
  - _nas_layer_choice:
      _name: "m1"
      _candidates:
        - conv2d: { kernel_size: [3, 3], out_channels: 8, padding: 1 }
        - conv2d: { kernel_size: [5, 5], out_channels: 8, padding: 2 }
  - flatten: {}
  - fully_connected: { out_features: 4, act_fn: null }
"""

SPACE = {
    "training:optimizer_opts.lr": {"_type": "loguniform", "_value": [1e-4, 1e-1]},
    "model:dropout_prob": {"_type": "uniform", "_value": [0.0, 0.5]},
    "model:conv_size": {"_type": "choice", "_value": [3, 5]},
    "training:batch_size": {"_type": "quniform", "_value": [8, 64, 8]},
    "training:epochs": {"_type": "randint", "_value": [1, 5]},
}


def _conf_models():
    doc = load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))
    return doc, {k: v for d in doc["models"] for k, v in d.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _pair(hp, shape, mode="fixed", arch=None, sampling="softmax", seed=3):
    jm = JaxModule(shape, hp, nas_mode=mode, nas_arch=arch, nas_sampling=sampling)
    jv = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    if mode == "supernet":       # logits off zero, so the mixture has a shape
        rng = np.random.default_rng(seed)

        def move(d):
            for k, v in d.items():
                if isinstance(v, dict):
                    move(v)
                elif k.startswith("arch__"):
                    d[k] = rng.normal(size=v.shape).astype(np.float32)
        move(jv["params"])
    tm = DeepcvModule(shape, hp, nas_mode=mode, nas_arch=arch, nas_sampling=sampling,
                      device="cpu")
    load_jax_variables(tm, jv)
    return jm, jv, tm


def _images(shape, n=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(np.float32)


def _jax_forward(jm, jv, x, train=False):
    out = jm.apply(jv, jnp.asarray(x), train=train)
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _tiny_data(n=96, size=8, classes=4, seed=1, ratio=0.25, jax_side=False):
    """Class-dependent synthetic images (learnable), split like the JAX
    tests'."""
    base = np.random.default_rng(99).integers(0, 256, (classes, size, size, 3)).astype(np.int16)
    rng = np.random.default_rng(seed)
    t = rng.integers(0, classes, n).astype(np.int64)
    imgs = np.clip(base[t] + rng.integers(0, 64, (n, size, size, 3)) - 32, 0, 255).astype(np.uint8)
    cfg = {"seed": 0, "split_dataset": {"validset_ratio": ratio}, "transforms": ["to_tensor"]}
    if jax_side:
        return jax_preprocess({"trainset": JaxArrayDataset(imgs, t, classes=list("abcd")[:classes],
                                                           name="tiny")}, cfg)
    return preprocess({"trainset": ArrayDataset(imgs, t, classes=list("abcd")[:classes],
                                                name="tiny")}, cfg)


def _train_hp(tmp_path, **kw):
    return {"epochs": 1, "batch_size": 24, "optimizer_opts": {"lr": 1e-2},
            "save_every_iters": 0, "output_path": str(tmp_path), "validate_every_epochs": 1,
            "seed": 5, "log_progress_every_iters": 1, **kw}


# --------------------------------------------------------------------------- #
# Spaces, tuners, runner, NNI shims
# --------------------------------------------------------------------------- #

def test_space_round_trips_and_samples_as_jax():
    js, ts = jhp.HyperparameterSpace.from_nni_json(SPACE), \
        thp.HyperparameterSpace.from_nni_json(SPACE)
    assert ts.to_nni_json() == js.to_nni_json() == SPACE and len(ts) == 5
    assert [ts.sample(np.random.default_rng(7)) for _ in range(1)] == \
        [js.sample(np.random.default_rng(7))]
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    assert [ts.sample(r1) for _ in range(20)] == [js.sample(r2) for _ in range(20)]
    with pytest.raises(ValueError, match="Unknown domain kind"):
        thp.HyperparamDomain("normal", [0, 1])
    flat = {"training:optimizer_opts.lr": 0.1, "model:act_fn": "relu"}
    assert thp.apply_dotted_overrides({"optimizer_opts": {"lr": 1.0}}, flat) == \
        jhp.apply_dotted_overrides({"optimizer_opts": {"lr": 1.0}}, flat)


@pytest.mark.parametrize("tuner", ["RandomTuner", "GridTuner", "TPETuner"])
def test_tuners_suggest_as_jax_for_the_same_seed(tuner):
    """The same seed and the same observations give the same suggestions
    (past the TPE's 8 random start-up trials)."""
    space = {k: v for k, v in SPACE.items() if not (tuner == "GridTuner" and k.endswith("lr"))}
    jt = getattr(jsearch, tuner)(jhp.HyperparameterSpace.from_nni_json(space), seed=4)
    tt = getattr(tsearch, tuner)(thp.HyperparameterSpace.from_nni_json(space), seed=4)
    for i in range(14):
        a, b = jt.suggest(), tt.suggest()
        assert a == b, (i, a, b)
        v = -sum(abs(float(x)) for x in a.values())
        jt.observe(a, v)
        tt.observe(b, v)


def test_median_stop_assessor_as_jax():
    ja, ta = jsearch.MedianStopAssessor(start_step=1), tsearch.MedianStopAssessor(start_step=1)
    for runs in ([0.5, 0.6, 0.7], [0.4, 0.5, 0.6]):
        ja.trial_end(runs)
        ta.trial_end(runs)
    for probe in ([0.1, 0.1], [0.8], [0.55, 0.5], []):
        assert ta.should_stop(probe) == ja.should_stop(probe)


def test_search_runner_records_equal_jax(tmp_path, monkeypatch):
    """A deterministic objective: the same trials (params, values,
    intermediates, early stops) and best, the files written, the env vars
    that name the trial."""
    monkeypatch.delenv("DEEPCV_SEARCH_TRIAL", raising=False)

    def trial_fn(params, trial):
        v = -(np.log10(params["training:optimizer_opts.lr"]) + 2.0) ** 2
        for k in range(3):
            trial.report_intermediate_result(v - 0.1 * (2 - k))
            if trial.should_stop():
                break
        trial.report_final_result(v)

    runs = {}
    for name, pkg, space_mod in (("jax", jsearch, jhp), ("torch", tsearch, thp)):
        space = space_mod.HyperparameterSpace.from_nni_json(SPACE)
        runs[name] = pkg.SearchRunner(space, trial_fn, tuner="tpe", max_trials=12, seed=3,
                                      output_dir=tmp_path / name,
                                      persistent_jit_cache=False).run()
    strip = lambda s: [{k: v for k, v in t.items() if k != "seconds"} for t in s["trials"]]
    assert strip(runs["torch"]) == strip(runs["jax"])
    assert runs["torch"]["best"]["trial"] == runs["jax"]["best"]["trial"]
    assert any(t["stopped_early"] for t in runs["torch"]["trials"])
    lines = (tmp_path / "torch" / "trials.jsonl").read_text().splitlines()
    assert len(lines) == 12 and json.loads(lines[-1])["trial"] == 11
    assert json.loads((tmp_path / "torch" / "summary.json").read_text())["best"]["trial"] == \
        runs["torch"]["best"]["trial"]
    assert os.environ["DEEPCV_SEARCH_TRIAL"] == "11"
    assert os.environ["DEEPCV_SEARCH_EXPERIMENT"] == "torch"
    assert ProjectContext._search_trial_run_name() == "torch_11"
    with pytest.raises(ValueError, match="Unknown tuner"):
        tsearch.SearchRunner(thp.HyperparameterSpace.from_nni_json(SPACE), trial_fn,
                             tuner="bayes")


def test_search_runner_records_a_failed_trial(tmp_path):
    def trial_fn(params, trial):
        if trial.trial_id == 1:
            raise RuntimeError("boom")
        return float(trial.trial_id)

    s = tsearch.SearchRunner(thp.HyperparameterSpace.from_nni_json(SPACE), trial_fn,
                             tuner="random", max_trials=3, output_dir=tmp_path).run()
    assert [t["value"] for t in s["trials"]] == [0.0, None, 2.0] and s["best"]["trial"] == 2


def test_nni_shims_as_jax(tmp_path, monkeypatch):
    model_hp = {"dropout_prob": 0.0, "architecture": []}
    training_hp = {"optimizer_opts": {"lr": 1e-3}, "epochs": 2}
    sample = {"model:dropout_prob": 0.3, "training:optimizer_opts.lr": 5e-4, "epochs": 9}
    assert tnni.sample_search_space(sample, model_hp, training_hp) == \
        jnni.sample_search_space(sample, model_hp, training_hp)
    assert model_hp["dropout_prob"] == 0.0
    cfg = tnni.gen_nni_config("train_image_classifier", "space.json",
                              output_path=tmp_path / "nni.yml", max_trials=10)
    ref = jnni.gen_nni_config("train_image_classifier", "space.json", max_trials=10)
    assert cfg["trial"]["command"] == "python -m deepcv_tpu_torch run " \
                                      "--pipeline=train_image_classifier"
    assert {k: v for k, v in cfg.items() if k not in ("trial", "authorName", "experimentName")} \
        == {k: v for k, v in ref.items() if k not in ("trial", "authorName", "experimentName")}
    assert yaml.safe_load((tmp_path / "nni.yml").read_text()) == cfg
    for env in ({}, {"DEEPCV_SEARCH_EXPERIMENT": "exp", "DEEPCV_SEARCH_TRIAL": "3"},
                {"NNI_EXP_ID": "STANDALONE"}, {"NNI_GEN_SEARCH_SPACE": "1"}):
        for k in ("DEEPCV_SEARCH_EXPERIMENT", "DEEPCV_SEARCH_TRIAL", "NNI_EXP_ID",
                  "NNI_TRIAL_JOB_ID", "NNI_GEN_SEARCH_SPACE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tnni.is_nni_run_standalone() == jnni.is_nni_run_standalone()
        assert tnni.experiment_and_trial() == jnni.experiment_and_trial()
        assert tnni.is_nni_gen_search_space_mode() == jnni.is_nni_gen_search_space_mode()
        assert ProjectContext._search_trial_run_name() == \
            (f"{env['DEEPCV_SEARCH_EXPERIMENT']}_3" if "DEEPCV_SEARCH_TRIAL" in env else None)


def test_search_exports_what_the_jax_package_exports():
    import deepcv_tpu.search as j
    import deepcv_tpu_torch.search as t
    names = {n for n in dir(j) if not n.startswith("_") and callable(getattr(j, n))}
    assert names <= set(dir(t)), sorted(names - set(dir(t)))


# --------------------------------------------------------------------------- #
# Mutables, classic NAS, the cost table
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["nas_yml", "nested", "larger_backbone"])
def test_mutables_space_samples_and_costs_equal_jax(which):
    hp = {"nas_yml": lambda: load_yaml(NAS_YML), "nested": lambda: load_yaml(NESTED_YML),
          "larger_backbone": nas_classifier_hp}[which]()
    assert tnas.list_mutables(hp) == jnas.list_mutables(hp)
    assert tnas.gen_classic_nas_search_space(hp) == jnas.gen_classic_nas_search_space(hp)
    for seed in (0, 1, 7):
        assert tnas.sample_architecture(hp, seed=seed) == jnas.sample_architecture(hp, seed=seed)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    assert [tnas.sample_architecture(hp, rng=r1) for _ in range(6)] == \
        [jnas.sample_architecture(hp, rng=r2) for _ in range(6)]
    shape = (32, 32, 3) if which == "larger_backbone" else (16, 16, 3)
    if which == "larger_backbone":
        hp = nas_classifier_hp(common_width=32)
    costs = tnas.candidate_costs(DeepcvModule(shape, hp, nas_mode="supernet", device="meta"))
    assert costs == jnas.candidate_costs(JaxModule(shape, hp, nas_mode="supernet"))
    assert costs


def test_larger_backbone_mutables_are_nested_and_auto_named():
    muts = tnas.list_mutables(nas_classifier_hp())
    assert muts == {
        "_submodule_0_nested/mutable_layer_1": {"kind": "layer", "n_candidates": 3,
                                                "n_chosen": 1},
        "_submodule_0_nested/_submodule_10_residual_link": {"kind": "input",
                                                            "n_candidates": 2,
                                                            "n_chosen": 1}}


def test_both_packages_refuse_the_conf_larger_backbone_as_a_supernet():
    """Its ``mutable_layer_1`` candidates give 32, 16 and 8 channels: a
    mixture cannot sum them. The port refuses at build, naming the mutable
    and the shapes; the JAX package fails in init. Fixed, each choice
    builds, with JAX's parameter count less its stem kernel's input channels
    padded past the image's 3."""
    hp = nas_classifier_hp()
    with pytest.raises(SpecError, match=r"_submodule_0_nested/mutable_layer_1.*"
                                        r"\(1, 32, 8, 8\), \(1, 16, 8, 8\), \(1, 8, 8, 8\)"):
        DeepcvModule((32, 32, 3), hp, nas_mode="supernet", device="meta")
    with pytest.raises(TypeError, match="incompatible shapes"):
        JaxModule((32, 32, 3), hp, nas_mode="supernet").init(jax.random.PRNGKey(0))
    for i in range(3):
        arch = {"_submodule_0_nested/mutable_layer_1": i}
        jm = JaxModule((32, 32, 3), hp, nas_arch=arch)
        jv = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        kh, kw, cin, cout = jv["params"]["node_impls__submodule_0_nested"][
            "node_impls__submodule_1_conv2d"]["op"]["kernel"].shape
        assert DeepcvModule((32, 32, 3), hp, nas_arch=arch, device="meta").capacity() == \
            jm.capacity(jv) - kh * kw * (cin - 3) * cout


def test_fixed_choices_default_and_refuse_out_of_range():
    hp = load_yaml(NAS_YML)
    m = DeepcvModule((16, 16, 3), hp, device="meta")
    assert [meta.refs for meta in m.module.node_metas if meta.name == "res1"] == [("p1",)]
    assert tuple(m.module.nodes["mut1"].op.weight.shape) == (8, 8, 3, 3)
    m = DeepcvModule((16, 16, 3), hp, nas_arch={"mut1": [1], "res1": 1}, device="meta")
    assert tuple(m.module.nodes["mut1"].op.weight.shape) == (8, 8, 5, 5)
    assert [meta.refs for meta in m.module.node_metas if meta.name == "res1"] == [("c1",)]
    with pytest.raises(SpecError, match=r"nas_arch\['mut1'\]=2 out of range"):
        DeepcvModule((16, 16, 3), hp, nas_arch={"mut1": 2}, device="meta")
    with pytest.raises(SpecError, match=r"nas_arch\['res1'\] picks 5"):
        DeepcvModule((16, 16, 3), hp, nas_arch={"res1": [5]}, device="meta")
    with pytest.raises(SpecError, match="nas_mode must be one of"):
        DeepcvModule((16, 16, 3), hp, nas_mode="oneshot", device="meta")
    with pytest.raises(SpecError, match="nas_sampling must be one of"):
        DeepcvModule((16, 16, 3), hp, nas_mode="supernet", nas_sampling="gumbel",
                     device="meta")


# --------------------------------------------------------------------------- #
# Forwards and first-step gradients against JAX
# --------------------------------------------------------------------------- #

FORWARD_CASES = [
    ("nas_yml", "fixed", "softmax", {"mut1": 1, "res1": [1]}, (16, 16, 3)),
    ("nas_yml", "fixed", "softmax", None, (16, 16, 3)),
    ("nas_yml", "supernet", "softmax", None, (16, 16, 3)),
    ("nas_yml", "supernet", "sampled", None, (16, 16, 3)),
    ("nas_yml", "supernet", "uniform", None, (16, 16, 3)),
    ("choice_head", "supernet", "sampled", None, (8, 8, 3)),
    ("choice_head", "supernet", "uniform", None, (8, 8, 3)),
    ("nested", "supernet", "softmax", None, (8, 8, 3)),
    ("larger_backbone", "fixed", "softmax",
     {"_submodule_0_nested/mutable_layer_1": 2,
      "_submodule_0_nested/_submodule_10_residual_link": [1]}, (32, 32, 3)),
    ("larger_backbone32", "supernet", "softmax", None, (32, 32, 3)),
]


def _case_hp(which):
    return {"nas_yml": lambda: load_yaml(NAS_YML), "nested": lambda: load_yaml(NESTED_YML),
            "choice_head": lambda: load_yaml(CHOICE_HEAD_YML),
            "larger_backbone": nas_classifier_hp,
            "larger_backbone32": lambda: nas_classifier_hp(32)}[which]()


@pytest.mark.parametrize("which,mode,sampling,arch,shape", FORWARD_CASES)
def test_nas_forward_and_first_step_gradients_match_jax(which, mode, sampling, arch, shape):
    """Eval forward within 1e-4; the train-mode step's gradients (the
    ``arch__*`` logits' included) at rtol 1e-3 of max|grad|. ``sampled`` and
    ``uniform`` take the argmax path in both packages here (JAX without a
    'nas' rng, the port without a generator), so their straight-through and
    stopped gradients are held to JAX's; ``uniform`` gives the logits none."""
    hp = _case_hp(which)
    jm, jv, tm = _pair(hp, shape, mode, arch, sampling)
    if mode == "supernet":
        assert sorted(jax_param_paths(tm).values()) == sorted(
            "/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jv["params"])[0])
    x = _images(shape, n=4)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_forward(jm, jv, x), atol=FWD_TOL, rtol=0)
    target = np.random.default_rng(2).normal(size=got.shape).astype(np.float32)

    def loss_fn(params):
        v = dict(jv, params=params)
        out = jm.apply(v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                       mutable=["batch_stats"] if "batch_stats" in jv else False)
        y = out[0] if isinstance(out, tuple) else out
        return jnp.mean((y - target) ** 2)

    jgrads = jax.grad(loss_fn)(jv["params"])
    tm.train()
    F.mse_loss(tm(torch.from_numpy(x)), torch.from_numpy(target)).backward()
    ref = jax_to_torch_state_dict({**jv, "params": _np_tree(jgrads)}, tm)
    named = dict(tm.named_parameters())
    ref = {k: v for k, v in ref.items() if k in named}
    assert set(ref) == set(named)
    for k, g in ref.items():
        # nodes whose output a new branch discards get no gradient (JAX: zeros)
        got_g = named[k].grad.numpy() if named[k].grad is not None else np.zeros(g.shape)
        scale = max(np.abs(g.numpy()).max(), 1e-12)
        np.testing.assert_allclose(got_g / scale, g.numpy() / scale, atol=GRAD_RTOL, rtol=0,
                                   err_msg=k)
    if mode == "supernet":      # (larger_backbone's residual link feeds a dead branch)
        assert any(np.abs(ref[k].numpy()).max() > 0 for k in ref if "arch__" in k) == \
            (sampling != "uniform")


@pytest.mark.parametrize("which,shape,arch", [
    ("nas_yml", (16, 16, 3), {"mut1": 1, "res1": [1]}),
    ("larger_backbone32", (32, 32, 3), {"_submodule_0_nested/mutable_layer_1": 2,
                                        "_submodule_0_nested/_submodule_10_residual_link": [0]}),
])
def test_forced_arch_supernet_equals_the_fixed_model(which, shape, arch):
    """A forced supernet runs the fixed model of the same architecture on
    its candidates' weights; it also equals the JAX package's
    ``clone_with_forced_arch``."""
    hp = _case_hp(which)
    jm, jv, tm = _pair(hp, shape, "supernet")
    x = _images(shape, n=3, seed=4)
    tm.eval()
    with torch.no_grad():
        forced = tm.with_forced_arch(arch)(torch.from_numpy(x)).numpy()
        assert tm.module.forced_arch is None
        fixed = tnas.apply_fixed_architecture(shape, hp, arch, device="cpu").eval()
        fixed.load_state_dict(tnas.fixed_state_dict(tm, arch))
        ref_fixed = fixed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(forced, ref_fixed, atol=FWD_TOL, rtol=0)
    jforced = jax_forced(jm.module, arch)
    np.testing.assert_allclose(forced, np.asarray(jforced.apply(jv, jnp.asarray(x))),
                               atol=FWD_TOL, rtol=0)


def test_export_mask_and_bundles(tmp_path):
    hp = load_yaml(NAS_YML)
    jm, jv, tm = _pair(hp, (16, 16, 3), "supernet")
    assert tnas.export_architecture(tm) == jnas.export_architecture(jv) == \
        tnas.export_architecture(tm.state_dict())
    nested = DeepcvModule((8, 8, 3), load_yaml(NESTED_YML), nas_mode="supernet", device="cpu")
    with torch.no_grad():
        nested.arch_parameters()["inner/m1"].copy_(torch.tensor([0.0, 2.0]))
    assert tnas.export_architecture(nested) == {"inner/m1": 1}
    mask = tnas.arch_params_mask(tm)
    assert sorted(k for k, v in mask.items() if v) == ["module.arch__mut1", "module.arch__res1"]
    assert tnas.arch_params_mask("module.nodes.inner.arch__m1") and \
        not tnas.arch_params_mask("module.nodes.c1.op.weight")
    assert tnas.arch_params_mask("module.nodes.c1.op.weight", invert=True)
    x = torch.from_numpy(_images((16, 16, 3), n=2))
    for model in (DeepcvModule((16, 16, 3), hp, nas_arch={"mut1": 1, "res1": [1]},
                               device="cpu"), tm):
        d = save_model_bundle(tmp_path / model.nas_mode, model.eval())
        meta = yaml.safe_load((d / "model.yaml").read_text())
        assert (meta["nas_mode"], meta["nas_arch"], meta["nas_sampling"]) == \
            (model.nas_mode, model.nas_arch, model.nas_sampling)
        back = load_model_bundle(d, device="cpu")
        assert back.nas_mode == model.nas_mode and back.nas_arch == model.nas_arch
        with torch.no_grad():
            assert torch.equal(back(x), model(x))
    (tmp_path / "arch.json").write_text(json.dumps({"mut1": 1, "res1": [1]}))
    m = tnas.apply_fixed_architecture((16, 16, 3), hp, tmp_path / "arch.json", device="meta")
    assert m.nas_arch == {"mut1": 1, "res1": [1]} and \
        m.with_options(dtype="bfloat16").nas_arch == m.nas_arch


def test_supernet_draws_and_the_nested_sampling_defect():
    """``sampled`` and ``uniform`` draw one path per forward in training
    mode from the model's generator, argmax otherwise; ``uniform`` gives the
    logits no gradient, ``sampled`` does through the straight-through gate.
    A nested supernet takes the model's sampling; the JAX package mixes a
    nested one by softmax whatever its sampling (its output is the softmax
    supernet's)."""
    hp = load_yaml(NESTED_YML)
    x = torch.from_numpy(_images((8, 8, 3), n=2))
    for sampling in ("sampled", "uniform"):
        m = DeepcvModule((8, 8, 3), hp, nas_mode="supernet", nas_sampling=sampling,
                         device="cpu")
        assert m.module.nodes["inner"].sampling == sampling
        m.module.nodes["inner"].generator = torch.Generator().manual_seed(0)
        picks = set()
        for _ in range(64):
            w = m.module.nodes["inner"]._choice_weights("m1", 2)
            assert sorted(w.detach().tolist()) == [0.0, 1.0]
            picks.add(int(w.argmax()))
        assert picks == {0, 1}
        m.zero_grad()
        m(x).sum().backward()
        g = m.arch_parameters()["inner/m1"].grad
        assert (g is None or not g.any()) if sampling == "uniform" else g.abs().max() > 0
        m.eval()
        assert m.module.nodes["inner"]._choice_weights("m1", 2).tolist() == [1.0, 0.0]
    jx = jnp.asarray(x.numpy())
    outs = {}
    for sampling in ("softmax", "uniform"):
        jm = JaxModule((8, 8, 3), hp, nas_mode="supernet", nas_sampling=sampling)
        v = jm.init(jax.random.PRNGKey(1))
        outs[sampling] = np.asarray(jm.apply(v, jx, train=True,
                                             rngs={"dropout": jax.random.PRNGKey(0),
                                                   "nas": jax.random.PRNGKey(3)}))
    np.testing.assert_array_equal(outs["uniform"], outs["softmax"])


def test_cost_regularizer_value_and_gradient_equal_jax():
    hp = load_yaml(NESTED_YML)
    jm, jv, tm = _pair(hp, (8, 8, 3), "supernet")
    costs = tnas.candidate_costs(tm)
    assert list(costs) == ["inner/m1"] and costs["inner/m1"][1] > 3 * costs["inner/m1"][0]
    jreg = jnas.expected_cost_regularizer(costs, weight=0.5)
    treg = tnas.expected_cost_regularizer(costs, weight=0.5)
    params = dict(tm.named_parameters())
    val = treg(params)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jreg(jv["params"])), rtol=1e-6)
    jg = jax.grad(jreg)(jv["params"])["node_impls_inner"]["arch__m1"]
    np.testing.assert_allclose(params["module.nodes.inner.arch__m1"].grad.numpy(),
                               np.asarray(jg), rtol=1e-5, atol=1e-9)


# --------------------------------------------------------------------------- #
# The ENAS controllers
# --------------------------------------------------------------------------- #

def _flat_jax(tree):
    return [np.asarray(a) for a in [tree["x0"], tree["wx"], tree["wh"], tree["b"], *tree["head"],
                                    *tree["head_b"], *tree["emb"]]]


def test_lstm_controller_matches_jax():
    """The same initial parameters (numpy draws), samples and greedy decode;
    each update's REINFORCE gradient within 1e-4 of max|g| (seen: 1.9e-5,
    a reduction-order difference of 1.2e-9), the parameters
    within 1e-5 after each of 3 updates, and the Adam step optax's (its
    float32 bias corrections: in float64 they moved entries whose gradient
    is near Adam's eps by up to 1e-4)."""
    lr = 0.1
    jc, tc = jnas.LstmController([2, 3, 2], seed=3, lr=lr, entropy_weight=5e-3), \
        tnas.LstmController([2, 3, 2], seed=3, lr=lr, entropy_weight=5e-3)
    for a, b in zip(_flat_jax(jc.params), tc._flat()):
        np.testing.assert_array_equal(b.numpy(), a)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        rows_j = [jc.sample(r1) for _ in range(6)]
        rows_t = [tc.sample(r2) for _ in range(6)]
        assert rows_t == rows_j
        adv = [float(r[0] == r[2]) - 0.5 for r in rows_t]
        jg = _flat_jax(jc._grad(jc.params, jnp.asarray(rows_j, jnp.int32),
                                jnp.asarray(adv, jnp.float32)))
        flat = tc._flat()
        for q in flat:
            q.requires_grad_(True)
        lps, ents = zip(*(tc._logprob_entropy(tc.params, r) for r in rows_t))
        loss = -(torch.mean(torch.tensor(adv) * torch.stack(lps))
                 + 5e-3 * torch.mean(torch.stack(ents)))
        tg = torch.autograd.grad(loss, flat, allow_unused=True)
        for q in flat:
            q.requires_grad_(False)
        for a, b in zip(jg, tg):
            b = np.zeros(a.shape) if b is None else b.numpy()
            np.testing.assert_allclose(b, a, atol=1e-4 * max(np.abs(a).max(), 1e-12), rtol=0)
        jc.update(rows_j, adv)
        tc.update(rows_t, adv)
        for a, b in zip(_flat_jax(jc.params), tc._flat()):
            np.testing.assert_allclose(b.numpy(), a, atol=NUM_TOL, rtol=0)
    # Adam itself: optax's step on the same gradients, to rounding
    p = [torch.tensor(a) for a in _flat_jax(jc.params)]
    gs = [torch.tensor(g) for g in jg]
    state = {"count": 0, "mu": [torch.zeros_like(q) for q in p],
             "nu": [torch.zeros_like(q) for q in p]}
    ref_tx = optax.adam(lr)
    upd, _ = ref_tx.update([jnp.asarray(g) for g in jg],
                           ref_tx.init([jnp.asarray(q) for q in _flat_jax(jc.params)]))
    tnas._adam_step(p, gs, state, lr)
    for q, a, u in zip(p, _flat_jax(jc.params), upd):
        np.testing.assert_allclose(q.numpy(), a + np.asarray(u), atol=1e-7, rtol=0)
    assert tc.greedy() == jc.greedy()
    np.testing.assert_allclose(tc.entropy(), jc.entropy(), rtol=1e-5)
    m1, m2 = tc.marginals(np.random.default_rng(1), k=16), jc.marginals(np.random.default_rng(1),
                                                                       k=16)
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(a, b)


def test_enas_steers_a_nested_mutable_and_lstm_finds_a_joint_mode(tmp_path):
    data = _tiny_data()
    arch, state, hist = tnas.enas_neural_architecture_search(
        (8, 8, 3), load_yaml(NESTED_YML), _train_hp(tmp_path, epochs=3, validate_every_epochs=100),
        "cross_entropy", data, controller_lr=10.0, controller_samples=8,
        reward_fn=lambda a, s: float(a["inner/m1"] == 1), device="cpu")
    assert arch == {"inner/m1": 1} and len(hist["controller"]) == 3
    assert hist["controller"][-1]["reward_mean"] > hist["controller"][0]["reward_mean"]
    hp2 = yaml.safe_load(CHOICE_HEAD_YML)
    hp2["architecture"].insert(2, {"_nas_layer_choice": {"_name": "m2", "_candidates": copy.deepcopy(
        hp2["architecture"][1]["_nas_layer_choice"]["_candidates"])}})
    arch, _, hist = tnas.enas_neural_architecture_search(
        (8, 8, 3), hp2, _train_hp(tmp_path, epochs=4, validate_every_epochs=100, seed=11),
        "cross_entropy", data, controller="lstm", controller_lr=0.08, controller_samples=12,
        entropy_weight=1e-3, reward_fn=lambda a, s: float(a["m1"] == a["m2"]), device="cpu")
    assert arch["m1"] == arch["m2"] and len(hist["controller"]) == 4


# --------------------------------------------------------------------------- #
# Single-shot NAS, hp search over NAS, scaling prediction
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("algorithm", ["darts", "spos", "proxylessnas", "enas"])
def test_single_shot_nas_end_to_end(algorithm, tmp_path):
    """Each algorithm trains its supernet on the CPU and exports a valid
    architecture; darts and proxylessnas train the logits, spos leaves them
    at zero, and a dominant cost term drives proxylessnas to the cheap
    candidate."""
    data = _tiny_data()
    kw = {"latency_weight": 100.0} if algorithm == "proxylessnas" else {}
    arch, state, hist = tnas.single_shot_neural_architecture_search(
        (8, 8, 3), load_yaml(CHOICE_HEAD_YML), _train_hp(tmp_path, epochs=2), "cross_entropy",
        data, algorithm=algorithm, arch_export_path=tmp_path / "arch.json", device="cpu", **kw)
    assert arch["m1"] in (0, 1)
    assert json.loads((tmp_path / "arch.json").read_text()) == arch
    assert hist["valid"] and np.isfinite(hist["valid"][-1]["valid_main_loss"])
    logits = state.model.arch_parameters()["m1"].detach()
    if algorithm == "spos":
        assert not logits.any()
    elif algorithm in ("darts", "proxylessnas"):
        assert logits.abs().max() > 1e-6
    if algorithm == "proxylessnas":
        assert arch["m1"] == 0
    fixed = tnas.apply_fixed_architecture((8, 8, 3), load_yaml(CHOICE_HEAD_YML), arch,
                                          device="cpu")
    assert fixed(torch.zeros(1, 8, 8, 3)).shape == (1, 4)
    with pytest.raises(ValueError, match="Unknown single-shot"):
        tnas.single_shot_neural_architecture_search(
            (8, 8, 3), load_yaml(CHOICE_HEAD_YML), _train_hp(tmp_path), "cross_entropy", data,
            algorithm="bogus", device="cpu")


def test_candidate_selection_samples_input_choices():
    """With more architectures than ``max_eval_archs``, the selection samples
    them, input choices included, and returns the best; the JAX package's
    sampler puts an input choice's list in a set and raises there."""
    hp = load_yaml(CHOICE_HEAD_YML)
    hp["architecture"][0] = {"conv2d": ["p1", hp["architecture"][0]["conv2d"]]}
    hp["architecture"].insert(2, {"residual_link": ["r1", {
        "_from_nas_input_choice": ["p1", "m1"], "reduction": "mean"}]})
    with pytest.raises(TypeError, match="unhashable"):
        jnas._select_arch_by_validation((8, 8, 3), hp, None, {}, None, {}, max_archs=2)
    supernet = DeepcvModule((8, 8, 3), hp, nas_mode="supernet", device="cpu")
    arch = tnas._select_arch_by_validation((8, 8, 3), hp, None, _tiny_data(),
                                           "cross_entropy", {}, max_archs=2, supernet=supernet)
    assert set(arch) == {"m1", "r1"} and arch["m1"] in (0, 1) and arch["r1"] in ([0], [1])


def test_hp_search_over_nas(tmp_path):
    data = _tiny_data()
    space = thp.HyperparameterSpace.from_nni_json({
        "training:optimizer_opts.lr": {"_type": "loguniform", "_value": [1e-3, 1e-2]}})
    summary = tsearch.hp_search_over_nas(
        (8, 8, 3), load_yaml(CHOICE_HEAD_YML), _train_hp(tmp_path, epochs=2), "cross_entropy",
        data, space, algorithm="darts", tuner="random", max_trials=2, seed=5,
        output_dir=tmp_path / "hp_over_nas", device="cpu")
    jspace = jhp.HyperparameterSpace.from_nni_json(space.to_nni_json())
    r = np.random.default_rng(5)
    assert [t["params"] for t in summary["trials"]] == [jspace.sample(r) for _ in range(2)]
    assert len(summary["architectures"]) == 2
    best = summary["best"]
    assert best["value"] is not None and best["architecture"]["m1"] in (0, 1)
    assert best["architecture"] == summary["architectures"][best["trial"]]


def test_scaling_prediction_trial_starts_every_subset_from_the_same_weights(tmp_path):
    data = _tiny_data(n=256)
    m = DeepcvModule((8, 8, 3), load_yaml(
        "act_fn: relu\narchitecture:\n  - conv2d: {kernel_size: [3,3], out_channels: 8, "
        "padding: 1}\n  - flatten: {}\n  - fully_connected: {out_features: 4, act_fn: null}"),
        device="cpu")
    start = copy.deepcopy(m.state_dict())
    hp = _train_hp(tmp_path, batch_size=16, optimizer_opts={"lr": 3e-3})
    out = tsearch.scaling_prediction_trial(m, "cross_entropy", data, hp,
                                           subset_fractions=(0.1, 0.2, 0.4, 0.6))
    assert len(out["observations"]) == 4 and 0.0 <= out["predicted_error"] <= 1.5
    assert [o["trainset_size"] for o in out["observations"]] == \
        [round(f * len(data["trainset"])) for f in (0.1, 0.2, 0.4, 0.6)]
    # a second call from the start weights gives the same errors: every
    # subset's run starts from the weights the call began with
    m.load_state_dict(start)
    again = tsearch.scaling_prediction_trial(m, "cross_entropy", data, hp,
                                             subset_fractions=(0.1, 0.2, 0.4, 0.6))
    assert again["observations"] == out["observations"]


def test_generalization_fit_and_hp_embedding_match_jax():
    ms = np.asarray([1e4, 1e4, 1e5, 1e5, 1e6, 1e6])
    ns = np.asarray([500, 5000, 500, 5000, 500, 5000])
    true = 2.0 * ns ** -0.4 + 1.5 * ms ** -0.3 + 0.05
    tp = tsearch.GeneralizationAcrossScalesPredictor().fit(ms, ns, true)
    jp = jsearch.GeneralizationAcrossScalesPredictor().fit(ms, ns, true)
    np.testing.assert_allclose(tp.params, jp.params, rtol=NUM_TOL)
    assert tp.predict(1e6, 50000) == pytest.approx(jp.predict(1e6, 50000), rel=NUM_TOL)
    with pytest.raises(ValueError):
        tsearch.GeneralizationAcrossScalesPredictor().fit([1], [1], [1])
    space_t, space_j = thp.HyperparameterSpace.from_nni_json(SPACE), \
        jhp.HyperparameterSpace.from_nni_json(SPACE)
    samples = [space_j.sample(np.random.default_rng(s)) for s in range(5)] + [{}]
    enc = np.stack([temb.encode_hp_sample(space_t, s) for s in samples])
    np.testing.assert_array_equal(enc, np.stack([jemb.encode_hp_sample(space_j, s)
                                                 for s in samples]))
    assert temb.encoding_size(space_t) == jemb.encoding_size(space_j) == enc.shape[1]
    jmod = jemb.HyperparamsEmbedding(embedding_size=16, hidden_size=32)
    jv = jmod.init(jax.random.PRNGKey(0), jnp.asarray(enc))
    ref = np.asarray(jmod.apply(jv, jnp.asarray(enc)))
    tmod = temb.HyperparamsEmbedding(enc.shape[1], 16, 32, device="cpu")
    load_jax_variables(tmod, _np_tree(jv))
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(enc)).numpy(), ref, atol=NUM_TOL, rtol=0)
    out, mod = temb.HyperparamsEmbedding.embed(space_t, samples, embedding_size=8, device="cpu")
    assert out.shape == (6, 8) and torch.isfinite(out).all()
    w = mod.fc1.weight
    assert w.std().item() == pytest.approx((1.0 / enc.shape[1]) ** 0.5, rel=0.3)


# --------------------------------------------------------------------------- #
# runtime_lr, train_arch_params, the LR finder
# --------------------------------------------------------------------------- #

def test_unported_hp_no_longer_holds_the_search_keys():
    assert "runtime_lr" not in training.UNPORTED_HP
    assert "train_arch_params" not in training.UNPORTED_HP
    # five since the data plane took wire_compression out too
    assert len(training.UNPORTED_HP) == 5


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_runtime_lr_trains_bit_equal_to_off(optimizer, tmp_path):
    data = _tiny_data()
    states = []
    for runtime_lr in (False, True):
        m = DeepcvModule((8, 8, 3), load_yaml(CHOICE_HEAD_YML), nas_mode="supernet",
                         device="cpu")
        training.train(_train_hp(tmp_path, runtime_lr=runtime_lr, optimizer=optimizer,
                                 optimizer_opts={"lr": 1e-2, "momentum": 0.9}
                                 if optimizer == "sgd" else {"lr": 1e-2},
                                 scheduler="one_cycle" if optimizer == "sgd" else None),
                       m, "cross_entropy", data)
        states.append(m.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("sampling", ["softmax", "sampled"])
def test_train_arch_params_false_leaves_the_logits_bit_unchanged(sampling, tmp_path):
    data = _tiny_data()
    m = DeepcvModule((8, 8, 3), load_yaml(NESTED_YML), nas_mode="supernet",
                     nas_sampling=sampling, device="cpu")
    with torch.no_grad():
        m.arch_parameters()["inner/m1"].copy_(torch.tensor([0.3, -0.2]))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    training.train(_train_hp(tmp_path, train_arch_params=False, gradient_clip_norm=0.5,
                             optimizer_opts={"lr": 1e-2, "weight_decay": 0.1}),
                   m, "cross_entropy", data)
    after = m.state_dict()
    assert torch.equal(after["module.nodes.inner.arch__m1"], before["module.nodes.inner.arch__m1"])
    assert not torch.equal(after["module.nodes.inner.nodes.m1_cand0.op.weight"],
                           before["module.nodes.inner.nodes.m1_cand0.op.weight"])


def test_train_arch_params_false_clips_over_the_other_parameters(tmp_path):
    """One SGD step with the clip: the update of every other parameter is the
    gradient scaled by min(1, c / |g|) over the non-arch gradients only, as
    the JAX mask chain clips inside the mask."""
    data = _tiny_data()
    hp = load_yaml(CHOICE_HEAD_YML)
    m = DeepcvModule((8, 8, 3), hp, nas_mode="supernet", device="cpu")
    with torch.no_grad():
        m.arch_parameters()["m1"].copy_(torch.tensor([3.0, -3.0]))
    ref = copy.deepcopy(m)
    lr, clip = 0.1, 1e-3
    hp_t = _train_hp(tmp_path, train_arch_params=False, gradient_clip_norm=clip, optimizer="sgd",
                     optimizer_opts={"lr": lr}, epochs=1, batch_size=len(data["trainset"]),
                     validate_every_epochs=100)
    training.train(hp_t, m, "cross_entropy", data)
    # the same first batch on the reference copy
    perm = training.epoch_permutation(5, 0, len(data["trainset"]))
    raw = torch.from_numpy(data["trainset"].dataset.images)[perm]
    y = torch.from_numpy(data["trainset"].dataset.targets)[perm].long()
    x = data["trainset"].batch_transform(raw, generator=training.step_generator(5, 0, "cpu"))
    F.cross_entropy(ref(x), y).backward()
    grads = {n: p.grad for n, p in ref.named_parameters() if "arch__" not in n}
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads.values()]))
    assert norm > 10 * clip
    got = dict(m.named_parameters())
    for n, p in ref.named_parameters():
        want = p.detach() if "arch__" in n else p.detach() - lr * grads[n] * (clip / norm)
        np.testing.assert_allclose(got[n].detach().numpy(), want.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=n)


def test_lr_finder_matches_jax_over_the_first_steps(tmp_path):
    """The same init (JAX's, carried across), the same batches: the losses of
    the sweep within 1e-4 over its first steps; the suggestion's structure;
    the model restored afterwards; the curve written."""
    hp = load_yaml(CHOICE_HEAD_YML)
    jdata, tdata = _tiny_data(jax_side=True), _tiny_data()
    jm = JaxModule((8, 8, 3), hp)
    jres = jax_lr_range_test(jm, "cross_entropy", jdata["trainset"], batch_size=16,
                             num_steps=12, min_lr=1e-4, max_lr=1.0, seed=0)
    tm = DeepcvModule((8, 8, 3), hp, device="cpu")
    load_jax_variables(tm, _np_tree(jm.init(jax.random.PRNGKey(0))))
    start = copy.deepcopy(tm.state_dict())
    tres = run_lr_range_test(tm, "cross_entropy", tdata["trainset"], batch_size=16,
                             num_steps=12, min_lr=1e-4, max_lr=1.0, seed=0)
    n = min(len(jres["losses"]), len(tres["losses"]), 8)
    assert n >= 5
    np.testing.assert_allclose(tres["losses"][:n], jres["losses"][:n], atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(tres["lrs"][:n], jres["lrs"][:n], rtol=1e-6)
    assert set(tres) == set(jres) and set(tres["suggested"]) == {"base_lr", "max_lr"}
    assert all(torch.equal(v, start[k]) for k, v in tm.state_dict().items())
    from deepcv_tpu_torch.train.lr_finder import find_optimal_params, plot_search_curves
    assert find_optimal_params(tres["lrs"], tres["smoothed"]) == \
        {k: tres[k] for k in ("best_lr", "suggested")}
    assert plot_search_curves(tres, tmp_path / "curve.png").exists()


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #

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


def test_cli_search_and_lr_find_on_a_tiny_project(tmp_path, monkeypatch, capsys):
    root = _tiny_cifar_project(tmp_path / "proj")
    monkeypatch.chdir(tmp_path)
    space = tmp_path / "space.json"
    space.write_text(json.dumps({
        "model:dropout_prob": {"_type": "uniform", "_value": [0.0, 0.5]},
        "training:optimizer_opts.lr": {"_type": "loguniform", "_value": [1e-4, 1e-2]},
        "training:epochs": {"_type": "choice", "_value": [1]}}))
    rc = cli_main(["search", "--pipeline", "train_image_classifier", "--space", str(space),
                   "--trials", "2", "--tuner", "random", "--project-path", str(root),
                   "--device", "cpu", "--output-dir", str(tmp_path / "hp"),
                   "--params", "train_image_classifier.batch_size:16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["trials"] == 2 and len(out["trial_seconds"]) == 2
    assert out["best_params"]["training:epochs"] == 1
    assert all(0.0 <= v <= 1.0 for v in out["trial_values"])
    summary = json.loads((tmp_path / "hp" / "summary.json").read_text())
    assert summary["best"]["value"] == out["best_value"]
    runs = sorted(p.name for p in (tmp_path / "data" / "04_training" / "experiments" /
                                   "train_image_classifier").iterdir())
    assert any(r.startswith("hp_0") for r in runs) and any(r.startswith("hp_1") for r in runs)
    assert cli_main(["search", "--space", str(tmp_path / "missing.json"),
                     "--project-path", str(root), "--device", "cpu"]) == 2
    capsys.readouterr()
    rc = cli_main(["lr-find", "--pipeline", "train_image_classifier", "--steps", "6",
                   "--batch-size", "8", "--project-path", str(root), "--device", "cpu",
                   "--out", str(tmp_path / "lr.png")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["steps"] == 6 and out["best_lr"] > 0
    assert os.path.exists(out["curve"])


def test_default_space_path_finds_the_conf_space():
    from deepcv_tpu.cli import _default_space_path as jax_default
    from deepcv_tpu_torch.cli import _default_space_path
    for pipeline in ("train_image_classifier", "train_nothing"):
        assert _default_space_path(REPO, pipeline) == jax_default(REPO, pipeline)
    assert _default_space_path(REPO, "train_image_classifier").exists()

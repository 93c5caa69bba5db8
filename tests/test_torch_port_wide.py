"""The wide classifiers (``train_wide_classifier``, ``_gn``, ``_ws``) and
hp ``weight_norm`` in the port against the JAX package, on the CPU: the
three models with JAX's own weights carried across by
``deepcv_tpu_torch.interop`` (forward and first-step gradients, parameter
counts), flax's ``WeightNorm`` on each op kind the port wraps, ResNet-50's
weight-norm pairing (bench.py config 9), the refusals, and the three
pipelines end to end through the port's ``run``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml

from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec.zoo import resnet_spec as jax_resnet_spec
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines.classification import get_pipelines
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.creators import CreatorContext, _as_layer
from deepcv_tpu_torch.spec.graph import SpecError
from deepcv_tpu_torch.spec.zoo import resnet_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
WN_OP_TOL = 1e-5      # one weight-normed op against flax's, both in f32
MODELS = ("wide_classifier_model", "wide_classifier_gn_model", "wide_classifier_ws_model")
#: the port's counts: the JAX package's less the 5 padded stem rows, 3*3*5*64
#: = 2,880 (1,191,050 with batch or group norm, 1,190,164 with weight norm)
CAPACITIES = {"wide_classifier_model": 1_188_170, "wide_classifier_gn_model": 1_188_170,
              "wide_classifier_ws_model": 1_187_284}
CONVS = 6             # the stride-1 3x3 convs of each, all in K2


def _hp(key, num_classes=10, act_fn=None):
    hp = dict(load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))[key])
    hp["architecture"][-1]["fully_connected"]["out_features"] = num_classes
    if act_fn:
        hp["act_fn"] = act_fn
    return hp


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _move_batch_stats(v, seed):
    """Every batch-stats leaf moved off its init value, so eval-mode batch
    norm is exercised."""
    rng = np.random.default_rng(seed)

    def move(d):
        for k, x in d.items():
            if isinstance(x, dict):
                move(x)
            elif k == "mean":
                d[k] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
            elif k == "var":
                d[k] = rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
    move(v.get("batch_stats", {}))
    return v


def _stem(v):
    return v["params"]["node_impls__submodule_0_conv2d"]["op"]


def _zero_padded_stem_rows(v):
    op = _stem(v)
    kernel = op["layer_instance"]["kernel"] if "layer_instance" in op else op["kernel"]
    kernel[:, :, 3:, :] = 0.0
    return v


def _pair(key, seed=1, zero_padded_rows=False, act_fn=None):
    jm = JaxModule((32, 32, 3), _hp(key, act_fn=act_fn))
    jv = _move_batch_stats(_numpy(jm.init(jax.random.PRNGKey(seed))), seed)
    if zero_padded_rows:
        _zero_padded_stem_rows(jv)
    tm = DeepcvModule((32, 32, 3), _hp(key, act_fn=act_fn), device="cpu").eval()
    load_jax_variables(tm, jv)
    return jm, jv, tm


# --------------------------------------------------------------------------- #
# The three models
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("key", MODELS)
def test_wide_model_builds_with_six_k2_convs_and_the_published_count(key):
    m = DeepcvModule((32, 32, 3), _hp(key), device="meta")
    convs = [mod for mod in m.modules() if isinstance(mod, dnn.FusedConv2d)]
    assert len(convs) == CONVS and all(c.act == "leaky_relu" for c in convs)
    assert [c.weight.shape[0] for c in convs] == [64, 64, 128, 128, 256, 256]
    wn = key.endswith("_ws_model")
    ops = [mod for mod in m.modules() if isinstance(mod, (dnn.Conv2d, dnn.Dense))]
    assert all((op.scale is not None) == wn for op in ops) and len(ops) == CONVS + 1
    if wn:
        assert {op.weight_norm_eps for op in ops} == {1e-6}
    assert m.capacity() == CAPACITIES[key]
    assert m.output_shape == (1, 10)


@pytest.mark.parametrize("key", MODELS)
def test_wide_model_forward_matches_jax(key):
    """Eval mode, batch statistics moved off init; weight norm on JAX's own
    init, whose padded stem rows are not zero, so the fold in ``interop``
    carries their share of the norm."""
    jm, jv, tm = _pair(key)
    if key.endswith("_ws_model"):
        kernel = _stem(jv)["layer_instance"]["kernel"]
        assert np.abs(kernel[:, :, 3:, :]).max() > 0.01
        assert not np.allclose(tm.module.nodes["_submodule_0_conv2d"].op.scale.detach(), 1.0)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=FWD_TOL, rtol=0)
    assert ref.std() > 1e-3


def test_weight_norm_fold_is_what_makes_the_stem_match():
    """Without the fold (the kept rows alone, scale as JAX has it) the WN
    model's output differs from JAX's by far more than the bound."""
    jm, jv, tm = _pair("wide_classifier_ws_model")
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        tm.module.nodes["_submodule_0_conv2d"].op.scale.fill_(1.0)
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() > 100 * FWD_TOL


@pytest.mark.parametrize("key", MODELS)
def test_wide_model_first_step_gradients_match_jax(key):
    """Train mode (batch norm on the batch's statistics); the padded stem
    rows zeroed in the JAX variables, so that under weight norm they take no
    part in the norm there either (see ``interop``). The conf's leaky_relu
    is swapped for silu, its smooth counterpart, here: with ~1.8 M
    pre-activations, one that lies within float32 rounding of zero takes
    slope 1 in one package and 0.01 in the other, which moves a weight's
    gradient by up to 1e-2 of its largest entry (the JAX package's own
    float32 gradients differ from its float64 ones that much), where with
    silu both stay within 1e-5 of float64."""
    jm, jv, tm = _pair(key, seed=2, zero_padded_rows=True, act_fn="silu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,))
    stats = {k: v for k, v in jv.items() if k != "params"}

    def loss_fn(params):
        out = jm.apply({"params": params, **stats}, jnp.asarray(x), train=True)
        logits = out[0] if stats else out
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jv["params"])
    tm.train()
    tloss = F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y).long())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    ref = jax_to_torch_state_dict({"params": _numpy(jgrads), **stats}, tm)
    grads = dict(tm.named_parameters())
    assert set(grads) <= set(ref)
    for k, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------- #
# Weight norm on each op kind, against flax's WeightNorm
# --------------------------------------------------------------------------- #

#: (port op class, spec entry, input shape NHWC): a stride-1 'same' conv (K2's
#: FusedConv2d), a strided conv (F.conv2d) and a dense over the flattened map
WN_OPS = {
    "fused_conv": (dnn.FusedConv2d, {"conv2d": {"kernel_size": [3, 3], "out_channels": 12,
                                                "padding": 1}}),
    "strided_conv": (dnn.Conv2d, {"conv2d": {"kernel_size": [3, 3], "out_channels": 12,
                                             "stride": 2, "padding": 1}}),
    "dense": (dnn.Dense, {"fully_connected": {"out_features": 5, "flatten_input": True}}),
}


@pytest.mark.parametrize("scale", ["init", "drawn"])
@pytest.mark.parametrize("kind", sorted(WN_OPS))
def test_weight_norm_op_matches_flax(kind, scale):
    """One weight-normed op of each kind, built by both packages from the
    same spec (eps 1e-6): the port's forward equals flax's ``WeightNorm``,
    at its unit init and with a drawn scale; the scale alone moves it."""
    cls, entry = WN_OPS[kind]
    hp = {"act_fn": "relu", "weight_norm": {"eps": 1e-6}, "architecture": [entry]}
    jm = JaxModule((6, 6, 8), hp)
    jv = _numpy(jm.init(jax.random.PRNGKey(3)))
    op_vars = jv["params"]["node_impls__submodule_0_" + next(iter(entry))]["op"]
    (scale_key,) = [k for k in op_vars if k.endswith("/scale")]
    assert np.all(op_vars[scale_key] == 1.0)
    x = np.random.default_rng(4).normal(size=(3, 6, 6, 8)).astype(np.float32)
    unit = np.asarray(jm.apply(jv, jnp.asarray(x)))
    if scale == "drawn":
        op_vars[scale_key] = np.random.default_rng(5).uniform(
            0.2, 3.0, op_vars[scale_key].shape).astype(np.float32)
    tm = DeepcvModule((6, 6, 8), hp, device="cpu")
    load_jax_variables(tm, jv)
    (op,) = [m for m in tm.modules() if isinstance(m, (dnn.Conv2d, dnn.Dense))]
    assert type(op) is cls and op.weight_norm_eps == 1e-6
    ref = np.asarray(jm.apply(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=WN_OP_TOL * max(1.0, np.abs(ref).max()), rtol=0)
    assert (np.abs(ref - unit).max() > 0.1) == (scale == "drawn")


def test_weight_norm_is_flax_l2_normalize_per_output_feature():
    """The function itself: flax's formula on a (Cout, Cin, kh, kw) weight,
    eps inside the rsqrt, per output filter, the scale by filter."""
    rng = np.random.default_rng(6)
    v = rng.normal(size=(4, 3, 3, 3)).astype(np.float32) * 1e-3
    g = rng.uniform(0.5, 2.0, size=(4,)).astype(np.float32)
    eps = 1e-6
    got = dnn.weight_norm(torch.from_numpy(v), torch.from_numpy(g), eps).numpy()
    norm = np.sqrt((v.astype(np.float64) ** 2).sum((1, 2, 3), keepdims=True) + eps)
    np.testing.assert_allclose(got, v / norm * g[:, None, None, None], rtol=1e-5)
    assert not np.allclose(got, v / np.sqrt((v ** 2).sum((1, 2, 3), keepdims=True))
                           * g[:, None, None, None], rtol=1e-3)   # eps counts here


def test_resnet50_weight_norm_pairing_matches_jax():
    """bench.py config 9's pairing: ``norm: None`` with ``weight_norm`` —
    53 convs and the head weight-normed, the strided 7x7 stem with its
    padded rows folded."""
    kw = dict(width=8, num_classes=10, pool_kernel=1, norm=None)
    hp = dict(resnet_spec(50, **kw), weight_norm={"eps": 1e-6})
    jhp = dict(jax_resnet_spec(50, **kw), weight_norm={"eps": 1e-6})
    jm = JaxModule((32, 32, 3), jhp)
    jv = _numpy(jm.init(jax.random.PRNGKey(7)))
    tm = DeepcvModule((32, 32, 3), hp, device="cpu").eval()
    load_jax_variables(tm, jv)
    ops = [m for m in tm.modules() if isinstance(m, (dnn.Conv2d, dnn.Dense))]
    assert len(ops) == 54 and all(op.scale is not None for op in ops)
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=FWD_TOL * max(1.0, np.abs(ref).max()), rtol=0)


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #

_CONV = [{"conv2d": {"kernel_size": [3, 3], "out_channels": 4}}]


@pytest.mark.parametrize("extra", [
    {"spectral_norm": {"n_power_iterations": 1}},
    {"spectral_norm": {"n_power_iterations": 1}, "weight_norm": {"eps": 1e-6}},
    {"weight_norm": True},
], ids=["spectral_norm", "spectral_and_weight_norm", "weight_norm_not_a_mapping"])
def test_unported_or_malformed_reparameterisations_raise(extra):
    with pytest.raises(SpecError, match="spectral_norm|weight_norm"):
        DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": _CONV, **extra},
                     device="meta")


def test_an_op_that_cannot_take_weight_norm_raises_naming_its_submodule():
    ctx = CreatorContext(hp={}, weight_norm={"eps": 1e-6})
    with pytest.raises(SpecError, match="'probe'.*Identity"):
        _as_layer(dnn.Identity(), {}, ctx, "probe", 4, 4)


def test_nested_modules_take_the_models_weight_norm():
    inner = [{"conv2d": {"kernel_size": [3, 3], "out_channels": 4}}]
    hp = {"act_fn": "relu", "weight_norm": {"eps": 1e-6}, "architecture": [
        {"_nested_deepcvmodule": inner}, {"flatten": {}},
        {"fully_connected": {"out_features": 3}}]}
    jm = JaxModule((6, 6, 8), hp)
    jv = _numpy(jm.init(jax.random.PRNGKey(9)))
    tm = DeepcvModule((6, 6, 8), hp, device="cpu")
    load_jax_variables(tm, jv)
    assert sum(m.scale is not None for m in tm.modules()
               if isinstance(m, (dnn.Conv2d, dnn.Dense))) == 2
    x = np.random.default_rng(10).normal(size=(2, 6, 6, 8)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.apply(jv, jnp.asarray(x))), atol=FWD_TOL)


# --------------------------------------------------------------------------- #
# The pipelines through run
# --------------------------------------------------------------------------- #

PIPELINES = ("train_wide_classifier", "train_wide_classifier_gn", "train_wide_classifier_ws")


def test_the_port_has_the_three_wide_pipelines():
    pipes = get_pipelines()
    for name in PIPELINES:
        assert [n.name for n in pipes[name].nodes] == ["preprocess", "create_model", "train"]
        inputs = [i for n in pipes[name].nodes for i in n.inputs]
        assert "cifar10_train" in inputs and "params:cifar10_preprocessing" in inputs
        assert "params:train_wide_classifier" in inputs
        model_key = "wide_classifier" + name[len("train_wide_classifier"):] + "_model"
        assert f"params:{model_key}" in inputs


@pytest.fixture(scope="module")
def cifar_project(tmp_path_factory):
    """A project whose conf is the repo's, with the CIFAR-10 catalog entries
    cut to 20 + 8 synthetic 32x32 images of 10 classes."""
    root = tmp_path_factory.mktemp("wide_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    entry = {"type": "synthetic", "image_shape": [32, 32, 3], "num_classes": 10}
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "cifar10_train": {**entry, "n": 20},
        "cifar10_test": {**entry, "n": 8, "train": False}}))
    return root


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_wide_pipeline_runs_end_to_end_on_cpu(pipeline, cifar_project, tmp_path):
    """The conf's model and hp (bfloat16 under autocast, AdamW,
    ``deterministic``, ``device_resident_dataset``), cut to one epoch at
    batch 4 with no checkpoints."""
    hp = "train_wide_classifier"
    store = cli_run([f"--pipeline={pipeline}", "--project-path", str(cifar_project),
                     "--device", "cpu", "--params",
                     f"{hp}.epochs:1,{hp}.batch_size:4,{hp}.save_every_iters:0,"
                     f"{hp}.output_path:{tmp_path}"])
    h = store["train_results"]["history"]
    n_train = len(store["datasets"]["trainset"])
    assert h["steps"] == n_train // 4 > 0
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert h["valid"] and 0 <= h["valid"][-1]["valid_accuracy"] <= 1
    model = store["model"]
    assert model.device.type == "cpu" and model.capacity() == CAPACITIES[
        "wide_classifier" + pipeline[len("train_wide_classifier"):] + "_model"]
    assert store["context"].params(f"{hp}.dtype") == "bfloat16"
    scales = [m.scale for m in model.modules() if isinstance(m, (dnn.Conv2d, dnn.Dense))
              and m.scale is not None]
    assert len(scales) == (CONVS + 1 if pipeline.endswith("_ws") else 0)
    assert all(not torch.all(s == 1.0) for s in scales)     # trained

"""The rest of the CNN zoo in the port (MobileNetV2, MobileNetV3,
EfficientNet-B0, DenseNet, ConvNeXt) against the JAX package, on the CPU:
the builders' dicts, the parameter counts (torchvision's, and the JAX
models' less their padded stem rows), forward parity in eval and one
train-mode forward with the JAX variables carried across by
``deepcv_tpu_torch.interop``, EfficientNet-B0's first-step gradients,
``squeeze_cell`` and ``ConvNeXtBlock`` alone, ``create_model``'s refusals,
which activations reach K2's epilogue, and the four pipelines end to end
through the port's ``run``.

The JAX variables are drawn with numpy into the shapes of
``jax.eval_shape(init)`` and the JAX forward is jitted: flax's init and an
eager forward of these models take tens of seconds each on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml

from deepcv_tpu.pipelines.classification import create_model as jax_create_model
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec import zoo as jax_zoo
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines.classification import (
    PORTED_ZOO, UNPORTED_ZOO, create_model, get_pipelines)
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: relative to max|ref|: both forwards in float32, sums in another order
#: (the forward bound of tests/test_torch_parity.py)
FWD_TOL = 1e-4
GRAD_RTOL = 1e-3      # the first-step gradient bound of tests/test_torch_parity.py

BUILDERS = {"mobilenet_v2": "mobilenet_v2_spec", "mobilenet_v3": "mobilenet_v3_spec",
            "efficientnet_b0": "efficientnet_b0_spec", "densenet": "densenet_spec",
            "convnext": "convnext_spec"}


def _both(family, **kw):
    """(port dict, JAX dict) of one builder for the same arguments."""
    name = BUILDERS[family]
    return getattr(zoo, name)(**kw), getattr(jax_zoo, name)(**kw)


# --------------------------------------------------------------------------- #
# (a) the builders
# --------------------------------------------------------------------------- #

BUILDER_GRID = [
    ("mobilenet_v2", {}), ("mobilenet_v2", {"width_mult": 0.5, "num_classes": 10}),
    ("mobilenet_v2", {"width_mult": 1.4, "norm": "group_norm", "dropout": 0.0}),
    ("mobilenet_v2", {"norm": None, "pool_kernel": 1}),
    ("mobilenet_v3", {}), ("mobilenet_v3", {"variant": "small"}),
    ("mobilenet_v3", {"variant": "large", "width_mult": 0.5, "norm": None}),
    ("mobilenet_v3", {"variant": "small", "width_mult": 0.75, "norm": "group_norm"}),
    ("efficientnet_b0", {}), ("efficientnet_b0", {"norm": "group_norm", "dropout": 0.0}),
    ("efficientnet_b0", {"norm": None, "pool_kernel": 1, "num_classes": 7}),
    ("densenet", {}), ("densenet", {"depth": 169}), ("densenet", {"depth": 201}),
    ("densenet", {"depth": 121, "norm": "group_norm", "pool_kernel": 1}),
    ("densenet", {"norm": None}),
    ("convnext", {}), ("convnext", {"variant": "small"}), ("convnext", {"variant": "base"}),
    ("convnext", {"variant": "large", "stochastic_depth": 0.3}),
    ("convnext", {"norm": "rms_norm", "pool_kernel": 1, "stochastic_depth": 0.0}),
]


@pytest.mark.parametrize("family,kw", BUILDER_GRID,
                         ids=[f"{f}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for f, kw in BUILDER_GRID])
def test_builder_returns_the_jax_builders_dict(family, kw):
    port, ref = _both(family, **kw)
    assert port == ref


@pytest.mark.parametrize("family,kw", [("mobilenet_v3", {"variant": "medium"}),
                                       ("densenet", {"depth": 100}),
                                       ("convnext", {"variant": "huge"})])
def test_builder_refuses_what_the_jax_builder_refuses(family, kw):
    name = BUILDERS[family]
    with pytest.raises(ValueError) as ref:
        getattr(jax_zoo, name)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(zoo, name)(**kw)
    assert str(got.value) == str(ref.value)


# --------------------------------------------------------------------------- #
# (b) parameter counts
# --------------------------------------------------------------------------- #

#: torchvision's counts at 1000 classes (as the JAX builders' docstrings
#: record them)
TORCHVISION = {("mobilenet_v2", ()): 3_504_872,
               ("mobilenet_v3", (("variant", "large"),)): 5_483_032,
               ("mobilenet_v3", (("variant", "small"),)): 2_542_856,
               ("efficientnet_b0", ()): 5_288_548,
               ("densenet", (("depth", 121),)): 7_978_856,
               ("densenet", (("depth", 169),)): 14_149_480,
               ("densenet", (("depth", 201),)): 20_013_928,
               ("convnext", (("variant", "tiny"),)): 28_589_128,
               ("convnext", (("variant", "small"),)): 50_223_688,
               ("convnext", (("variant", "base"),)): 88_591_464,
               ("convnext", (("variant", "large"),)): 197_767_336}
#: the JAX package pads the 3-channel stem's input to 8: the rows the port
#: does not have, kh * kw * 5 * Cout (ConvNeXt's stem is a Dense: none)
PAD_ROWS = {"mobilenet_v2": 9 * 5 * 32, "mobilenet_v3": 9 * 5 * 16,
            "efficientnet_b0": 9 * 5 * 32, "densenet": 49 * 5 * 64, "convnext": 0}


def _jax_shapes(hp, input_hw=32):
    jm = JaxModule((input_hw, input_hw, 3), hp)
    return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("family,kw", sorted(TORCHVISION),
                         ids=[f"{f}-{'-'.join(str(v) for _, v in kw)}" for f, kw in
                              sorted(TORCHVISION)])
def test_parameter_count_is_torchvisions(family, kw):
    port, _ = _both(family, **dict(kw))
    assert DeepcvModule((224, 224, 3), port, device="meta").capacity() == \
        TORCHVISION[(family, kw)]


@pytest.mark.parametrize("family", sorted(BUILDERS))
def test_parameter_count_is_the_jax_models_less_its_padded_stem_rows(family):
    """One variant a family: the default (MobileNetV3-Large, DenseNet-121,
    ConvNeXt-Tiny); the count does not depend on the input size."""
    port, ref = _both(family, pool_kernel=1)
    _, shapes = _jax_shapes(ref)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_port = DeepcvModule((32, 32, 3), port, device="meta").capacity()
    assert n_port == n_jax - PAD_ROWS[family]


# --------------------------------------------------------------------------- #
# (c) (d) (e) forward parity, a train-mode forward, first-step gradients
# --------------------------------------------------------------------------- #

def _draw(shapes, seed):
    """Variables for the shapes of a JAX init, drawn with numpy: kernels
    normal with variance 1 / fan-in, scales (norms, layer scale) in [0.5,
    1.5), biases and running means small, running variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name or "var" in name or "layer_scale" in name:
            a = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(family, seed=0, **kw):
    """The JAX model with drawn variables and the port's model of the same
    dict with them loaded, 32x32 input, 10 classes, ``pool_kernel`` 1."""
    port_hp, ref_hp = _both(family, num_classes=10, pool_kernel=1, **kw)
    jm, shapes = _jax_shapes(ref_hp)
    jv = _draw(shapes, seed)
    tm = DeepcvModule((32, 32, 3), port_hp, device="cpu")
    load_jax_variables(tm, jv)
    return jm, jv, tm


def _images(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


FORWARD_CASES = [("mobilenet_v2", {"width_mult": 0.5}),
                 ("mobilenet_v3", {"variant": "large", "width_mult": 0.5}),
                 ("mobilenet_v3", {"variant": "small", "width_mult": 0.5}),
                 ("efficientnet_b0", {}), ("densenet", {"depth": 121}),
                 ("convnext", {"variant": "tiny"})]


@pytest.mark.parametrize("family,kw", FORWARD_CASES,
                         ids=[f"{f}-{'-'.join(str(v) for v in kw.values())}"
                              for f, kw in FORWARD_CASES])
def test_forward_matches_jax(family, kw):
    """Eval mode, float32, every variable drawn (running statistics off
    their init, ConvNeXt's layer scale near 1, so each block's branch
    counts)."""
    jm, jv, tm = _pair(family, **kw)
    x = _images(1)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 10)
    assert ref.std() > 1e-2
    assert _rel(got, ref) <= FWD_TOL


@pytest.fixture(scope="module")
def efficientnet_train_step():
    """EfficientNet-B0 at full width, the head's dropout off, one train-mode
    step on 16 images of 32x32 in both packages: the JAX model, its
    variables, the port's model after its forward and backward, the images
    and labels. 16 images: the last stages' maps are 1x1, so batch norm
    takes its statistics over the batch alone, and over 4 images their
    float32 rounding is amplified to 3e-5 of the loss (both packages
    compute the variance as mean(x^2) - mean(x)^2)."""
    jm, jv, tm = _pair("efficientnet_b0", seed=3, dropout=0.0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,))
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    return jm, jv, tm, x, y, logits.detach().numpy(), loss.item()


def test_train_mode_batch_norm_forward_matches_jax(efficientnet_train_step):
    """Batch norm on the batch's statistics: the logits and every updated
    running mean and variance."""
    jm, jv, tm, x, _, logits, _ = efficientnet_train_step
    y, state = jax.jit(lambda v, xx: jm.apply(v, xx, train=True))(jv, jnp.asarray(x))
    assert _rel(logits, np.asarray(y)) <= FWD_TOL
    ref = jax_to_torch_state_dict({"params": jv["params"],
                                   **jax.tree_util.tree_map(np.asarray, dict(state))}, tm)
    stats = {k: v for k, v in tm.state_dict().items() if k.endswith(("running_mean",
                                                                     "running_var"))}
    assert len(stats) == 2 * 49
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_efficientnet_b0_first_step_gradients_match_jax(efficientnet_train_step):
    """The loss and every parameter's gradient, each within rtol 1e-3 and
    1e-3 of its tensor's largest entry: through 49 train-mode batch norms
    the entries near zero carry the others' float32 rounding (up to 5.5e-5
    of the largest). silu is smooth, so no pre-activation near a kink
    flips between the packages."""
    jm, jv, tm, x, y, _, tloss = efficientnet_train_step
    stats = {k: v for k, v in jv.items() if k != "params"}

    def loss_fn(params):
        logits, _ = jm.apply({"params": params, **stats}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jv["params"])
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                   **stats}, tm)
    grads = dict(tm.named_parameters())
    assert len(grads) > 200 and set(grads) <= set(ref)
    for k, p in grads.items():
        want = ref[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=k)


# --------------------------------------------------------------------------- #
# (f) the cells alone
# --------------------------------------------------------------------------- #

SE_CASES = {
    "default": ("relu", {}),                                    # relu inside, sigmoid gate
    "efficientnet": ("silu", {"reduction_ratio": 24}),          # the model's silu inside
    "mobilenet_v3": ("hard_swish", {"hidden_channels": 8, "act_fn": "relu",
                                    "gate_fn": "hard_sigmoid"}),
}


@pytest.mark.parametrize("case", sorted(SE_CASES))
def test_squeeze_cell_matches_jax(case):
    """One ``squeeze_cell`` after a conv, both packages from the same spec:
    the global ``act_fn`` reaches the cell unless the node pins its own,
    ``hidden_channels`` and ``gate_fn`` survive, the Denses are ``reduce``
    and ``expand``."""
    act, node = SE_CASES[case]
    hp = {"act_fn": act, "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 48, "padding": 1}},
        {"squeeze_cell": ["se", dict(node)]}]}
    jm, shapes = _jax_shapes(hp, input_hw=8)
    jv = _draw(shapes, 5)
    tm = DeepcvModule((8, 8, 3), hp, device="cpu")
    load_jax_variables(tm, jv)
    se = tm.module.nodes["se"]
    hidden = node.get("hidden_channels") or 48 // node.get("reduction_ratio", 4)
    assert tuple(se.reduce.weight.shape) == (hidden, 48)
    assert tuple(se.expand.weight.shape) == (48, hidden)
    assert se.act_fn is dnn.ACTIVATION_FNS[node.get("act_fn", act)]
    assert se.gate_fn is (dnn.ACTIVATION_FNS[node["gate_fn"]] if "gate_fn" in node
                          else torch.sigmoid)
    x = np.random.default_rng(6).normal(size=(3, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) <= FWD_TOL


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_convnext_block_matches_jax_with_drop_path_an_identity_in_eval(norm):
    """One ``convnext_block`` (drop path 0.5) on a 24-channel map: in eval
    the drop path is an identity and the block equals JAX's; in train mode
    whole samples lose the branch."""
    node = {"drop_path_prob": 0.5, **({"norm": norm} if norm != "layer_norm" else {})}
    hp = {"act_fn": "gelu_exact", "architecture": [
        {"conv2d": {"kernel_size": [1, 1], "out_channels": 24, "act_fn": None}},
        {"convnext_block": ["blk", node]}]}
    jm, shapes = _jax_shapes(hp, input_hw=9)
    jv = _draw(shapes, 7)
    tm = DeepcvModule((9, 9, 3), hp, device="cpu")
    load_jax_variables(tm, jv)
    blk = tm.module.nodes["blk"]
    assert isinstance(blk.ln, dnn.RMSNorm if norm == "rms_norm" else dnn.LayerNorm)
    assert blk.dwconv.groups == 24 and tuple(blk.dwconv.weight.shape) == (24, 1, 7, 7)
    x = np.random.default_rng(8).normal(size=(8, 9, 9, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
        assert _rel(got, ref) <= FWD_TOL
        trunk = tm.module.nodes["_submodule_0_conv2d"](torch.from_numpy(x).movedim(-1, 1))
        dropped = tm.train()(torch.from_numpy(x)).movedim(-1, 1)
    same = [torch.equal(dropped[i], trunk[i]) for i in range(8)]
    assert 0 < sum(same) < 8


# --------------------------------------------------------------------------- #
# (g) create_model
# --------------------------------------------------------------------------- #

_DATASETS = {"trainset": type("T", (), {"image_shape": (32, 32, 3), "num_classes": 5})()}
#: a valid value of every key some zoo builder takes
_KEYS = {"depth": 121, "width_mult": 0.5, "variant": None, "window": 7, "groups": 1,
         "width_per_group": 64, "norm": "batch_norm"}
_VARIANT = {"mobilenet_v3": "small", "convnext": "tiny"}


@pytest.mark.parametrize("key", sorted(_KEYS))
@pytest.mark.parametrize("family", sorted(BUILDERS))
def test_create_model_refuses_the_keys_the_jax_package_refuses(family, key):
    params = {"zoo": family, key: _KEYS[key] if key != "variant" else _VARIANT.get(family, "x")}
    try:
        jax_create_model(_DATASETS, params)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None:
        model = create_model(_DATASETS, params, device="meta")
        assert model.output_shape == (1, 5)
    else:
        with pytest.raises(ValueError) as got:
            create_model(_DATASETS, params, device="meta")
        assert str(got.value) == refused


def test_only_swin_is_left_unported():
    """Every zoo builder of the JAX package is ported: swin was the last
    (tests/test_torch_port_swin.py)."""
    assert UNPORTED_ZOO == ()
    assert set(PORTED_ZOO) == set(BUILDERS) | {"resnet", "vit", "swin"}


# --------------------------------------------------------------------------- #
# K2's epilogue in the zoo
# --------------------------------------------------------------------------- #

#: K2 convs per forward by epilogue activation (None: none in the epilogue;
#: DenseNet's relu runs before each conv)
K2_BY_ACT = {"mobilenet_v2": {"relu6": 17, None: 17},
             "mobilenet_v3": {"hard_swish": 10, "relu": 5, None: 15},
             "efficientnet_b0": {"silu": 16, None: 16},
             "densenet": {None: 119}, "convnext": {}}


@pytest.mark.parametrize("family", sorted(K2_BY_ACT))
def test_the_zoos_activations_run_in_k2s_epilogue(family):
    """Every stride-1 'same' conv of the family is a FusedConv2d whose
    activation the kernel applies by name: no separate activation pass."""
    port, _ = _both(family)
    m = DeepcvModule((224, 224, 3), port, device="meta")
    convs = [c for c in m.modules() if isinstance(c, dnn.FusedConv2d)]
    acts = {}
    for c in convs:
        assert c.act is None or isinstance(c.act, str)
        acts[c.act] = acts.get(c.act, 0) + 1
    assert acts == K2_BY_ACT[family]
    layers = [mod for mod in m.modules() if isinstance(mod, dnn.Layer)
              and isinstance(mod.op, dnn.FusedConv2d) and not mod.preactivation]
    assert all(layer.act_in_op for layer in layers)


# --------------------------------------------------------------------------- #
# (h) the pipelines through run
# --------------------------------------------------------------------------- #

PIPELINES = {"train_mobilenet_v2": ("mobilenet_v2_model.width_mult:0.25",),
             "train_mobilenet_v3": ("mobilenet_v3_model.width_mult:0.25",),
             "train_densenet": (),
             "train_convnext": ()}


def test_the_port_has_the_four_zoo_pipelines():
    """The four, and train_swin (run end to end in
    tests/test_torch_port_swin.py), each with train_resnet50's hp."""
    pipes = get_pipelines()
    for name in (*PIPELINES, "train_swin"):
        assert [n.name for n in pipes[name].nodes] == ["preprocess", "create_model", "train"]
        inputs = [i for n in pipes[name].nodes for i in n.inputs]
        assert "imagenet224_train" in inputs and "params:train_resnet50" in inputs
        assert f"params:{name[len('train_'):]}_model" in inputs
    assert "train_swin" in pipes


@pytest.fixture(scope="module")
def imagenet_project(tmp_path_factory):
    """A project whose conf is the repo's, with the imagenet224 catalog
    entries cut to 10 + 4 synthetic 32x32 images of 3 classes."""
    root = tmp_path_factory.mktemp("zoo_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    entry = {"type": "synthetic", "image_shape": [32, 32, 3], "num_classes": 3}
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "imagenet224_train": {**entry, "n": 10},
        "imagenet224_test": {**entry, "n": 4, "train": False}}))
    return root


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_zoo_pipeline_runs_end_to_end_on_cpu(pipeline, imagenet_project, tmp_path):
    """The conf's model (MobileNets at width 0.25) and ``train_resnet50``'s
    hp (SGD, bfloat16 under autocast), cut to one epoch at batch 4 with no
    checkpoints, 3 of the 10 images held out to validate; 32x32 images, so
    the global pool is 1x1."""
    hp = "train_resnet50"
    params = [*PIPELINES[pipeline], "imagenet224_preprocessing.split_dataset.validset_ratio:0.3",
              f"{hp}.epochs:1", f"{hp}.batch_size:4",
              f"{hp}.save_every_iters:0", f"{hp}.output_path:{tmp_path}"]
    store = cli_run([f"--pipeline={pipeline}", "--project-path", str(imagenet_project),
                     "--device", "cpu", "--params", ",".join(params)])
    h = store["train_results"]["history"]
    assert h["steps"] == len(store["datasets"]["trainset"]) // 4 > 0
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert h["valid"] and 0 <= h["valid"][-1]["valid_accuracy"] <= 1
    assert np.isfinite(list(h["valid"][-1].values())).all()
    model = store["model"]
    assert model.device.type == "cpu" and model.dtype == torch.bfloat16
    assert model.output_shape == (1, 3)

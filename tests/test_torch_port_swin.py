"""Swin in the port against the JAX package, on the CPU: the window helpers
(equal exactly), ``WindowAttention`` (shifted, unshifted and the clamp of
a map smaller than the window), ``SwinBlock`` and ``PatchMerging`` alone,
a tiny ``swin_spec`` model forward and first-step gradients with the JAX
variables carried across by ``deepcv_tpu_torch.interop``, the builder's
dicts and parameter counts, the refusals, and ``train_swin`` end to end
through the port's ``run``.

The JAX variables are drawn with numpy into the shapes of
``jax.eval_shape(init)``, so that the relative-position tables (0.02 at
init) and the norms' scales count in the comparison."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.ops import attention as jatt
from deepcv_tpu.pipelines.classification import create_model as jax_create_model
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec import zoo as jax_zoo
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import attention as tatt
from deepcv_tpu_torch.pipelines.classification import create_model
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: relative to max|ref|, both in float32: one block's sums in another order
BLOCK_TOL = 1e-5
#: the whole model's forward (the bound of tests/test_torch_parity.py)
FWD_TOL = 1e-4
GRAD_RTOL = 1e-3


def _draw(shapes, seed):
    """Variables for the shapes of a JAX init, drawn with numpy: kernels
    normal with variance 1 / fan-in, norm scales in [0.5, 1.5), the
    relative-position tables and biases normal with std 0.5 and 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name:
            a = rng.uniform(0.5, 1.5, size=s.shape)
        elif "rel_pos_bias" in name:
            a = 0.5 * rng.normal(size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _pair(hp, input_shape, seed):
    """The JAX model with drawn variables and the port's model of the same
    spec with them loaded."""
    jm = JaxModule(input_shape, hp)
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    tm = DeepcvModule(input_shape, hp, device="cpu")
    load_jax_variables(tm, jv)
    return jm, jv, tm


# --------------------------------------------------------------------------- #
# the window helpers and WindowAttention
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("w", [1, 2, 4, 7])
def test_relative_position_index_is_the_jax_helpers(w):
    got = tatt._relative_position_index(w)
    np.testing.assert_array_equal(got, jatt._relative_position_index(w))
    assert got.shape == (w * w, w * w) and got.max() == (2 * w - 1) ** 2 - 1


@pytest.mark.parametrize("h,wid,w,shift", [(8, 8, 4, 2), (56, 56, 7, 3), (14, 28, 7, 3),
                                           (12, 8, 4, 1)])
def test_shift_attention_mask_is_the_jax_helpers(h, wid, w, shift):
    got = tatt._shift_attention_mask(h, wid, w, shift)
    np.testing.assert_array_equal(got, jatt._shift_attention_mask(h, wid, w, shift))
    assert got.dtype == np.float32 and set(np.unique(got)) == {0.0, np.float32(-1e9)}


def test_window_partition_and_reverse_are_the_jax_ones():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 3)).astype(np.float32)
    win = tatt._window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jatt._window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tatt._window_reverse(win, 4, 8, 12).numpy(), x)


def _load_window_attention(port, params):
    with torch.no_grad():
        for sub in ("qkv", "out"):
            getattr(port, sub).weight.copy_(torch.from_numpy(np.asarray(params[sub]["kernel"]).T))
            getattr(port, sub).bias.copy_(torch.from_numpy(np.asarray(params[sub]["bias"])))
        port.rel_pos_bias.copy_(torch.from_numpy(np.asarray(params["rel_pos_bias"])))


#: (map H, W, window, shift): shifted and unshifted windows of 4 on an 8x8
#: map, and a 4x4 map under a window of 7 (clamped to 4, shift dropped)
WINDOW_CASES = [(8, 8, 4, 0), (8, 8, 4, 2), (4, 4, 7, 3)]


@pytest.mark.parametrize("h,wid,window,shift", WINDOW_CASES)
def test_window_attention_matches_jax(h, wid, window, shift):
    c, nh = 16, 2
    jmod = jatt.WindowAttention(num_heads=nh, window=window, shift=shift)
    x = np.random.default_rng(1).normal(size=(3, h, wid, c)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _draw(shapes, 2)["params"]
    with torch.device("meta"):
        port = tatt.WindowAttention(c, (h, wid), nh, window, shift)
    port.to_empty(device="cpu")
    port.init_parameters(torch.Generator().manual_seed(0))
    _load_window_attention(port, params)
    w = min(window, h, wid)
    assert (port.window, port.shift) == (w, shift if w < min(h, wid) else 0)
    assert tuple(port.rel_pos_bias.shape) == ((2 * w - 1) ** 2, nh)
    index, mask = port.static_tensors(torch.device("cpu"))
    np.testing.assert_array_equal(index.numpy(), jatt._relative_position_index(w).reshape(-1))
    if port.shift:
        np.testing.assert_array_equal(mask.numpy(),
                                      jatt._shift_attention_mask(h, wid, w, port.shift))
    else:
        assert mask is None
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    assert _rel(got, ref) <= BLOCK_TOL


def test_the_shift_changes_the_output():
    """The shifted window sees other neighbours and the mask: a 2 x 2 shift
    changes every window's output."""
    c, nh = 16, 2
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 8, 8, c)).astype(np.float32))
    outs = []
    for shift in (0, 2):
        with torch.device("meta"):
            port = tatt.WindowAttention(c, (8, 8), nh, 4, shift)
        port.to_empty(device="cpu")
        port.init_parameters(torch.Generator().manual_seed(5))
        with torch.no_grad():
            outs.append(port(x))
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)


# --------------------------------------------------------------------------- #
# SwinBlock and PatchMerging through the spec
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("node", [
    {"num_heads": 2, "window": 4, "shift": 2},
    {"num_heads": 4, "window": 4, "shift": 0, "mlp_ratio": 2.0, "norm": "rms_norm"},
    {"num_heads": 2, "window": 9, "shift": 4, "ln_eps": 1e-6}])
def test_swin_block_matches_jax(node):
    """One ``swin_block`` on an 8x8 map of 16 channels (a window of 9
    clamps to the map and drops the shift), drop path 0.3 an identity in
    eval."""
    hp = {"act_fn": "gelu_exact",
          "architecture": [{"swin_block": ["blk", {**node, "drop_path_prob": 0.3}]}]}
    jm, jv, tm = _pair(hp, (8, 8, 16), 4)
    blk = tm.module.nodes["blk"]
    assert blk.mlp.fc1.weight.shape[0] == int(round(16 * node.get("mlp_ratio", 4.0)))
    x = np.random.default_rng(5).normal(size=(2, 8, 8, 16)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    assert _rel(got, ref) <= BLOCK_TOL


def test_patch_merging_matches_jax_in_torchs_concat_order():
    hp = {"act_fn": "gelu_exact", "architecture": [{"patch_merging": ["merge", {}]}]}
    jm, jv, tm = _pair(hp, (8, 6, 12), 6)
    merge = tm.module.nodes["merge"]
    assert tuple(merge.reduce.weight.shape) == (24, 48) and merge.reduce.bias is None
    x = np.random.default_rng(7).normal(size=(3, 8, 6, 12)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 4, 3, 24)
    assert _rel(got, ref) <= BLOCK_TOL
    # torch's order: the 4C vector is [x(2i, 2j), x(2i+1, 2j), x(2i, 2j+1), x(2i+1, 2j+1)]
    with torch.no_grad():
        merge.ln = torch.nn.Identity()
        merge.reduce.weight.copy_(torch.eye(24, 48))
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:, 1, 2, :12], x[:, 2, 4])
    np.testing.assert_array_equal(got[:, 1, 2, 12:], x[:, 3, 4])


# --------------------------------------------------------------------------- #
# a tiny swin_spec model
# --------------------------------------------------------------------------- #

def _tiny_swin(spec_fn, dim=16, heads=(1, 2, 2, 4), stage3=2):
    """swin_spec('t') at window 4, cut to width ``dim`` (stages dim to
    8 dim), ``heads`` per stage and ``stage3`` blocks in stage 3: on 32x32
    images the stages' maps are 8x8 (shifted windows of 4), 4x4 (the clamp),
    2x2 and 1x1."""
    hp = spec_fn("t", num_classes=5, window=4, stochastic_depth=0.0, pool_kernel=1)
    arch = []
    for entry in hp["architecture"]:
        (key, val), = entry.items()
        if key == "convnext_stem":
            val[1]["dim"] = dim
        if key == "swin_block":
            s, b = int(val[0][1]), int(val[0][3])
            if s == 2 and b >= stage3:
                continue
            val[1]["num_heads"] = heads[s]
        arch.append(entry)
    hp["architecture"] = arch
    return hp


@pytest.fixture(scope="module")
def tiny_swin():
    hp = _tiny_swin(zoo.swin_spec)
    assert hp == _tiny_swin(jax_zoo.swin_spec)
    return _pair(hp, (32, 32, 3), 8)


def test_tiny_swin_forward_matches_jax(tiny_swin):
    jm, jv, tm = tiny_swin
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 5)
    assert ref.std() > 1e-2
    assert _rel(got, ref) <= FWD_TOL


def test_tiny_swin_first_step_gradients_match_jax(tiny_swin):
    """The loss and every parameter's gradient (bias tables included), each
    within rtol 1e-3 and 1e-3 of its tensor's largest entry."""
    jm, jv, tm = tiny_swin
    rng = np.random.default_rng(10)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(4,))

    def loss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), train=False)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), y])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jv["params"])
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, tm)
    tm.train()
    for p in tm.parameters():
        p.grad = None
    tloss = torch.nn.functional.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref) and sum(k.endswith("rel_pos_bias") for k in got) == 8
    for key, want in ref.items():
        want = want.numpy()
        np.testing.assert_allclose(got[key].grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()) + 1e-8,
                                   err_msg=key)


def test_swin_bundle_saves_and_loads_with_equal_logits(tmp_path):
    """A bundle's model is built on the meta device and given its weights by
    ``load_state_dict``: the windows' static bias index and shift mask come
    back without ``init_parameters``, and the logits are the saved model's."""
    from deepcv_tpu_torch.serve import load_model_bundle, save_model_bundle

    model = DeepcvModule((32, 32, 3), _tiny_swin(zoo.swin_spec), device="cpu").eval()
    save_model_bundle(tmp_path / "bundle", model)
    loaded = load_model_bundle(tmp_path / "bundle", device="cpu")
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = model(x), loaded(x)
    assert got.shape == (2, 5) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_interop_keeps_the_bias_table_layout_and_refuses_unmapped_swin_leaves(tiny_swin):
    _, jv, tm = tiny_swin
    table = np.asarray(jv["params"]["node_impls_s0b1"]["attn"]["rel_pos_bias"])
    assert table.shape == (49, 1)
    sd = jax_to_torch_state_dict(jv, tm)
    np.testing.assert_array_equal(sd["module.nodes.s0b1.attn.rel_pos_bias"].numpy(), table)
    np.testing.assert_array_equal(
        sd["module.nodes.merge1.reduce.weight"].numpy(),
        np.asarray(jv["params"]["node_impls_merge1"]["reduce"]["kernel"]).T)
    for bad in ({"attn": {"rel_pos_table": table}}, {"attn": {"qkv": {"weird": table}}},
                {"rel_pos_bias": table}):
        with pytest.raises(KeyError):
            jax_to_torch_state_dict({"params": {"node_impls_s0b1": bad}}, tm)


# --------------------------------------------------------------------------- #
# the builder, its counts and its refusals
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [{}, {"variant": "s"}, {"variant": "b", "num_classes": 7},
                                {"window": 4, "stochastic_depth": 0.0, "pool_kernel": 1},
                                {"norm": "rms_norm", "stochastic_depth": 0.5}])
def test_swin_spec_is_the_jax_spec(kw):
    assert zoo.swin_spec(**kw) == jax_zoo.swin_spec(**kw)


#: torchvision's swin_t, swin_s and swin_b at 1000 classes
SWIN_COUNTS = {"t": 28_288_354, "s": 49_606_258, "b": 87_768_224}


@pytest.mark.parametrize("variant", sorted(SWIN_COUNTS))
def test_swin_parameter_count_is_torchvisions(variant):
    m = DeepcvModule((224, 224, 3), zoo.swin_spec(variant), device="meta")
    assert m.capacity() == SWIN_COUNTS[variant]
    assert zoo.SWIN_SETTINGS[variant] == jax_zoo.SWIN_SETTINGS[variant]


def test_swin_t_stage_four_is_unshifted_and_its_drop_path_ramps():
    m = DeepcvModule((224, 224, 3), zoo.swin_spec("t"), device="meta")
    blocks = [(name, mod) for name, mod in m.module.nodes.items()
              if isinstance(mod, tatt.SwinBlock)]
    assert len(blocks) == 12
    assert [(b.attn.map_hw[0], b.attn.shift) for _, b in blocks] == \
        [(56, 0), (56, 3), (28, 0), (28, 3)] + [(14, 0), (14, 3)] * 3 + [(7, 0), (7, 0)]
    assert [b.drop_path.p for _, b in blocks] == pytest.approx(
        [0.2 * i / 11 for i in range(12)], abs=1e-6)


_DATASETS = {"trainset": type("T", (), {"image_shape": (224, 224, 3), "num_classes": 5})()}
_KEYS = {"depth": 121, "width_mult": 0.5, "variant": "s", "window": 7, "groups": 1,
         "width_per_group": 64, "norm": "batch_norm"}


@pytest.mark.parametrize("key", sorted(_KEYS))
def test_create_model_takes_and_refuses_the_keys_the_jax_package_does(key):
    params = {"zoo": "swin", key: _KEYS[key]}
    try:
        jax_create_model(_DATASETS, params)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None:
        assert create_model(_DATASETS, params, device="meta").output_shape == (1, 5)
    else:
        with pytest.raises(ValueError) as got:
            create_model(_DATASETS, params, device="meta")
        assert str(got.value) == refused


@pytest.mark.parametrize("hp,input_shape,match", [
    ({"architecture": [{"swin_block": ["b", {"num_heads": 2, "window": 3}]}]}, (8, 8, 16),
     "feature map 8x8 not divisible by window=3"),
    ({"architecture": [{"swin_block": ["b", {"num_heads": 3}]}]}, (7, 7, 16),
     "dim 16 not divisible by 3 heads"),
    ({"architecture": [{"patch_merging": ["m", {}]}]}, (5, 6, 16),
     "feature map 5x6 not divisible by 2")])
def test_swin_nodes_refuse_what_the_jax_nodes_refuse(hp, input_shape, match):
    hp = {"act_fn": "gelu_exact", **hp}
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(JaxModule(input_shape, hp).init, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=match):
        DeepcvModule(input_shape, hp, device="meta")


def test_swin_nodes_refuse_unknown_keys():
    hp = {"act_fn": "gelu_exact",
          "architecture": [{"swin_block": ["b", {"num_heads": 2, "moe": {}}]}]}
    with pytest.raises(ValueError, match="unexpected param.*moe"):
        DeepcvModule((8, 8, 16), hp, device="meta")


# --------------------------------------------------------------------------- #
# train_swin through run
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def imagenet_project(tmp_path_factory):
    """A project whose conf is the repo's, with the imagenet224 catalog
    entries cut to 10 + 4 synthetic 32x32 images of 3 classes."""
    root = tmp_path_factory.mktemp("swin_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    entry = {"type": "synthetic", "image_shape": [32, 32, 3], "num_classes": 3}
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "imagenet224_train": {**entry, "n": 10},
        "imagenet224_test": {**entry, "n": 4, "train": False}}))
    return root


def test_train_swin_runs_end_to_end_on_cpu(imagenet_project, tmp_path):
    """The conf's Swin-T (full width, drop path 0.2, bfloat16) with window 4,
    so that the 32x32 images' 8x8 first map holds whole windows, and
    ``train_resnet50``'s hp cut to one epoch at batch 4, no checkpoints."""
    hp = "train_resnet50"
    params = ["swin_model.window:4", "imagenet224_preprocessing.split_dataset.validset_ratio:0.3",
              f"{hp}.epochs:1", f"{hp}.batch_size:4", f"{hp}.save_every_iters:0",
              f"{hp}.output_path:{tmp_path}"]
    store = cli_run(["--pipeline=train_swin", "--project-path", str(imagenet_project),
                     "--device", "cpu", "--params", ",".join(params)])
    h = store["train_results"]["history"]
    assert h["steps"] == len(store["datasets"]["trainset"]) // 4 > 0
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert h["valid"] and np.isfinite(list(h["valid"][-1].values())).all()
    assert "moe_aux" not in h["train"][0]
    model = store["model"]
    assert model.device.type == "cpu" and model.dtype == torch.bfloat16
    assert model.output_shape == (1, 3)
    # Swin-T less 997 classes of the head and the bias tables' rows the
    # windows of 4, 4, 2 and 1 do not have (169 - (2w - 1)^2 a head)
    table_rows = sum(n * heads * (169 - (2 * w - 1) ** 2) for n, heads, w in
                     ((2, 3, 4), (2, 6, 4), (6, 12, 2), (2, 24, 1)))
    assert model.capacity() == SWIN_COUNTS["t"] - 997 * 769 - table_rows

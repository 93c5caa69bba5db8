"""The port's spec engine and model against the JAX package's, on the CPU:
the same spec, the same weights (initialised in JAX, carried across by
``deepcv_tpu_torch.interop``), the same inputs from a numpy seed."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec.zoo import resnet_spec as jax_resnet_spec
from deepcv_tpu_torch.config import TaggedFactory, load_yaml
from deepcv_tpu_torch.hyperparams import merge_hyperparameters, to_hyperparameters
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.spec import DeepcvModule, SpecError
from deepcv_tpu_torch.spec.zoo import resnet_spec

TOL = 1e-4  # the forward bound of tests/test_torch_parity.py


def _numpy_vars(variables, seed=0):
    """JAX variables as numpy, with batch stats moved off their init values so
    eval-mode BatchNorm is exercised."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    v = {k: jax.tree_util.tree_map(np.array, d) for k, d in v.items()}
    rng = np.random.default_rng(seed)
    for node in v.get("batch_stats", {}).values():
        for st in node.values():
            st["mean"] = (0.1 * rng.normal(size=st["mean"].shape)).astype(np.float32)
            st["var"] = rng.uniform(0.5, 1.5, size=st["var"].shape).astype(np.float32)
    return v


def _pair(hp, input_shape, seed=7):
    jm = JaxModule(input_shape, hp)
    jv = _numpy_vars(jm.init(jax.random.PRNGKey(seed)))
    tm = DeepcvModule(input_shape, hp, device="cpu").eval()
    load_jax_variables(tm, jv)
    return jm, jv, tm


def test_narrow_resnet50_forward_matches_jax():
    hp = resnet_spec(50, width=8, num_classes=10, pool_kernel=1)
    assert hp == jax_resnet_spec(50, width=8, num_classes=10, pool_kernel=1)
    jm, jv, tm = _pair(hp, (32, 32, 3))
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 10)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_links_pools_groupnorm_and_dense_match_jax():
    """The other ported creators: 5x5 and 3x3 convs with group_norm and
    leaky_relu, named avg-pool, dense_link with rescaling, flatten in HWC
    order, fully_connected with batch_norm and a sigmoid."""
    hp = {"act_fn": "leaky_relu", "group_norm": {"num_groups": 2, "eps": 1e-5},
          "architecture": [
              {"conv2d": {"kernel_size": [5, 5], "out_channels": 4, "padding": 2}},
              {"average_pooling": ["pool1", {"kernel_size": [2, 2], "stride": [2, 2]}]},
              {"conv2d": {"kernel_size": [3, 3], "out_channels": 6, "padding": 1}},
              {"max_pooling": {"kernel_size": [3, 3], "stride": [2, 2], "padding": 1}},
              {"dense_link": {"_from": "pool1", "allow_scaling": True}},
              {"conv2d": ["c1x1", {"kernel_size": [1, 1], "out_channels": 10,
                                   "act_fn": None}]},
              {"_new_branch_from_tensor": {"_from": "pool1"}},
              {"conv2d": {"kernel_size": [3, 3], "out_channels": 10, "stride": 2,
                          "padding": 1}},
              {"residual_link": {"_from": "c1x1"}},
              {"activation": {}},
              {"flatten": {}},
              {"fully_connected": {"out_features": 5, "act_fn": "sigmoid",
                                   "group_norm": None,
                                   "batch_norm": {"momentum": 0.1, "eps": 1e-5}}},
          ]}
    jm, jv, tm = _pair(hp, (16, 16, 3))
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_resnet50_parameter_count_on_the_meta_device():
    m = DeepcvModule((224, 224, 3), resnet_spec(50), device="meta")
    assert m.capacity() == 25_557_032          # torchvision's resnet50
    assert all(p.device.type == "meta" for p in m.parameters())
    assert m.output_shape == (1, 1000)
    text = str(m.describe())
    assert "capacity=25,557,032" in text and "s3b2_out" in text


def test_resnet50_routes_46_convs_to_the_kernel():
    from deepcv_tpu_torch.ops.nn import Conv2d, FusedConv2d

    m = DeepcvModule((224, 224, 3), resnet_spec(50), device="meta")
    fused = [n for n, mod in m.named_modules() if isinstance(mod, FusedConv2d)]
    plain = [n for n, mod in m.named_modules()
             if isinstance(mod, Conv2d) and not isinstance(mod, FusedConv2d)]
    assert len(fused) == 46 and len(plain) == 7
    assert "module.nodes.stem.op" in plain


def test_same_seed_same_weights_and_init_statistics():
    hp = resnet_spec(50, width=8, num_classes=10, pool_kernel=1)
    a = DeepcvModule((32, 32, 3), hp, device="cpu", generator=torch.Generator().manual_seed(3))
    b = DeepcvModule((32, 32, 3), hp, device="cpu", generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    bn = a.module.nodes["s0b0_c1"].norms[0]
    assert 0.0 <= bn.weight.min() and bn.weight.max() < 1.0      # uniform[0, 1)
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_train_mode_batchnorm_updates_like_jax():
    hp = {"act_fn": "relu", "batch_norm": {"momentum": 0.2, "eps": 1e-5},
          "architecture": [{"conv2d": {"kernel_size": [3, 3], "out_channels": 8}}]}
    jm, jv, tm = _pair(hp, (8, 8, 4))
    x = np.random.default_rng(3).normal(size=(4, 8, 8, 4)).astype(np.float32)
    y_j, state = jm.apply(jv, jnp.asarray(x), train=True)
    tm.train()
    y_t = tm(torch.from_numpy(x))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=TOL, rtol=0)
    sd = jax_to_torch_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, state["batch_stats"]), "params": jv["params"]}, tm)
    for k in ("running_mean", "running_var"):
        key = f"module.nodes._submodule_0_conv2d.norms.0.{k}"
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), sd[key].numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,match", [
    ([{"no_such_creator": {}}], "Unknown submodule creator"),
    ([{"conv2d": {"kernel_size": 3, "out_channels": 4}},
      {"residual_link": {"_from": "missing"}}], "undefined"),
    ([{"conv2d": ["a", {"kernel_size": 3, "out_channels": 4}]},
      {"conv2d": ["a", {"kernel_size": 3, "out_channels": 4}]}], "Duplicate"),
    ([{"conv2d": {"kernel_size": 3, "out_channels": 4, "_from": "x"}}], "undefined"),
    ([{"_nested_deepcvmodule": {"architecture": [{"flatten": {}}]}}], "not ported"),
    ([], "non-empty"),
])
def test_bad_specs_are_spec_errors_at_build_time(arch, match):
    with pytest.raises(SpecError, match=match):
        DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": arch}, device="meta")


def test_missing_required_hp_and_bad_params_raise_value_errors():
    with pytest.raises(ValueError, match="act_fn"):
        DeepcvModule((8, 8, 3), {"architecture": [{"flatten": {}}]}, device="meta")
    with pytest.raises(ValueError, match="unexpected param"):
        DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": [
            {"conv2d": {"kernel_size": 3, "out_channels": 4, "bogus": 1}}]}, device="meta")


def test_interop_refuses_keys_that_do_not_map():
    hp = {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 4}}]}
    jm, jv, tm = _pair(hp, (8, 8, 3))
    extra = {"params": {**jv["params"], "node_impls_ghost": {"op": {"kernel": np.zeros(3)}}}}
    with pytest.raises(KeyError, match="ghost"):
        jax_to_torch_state_dict(extra, tm)
    partial = {"params": {k: {"op": {"kernel": v["op"]["kernel"]}}
                          for k, v in jv["params"].items()}}
    with pytest.raises(KeyError, match="no JAX variable"):
        jax_to_torch_state_dict(partial, tm)


def test_config_loads_the_repo_parameters_and_refuses_unsafe_tags():
    doc = load_yaml(Path(__file__).resolve().parents[1] / "conf/base/parameters.yml")
    assert "image_classifier_model" in doc
    tag = load_yaml("act_fn: !py!os.system")["act_fn"]
    assert isinstance(tag, TaggedFactory)
    with pytest.raises(ValueError, match="Refusing"):
        tag.resolve()
    assert load_yaml("a: !py!relu")["a"].resolve() is torch.relu


def test_hyperparameters_defaults_and_merge():
    hp, missing = to_hyperparameters({"a": 1}, {"a": ..., "b": 2, "c": ...},
                                     raise_if_missing=False)
    assert dict(hp) == {"a": 1, "b": 2} and missing == ["c"]
    with pytest.raises(ValueError, match="Missing"):
        to_hyperparameters({}, {"x": ...})
    merged = merge_hyperparameters({"o": {"a": 1, "b": 2}}, {"o": {"b": 3}})
    assert merged["o"] == {"a": 1, "b": 3}

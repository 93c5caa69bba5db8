"""ViT in the port against the JAX package: ``vit_spec`` emits the same spec,
the model built from it has torchvision's parameter count, and with the
same weights (carried across by ``interop``) the forward agrees to 1e-4 and
the first-step gradients to rtol 1e-3, for both attention impls. Also the
spec refusals, the ViT creators and ViT bundles through the Predictor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec.zoo import vit_spec as jax_vit_spec
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.serve import Predictor, load_model_bundle, save_model_bundle
from deepcv_tpu_torch.spec import DeepcvModule, SpecError
from deepcv_tpu_torch.spec.zoo import VIT_SETTINGS, vit_spec

FWD_TOL = 1e-4    # the repo's bound (tests/test_torch_parity.py:11-12)
GRAD_RTOL = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tiny(spec_fn, attn_impl, layers=2, heads=4, hidden=32, mlp=64, patch=8,
          num_classes=5, **kw):
    hp = spec_fn(variant="b_16", num_classes=num_classes, attn_impl=attn_impl, **kw)
    arch = [hp["architecture"][0]] + hp["architecture"][1:1 + layers] \
        + hp["architecture"][-3:]
    arch[0]["patch_embed"][1].update(patch_size=patch, embed_dim=hidden)
    for row in arch[1:1 + layers]:
        row["transformer_block"][1].update(num_heads=heads, mlp_dim=mlp)
    hp["architecture"] = arch
    return hp


def _pair(attn_impl, img=16, **kw):
    hp = _tiny(jax_vit_spec, attn_impl, **kw)
    jm = JaxModule((img, img, 3), hp)
    jv = jm.init(jax.random.PRNGKey(7))
    tm = DeepcvModule((img, img, 3), _tiny(vit_spec, attn_impl, **kw), device="cpu")
    load_jax_variables(tm, _np_tree(jv))
    return jm, jv, tm


@pytest.mark.parametrize("kw", [
    {}, {"attn_impl": "flash"}, {"variant": "l_32", "num_classes": 7},
    {"dropout": 0.1, "attn_dropout": 0.2, "stochastic_depth": 0.3},
    {"mlp_act": "gelu_tanh", "norm": "rms_norm"}])
def test_vit_spec_is_the_jax_spec(kw):
    assert vit_spec(**kw) == jax_vit_spec(**kw)


def test_vit_b16_has_torchvision_parameter_count_on_meta():
    m = DeepcvModule((224, 224, 3), vit_spec("b_16", attn_impl="flash"), device="meta")
    assert m.capacity() == 86_567_656
    assert next(m.parameters()).device.type == "meta"
    assert VIT_SETTINGS["b_16"] == (16, 12, 12, 768, 3072)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_vit_forward_matches_jax(attn_impl):
    jm, jv, tm = _pair(attn_impl, img=24)
    x = np.random.default_rng(11).normal(size=(3, 24, 24, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 5)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_vit_first_step_gradients_match_jax(attn_impl):
    jm, jv, tm = _pair(attn_impl)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(4,))

    def loss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), train=False)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), y])

    g = jax_to_torch_state_dict({"params": _np_tree(jax.grad(loss)(jv["params"]))}, tm)
    tm.train()
    torch.nn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                      torch.from_numpy(y)).backward()
    got = dict(tm.named_parameters())
    assert set(g) == set(got)
    for key, ref in g.items():
        grad = got[key].grad.numpy()
        np.testing.assert_allclose(grad, ref.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(ref.numpy()).max()) + 1e-8,
                                   err_msg=key)


def test_interop_maps_every_vit_variable_and_keeps_qkv_row_order():
    jm, jv, tm = _pair("flash")
    sd = tm.state_dict()
    qkv = np.asarray(jv["params"]["node_impls_enc0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["module.nodes.enc0.attn.qkv.weight"].numpy(), qkv.T)
    np.testing.assert_array_equal(sd["module.nodes.embed.pos_embedding"].numpy(),
                                  np.asarray(jv["params"]["node_impls_embed"]["pos_embedding"]))
    np.testing.assert_array_equal(
        sd["module.nodes.final_ln.norms.0.weight"].numpy(),
        np.asarray(jv["params"]["node_impls_final_ln"]["norms_0"]["scale"]))
    bad = {"params": {"node_impls_enc0": {"attn": {"qkv": {"weird": qkv}}}}}
    with pytest.raises(KeyError, match="unmapped"):
        jax_to_torch_state_dict(bad, tm)


def test_vit_refuses_what_this_slice_does_not_carry():
    """What the JAX package refuses: a ``moe`` without ``num_experts`` (by
    the JAX creator's message) and ``k`` outside [1, E] (by the JAX
    module's); a Swin key on a transformer block; an unknown attention impl
    or variant."""
    hp = _tiny(vit_spec, "xla")
    hp["architecture"][1]["transformer_block"][1]["moe"] = {"k": 1}
    with pytest.raises(ValueError) as ref:
        JaxModule((16, 16, 3), hp)
    with pytest.raises(ValueError) as got:
        DeepcvModule((16, 16, 3), hp, device="cpu")
    assert str(got.value) == str(ref.value) == "enc0: moe config requires num_experts " \
        "(got {'k': 1})"
    for k in (0, 5):
        hp = _tiny(vit_spec, "xla", moe_experts=4, moe_k=k, moe_every=1)
        with pytest.raises(ValueError) as ref:
            JaxModule((16, 16, 3), hp).init(jax.random.PRNGKey(0))
        with pytest.raises(ValueError) as got:
            DeepcvModule((16, 16, 3), hp, device="cpu")
        assert str(got.value) == str(ref.value) == f"k={k} must be in [1, E=4]"
    hp = _tiny(vit_spec, "xla")
    hp["architecture"][1]["transformer_block"][1]["window"] = 7
    with pytest.raises(ValueError, match="unexpected param.*window"):
        DeepcvModule((16, 16, 3), hp, device="cpu")
    hp = _tiny(vit_spec, "fused")
    with pytest.raises(ValueError, match="unknown attention impl"):
        DeepcvModule((16, 16, 3), hp, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        vit_spec("s_16")


def test_norm_node_over_tokens_and_feature_maps():
    hp = {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [1, 1], "out_channels": 6, "padding": 0}},
        {"norm": ["ln_map", {"layer_norm": {"eps": 1e-6}}]},
        {"norm": ["rms_map", {"rms_norm": {}}]}]}
    m = DeepcvModule((5, 5, 3), hp, device="cpu")
    y = m(torch.randn(2, 5, 5, 3))
    assert y.shape == (2, 5, 5, 6)
    with pytest.raises(ValueError, match="no normalization technique"):
        DeepcvModule((5, 5, 3), {"act_fn": "relu", "architecture": [{"norm": {}}]},
                     device="cpu")


def test_vit_bundle_serves_through_the_predictor(tmp_path):
    hp = _tiny(vit_spec, "flash")
    m = DeepcvModule((16, 16, 3), hp, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    save_model_bundle(tmp_path, m)
    loaded = load_model_bundle(tmp_path, device="cpu")
    for (k, a), (k2, b) in zip(m.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    x = np.random.default_rng(0).integers(0, 256, (5, 16, 16, 3)).astype(np.uint8)
    pre = lambda t: t.float() / 255.0  # noqa: E731
    got = Predictor(loaded, batch_size=4, preprocess=pre, device="cpu")(x)
    m.eval()
    with torch.no_grad():
        ref = m(torch.from_numpy(x).float() / 255.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_bf16_compute_dtype_keeps_float32_parameters():
    hp = _tiny(vit_spec, "flash")
    m = DeepcvModule((16, 16, 3), hp, device="cpu", dtype="bfloat16")
    ref = DeepcvModule((16, 16, 3), hp, device="cpu")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    x = torch.randn(2, 16, 16, 3)
    y = m(x)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.float().detach().numpy(), ref(x).detach().numpy(),
                               atol=0.1, rtol=0)

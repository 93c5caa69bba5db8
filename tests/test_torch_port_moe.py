"""V-MoE in the port against the JAX package, on the CPU: ``MoEMlp`` alone
(top-1 and top-2, one global group and groups of whole images, a capacity
low enough that choices overflow, exact and tanh GELU) with its output,
its load-balance loss and its router and expert gradients; the refusals;
a tiny V-MoE ``vit_spec`` model's forward with the JAX variables carried
across by ``deepcv_tpu_torch.interop``; the first training step's
objective, CE + ``moe_aux_weight`` x the mean aux; bench.py config 13's
parameter count; and ``train_vit`` with ``moe_experts`` end to end through
the port's ``run``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.ops import moe as jmoe
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec.zoo import vit_spec as jax_vit_spec
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops.moe import MoEMlp
from deepcv_tpu_torch.pipelines.classification import create_model
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import vit_spec
from deepcv_tpu_torch.train.losses import WeightedLosses, cross_entropy_loss
from deepcv_tpu_torch.train.metrics import accuracy
from deepcv_tpu_torch.train.training import TrainState, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: relative to max|ref|, both in float32: the same routing, the experts'
#: sums in another order
MOE_TOL = 1e-5
FWD_TOL = 1e-4      # a whole model (the bound of tests/test_torch_parity.py)
GRAD_RTOL = 1e-3

N, T, D, E, M = 4, 9, 16, 4, 24


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _moe_params(seed):
    """MoEMlp's variables drawn with numpy: a router of std 1 (peaked, so a
    low capacity overflows), expert kernels of variance 1 / fan-in, biases
    of std 0.1."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"router": rng.normal(size=(D, E)).astype(f32),
            "expert_w1": (rng.normal(size=(E, D, M)) / np.sqrt(D)).astype(f32),
            "expert_b1": (0.1 * rng.normal(size=(E, M))).astype(f32),
            "expert_w2": (rng.normal(size=(E, M, D)) / np.sqrt(M)).astype(f32),
            "expert_b2": (0.1 * rng.normal(size=(E, D))).astype(f32)}


def _port_moe(params, **kw):
    with torch.device("meta"):
        m = MoEMlp(D, E, M, **kw)
    m.to_empty(device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return m


#: (k, group_size, capacity_factor, mlp_act): one global group and groups of
#: two images (18 tokens), capacities that hold and that overflow
MOE_CASES = [(1, 0, 1.25, "gelu"), (2, 0, 1.25, "gelu"), (1, 18, 1.0, "gelu_tanh"),
             (2, 18, 0.5, "gelu"), (1, 18, 0.5, "gelu_tanh"), (2, 0, 2.0, "gelu_tanh")]


@pytest.mark.parametrize("k,group_size,cf,act", MOE_CASES,
                         ids=[f"k{k}-gs{g}-cf{c}-{a}" for k, g, c, a in MOE_CASES])
def test_moe_mlp_matches_jax(k, group_size, cf, act):
    params = _moe_params(k * 100 + group_size)
    x = np.random.default_rng(1).normal(size=(N, T, D)).astype(np.float32)
    jm = jmoe.MoEMlp(num_experts=E, mlp_dim=M, k=k, capacity_factor=cf,
                     group_size=group_size, mlp_act=act)
    r = np.random.default_rng(2).normal(size=(N, T, D)).astype(np.float32)

    def objective(p):
        y, state = jm.apply({"params": p}, jnp.asarray(x), train=True, mutable=["moe_losses"])
        aux = state["moe_losses"]["load_balance"]
        return jnp.sum(y * r) + 3.0 * aux, (y, aux)

    (_, (ref, ref_aux)), jgrads = jax.value_and_grad(objective, has_aux=True)(params)
    port = _port_moe(params, k=k, capacity_factor=cf, group_size=group_size, mlp_act=act)
    xt = torch.from_numpy(x)
    y = port(xt)
    assert y.shape == xt.shape and y.dtype == torch.float32
    assert _rel(y.detach().numpy(), np.asarray(ref)) <= MOE_TOL
    np.testing.assert_allclose(port.aux.item(), float(ref_aux), rtol=1e-6)
    experts, kept = port.routing
    g = 2 if group_size else 1
    assert experts.shape == kept.shape == (g, N * T // g, k)
    if cf < 1.0:
        assert not kept.all()
    # a token none of whose choices kept its slot comes out exactly 0
    none_kept = ~kept.any(-1).reshape(N, T)
    assert torch.equal(y.detach()[none_kept], torch.zeros_like(y.detach()[none_kept]))
    if k == 1 and cf < 1.0:
        assert none_kept.any()
    (y * torch.from_numpy(r)).sum().add(3.0 * port.aux).backward()
    for name, want in jgrads.items():
        want = np.asarray(want)
        np.testing.assert_allclose(getattr(port, name).grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=name)


def test_config13_routing_geometry_drops_the_jax_modules_choices():
    """bench.py config 13's routing geometry (one group of 4 images x 197
    tokens, E 8, top-1, capacity factor 1.25: capacity 124) at width 16, on
    tokens that each image's shared vector dominates, so that most of a
    group picks one or two experts and overflows: the port keeps exactly
    the choices the JAX module keeps (its output rows that are not 0) and
    agrees on the rest of the output and the aux."""
    d, e, m, n, t = 16, 8, 24, 4, 197
    rng = np.random.default_rng(13)
    f32 = np.float32
    params = {"router": rng.normal(size=(d, e)).astype(f32),
              "expert_w1": (rng.normal(size=(e, d, m)) / np.sqrt(d)).astype(f32),
              "expert_b1": (0.1 * rng.normal(size=(e, m))).astype(f32),
              "expert_w2": (rng.normal(size=(e, m, d)) / np.sqrt(m)).astype(f32),
              "expert_b2": (0.1 * rng.normal(size=(e, d))).astype(f32)}
    x = (rng.normal(size=(n, 1, d)) + 0.1 * rng.normal(size=(n, t, d))).astype(f32)
    jm = jmoe.MoEMlp(num_experts=e, mlp_dim=m, k=1, group_size=788)
    ref, state = jm.apply({"params": params}, jnp.asarray(x), train=True,
                          mutable=["moe_losses"])
    ref = np.asarray(ref)
    with torch.device("meta"):
        port = MoEMlp(d, e, m, k=1, group_size=788)
    port.to_empty(device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    experts, kept = port.routing
    assert kept.shape == (1, n * t, 1)
    jax_kept = np.abs(ref).reshape(n * t, d).max(-1) > 0
    np.testing.assert_array_equal(kept.reshape(-1).numpy(), jax_kept)
    assert (~jax_kept).mean() > 0.5          # the group overflows, as config 13's did
    assert _rel(got, ref) <= MOE_TOL
    np.testing.assert_allclose(port.aux.item(), float(state["moe_losses"]["load_balance"]),
                               rtol=1e-6)


def test_priority_ordering_and_capacity():
    """Top-2 in one group of 8 tokens, capacity 2 (E 4, cf 0.5): every first
    choice claims its slot before any second choice, and within a choice the
    slots go in token order."""
    params = _moe_params(3)
    port = _port_moe(params, k=2, capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, D)).astype(np.float32))
    probs = torch.softmax(x @ torch.from_numpy(params["router"]), -1)
    first, second = probs.topk(2, -1).indices.unbind(-1)
    with torch.no_grad():
        port(x)
    experts, kept = port.routing
    assert torch.equal(experts[0, :, 0], first) and torch.equal(experts[0, :, 1], second)
    cap = 2
    used = [0] * E
    want = []
    for choice in (first, second):
        col = []
        for e in choice.tolist():
            col.append(used[e] < cap)
            used[e] += col[-1]
        want.append(col)
    assert kept[0].T.tolist() == want


def test_router_noise_only_in_training_and_from_the_generator():
    params = _moe_params(5)
    port = _port_moe(params, router_noise=0.5, capacity_factor=4.0)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(N, T, D)).astype(np.float32))
    with torch.no_grad():
        clean = port.eval()(x)
        assert torch.equal(port(x), clean)
        port.train()
        outs = []
        for seed in (7, 7, 8):
            port.generator = torch.Generator().manual_seed(seed)
            outs.append(port(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], clean)


def test_moe_refuses_what_the_jax_module_refuses():
    x = jnp.zeros((2, 3, D))
    for k in (0, E + 1):
        with pytest.raises(ValueError) as ref:
            jmoe.MoEMlp(num_experts=E, mlp_dim=M, k=k).init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError) as got:
            MoEMlp(D, E, M, k=k)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown mlp_act 'relu'"):
        MoEMlp(D, E, M, mlp_act="relu")


# --------------------------------------------------------------------------- #
# a tiny V-MoE ViT
# --------------------------------------------------------------------------- #

def _tiny_vmoe(spec_fn, layers=4, heads=2, hidden=16, mlp=32, patch=8, **moe):
    """vit_spec('b_16') with V-MoE arguments, cut to ``layers`` blocks of
    width ``hidden``: on 16x16 images, 5 tokens an image."""
    hp = spec_fn(variant="b_16", num_classes=5, **moe)
    arch = [hp["architecture"][0]] + hp["architecture"][13 - layers:13] \
        + hp["architecture"][-3:]
    arch[0]["patch_embed"][1].update(patch_size=patch, embed_dim=hidden)
    for row in arch[1:1 + layers]:
        row["transformer_block"][1].update(num_heads=heads, mlp_dim=mlp)
    hp["architecture"] = arch
    return hp


VMOE = {"moe_experts": 4, "moe_every": 2, "moe_k": 2, "moe_capacity_factor": 1.0,
        "moe_group_size": 10}


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name or "expert_w" in name:
            a = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        elif "scale" in name:
            a = rng.uniform(0.5, 1.5, size=s.shape)
        elif "router" in name or "pos_embedding" in name or "cls_token" in name:
            a = rng.normal(size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny_vmoe():
    hp = _tiny_vmoe(vit_spec, **VMOE)
    assert hp == _tiny_vmoe(jax_vit_spec, **VMOE)
    jm = JaxModule((16, 16, 3), hp)
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 9)
    tm = DeepcvModule((16, 16, 3), hp, device="cpu")
    load_jax_variables(tm, {"params": jv["params"]})
    return jm, jv, tm


def test_vit_spec_places_the_experts_as_the_jax_spec(tiny_vmoe):
    _, jv, tm = tiny_vmoe
    for kw in (VMOE, {"moe_experts": 8, "moe_every": 2, "moe_k": 1, "moe_group_size": 788},
               {"moe_experts": 2, "moe_every": 5, "moe_router_noise": 0.1}):
        assert vit_spec(**kw) == jax_vit_spec(**kw)
    moe = [name for name, m in tm.named_modules() if isinstance(m, MoEMlp)]
    assert moe == ["module.nodes.enc9.moe_mlp", "module.nodes.enc11.moe_mlp"]
    assert not hasattr(tm.module.nodes.enc9, "mlp")
    assert set(jv["params"]["node_impls_enc11"]["moe_mlp"]) == {
        "router", "expert_w1", "expert_b1", "expert_w2", "expert_b2"}


def test_tiny_vmoe_forward_matches_jax(tiny_vmoe):
    jm, jv, tm = tiny_vmoe
    x = np.random.default_rng(11).normal(size=(6, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (6, 5)
    assert ref.std() > 1e-2
    assert _rel(got, ref) <= FWD_TOL


def test_first_step_objective_is_ce_plus_weighted_mean_aux(tiny_vmoe):
    """``train_step`` with ``moe_aux_weight`` 0.01: its ``main_loss`` is the
    JAX ``train()``'s objective on the same batch, CE + 0.01 x the mean of
    the two layers' aux, and ``moe_aux`` is that mean."""
    jm, jv, tm = tiny_vmoe
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(6,))
    logits, state = jm.apply(jv, jnp.asarray(x), train=True, mutable=["moe_losses"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
    auxes = jax.tree_util.tree_leaves(state["moe_losses"])
    assert len(auxes) == 2
    ce = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(6), y])
    ref_aux = float(sum(jnp.mean(a) for a in auxes) / 2)
    state = TrainState(tm.train(), torch.optim.SGD(tm.parameters(), lr=0.0), 0,
                       torch.Generator().manual_seed(0))
    out = train_step(state, WeightedLosses(cross_entropy_loss), {"accuracy": accuracy},
                     torch.from_numpy(x), torch.from_numpy(y), moe_aux_weight=0.01)
    np.testing.assert_allclose(out["moe_aux"].item(), ref_aux, rtol=1e-5)
    np.testing.assert_allclose(out["main_loss"].item(), float(ce) + 0.01 * ref_aux, rtol=1e-5)
    np.testing.assert_allclose(out["loss"].item(), float(ce), rtol=1e-5)
    plain = train_step(state, WeightedLosses(cross_entropy_loss), {},
                       torch.from_numpy(x), torch.from_numpy(y))
    assert "moe_aux" not in plain


def test_interop_keeps_the_expert_layouts_and_refuses_unmapped_moe_leaves(tiny_vmoe):
    _, jv, tm = tiny_vmoe
    sd = jax_to_torch_state_dict({"params": jv["params"]}, tm)
    node = jv["params"]["node_impls_enc9"]["moe_mlp"]
    for leaf in ("router", "expert_w1", "expert_b1", "expert_w2", "expert_b2"):
        np.testing.assert_array_equal(sd[f"module.nodes.enc9.moe_mlp.{leaf}"].numpy(),
                                      np.asarray(node[leaf]))
    router = np.asarray(node["router"])
    for bad in ({"moe_mlp": {"gate": router}}, {"moe_mlp": {"router": {"kernel": router}}},
                {"mlp": {"router": router}}):
        with pytest.raises(KeyError):
            jax_to_torch_state_dict({"params": {"node_impls_enc9": bad}}, tm)


def test_vmoe_bundle_saves_and_loads_with_equal_logits(tiny_vmoe, tmp_path):
    from deepcv_tpu_torch.serve import load_model_bundle, save_model_bundle

    _, _, tm = tiny_vmoe
    save_model_bundle(tmp_path / "bundle", tm)
    loaded = load_model_bundle(tmp_path / "bundle", device="cpu")
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = tm.eval()(x), loaded(x)
    assert torch.equal(got, want)


def test_vmoe_b16_parameter_count_through_create_model():
    """bench.py config 13's model: ViT-B/16 with 8 experts on every 2nd block
    (6 of 12), 86,567,656 + 6 x 33,063,168; the ``vit`` builder takes the
    V-MoE arguments from the conf."""
    datasets = {"trainset": type("T", (), {"image_shape": (224, 224, 3), "num_classes": 1000})()}
    hp = {"zoo": "vit", "attn_impl": "flash", "moe_experts": 8, "moe_every": 2, "moe_k": 1,
          "moe_group_size": 788}
    m = create_model(datasets, hp, device="meta")
    assert m.capacity() == 284_946_664 == 86_567_656 + 6 * 33_063_168
    moe = [mod for mod in m.modules() if isinstance(mod, MoEMlp)]
    assert len(moe) == 6 and {(mm.num_experts, mm.k, mm.group_size) for mm in moe} == {(8, 1, 788)}
    assert "moe_experts" not in m.hp


# --------------------------------------------------------------------------- #
# train_vit with moe_experts through run
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def imagenet_project(tmp_path_factory):
    root = tmp_path_factory.mktemp("vmoe_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    entry = {"type": "synthetic", "image_shape": [32, 32, 3], "num_classes": 3}
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "imagenet224_train": {**entry, "n": 12},
        "imagenet224_test": {**entry, "n": 4, "train": False}}))
    return root


def test_train_vit_with_moe_experts_runs_end_to_end_on_cpu(imagenet_project, tmp_path):
    """ViT-B/16 at full width on 32x32 images (5 tokens), 2 experts on every
    6th block (blocks 5 and 11), top-1, groups of 2 images, flash attention,
    ``train_resnet50``'s hp (SGD, bfloat16) cut to one epoch of 2 steps at
    batch 4: the history's ``moe_aux`` is finite and in (0, E]."""
    hp = "train_resnet50"
    params = ["vit_model.attn_impl:flash", "vit_model.moe_experts:2", "vit_model.moe_every:6",
              "vit_model.moe_k:1", "vit_model.moe_group_size:10",
              "imagenet224_preprocessing.split_dataset.validset_ratio:0.25",
              f"{hp}.epochs:1", f"{hp}.batch_size:4", f"{hp}.save_every_iters:0",
              f"{hp}.log_progress_every_iters:1", f"{hp}.output_path:{tmp_path}"]
    store = cli_run(["--pipeline=train_vit", "--project-path", str(imagenet_project),
                     "--device", "cpu", "--params", ",".join(params)])
    h = store["train_results"]["history"]
    assert h["steps"] == 2
    aux = [e["moe_aux"] for e in h["train"]]
    assert len(aux) == 2 and all(0.0 < a <= 2.0 for a in aux)
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert h["valid"] and np.isfinite(list(h["valid"][-1].values())).all()
    model = store["model"]
    assert model.dtype == torch.bfloat16
    moe = [m for m in model.modules() if isinstance(m, MoEMlp)]
    assert len(moe) == 2 and all(m.generator is not None for m in moe)

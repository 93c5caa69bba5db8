"""The video slice of the port against the JAX package, on the CPU: the
synthetic generators (byte-equal) and their loaders, ``flow_warp`` (forward
and gradients at integer and fractional flows), ``interpolate_frames``,
``endpoint_error``, ``deep_feature_flow_inference``'s key-frame schedule,
the spec engine's ``conv1d`` and ``conv3d``, the conf's video classifier,
``FlowModel`` at levels 1-3 and ``TemporalVideoModel`` for each head, pool
and stride setting (forward, first-step gradients, parameter counts), the
refusals with the JAX messages, ``create_pipelines`` with all six task
packages, and the three video pipelines through ``run``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.data.datasets import load_dataset as jax_load_dataset
from deepcv_tpu.pipelines import video as jv
from deepcv_tpu.pipelines.classification import create_model as jax_create_model
from deepcv_tpu.pipelines.registry import create_pipelines as jax_create_pipelines
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.train.losses import cross_entropy_loss as jax_ce, mse_loss as jax_mse
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data.datasets import load_dataset
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines import video as tv
from deepcv_tpu_torch.pipelines.classification import create_model
from deepcv_tpu_torch.pipelines.registry import TASK_PACKAGES, create_pipelines
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.losses import cross_entropy_loss, mse_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
OP_TOL = 1e-5         # flow_warp, interpolate_frames, endpoint_error
VIDEO_PIPELINES = ("train_optical_flow", "train_video_classifier", "train_temporal_classifier")


def _draw(shapes, seed):
    """Variables for the shapes of a JAX init: kernels normal with variance
    1 / fan-in, norm scales and running variances in [0.5, 1.5), biases,
    running means and position tables normal with std 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name or "var" in name:
            a = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _conf(key):
    path = os.path.join(REPO, "conf/base/parameters.yml")
    return load_yaml(path)[key], jax_load_yaml(path)[key]


class _Set:
    def __init__(self, shape, classes):
        self.image_shape, self.num_classes = tuple(shape), classes


def _assert_grads(tm, ref, tloss, jloss):
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = want.numpy()
        np.testing.assert_allclose(got[key].grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()) + 1e-8,
                                   err_msg=key)


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("train", [True, False])
def test_generators_are_byte_equal_to_jax(train):
    for t_gen, j_gen, kw in ((tv.generate_flow_dataset, jv.generate_flow_dataset,
                              dict(n=6, image_size=16, max_shift=3, seed=4)),
                             (tv.generate_clip_dataset, jv.generate_clip_dataset,
                              dict(n=10, frames=5, image_size=8, seed=4))):
        got, want = t_gen(train=train, **kw), j_gen(train=train, **kw)
        assert got.images.dtype == want.images.dtype and got.targets.dtype == want.targets.dtype
        assert got.images.tobytes() == want.images.tobytes()
        assert got.targets.tobytes() == want.targets.tobytes()
        assert got.classes == want.classes and got.name == want.name
        assert got.provenance == "synthetic"


@pytest.mark.parametrize("spec", [{"type": "synthetic_flow", "n": 3},
                                  {"type": "synthetic_clips", "train": False, "n": 5}])
def test_loaders_take_the_jax_defaults(spec):
    got = load_dataset(spec, train=spec.get("train", True))
    want = jax_load_dataset(spec, train=spec.get("train", True))
    assert got.images.shape == want.images.shape
    assert got.images.tobytes() == want.images.tobytes()
    assert got.targets.tobytes() == want.targets.tobytes()


def test_flow_targets_warp_b_onto_a():
    ds = tv.generate_flow_dataset(n=4, image_size=16, max_shift=2, seed=1)
    x = torch.from_numpy(ds.images.astype(np.float32))
    warped = tv.flow_warp(x[..., 3:], torch.from_numpy(ds.targets))
    inner = (slice(None), slice(2, -2), slice(2, -2))
    assert torch.equal(warped[inner], x[..., :3][inner])


# --------------------------------------------------------------------------- #
# ops
# --------------------------------------------------------------------------- #

def _flows(kind, rng, shape):
    if kind == "integer":
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.uniform(-3.5, 3.5, size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_flow_warp_and_its_gradients_match_jax(kind):
    """Forward within 1e-5, gradients with respect to the features and the
    flow at rtol 1e-3, flows reaching outside the frame."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    flow = _flows(kind, rng, (2, 9, 11, 2))
    cot = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    want, vjp = jax.vjp(jv.flow_warp, jnp.asarray(feats), jnp.asarray(flow))
    g_feats, g_flow = vjp(jnp.asarray(cot))
    tf = torch.from_numpy(feats).requires_grad_()
    tflow = torch.from_numpy(flow).requires_grad_()
    got = tv.flow_warp(tf, tflow)
    (got * torch.from_numpy(cot)).sum().backward()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= OP_TOL
    for g, w in ((tf.grad, g_feats), (tflow.grad, g_flow)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0])
def test_interpolate_frames_matches_jax(t):
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(size=(2, 8, 10, 3)).astype(np.float32) for _ in range(2))
    flow = _flows("fractional", rng, (2, 8, 10, 2))
    want = jv.interpolate_frames(jnp.asarray(a), jnp.asarray(b), flow=jnp.asarray(flow), t=t)
    got = tv.interpolate_frames(torch.from_numpy(a), torch.from_numpy(b),
                                flow=torch.from_numpy(flow), t=t)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= OP_TOL
    by_fn = tv.interpolate_frames(torch.from_numpy(a), torch.from_numpy(b), t=t,
                                  flow_fn=lambda *_: torch.from_numpy(flow))
    assert torch.equal(by_fn, got)


def test_interpolate_frames_refuses_both_or_neither_flow():
    a = np.zeros((1, 4, 4, 3), np.float32)
    for fn, arr in ((tv.interpolate_frames, torch.from_numpy(a)),
                    (jv.interpolate_frames, jnp.asarray(a))):
        with pytest.raises(ValueError, match="exactly one of flow= or flow_fn="):
            fn(arr, arr)
        with pytest.raises(ValueError, match="exactly one of flow= or flow_fn="):
            fn(arr, arr, flow=arr[..., :2], flow_fn=lambda *_: arr[..., :2])


def test_endpoint_error_matches_jax():
    rng = np.random.default_rng(7)
    p, q = (rng.normal(size=(3, 5, 6, 2)).astype(np.float32) for _ in range(2))
    got = tv.endpoint_error(torch.from_numpy(p), torch.from_numpy(q)).item()
    assert abs(got - float(jv.endpoint_error(jnp.asarray(p), jnp.asarray(q)))) <= OP_TOL
    assert tv.endpoint_error(torch.from_numpy(p), torch.from_numpy(p)).item() == \
        pytest.approx(1e-6, rel=1e-3)


@pytest.mark.parametrize("interval", [1, 3, 10])
def test_deep_feature_flow_runs_features_on_key_frames_only(interval):
    """``feature_fn`` on every ``interval``-th frame; the others warp the
    key frame's features by ``flow_fn(key, frame)``; the calls and the
    outputs are the JAX generator's."""
    rng = np.random.default_rng(8)
    frames = [i + 0.01 * rng.normal(size=(1, 6, 7, 2)).astype(np.float32) for i in range(7)]
    flows = [_flows("fractional", rng, (1, 6, 7, 2)) for _ in frames]

    def run(gen, to):
        calls = []

        def index(f):
            return int(round(float(np.asarray(f).mean())))

        def feature_fn(f):
            calls.append(("features", index(f)))
            return f * 2.0

        def flow_fn(key, f):
            calls.append(("flow", index(key), index(f)))
            return to(flows[index(f)])
        outs = [np.asarray(o) for o in gen((to(f) for f in frames), feature_fn, flow_fn,
                                           lambda feats: feats + 1.0, interval)]
        return calls, outs

    t_calls, got = run(tv.deep_feature_flow_inference, torch.from_numpy)
    j_calls, want = run(jv.deep_feature_flow_inference, jnp.asarray)
    keys = [i for i in range(len(frames)) if i % interval == 0]
    assert t_calls == j_calls
    assert [c[1] for c in t_calls if c[0] == "features"] == keys
    assert [c[1:] for c in t_calls if c[0] == "flow"] == \
        [(i - i % interval, i) for i in range(len(frames)) if i % interval]
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= OP_TOL


# --------------------------------------------------------------------------- #
# the spec engine's conv1d and conv3d
# --------------------------------------------------------------------------- #

CONV1D = {"act_fn": "relu", "batch_norm": {"momentum": 0.1}, "architecture": [
    {"conv1d": {"kernel_size": [3], "out_channels": 6, "padding": 1}},
    {"conv1d": {"kernel_size": [3], "out_channels": 8, "stride": 2, "padding": 1}},
    {"average_pooling": {"kernel_size": [2], "stride": [2]}},
    {"flatten": {}},
    {"fully_connected": {"out_features": 5, "act_fn": None, "batch_norm": None}}]}
CONV3D = {"act_fn": "relu", "batch_norm": {"momentum": 0.1}, "architecture": [
    {"conv3d": {"kernel_size": [3, 3, 3], "out_channels": 4, "padding": 1}},
    {"conv3d": {"kernel_size": [3, 3, 3], "out_channels": 6, "stride": [1, 2, 2],
                "padding": 1}},
    {"average_pooling": {"kernel_size": [2, 2, 2], "stride": [2, 2, 2]}},
    {"conv3d": {"kernel_size": [1, 1, 1], "out_channels": 5, "padding": 0, "act_fn": None,
                "batch_norm": None}}]}


@pytest.mark.parametrize("name,spec,shape,convs", [("conv1d", CONV1D, (12, 3), 2),
                                                   ("conv3d", CONV3D, (4, 8, 8, 3), 3)])
@pytest.mark.parametrize("train_mode", [False, True])
def test_nd_convs_match_the_jax_creators(name, spec, shape, convs, train_mode):
    """A spec of the creator with batch norm and an average pool against the
    JAX one, within 1e-4 in train and eval mode; none of its convs takes the
    kernel, and the output comes back channel-last."""
    jm = JaxModule(shape, spec)
    jvars = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 9)
    tm = load_jax_variables(DeepcvModule(shape, spec, device="cpu"), jvars)
    assert not any(isinstance(m, dnn.FusedConv2d) for m in tm.modules())
    assert sum(isinstance(m, dnn.ConvNd) for m in tm.modules()) == convs
    x = np.random.default_rng(10).normal(size=(3, *shape)).astype(np.float32)
    ref = jm.apply(jvars, jnp.asarray(x), train=train_mode)
    ref = np.asarray(ref[0] if isinstance(ref, tuple) else ref)
    got = tm.train(train_mode)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape and _rel(got, ref) <= FWD_TOL
    assert tm.output_shape == (1, *ref.shape[1:])


def test_conv1d_refuses_token_norms_and_unflattened_dense():
    with pytest.raises(ValueError, match="1-d maps take"):
        DeepcvModule((12, 3), {"act_fn": "relu", "architecture": [
            {"conv1d": {"kernel_size": [3], "out_channels": 4, "layer_norm": {}}}]},
            device="cpu")
    with pytest.raises(ValueError, match="after 'flatten'"):
        DeepcvModule((12, 3), {"act_fn": "relu", "architecture": [
            {"conv1d": {"kernel_size": [3], "out_channels": 4}},
            {"fully_connected": {"out_features": 2}}]}, device="cpu")


def test_conv3d_refuses_other_ranks_and_same_at_stride_two():
    with pytest.raises(ValueError, match=r"\(conv3d\): input must be 3-d spatial"):
        DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": [
            {"conv3d": {"kernel_size": [3, 3, 3], "out_channels": 4}}]}, device="cpu")
    with pytest.raises(NotImplementedError, match="'SAME' is ported for stride-1"):
        DeepcvModule((4, 8, 8, 3), {"act_fn": "relu", "architecture": [
            {"conv3d": {"kernel_size": [3, 3, 3], "out_channels": 4, "padding": "same",
                        "stride": 2}}]}, device="cpu")


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #

def _clip_sets(frames=6, size=12):
    return {"trainset": _Set((frames, size, size, 3), 4)}


@pytest.fixture(scope="module")
def video_classifier():
    t_hp, j_hp = _conf("video_classifier_model")
    sets = _clip_sets()
    jm = jax_create_model(sets, j_hp)
    jvars = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 11)
    tm = load_jax_variables(create_model(sets, t_hp, device="cpu"), jvars)
    return jm, jvars, tm


def test_video_classifier_counts_and_no_kernel(video_classifier):
    """17,556 parameters in JAX; the port's the same less the stem's 2,160
    zero-padded input rows (27 x 5 x 16); no conv takes the kernel."""
    _, jvars, tm = video_classifier
    assert sum(a.size for a in jax.tree_util.tree_leaves(jvars["params"])) == 17_556
    assert tm.capacity() == 15_396
    assert [tuple(m.weight.shape) for m in tm.modules() if isinstance(m, dnn.ConvNd)] == \
        [(16, 3, 3, 3, 3), (32, 16, 3, 3, 3)]
    assert not any(isinstance(m, dnn.FusedConv2d) for m in tm.modules())


@pytest.mark.parametrize("train_mode", [False, True])
def test_video_classifier_forward_matches_jax(video_classifier, train_mode):
    jm, jvars, tm = video_classifier
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    x = np.random.default_rng(12).uniform(size=(3, 6, 12, 12, 3)).astype(np.float32)
    ref = jm.apply(jvars, jnp.asarray(x), train=train_mode)
    ref = np.asarray(ref[0] if isinstance(ref, tuple) else ref)
    with torch.no_grad():
        got = tm.train(train_mode)(torch.from_numpy(x)).numpy()
    tm.load_state_dict(state)
    assert got.shape == ref.shape == (3, 4) and _rel(got, ref) <= FWD_TOL


def test_video_classifier_first_step_gradients_match_jax(video_classifier):
    jm, jvars, tm = video_classifier
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    x = np.random.default_rng(13).uniform(size=(4, 6, 12, 12, 3)).astype(np.float32)
    y = np.array([0, 3, 1, 2])

    def loss(params):
        out, _ = jm.apply({**jvars, "params": params}, jnp.asarray(x), train=True)
        return jax_ce(out, jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jvars["params"])
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                   "batch_stats": jvars["batch_stats"]}, tm)
    ref = {k: v for k, v in ref.items() if "running_" not in k}
    tm.train().zero_grad()
    tloss = cross_entropy_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    tm.load_state_dict(state)
    _assert_grads(tm, ref, tloss, jloss)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_flow_model_forward_and_gradients_match_jax(levels):
    """The refiner shared by every level (its three convs once), the MSE
    of one batch against a flow target and every gradient."""
    jm = jv.FlowModel((16, 16, 6), levels=levels, features=8)
    jvars = _draw(jax.eval_shape(lambda: jm.init(0)), 14 + levels)
    tm = load_jax_variables(tv.FlowModel((16, 16, 6), levels=levels, features=8,
                                         device="cpu"), jvars)
    assert [n for n, _ in tm.named_children()] == ["c1", "c2", "out"]
    rng = np.random.default_rng(15)
    x = rng.uniform(size=(2, 16, 16, 6)).astype(np.float32)
    y = rng.integers(-2, 3, size=(2, 1, 1, 2)).astype(np.float32) * np.ones((1, 16, 16, 1),
                                                                             np.float32)

    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(x))
        return jax_mse(out, jnp.asarray(y)), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jvars["params"])
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, tm)
    out = tm(torch.from_numpy(x))
    assert out.shape == (2, 16, 16, 2) and _rel(out.detach(), jout) <= FWD_TOL
    tloss = mse_loss(out, torch.from_numpy(y))
    tloss.backward()
    _assert_grads(tm, ref, tloss, jloss)


def test_conf_flow_model_count():
    """The conf's model (levels 3, features 32) on the 32x32 pair: 14,754
    parameters in both packages (17 refiner input channels, no padding)."""
    t_p, j_p = _conf("optical_flow_model")
    sets = {"trainset": _Set((32, 32, 6), None)}
    assert tv.create_flow_model(sets, t_p, device="cpu").capacity() == 14_754
    assert jv.create_flow_model(sets, j_p).capacity() == 14_754


@pytest.mark.parametrize("strides", [(1, 2), (2, 2)])
@pytest.mark.parametrize("pool", ["soft_argmax", "gap"])
@pytest.mark.parametrize("temporal", ["gru", "transformer", "mean"])
def test_temporal_model_forward_and_gradients_match_jax(temporal, pool, strides):
    """Forward within 1e-4 and first-step gradients at rtol 1e-3 on 6-frame
    12x12 clips (flax's asymmetric 'SAME' padding at stride 2, its GELU and
    eps, its GRU cell), and equal parameter counts."""
    jm = jv.TemporalVideoModel((6, 12, 12, 3), 4, temporal=temporal, pool=pool,
                               encoder_strides=strides)
    jvars = _draw(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))), 16)
    tm = load_jax_variables(tv.TemporalVideoModel(
        (6, 12, 12, 3), 4, temporal=temporal, pool=pool, encoder_strides=strides,
        device="cpu"), jvars)
    assert tm.capacity() == sum(a.size for a in jax.tree_util.tree_leaves(jvars))
    rng = np.random.default_rng(17)
    x = rng.uniform(size=(3, 6, 12, 12, 3)).astype(np.float32)
    y = np.array([0, 3, 1])

    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(x))
        return jax_ce(out, jnp.asarray(y)), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jvars["params"])
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, tm)
    out = tm.train()(torch.from_numpy(x))
    assert out.shape == (3, 4) and _rel(out.detach(), jout) <= FWD_TOL
    tloss = cross_entropy_loss(out, torch.from_numpy(y))
    tloss.backward()
    _assert_grads(tm, ref, tloss, jloss)


@pytest.mark.parametrize("temporal,params", [("gru", 13_668), ("transformer", 16_196),
                                             ("mean", 7_396)])
def test_conf_temporal_model_counts(temporal, params):
    t_p, j_p = _conf("temporal_classifier_model")
    sets = _clip_sets()
    tm = tv.create_temporal_model(sets, {**t_p, "temporal": temporal}, device="cpu")
    jm = jv.create_temporal_model(sets, {**j_p, "temporal": temporal})
    assert tm.capacity() == jm.capacity() == params
    assert not any(isinstance(m, dnn.FusedConv2d) for m in tm.modules())


@pytest.mark.parametrize("kwargs,shape,match", [
    ({"encoder_strides": (1, 2, 2)}, None, "encoder_strides must match encoder_features length"),
    ({"pool": "max"}, None, "unknown pool 'max' \\(expected soft_argmax\\|gap\\)"),
    ({"temporal": "lstm"}, None,
     "unknown temporal model 'lstm' \\(expected transformer\\|gru\\|mean\\)"),
    ({}, (2, 12, 12, 3), "expected \\(N, F, H, W, C\\) clips, got \\(2, 12, 12, 3\\)")])
def test_temporal_model_refusals_carry_the_jax_messages(kwargs, shape, match):
    def jax_build():
        jm = jv.TemporalVideoModel((6, 12, 12, 3), 4, **kwargs)
        if shape is None:
            return jm.init(jax.random.PRNGKey(0))
        v = jm.init(jax.random.PRNGKey(0))
        return jm.apply(v, jnp.zeros(shape))

    def torch_build():
        tm = tv.TemporalVideoModel((6, 12, 12, 3), 4, device="cpu", **kwargs)
        return tm(torch.zeros(shape))

    for build in (jax_build, torch_build):
        with pytest.raises(ValueError, match=match):
            build()


def test_temporal_model_refuses_a_non_clip_input_shape():
    for cls, kw in ((jv.TemporalVideoModel, {}), (tv.TemporalVideoModel, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"expects \(F, H, W, C\) input_shape, got "
                                             r"\(12, 12, 3\)"):
            cls((12, 12, 3), 4, **kw)


# --------------------------------------------------------------------------- #
# the pipelines
# --------------------------------------------------------------------------- #

def test_create_pipelines_lists_all_six_packages():
    pipes = create_pipelines()
    assert TASK_PACKAGES == ("classification", "keypoints", "detection", "pose",
                             "segmentation", "video")
    jax_pipes = jax_create_pipelines()
    assert set(pipes) == set(jax_pipes) and len(pipes) == 24
    for name in VIDEO_PIPELINES:
        assert [n.name for n in pipes[name].nodes] == [n.name for n in jax_pipes[name].nodes]
        assert pipes[name].tags == jax_pipes[name].tags == {"train", "video"}
    assert set(create_pipelines({"enabled": ["video"]})) == {*VIDEO_PIPELINES, "__default__"}
    assert set(create_pipelines({"disabled": ["video"]})) == set(pipes) - set(VIDEO_PIPELINES)
    with pytest.raises(ValueError, match="Unknown task package"):
        create_pipelines({"enabled": ["audio"]})


@pytest.fixture(scope="module")
def video_project(tmp_path_factory):
    """A project whose conf is the repo's, with the flow and clip catalog
    entries cut to 20 + 4 pairs of 16x16 and 20 + 4 clips."""
    root = tmp_path_factory.mktemp("video_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "flow_train": {"type": "synthetic_flow", "n": 20, "image_size": 16, "max_shift": 2},
        "flow_test": {"type": "synthetic_flow", "train": False, "n": 4, "image_size": 16,
                      "max_shift": 2},
        "clips_train": {"type": "synthetic_clips", "n": 20, "frames": 6, "image_size": 12},
        "clips_test": {"type": "synthetic_clips", "train": False, "n": 4, "frames": 6,
                       "image_size": 12}}))
    return root


@pytest.mark.parametrize("pipeline,params,metric", [
    ("train_optical_flow", 14_754, "valid_epe"),
    ("train_video_classifier", 15_396, "valid_accuracy"),
    ("train_temporal_classifier", 13_668, "valid_accuracy")])
def test_video_pipeline_runs_end_to_end_on_cpu(video_project, tmp_path, pipeline, params,
                                               metric):
    """The conf's model and hp, cut to one epoch at batch 4 and validated
    after it: finite losses and the validation metric, the conf's count, no
    kernel conv."""
    p = pipeline
    store = cli_run([f"--pipeline={p}", "--project-path", str(video_project), "--device", "cpu",
                     "--params", f"{p}.epochs:1,{p}.batch_size:4,{p}.validate_every_epochs:1,"
                                 f"{p}.output_path:{tmp_path}"])
    h = store["train_results"]["history"]
    assert h["steps"] == len(store["datasets"]["trainset"]) // 4 > 0
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert np.isfinite(h["valid"][-1][metric])
    model = store["model"]
    assert model.device.type == "cpu" and model.capacity() == params
    assert not any(isinstance(m, dnn.FusedConv2d) for m in model.modules())
    if metric == "valid_accuracy":
        assert 0.0 <= h["valid"][-1][metric] <= 1.0

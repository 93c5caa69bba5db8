"""HRNet in the port against the JAX package, on the CPU: the blocks
(``ParallelConvolution`` with its groups snapped, ``MultiresolutionFusion``
with and without ``reuse_scaling_convs`` and the new branch, the stem, the
V1, V2 and V2p heads) in train and eval mode through the spec engine,
``MeanOnlyBatchNorm`` and ``layer_nrm_and_mean_batch_nrm``, a
``residual_link`` zipped over streams with a ref of fewer streams, the
``interpolate`` node, and the conf's ``semantic_segmentation_model``
through ``create_segmenter``: forward, first-step gradients, parameter
count and ``describe()``.

The JAX variables are drawn with numpy into the shapes of
``jax.eval_shape(init)`` (the running means too, so eval mode subtracts
something) and carried across by ``deepcv_tpu_torch.interop``."""
import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.pipelines import segmentation as jseg
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu.spec import creators as jcreators
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import hrnet
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines import segmentation as tseg
from deepcv_tpu_torch.spec import DeepcvModule, SpecError, creators

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
NORM_TOL = 1e-5       # one norm or one resize, summed in another order
#: the conf's HRNet norm, as hrnet_backbone sets it
LNMBN = {"eps": 1e-5, "elementwise_affine": True, "momentum": 0.1}
#: the JAX models pad a 3-channel stem's input rows to 8, with zeros
PADDED_STEM_ROWS = 3 * 3 * 5 * 32


def _draw(shapes, seed):
    """Variables for the shapes of a JAX init: kernels normal with variance
    1 / fan-in, norm scales in [0.5, 1.5), biases and running means normal
    with std 0.1, running variances in [0.5, 1.5)."""
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


def _pair(hp, input_shape, seed):
    jm = JaxModule(input_shape, hp)
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed)
    tm = DeepcvModule(input_shape, hp, device="cpu")
    load_jax_variables(tm, jv)
    return jm, jv, tm


def _streams(y):
    return [np.asarray(t) for t in y] if isinstance(y, (list, tuple)) else [np.asarray(y)]


def _forward_both(jm, jv, tm, x, train):
    """Both forwards; in train mode also both sets of running statistics
    after it (the port's as a JAX-keyed state dict)."""
    if train:
        y, state = jm.apply(jv, jnp.asarray(x), train=True, mutable=["batch_stats"])
        with torch.no_grad():
            got = tm.train()(torch.from_numpy(x))
        sd = jax_to_torch_state_dict({"params": jv["params"], "batch_stats": jax.tree_util.tree_map(
            np.asarray, dict(state["batch_stats"]))}, tm)
        buffers = dict(tm.named_buffers())
        return _streams(y), _streams(got), {k: v for k, v in sd.items() if k in buffers}
    y = jm.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    return _streams(y), _streams(got), None


def _check(jm, jv, tm, x, train, tol=FWD_TOL):
    ref, got, stats = _forward_both(jm, jv, tm, x, train)
    assert [r.shape for r in ref] == [g.shape for g in got]
    for r, g in zip(ref, got):
        assert np.isfinite(g).all() and _rel(g, r) <= tol
    if stats is not None:
        buffers = dict(tm.named_buffers())
        for key, want in stats.items():
            np.testing.assert_allclose(buffers[key].numpy(), want.numpy(), rtol=0, atol=1e-6,
                                       err_msg=key)
    return got


def _hp(arch, **glob):
    return {"act_fn": "relu", "preactivation": True, "layer_nrm_and_mean_batch_nrm": LNMBN,
            "architecture": arch, **glob}


STEM = {"hrnet_input_stem": {"out_channels": 16, "conv_count": 2}}
FUSE_NB = {"multiresolution_fusion": {"create_new_branch": True, "new_branch_channels": 16,
                                      "reuse_scaling_convs": True}}
#: three streams (8x8, 4x4, 2x2 on 32x32 images) of 16 channels
THREE_STREAMS = [STEM, FUSE_NB, FUSE_NB]


def _x(n=2, size=32, seed=1):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


# --------------------------------------------------------------------------- #
# the blocks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("train", [False, True])
def test_stem_matches_jax(train):
    """The stem's layer units, pre-activation with the conf's norm, on the
    3-channel image (the JAX stem kernel's 5 padded rows are cut)."""
    jm, jv, tm = _pair(_hp([STEM]), (32, 32, 3), 2)
    stem = tm.module.nodes["_submodule_0_hrnet_input_stem"]
    assert [tuple(layer.op.weight.shape) for layer in stem.layers] == [(16, 3, 3, 3),
                                                                      (16, 16, 3, 3)]
    assert stem.jax_names["LayerNorm_0"] == "layers.0.norms.1"
    got = _check(jm, jv, tm, _x(), train)
    assert got[0].shape == (2, 8, 8, 16)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("glob", [{}, {"preactivation": False, "batch_norm": {"momentum": 0.1}}],
                         ids=["conf_norm", "post_act_batch_norm"])
def test_parallel_conv_snaps_groups_and_matches_jax(glob, train):
    """groups [8, 6] on 16 channels: 8 and 4 (6, then 5, do not divide
    16); the 5x5 stream's kernel is (5, 5, 4, 16) in JAX, (16, 4, 5, 5)
    here. With batch_norm beside the conf's norm, each stream has three
    norms, numbered per class."""
    pconv = {"parallel_conv": ["pc", {"kernel_size": [[3, 3], [5, 5]], "out_channels": 16,
                                      "groups": [8, 6]}]}
    jm, jv, tm = _pair(_hp([STEM, FUSE_NB, pconv], **glob), (32, 32, 3), 3)
    pc = tm.module.nodes["pc"]
    assert [layer.op.groups for layer in pc.layers] == [8, 4]
    jparams = jv["params"]["node_impls_pc"]
    assert jparams["stream1_conv"]["kernel"].shape == (5, 5, 4, 16)
    assert tuple(pc.layers[1].op.weight.shape) == (16, 4, 5, 5)
    if glob:
        assert pc.jax_names["BatchNorm_1"] == "layers.1.norms.0"
        assert pc.jax_names["LayerNorm_1"] == "layers.1.norms.2"
    _check(jm, jv, tm, _x(), train)


def test_parallel_conv_refuses_a_scalar_or_a_single_pair():
    for ks in (3, [3, 3]):
        arch = [STEM, {"parallel_conv": {"kernel_size": ks, "out_channels": 16}}]
        with pytest.raises(ValueError, match="sequence of kernel-size pairs"):
            DeepcvModule((32, 32, 3), _hp(arch), device="meta")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("new_branch", [False, True])
def test_multiresolution_fusion_matches_jax(new_branch, reuse, train):
    """A fusion over three streams of 16, 24 and 32 channels: two-step down
    paths (0 to 2), ups from both sides, the new branch or not, shared
    scaling convs or one per site; the parameter count is the JAX one."""
    widen = {"parallel_conv": {"kernel_size": [[3, 3]], "out_channels": [16, 24, 32]}}
    fuse = {"multiresolution_fusion": ["fuse", {"create_new_branch": new_branch,
                                                "reuse_scaling_convs": reuse}]}
    jm, jv, tm = _pair(_hp(THREE_STREAMS + [widen, fuse]), (32, 32, 3), 4)
    jnames = set(jv["params"]["node_impls_fuse"])
    fusion = tm.module.nodes["fuse"]
    assert set(fusion.convs) == jnames
    if reuse:
        assert "down_shared_16to32" in jnames and "down_shared_32to32" in jnames
    else:
        assert {"down_0to2_0", "down_0to2_1", "up_2to0"} <= jnames
    assert ("down_newbranch" in jnames or "down_shared_32to64" in jnames) == new_branch
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jv["params"]))
    assert tm.capacity() == n_jax - 3 * 3 * 5 * 16
    got = _check(jm, jv, tm, _x(), train)
    assert [g.shape[-1] for g in got] == [16, 24, 32] + ([64] if new_branch else [])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("head", [
    {"hrnet_repr_head_v1": {}}, {"hrnet_repr_head_v2": {"out_channels": 24}},
    {"hrnet_repr_head_vZ": {}}, {"hrnet_repr_head_v2p": {"pyramid_levels": 3}}],
    ids=["v1", "v2", "vZ", "v2p"])
def test_representation_heads_match_jax(head, train):
    jm, jv, tm = _pair(_hp(THREE_STREAMS + [head]), (32, 32, 3), 5)
    got = _check(jm, jv, tm, _x(), train)
    name = next(iter(head))
    want = {"hrnet_repr_head_v1": [(2, 8, 8, 16)], "hrnet_repr_head_v2": [(2, 8, 8, 24)],
            "hrnet_repr_head_vZ": [(2, 8, 8, 48)],
            "hrnet_repr_head_v2p": [(2, 8, 8, 48), (2, 4, 4, 48), (2, 2, 2, 48)]}[name]
    assert [g.shape for g in got] == want


# --------------------------------------------------------------------------- #
# the norm, the links, the resize
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("train", [False, True])
def test_layer_nrm_and_mean_batch_nrm_matches_jax(train):
    """The technique after a K2 conv (post-activation): the mean-only batch
    norm, then a layer norm over each pixel's channels (flax's LayerNorm on
    the last axis), within 1e-5; after a training forward the running mean
    within 1e-6 of the JAX one."""
    hp = {"act_fn": "relu", "layer_nrm_and_mean_batch_nrm": LNMBN,
          "architecture": [{"conv2d": ["c", {"kernel_size": [3, 3], "out_channels": 8}]}]}
    jm, jv, tm = _pair(hp, (16, 16, 3), 6)
    norms = tm.module.nodes["c"].norms
    assert [type(m) for m in norms] == [dnn.MeanOnlyBatchNorm, dnn.LayerNorm]
    before = norms[0].running_mean.clone()
    _check(jm, jv, tm, _x(size=16, seed=7), train, tol=NORM_TOL)
    assert train == (not torch.equal(before, norms[0].running_mean))


def test_mean_only_batch_norm_running_mean_after_one_training_forward():
    """The running mean after one training forward, ``(1 - m) * running +
    m * batch mean`` with the batch mean in float32, within 1e-6 of JAX's,
    at momentum 0.3; the output is the input less the batch mean."""
    from deepcv_tpu.ops import nn as jnn
    x = (np.random.default_rng(8).normal(size=(3, 5, 6, 4)) + 2.0).astype(np.float32)
    jmod = jnn.MeanOnlyBatchNorm(momentum=0.3)
    jvars = {"batch_stats": {"mean": np.full(4, 0.5, np.float32)}}
    ref, state = jmod.apply(jvars, jnp.asarray(x), use_running_average=False,
                            mutable=["batch_stats"])
    port = dnn.MeanOnlyBatchNorm(4, momentum=0.3)
    port.running_mean.fill_(0.5)
    got = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(state["batch_stats"]["mean"]), rtol=0, atol=1e-6)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= NORM_TOL
    evaled = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(evaled.permute(0, 2, 3, 1).numpy(),
                               x - port.running_mean.numpy(), rtol=0, atol=1e-6)
    assert dnn.NormTechnique.LAYER_NRM_AND_MEAN_BATCH_NRM in dnn.NormTechnique.PORTED


def test_residual_link_in_parallel_skips_the_streams_a_ref_lacks():
    """``apply_in_parallel`` over three streams with refs of two streams
    and of three: stream 2 adds only the second ref, as the JAX callback
    does; without it a list is not zipped."""
    rng = np.random.default_rng(9)
    shapes = [(2, 8, 8, 4), (2, 4, 4, 4), (2, 2, 2, 4)]
    x, r3 = ([rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(2))
    r2 = [rng.normal(size=s).astype(np.float32) for s in shapes[:2]]
    params = {"apply_in_parallel": True, "allow_scaling": True}
    jcb = jcreators.get_creator("residual_link")["fn"](params, None, "res")
    tcb = creators.get_creator("residual_link")["fn"](params, None, "res", None)
    ref = jcb([jnp.asarray(a) for a in x], [[jnp.asarray(a) for a in r2],
                                           [jnp.asarray(a) for a in r3]])

    def nchw(arrays):
        return [torch.from_numpy(a).permute(0, 3, 1, 2) for a in arrays]

    got = tcb(nchw(x), [nchw(r2), nchw(r3)])
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(got[2].permute(0, 2, 3, 1).numpy(), x[2] + r3[2], rtol=0,
                               atol=1e-6)
    assert creators.get_creator("dense_link")["fn"](params, None, "cat", None).apply_in_parallel
    assert not creators.get_creator("residual_link")["fn"]({}, None, "r", None).apply_in_parallel


@pytest.mark.parametrize("node,out_hw", [({"size": [12, 20]}, (12, 20)),
                                         ({"scale": 2}, (16, 12)),
                                         ({"scale": 0.5, "method": "linear"}, (4, 3)),
                                         ({"size": [8, 6]}, (8, 6))],
                         ids=["size", "scale_up", "scale_down", "same_size"])
def test_interpolate_node_matches_jax(node, out_hw):
    hp = {"act_fn": "relu", "architecture": [{"upsample": ["up", node]}]}
    jm, jv, tm = _pair(hp, (8, 6, 5), 10)
    x = np.random.default_rng(11).normal(size=(2, 8, 6, 5)).astype(np.float32)
    got = _check(jm, jv, tm, x, False, tol=NORM_TOL)
    assert got[0].shape == (2, *out_hw, 5) and tm.output_shape == (1, *out_hw, 5)


@pytest.mark.parametrize("node,err", [({"size": [4, 4], "method": "cubic"}, NotImplementedError),
                                      ({}, ValueError)])
def test_interpolate_node_refuses_other_methods_and_no_target(node, err):
    hp = {"act_fn": "relu", "architecture": [{"interpolate": node}]}
    with pytest.raises(err, match="cubic" if node else "size"):
        DeepcvModule((8, 8, 3), hp, device="meta")
    with pytest.raises(NotImplementedError, match="'cubic'"):
        dnn.interpolate(torch.zeros(1, 2, 4, 4), (8, 8), method="cubic")


def test_hrnet_node_refuses_token_input():
    hp = {"act_fn": "relu", "architecture": [
        {"patch_embed": {"patch_size": 4, "embed_dim": 8}}, FUSE_NB]}
    with pytest.raises(ValueError, match="image feature maps"):
        DeepcvModule((8, 8, 3), hp, device="meta")


# --------------------------------------------------------------------------- #
# the conf's segmenter
# --------------------------------------------------------------------------- #

class _Set:
    """The ``datasets['trainset']`` view that both ``create_segmenter``s read."""

    def __init__(self, classes, image_shape):
        self.classes, self.image_shape = classes, image_shape
        self.dataset = self


@pytest.fixture(scope="module")
def conf_segmenter():
    """The conf's semantic_segmentation_model (hrnet_backbone) through both
    ``create_segmenter``s at 32x32 with 4 classes, JAX variables drawn."""
    datasets = {"trainset": _Set(list(tseg.SEG_CLASSES), (32, 32, 3))}
    tm = tseg.create_segmenter(datasets, load_yaml(os.path.join(
        REPO, "conf/base/parameters.yml"))["semantic_segmentation_model"], device="cpu")
    jm = jseg.create_segmenter(datasets, jax_load_yaml(os.path.join(
        REPO, "conf/base/parameters.yml"))["semantic_segmentation_model"])
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 12)
    load_jax_variables(tm, jv)
    return jm, jv, tm


@pytest.mark.parametrize("train", [False, True])
def test_conf_segmenter_forward_matches_jax(conf_segmenter, train):
    jm, jv, tm = conf_segmenter
    state = copy.deepcopy(tm.state_dict())
    got = _check(jm, jv, tm, _x(seed=13), train)
    tm.load_state_dict(state)
    assert got[0].shape == (2, 32, 32, 4)


#: biases whose conv feeds a pre-activation mean-only batch norm directly
#: (the stem's first conv, the first parallel_conv of each stage): in train
#: mode the batch mean takes them out, so their gradient is zero but for
#: rounding, in both packages
CANCELLED_BIAS = re.compile(
    r"(hrnet_input_stem\.layers\.0|_submodule_[26]_parallel_conv\.layers\.\d)\.op\.bias$")


def test_conf_segmenter_first_step_gradients_match_jax(conf_segmenter):
    """Train mode (the mean-only batch norm on the batch's means): the
    segmentation loss and every parameter's gradient within rtol 1e-3 and
    1e-3 of its tensor's largest entry; the gradients of the biases the
    batch mean cancels below 1e-6 of the largest gradient on both sides."""
    jm, jv, tm = conf_segmenter
    state = copy.deepcopy(tm.state_dict())
    rng = np.random.default_rng(14)
    x = _x(n=4, seed=15)
    y = rng.integers(0, 4, size=(4, 32, 32)).astype(np.int32)

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        return jseg.segmentation_loss(out, jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jv["params"])
    grads = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                     "batch_stats": jv["batch_stats"]}, tm)
    got = dict(tm.named_parameters())
    ref = {k: v for k, v in grads.items() if k in got}
    tm.train()
    for p in tm.parameters():
        p.grad = None
    tloss = tseg.segmentation_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    tm.load_state_dict(state)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(got) == set(ref)
    largest = max(float(np.abs(w.numpy()).max()) for w in ref.values())
    assert sum(bool(CANCELLED_BIAS.search(k)) for k in ref) == 6
    for key, want in ref.items():
        want = want.numpy()
        if CANCELLED_BIAS.search(key):
            assert max(np.abs(want).max(), np.abs(got[key].grad.numpy()).max()) \
                <= 1e-6 * largest, key
            continue
        np.testing.assert_allclose(got[key].grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()) + 1e-8,
                                   err_msg=key)


def test_conf_segmenter_count_and_describe(conf_segmenter):
    """90,698 parameters in JAX at 32x32, the port's the same less the
    stem's 1,440 zero-padded kernel rows; the head is one K2 conv (32 to 4,
    1x1); ``describe()`` of the backbone alone lists each node's streams
    as channel-last shapes, as the JAX one does."""
    jm, jv, tm = conf_segmenter
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jv["params"]))
    assert n_jax == 90_698 and tm.capacity() == n_jax - PADDED_STEM_ROWS
    head = tm.module.nodes["seg_head"].op
    assert isinstance(head, dnn.FusedConv2d) and tuple(head.weight.shape) == (4, 32, 1, 1)
    assert sum(isinstance(m, dnn.FusedConv2d) for m in tm.modules()) == 1
    backbone = load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))["models"][2][
        "hrnet_backbone"]
    tb = DeepcvModule((32, 32, 3), backbone, device="meta")
    jd = JaxModule((32, 32, 3), jax_load_yaml(os.path.join(
        REPO, "conf/base/parameters.yml"))["models"][2]["hrnet_backbone"]).describe()
    assert tb.node_shapes == jd.features_shapes
    assert tb.node_shapes["stage_2_fusion"] == [(1, 8, 8, 32), (1, 4, 4, 32), (1, 2, 2, 32)]
    text = str(tb.describe())
    assert "out=[(1, 8, 8, 32), (1, 4, 4, 32)]" in text
    assert "<- ['stage_1_fusion', 'stage_2_fusion']" in text


def test_a_stream_list_output_comes_back_channel_last():
    hp = _hp([STEM, FUSE_NB])
    m = DeepcvModule((32, 32, 3), hp, device="cpu")
    out = m(torch.from_numpy(_x()))
    assert isinstance(out, list) and [tuple(t.shape) for t in out] == [(2, 8, 8, 16),
                                                                       (2, 4, 4, 16)]
    assert m.output_shape == [(1, 8, 8, 16), (1, 4, 4, 16)]
    with pytest.raises(SpecError, match="undefined"):
        DeepcvModule((32, 32, 3), _hp([STEM, {"residual_link": {"_from": "nope"}}]),
                     device="meta")
    assert isinstance(m.module.nodes["_submodule_1_multiresolution_fusion"],
                      hrnet.MultiresolutionFusion)

"""The detection slice of the port against the JAX package, on the CPU:
the synthetic generators (byte-equal) and the FPN loader's default bounds,
the losses, metrics, decoders and mAP on the same logits (random ones and
perfect ones, whose scores tie), ``interpolate``'s nearest method,
``FeaturePyramid`` with and without its head, the conf's two detectors
(forward, first-step gradients, parameter counts) and config 12's,
``train_fpn_detector``'s refusals, and both pipelines through ``run``."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.data.datasets import load_dataset as jax_load_dataset
from deepcv_tpu.ops.nn import interpolate as jax_interpolate
from deepcv_tpu.pipelines import detection as jd
from deepcv_tpu.pipelines.registry import create_pipelines as jax_create_pipelines
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data.datasets import load_dataset
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import jax_to_torch_state_dict, load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines import detection as td
from deepcv_tpu_torch.pipelines.registry import TASK_PACKAGES, create_pipelines
from deepcv_tpu_torch.spec import DeepcvModule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
GRAD_RTOL = 1e-3      # its first-step gradient bound
TOL = 1e-6            # the same float32 values through sigmoid, exp or sums
GRIDS = (8, 4)


def _draw(shapes, seed):
    """Variables for the shapes of a JAX init: kernels normal with variance
    1 / fan-in, norm scales and running variances in [0.5, 1.5), biases and
    running means normal with std 0.1."""
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


def _jax_out(out):
    return out[0] if isinstance(out, tuple) else out


# --------------------------------------------------------------------------- #
# generators and loaders
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("train", [True, False])
def test_generators_are_byte_equal_to_jax(train):
    pairs = [(td.generate_shapes_dataset(n=10, image_size=24, grid=6, seed=3, train=train),
              jd.generate_shapes_dataset(n=10, image_size=24, grid=6, seed=3, train=train)),
             (td.generate_shapes_dataset_fpn(n=10, image_size=32, grids=(8, 4, 2),
                                             size_bounds=(0.25, 0.4), seed=4, train=train),
              jd.generate_shapes_dataset_fpn(n=10, image_size=32, grids=(8, 4, 2),
                                             size_bounds=(0.25, 0.4), seed=4, train=train))]
    for t, j in pairs:
        for a, b in ((t.images, j.images), (t.targets, j.targets)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert t.classes == list(j.classes) and t.name == j.name
    assert pairs[1][0].targets.shape == (10, 84, 8) and pairs[1][0].targets[..., 0].sum() >= 10
    with pytest.raises(ValueError, match="one size bound per level boundary"):
        td.generate_shapes_dataset_fpn(n=2, grids=(8, 4, 2))


@pytest.mark.parametrize("grids", [[8, 4], [8, 4, 2]], ids=["2_levels", "3_levels"])
def test_fpn_loader_default_bounds_match_jax(grids):
    """The catalog loaders with no size bounds: (0.3,) for two levels,
    evenly spaced over (0.15, 0.6) for more; the same bytes as JAX's."""
    entry = {"type": "synthetic_shapes_fpn", "n": 12, "image_size": 32, "grids": grids}
    t, j = load_dataset(dict(entry)), jax_load_dataset(dict(entry))
    assert t.targets.tobytes() == j.targets.tobytes() and t.images.tobytes() == j.images.tobytes()
    entry["train"] = False
    assert load_dataset(dict(entry)).images.tobytes() == jax_load_dataset(
        dict(entry)).images.tobytes()


def test_catalog_shapes_entries_load():
    catalog = load_yaml(os.path.join(REPO, "conf/base/catalog.yml"))
    for name, shape in (("shapes_test", (256, 8, 8, 8)), ("shapes_fpn_test", (256, 80, 8))):
        ds = load_dataset(catalog[name])
        assert ds.targets.shape == shape and ds.images.shape == (256, 32, 32, 3)


# --------------------------------------------------------------------------- #
# losses, metrics, decoders, mAP
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def grid_case():
    """Targets of 4 images and random logits for them, single grid and flat
    FPN layout."""
    t = td.generate_shapes_dataset(n=4, seed=5).targets
    tf = td.generate_shapes_dataset_fpn(n=4, seed=5).targets
    rng = np.random.default_rng(6)
    return (_noisy(t, rng), t, _noisy(tf, rng), tf)


def _logit(v):
    v = np.clip(v, 1e-4, 1 - 1e-4)
    return np.log(v / (1 - v))


def _noisy(target, rng):
    """Logits near the targets': objectness and class shifted by +-1.5 plus
    noise, box fields the targets' logits plus noise (so that some boxes
    overlap their object by IoU 0.5 and some do not)."""
    noise = rng.normal(size=target.shape).astype(np.float32)
    p = 3.0 * (target - 0.5) + noise
    p[..., 1:5] = _logit(target[..., 1:5]) + 0.5 * noise[..., 1:5]
    return p.astype(np.float32)


def _perfect(target):
    """Logits that decode to the targets: objectness +-8, the box fields'
    logits, the class +-8; every object cell scores alike, as do the empty
    ones."""
    p = np.where(target > 0.5, 8.0, -8.0).astype(np.float32)
    p[..., 1:5] = _logit(target[..., 1:5])
    return p.astype(np.float32)


def test_losses_and_metrics_match_jax(grid_case):
    p, t, pf, tf = grid_case
    for tl, jl, pp, tt in ((td.detection_loss, jd.detection_loss, p, t),
                           (td.detection_loss_focal, jd.detection_loss_focal, pf, tf)):
        got = float(tl(torch.from_numpy(pp), torch.from_numpy(tt)))
        ref = float(jl(jnp.asarray(pp), jnp.asarray(tt)))
        assert abs(got - ref) <= TOL * abs(ref)
    for pp, tt in ((p, t), (pf, tf)):
        got = float(td.objectness_accuracy(torch.from_numpy(pp), torch.from_numpy(tt)))
        assert abs(got - float(jd.objectness_accuracy(jnp.asarray(pp), jnp.asarray(tt)))) <= TOL
    got = float(td.mean_iou_on_objects(torch.from_numpy(p), torch.from_numpy(t)))
    ref = float(jd.mean_iou_on_objects(jnp.asarray(p), jnp.asarray(t)))
    assert abs(got - ref) <= TOL and 0.0 < got < 1.0


def _check_decode(got, ref):
    """Boxes and scores within 1e-6 (XLA's sigmoid and torch's round a
    float32 ulp apart now and then), classes and NMS's zeros exact."""
    (gb, gs, gc), (rb, rs, rc) = [t.numpy() for t in got], [np.asarray(r) for r in ref]
    assert gb.shape == rb.shape and np.abs(gb - rb).max() <= TOL
    assert np.abs(gs - rs).max() <= TOL
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_array_equal(gs == 0, rs == 0)


@pytest.mark.parametrize("nms_iou,class_aware", [(None, True), (0.5, True), (0.3, False)])
@pytest.mark.parametrize("perfect", [False, True], ids=["random", "perfect"])
def test_decoders_match_jax(grid_case, nms_iou, class_aware, perfect):
    p, t, pf, tf = grid_case
    if perfect:
        p, pf = _perfect(t), _perfect(tf)
    _check_decode(td.decode_detections(torch.from_numpy(p), 16, nms_iou, class_aware),
                  jd.decode_detections(jnp.asarray(p), 16, nms_iou, class_aware))
    _check_decode(td.decode_detections_flat(torch.from_numpy(pf), GRIDS, 16, nms_iou,
                                            class_aware),
                  jd.decode_detections_flat(jnp.asarray(pf), GRIDS, 16, nms_iou, class_aware))


@pytest.mark.parametrize("perfect", [False, True], ids=["random", "perfect"])
def test_map50_matches_jax(grid_case, perfect):
    p, t, pf, tf = grid_case
    if perfect:
        p, pf = _perfect(t), _perfect(tf)
    got = float(td.map50(torch.from_numpy(p), torch.from_numpy(t)))
    ref = float(jd.map50(jnp.asarray(p), jnp.asarray(t)))
    got_f = float(td.map50_flat(torch.from_numpy(pf), torch.from_numpy(tf), GRIDS))
    ref_f = float(jd.map50_flat(jnp.asarray(pf), jnp.asarray(tf), GRIDS))
    assert abs(got - ref) <= TOL and abs(got_f - ref_f) <= TOL
    if perfect:
        assert abs(got - 1.0) <= TOL and abs(got_f - 1.0) <= TOL
    else:
        assert 0.0 < got < 1.0 and 0.0 < got_f < 1.0


def test_dense_detection_head_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 4, 4, 6)).astype(np.float32)
    jm = jd.DenseDetectionHead(num_classes=3)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    head = td.DenseDetectionHead(6, 3)
    k = np.asarray(jv["params"]["det_head"]["kernel"])
    head.det_head.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    head.det_head.bias.data = torch.from_numpy(np.asarray(jv["params"]["det_head"]["bias"]))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 4, 8) and _rel(got, jm.apply(jv, jnp.asarray(x))) <= FWD_TOL


# --------------------------------------------------------------------------- #
# nearest interpolate, FeaturePyramid, the fpn creator
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("src,dst", [(4, 8), (8, 16), (3, 8), (5, 7), (8, 4), (7, 5)])
def test_interpolate_nearest_matches_jax_resize(src, dst):
    """``method='nearest'`` is torch's nearest-exact: equal to
    ``jax.image.resize(..., 'nearest')`` at factor 2 and at non-integer
    factors, up and down."""
    x = np.random.default_rng(src * 10 + dst).normal(size=(2, src, src + 1, 3)).astype(np.float32)
    ref = np.asarray(jax_interpolate(jnp.asarray(x), (dst, dst + 2), method="nearest"))
    got = dnn.interpolate(torch.from_numpy(x).movedim(-1, 1), (dst, dst + 2),
                          method="nearest").movedim(1, -1).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= TOL


def test_interpolate_node_takes_nearest():
    hp = {"act_fn": "relu", "architecture": [{"upsample": {"scale": 1.5, "method": "nearest"}}]}
    x = np.random.default_rng(8).normal(size=(2, 6, 4, 3)).astype(np.float32)
    jm = JaxModule((6, 4, 3), hp)
    ref = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0)), jnp.asarray(x)))
    got = DeepcvModule((6, 4, 3), hp, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 9, 6, 3) and np.abs(got - ref).max() <= TOL


def _pyramid_hp(head_outputs):
    return {"act_fn": "relu", "architecture": [
        {"conv2d": ["c3", {"kernel_size": [3, 3], "out_channels": 8, "padding": 1}]},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"conv2d": ["c4", {"kernel_size": [3, 3], "out_channels": 12, "padding": 1}]},
        {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"conv2d": ["c5", {"kernel_size": [3, 3], "out_channels": 16, "padding": 1}]},
        {"_new_branch_from_tensor": {"_from": ["c3", "c4", "c5"]}},
        {"feature_pyramid": {"channels": 8, "head_outputs": head_outputs}}]}


@pytest.mark.parametrize("head_outputs", [0, 7])
def test_feature_pyramid_matches_jax(head_outputs):
    """Three levels (16x16, 8x8 and 4x4 on 16x16 images): the list of
    P-levels, or the shared head's flat (N, 336, 7) output in the JAX
    layout (cell (y, x), then channels), within 1e-4."""
    hp = _pyramid_hp(head_outputs)
    jm = JaxModule((16, 16, 3), hp)
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 9)
    tm = DeepcvModule((16, 16, 3), hp, device="cpu")
    load_jax_variables(tm, jv)
    x = np.random.default_rng(10).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = jm.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if head_outputs:
        assert got.shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 7) and tm.output_shape == (1, 336, 7)
        assert _rel(got.numpy(), ref) <= FWD_TOL
    else:
        assert [tuple(g.shape) for g in got] == [(2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 8)]
        for g, r in zip(got, ref):
            assert _rel(g.numpy(), r) <= FWD_TOL
    fpn = [m for m in tm.modules() if isinstance(m, dnn.FeaturePyramid)][0]
    assert not any(isinstance(m, dnn.FusedConv2d) for m in fpn.modules())


def test_fpn_refuses_a_single_tensor():
    hp = {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 8}}, {"fpn": {"channels": 8}}]}
    with pytest.raises(ValueError, match="FeaturePyramid expects a list of >=2 feature maps"):
        DeepcvModule((8, 8, 3), hp, device="meta")
    with pytest.raises(ValueError, match="unexpected param"):
        DeepcvModule((8, 8, 3), {**hp, "architecture": [
            {"conv2d": ["a", {"kernel_size": [3, 3], "out_channels": 8}]},
            {"conv2d": ["b", {"kernel_size": [3, 3], "out_channels": 8}]},
            {"_new_branch_from_tensor": {"_from": ["a", "b"]}},
            {"fpn": {"channels": 8, "levels": 2}}]}, device="meta")


# --------------------------------------------------------------------------- #
# the conf's detectors and config 12's
# --------------------------------------------------------------------------- #

class _Set:
    """The ``datasets['trainset']`` view both packages' create_* read."""

    def __init__(self, image_shape, targets_shape):
        self.image_shape = image_shape
        self.targets = np.zeros(targets_shape, np.float32)
        self.dataset = self


DETECTORS = {"single": ("object_detector_model", "create_detector", (1, 8, 8, 8), 14_760,
                        15_480, "detection_loss"),
             "fpn": ("fpn_detector_model", "create_fpn_detector", (1, 80, 8), 117_864,
                     118_584, "detection_loss_focal")}


@pytest.fixture(scope="module", params=sorted(DETECTORS))
def detector(request):
    key, create, tshape, _, _, loss = DETECTORS[request.param]
    t_hp, j_hp = _conf(key)
    datasets = {"trainset": _Set((32, 32, 3), tshape)}
    tm = getattr(td, create)(datasets, t_hp, device="cpu")
    jm = getattr(jd, create)(datasets, j_hp)
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 11)
    load_jax_variables(tm, jv)
    return request.param, jm, jv, tm, getattr(td, loss), getattr(jd, loss)


def test_detector_counts_and_k2_convs(detector):
    kind, jm, jv, tm, _, _ = detector
    _, _, _, params, jax_params, _ = DETECTORS[kind]
    assert sum(a.size for a in jax.tree_util.tree_leaves(jv["params"])) == jax_params
    assert tm.capacity() == params == jax_params - 5 * 9 * 16
    assert sum(isinstance(m, dnn.FusedConv2d) for m in tm.modules()) == 4


@pytest.mark.parametrize("train", [False, True])
def test_detector_forward_matches_jax(detector, train):
    kind, jm, jv, tm, _, _ = detector
    x = np.random.default_rng(12).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = _jax_out(jm.apply(jv, jnp.asarray(x), train=train))
    with torch.no_grad():
        got = tm.train(train)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == ((2, 8, 8, 8) if kind == "single" else (2, 80, 8))
    assert _rel(got, ref) <= FWD_TOL


def test_detector_first_step_gradients_match_jax(detector):
    """The detection loss (focal on the FPN) of one batch in train mode and
    every parameter's gradient within rtol 1e-3 and 1e-3 of its tensor's
    largest entry."""
    kind, jm, jv, tm, tloss_fn, jloss_fn = detector
    x = np.random.default_rng(13).normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = (td.generate_shapes_dataset(n=4, seed=14) if kind == "single"
         else td.generate_shapes_dataset_fpn(n=4, seed=14)).targets

    def loss(params):
        return jloss_fn(_jax_out(jm.apply({"params": params}, jnp.asarray(x), train=True)),
                        jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jv["params"])
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}, tm)
    tm.train()
    for p in tm.parameters():
        p.grad = None
    tloss = tloss_fn(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = want.numpy()
        np.testing.assert_allclose(got[key].grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()) + 1e-8,
                                   err_msg=key)


#: bench.py config 12's FPN detector backbone (bench.py:1064-1079)
CONFIG12 = {"act_fn": "relu", "fpn_channels": 64, "architecture": [
    {"conv2d": {"kernel_size": [3, 3], "out_channels": 32, "padding": 1}},
    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
    {"conv2d": {"kernel_size": [3, 3], "out_channels": 64, "padding": 1}},
    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
    {"conv2d": ["c3", {"kernel_size": [3, 3], "out_channels": 64, "padding": 1}]},
    {"avg_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
    {"conv2d": ["c4", {"kernel_size": [3, 3], "out_channels": 128, "padding": 1}]},
    {"_new_branch_from_tensor": {"_from": ["c3", "c4"]}}]}


def test_config12_fpn_detector_count_at_64():
    datasets = {"trainset": _Set((64, 64, 3), (1, 16 * 16 + 8 * 8, 8))}
    jm = jd.create_fpn_detector(datasets, CONFIG12)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    tm = td.create_fpn_detector(datasets, CONFIG12, device="meta")
    assert n_jax == 222_504 and tm.capacity() == 221_064 == n_jax - 5 * 9 * 32
    assert tm.output_shape == (1, 320, 8)
    assert "fpn_channels" in CONFIG12           # the spec given is not changed


@pytest.mark.parametrize("grids,match", [((4, 8), "strictly fine->coarse"),
                                         ((8, 8), "strictly fine->coarse"),
                                         ((8, 2), "flatten to 68 cells but the dataset "
                                                  "targets have 80")])
def test_train_fpn_detector_refuses_bad_grids_as_jax(grids, match):
    datasets = {"trainset": _Set((32, 32, 3), (1, 80, 8))}
    for train_fn in (td.train_fpn_detector, jd.train_fpn_detector):
        with pytest.raises(ValueError, match=match):
            train_fn(datasets, None, {"fpn_grids": list(grids)})


# --------------------------------------------------------------------------- #
# the pipelines
# --------------------------------------------------------------------------- #

def test_create_pipelines_lists_the_detection_and_keypoint_pipelines():
    pipes = create_pipelines()
    assert TASK_PACKAGES == ("classification", "keypoints", "detection", "pose", "segmentation",
                             "video")
    assert set(create_pipelines({"enabled": ["video"]})) == \
        {"train_optical_flow", "train_video_classifier", "train_temporal_classifier",
         "__default__"}
    assert {"train_object_detector", "train_fpn_detector", "train_keypoint_detector"} \
        <= set(pipes)
    jax_pipes = jax_create_pipelines({"enabled": list(TASK_PACKAGES)})
    assert set(pipes) == set(jax_pipes)
    for name in ("train_object_detector", "train_fpn_detector", "train_keypoint_detector"):
        assert [n.name for n in pipes[name].nodes] == [n.name for n in jax_pipes[name].nodes]
        assert pipes[name].tags == jax_pipes[name].tags


@pytest.fixture(scope="module")
def detect_project(tmp_path_factory):
    """A project whose conf is the repo's, with the shapes catalog entries
    cut to 24 + 8 synthetic 32x32 images."""
    root = tmp_path_factory.mktemp("detect_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "shapes_train": {"type": "synthetic_shapes", "n": 24, "image_size": 32, "grid": 8},
        "shapes_test": {"type": "synthetic_shapes", "train": False, "n": 8, "image_size": 32,
                        "grid": 8},
        "shapes_fpn_train": {"type": "synthetic_shapes_fpn", "n": 24, "image_size": 32},
        "shapes_fpn_test": {"type": "synthetic_shapes_fpn", "train": False, "n": 8,
                            "image_size": 32}}))
    return root


@pytest.mark.parametrize("pipeline,params,metrics", [
    ("train_object_detector", 14_760,
     ("valid_map50", "valid_objectness_accuracy", "valid_mean_iou")),
    ("train_fpn_detector", 117_864, ("valid_map50", "valid_objectness_accuracy"))])
def test_detection_pipeline_runs_end_to_end_on_cpu(detect_project, tmp_path, pipeline, params,
                                                   metrics, monkeypatch):
    """The conf's model and hp, cut to one epoch at batch 8 and validated
    after it: finite losses, the validation metrics with mAP (computed in
    validation only), 4 K2 convs."""
    calls = []
    real = td.map50 if pipeline == "train_object_detector" else td.map50_flat
    monkeypatch.setattr(td, real.__name__, lambda *a, **k: calls.append(1) or real(*a, **k))
    p = pipeline
    store = cli_run([f"--pipeline={p}", "--project-path", str(detect_project), "--device", "cpu",
                     "--params", f"{p}.epochs:1,{p}.batch_size:8,{p}.validate_every_epochs:1,"
                                 f"{p}.output_path:{tmp_path}"])
    h = store["train_results"]["history"]
    assert h["steps"] == len(store["datasets"]["trainset"]) // 8 > 0
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert "map50" not in h["train"][-1] and set(metrics) <= set(h["valid"][-1])
    assert np.isfinite([h["valid"][-1][m] for m in metrics]).all()
    assert 0.0 <= h["valid"][-1]["valid_map50"] <= 1.0 and calls == [1]
    model = store["model"]
    assert model.device.type == "cpu" and model.capacity() == params
    assert sum(isinstance(m, dnn.FusedConv2d) for m in model.modules()) == 4


def test_validation_map_is_weighted_by_batch_size(tmp_path):
    """``eval_metrics`` run per validation batch after ``metrics``, and the
    pass averages them weighted by each batch's size (two batches of 16
    and 4 here)."""
    from deepcv_tpu_torch.train.training import train

    raw = td.generate_shapes_dataset(n=60, seed=15)
    datasets = preprocess({"trainset": raw}, {"seed": 0, "transforms": ["to_tensor"],
                                              "split_dataset": {"validset_ratio": 1 / 3}})
    t_hp, _ = _conf("object_detector_model")
    model = td.create_detector(datasets, t_hp, device="cpu")
    seen = []

    def metric(pred, target):
        seen.append(len(target))
        return torch.tensor(float(len(target)))

    hp = {"epochs": 1, "batch_size": 8, "optimizer_opts": {"lr": 0.0},
          "eval_batch_multiplier": 2, "save_every_iters": 0, "output_path": str(tmp_path)}
    _, h = train(hp, model, td.detection_loss, datasets, metrics={"acc": td.objectness_accuracy},
                 eval_metrics={"size": metric, "acc": functools.partial(metric)})
    assert seen == [16, 16, 4, 4] and "size" not in h["train"][-1]
    assert h["valid"][0]["valid_size"] == pytest.approx((16 * 16 + 4 * 4) / 20)
    assert h["valid"][0]["valid_acc"] == h["valid"][0]["valid_size"]

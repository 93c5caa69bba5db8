"""The dense-prediction pipelines in the port against the JAX package, on
the CPU: the synthetic generators (byte-equal), the losses and metrics of
segmentation and pose on the same inputs, the float targets of pose through
``train()`` (F4) in training and validation, ``unet_spec`` (forward against
the JAX model, parameter count at 256x256), and
``train_semantic_segmentation`` and ``train_pose_estimator`` through the
port's ``run``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.pipelines import pose as jpose
from deepcv_tpu.pipelines import segmentation as jseg
from deepcv_tpu.pipelines.registry import create_pipelines as jax_create_pipelines
from deepcv_tpu.spec import zoo as jax_zoo
from deepcv_tpu_torch.cli import run as cli_run
from deepcv_tpu_torch.config import load_yaml
from deepcv_tpu_torch.data.preprocess import preprocess
from deepcv_tpu_torch.interop import load_jax_variables
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.pipelines import pose as tpose
from deepcv_tpu_torch.pipelines import segmentation as tseg
from deepcv_tpu_torch.pipelines.registry import TASK_PACKAGES, create_pipelines
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4        # the forward bound of tests/test_torch_parity.py
LOSS_TOL = 1e-6       # one loss over the same values, summed in another order
STEP_TOL = 1e-5       # one training step's loss through a whole model


def _draw(shapes, seed):
    """Variables for the shapes of a JAX init: kernels normal with variance
    1 / fan-in, norm scales in [0.5, 1.5), biases and running means normal
    with std 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name:
            a = rng.uniform(0.5, 1.5, size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _conf(key):
    return (load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))[key],
            jax_load_yaml(os.path.join(REPO, "conf/base/parameters.yml"))[key])


# --------------------------------------------------------------------------- #
# generators
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("train", [True, False])
def test_generators_are_byte_equal_to_jax(train):
    seg_t = tseg.generate_segmentation_dataset(n=12, image_size=24, seed=3, train=train)
    seg_j = jseg.generate_segmentation_dataset(n=12, image_size=24, seed=3, train=train)
    pose_t = tpose.generate_pose_dataset(n=12, image_size=32, heatmap_size=16, seed=4,
                                         train=train)
    pose_j = jpose.generate_pose_dataset(n=12, image_size=32, heatmap_size=16, seed=4,
                                         train=train)
    for t, j in ((seg_t, seg_j), (pose_t, pose_j)):
        for a, b in ((t.images, j.images), (t.targets, j.targets)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert t.classes == list(j.classes) and t.name == j.name
    assert seg_t.targets.dtype == np.int32 and pose_t.targets.dtype == np.float32
    assert set(np.unique(seg_t.targets)) <= {0, 1, 2, 3}


# --------------------------------------------------------------------------- #
# losses and metrics
# --------------------------------------------------------------------------- #

def test_segmentation_loss_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    logits[0, :, :, 2] += 3.0           # one class never predicted in image 0
    mask = rng.integers(0, 4, size=(3, 8, 8)).astype(np.int32)
    mask[:, :, :] = np.where(mask == 3, 1, mask)   # class 3 absent from the targets
    jl, jm = jnp.asarray(logits), jnp.asarray(mask)
    tl, tm = torch.from_numpy(logits), torch.from_numpy(mask)
    assert abs(float(tseg.segmentation_loss(tl, tm)) - float(jseg.segmentation_loss(jl, jm))) \
        <= LOSS_TOL * abs(float(jseg.segmentation_loss(jl, jm)))
    assert float(tseg.pixel_accuracy(tl, tm)) == float(jseg.pixel_accuracy(jl, jm))
    assert float(tseg.mean_iou(tl, tm)) == float(jseg.mean_iou(jl, jm))
    assert float(tseg.mean_iou(tl, tl.argmax(-1))) == 1.0


def _peaked_heatmaps():
    """(4, 16, 16, 4) heatmaps: random low noise plus one peak a channel,
    at corners, on edges and inside, with the neighbours on one side larger,
    equal or missing."""
    rng = np.random.default_rng(6)
    h = (0.1 * rng.random(size=(4, 16, 16, 4))).astype(np.float32)
    peaks = [(0, 0), (15, 15), (0, 7), (9, 15), (5, 5), (8, 1), (14, 6), (1, 14)]
    for n in range(4):
        for k in range(4):
            y, x = peaks[(n + 2 * k) % len(peaks)]
            h[n, y, x, k] = 1.0
            if 0 < x < 15:
                h[n, y, x + 1, k] = 0.6 if (n + k) % 3 else h[n, y, x - 1, k]
            if 0 < y < 15 and (n + k) % 2:
                h[n, y - 1, x, k] = 0.5
    return h


def test_decode_heatmaps_is_exact_with_edge_peaks():
    h = _peaked_heatmaps()
    tc, ts = tpose.decode_heatmaps(torch.from_numpy(h))
    jc, js = jpose.decode_heatmaps(jnp.asarray(h))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc.dtype == torch.float32
    # a corner peak stays on the grid; an interior one moves a quarter pixel
    assert tc[0, 0].tolist() == [0.0, 0.0]
    assert set(np.unique(tc.numpy() % 1.0)) <= {0.0, 0.25, 0.75}


def test_heatmap_loss_and_pck_match_jax():
    tgt = tpose.generate_pose_dataset(n=4, seed=7).targets
    pred = _peaked_heatmaps()
    pred[:2] = tgt[:2] + 0.05 * np.random.default_rng(8).normal(size=tgt[:2].shape)
    for a in (pred, tgt):
        assert a.dtype == np.float32
    tl, jl = (tpose.heatmap_mse_loss(torch.from_numpy(pred), torch.from_numpy(tgt)),
              jpose.heatmap_mse_loss(jnp.asarray(pred), jnp.asarray(tgt)))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * float(jl)
    for alpha in (0.1, 0.3):
        got = float(tpose.pck(torch.from_numpy(pred), torch.from_numpy(tgt), alpha))
        assert got == float(jpose.pck(jnp.asarray(pred), jnp.asarray(tgt), alpha))
        assert 0.0 < got < 1.0


# --------------------------------------------------------------------------- #
# F4: float targets stay float through train()
# --------------------------------------------------------------------------- #

def test_f4_pose_heatmaps_reach_the_loss_as_float32(tmp_path):
    """One ``train()`` step of the conf's pose estimator on 16 images (one
    batch, learning rate 0, so the weights stay as they are) and its
    validation: the step's loss equals the JAX ``heatmap_mse_loss`` of the
    JAX model in train mode, and the validation loss the JAX eval-mode loss
    with the running means that step left, each within 1e-5. Cast to int64
    (as before the repair) the Gaussian heatmaps lose everything below 1,
    which moves the loss by more than 100 times that bound here."""
    data = tpose.generate_pose_dataset(n=20, image_size=32, heatmap_size=16, seed=9)
    datasets = preprocess({"trainset": data}, {"seed": 7, "transforms": ["to_tensor"],
                                               "split_dataset": {"validset_ratio": 0.2}})
    t_hp, j_hp = _conf("pose_estimator_model")
    tm = tpose.create_pose_estimator(datasets, t_hp, device="cpu")
    jm = jpose.create_pose_estimator(datasets, j_hp)
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 10)
    load_jax_variables(tm, jv)
    hp = {"epochs": 1, "batch_size": 16, "optimizer": "adamw",
          "optimizer_opts": {"lr": 0.0, "weight_decay": 1e-4}, "save_every_iters": 0,
          "log_progress_every_iters": 1, "validate_every_epochs": 1,
          "output_path": str(tmp_path)}
    h = tpose.train_pose_estimator(datasets, tm, hp)["history"]

    def split(name):
        ds = datasets[name].dataset
        return jnp.asarray(ds.images.astype(np.float32) / np.float32(255.0)), ds.targets

    x, y = split("trainset")
    out, state = jax.jit(lambda v, xx: jm.apply(v, xx, train=True, mutable=["batch_stats"]))(
        jv, x)
    want = float(jpose.heatmap_mse_loss(out, jnp.asarray(y)))
    assert abs(h["train"][0]["loss"] - want) <= STEP_TOL * want
    xv, yv = split("validset")
    out_v = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        {"params": jv["params"], "batch_stats": state["batch_stats"]}, xv)
    want_v = float(jpose.heatmap_mse_loss(out_v, jnp.asarray(yv)))
    assert abs(h["valid"][0]["valid_loss"] - want_v) <= STEP_TOL * want_v
    assert h["valid"][0]["valid_pck"] == float(jpose.pck(out_v, jnp.asarray(yv)))
    as_int = float(jpose.heatmap_mse_loss(out, jnp.asarray(y.astype(np.int64))))
    assert abs(as_int - want) > 100 * STEP_TOL * want


# --------------------------------------------------------------------------- #
# U-Net
# --------------------------------------------------------------------------- #

class _Set:
    """The ``datasets['trainset']`` view that both ``create_segmenter``s read."""

    def __init__(self, image_shape):
        self.classes, self.image_shape = list(tseg.SEG_CLASSES), image_shape
        self.dataset = self


@pytest.mark.parametrize("train", [False, True])
def test_small_unet_segmenter_matches_jax(train):
    """``unet_spec(depth=2, base_channels=8)`` with the dense head on 16x16
    images: the same dict as the JAX builder's, ten 3x3 K2 convs and the
    head (11), forward within 1e-4 (group norm in both modes)."""
    spec = zoo.unet_spec(depth=2, base_channels=8)
    assert spec == jax_zoo.unet_spec(depth=2, base_channels=8)
    datasets = {"trainset": _Set((16, 16, 3))}
    tm = tseg.create_segmenter(datasets, spec, device="cpu")
    jm = jseg.create_segmenter(datasets, jax_zoo.unet_spec(depth=2, base_channels=8))
    jv = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 11)
    load_jax_variables(tm, jv)
    assert sum(isinstance(m, dnn.FusedConv2d) for m in tm.modules()) == 11
    x = np.random.default_rng(12).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=train))
    with torch.no_grad():
        got = tm.train(train)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 4)
    assert _rel(got, ref) <= FWD_TOL


def test_unet_parameter_count_at_256():
    """7,851,140 parameters in JAX with the 4-class head; the port's the
    same less the 1,440 zero-padded rows of the JAX stem kernel; 19 K2
    convs, the decoder's first ones taking 768, 384, 192 and 96 channels."""
    datasets = {"trainset": _Set((256, 256, 3))}
    jm = jseg.create_segmenter(datasets, jax_zoo.unet_spec())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_jax == 7_851_140
    tm = tseg.create_segmenter(datasets, zoo.unet_spec(), device="meta")
    assert tm.capacity() == n_jax - 3 * 3 * 5 * 32
    convs = [m for m in tm.modules() if isinstance(m, dnn.FusedConv2d)]
    assert len(convs) == 19 and sum(m.bias is None for m in convs) == 18
    assert [m.weight.shape[1] for m in convs if m.weight.shape[1] > m.weight.shape[0]] == \
        [768, 384, 192, 96, 32]
    assert tm.output_shape == (1, 256, 256, 4)


# --------------------------------------------------------------------------- #
# the pipelines
# --------------------------------------------------------------------------- #

def test_create_pipelines_lists_both_dense_pipelines():
    pipes = create_pipelines()
    assert {"train_semantic_segmentation", "train_pose_estimator"} <= set(pipes)
    assert TASK_PACKAGES == ("classification", "keypoints", "detection", "pose",
                             "segmentation", "video")
    jax_pipes = jax_create_pipelines({"enabled": list(TASK_PACKAGES)})
    assert set(pipes) == set(jax_pipes)
    assert [n.name for n in pipes["__default__"].nodes] == \
        [n.name for n in jax_pipes["__default__"].nodes]
    assert [n.name for n in pipes["train_pose_estimator"].nodes] == \
        [n.name for n in jax_pipes["train_pose_estimator"].nodes]
    assert set(create_pipelines({"enabled": ["video"]})) == \
        {"train_optical_flow", "train_video_classifier", "train_temporal_classifier",
         "__default__"}


@pytest.fixture(scope="module")
def dense_project(tmp_path_factory):
    """A project whose conf is the repo's, with the seg and pose catalog
    entries cut to 24 + 8 synthetic 32x32 images."""
    root = tmp_path_factory.mktemp("dense_project")
    (root / "conf" / "local").mkdir(parents=True)
    os.symlink(os.path.join(REPO, "conf", "base"), root / "conf" / "base")
    (root / "conf" / "local" / "catalog.yml").write_text(yaml.safe_dump({
        "seg_train": {"type": "synthetic_shapes_seg", "n": 24, "image_size": 32},
        "seg_test": {"type": "synthetic_shapes_seg", "train": False, "n": 8, "image_size": 32},
        "pose_train": {"type": "synthetic_pose", "n": 24, "image_size": 32, "heatmap_size": 16},
        "pose_test": {"type": "synthetic_pose", "train": False, "n": 8, "image_size": 32,
                      "heatmap_size": 16}}))
    return root


@pytest.mark.parametrize("pipeline,hp,metrics,targets", [
    ("train_semantic_segmentation", "train_semantic_segmentation",
     ("valid_pixel_accuracy", "valid_mean_iou"), torch.int64),
    ("train_pose_estimator", "train_pose_estimator", ("valid_pck",), torch.float32)])
def test_dense_pipeline_runs_end_to_end_on_cpu(dense_project, tmp_path, pipeline, hp, metrics,
                                                targets, monkeypatch):
    """The conf's HRNet model and hp (AdamW, one_cycle for segmentation),
    cut to one epoch at batch 8 and validated after it: finite losses, the
    validation metrics, the head's one K2 conv, the targets' dtype as the
    loss saw it."""
    seen = []
    loss = tseg.segmentation_loss if "seg" in pipeline else tpose.heatmap_mse_loss
    module = tseg if "seg" in pipeline else tpose
    monkeypatch.setattr(module, loss.__name__, lambda p, t: seen.append(t.dtype) or loss(p, t))
    params = [f"{hp}.epochs:1", f"{hp}.batch_size:8", f"{hp}.validate_every_epochs:1",
              f"{hp}.output_path:{tmp_path}"]
    store = cli_run([f"--pipeline={pipeline}", "--project-path", str(dense_project),
                     "--device", "cpu", "--params", ",".join(params)])
    h = store["train_results"]["history"]
    n_train = len(store["datasets"]["trainset"])
    assert h["steps"] == n_train // 8 > 0
    assert np.isfinite([e["main_loss"] for e in h["train"]]).all()
    assert h["valid"] and set(metrics) <= set(h["valid"][-1])
    assert np.isfinite([h["valid"][-1][m] for m in metrics]).all()
    assert set(seen) == {targets}
    model = store["model"]
    assert model.device.type == "cpu" and model.capacity() == 90_698 - 3 * 3 * 5 * 32
    assert sum(isinstance(m, dnn.FusedConv2d) for m in model.modules()) == 1

"""Video: optical flow, the conv3d and temporal video classifiers, deep
feature flow.

Counterpart of ``deepcv_tpu/pipelines/video.py`` (``flow_warp``,
``deep_feature_flow_inference``, ``SimpleFlowNet``, ``FlowModel``,
``generate_flow_dataset``, ``interpolate_frames``,
``generate_clip_dataset`` with their ``synthetic_flow`` and
``synthetic_clips`` loaders, ``TemporalVideoModel``,
``create_temporal_model``, ``endpoint_error``, ``create_flow_model``,
``train_flow``, ``get_pipelines``):

* ``train_optical_flow``: a coarse-to-fine flow net whose one refiner
  (three 3x3 convs, shared by every pyramid level) reads frame a, frame b
  warped by the current flow, their 9-way local correlation and the flow,
  trained with MSE against synthetic translations, EPE as its metric;
* ``train_video_classifier``: the conf's ``conv3d`` spec over (F, H, W, C)
  clips through the classification nodes;
* ``train_temporal_classifier``: a per-frame 2-d encoder (the frames folded
  into the batch), a soft-argmax or average pool to one low-dim embedding
  per frame, then a temporal transformer, GRU or mean over the sequence.

These paths launch none of the port's kernels: the JAX package takes its
Pallas conv only in the spec engine's 2-d creator, and these convs are
flax's own (the refiner's, the encoder's) or 3-d. The models are
``nn.Module``\\ s whose parameter names are the JAX variables' paths
(``c1``, ``enc_conv_0``, ``block_0.attn.qkv``, ``gru.ir``, ...), so
``interop`` maps them one to one (:attr:`FlowModel.jax_flat`). Their
initialisers are flax's defaults (LeCun-normal kernels, zero biases,
orthogonal recurrent kernels), GroupNorm and LayerNorm take flax's eps
1e-6 and GELU its tanh form.

The generators draw from numpy's ``default_rng`` in the JAX package's
order, so a seed gives the same bytes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepcv_tpu_torch.data.datasets import DATASET_LOADERS, ArrayDataset
from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.ops.attention import TransformerEncoderBlock
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, preprocess_node
from deepcv_tpu_torch.train.losses import mse_loss
from deepcv_tpu_torch.train.training import train as train_fn
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["get_pipelines", "flow_warp", "deep_feature_flow_inference", "interpolate_frames",
           "generate_flow_dataset", "generate_clip_dataset", "SimpleFlowNet", "FlowModel",
           "GRUCell", "TemporalVideoModel", "create_temporal_model", "endpoint_error",
           "create_flow_model", "train_flow"]

#: flax's GroupNorm and LayerNorm default epsilon
FLAX_NORM_EPS = 1e-6


def flow_warp(features: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (N, H, W, C) features by (N, H, W, 2) backward flow (dx, dy) in
    pixel units: ``out(y, x) = features(y + dy, x + dx)``, bilinear, each of
    the four corners read as zero outside the frame. The JAX formula itself
    (floor, four gathers at clipped indices, validity masks), not
    ``F.grid_sample``, whose normalised coordinates can land a hair below an
    integer and floor into the neighbouring cell, changing the gradient
    with respect to the flow."""
    n, h, w, c = features.shape
    rows = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    cols = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    sx = cols + flow[..., 0]
    sy = rows + flow[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dx, dy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = features.reshape(n, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(n, h * w, 1)
        vals = flat.gather(1, idx.expand(-1, -1, c)).reshape(n, h, w, c)
        return torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                              device=vals.device))

    top = gather(y0, x0) * (1 - dx) + gather(y0, x0 + 1) * dx
    bot = gather(y0 + 1, x0) * (1 - dx) + gather(y0 + 1, x0 + 1) * dx
    return top * (1 - dy) + bot * dy


def deep_feature_flow_inference(frames: Iterator[torch.Tensor], feature_fn: Callable,
                                flow_fn: Callable, task_head_fn: Callable,
                                key_frame_interval: int = 10):
    """Generator over per-frame predictions (deep feature flow,
    arXiv:1611.07715): the heavy ``feature_fn`` runs on key frames only
    (every ``key_frame_interval``-th); the frames between warp the cached
    key-frame features by ``flow_fn(key_frame, frame)`` and run only the
    light ``task_head_fn``."""
    key_frame = key_features = None
    for i, frame in enumerate(frames):
        if i % key_frame_interval == 0 or key_features is None:
            key_frame = frame
            key_features = feature_fn(frame)
            features = key_features
        else:
            features = flow_warp(key_features, flow_fn(key_frame, frame))
        yield task_head_fn(features)


def interpolate_frames(frame_a: torch.Tensor, frame_b: torch.Tensor, *,
                       flow: Optional[torch.Tensor] = None,
                       flow_fn: Optional[Callable] = None, t: float = 0.5) -> torch.Tensor:
    """The frame at time ``t`` (0 = a, 1 = b) between two (N, H, W, C)
    frames, from the backward flow with ``a(p) = b(p + flow(p))`` (given, or
    ``flow_fn(a, b)``): both endpoints warped along the linearly scaled flow
    and blended, ``(1-t) * a(p - t*flow) + t * b(p + (1-t)*flow)``."""
    if (flow is None) == (flow_fn is None):
        raise ValueError("pass exactly one of flow= or flow_fn=")
    if flow is None:
        flow = flow_fn(frame_a, frame_b)
    t = float(t)
    from_a = flow_warp(frame_a.float(), -t * flow)
    from_b = flow_warp(frame_b.float(), (1.0 - t) * flow)
    return (1.0 - t) * from_a + t * from_b


def endpoint_error(pred_flow: torch.Tensor, target_flow: torch.Tensor) -> torch.Tensor:
    """Average endpoint error (EPE), the optical-flow metric, in float32."""
    return ((pred_flow.float() - target_flow.float()).square().sum(-1) + 1e-12).sqrt().mean()


# --------------------------------------------------------------------------- #
# Synthetic data
# --------------------------------------------------------------------------- #

def generate_flow_dataset(n: int = 512, image_size: int = 32, max_shift: int = 4,
                          seed: int = 0, train: bool = True) -> ArrayDataset:
    """Textured frames translated by a known (dx, dy): x the packed (a ++ b)
    uint8 pair, the target the dense backward flow (H, W, 2), (-dx, -dy),
    which warps b onto a (``flow_warp(b, target) == a`` inside the frame)."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    big = image_size + 2 * max_shift
    xs = np.zeros((n, image_size, image_size, 6), np.uint8)
    flows = np.zeros((n, image_size, image_size, 2), np.float32)
    for i in range(n):
        canvas = rng.integers(0, 256, (big, big, 3), np.uint8)
        for _ in range(4):
            y0, x0 = rng.integers(0, big - 8, 2)
            canvas[y0:y0 + 8, x0:x0 + 8] = rng.integers(128, 256, 3)
        dx, dy = rng.integers(-max_shift, max_shift + 1, 2)
        xs[i, ..., :3] = canvas[max_shift:max_shift + image_size,
                                max_shift:max_shift + image_size]
        xs[i, ..., 3:] = canvas[max_shift + dy:max_shift + dy + image_size,
                                max_shift + dx:max_shift + dx + image_size]
        flows[i, ..., 0] = -dx
        flows[i, ..., 1] = -dy
    return ArrayDataset(xs, flows, name=f"flow_{'train' if train else 'test'}",
                        provenance="synthetic")


def generate_clip_dataset(n: int = 512, frames: int = 6, image_size: int = 12, seed: int = 0,
                          train: bool = True) -> ArrayDataset:
    """(F, H, W, 3) clips of a bright dot moving one pixel a frame (wrapping)
    in one of 4 directions, the label: no single frame tells it."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    f, s = int(frames), int(image_size)
    clips = np.zeros((n, f, s, s, 3), np.uint8)
    labels = rng.integers(0, 4, n)
    dirs = {0: (1, 0), 1: (-1, 0), 2: (0, 1), 3: (0, -1)}
    for i in range(n):
        dy, dx = dirs[int(labels[i])]
        y0, x0 = rng.integers(0, s, 2)
        color = rng.integers(128, 256, 3)
        for t in range(f):
            clips[i, t, (y0 + dy * t) % s, (x0 + dx * t) % s] = color
    return ArrayDataset(clips, labels.astype(np.int64), classes=["down", "up", "right", "left"],
                        name=f"clips_{'train' if train else 'test'}", provenance="synthetic")


DATASET_LOADERS["synthetic_flow"] = (
    lambda root=None, train=True, n=512, image_size=32, max_shift=4, seed=0, **kw:
    generate_flow_dataset(n=int(n), image_size=int(image_size), max_shift=int(max_shift),
                          seed=int(seed), train=train))
DATASET_LOADERS["synthetic_clips"] = (
    lambda root=None, train=True, n=512, frames=6, image_size=12, seed=0, **kw:
    generate_clip_dataset(n=int(n), frames=int(frames), image_size=int(image_size),
                          seed=int(seed), train=train))


# --------------------------------------------------------------------------- #
# Models
# --------------------------------------------------------------------------- #

class _FlaxDefaultInit(nn.Module):
    """A model built on the CPU, initialised from ``generator`` (a fresh one
    seeded 0 when None) by its modules' ``init_parameters``, then moved to
    ``device`` (CUDA unless given), as ``DeepcvModule`` is. Its parameter
    names are the JAX variables' paths (``interop``)."""

    jax_flat = True

    def _materialise(self, device, generator: Optional[torch.Generator]) -> None:
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        for m in self.modules():
            if hasattr(m, "init_parameters"):
                m.init_parameters(gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def capacity(self) -> int:
        return sum(p.numel() for p in self.parameters())


class SimpleFlowNet(_FlaxDefaultInit):
    """Pyramidal optical-flow estimator: from the coarsest level
    (``h // 2**(levels-1)``) to full size, the frames are resized (linear,
    half-pixel), the flow upsampled and scaled by the size ratio, frame b
    warped by it, and the refiner adds its correction. One refiner serves
    every level: ``c1``, ``c2`` (3x3 'SAME', bias, relu) and ``out`` (3x3
    to 2), plain ``F.conv2d`` as in the JAX package, over (a, warped b, the
    9-way local correlation, the flow)."""

    def __init__(self, channels: int = 3, levels: int = 3, features: int = 32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.levels, self.channels = int(levels), int(channels)
        cin = 2 * self.channels + 9 + 2
        self.c1 = dnn.LecunConv2d(cin, int(features), (3, 3), padding=(1, 1))
        self.c2 = dnn.LecunConv2d(int(features), int(features), (3, 3), padding=(1, 1))
        self.out = dnn.LecunConv2d(int(features), 2, (3, 3), padding=(1, 1))
        self._materialise(device, generator)

    def refine(self, a: torch.Tensor, b_warped: torch.Tensor, flow: torch.Tensor
               ) -> torch.Tensor:
        """The refiner's flow correction from NHWC a, warped b and flow."""
        corr = [(a * torch.roll(b_warped, (dy, dx), dims=(1, 2))).mean(-1, keepdim=True)
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        x = torch.cat([a, b_warped, *corr, flow], dim=-1).movedim(-1, 1)
        x = torch.relu(self.c1(x))
        x = torch.relu(self.c2(x))
        return self.out(x).movedim(1, -1)

    def forward(self, frame_a: torch.Tensor, frame_b: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) pair -> (N, H, W, 2) backward flow, coarse to fine."""
        h, w = frame_a.shape[1:3]

        def resize(x, hw):
            return dnn.interpolate(x.movedim(-1, 1), hw).movedim(1, -1)

        flow = frame_a.new_zeros((frame_a.shape[0], max(1, h // 2 ** (self.levels - 1)),
                                  max(1, w // 2 ** (self.levels - 1)), 2))
        for lvl in reversed(range(self.levels)):
            hw = (max(1, h // 2 ** lvl), max(1, w // 2 ** lvl))
            a, b = resize(frame_a, hw), resize(frame_b, hw)
            flow = resize(flow, hw) * (hw[0] / max(1, flow.shape[1]))
            flow = flow + self.refine(a, flow_warp(b, flow), flow)
        return flow


class FlowModel(SimpleFlowNet):
    """:class:`SimpleFlowNet` over a packed (H, W, 2C) input (frame a ++
    frame b), so that ``train()`` drives it as any model."""

    def __init__(self, input_shape: Sequence[int], levels: int = 2, features: int = 16, *,
                 device=None, generator: Optional[torch.Generator] = None):
        self.input_shape = tuple(int(s) for s in input_shape)
        super().__init__(self.input_shape[-1] // 2, levels, features, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x[..., :self.channels], x[..., self.channels:])


def create_flow_model(datasets, model_params: Mapping[str, Any], device=None) -> FlowModel:
    p = dict(model_params or {})
    return FlowModel(datasets["trainset"].image_shape, levels=int(p.get("levels", 2)),
                     features=int(p.get("features", 16)), device=device)


def train_flow(datasets, model: FlowModel, hp: Mapping[str, Any], trackers=()):
    """``train()`` with the MSE against the flow and EPE as the metric."""
    state, history = train_fn(hp, model, mse_loss, datasets,
                              metrics={"epe": endpoint_error}, loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


class _SameConv2d(dnn.LecunConv2d):
    """flax's ``Conv`` with 'SAME' padding at any stride: ``total =
    max((ceil(in/s) - 1) * s + k - in, 0)`` per dim, ``total // 2`` before
    and the rest after (asymmetric at an even total, where torch's
    symmetric padding would shift the map by a pixel)."""

    def forward(self, x):
        pads = []
        for size, k, s in reversed(list(zip(x.shape[2:], self.weight.shape[2:], self.stride))):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def _orthogonal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal()`` on a (in, out) kernel stored (out, in)."""
    q, r = torch.linalg.qr(torch.randn(t.shape[1], t.shape[0], generator=generator))
    q = q * torch.sign(torch.diagonal(r))
    return t.copy_(q.T)


class GRUCell(nn.Module):
    """flax's ``GRUCell`` (the JAX package's ``gru`` head), not
    ``torch.nn.GRU``: the input denses ``ir``, ``iz``, ``in`` carry biases,
    of the recurrent ones only ``hn`` does::

        r = sigmoid(x W_ir + b_ir + h W_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    LeCun-normal input kernels, orthogonal recurrent ones, zero biases."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ir = dnn.LecunDense(in_features, features)
        self.iz = dnn.LecunDense(in_features, features)
        # 'in' is a Python keyword: registered by name, read by getattr
        self.add_module("in", dnn.LecunDense(in_features, features))
        self.hr = dnn.LecunDense(features, features, use_bias=False)
        self.hz = dnn.LecunDense(features, features, use_bias=False)
        self.hn = dnn.LecunDense(features, features)

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            for d in (self.hr, self.hz, self.hn):
                _orthogonal_(d.weight, generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


#: TemporalVideoModel's ``pool`` and ``temporal`` choices
POOLS = ("soft_argmax", "gap")
TEMPORALS = ("transformer", "gru", "mean")


class TemporalVideoModel(_FlaxDefaultInit):
    """Per-frame features, then a timeseries model over them (the JAX
    package's ``TemporalNet``): (N, F, H, W, C) clips -> (N, n_classes).

    The encoder folds the frames into the batch: per ``encoder_features``
    entry a 3x3 'SAME' conv at its stride (``enc_conv_<i>``), GroupNorm with
    min(4, C) groups (``enc_gn_<i>``) and GELU. ``pool`` makes each frame's
    map one row: ``soft_argmax``, each channel's expected (y, x) under a
    spatial softmax over ``linspace(-1, 1)`` coordinates (2C, channel-major),
    or ``gap``, the channel means. ``embed`` (a Dense) gives the (N, F, D)
    sequence, and ``temporal`` reads it: ``transformer`` (``pos_embedding``,
    ``n_blocks`` pre-LN encoder blocks ``block_<i>`` with plain attention,
    ``ln_final``, the mean over frames), ``gru`` (:class:`GRUCell`, the
    final hidden state) or ``mean``. Then the ``head`` Dense."""

    def __init__(self, input_shape: Sequence[int], n_classes: int,
                 temporal: str = "transformer", embed_dim: int = 32,
                 encoder_features: Sequence[int] = (16, 32),
                 encoder_strides: Sequence[int] = (2, 2), pool: str = "soft_argmax",
                 num_heads: int = 4, n_blocks: int = 1, mlp_ratio: int = 2,
                 dropout_prob: float = 0.0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_shape = tuple(int(s) for s in input_shape)
        if len(self.input_shape) != 4:
            raise ValueError(f"TemporalVideoModel expects (F, H, W, C) input_shape, got "
                             f"{self.input_shape}")
        if len(tuple(encoder_strides)) != len(tuple(encoder_features)):
            raise ValueError("encoder_strides must match encoder_features length")
        if pool not in POOLS:
            raise ValueError(f"unknown pool '{pool}' (expected soft_argmax|gap)")
        if temporal not in TEMPORALS:
            raise ValueError(f"unknown temporal model '{temporal}' "
                             "(expected transformer|gru|mean)")
        self.temporal, self.pool, self.embed_dim = temporal, pool, int(embed_dim)
        frames, cin = self.input_shape[0], self.input_shape[-1]
        self.n_enc = len(tuple(encoder_features))
        for i, (feats, stride) in enumerate(zip(encoder_features, encoder_strides)):
            setattr(self, f"enc_conv_{i}", _SameConv2d(cin, int(feats), (3, 3),
                                                       stride=(int(stride),) * 2))
            setattr(self, f"enc_gn_{i}", dnn.GroupNorm(min(4, int(feats)), int(feats),
                                                       eps=FLAX_NORM_EPS))
            cin = int(feats)
        self.embed = dnn.LecunDense(2 * cin if pool == "soft_argmax" else cin, self.embed_dim)
        self.n_blocks = int(n_blocks) if temporal == "transformer" else 0
        if temporal == "transformer":
            self.pos_embedding = nn.Parameter(torch.empty(1, frames, self.embed_dim))
            for i in range(self.n_blocks):
                setattr(self, f"block_{i}", TransformerEncoderBlock(
                    self.embed_dim, int(num_heads), self.embed_dim * int(mlp_ratio),
                    dropout_prob=float(dropout_prob)))
            self.ln_final = dnn.LayerNorm(self.embed_dim, eps=FLAX_NORM_EPS)
        elif temporal == "gru":
            self.gru = GRUCell(self.embed_dim, self.embed_dim)
        self.head = dnn.LecunDense(self.embed_dim, int(n_classes))
        self._materialise(device, generator)

    def init_parameters(self, generator: torch.Generator):
        if self.temporal == "transformer":
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool == "gap":
            return x.mean((2, 3))
        nf, c, hh, ww = x.shape
        p = torch.softmax(x.reshape(nf, c, hh * ww), dim=-1)
        ys, xs = torch.meshgrid(torch.linspace(-1.0, 1.0, hh, device=x.device),
                                torch.linspace(-1.0, 1.0, ww, device=x.device),
                                indexing="ij")
        coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=-1).to(p.dtype)
        return (p @ coords).reshape(nf, 2 * c)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        if clips.dim() != 5:
            raise ValueError(f"expected (N, F, H, W, C) clips, got {tuple(clips.shape)}")
        n, f = clips.shape[:2]
        x = clips.reshape(n * f, *clips.shape[2:]).movedim(-1, 1)
        for i in range(self.n_enc):
            x = getattr(self, f"enc_gn_{i}")(getattr(self, f"enc_conv_{i}")(x))
            x = dnn.gelu_tanh(x)
        e = self.embed(self._pool(x)).reshape(n, f, self.embed_dim)
        if self.temporal == "transformer":
            h = e + self.pos_embedding
            for i in range(self.n_blocks):
                h = getattr(self, f"block_{i}")(h)
            h = self.ln_final(h).mean(1)
        elif self.temporal == "gru":
            h = e.new_zeros((n, self.embed_dim))
            for t in range(f):
                h = self.gru(h, e[:, t])
        else:
            h = e.mean(1)
        return self.head(h)


def create_temporal_model(datasets, model_params: Mapping[str, Any],
                          device=None) -> TemporalVideoModel:
    trainset = datasets["trainset"]
    p = dict(model_params or {})
    return TemporalVideoModel(
        trainset.image_shape, n_classes=trainset.num_classes,
        temporal=str(p.get("temporal", "transformer")),
        embed_dim=int(p.get("embed_dim", 32)),
        encoder_features=tuple(int(c) for c in p.get("encoder_features", (16, 32))),
        encoder_strides=tuple(int(s) for s in p.get("encoder_strides", (2, 2))),
        pool=str(p.get("pool", "soft_argmax")), num_heads=int(p.get("num_heads", 4)),
        n_blocks=int(p.get("n_blocks", 1)), dropout_prob=float(p.get("dropout_prob", 0.0)),
        device=device)


def get_pipelines() -> Dict[str, Pipeline]:
    from deepcv_tpu_torch.pipelines.classification import create_model
    from deepcv_tpu_torch.pipelines.classification import train as train_classifier

    def clips(name: str, create: Callable, model_key: str) -> Pipeline:
        return Pipeline([
            Node(preprocess_node, ["clips_train", "clips_test", "params:clips_preprocessing"],
                 "datasets", name="preprocess"),
            Node(create, ["datasets", f"params:{model_key}", "device"], "model",
                 name="create_model"),
            Node(train_classifier, ["datasets", "model", f"params:{name}", "trackers"],
                 "train_results", name="train"),
        ], name=name, tags={"train", "video"})

    return {
        "train_optical_flow": Pipeline([
            Node(preprocess_node, ["flow_train", "flow_test", "params:flow_preprocessing"],
                 "datasets", name="preprocess"),
            Node(create_flow_model, ["datasets", "params:optical_flow_model", "device"],
                 "model", name="create_flow_model"),
            Node(train_flow, ["datasets", "model", "params:train_optical_flow", "trackers"],
                 "train_results", name="train"),
        ], name="train_optical_flow", tags={"train", "video"}),
        "train_video_classifier": clips("train_video_classifier", create_model,
                                        "video_classifier_model"),
        "train_temporal_classifier": clips("train_temporal_classifier", create_temporal_model,
                                           "temporal_classifier_model"),
    }

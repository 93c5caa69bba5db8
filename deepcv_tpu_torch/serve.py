"""Inference path: bundle -> model on the card -> fixed-batch predictor,
MC-dropout, ensembles, stacking and distillation targets.

Counterpart of ``deepcv_tpu/serve.py`` (``save_model_bundle``,
``load_model_bundle`` with ``dtype``, ``quantize`` and ``quantize_scales``,
``Predictor`` with ``__call__``, ``postprocess``, ``from_checkpoint``,
``predict_with_uncertainty``, ``benchmark`` and ``tta='flip'``,
``EnsemblePredictor``, ``StackedEnsemble``, ``distill_targets`` and
``ensemble_distill_targets``). ``export_stablehlo`` has no counterpart yet:
``torch.export`` cannot trace the kernels' ``ctypes`` launches.

A bundle is a directory with ``model.yaml`` in the JAX package's own format
(input shape, hp, NAS options: ``nas_mode``, ``nas_arch``, ``nas_sampling``)
and ``weights.npz``, the model's
``state_dict`` as numpy arrays. The JAX package writes its weights with
orbax, which the port cannot read; carry such weights across with
:mod:`deepcv_tpu_torch.interop`. A model of the port holds its weights, so
where the JAX package passes ``(model, variables)`` the port passes the
model.

Usage::

    model = load_model_bundle("bundle/")                 # on the card
    predictor = Predictor(model, batch_size=64, preprocess=pre)
    probs = predictor(images_uint8_nhwc)                 # any leading batch
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from deepcv_tpu_torch.spec.module import DeepcvModule
from deepcv_tpu_torch.utils import identifier_to_str, resolve_device

__all__ = ["Predictor", "EnsemblePredictor", "StackedEnsemble", "distill_targets",
           "ensemble_distill_targets", "save_model_bundle", "load_model_bundle"]

WEIGHTS_FILE = "weights.npz"


def _yamlable(obj):
    """YAML-safe hp tree: TaggedFactory/callables -> identifier strings."""
    from deepcv_tpu_torch.ops.nn import activation_name

    if hasattr(obj, "identifier"):  # TaggedFactory
        return obj.identifier
    if isinstance(obj, dict):
        return {k: _yamlable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yamlable(v) for v in obj]
    if callable(obj):
        return activation_name(obj) or identifier_to_str(obj)
    return obj


def save_model_bundle(directory: Union[str, Path], model: DeepcvModule) -> Path:
    """Write ``model.yaml`` and ``weights.npz`` (float32 ``state_dict``)."""
    import yaml

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    meta = {"input_shape": list(model.input_shape),
            "hp": _yamlable(model.hp.to_dict()),
            "nas_mode": getattr(model, "nas_mode", "fixed"),
            "nas_arch": _yamlable(dict(getattr(model, "nas_arch", {}))),
            "nas_sampling": getattr(model, "nas_sampling", "softmax")}
    (d / "model.yaml").write_text(yaml.safe_dump(meta, sort_keys=False,
                                                 default_flow_style=False))
    arrays = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    with open(d / WEIGHTS_FILE, "wb") as f:
        np.savez(f, **arrays)
    return d


def load_model_bundle(directory: Union[str, Path],
                      device: Union[None, str, torch.device] = None,
                      dtype: Union[None, str, torch.dtype] = None,
                      quantize: Optional[str] = None,
                      quantize_scales: Optional[Mapping[str, float]] = None) -> DeepcvModule:
    """The bundle's model with its weights, in eval mode, on ``device``
    (CUDA unless given). ``quantize='int8'`` builds it in w8a8 (dynamic
    activation scales unless ``quantize_scales`` gives static ones); the
    float weights load unchanged, since the quantization lives in the ops.
    A NAS bundle rebuilds the architecture its ``nas_mode``, ``nas_arch``
    and ``nas_sampling`` name (a fixed export, or a supernet)."""
    import yaml

    dev = resolve_device(device)
    d = Path(directory)
    meta = yaml.safe_load((d / "model.yaml").read_text())
    model = DeepcvModule(tuple(meta["input_shape"]), meta["hp"], device="meta",
                         dtype=dtype, quantize=quantize, quantize_scales=quantize_scales,
                         nas_mode=meta.get("nas_mode", "fixed"),
                         nas_arch=meta.get("nas_arch") or {},
                         nas_sampling=meta.get("nas_sampling", "softmax"))
    with np.load(d / WEIGHTS_FILE, allow_pickle=False) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev).eval()


class Predictor:
    """Batched inference at a fixed batch size on one device.

    Images are NHWC numpy arrays of any leading size; each chunk of
    ``batch_size`` goes to the device, through ``preprocess`` (on the
    device, NHWC tensors), a cast to ``dtype`` and the model, and comes back
    as float32 numpy rows. A ragged last chunk is zero-padded to the batch
    size so the model always sees one shape; the padded rows are dropped.
    ``tta='flip'`` also runs the horizontally mirrored batch and averages.
    ``postprocess`` maps the model's output tensor (on the device) before it
    comes back. ``forwards`` counts the model calls made.
    """

    def __init__(self, model: DeepcvModule, batch_size: int = 256,
                 preprocess: Optional[Callable] = None,
                 dtype: Union[None, str, torch.dtype] = None,
                 tta: Optional[str] = None,
                 device: Union[None, str, torch.device] = None,
                 postprocess: Optional[Callable] = None):
        if tta not in (None, "flip"):
            raise ValueError(f"unknown tta mode {tta!r} (known: 'flip')")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.tta = tta
        self.forwards = 0

    @classmethod
    def from_checkpoint(cls, model: DeepcvModule, checkpoint_path: Union[str, Path],
                        best: bool = True, **kw) -> "Predictor":
        """A predictor of ``model`` with the weights of a ``train()``
        checkpoint directory (its best-k checkpoint when it has one and
        ``best``, else its latest step) or of a checkpoint file."""
        from deepcv_tpu_torch.train.checkpoint import CheckpointManager, resume_from_path

        p = Path(checkpoint_path)
        state = None
        if best and (p / "best").exists():
            try:
                state = CheckpointManager(p).restore_best(map_location="cpu")
            except FileNotFoundError:
                state = None
        if state is None:
            state = resume_from_path(p, map_location="cpu")
        model.load_state_dict(state["model"])
        return cls(model, **kw)

    def _model_input(self, chunk: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        if self.preprocess is not None:
            x = self.preprocess(x)
        return x if self.dtype is None else x.to(self.dtype)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        y = self.model(x)
        self.forwards += 1
        if self.tta == "flip":
            y = (y + self.model(torch.flip(x, dims=[2]))) * 0.5
            self.forwards += 1
        return y

    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            y = self._apply(self._model_input(chunk))
            if self.postprocess is not None:
                y = self.postprocess(y)
            return y.float().cpu().numpy()

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """Predict any leading batch size (ragged tails are zero-padded)."""
        images = np.asarray(images)
        n = len(images)
        if n == 0:
            return np.empty((0, *self.model.output_shape[1:]), np.float32)
        bs = self.batch_size
        outs = []
        for start in range(0, n, bs):
            chunk = images[start:start + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            outs.append(self._forward(chunk)[:bs - pad])
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def predict_with_uncertainty(self, images: np.ndarray, n_samples: int = 8,
                                 seed: int = 0):
        """MC-dropout predictive uncertainty: the model runs ``n_samples``
        times in training mode (dropout, drop-path and router noise on,
        sample i drawing from a generator seeded ``seed + i``), and this
        returns the (mean, std) over the samples. Batch norm normalises with
        each batch's statistics and its running statistics are left as they
        were (every buffer is restored), as the JAX package discards the
        update. Chunks of ``batch_size`` go through unpadded, so a ragged
        last chunk is normalised by its own statistics. Models without
        dropout give std 0; a real-int8 build refuses training mode."""
        from deepcv_tpu_torch.ops.moe import MoEMlp
        from deepcv_tpu_torch.ops.nn import Dropout

        model = self.model
        images = np.asarray(images)
        drawers = [m for m in model.modules() if isinstance(m, (Dropout, MoEMlp))]
        generators = [m.generator for m in drawers]
        buffers = {k: b.detach().clone() for k, b in model.named_buffers()}
        outs = []
        try:
            model.train()
            with torch.no_grad():
                for i in range(n_samples):
                    gen = torch.Generator(device=self.device).manual_seed(seed + i)
                    for m in drawers:
                        m.generator = gen
                    ys = []
                    for lo in range(0, len(images), self.batch_size):
                        y = self._apply(self._model_input(images[lo:lo + self.batch_size]))
                        ys.append(y.float().cpu().numpy())
                    outs.append(np.concatenate(ys))
        finally:
            model.eval()
            for m, g in zip(drawers, generators):
                m.generator = g
            with torch.no_grad():
                for k, b in model.named_buffers():
                    b.copy_(buffers[k])
        stacked = np.stack(outs)
        return stacked.mean(axis=0), stacked.std(axis=0)

    def benchmark(self, batch: Optional[int] = None, n_iters: int = 20) -> Dict[str, float]:
        """Steady-state throughput of the predictor's forward at ``batch``,
        host clock around work that ends in a device synchronise."""
        bs = int(batch or self.batch_size)
        x = np.random.default_rng(0).integers(
            0, 256, (bs, *self.model.input_shape)).astype(np.uint8)
        y = self._forward(x)                      # warm-up (kernel build, caches)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            y = self._forward(x)                  # ends in a device->host copy
        dt = time.perf_counter() - t0
        return {"img_per_s": bs * n_iters / dt, "latency_ms": dt / n_iters * 1e3,
                "batch": bs, "checksum": float(y.sum()), "device": str(self.device)}


# --------------------------------------------------------------------------- #
# Ensembling, stacking and distillation targets
# --------------------------------------------------------------------------- #

def _softmax(outs: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.softmax(torch.from_numpy(np.asarray(outs, np.float32)).to(device), dim=-1)


class EnsemblePredictor:
    """Average N member models' predictions.

    ``members``: :class:`Predictor` instances or models (each then wrapped in a
    ``Predictor(model, **predictor_kw)``); mixed architectures are welcome.
    ``mode='prob'`` (default) averages softmax probabilities, ``mode='mean'``
    raw outputs (embeddings, regression heads). Optional per-member
    ``weights`` (normalized). The softmax runs on the first member's
    device, the weighted average on the host as in the JAX package."""

    def __init__(self, members: Sequence[Any], mode: str = "prob", weights=None,
                 **predictor_kw):
        if mode not in ("prob", "mean"):
            raise ValueError(f"unknown ensemble mode {mode!r} (prob|mean)")
        self.members = [m if isinstance(m, Predictor) else Predictor(m, **predictor_kw)
                        for m in members]
        if not self.members:
            raise ValueError("EnsemblePredictor needs at least one member")
        self.mode = mode
        w = np.ones(len(self.members)) if weights is None else np.asarray(weights, np.float64)
        if w.shape != (len(self.members),) or (w < 0).any() or w.sum() <= 0:
            raise ValueError("weights must be non-negative, one per member")
        self.weights = w / w.sum()
        self.device = self.members[0].device

    def member_outputs(self, images) -> np.ndarray:
        """(M, N, C) raw member outputs (the stacker's feature layout)."""
        return np.stack([np.asarray(p(images), np.float32) for p in self.members])

    def __call__(self, images) -> np.ndarray:
        outs = self.member_outputs(images)
        if self.mode == "prob":
            outs = _softmax(outs, self.device).cpu().numpy()
        return np.einsum("m,mnc->nc", self.weights, outs)


class StackedEnsemble(EnsemblePredictor):
    """Stacking: a learned linear combiner over the members' probabilities.
    ``fit`` trains one dense (M*C -> C) head with softmax cross-entropy on a
    held-out split, full-batch Adam from the uniform average (identity
    blocks), in float32 on the first member's device; the members run
    once."""

    def fit(self, images, labels, *, steps: int = 300, lr: float = 0.05,
            l2: float = 1e-4, seed: int = 0) -> float:
        import torch.nn.functional as F

        dev = self.device
        probs = _softmax(self.member_outputs(images), dev)
        m, n, c = probs.shape
        feats = probs.permute(1, 0, 2).reshape(n, m * c)
        y = torch.from_numpy(np.asarray(labels).reshape(-1).astype(np.int64)).to(dev)
        if y.shape[0] != n:
            raise ValueError(f"{n} stacked rows vs {y.shape[0]} labels")
        params = {"w": (torch.eye(c, device=dev).repeat(m, 1) / m).requires_grad_(),
                  "b": torch.zeros(c, device=dev, requires_grad=True)}
        # optax.adam(lr) with its defaults, term for term
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        loss = torch.zeros((), device=dev)
        for t in range(1, steps + 1):
            logits = feats @ params["w"] + params["b"]
            loss = F.cross_entropy(logits, y) + l2 * params["w"].square().sum()
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * g * g + b2 * nu[k]
                    mu_hat = mu[k] / torch.tensor(1 - b1 ** t, dtype=torch.float32, device=dev)
                    nu_hat = nu[k] / torch.tensor(1 - b2 ** t, dtype=torch.float32, device=dev)
                    p.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))
        self._stack_params = {k: v.detach() for k, v in params.items()}
        return float(loss.detach())

    def __call__(self, images) -> np.ndarray:
        if not hasattr(self, "_stack_params"):
            raise RuntimeError("StackedEnsemble: call fit(images, labels) on a held-out "
                               "split before predicting")
        probs = _softmax(self.member_outputs(images), self.device)
        m, n, c = probs.shape
        feats = probs.permute(1, 0, 2).reshape(n, m * c)
        p = self._stack_params
        return (feats @ p["w"] + p["b"]).cpu().numpy()


def _stack_distill_targets(dataset, logits_fn: Callable[[], np.ndarray], suffix: str):
    """The (N, 1 + C) [hard label | logits] targets that
    ``train.losses.distillation_loss`` consumes, as a new ArrayDataset; the
    labels are checked before ``logits_fn`` (the teacher's inference)
    runs."""
    from deepcv_tpu_torch.data.datasets import ArrayDataset

    labels = np.asarray(dataset.targets, np.float32).reshape(len(dataset), -1)
    if labels.shape[1] != 1:
        raise ValueError("distill targets expect integer class targets "
                         f"(got target shape {np.shape(dataset.targets)})")
    logits = np.asarray(logits_fn(), np.float32)
    classes = dataset.classes or [f"class_{i}" for i in range(logits.shape[1])]
    return ArrayDataset(dataset.images, np.concatenate([labels, logits], axis=1),
                        classes=classes, name=f"{dataset.name}_{suffix}",
                        provenance=getattr(dataset, "provenance", "real"))


def distill_targets(teacher: DeepcvModule, dataset, batch_size: int = 256,
                    preprocess: Optional[Callable] = None,
                    device: Union[None, str, torch.device] = None):
    """A frozen teacher's logits over ``dataset``, stacked after the hard
    label as a new ArrayDataset's (N, 1 + C) targets: offline distillation,
    the teacher runs once here and the student's step stays single-model."""
    pred = Predictor(teacher, batch_size=batch_size, preprocess=preprocess, device=device)
    return _stack_distill_targets(dataset, lambda: pred(dataset.images), "distill")


def ensemble_distill_targets(members: Sequence[Any], dataset, batch_size: int = 256,
                             preprocess: Optional[Callable] = None,
                             device: Union[None, str, torch.device] = None):
    """Distillation targets from an ensemble of teachers: the members' mean
    softmax probability as log-probabilities (softmax-invariant
    pseudo-logits), stacked as :func:`distill_targets` stacks them."""
    ens = EnsemblePredictor(members, mode="prob", batch_size=batch_size,
                            preprocess=preprocess, device=device)

    def pseudo_logits():
        mean_prob = np.asarray(ens(dataset.images), np.float32)
        return np.log(np.maximum(mean_prob, 1e-12))

    return _stack_distill_targets(dataset, pseudo_logits, "ens_distill")

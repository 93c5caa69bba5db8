"""The training procedure on one device.

Counterpart of ``deepcv_tpu/train/training.py`` (``train``,
``train_with_retries``, ``build_optimizer``, ``scale_updates_by_path``'s
rule, ``TRAINING_HP_DEFAULTS``, ``TrainingEvents``, ``CrashIteration``,
``Preempted``) on one card:

* **the input paths.** With ``device_resident_dataset: true`` (or ``auto``
  and a dataset of at most 2 GiB that is not a memmap) the whole trainset
  lives on the device as uint8, its targets as the dataset keeps them
  (float ones as float32, labels and masks as int64). Each epoch visits every
  sample once in the order of a permutation drawn from a generator keyed
  by (seed, epoch) alone, or, with ``sampling: with_replacement``, each
  step draws its batch uniformly from a generator keyed by (seed, step).
  Otherwise the run streams, and the host gathers each batch in the JAX
  package's order: ``native_loader: auto`` or ``true`` takes the C++
  ring-buffer loader (:class:`~deepcv_tpu_torch.runtime.NativeBatchLoader`,
  three batches gathered ahead, the order of ``seed + epoch``) where its
  library builds, ``auto`` falls back to
  :class:`~deepcv_tpu_torch.data.pipeline.BatchIterator` (the numpy order)
  where it does not, ``true`` raises, ``false`` takes the numpy iterator.
  :func:`~deepcv_tpu_torch.data.pipeline.prefetch_to_device` copies each
  batch from pinned memory on a side stream, ``prefetch_batches`` (2
  batches, or 1) in flight; ``wire_compression`` (``true`` is ``{bits: 3,
  axis: -2}``) ships the images coded and decodes them on the device;
* **the step.** Each step transforms its batch on the device (augmenting it
  from a generator keyed by (seed, step); validation batches are not
  augmented), runs the forward under ``torch.autocast`` when ``dtype`` is
  bfloat16 (parameters stay float32) and computes the loss in float32. A
  model with V-MoE blocks adds ``moe_aux_weight`` times the mean of their
  load-balance losses; ``mixup_alpha`` / ``cutmix_alpha`` mix the batch
  and the loss; ``augmix_jsd`` adds AugMix's JSD consistency; ``uda``
  (with ``datasets['unlabeledset']`` joined to the resident pool under
  target -1) adds the KL of a sharpened, stopped teacher (the batch's own
  logits) to a student that sees an AugMix view, on the confident
  unlabeled rows; ``param_regularizer(named parameters)`` joins the
  training loss. ``remat: true`` recomputes the forward in the backward
  pass, ``remat: dots`` keeps the outputs of the matmuls and convolutions
  (the K2 launches among them) and recomputes the rest; the recomputation
  replays the first forward's draws of the loop's generator and leaves
  the buffers (BatchNorm's statistics) as that forward left them;
* **the update chain**, in the JAX package's order: ``freeze_params``
  (parameters whose JAX path matches the regex take no update, weight
  decay included, and stay out of the optimizer and of the clip's norm)
  around ``gradient_clip_norm`` (optax's ``clip_by_global_norm``), the
  optimizer (:mod:`~deepcv_tpu_torch.train.optimizers`: the ten names) and
  ``lr_scales`` (the first matching regex scales a parameter's update,
  ``p_old + s * (p_new - p_old)``), all inside ``grad_accumulation_steps``
  (optax's ``MultiSteps``: the running mean of the micro-steps' gradients
  updates the parameters every k-th micro-step; the schedules read the
  count of real updates, the buffers move every micro-step, the log and
  save cadences count micro-steps). ``ema_decay`` keeps an exponential
  moving average of the parameters, moved on each real update; with
  ``ema_eval`` validation and ``TrainState.eval_weights`` use it.
  ``schedule_free_adamw`` validates at its averaged iterate and cannot
  combine with ``ema_decay``;
* validation after every ``validate_every_epochs`` epochs, periodic and
  best-k checkpoints (the accumulated gradients and the EMA included),
  exact resume, SIGTERM preemption, injected crashes, ``events``
  (:class:`TrainingEvents`), loggers (``log_param_histograms`` adds the
  parameters' histograms at each validation) and
  :func:`train_with_retries`;
* **search.** ``runtime_lr: true`` is accepted and trains bit-equal to
  ``false``: the JAX package injects the learning rate into the optimizer's
  state so that every trial of a search shares one XLA executable, and a
  PyTorch optimizer already reads it from ``param_groups`` at each step.
  ``train_arch_params: false`` leaves a NAS supernet's ``arch__*`` logits
  out of the update chain, as ``freeze_params`` does (no update, no weight
  decay, no momentum, outside the clip's norm). A supernet's ``sampled``
  and ``uniform`` draws take the loop's generator, seeded from ``seed``.

Every other hp key of the JAX list raises an error naming it when it is set
to anything but its off value (:data:`UNPORTED_HP`), as does a multi-device
``backend_conf``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import itertools
import logging
import os
import re
import signal
import threading
import time
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.nn.functional as F

from deepcv_tpu_torch.data import augmentation as aug
from deepcv_tpu_torch.data.datasets import ArrayDataset
from deepcv_tpu_torch.data.pipeline import (BatchIterator, DeviceDataset, prefetch_to_device,
                                            unwrap_dataset)
from deepcv_tpu_torch.data.transforms import to_tensor, uniform
from deepcv_tpu_torch.hyperparams import to_hyperparameters
from deepcv_tpu_torch.interop import jax_param_paths
from deepcv_tpu_torch.ops.moe import MoEMlp
from deepcv_tpu_torch.ops.nn import Dropout
from deepcv_tpu_torch.spec.graph import ARCH_PARAM_PREFIX, SpecModule
from deepcv_tpu_torch.train.backend import BackendConfig
from deepcv_tpu_torch.train.checkpoint import CheckpointManager, resume_from_path
from deepcv_tpu_torch.train.losses import (WeightedLosses,
                                           jensen_shannon_divergence_consistency_loss)
from deepcv_tpu_torch.train.metrics import MetricAccumulator, accuracy
from deepcv_tpu_torch.train.optimizers import (ScheduleFreeAdamW, apply_schedules,
                                               build_optimizer, clip_by_global_norm)
from deepcv_tpu_torch.train.schedules import build_schedules
from deepcv_tpu_torch.utils import EventsHandler

__all__ = ["TRAINING_HP_DEFAULTS", "UNPORTED_HP", "TrainState", "TrainingEvents", "train",
           "train_with_retries", "train_step", "build_optimizer", "apply_schedules",
           "epoch_permutation", "step_generator", "cudnn_deterministic", "mix_batch",
           "mixed_losses", "jsd_views", "uda_terms", "remat_forward", "scales_by_path",
           "frozen_by_path", "CrashIteration", "Preempted", "request_preemption"]

_logger = logging.getLogger(__name__)

#: the JAX package's TRAINING_HP_DEFAULTS (``...`` marks a required key)
TRAINING_HP_DEFAULTS: Dict[str, Any] = {
    "epochs": ...,
    "batch_size": ...,
    "optimizer_opts": ...,
    "optimizer": "adamw",
    "scheduler": None,
    "losses_weights": None,
    "validate_every_epochs": 1,
    "save_every_iters": 1000,
    "log_progress_every_iters": 100,
    "keep_best_models": 3,
    "prefetch_batches": True,
    "device_resident_dataset": "auto",
    "resume_from": "",
    "crash_iteration": -1,
    "handle_preemption": True,
    "seed": 563454,
    "deterministic": False,
    "use_sync_batch_norm": True,
    "dtype": None,
    "output_path": "data/04_training",
    "eval_batch_multiplier": 32,
    "nni_compression": None,
    "log_grad_norm": True,
    "log_param_histograms": False,
    "grad_accumulation_steps": 1,
    "remat": False,
    "sampling": "epoch",
    "max_epochs_per_dispatch": 1,
    "sync_every_dispatches": 1,
    "runtime_lr": False,
    "flatten_optimizer": False,
    "flat_params": False,
    "wire_compression": False,
    "train_arch_params": True,
    "run_dir": None,
    "self_supervised_target": None,
    "ema_decay": None,
    "ema_eval": True,
    "gradient_clip_norm": None,
    "freeze_params": None,
    "lr_scales": None,
    "mixup_alpha": 0.0,
    "cutmix_alpha": 0.0,
    "moe_aux_weight": 0.01,
    "uda": None,
}

#: hp keys the JAX package reads that the port does not carry, each with
#: its off value; any other value raises, naming the key.
#: ``flatten_optimizer``, ``flat_params``, ``max_epochs_per_dispatch`` and
#: ``sync_every_dispatches`` are TPU dispatch workarounds; the JAX package
#: reads ``nni_compression`` nowhere.
UNPORTED_HP: Dict[str, Any] = {
    "nni_compression": None,
    "max_epochs_per_dispatch": 1,
    "sync_every_dispatches": 1,
    "flatten_optimizer": False,
    "flat_params": False,
}

#: ``auto``: stream a trainset larger than this (or a memmap)
RESIDENT_LIMIT_BYTES = 2 * 1024 ** 3


class CrashIteration(RuntimeError):
    """Injected fault at ``hp['crash_iteration']`` (tests of resume)."""


class Preempted(RuntimeError):
    """Training stopped on SIGTERM after checkpointing its state."""


_PREEMPTION = threading.Event()


def request_preemption() -> None:
    """Ask a running ``train()`` to checkpoint and stop at its next step
    boundary (what its SIGTERM handler does)."""
    _PREEMPTION.set()


class TrainingEvents(EventsHandler):
    """The loop's events: ``iteration_completed`` (count = step; state,
    metrics), ``epoch_completed`` (count = epoch; state, metrics,
    throughput), ``validation_completed`` (count = epoch; state, metrics)
    and ``completed`` (state, history)."""
    ITERATION_COMPLETED = "iteration_completed"
    EPOCH_COMPLETED = "epoch_completed"
    VALIDATION_COMPLETED = "validation_completed"
    COMPLETED = "completed"

    def __init__(self):
        super().__init__(self.ITERATION_COMPLETED, self.EPOCH_COMPLETED,
                         self.VALIDATION_COMPLETED, self.COMPLETED)


@dataclasses.dataclass
class TrainState:
    """What ``train()`` trains: the model, its optimizer, the number of
    micro-steps taken and the generator that feeds dropout, drop-path and the
    MoE router noise; then the update chain's state. ``params`` are the
    parameters the optimizer updates (all when None), ``lr_scales`` their
    scales (aligned with ``params``), ``accum`` the micro-steps per update,
    ``acc_grads`` the running mean of their gradients and ``mini_step`` the
    micro-step within the accumulation, ``ema`` the moving average of the
    parameters by name."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    params: Optional[List[torch.nn.Parameter]] = None
    lr_scales: Optional[List[float]] = None
    clip: Optional[float] = None
    accum: int = 1
    acc_grads: Optional[List[torch.Tensor]] = None
    mini_step: int = 0
    ema_decay: Optional[float] = None
    ema: Optional[Dict[str, torch.Tensor]] = None

    def trainable(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters()) if self.params is None else self.params

    @property
    def updates(self) -> int:
        """Real updates applied (the count the schedules read)."""
        return self.step // self.accum

    def checkpoint(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "mini_step": self.mini_step,
                "acc_grads": self.acc_grads, "ema": self.ema}

    def load(self, ckpt: Mapping[str, Any]) -> None:
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.generator.set_state(ckpt["generator"])
        self.step = int(ckpt["step"])
        self.mini_step = int(ckpt.get("mini_step", 0))
        if ckpt.get("acc_grads") is not None:
            self.acc_grads = [a.to(p.device) for a, p in zip(ckpt["acc_grads"],
                                                             self.trainable())]
        if ckpt.get("ema") is not None:
            dev = next(self.model.parameters()).device
            self.ema = {k: v.to(dev) for k, v in ckpt["ema"].items()}

    def eval_parameters(self) -> Optional[Dict[torch.nn.Parameter, torch.Tensor]]:
        """The weights to evaluate with, where they are not the parameters:
        the schedule-free averaged iterate, else the EMA (None: the
        parameters themselves)."""
        if isinstance(self.optimizer, ScheduleFreeAdamW):
            return self.optimizer.eval_params()
        if self.ema is not None:
            return {p: self.ema[n] for n, p in self.model.named_parameters()}
        return None

    @contextlib.contextmanager
    def eval_weights(self, use: bool = True):
        """Inside the block the model's parameters hold
        :meth:`eval_parameters` (when ``use``); they are restored on exit."""
        swap = self.eval_parameters() if use else None
        if not swap:
            yield self.model
            return
        kept = {p: p.detach().clone() for p in swap}
        with torch.no_grad():
            for p, v in swap.items():
                p.copy_(v)
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for p, v in kept.items():
                    p.copy_(v)


# --------------------------------------------------------------------------- #
# Parameter paths: freeze_params and lr_scales
# --------------------------------------------------------------------------- #

def frozen_by_path(model: torch.nn.Module, regex: str) -> List[str]:
    """Names of the parameters whose JAX path matches ``regex``
    (``re.search``)."""
    pat = re.compile(str(regex))
    return [n for n, path in jax_param_paths(model).items() if pat.search(path)]


def scales_by_path(model: torch.nn.Module, lr_scales: Mapping[str, float]) -> Dict[str, float]:
    """Each parameter's update scale: the value of the first regex (in
    order) that its JAX path matches, 1.0 where none does."""
    pats = [(re.compile(str(p)), float(s)) for p, s in lr_scales.items()]
    return {n: next((s for pat, s in pats if pat.search(path)), 1.0)
            for n, path in jax_param_paths(model).items()}


# --------------------------------------------------------------------------- #
# Steps
# --------------------------------------------------------------------------- #

def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    if dtype is None or dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def mix_batch(x: torch.Tensor, generator: torch.Generator, mixup_alpha: float,
              cutmix_alpha: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mixup or CutMix on a transformed batch: (x_mixed, perm, lam). With
    both alphas set, one Bernoulli(0.5) draw picks CutMix (true) or mixup."""
    if mixup_alpha > 0 and cutmix_alpha > 0:
        pick = bool(uniform((), generator) < 0.5)
        return aug.cutmix_batch(x, generator, cutmix_alpha) if pick \
            else aug.mixup_batch(x, generator, mixup_alpha)
    if cutmix_alpha > 0:
        return aug.cutmix_batch(x, generator, cutmix_alpha)
    return aug.mixup_batch(x, generator, mixup_alpha)


def mixed_losses(losses: Callable, logits: torch.Tensor, y: torch.Tensor,
                 perm: torch.Tensor, lam: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The convex combination ``lam * loss(y) + (1 - lam) * loss(y[perm])``
    of every term, the main loss included."""
    _, terms_a = losses(logits, y)
    _, terms_b = losses(logits, y.index_select(0, perm.to(y.device)))
    terms = {k: lam * terms_a[k] + (1.0 - lam) * terms_b[k] for k in terms_a}
    return terms[WeightedLosses.MAIN], terms


def _augmix_view(raw: torch.Tensor, trainset, generator: torch.Generator,
                 cfg: Mapping[str, Any]) -> torch.Tensor:
    """``to_tensor``, AugMix at the config's severity, width, depth and ops,
    then the trainset's transform list."""
    xa = aug.augment_and_mix(to_tensor(raw), generator, severity=int(cfg.get("severity", 3)),
                             width=int(cfg.get("width", 3)), depth=int(cfg.get("depth", -1)),
                             ops=tuple(cfg["ops"]) if cfg.get("ops") else None)
    return trainset.transform(xa, generator) if trainset.transform is not None else xa


def jsd_views(raw: torch.Tensor, trainset, generator: torch.Generator,
              cfg: Mapping[str, Any]) -> List[torch.Tensor]:
    """The ``augmix_jsd`` views of a raw batch (``views`` AugMix views)."""
    return [_augmix_view(raw, trainset, generator, cfg) for _ in range(int(cfg.get("views", 2)))]


def uda_terms(logits: torch.Tensor, student_logits: torch.Tensor, y: torch.Tensor,
              cfg: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """UDA's terms (arXiv:1904.12848), as the JAX loop computes them: the
    teacher is the batch's own logits, stopped and sharpened by
    ``temperature``; ``uda_consistency`` is KL(teacher || student) over the
    unlabeled rows (target < 0) whose teacher confidence reaches
    ``confidence_threshold``, ``uda_masked_frac`` their share of the batch,
    ``labeled_accuracy`` the accuracy on the labeled rows."""
    t_logits = logits.detach().float()
    p_teacher = F.softmax(t_logits / float(cfg.get("temperature", 0.4)), dim=-1)
    conf = F.softmax(t_logits, dim=-1).max(-1).values
    unlabeled = y < 0
    m = (unlabeled & (conf >= float(cfg.get("confidence_threshold", 0.0)))).float()
    logq = F.log_softmax(student_logits.float(), dim=-1)
    kl = (p_teacher * (torch.log(torch.clamp(p_teacher, min=1e-12)) - logq)).sum(-1)
    lm = (~unlabeled).float()
    hits = (logits.argmax(-1) == torch.clamp(y, min=0)).float()
    return {"uda_consistency": (kl * m).sum() / torch.clamp(m.sum(), min=1.0),
            "uda_masked_frac": m.mean(),
            "labeled_accuracy": (hits * lm).sum() / torch.clamp(lm.sum(), min=1.0)}


#: aten ops whose outputs ``remat: dots`` keeps: matmuls and convolutions
#: without batch dimensions (the JAX policy ``dots_with_no_batch_dims_saveable``)
#: and K2's launch
_DOTS = ("mm", "addmm", "convolution", "_convolution", "cudnn_convolution")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    keep = (op.namespace == "aten" and op._opname in _DOTS) or op.namespace == "deepcv"
    return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


class remat_forward:
    """``model``'s forward under activation checkpointing: ``true``/``all``
    recomputes everything in the backward pass, ``dots`` keeps the outputs
    of the matmuls, convolutions and K2 launches. The recomputation replays
    what the first forward drew from ``generator``; run the backward pass
    inside :meth:`backward_guard`, which leaves the generator and the
    model's buffers as the forward passes left them."""

    def __init__(self, model: torch.nn.Module, mode: Union[bool, str],
                 generator: Optional[torch.Generator]):
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        if mode in (True, 1, "all", "full"):
            self._context = {}
        elif mode in ("dots", "dots_saveable"):
            self._context = {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)}
        else:
            raise ValueError(f"remat must be true|'all'|'dots', got {mode!r}")
        self.model, self.generator = model, generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from torch.utils.checkpoint import checkpoint

        before = None if self.generator is None else self.generator.get_state()
        first = [True]

        def run(inp):
            if not first[0] and before is not None:
                self.generator.set_state(before)
            first[0] = False
            return self.model(inp)

        return checkpoint(run, x, use_reentrant=False, **self._context)

    @contextlib.contextmanager
    def backward_guard(self):
        after = None if self.generator is None else self.generator.get_state()
        with _buffers_kept(self.model):
            yield
        if after is not None:
            self.generator.set_state(after)


@contextlib.contextmanager
def _buffers_kept(model: torch.nn.Module):
    """The model's buffers as they were on entry, after the block (the
    extra forwards of the JSD and UDA views leave BatchNorm's statistics
    as the batch's forward left them, as the JAX loop keeps only that
    forward's state)."""
    kept = [b.detach().clone() for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, saved in zip(model.buffers(), kept):
                b.copy_(saved)


def _apply_update(state: TrainState, schedules: Mapping[str, Callable[[int], float]]) -> bool:
    """The update chain after a backward pass: accumulation (optax
    ``MultiSteps``), then the clip, the optimizer's step (schedules at the
    count of real updates) and the per-parameter scales, then the EMA.
    Returns whether the parameters were updated."""
    params = state.trainable()
    with torch.no_grad():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if state.accum > 1:
            if state.acc_grads is None:
                state.acc_grads = [torch.zeros_like(g) for g in grads]
            n = state.mini_step
            state.acc_grads = [a + (g - a) / (n + 1) for a, g in zip(state.acc_grads, grads)]
            state.mini_step = (n + 1) % state.accum
            if state.mini_step != 0:
                return False
            grads = state.acc_grads
            state.acc_grads = [torch.zeros_like(a) for a in grads]
        for p, g in zip(params, grads):
            if g is not p.grad:
                p.grad = g.clone()
        if state.clip:
            clip_by_global_norm([p.grad for p in params], float(state.clip))
        apply_schedules(state.optimizer, schedules, state.updates)
        scaled = [(p, s, p.detach().clone()) for p, s in zip(params, state.lr_scales or ())
                  if s != 1.0]
    state.optimizer.step()
    with torch.no_grad():
        for p, s, old in scaled:
            p.copy_(old + s * (p - old))
        if state.ema is not None:
            d = float(state.ema_decay)
            for n, p in state.model.named_parameters():
                state.ema[n] = d * state.ema[n] + (1.0 - d) * p.detach()
    return True


def train_step(state: TrainState, losses: Callable, metrics: Mapping[str, Callable],
               x: torch.Tensor, y: torch.Tensor, *, dtype: Optional[torch.dtype] = None,
               schedules: Optional[Mapping[str, Callable[[int], float]]] = None,
               log_grad_norm: bool = True, moe_aux_weight: float = 0.0,
               mix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               views: Sequence[torch.Tensor] = (), jsd_weight: float = 0.0,
               uda: Optional[Tuple[torch.Tensor, Mapping[str, Any]]] = None,
               forward: Optional[Callable] = None,
               param_regularizer: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One micro-step on a transformed batch ``x`` (NHWC float) with targets
    ``y``; returns the step's metrics as device scalars. With
    ``moe_aux_weight``, the mean load-balance loss of the model's MoE
    layers (their ``aux`` after this forward), times the weight, joins the
    objective as the JAX package's ``train()`` adds it. ``mix`` (perm, lam)
    mixes the loss (:func:`mixed_losses`); ``views`` add ``jsd_weight``
    times the JSD consistency of their logits with the batch's; ``uda``
    (the student's view, the config) adds ``weight`` times
    :func:`uda_terms`' consistency. ``forward`` replaces the model's call
    (:func:`remat_forward`). The update goes through the state's chain."""
    model = state.model
    forward = forward or model
    with _autocast(x.device, dtype):
        logits = forward(x)
    main, terms = losses(logits, y) if mix is None else mixed_losses(losses, logits, y, *mix)
    if moe_aux_weight:
        aux = torch.stack([m.aux for m in model.modules() if isinstance(m, MoEMlp)]).mean()
        main = main + moe_aux_weight * aux
        terms = {**terms, "moe_aux": aux, WeightedLosses.MAIN: main}
    if views:
        with _buffers_kept(model), _autocast(x.device, dtype):
            view_logits = [forward(xa) for xa in views]
        consistency = jensen_shannon_divergence_consistency_loss(logits, *view_logits)
        main = main + jsd_weight * consistency
        terms = {**terms, "jsd_consistency": consistency, WeightedLosses.MAIN: main}
    if uda is not None:
        xa, cfg = uda
        with _buffers_kept(model), _autocast(x.device, dtype):
            student = forward(xa)
        extra = uda_terms(logits, student, y, cfg)
        main = main + float(cfg.get("weight", 1.0)) * extra["uda_consistency"]
        terms = {**terms, **extra, WeightedLosses.MAIN: main}
    if param_regularizer is not None:
        main = main + param_regularizer(dict(model.named_parameters()))
        terms = {**terms, WeightedLosses.MAIN: main}
    model.zero_grad(set_to_none=True)
    with getattr(forward, "backward_guard", contextlib.nullcontext)():
        main.backward()
    out = {k: v.detach() for k, v in terms.items()}
    if log_grad_norm:
        out["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in model.parameters()
             if p.grad is not None]))
    _apply_update(state, schedules or {})
    state.step += 1
    with torch.no_grad():
        for name, fn in metrics.items():
            out[name] = fn(logits.float(), y)
    return out


def _device_targets(targets, device) -> torch.Tensor:
    """Targets on ``device``: float ones (pose heatmaps) as float32, integer
    ones (labels, masks) as int64. The JAX loop keeps the dataset's dtype and
    each loss casts what it needs."""
    t = targets if torch.is_tensor(targets) else torch.from_numpy(np.asarray(targets))
    return (t.float() if t.is_floating_point() else t.long()).to(device)


def _batch_target(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The target of a self-supervised batch: the transformed batch in the
    compute dtype (the JAX loop casts the batch before it takes it)."""
    return x if dtype is None else x.to(dtype)


def _keyed(seed: int, salt: int, i: int) -> int:
    return ((int(seed) ^ salt) * 1_000_003 + int(i)) % (2 ** 63)


def epoch_permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """The order of epoch ``epoch``: a permutation of ``n`` from a CPU
    generator keyed by (seed, epoch) alone."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(_keyed(seed, 0x5EED, epoch)))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator that augments the batch of micro-step ``step``: on
    ``device``, keyed by (seed, step) alone."""
    return torch.Generator(device=device).manual_seed(_keyed(seed, 0xA06, step))


def _sample_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator that draws the batch of micro-step ``step`` under
    ``sampling: with_replacement``."""
    return torch.Generator(device=device).manual_seed(_keyed(seed, 0x5A3, step))


@contextlib.contextmanager
def cudnn_deterministic(on: bool):
    """With ``on``, cuDNN picks deterministic algorithms and does not
    autotune inside the block; both flags are restored on exit, also when
    the block raises. ``torch.use_deterministic_algorithms`` is left alone:
    the backward of the bilinear resize in a ``dense_link`` has no
    deterministic CUDA implementation, and cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before its first handle."""
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    if on:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def _refuse_unported(hp: Mapping[str, Any]) -> None:
    for key, off in UNPORTED_HP.items():
        value = hp.get(key, off)
        if value != off and not (off is None and value in (False, {}, [])):
            raise NotImplementedError(
                f"hp '{key}' = {value!r} is not ported (the port trains with {key}: {off!r})")


def _wire_codec(hp: Mapping[str, Any]) -> Optional[Dict[str, Any]]:
    """hp ``wire_compression`` as ``prefetch_to_device``'s ``wire_codec``."""
    wire = hp.get("wire_compression", False)
    if wire is True:
        return {"bits": 3, "axis": -2}
    return dict(wire) if wire else None


def host_batches(iterator: BatchIterator, trainset, epoch: int, skip: int,
                 hp: Mapping[str, Any], seed: int
                 ) -> Tuple[str, Iterable[Tuple[np.ndarray, np.ndarray]]]:
    """One epoch of host batches after the first ``skip`` (an exact resume),
    and the loader's name (``native`` or ``numpy``): hp ``native_loader``
    ``auto`` (the default) or ``true`` takes the C++ loader, seeded with
    ``seed + epoch``, for ``iterator.num_batches`` batches; ``auto`` falls
    back to ``iterator`` where the library cannot be built, ``true`` raises
    there; ``false`` takes ``iterator``."""
    from deepcv_tpu_torch.runtime import NativeBatchLoader, native_available

    use_native = hp.get("native_loader", "auto")
    if use_native not in ("auto", True, False):
        raise ValueError(f"hp 'native_loader' must be auto, true or false, got {use_native!r}")
    if use_native is not False and native_available():
        data = unwrap_dataset(trainset)
        loader = NativeBatchLoader(data.images, data.targets, iterator.batch_size, depth=3,
                                   seed=seed + epoch)

        def gen():
            try:
                for i in range(iterator.num_batches):
                    batch = next(loader)
                    if i >= skip:
                        yield batch
            finally:
                loader.close()
        return "native", gen()
    if use_native is True:
        raise RuntimeError("hp 'native_loader' = True, but the C++ loader's library cannot "
                           "be built (no C++ compiler)")
    batches = iterator.epoch(epoch)
    return "numpy", itertools.islice(batches, skip, None) if skip else batches


def _backend(hp: Mapping[str, Any], backend_conf, device: torch.device) -> BackendConfig:
    if backend_conf is not None:
        return backend_conf
    conf = dict(hp.get("backend_conf") or {})
    try:
        return BackendConfig(**{"device": device, **conf})
    except NotImplementedError as e:
        raise NotImplementedError(f"hp 'backend_conf' = {conf!r}: {e}") from None


def _self_target(hp: Mapping[str, Any]) -> bool:
    """Whether the batch is its own target (``self_supervised_target:
    input``); any other value but off raises, naming the key."""
    value = hp.get("self_supervised_target")
    if value in (None, False):
        return False
    if value != "input":
        raise ValueError(f"hp 'self_supervised_target' = {value!r}: the one target the "
                         "training loop takes is 'input' (or null for the dataset's targets)")
    return True


def _resolve_dtype(dtype) -> Optional[torch.dtype]:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return None if dtype in (None, torch.float32) else dtype


def _uda_pool(trainset, unlabeledset) -> ArrayDataset:
    """The trainset with the unlabeled images appended under target -1
    (signed integer targets)."""
    base = unwrap_dataset(trainset)
    li, lt = np.asarray(base.images), np.asarray(base.targets)
    if lt.ndim != 1 or not np.issubdtype(lt.dtype, np.integer):
        raise ValueError(f"uda needs integer class targets (got targets of shape "
                         f"{lt.shape}, {lt.dtype})")
    if not np.issubdtype(lt.dtype, np.signedinteger):
        lt = lt.astype(np.int32)
    ui = np.asarray(getattr(unlabeledset, "images", unlabeledset))
    if ui.shape[1:] != li.shape[1:]:
        raise ValueError(f"unlabeled image shape {ui.shape[1:]} != labeled {li.shape[1:]}")
    return ArrayDataset(np.concatenate([li, ui.astype(li.dtype)]),
                        np.concatenate([lt, np.full(len(ui), -1, lt.dtype)]),
                        classes=base.classes, name=f"{base.name}_uda",
                        provenance=base.provenance)


def _run_dir_name(backend: BackendConfig) -> str:
    """``run_<timestamp>_<backend>`` (``cuda-x1``), the JAX package's name."""
    return f"run_{datetime.datetime.now().strftime('%Y%m%d-%H%M%S')}_{backend}"


def _histogram_name(path: str) -> str:
    """A JAX path in ``jax.tree_util.keystr``'s form."""
    return "".join(f"['{k}']" for k in path.split("/"))


# --------------------------------------------------------------------------- #
# The training procedure
# --------------------------------------------------------------------------- #

def train(hp: Mapping[str, Any], model: torch.nn.Module, losses, datasets: Mapping[str, Any],
          metrics: Optional[Mapping[str, Callable]] = None,
          loggers: Iterable[Any] = (),
          eval_metrics: Optional[Mapping[str, Callable]] = None, *,
          backend_conf: Optional[BackendConfig] = None,
          events: Optional[TrainingEvents] = None,
          param_regularizer: Optional[Callable] = None,
          init_variables: Optional[Mapping[str, torch.Tensor]] = None
          ) -> Tuple[TrainState, Dict[str, Any]]:
    """Train ``model`` on ``datasets`` ({'trainset', 'validset'[, 'testset',
    'unlabeledset']} of :class:`~deepcv_tpu_torch.data.preprocess.PreprocessedDataset`)
    on the device its parameters live on; returns ``(state, history)``.
    ``eval_metrics`` join ``metrics`` in the validation pass only;
    ``backend_conf`` wins over ``hp['backend_conf']``; ``init_variables``
    (a ``state_dict`` of the model) is copied into it first;
    ``param_regularizer(named parameters)`` joins the training loss."""
    hp, _ = to_hyperparameters(dict(hp), TRAINING_HP_DEFAULTS)
    _refuse_unported(hp)
    self_target = _self_target(hp)
    device = next(model.parameters()).device
    backend = _backend(hp, backend_conf, device)
    events = events or TrainingEvents()
    loggers = list(loggers)
    if not isinstance(losses, WeightedLosses):
        losses = WeightedLosses(losses, weights=hp.get("losses_weights"))
    metrics = dict(metrics or {"accuracy": accuracy})
    eval_metrics = {**metrics, **dict(eval_metrics or {})}
    seed = int(hp["seed"])
    trainset = datasets["trainset"]
    validset = datasets.get("validset", datasets.get("testset", trainset))
    batch_size, epochs = int(hp["batch_size"]), int(hp["epochs"])

    # ---------------- the input path --------------------------------------- #
    images_np = trainset.dataset.images
    resident = hp["device_resident_dataset"]
    if resident == "auto":
        resident = (images_np.nbytes <= RESIDENT_LIMIT_BYTES and backend.process_count == 1
                    and not isinstance(images_np, np.memmap))
    resident = bool(resident)
    uda_cfg = dict(hp.get("uda") or {})
    unlabeledset = datasets.get("unlabeledset")
    if uda_cfg:
        if unlabeledset is None:
            raise ValueError("hp['uda'] set but datasets['unlabeledset'] missing (pass an "
                             "ArrayDataset or image array)")
        if not resident:
            raise ValueError("uda requires the device-resident data path "
                             "(device_resident_dataset: true)")
    elif unlabeledset is not None:
        raise ValueError("datasets['unlabeledset'] present but hp['uda'] not set — pass "
                         "uda: {weight: ...} to enable it")
    if resident and len(trainset) < batch_size:
        raise ValueError(f"batch_size={batch_size} exceeds the trainset size {len(trainset)}: "
                         "zero steps per epoch (reduce batch_size)")
    sampling = str(hp.get("sampling", "epoch"))
    if sampling not in ("epoch", "with_replacement"):
        raise ValueError(f"sampling must be 'epoch' or 'with_replacement', got {sampling!r}")
    if resident:
        device_ds = DeviceDataset(_uda_pool(trainset, unlabeledset) if uda_cfg else trainset,
                                  batch_size, device)
        iterator = None
        steps_per_epoch = device_ds.steps_per_epoch
    else:
        device_ds = None
        iterator = BatchIterator(trainset, batch_size, shuffle=True, seed=seed)
        steps_per_epoch = len(iterator)

    # ---------------- the update chain ------------------------------------- #
    if init_variables is not None:
        model.load_state_dict({k: torch.as_tensor(v).clone() for k, v in init_variables.items()})
    named = list(model.named_parameters())
    frozen = set(frozen_by_path(model, hp["freeze_params"])) if hp.get("freeze_params") \
        else set()
    if not hp.get("train_arch_params", True):
        frozen |= {n for n, _ in named if n.rsplit(".", 1)[-1].startswith(ARCH_PARAM_PREFIX)}
    trainable = [(n, p) for n, p in named if n not in frozen]
    schedules = build_schedules(hp.get("scheduler"), hp.to_dict(), steps_per_epoch)
    optimizer = build_optimizer(hp["optimizer"], hp["optimizer_opts"], trainable, schedules)
    scales = scales_by_path(model, hp["lr_scales"]) if hp.get("lr_scales") else None
    ema_decay = None if hp.get("ema_decay") is None else float(hp["ema_decay"])
    sf_eval = isinstance(optimizer, ScheduleFreeAdamW)
    if sf_eval and ema_decay is not None:
        raise ValueError("schedule_free_adamw already evaluates an averaged iterate "
                         "(arXiv:2405.15682); combining it with ema_decay would average the "
                         "raw gradient-point iterates instead; set ema_decay: null")
    generator = torch.Generator(device=device).manual_seed(seed)
    has_moe = False
    for m in model.modules():
        if isinstance(m, (Dropout, MoEMlp, SpecModule)):
            m.generator = generator
        has_moe = has_moe or isinstance(m, MoEMlp)
    state = TrainState(model, optimizer, 0, generator,
                       params=[p for _, p in trainable] if frozen else None,
                       lr_scales=[scales[n] for n, _ in trainable] if scales else None,
                       clip=hp.get("gradient_clip_norm") or None,
                       accum=int(hp.get("grad_accumulation_steps") or 1),
                       ema_decay=ema_decay,
                       ema={n: p.detach().clone() for n, p in named}
                       if ema_decay is not None else None)
    if hp["resume_from"]:
        state.load(resume_from_path(hp["resume_from"], map_location=device))
        _logger.info("Resumed from %s at step %d", hp["resume_from"], state.step)
    dtype = _resolve_dtype(hp.get("dtype")) or getattr(model, "dtype", None)
    forward = remat_forward(model, hp["remat"], generator) if hp.get("remat") else model
    step_kw = dict(dtype=dtype, schedules=schedules,
                   log_grad_norm=bool(hp.get("log_grad_norm", True)),
                   moe_aux_weight=float(hp["moe_aux_weight"] or 0.0) if has_moe else 0.0,
                   forward=forward, param_regularizer=param_regularizer)
    mixup_a = float(hp.get("mixup_alpha") or 0.0)
    cutmix_a = float(hp.get("cutmix_alpha") or 0.0)
    mixing = (mixup_a > 0 or cutmix_a > 0) and not self_target
    jsd_cfg = dict(hp.get("augmix_jsd") or {})
    if mixing and jsd_cfg:
        raise ValueError("mixup/cutmix cannot combine with augmix_jsd: the JSD anchor must "
                         "be the clean batch (disable one)")
    if uda_cfg and (self_target or jsd_cfg or mixing):
        raise ValueError("uda cannot combine with self_supervised_target, augmix_jsd, or "
                         "mixup/cutmix — each redefines what the batch's anchor/labels mean "
                         "(disable the others)")
    jsd_weight = float(jsd_cfg.get("weight", 12.0)) if jsd_cfg else 0.0
    eval_with_ema = ema_decay is not None and bool(hp.get("ema_eval", True))

    out_dir = Path(hp["output_path"]) / (hp.get("run_dir") or _run_dir_name(backend))
    save_every = int(hp["save_every_iters"])
    ckpt = CheckpointManager(out_dir / "checkpoints", best_k=int(hp["keep_best_models"])) \
        if save_every > 0 else None
    eval_bs = max(1, min(int(hp["eval_batch_multiplier"]) * batch_size, len(validset)))

    def run_validation() -> Dict[str, float]:
        acc = MetricAccumulator()
        model.eval()
        vx = validset.dataset.images
        vy = validset.dataset.targets
        with torch.no_grad(), state.eval_weights(eval_with_ema or sf_eval):
            for lo in range(0, len(validset), eval_bs):
                x = validset.batch_transform(torch.from_numpy(
                    np.require(vx[lo:lo + eval_bs], requirements=("C", "W"))).to(device),
                    augment=False)
                y = _batch_target(x, dtype) if self_target else validset.transform_targets(
                    _device_targets(np.asarray(vy[lo:lo + eval_bs]), device))
                with _autocast(device, dtype):
                    logits = model(x)
                _, terms = losses(logits, y)
                out = dict(terms)
                for name, fn in eval_metrics.items():
                    out[name] = fn(logits.float(), y)
                acc.update(out, weight=len(y))
        model.train()
        return {f"valid_{k}": v for k, v in acc.compute().items()}

    history: Dict[str, Any] = {"train": [], "valid": [], "throughput_img_s": [],
                               "run_dir": str(out_dir)}
    crash_at = int(hp["crash_iteration"])
    log_every = max(1, int(hp["log_progress_every_iters"]))
    validate_every = max(1, int(hp["validate_every_epochs"]))
    train_acc = MetricAccumulator()
    t_start = time.perf_counter()
    paths = jax_param_paths(model) if hp.get("log_param_histograms") else {}

    def flush(at_step):
        vals = train_acc.compute()
        train_acc.reset()
        if vals:
            history["train"].append({"step": at_step, **vals})
            _logger.info("step %d  %s", at_step,
                         " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
            for lg in loggers:
                lg.log_metrics(vals, step=at_step)

    def one_step(raw: torch.Tensor, y_raw: torch.Tensor):
        if crash_at >= 0 and state.step == crash_at:
            raise CrashIteration(f"Injected crash at iteration {crash_at}")
        if _PREEMPTION.is_set():
            _PREEMPTION.clear()
            where = ""
            if ckpt is not None:
                where = f" (checkpoint {ckpt.save(state.step, state.checkpoint())})"
            raise Preempted(f"SIGTERM: training stopped at step {state.step}{where}")
        gen = step_generator(seed, state.step, device)
        x = trainset.batch_transform(raw, generator=gen)
        y = _batch_target(x, dtype) if self_target else trainset.transform_targets(y_raw)
        mix = None
        if mixing:
            x, *mix = mix_batch(x, gen, mixup_a, cutmix_a)
        views = jsd_views(raw, trainset, gen, jsd_cfg) if jsd_cfg else ()
        uda = (_augmix_view(raw, trainset, gen, uda_cfg), uda_cfg) if uda_cfg else None
        m = train_step(state, losses, metrics, x, y, mix=mix, views=views,
                       jsd_weight=jsd_weight, uda=uda, **step_kw)
        train_acc.update(m)
        if state.step % log_every == 0:
            flush(state.step)
        events.fire(TrainingEvents.ITERATION_COMPLETED, count=state.step, state=state,
                    metrics=m)
        if ckpt is not None and state.step % save_every == 0:
            ckpt.save(state.step, state.checkpoint())

    def epoch_batches(epoch: int, skip: int):
        if not resident:
            loader, batches = host_batches(iterator, trainset, epoch, skip, hp, seed)
            history["host_loader"] = loader
            depth = 2 if hp.get("prefetch_batches", True) else 1
            for raw, y in prefetch_to_device(batches, size=depth, device=device,
                                             wire_codec=_wire_codec(hp)):
                yield raw, _device_targets(y, device)
            return
        perm = epoch_permutation(seed, epoch, device_ds.n).to(device) \
            if sampling == "epoch" else None
        for i in range(skip, steps_per_epoch):
            if perm is None:
                yield device_ds.batch_for_step(_sample_generator(seed, state.step, device))
            else:
                yield device_ds.batch_at(perm, i)

    prev_sigterm = None
    on_main = threading.current_thread() is threading.main_thread()
    if hp["handle_preemption"] and on_main:
        prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: _PREEMPTION.set())
    model.train()
    with cudnn_deterministic(bool(hp["deterministic"])):
        try:
            epoch = state.step // steps_per_epoch
            while epoch < epochs:
                skip = state.step - epoch * steps_per_epoch
                t0 = time.perf_counter()
                step0 = state.step
                for raw, y in epoch_batches(epoch, skip):
                    one_step(raw, y)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                seen = (state.step - step0) * batch_size
                history["throughput_img_s"].append(seen / dt if dt > 0 else 0.0)
                epoch += 1
                val = {}
                if epoch % validate_every == 0:
                    val = run_validation()
                    history["valid"].append({"epoch": epoch, **val})
                    events.fire(TrainingEvents.VALIDATION_COMPLETED, count=epoch, state=state,
                                metrics=val)
                    for lg in loggers:
                        lg.log_metrics(val, step=state.step)
                    if paths:
                        for n, p in model.named_parameters():
                            for lg in loggers:
                                if hasattr(lg, "log_histogram"):
                                    lg.log_histogram(_histogram_name(paths[n]),
                                                     p.detach().float().cpu().numpy(),
                                                     state.step)
                    key = f"valid_{next(iter(metrics))}"
                    if ckpt is not None and key in val:
                        ckpt.update_best(state.step, val[key], state.checkpoint())
                _logger.info("epoch %d/%d  %.1f img/s  %s", epoch, epochs,
                             history["throughput_img_s"][-1],
                             " ".join(f"{k}={v:.4f}" for k, v in val.items()))
                events.fire(TrainingEvents.EPOCH_COMPLETED, count=epoch, state=state,
                            metrics=val, throughput=history["throughput_img_s"][-1])
            flush(state.step)
        finally:
            _PREEMPTION.clear()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            for lg in loggers:
                if hasattr(lg, "flush"):
                    lg.flush()
    history["total_time_s"] = time.perf_counter() - t_start
    history["steps"] = state.step
    history["output_path"] = str(out_dir)
    history["input_path"] = "resident" if resident else "streaming"
    events.fire(TrainingEvents.COMPLETED, count=1, state=state, history=history)
    return state, history


def train_with_retries(hp: Mapping[str, Any], model, losses, datasets, max_retries: int = 2,
                       **kwargs):
    """``train()`` that, on a crash, resumes from the latest checkpoint of
    the run directory this call pinned (``run_dir``) and goes on, up to
    ``max_retries`` times; needs ``save_every_iters`` > 0. ``Preempted`` is
    not retried, and a crash before the first periodic save re-raises the
    original error."""
    import uuid

    hp = dict(hp)
    if int(hp.get("save_every_iters", TRAINING_HP_DEFAULTS["save_every_iters"])) <= 0:
        raise ValueError("train_with_retries requires save_every_iters > 0")
    if not hp.get("run_dir"):
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        hp["run_dir"] = f"run_{stamp}_{os.getpid()}_{uuid.uuid4().hex[:6]}"
    ckpt_dir = (Path(hp.get("output_path", TRAINING_HP_DEFAULTS["output_path"]))
                / hp["run_dir"] / "checkpoints")
    for attempt in range(max_retries + 1):
        try:
            return train(hp, model, losses, datasets, **kwargs)
        except Preempted:
            raise
        except Exception as e:  # noqa: BLE001 — deliberate catch-all recovery
            latest = CheckpointManager(ckpt_dir).latest_step if (ckpt_dir / "steps").exists() \
                else None
            if attempt >= max_retries or latest is None:
                raise
            hp["resume_from"] = str(ckpt_dir)
            hp["crash_iteration"] = -1
            _logger.warning("training attempt %d failed (%s); resuming from %s at step %d",
                            attempt + 1, e, ckpt_dir, latest)
    raise AssertionError("unreachable")

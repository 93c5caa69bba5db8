"""The training procedure on one device.

Counterpart of ``deepcv_tpu/train/training.py`` (``train``,
``build_optimizer``, ``TRAINING_HP_DEFAULTS``, ``CrashIteration``,
``Preempted``), the subset that ``train_resnet50``-style runs use on one
card:

* the whole trainset lives on the device as uint8, its targets as the
  dataset keeps them (float ones, such as pose heatmaps, as float32;
  labels and masks as int64), as the JAX loop keeps the dataset's dtype;
  each epoch visits every
  sample once in the order of a permutation drawn from a generator keyed by
  (seed, epoch) alone, so a resumed run replays the same order;
* each step transforms its batch on the device (augmenting it from a
  generator keyed by (seed, step), so a resumed run augments the same
  way; validation batches are not augmented), runs the forward under
  ``torch.autocast`` when ``dtype`` is bfloat16 (parameters stay float32),
  computes the loss in float32, and applies one optimizer update;
* a model with V-MoE blocks (:class:`~deepcv_tpu_torch.ops.moe.MoEMlp`)
  adds ``moe_aux_weight`` times the mean of their load-balance losses to
  the objective and reports it as the step's ``moe_aux`` term; their router
  noise draws from the run's generator;
* ``deterministic: true`` sets cuDNN's ``deterministic`` and clears its
  ``benchmark`` (autotuning) for the run, restoring both after it, as the
  reference's ``setup_cudnn(deterministic, seed)`` did;
* ``self_supervised_target: input`` trains against the batch itself (an
  autoencoder's reconstruction): the target is the transformed batch, cast
  to ``dtype`` as the JAX loop casts it, in training and in validation;
* ``mixup_alpha`` and ``cutmix_alpha`` mix each transformed batch with a
  permutation of itself (when both are set, one Bernoulli(0.5) draw a batch
  picks CutMix or mixup), and the loss is ``lam * loss(y) + (1 - lam) *
  loss(y[perm])``, term by term; ``augmix_jsd: {weight, views, severity,
  width, depth, ops}`` adds ``weight`` times AugMix's JSD consistency
  between the batch's logits and those of ``views`` AugMix views of the raw
  batch (each through the trainset's transform list); the views leave the
  model's buffers (BatchNorm's running statistics) as the clean forward
  left them, as the JAX loop keeps only that forward's state. The two
  cannot combine, as in the JAX package;
* validation after every ``validate_every_epochs`` epochs, periodic and
  best-k checkpoints, exact resume, SIGTERM preemption and injected crashes;
  ``eval_metrics`` are computed in the validation pass only, after
  ``metrics`` (detection's mAP, a ranked greedy matching);
* ``history`` has the JAX package's keys, ``throughput_img_s`` one entry
  per epoch (images over the epoch's step time, validation excluded).

The optimizers are ``torch.optim``'s SGD (momentum, nesterov, weight decay
folded into the gradient), Adam and AdamW, whose updates equal the JAX
package's optax chains (``tests/test_torch_parity.py``). Every other hp key
of the JAX list raises an error naming it when it is set to anything but
its off value (:data:`UNPORTED_HP`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import signal
import threading
import time
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from deepcv_tpu_torch.data import augmentation as aug
from deepcv_tpu_torch.data.transforms import to_tensor, uniform
from deepcv_tpu_torch.hyperparams import to_hyperparameters
from deepcv_tpu_torch.ops.moe import MoEMlp
from deepcv_tpu_torch.ops.nn import Dropout
from deepcv_tpu_torch.train.checkpoint import CheckpointManager, resume_from_path
from deepcv_tpu_torch.train.losses import (WeightedLosses,
                                           jensen_shannon_divergence_consistency_loss)
from deepcv_tpu_torch.train.metrics import MetricAccumulator, accuracy
from deepcv_tpu_torch.train.schedules import build_schedules

__all__ = ["TRAINING_HP_DEFAULTS", "UNPORTED_HP", "TrainState", "train", "train_step",
           "build_optimizer", "apply_schedules", "epoch_permutation", "step_generator",
           "cudnn_deterministic", "mix_batch", "mixed_losses", "jsd_views",
           "CrashIteration", "Preempted", "request_preemption"]

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

#: hp keys the JAX package reads that this port does not carry yet, each
#: with its off value; any other value raises, naming the key.
#: ``device_resident_dataset: false`` (the streaming path) is refused too.
UNPORTED_HP: Dict[str, Any] = {
    "nni_compression": None,
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
    "ema_decay": None,
    "gradient_clip_norm": None,
    "freeze_params": None,
    "lr_scales": None,
    "uda": None,
    "backend_conf": None,
}

_PORTED_OPTIMIZERS = ("adamw", "adam", "sgd")


class CrashIteration(RuntimeError):
    """Injected fault at ``hp['crash_iteration']`` (tests of resume)."""


class Preempted(RuntimeError):
    """Training stopped on SIGTERM after checkpointing its state."""


_PREEMPTION = threading.Event()


def request_preemption() -> None:
    """Ask a running ``train()`` to checkpoint and stop at its next step
    boundary (what its SIGTERM handler does)."""
    _PREEMPTION.set()


@dataclasses.dataclass
class TrainState:
    """What ``train()`` trains: the model, its optimizer, the number of
    updates applied and the generator that feeds dropout, drop-path and the
    MoE router noise."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator

    def checkpoint(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load(self, ckpt: Mapping[str, Any]) -> None:
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.generator.set_state(ckpt["generator"])
        self.step = int(ckpt["step"])


# --------------------------------------------------------------------------- #
# Optimizer
# --------------------------------------------------------------------------- #

def build_optimizer(name: Union[str, Any], optimizer_opts: Mapping[str, Any],
                    params: Iterable[torch.nn.Parameter],
                    schedules: Optional[Mapping[str, Callable[[int], float]]] = None
                    ) -> torch.optim.Optimizer:
    """The optimizer for a torch-style spec (``optimizer: sgd``,
    ``optimizer_opts: {lr, momentum, weight_decay, nesterov}``; ``adamw`` /
    ``adam`` with ``betas``, ``eps``, ``weight_decay``). ``schedules`` (from
    :func:`build_schedules`) give the hyperparameters' values at step 0."""
    opts = dict(optimizer_opts)
    schedules = dict(schedules or {})
    name = str(getattr(name, "identifier", name)).rsplit(".", 1)[-1].lower()
    if name not in _PORTED_OPTIMIZERS:
        raise NotImplementedError(f"optimizer '{name}' is not ported yet "
                                  f"(ported: {', '.join(_PORTED_OPTIMIZERS)})")
    lr = float(opts.pop("lr", 1e-3))
    if name in ("adamw", "adam"):
        b1, b2 = opts.pop("betas", (0.9, 0.999))
        if opts.pop("amsgrad", False):
            _logger.warning("amsgrad is ignored, as in the JAX package")
        if name == "adam":
            opt = torch.optim.Adam(params, lr=lr, betas=(float(b1), float(b2)),
                                   eps=float(opts.pop("eps", 1e-8)))
        else:
            opt = torch.optim.AdamW(params, lr=lr, betas=(float(b1), float(b2)),
                                    eps=float(opts.pop("eps", 1e-8)),
                                    weight_decay=float(opts.pop("weight_decay", 1e-2)))
    else:
        mom = float(opts.pop("momentum", 0.0))
        if "momentum" in schedules:
            mom = max(mom, 1e-8)  # keep the momentum buffer, as optax's does
        opt = torch.optim.SGD(params, lr=lr, momentum=mom,
                              weight_decay=float(opts.pop("weight_decay", 0.0)),
                              nesterov=bool(opts.pop("nesterov", False)) and mom > 0)
    if "weight_decay" in schedules and name == "adam":
        raise ValueError("adam has no decoupled weight_decay to schedule — use "
                         "optimizer: adamw")
    apply_schedules(opt, schedules, 0)
    return opt


def apply_schedules(optimizer: torch.optim.Optimizer,
                    schedules: Mapping[str, Callable[[int], float]], step: int) -> None:
    """Write the scheduled hyperparameters for update number ``step`` into
    every parameter group (momentum is beta1 for the Adam family)."""
    for group in optimizer.param_groups:
        for key, sched in schedules.items():
            value = float(sched(step))
            if key == "momentum" and "betas" in group:
                group["betas"] = (value, group["betas"][1])
            else:
                group[key] = value


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


def jsd_views(raw: torch.Tensor, trainset, generator: torch.Generator,
              cfg: Mapping[str, Any]) -> List[torch.Tensor]:
    """The ``augmix_jsd`` views of a raw batch: ``to_tensor``, AugMix at the
    config's severity, width, depth and ops, then the trainset's transform
    list."""
    base = to_tensor(raw)
    out = []
    for _ in range(int(cfg.get("views", 2))):
        xa = aug.augment_and_mix(base, generator, severity=int(cfg.get("severity", 3)),
                                 width=int(cfg.get("width", 3)),
                                 depth=int(cfg.get("depth", -1)),
                                 ops=tuple(cfg["ops"]) if cfg.get("ops") else None)
        if trainset.transform is not None:
            xa = trainset.transform(xa, generator)
        out.append(xa)
    return out


def train_step(state: TrainState, losses: Callable, metrics: Mapping[str, Callable],
               x: torch.Tensor, y: torch.Tensor, *, dtype: Optional[torch.dtype] = None,
               schedules: Optional[Mapping[str, Callable[[int], float]]] = None,
               log_grad_norm: bool = True, moe_aux_weight: float = 0.0,
               mix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               views: Sequence[torch.Tensor] = (), jsd_weight: float = 0.0
               ) -> Dict[str, torch.Tensor]:
    """One update on a transformed batch ``x`` (NHWC float) with targets
    ``y``; returns the step's metrics as device scalars. With
    ``moe_aux_weight``, the mean load-balance loss of the model's MoE
    layers (their ``aux`` after this forward), times the weight, joins the
    objective as the JAX package's ``train()`` adds it. ``mix`` (perm, lam)
    mixes the loss (:func:`mixed_losses`); ``views`` add ``jsd_weight``
    times the JSD consistency of their logits with the batch's."""
    model, opt = state.model, state.optimizer
    apply_schedules(opt, schedules or {}, state.step)
    with _autocast(x.device, dtype):
        logits = model(x)
    main, terms = losses(logits, y) if mix is None else mixed_losses(losses, logits, y, *mix)
    if moe_aux_weight:
        aux = torch.stack([m.aux for m in model.modules() if isinstance(m, MoEMlp)]).mean()
        main = main + moe_aux_weight * aux
        terms = {**terms, "moe_aux": aux, WeightedLosses.MAIN: main}
    if views:
        kept = [b.detach().clone() for b in model.buffers()]
        with _autocast(x.device, dtype):
            view_logits = [model(xa) for xa in views]
        with torch.no_grad():
            for b, saved in zip(model.buffers(), kept):
                b.copy_(saved)
        consistency = jensen_shannon_divergence_consistency_loss(logits, *view_logits)
        main = main + jsd_weight * consistency
        terms = {**terms, "jsd_consistency": consistency, WeightedLosses.MAIN: main}
    opt.zero_grad(set_to_none=True)
    main.backward()
    out = {k: v.detach() for k, v in terms.items()}
    if log_grad_norm:
        out["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in model.parameters()
             if p.grad is not None]))
    opt.step()
    state.step += 1
    with torch.no_grad():
        for name, fn in metrics.items():
            out[name] = fn(logits.float(), y)
    return out


def _device_targets(targets: np.ndarray, device) -> torch.Tensor:
    """Targets on ``device``: float ones (pose heatmaps) as float32, integer
    ones (labels, masks) as int64. The JAX loop keeps the dataset's dtype and
    each loss casts what it needs."""
    t = torch.from_numpy(np.asarray(targets))
    return (t.float() if t.is_floating_point() else t.long()).to(device)


def _batch_target(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The target of a self-supervised batch: the transformed batch in the
    compute dtype (the JAX loop casts the batch before it takes it)."""
    return x if dtype is None else x.to(dtype)


def epoch_permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """The order of epoch ``epoch``: a permutation of ``n`` from a CPU
    generator keyed by (seed, epoch) alone."""
    key = ((int(seed) ^ 0x5EED) * 1_000_003 + int(epoch)) % (2 ** 63)
    return torch.randperm(n, generator=torch.Generator().manual_seed(key))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator that augments the batch of update ``step``: on
    ``device``, keyed by (seed, step) alone."""
    key = ((int(seed) ^ 0xA06) * 1_000_003 + int(step)) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(key)


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
                f"hp '{key}' = {value!r} is not ported yet (the port trains "
                f"with {key}: {off!r})")
    if hp["device_resident_dataset"] not in (True, "auto"):
        raise NotImplementedError(
            "hp 'device_resident_dataset' = false (the streaming input path) is "
            "not ported yet; the port keeps the dataset on the device")


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


# --------------------------------------------------------------------------- #
# The training procedure
# --------------------------------------------------------------------------- #

def train(hp: Mapping[str, Any], model: torch.nn.Module, losses, datasets: Mapping[str, Any],
          metrics: Optional[Mapping[str, Callable]] = None,
          loggers: Iterable[Any] = (),
          eval_metrics: Optional[Mapping[str, Callable]] = None
          ) -> Tuple[TrainState, Dict[str, Any]]:
    """Train ``model`` on ``datasets`` ({'trainset', 'validset'[, 'testset']}
    of :class:`~deepcv_tpu_torch.data.preprocess.PreprocessedDataset`) on the
    device its parameters live on; returns ``(state, history)``.
    ``eval_metrics`` join ``metrics`` in the validation pass only."""
    hp, _ = to_hyperparameters(dict(hp), TRAINING_HP_DEFAULTS)
    _refuse_unported(hp)
    self_target = _self_target(hp)
    device = next(model.parameters()).device
    if not isinstance(losses, WeightedLosses):
        losses = WeightedLosses(losses, weights=hp.get("losses_weights"))
    metrics = dict(metrics or {"accuracy": accuracy})
    eval_metrics = {**metrics, **dict(eval_metrics or {})}
    seed = int(hp["seed"])
    trainset = datasets["trainset"]
    validset = datasets.get("validset", datasets.get("testset", trainset))
    batch_size, epochs = int(hp["batch_size"]), int(hp["epochs"])
    n = len(trainset)
    if n < batch_size:
        raise ValueError(f"batch_size={batch_size} exceeds the trainset size {n}: "
                         "zero steps per epoch (reduce batch_size)")
    steps_per_epoch = n // batch_size
    images = torch.from_numpy(np.ascontiguousarray(trainset.dataset.images)).to(device)
    targets = _device_targets(trainset.dataset.targets, device)

    schedules = build_schedules(hp.get("scheduler"), hp.to_dict(), steps_per_epoch)
    optimizer = build_optimizer(hp["optimizer"], hp["optimizer_opts"],
                                model.parameters(), schedules)
    generator = torch.Generator(device=device).manual_seed(seed)
    has_moe = False
    for m in model.modules():
        if isinstance(m, (Dropout, MoEMlp)):
            m.generator = generator
        has_moe = has_moe or isinstance(m, MoEMlp)
    state = TrainState(model, optimizer, 0, generator)
    if hp["resume_from"]:
        state.load(resume_from_path(hp["resume_from"], map_location=device))
        _logger.info("Resumed from %s at step %d", hp["resume_from"], state.step)
    dtype = _resolve_dtype(hp.get("dtype")) or getattr(model, "dtype", None)
    step_kw = dict(dtype=dtype, schedules=schedules,
                   log_grad_norm=bool(hp.get("log_grad_norm", True)),
                   moe_aux_weight=float(hp["moe_aux_weight"] or 0.0) if has_moe else 0.0)
    mixup_a = float(hp.get("mixup_alpha") or 0.0)
    cutmix_a = float(hp.get("cutmix_alpha") or 0.0)
    mixing = (mixup_a > 0 or cutmix_a > 0) and not self_target
    jsd_cfg = dict(hp.get("augmix_jsd") or {})
    if mixing and jsd_cfg:
        raise ValueError("mixup/cutmix cannot combine with augmix_jsd: the JSD anchor must "
                         "be the clean batch (disable one)")
    jsd_weight = float(jsd_cfg.get("weight", 12.0)) if jsd_cfg else 0.0

    run_dir = hp.get("run_dir") or \
        f"run_{datetime.datetime.now().strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
    out_dir = Path(hp["output_path"]) / run_dir
    save_every = int(hp["save_every_iters"])
    ckpt = CheckpointManager(out_dir / "checkpoints", best_k=int(hp["keep_best_models"])) \
        if save_every > 0 else None
    eval_bs = max(1, min(int(hp["eval_batch_multiplier"]) * batch_size, len(validset)))

    def run_validation() -> Dict[str, float]:
        acc = MetricAccumulator()
        model.eval()
        vx = validset.dataset.images
        vy = np.asarray(validset.dataset.targets)
        with torch.no_grad():
            for lo in range(0, len(validset), eval_bs):
                x = validset.batch_transform(torch.from_numpy(
                    np.ascontiguousarray(vx[lo:lo + eval_bs])).to(device), augment=False)
                y = _batch_target(x, dtype) if self_target \
                    else _device_targets(vy[lo:lo + eval_bs], device)
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

    def flush(at_step):
        vals = train_acc.compute()
        train_acc.reset()
        if vals:
            history["train"].append({"step": at_step, **vals})
            _logger.info("step %d  %s", at_step,
                         " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
            for lg in loggers:
                lg.log_metrics(vals, step=at_step)

    prev_sigterm = None
    on_main = threading.current_thread() is threading.main_thread()
    if hp["handle_preemption"] and on_main:
        prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: _PREEMPTION.set())
    model.train()
    with cudnn_deterministic(bool(hp["deterministic"])):
        try:
            epoch = state.step // steps_per_epoch
            while epoch < epochs:
                perm = epoch_permutation(seed, epoch, n).to(device)
                skip = state.step - epoch * steps_per_epoch
                seen = 0
                t0 = time.perf_counter()
                for i in range(skip, steps_per_epoch):
                    if crash_at >= 0 and state.step == crash_at:
                        raise CrashIteration(f"Injected crash at iteration {crash_at}")
                    if _PREEMPTION.is_set():
                        _PREEMPTION.clear()
                        where = ""
                        if ckpt is not None:
                            where = f" (checkpoint {ckpt.save(state.step, state.checkpoint())})"
                        raise Preempted(f"SIGTERM: training stopped at step {state.step}{where}")
                    idx = perm[i * batch_size:(i + 1) * batch_size]
                    gen = step_generator(seed, state.step, device)
                    raw = images[idx]
                    x = trainset.batch_transform(raw, generator=gen)
                    y = _batch_target(x, dtype) if self_target else targets[idx]
                    mix = None
                    if mixing:
                        x, *mix = mix_batch(x, gen, mixup_a, cutmix_a)
                    views = jsd_views(raw, trainset, gen, jsd_cfg) if jsd_cfg else ()
                    m = train_step(state, losses, metrics, x, y, mix=mix, views=views,
                                   jsd_weight=jsd_weight, **step_kw)
                    train_acc.update(m)
                    seen += batch_size
                    if state.step % log_every == 0:
                        flush(state.step)
                    if ckpt is not None and state.step % save_every == 0:
                        ckpt.save(state.step, state.checkpoint())
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                history["throughput_img_s"].append(seen / dt if dt > 0 else 0.0)
                epoch += 1
                val = {}
                if epoch % validate_every == 0:
                    val = run_validation()
                    history["valid"].append({"epoch": epoch, **val})
                    for lg in loggers:
                        lg.log_metrics(val, step=state.step)
                    key = f"valid_{next(iter(metrics))}"
                    if ckpt is not None and key in val:
                        ckpt.update_best(state.step, val[key], state.checkpoint())
                _logger.info("epoch %d/%d  %.1f img/s  %s", epoch, epochs,
                             history["throughput_img_s"][-1],
                             " ".join(f"{k}={v:.4f}" for k, v in val.items()))
            flush(state.step)
        finally:
            _PREEMPTION.clear()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
    history["total_time_s"] = time.perf_counter() - t_start
    history["steps"] = state.step
    history["output_path"] = str(out_dir)
    return state, history

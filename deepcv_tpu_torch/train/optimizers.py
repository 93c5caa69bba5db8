"""The optimizers: the JAX package's ten names as ``torch.optim.Optimizer``\\ s.

Counterpart of ``build_optimizer`` and ``_scheduled_optimizer`` in
``deepcv_tpu/train/training.py``. ``sgd``, ``adam`` and ``adamw`` are
``torch.optim``'s, whose updates equal optax's chains; the other seven are
written here from optax's update rules, with the JAX package's option
names and defaults (``torch.optim``'s namesakes compute other formulas):

* ``rmsprop`` (``alpha``, ``eps``, ``momentum``): optax ``rmsprop``, the
  gradient times ``rsqrt(nu + eps)``, then ``-lr``, then a momentum trace;
* ``lamb`` (``betas``, ``eps`` 1e-6, ``weight_decay``): Adam's direction
  plus decayed weights, scaled per tensor by the trust ratio
  ``|p| / |u|`` (1 where either norm is 0), then ``-lr``;
* ``lars`` (``weight_decay``, ``momentum`` 0.9, ``trust_coefficient``
  0.001, ``nesterov``): decayed weights, the trust ratio times the
  coefficient, ``-lr``, then the momentum trace;
* ``adafactor`` (``min_dim_size_to_factor`` 128, ``decay_rate`` 0.8,
  ``weight_decay``, ``momentum``): second moments factored over the two
  largest dimensions when the second largest is at least 128, each
  tensor's update clipped to RMS 1, times ``lr``, times the parameter's RMS
  (at least 1e-3), plus ``weight_decay`` times the parameter (not scaled
  by ``lr``), negated;
* ``lion`` (``betas`` (0.9, 0.99), ``weight_decay``): the sign of the
  interpolated momentum plus decayed weights, then ``-lr``;
* ``muon`` (``beta`` 0.95, ``ns_steps`` 5, ``weight_decay``, ``nesterov``,
  ``adam_b1``, ``adam_b2``, ``adam_weight_decay``): a 2-d parameter takes
  Nesterov momentum orthogonalized by Newton-Schulz, scaled by
  ``sqrt(max(1, out / in))``; every other one takes AdamW (Nesterov), as
  optax partitions them;
* ``schedule_free_adamw`` (``betas``, ``weight_decay``, ``warmup_steps``):
  optax's schedule-free wrapper around an RMS-scaled AdamW step; the
  parameters hold the gradient point y, :meth:`ScheduleFreeAdamW.eval_params`
  the averaged iterate x that validation uses.

Each optimizer treats a parameter without a gradient as one with a zero
gradient, as optax updates every leaf. ``momentum`` and ``weight_decay``
may follow schedules for ``sgd``, ``adam`` (momentum only), ``adamw``,
``lamb`` and ``lion`` (momentum is beta1 for the last four).

A 2-d ``*.weight`` of the port is a torch ``(out, in)`` matrix, the
transpose of the JAX package's ``(in, out)`` kernel; any other 2-d
parameter keeps the JAX layout (the V-MoE router, the Swin bias table).
``muon`` reads ``out / in`` accordingly, from the names given with the
parameters.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["build_optimizer", "apply_schedules", "clip_by_global_norm", "OPTIMIZERS",
           "RMSprop", "Lamb", "Lars", "Adafactor", "Lion", "Muon", "ScheduleFreeAdamW"]

_logger = logging.getLogger(__name__)

Schedule = Callable[[int], float]


# --------------------------------------------------------------------------- #
# Shared pieces of the update rules
# --------------------------------------------------------------------------- #

def _moment(g: torch.Tensor, m: torch.Tensor, decay: float) -> torch.Tensor:
    """optax ``update_moment``: ``(1 - decay) * g + decay * m``."""
    return (1 - decay) * g + decay * m


def _trust_ratio(u: torch.Tensor, p: torch.Tensor, coefficient: float = 1.0,
                 eps: float = 0.0) -> torch.Tensor:
    """optax ``scale_by_trust_ratio``: ``u`` times ``coefficient * |p| /
    (|u| + eps)``, or ``u`` where either norm is 0."""
    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * p_norm / (u_norm + eps)
    return u * torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)


def _trace(u: torch.Tensor, state: Dict[str, Any], decay: float, nesterov: bool
           ) -> torch.Tensor:
    """optax ``trace``: ``t = u + decay * t``; the update is ``t``, or ``u +
    decay * t`` with Nesterov."""
    t = u + decay * state["trace"]
    state["trace"] = t
    return u + decay * t if nesterov else t


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


def _newton_schulz(x: torch.Tensor, steps: int, eps: float,
                   coeffs=(3.4445, -4.7750, 2.0315)) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` of a matrix: on its wide
    orientation, normalized by its Frobenius norm plus ``eps``, ``steps``
    iterations of ``a X + (b A + c A^2) X`` with ``A = X X^T``."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    a, b, c = coeffs
    for _ in range(int(steps)):
        gram = x @ x.T
        x = a * x + (b * gram + c * gram @ gram) @ x
    return x.T if transposed else x


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _apply(p: torch.Tensor, u: torch.Tensor) -> None:
    """optax ``apply_updates``."""
    p.add_(u.to(p.dtype))


class _OptaxRule(torch.optim.Optimizer):
    """An optax chain as a ``torch.optim.Optimizer``: ``step()`` computes
    each parameter's update with :meth:`_update` and adds it. The count of
    updates is kept in every parameter's state."""

    def _update(self, group: Dict[str, Any], p: torch.Tensor, g: torch.Tensor,
                state: Dict[str, Any], count: int) -> torch.Tensor:
        raise NotImplementedError

    def _init_state(self, group: Dict[str, Any], p: torch.Tensor) -> Dict[str, Any]:
        return {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state.update(self._init_state(group, p), count=0)
                state["count"] += 1
                _apply(p, self._update(group, p, _grad(p).float(), state, state["count"]))
        return loss


# --------------------------------------------------------------------------- #
# The seven optimizers written from optax's rules
# --------------------------------------------------------------------------- #

class RMSprop(_OptaxRule):
    """optax ``rmsprop(lr, decay, eps, momentum)``: ``nu = decay nu + (1 -
    decay) g^2``, ``u = -lr g rsqrt(nu + eps)``, then the momentum trace."""

    def __init__(self, params, lr: float = 1e-3, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    def _init_state(self, group, p):
        return {"nu": torch.zeros_like(p, dtype=torch.float32),
                "trace": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, group, p, g, state, count):
        state["nu"] = _moment(g * g, state["nu"], group["alpha"])
        u = -group["lr"] * (torch.rsqrt(state["nu"] + group["eps"]) * g)
        return _trace(u, state, group["momentum"], False)


class Lamb(_OptaxRule):
    """optax ``lamb``: Adam's bias-corrected direction ``m / (sqrt(v) +
    eps)``, plus ``weight_decay * p``, times the trust ratio, times
    ``-lr``."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, group, p):
        return {"mu": torch.zeros_like(p, dtype=torch.float32),
                "nu": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, group, p, g, state, count):
        b1, b2 = group["betas"]
        state["mu"] = _moment(g, state["mu"], b1)
        state["nu"] = _moment(g * g, state["nu"], b2)
        u = (state["mu"] / (1 - b1 ** count)) / \
            (torch.sqrt(state["nu"] / (1 - b2 ** count)) + group["eps"])
        u = u + group["weight_decay"] * p
        return -group["lr"] * _trust_ratio(u, p)


class Lars(_OptaxRule):
    """optax ``lars``: ``g + weight_decay * p``, times ``trust_coefficient *
    |p| / |u|``, times ``-lr``, then the momentum trace."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                                      trust_coefficient=trust_coefficient, nesterov=nesterov))

    def _init_state(self, group, p):
        return {"trace": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, group, p, g, state, count):
        u = _trust_ratio(g + group["weight_decay"] * p, p, group["trust_coefficient"])
        return _trace(-group["lr"] * u, state, group["momentum"], group["nesterov"])


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
    """optax's choice: the second largest and the largest dimension, when
    the second largest is at least ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(_OptaxRule):
    """optax ``adafactor`` (eps 1e-30, update clipping 1, parameter scale
    with a floor of 1e-3)."""

    def __init__(self, params, lr: float = 1e-3, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, weight_decay: Optional[float] = None,
                 momentum: Optional[float] = None, eps: float = 1e-30):
        super().__init__(params, dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                                      decay_rate=decay_rate, weight_decay=weight_decay,
                                      momentum=momentum, eps=eps))

    def _init_state(self, group, p):
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=p.device)  # noqa: E731
        state = {"v": zeros(*p.shape)} if dims is None else {
            "v_row": zeros(*np.delete(p.shape, dims[1])),
            "v_col": zeros(*np.delete(p.shape, dims[0]))}
        if group["momentum"] is not None:
            state["m"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def _update(self, group, p, g, state, count):
        decay = 1.0 - float(count) ** (-group["decay_rate"])
        g2 = g * g + group["eps"]
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is None:
            state["v"] = decay * state["v"] + (1.0 - decay) * g2
            u = g * state["v"] ** -0.5
        else:
            d1, d0 = dims
            state["v_row"] = decay * state["v_row"] + (1.0 - decay) * g2.mean(d0)
            state["v_col"] = decay * state["v_col"] + (1.0 - decay) * g2.mean(d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = state["v_row"].mean(reduced_d1, keepdim=True)
            u = g * (state["v_row"] / row_mean).pow(-0.5).unsqueeze(d0) \
                * state["v_col"].pow(-0.5).unsqueeze(d1)
        u = u / torch.clamp(_rms(u), min=1.0)
        u = group["lr"] * u
        p_rms = _rms(p.float())
        u = u * torch.where(p_rms <= 1e-3, torch.full_like(p_rms, 1e-3), p_rms)
        if group["momentum"] is not None:
            state["m"] = _moment(u, state["m"], group["momentum"])
            u = state["m"]
        if group["weight_decay"] is not None:
            u = u + group["weight_decay"] * p
        return -u


class Lion(_OptaxRule):
    """optax ``lion``: ``sign((1 - b1) g + b1 m)`` plus ``weight_decay *
    p``, times ``-lr``; then ``m = (1 - b2) g + b2 m``."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    def _init_state(self, group, p):
        return {"mu": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, group, p, g, state, count):
        b1, b2 = group["betas"]
        u = torch.sign((1.0 - b1) * g + b1 * state["mu"])
        state["mu"] = _moment(g, state["mu"], b2)
        return -group["lr"] * (u + group["weight_decay"] * p)


class Muon(_OptaxRule):
    """optax ``contrib.muon``: 2-d parameters on the orthogonalized Nesterov
    momentum, the others on AdamW with Nesterov momentum (eps 1e-8).
    ``torch_layout`` holds the 2-d parameters stored as torch ``(out, in)``
    matrices (default: every 2-d parameter)."""

    def __init__(self, params, lr: float = 0.02, beta: float = 0.95, ns_steps: int = 5,
                 weight_decay: float = 0.0, nesterov: bool = True, adam_b1: float = 0.9,
                 adam_b2: float = 0.999, adam_weight_decay: float = 0.0, eps: float = 1e-8,
                 torch_layout: Optional[Iterable[torch.Tensor]] = None):
        super().__init__(params, dict(lr=lr, beta=beta, ns_steps=ns_steps,
                                      weight_decay=weight_decay, nesterov=nesterov,
                                      adam_b1=adam_b1, adam_b2=adam_b2,
                                      adam_weight_decay=adam_weight_decay, eps=eps))
        self._jax_layout = set() if torch_layout is None else {
            id(p) for g in self.param_groups for p in g["params"]
            if p.dim() == 2 and not any(p is q for q in torch_layout)}

    def _init_state(self, group, p):
        state = {"mu": torch.zeros_like(p, dtype=torch.float32)}
        if p.dim() != 2:
            state["nu"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def _update(self, group, p, g, state, count):
        if p.dim() == 2:
            beta = group["beta"]
            state["mu"] = _moment(g, state["mu"], beta)
            if group["nesterov"]:
                mu_hat = beta * (state["mu"] / (1 - beta ** (count + 1))) \
                    + (1 - beta) * (g / (1 - beta ** count))
            else:
                mu_hat = state["mu"] / (1 - beta ** count)
            u = _newton_schulz(mu_hat, group["ns_steps"], group["eps"])
            rows, cols = p.shape
            factor = cols / rows if id(p) in self._jax_layout else rows / cols
            u = math.sqrt(max(1.0, factor)) * u
            return -group["lr"] * (u + group["weight_decay"] * p)
        b1, b2 = group["adam_b1"], group["adam_b2"]
        state["mu"] = _moment(g, state["mu"], b1)
        state["nu"] = _moment(g * g, state["nu"], b2)
        if group["nesterov"]:
            mu_hat = b1 * (state["mu"] / (1 - b1 ** (count + 1))) \
                + (1 - b1) * (g / (1 - b1 ** count))
        else:
            mu_hat = state["mu"] / (1 - b1 ** count)
        u = mu_hat / (torch.sqrt(state["nu"] / (1 - b2 ** count)) + group["eps"])
        return -group["lr"] * (u + group["adam_weight_decay"] * p)


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """optax ``contrib.schedule_free_adamw``: the parameters are the
    gradient point ``y``; ``z`` takes the base step ``-lr * (g / (sqrt(v_hat)
    + eps) + weight_decay * y)``; the average ``x`` moves to ``z`` by ``ck =
    max_lr^2 / sum of max_lr^2``, and ``y = b1 x + (1 - b1) z``. With
    ``warmup_steps`` the rate rises linearly from 0 (the wrapper reads it at
    its count, which starts at 1; the base step at its own, from 0)."""

    def __init__(self, params, lr: float = 0.0025, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, warmup_steps: Optional[int] = None,
                 weight_lr_power: float = 2.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, warmup_steps=warmup_steps,
                                      weight_lr_power=weight_lr_power, weight_sum=0.0,
                                      step_count=1, max_lr=0.0, inner_count=0))

    @staticmethod
    def _lr(group, count: int) -> float:
        warm = group["warmup_steps"]
        if not warm:
            return float(group["lr"])
        return float(group["lr"]) * min(max(float(count), 0.0), float(warm)) / warm

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            max_lr = max(group["max_lr"], self._lr(group, group["step_count"]))
            weight = max_lr ** group["weight_lr_power"]
            total = group["weight_sum"] + weight
            ck = weight / total if total > 0 else 0.0
            inner_lr = self._lr(group, group["inner_count"])
            group["inner_count"] += 1
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["z"] = p.detach().clone()
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                g = _grad(p).float()
                state["nu"] = _moment(g * g, state["nu"], b2)
                nu_hat = state["nu"] / (1 - b2 ** group["inner_count"])
                u = g / (torch.sqrt(nu_hat) + group["eps"]) + group["weight_decay"] * p
                z_old = state["z"]
                z = z_old + (-inner_lr) * u
                prev_x = (p - (1.0 - b1) * z_old) / b1
                x = (1.0 - ck) * prev_x + ck * z
                _apply(p, (b1 * x + (1.0 - b1) * z) - p)
                state["z"] = z
            group.update(max_lr=max_lr, weight_sum=total, step_count=group["step_count"] + 1)
        return loss

    @torch.no_grad()
    def eval_params(self) -> Dict[torch.Tensor, torch.Tensor]:
        """The averaged iterate ``x = (y - (1 - b1) z) / b1`` of every
        parameter that has taken a step (optax
        ``schedule_free_eval_params``)."""
        out = {}
        for group in self.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                if "z" in self.state[p]:
                    out[p] = (p - (1.0 - b1) * self.state[p]["z"]) / b1
        return out


# --------------------------------------------------------------------------- #
# Building an optimizer from the conf
# --------------------------------------------------------------------------- #

def _sgd(params, o):
    mom = float(o.pop("momentum", 0.0))
    if o.pop("_scheduled_momentum", False):
        mom = max(mom, 1e-8)  # keep the momentum buffer, as optax's does
    return torch.optim.SGD(params, lr=o.pop("lr"), momentum=mom,
                           weight_decay=float(o.pop("weight_decay", 0.0)),
                           nesterov=bool(o.pop("nesterov", False)) and mom > 0)


def _adam(params, o, decoupled: bool):
    b1, b2 = o.pop("betas", (0.9, 0.999))
    if o.pop("amsgrad", False):
        _logger.warning("amsgrad is ignored, as in the JAX package")
    kw = dict(lr=o.pop("lr"), betas=(float(b1), float(b2)), eps=float(o.pop("eps", 1e-8)))
    if decoupled:
        return torch.optim.AdamW(params, weight_decay=float(o.pop("weight_decay", 1e-2)), **kw)
    return torch.optim.Adam(params, **kw)


def _betas(o, default):
    return tuple(float(b) for b in o.pop("betas", default))


#: the JAX package's optimizer names -> constructor(params, opts)
OPTIMIZERS: Dict[str, Callable] = {
    "sgd": _sgd,
    "adam": lambda params, o: _adam(params, o, False),
    "adamw": lambda params, o: _adam(params, o, True),
    "rmsprop": lambda params, o: RMSprop(params, lr=o.pop("lr"),
                                         alpha=float(o.pop("alpha", 0.99)),
                                         eps=float(o.pop("eps", 1e-8)),
                                         momentum=float(o.pop("momentum", 0.0))),
    "lamb": lambda params, o: Lamb(params, lr=o.pop("lr"), betas=_betas(o, (0.9, 0.999)),
                                   eps=float(o.pop("eps", 1e-6)),
                                   weight_decay=float(o.pop("weight_decay", 0.0))),
    "lars": lambda params, o: Lars(params, lr=o.pop("lr"),
                                   weight_decay=float(o.pop("weight_decay", 0.0)),
                                   momentum=float(o.pop("momentum", 0.9)),
                                   trust_coefficient=float(o.pop("trust_coefficient", 0.001)),
                                   nesterov=bool(o.pop("nesterov", False))),
    "adafactor": lambda params, o: Adafactor(
        params, lr=o.pop("lr"), min_dim_size_to_factor=int(o.pop("min_dim_size_to_factor", 128)),
        decay_rate=float(o.pop("decay_rate", 0.8)),
        weight_decay=float(o.pop("weight_decay", 0.0)) or None,
        momentum=o.pop("momentum", None)),
    "lion": lambda params, o: Lion(params, lr=o.pop("lr"), betas=_betas(o, (0.9, 0.99)),
                                   weight_decay=float(o.pop("weight_decay", 0.0))),
    "muon": lambda params, o: Muon(
        params, lr=o.pop("lr"), beta=float(o.pop("beta", 0.95)),
        ns_steps=int(o.pop("ns_steps", 5)), weight_decay=float(o.get("weight_decay", 0.0)),
        nesterov=bool(o.pop("nesterov", True)), adam_b1=float(o.pop("adam_b1", 0.9)),
        adam_b2=float(o.pop("adam_b2", 0.999)),
        adam_weight_decay=float(o.pop("adam_weight_decay", o.pop("weight_decay", 0.0))),
        torch_layout=o.pop("_torch_layout", None)),
    "schedule_free_adamw": lambda params, o: ScheduleFreeAdamW(
        params, lr=o.pop("lr"), warmup_steps=int(o.pop("warmup_steps", 0)) or None,
        betas=_betas(o, (0.9, 0.999)), weight_decay=float(o.pop("weight_decay", 0.0))),
}
#: optimizers whose ``momentum`` (beta1) and ``weight_decay`` may follow a schedule
_SCHEDULED = ("adamw", "adam", "sgd", "lamb", "lion")


def _named(params) -> Tuple[list, Optional[list]]:
    """Parameters, and the 2-d ones in torch layout when names are given
    (``(name, parameter)`` pairs): those named ``*.weight``."""
    params = list(params)
    if params and isinstance(params[0], tuple):
        return [p for _, p in params], [p for n, p in params
                                        if p.dim() == 2 and n.endswith("weight")]
    return params, None


def build_optimizer(name: Union[str, Callable], optimizer_opts: Mapping[str, Any],
                    params: Iterable, schedules: Optional[Mapping[str, Schedule]] = None
                    ) -> torch.optim.Optimizer:
    """The optimizer a spec names (``optimizer: lamb``, ``optimizer_opts:
    {lr, betas, ...}``; the JAX package's ten names) over ``params``
    (parameters, or ``(name, parameter)`` pairs, whose names tell ``muon``
    the layout of a 2-d one). A callable instead of a name is a factory,
    called as ``factory(optimizer_opts, params, lr_schedule)``.
    ``schedules`` (from :func:`~deepcv_tpu_torch.train.schedules.build_schedules`)
    give the hyperparameters' values at step 0."""
    schedules = dict(schedules or {})
    extra = sorted(k for k in schedules if k != "lr")
    params, torch_layout = _named(params)
    if callable(name) and not isinstance(name, str):
        if extra:
            raise ValueError("momentum/weight_decay schedules cannot combine with a custom "
                             "optimizer factory")
        opt = name(dict(optimizer_opts), params, schedules.get("lr"))
        apply_schedules(opt, schedules, 0)
        return opt
    name = str(getattr(name, "identifier", name)).rsplit(".", 1)[-1].lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{name}' (known: {', '.join(OPTIMIZERS)}, "
                         "or pass a factory)")
    if extra and name not in _SCHEDULED:
        raise ValueError(f"momentum/weight_decay schedules are supported for "
                         f"{', '.join(_SCHEDULED)}, not '{name}' (drop the extra schedule "
                         "or switch optimizer)")
    if "weight_decay" in schedules and name == "adam":
        raise ValueError("adam has no decoupled weight_decay to schedule — use "
                         "optimizer: adamw")
    if name == "schedule_free_adamw" and "lr" in schedules:
        raise ValueError("schedule_free_adamw replaces the LR schedule: set scheduler: null "
                         "and pass a flat lr (and optionally optimizer_opts warmup_steps)")
    opts = dict(optimizer_opts)
    opts["lr"] = float(opts.get("lr", 1e-3))
    if name == "sgd" and "momentum" in schedules:
        opts["_scheduled_momentum"] = True
    if name == "muon":
        opts["_torch_layout"] = torch_layout
    opt = OPTIMIZERS[name](params, opts)
    apply_schedules(opt, schedules, 0)
    return opt


def apply_schedules(optimizer: torch.optim.Optimizer,
                    schedules: Mapping[str, Schedule], step: int) -> None:
    """Write the scheduled hyperparameters for update number ``step`` into
    every parameter group (momentum is beta1 where the group has betas)."""
    for group in optimizer.param_groups:
        for key, sched in schedules.items():
            value = float(sched(step))
            if key == "momentum" and "betas" in group:
                group["betas"] = (value, group["betas"][1])
            else:
                group[key] = value


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: when the global norm of
    ``grads`` is at least ``max_norm``, each becomes ``g / norm *
    max_norm``; below it they stay as they are. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm))
    return norm

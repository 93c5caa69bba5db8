"""Schedules of optimizer hyperparameters, as functions of the step.

Counterpart of ``deepcv_tpu/train/schedules.py``: ``piecewise_linear``,
``one_cycle``, ``safe_eval_milestones``, ``build_schedules`` (no
scheduler gives no schedule) and the types ``constant``, ``cosine``,
``warmup_cosine`` and ``exponential`` with optax's formulas
(``constant_schedule``, ``cosine_decay_schedule``,
``warmup_cosine_decay_schedule``, whose ``decay_steps`` count the warmup,
and ``exponential_decay``). A schedule is a plain function of the number
of updates already applied, returning the value for the next one; the
training loop writes it into the optimizer's parameter groups before each
step, as optax reads its schedules.
"""
from __future__ import annotations

import ast
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["piecewise_linear", "one_cycle", "constant", "cosine_decay", "linear",
           "warmup_cosine_decay", "exponential_decay", "safe_eval_milestones",
           "build_schedules", "build_schedule", "SCHEDULES", "SCHEDULABLE"]

Schedule = Callable[[int], float]


def piecewise_linear(milestones_values: Sequence[Sequence[float]],
                     param_name: str = "lr") -> Schedule:
    """Linear interpolation through ``[(step, value), ...]``; constant
    outside the range (ignite ``PiecewiseLinear``)."""
    pts = sorted((int(s), float(v)) for s, v in milestones_values)
    steps = np.asarray([p[0] for p in pts], np.float32)
    vals = np.asarray([p[1] for p in pts], np.float32)

    def schedule(count: int) -> float:
        return float(np.interp(np.float32(count), steps, vals))

    return schedule


def one_cycle(max_lr: float, total_steps: int, base_lr: Optional[float] = None,
              final_lr: Optional[float] = None, pct_start: float = 0.3,
              base_momentum: float = 0.85, max_momentum: float = 0.95,
              anneal_strategy: str = "cos") -> Tuple[Schedule, Schedule]:
    """One-cycle policy (arXiv:1803.09820): ``(lr, momentum)`` schedules,
    momentum cycling inversely to the learning rate."""
    base_lr = base_lr if base_lr is not None else max_lr / 25.0
    final_lr = final_lr if final_lr is not None else base_lr / 1e4
    up = max(1, int(pct_start * total_steps))
    down = max(1, total_steps - up)

    def interp(t, a, b):
        if anneal_strategy == "cos":
            return b + (a - b) * 0.5 * (1.0 + math.cos(math.pi * t))
        return a + (b - a) * t

    def phase(count):
        c = float(count)
        return c <= up, min(max(c / up, 0.0), 1.0), min(max((c - up) / down, 0.0), 1.0)

    def lr_schedule(count: int) -> float:
        rising, t_up, t_down = phase(count)
        return interp(t_up, base_lr, max_lr) if rising else interp(t_down, max_lr, final_lr)

    def momentum_schedule(count: int) -> float:
        rising, t_up, t_down = phase(count)
        return (interp(t_up, max_momentum, base_momentum) if rising
                else interp(t_down, base_momentum, max_momentum))

    return lr_schedule, momentum_schedule


def constant(value: float = 1e-3, **_) -> Schedule:
    """``value`` at every step (optax ``constant_schedule``)."""
    return lambda count: float(value)


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        return float(init_value) * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                                    + alpha)

    return schedule


def linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax ``linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps``, then constant (constant ``init_value`` when
    ``transition_steps`` <= 0)."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count: int) -> float:
        frac = 1 - min(max(float(count), 0.0), float(transition_steps)) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay over
    ``decay_steps - warmup_steps`` (the warmup counts in ``decay_steps``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear(init_value, peak_value, warmup_steps)
    decay = cosine_decay(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    """optax ``exponential_decay``: ``init_value * decay_rate ** (count /
    transition_steps)`` (constant for transition_steps <= 0 or a zero
    rate)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(init_value)
    return lambda count: float(init_value) if count <= 0 else \
        float(init_value) * float(decay_rate) ** (count / transition_steps)


_ALLOWED_NODES = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.List,
                  ast.Tuple, ast.Subscript, ast.Name, ast.Load, ast.Call,
                  ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
                  ast.Pow, ast.USub, ast.UAdd)
_ALLOWED_CALLS = {"int": int, "float": float, "round": round, "min": min,
                  "max": max, "len": len}
_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
           ast.FloorDiv: lambda a, b: a // b, ast.Mod: lambda a, b: a % b,
           ast.Pow: lambda a, b: a ** b}


def safe_eval_milestones(expr: str, env: Mapping[str, Any]) -> Any:
    """Evaluate a milestone string such as ``"[[0, 0.0], [int(0.2 *
    hp['epochs'] * iterations), hp['optimizer_opts']['lr']]]"``: arithmetic,
    indexing and int/float/round/min/max/len only, names from ``env``."""
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f"Disallowed expression element {type(node).__name__} "
                             f"in milestone string: {expr!r}")
        if isinstance(node, ast.Call) and not (
                isinstance(node.func, ast.Name) and node.func.id in _ALLOWED_CALLS):
            raise ValueError(f"Only {sorted(_ALLOWED_CALLS)} callable in milestone "
                             f"strings, got: {ast.dump(node.func)}")

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, (ast.List, ast.Tuple)):
            return [ev(e) for e in node.elts]
        if isinstance(node, ast.Name):
            if node.id not in env:
                raise ValueError(f"Unknown name '{node.id}' in milestone string")
            return env[node.id]
        if isinstance(node, ast.Subscript):
            return ev(node.value)[ev(node.slice)]
        if isinstance(node, ast.Call):
            return _ALLOWED_CALLS[node.func.id](*[ev(a) for a in node.args])
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            return -v if isinstance(node.op, ast.USub) else +v
        if isinstance(node, ast.BinOp):
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        raise AssertionError(node)

    return ev(tree)


SCHEDULES: Dict[str, Callable] = {
    "piecewise_linear": piecewise_linear,
    "one_cycle": one_cycle,
    "constant": constant,
    "cosine": lambda init_value, decay_steps, alpha=0.0, **_:
        cosine_decay(float(init_value), int(decay_steps), float(alpha)),
    "warmup_cosine": lambda peak_value, warmup_steps, decay_steps, init_value=0.0, **_:
        warmup_cosine_decay(float(init_value), float(peak_value), int(warmup_steps),
                            int(decay_steps)),
    "exponential": lambda init_value, transition_steps, decay_rate, **_:
        exponential_decay(float(init_value), int(transition_steps), float(decay_rate)),
}
#: optimizer hyperparameters that may carry their own schedule
SCHEDULABLE = ("lr", "momentum", "weight_decay")


def _build_one(spec: Mapping[str, Any], hp: Mapping[str, Any], iterations_per_epoch: int):
    spec = dict(spec)
    t = spec.get("type")
    name = str(getattr(t, "identifier", t)).rsplit(".", 1)[-1]
    name = {"PiecewiseLinear": "piecewise_linear", "OneCyclePolicy": "one_cycle"}.get(name, name)
    if name not in SCHEDULES:
        raise ValueError(f"Unknown scheduler '{name}'; known: {sorted(SCHEDULES)}")
    kwargs = dict(spec.get("kwargs", {}))
    kwargs.pop("param_name", None)
    env = {"hp": dict(hp), "iterations": int(iterations_per_epoch)}
    for arg in spec.get("eval_args", []):
        if isinstance(kwargs.get(arg), str):
            kwargs[arg] = safe_eval_milestones(kwargs[arg], env)
    if name == "one_cycle":
        opts = env["hp"].get("optimizer_opts") or {}
        if "max_lr" not in kwargs and "lr" in opts:
            kwargs["max_lr"] = float(opts["lr"])
        if "total_steps" not in kwargs and env["hp"].get("epochs"):
            kwargs["total_steps"] = int(env["hp"]["epochs"]) * int(iterations_per_epoch)
    return SCHEDULES[name](**kwargs)


def build_schedules(spec: Optional[Mapping[str, Any]], hp: Mapping[str, Any],
                    iterations_per_epoch: int) -> Dict[str, Schedule]:
    """Every schedule a scheduler spec declares: ``{}`` for none, ``{'lr':
    ...}`` for a single ``{type: ..., kwargs: ..., eval_args: ...}`` spec
    (``one_cycle`` also gives ``'momentum'``), or one schedule per key of a
    ``{lr: <spec>, momentum: <spec>, weight_decay: <spec>}`` mapping."""
    if not spec:
        return {}
    if isinstance(spec, str):
        spec = {"type": spec}
    if "type" in spec:
        out = _build_one(spec, hp, iterations_per_epoch)
        return {"lr": out[0], "momentum": out[1]} if isinstance(out, tuple) else {"lr": out}
    unknown = set(spec) - set(SCHEDULABLE)
    if unknown:
        raise ValueError(f"Unknown scheduler targets {sorted(unknown)}; "
                         f"schedulable: {SCHEDULABLE} (or pass a single 'type: ...' spec)")
    built: Dict[str, Schedule] = {}
    for target, sub in spec.items():
        out = _build_one(sub, hp, iterations_per_epoch)
        if isinstance(out, tuple):
            built[target] = out[0] if target != "momentum" else out[1]
            if target == "lr":
                built.setdefault("momentum", out[1])
        else:
            built[target] = out
    return built


def build_schedule(spec: Optional[Mapping[str, Any]], hp: Mapping[str, Any],
                   iterations_per_epoch: int) -> Optional[Schedule]:
    """The learning-rate schedule alone of :func:`build_schedules`."""
    return build_schedules(spec, hp, iterations_per_epoch).get("lr")

"""Neural-architecture search over the spec's choice points.

Counterpart of ``deepcv_tpu/search/nas.py``:

* classic NAS: :func:`gen_classic_nas_search_space` enumerates the spec's
  mutables (:func:`list_mutables`), :func:`sample_architecture` draws one
  fixed architecture per trial (the JAX package's numpy draws), and
  :func:`apply_fixed_architecture` builds it;
* single-shot NAS (:func:`single_shot_neural_architecture_search`): train a
  weight-sharing supernet (``DeepcvModule(nas_mode='supernet')``) once, then
  export an architecture: ``darts`` (softmax mixture, argmax of the trained
  logits), ``spos`` (uniform paths, then the best candidate on validation
  with the shared weights, :func:`_select_arch_by_validation`),
  ``proxylessnas`` (binary gates plus the expected-cost objective of
  :func:`expected_cost_regularizer` over :func:`candidate_costs`) and
  ``enas`` (:func:`enas_neural_architecture_search`: REINFORCE on the
  validation reward, with a factored policy over the ``arch__*`` logits or
  the recurrent :class:`LstmController`).

Exported architectures are JSON dicts ``{mutable: index}`` (nested mutables
``'<nested>/<local>'``), interchangeable with the JAX package's.
:func:`arch_params_mask` is a predicate on parameter names, and
:func:`expected_cost_regularizer` takes the model's named parameters, which
is what the port's ``train(param_regularizer=...)`` passes.

The models are built on the card unless ``device`` (a model keyword) says
otherwise.
"""
from __future__ import annotations

import itertools
import json
import logging
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from deepcv_tpu_torch.spec.graph import ARCH_PARAM_PREFIX
from deepcv_tpu_torch.spec.tokens import YamlTokens as T

__all__ = ["list_mutables", "sample_architecture", "export_architecture",
           "apply_fixed_architecture", "arch_params_mask",
           "gen_classic_nas_search_space", "candidate_costs",
           "enas_neural_architecture_search", "LstmController",
           "expected_cost_regularizer",
           "single_shot_neural_architecture_search"]

_logger = logging.getLogger(__name__)


def list_mutables(hp: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The NAS choice points of an architecture spec, nested modules
    included: {name: {'kind': 'layer'|'input', 'n_candidates': k,
    'n_chosen': m}}."""
    out: Dict[str, Dict[str, Any]] = {}

    def walk(arch, prefix=""):
        for idx, entry in enumerate(arch or []):
            if not isinstance(entry, Mapping):
                continue
            for key, val in entry.items():
                if key == T.NAS_LAYER_CHOICE:
                    params = dict(val)
                    name = params.get(T.NAME, f"_submodule_{idx}_layer_choice")
                    out[prefix + name] = {"kind": "layer",
                                          "n_candidates": len(params.get(T.CANDIDATES, [])),
                                          "n_chosen": 1}
                elif key in (T.NESTED_DEEPCV_MODULE, T.NESTED_DEEPCV_MODULE_ALT):
                    sub = val.get("architecture") if isinstance(val, Mapping) else val
                    nested_name = (val.get(T.NAME) if isinstance(val, Mapping)
                                   else None) or f"_submodule_{idx}_nested"
                    walk(sub, prefix=f"{prefix}{nested_name}/")
                elif isinstance(val, Mapping) and T.FROM_NAS_INPUT_CHOICE in val:
                    name = val.get(T.NAME) or f"_submodule_{idx}_{str(key).lstrip('_')}"
                    out[prefix + name] = {"kind": "input",
                                          "n_candidates": len(val[T.FROM_NAS_INPUT_CHOICE]),
                                          "n_chosen": int(val.get(T.N_CHOSEN, 1))}
                elif isinstance(val, (list, tuple)) and len(val) == 2 \
                        and isinstance(val[1], Mapping) and T.FROM_NAS_INPUT_CHOICE in val[1]:
                    out[prefix + val[0]] = {
                        "kind": "input",
                        "n_candidates": len(val[1][T.FROM_NAS_INPUT_CHOICE]),
                        "n_chosen": int(val[1].get(T.N_CHOSEN, 1))}
    walk(hp.get("architecture"))
    return out


def gen_classic_nas_search_space(hp: Mapping[str, Any]) -> Dict[str, Any]:
    """The NNI classic-NAS search-space JSON of the spec's mutables."""
    return {name: {"_type": "layer_choice" if m["kind"] == "layer" else "input_choice",
                   "_value": list(range(m["n_candidates"]))}
            for name, m in list_mutables(hp).items()}


def sample_architecture(hp: Mapping[str, Any], rng=None,
                        seed: Optional[int] = None) -> Dict[str, Any]:
    """One fixed architecture drawn from a numpy Generator (a classic-NAS
    trial): a candidate index per layer choice, ``n_chosen`` sorted indices
    per input choice."""
    rng = rng if rng is not None else np.random.default_rng(seed or 0)
    arch = {}
    for name, m in list_mutables(hp).items():
        if m["kind"] == "layer":
            arch[name] = int(rng.integers(m["n_candidates"]))
        else:
            k = min(m["n_chosen"], m["n_candidates"])
            arch[name] = sorted(int(i) for i in
                                rng.choice(m["n_candidates"], size=k, replace=False))
    return arch


def _arch_param_name(mutable: str) -> str:
    """The parameter name of mutable ``mutable``'s logits in a supernet
    ``DeepcvModule`` (``module.arch__m``, ``module.nodes.<nested>.arch__m``)."""
    *nested, local = mutable.split("/")
    return "module." + "".join(f"nodes.{n}." for n in nested) + ARCH_PARAM_PREFIX + local


def _mutable_of(param_name: str) -> Optional[str]:
    """The inverse of :func:`_arch_param_name` (None for another parameter)."""
    parts = param_name.split(".")
    if not parts[-1].startswith(ARCH_PARAM_PREFIX):
        return None
    nested = [parts[i + 1] for i in range(1, len(parts) - 1, 2) if parts[i] == "nodes"]
    return "/".join([*nested, parts[-1][len(ARCH_PARAM_PREFIX):]])


def _named_arch_logits(model_or_params) -> Dict[str, torch.Tensor]:
    items = model_or_params.named_parameters() if isinstance(model_or_params, nn.Module) \
        else model_or_params.items()
    return {m: p for n, p in items if (m := _mutable_of(n)) is not None}


def export_architecture(model_or_params) -> Dict[str, Any]:
    """The argmax architecture of a trained supernet (a ``DeepcvModule`` or
    its ``state_dict``/named parameters): {mutable: index}."""
    return {name: int(np.argmax(p.detach().float().cpu().numpy()))
            for name, p in _named_arch_logits(model_or_params).items()}


def apply_fixed_architecture(input_shape, hp: Mapping[str, Any],
                             architecture: Union[str, Path, Mapping[str, Any]],
                             **model_kwargs):
    """A fixed ``DeepcvModule`` of an exported architecture (a JSON file or a
    dict)."""
    from deepcv_tpu_torch.spec import DeepcvModule

    if isinstance(architecture, (str, Path)):
        architecture = json.loads(Path(architecture).read_text())
    return DeepcvModule(input_shape, hp, nas_mode="fixed", nas_arch=dict(architecture),
                        **model_kwargs)


def fixed_state_dict(supernet, architecture: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state_dict of ``architecture``'s fixed model on a supernet's
    weights (a ``DeepcvModule`` or its ``state_dict``): each layer choice's
    chosen candidate under its mutable's name, the other candidates and the
    ``arch__*`` logits left out."""
    state = supernet.state_dict() if isinstance(supernet, nn.Module) else supernet
    chosen = {}
    for name, c in architecture.items():
        *outer, local = name.split("/")
        prefix = "module." + "".join(f"nodes.{p}." for p in outer) + f"nodes.{local}"
        chosen[prefix + "_cand"] = (prefix + ".", int(c[0] if isinstance(c, (list, tuple))
                                                      else c))
    out = {}
    for k, v in state.items():
        if arch_params_mask(k):
            continue
        for cand, (fixed, i) in chosen.items():
            if k.startswith(cand):
                idx, rest = k[len(cand):].split(".", 1)
                k = fixed + rest if int(idx) == i else None
                break
        if k is not None:
            out[k] = v
    return out


def arch_params_mask(params, invert: bool = False):
    """Whether a parameter is an architecture logit (``arch__*``): for one
    parameter name, a bool; for a mapping or a model's named parameters,
    {name: bool}. ``invert`` flips it."""
    if isinstance(params, str):
        return (ARCH_PARAM_PREFIX in params.rsplit(".", 1)[-1]) != invert
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {n: arch_params_mask(n, invert) for n, _ in items}


def _candidate_cost(candidate: nn.Module, out_shape) -> float:
    """A candidate's compute estimate: its parameters times its output's
    spatial positions (MACs for a conv), its parameters for a dense."""
    n_params = sum(p.numel() for p in candidate.parameters())
    spatial = int(np.prod(out_shape[2:])) if len(out_shape) > 2 else 1
    return float(n_params * spatial)


def candidate_costs(supernet) -> Dict[str, List[float]]:
    """Each layer-choice mutable's candidate costs, nested ones included
    ('<nested>/<local>'): the ProxylessNAS latency table (arXiv:1812.00332
    §3.2) as an analytic MAC estimate. The shapes are those the spec engine
    inferred on the meta device at build; input choices carry no compute.
    The JAX package pads a conv's input to 8 channels on the TPU and counts
    the padded kernel rows, so a candidate on fewer input channels costs
    more there."""
    costs: Dict[str, List[float]] = {}
    for prefix, spec in supernet.spec_modules().items():
        for meta in spec.node_metas:
            if meta.kind == "choice":
                out_shape = spec.node_shapes[meta.name]
                costs[prefix + meta.name] = [
                    _candidate_cost(spec.nodes[f"{meta.name}_cand{i}"], out_shape)
                    for i in range(meta.n_candidates)]
    return costs


def expected_cost_regularizer(costs: Mapping[str, Sequence[float]], weight: float = 0.1):
    """The differentiable expected architecture cost
    ``weight * sum_m <softmax(logits_m), costs_m> / sum_m max(costs_m)``
    (ProxylessNAS eq. 7) as a function of the model's named parameters, for
    ``train(param_regularizer=...)``."""
    total = sum(max(c) for c in costs.values()) or 1.0
    tables = {n: torch.tensor(c, dtype=torch.float32) for n, c in costs.items()}

    def reg(named_params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        e = 0.0
        for name, cs in tables.items():
            logits = named_params[_arch_param_name(name)]
            e = e + torch.dot(torch.softmax(logits, 0), cs.to(logits.device))
        return weight * e / total

    return reg


def _adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any],
               lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One step of optax's ``adam`` in place, with its operations in its
    order and its float32 bias corrections."""
    state["count"] += 1
    t = state["count"]
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            state["mu"][i] = (1 - b1) * g + b1 * state["mu"][i]
            state["nu"][i] = (1 - b2) * (g * g) + b2 * state["nu"][i]
            u = (state["mu"][i] / bc1) / (torch.sqrt(state["nu"][i] / bc2) + eps)
            p.copy_(p + -lr * u)


class LstmController:
    """ENAS's recurrent controller (arXiv:1802.03268 §2): an LSTM samples the
    decisions one after another, each conditioned on the earlier ones
    through its state. Per step t: h_t = LSTM(embed(choice_{t-1}), h_{t-1});
    logits_t = W_t h_t + b_t. Trained by REINFORCE (advantage-weighted
    log-probability plus an entropy bonus) with optax's Adam. The initial
    parameters come from ``np.random.default_rng(seed)`` in the JAX
    package's order; it runs on the CPU."""

    def __init__(self, sizes: Sequence[int], seed: int = 0,
                 embed_dim: int = 16, hidden_dim: int = 32, lr: float = 0.05,
                 entropy_weight: float = 1e-2):
        self.sizes = [int(s) for s in sizes]
        self.H = hidden_dim
        rng = np.random.default_rng(seed)

        def init(*shape, scale=0.1):
            return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32)

        self.params = {
            "x0": init(embed_dim),
            "wx": init(embed_dim, 4 * hidden_dim),
            "wh": init(hidden_dim, 4 * hidden_dim),
            "b": torch.zeros(4 * hidden_dim),
            "head": [init(hidden_dim, n) for n in self.sizes],
            "head_b": [torch.zeros(n) for n in self.sizes],
            "emb": [init(n, embed_dim) for n in self.sizes],
        }
        self._lr = float(lr)
        self._w_ent = float(entropy_weight)
        flat = self._flat()
        self._opt = {"count": 0, "mu": [torch.zeros_like(p) for p in flat],
                     "nu": [torch.zeros_like(p) for p in flat]}

    def _flat(self) -> List[torch.Tensor]:
        p = self.params
        return [p["x0"], p["wx"], p["wh"], p["b"], *p["head"], *p["head_b"], *p["emb"]]

    def _cell(self, p, x, h, c):
        z = x @ p["wx"] + h @ p["wh"] + p["b"]
        i, f, g, o = torch.split(z, self.H)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def _step_logits(self, p, t: int, x, h, c):
        h, c = self._cell(p, x, h, c)
        return h @ p["head"][t] + p["head_b"][t], h, c

    def _logprob_entropy(self, p, choices: Sequence[int]):
        """log pi(arch) and the policy's entropy along the sampled path."""
        h = torch.zeros(self.H)
        c = torch.zeros(self.H)
        x = p["x0"]
        lp = torch.zeros(())
        ent = torch.zeros(())
        for t in range(len(self.sizes)):
            logits, h, c = self._step_logits(p, t, x, h, c)
            logq = torch.log_softmax(logits, 0)
            lp = lp + logq[int(choices[t])]
            ent = ent - torch.sum(torch.exp(logq) * logq)
            x = p["emb"][t][int(choices[t])]
        return lp, ent

    def _decode(self, pick) -> List[int]:
        p = self.params
        h = torch.zeros(self.H)
        c = torch.zeros(self.H)
        x = p["x0"]
        out = []
        with torch.no_grad():
            for t in range(len(self.sizes)):
                logits, h, c = self._step_logits(p, t, x, h, c)
                ch = int(pick(t, logits.numpy().astype(np.float64)))
                out.append(ch)
                x = p["emb"][t][ch]
        return out

    def sample(self, rng: np.random.Generator) -> List[int]:
        def pick(t, logits):
            e = np.exp(logits - logits.max())
            return rng.choice(self.sizes[t], p=e / e.sum())
        return self._decode(pick)

    def greedy(self) -> List[int]:
        return self._decode(lambda t, logits: int(np.argmax(logits)))

    def marginals(self, rng: np.random.Generator, k: int = 64) -> List[np.ndarray]:
        """Each step's empirical marginal over ``k`` policy samples."""
        counts = [np.full(n, 1e-3) for n in self.sizes]
        for _ in range(k):
            for t, ch in enumerate(self.sample(rng)):
                counts[t][ch] += 1.0
        return [c / c.sum() for c in counts]

    def entropy(self) -> float:
        with torch.no_grad():
            return float(self._logprob_entropy(self.params, self.greedy())[1])

    def update(self, arch_rows: Sequence[Sequence[int]], advantages: Sequence[float]) -> None:
        """One REINFORCE step: Adam on
        -(mean(adv * log pi) + entropy_weight * mean(entropy))."""
        flat = self._flat()
        for q in flat:
            q.requires_grad_(True)
        lps, ents = zip(*(self._logprob_entropy(self.params, row) for row in arch_rows))
        adv = torch.tensor(list(advantages), dtype=torch.float32)
        loss = -(torch.mean(adv * torch.stack(lps)) + self._w_ent * torch.mean(torch.stack(ents)))
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(q) if g is None else g for q, g in zip(flat, grads)]
        for q in flat:
            q.requires_grad_(False)
        _adam_step(flat, grads, self._opt, self._lr)


def _validation_batch(datasets: Mapping[str, Any], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first (up to) 512 validation images, transformed without
    augmentation, and their targets, on ``device``."""
    from deepcv_tpu_torch.train.training import _device_targets

    validset = datasets.get("validset", datasets["trainset"])
    inner = getattr(validset, "dataset", validset)
    n = min(len(inner), 512)
    x = torch.from_numpy(np.ascontiguousarray(inner.images[:n])).to(device)
    y = _device_targets(np.asarray(inner.targets[:n]), device)
    tf = getattr(validset, "batch_transform", None)
    return (tf(x, augment=False) if tf is not None else x), y


def _forced_logits(supernet, arch: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The supernet's eval-mode output with ``arch`` forced on its weights."""
    was = supernet.training
    supernet.eval()
    try:
        with torch.no_grad():
            return supernet.with_forced_arch(arch)(x)
    finally:
        supernet.train(was)


def _set_logits(logits: torch.Tensor, value) -> None:
    with torch.no_grad():
        logits.copy_(torch.as_tensor(np.asarray(value), dtype=logits.dtype))


def _write_arch(arch: Mapping[str, Any], path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(arch, indent=1))


def enas_neural_architecture_search(
        input_shape, model_hp: Mapping[str, Any], training_hp: Mapping[str, Any],
        losses, datasets, backend_conf=None, metrics=None,
        arch_export_path: Optional[Union[str, Path]] = None,
        controller_lr: float = 0.2, controller_samples: int = 8,
        entropy_weight: float = 1e-2, baseline_decay: float = 0.7,
        reward_metric: str = "accuracy",
        reward_fn: Optional[Any] = None,
        controller: str = "factored",
        **model_kwargs) -> Tuple[Dict[str, Any], Any, Dict[str, Any]]:
    """ENAS (arXiv:1802.03268): shared weights and a controller trained by
    REINFORCE on the validation reward, alternating per epoch:

    1. the weight phase: one epoch of ``train()`` of the ``sampled``
       supernet with ``train_arch_params: false`` (the logits move only by
       the controller), seed ``seed + round``;
    2. the controller phase: ``controller_samples`` architectures drawn on
       the host, each scored on a validation batch with the shared weights
       (one-hot forced paths), and an ascent of
       ``(R - baseline) * grad log pi + entropy_weight * grad H`` with an EMA
       baseline.

    ``controller='factored'`` is one softmax per mutable over the ``arch__*``
    logits (the exact policy gradient ``onehot - softmax``, a step of
    ``controller_lr`` over the sample count); ``'lstm'`` is
    :class:`LstmController` (Adam at ``controller_lr``), whose empirical
    marginals become the logits the weight phase samples from, and whose
    greedy decode is the export. ``reward_fn(arch, state) -> float``
    replaces the validation accuracy. Returns (architecture, the last
    round's state, history: the rounds' 'train', 'valid' and
    'throughput_img_s' entries, their 'steps', and a 'controller' list of
    per-round {epoch, reward_mean, baseline, entropy})."""
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.train.metrics import METRIC_FNS
    from deepcv_tpu_torch.train.training import train

    supernet = DeepcvModule(input_shape, model_hp, nas_mode="supernet",
                            nas_sampling="sampled", **model_kwargs)
    muts = list_mutables(model_hp)
    if not muts:
        raise ValueError("enas: the spec has no NAS mutables")
    if controller not in ("factored", "lstm"):
        raise ValueError(f"enas: unknown controller '{controller}' (factored|lstm)")
    hp = dict(training_hp)
    epochs = int(hp.get("epochs", 1))
    base_seed = int(hp.get("seed", 0))
    hp.update(epochs=1, train_arch_params=False)
    rng = np.random.default_rng(base_seed + 1)
    logits_of = supernet.arch_parameters()
    mut_names = list(muts)
    lstm = None
    if controller == "lstm":
        lstm = LstmController([logits_of[n].shape[0] for n in mut_names],
                              seed=base_seed + 2, lr=float(controller_lr),
                              entropy_weight=float(entropy_weight))
    metric_fn = METRIC_FNS[reward_metric]
    batch: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def default_reward(arch, state) -> float:
        if not batch:
            batch.append(_validation_batch(datasets, supernet.device))
        vx, vy = batch[0]
        return float(metric_fn(_forced_logits(supernet, arch, vx).float(), vy))

    reward_of = reward_fn or default_reward
    state = None
    history: Dict[str, Any] = {"train": [], "valid": [], "controller": [], "steps": 0,
                               "throughput_img_s": []}
    baseline = None
    for epoch in range(epochs):
        # each round its own shuffle, augmentation and path draws; the
        # optimizer's moments and the schedule restart every round
        state, h = train(dict(hp, seed=base_seed + epoch), supernet, losses, datasets,
                         metrics=metrics, backend_conf=backend_conf)
        for key in ("train", "valid", "throughput_img_s"):
            history[key].extend(h[key])
        history["steps"] += h["steps"]
        if lstm is not None:
            rows, advs, rewards = [], [], []
            for _ in range(int(controller_samples)):
                row = lstm.sample(rng)
                r = float(reward_of(dict(zip(mut_names, row)), state))
                rewards.append(r)
                baseline = r if baseline is None else \
                    baseline_decay * baseline + (1 - baseline_decay) * r
                rows.append(row)
                advs.append(r - baseline)
            lstm.update(rows, advs)
            # the weight phase samples from the policy's log-marginals
            for name, m in zip(mut_names, lstm.marginals(rng)):
                _set_logits(logits_of[name], np.log(m))
            ent = lstm.entropy()
        else:
            logits = {n: logits_of[n].detach().cpu().numpy().astype(np.float64) for n in muts}
            probs = {n: np.exp(v - v.max()) / np.exp(v - v.max()).sum()
                     for n, v in logits.items()}
            grads = {n: np.zeros_like(v) for n, v in logits.items()}
            rewards = []
            for _ in range(int(controller_samples)):
                arch = {n: int(rng.choice(len(p), p=p)) for n, p in probs.items()}
                r = float(reward_of(arch, state))
                rewards.append(r)
                baseline = r if baseline is None else \
                    baseline_decay * baseline + (1 - baseline_decay) * r
                adv = r - baseline
                for n_, c in arch.items():
                    onehot = np.zeros_like(probs[n_])
                    onehot[c] = 1.0
                    grads[n_] += adv * (onehot - probs[n_])
            ent = 0.0
            for n_, p in probs.items():
                logp = np.log(p + 1e-12)
                h_n = float(-(p * logp).sum())
                ent += h_n
                # dH/dlogit_i = -p_i (log p_i + H)
                grads[n_] += entropy_weight * (-p * (logp + h_n))
            for n_ in muts:
                _set_logits(logits_of[n_], logits[n_] + controller_lr * grads[n_]
                            / max(1, controller_samples))
        history["controller"].append({"epoch": epoch + 1,
                                      "reward_mean": float(np.mean(rewards)),
                                      "baseline": float(baseline), "entropy": float(ent)})
        _logger.info("enas[%s] round %d: reward %.4f baseline %.4f entropy %.3f", controller,
                     epoch + 1, np.mean(rewards), baseline, ent)

    if lstm is not None:
        arch = dict(zip(mut_names, lstm.greedy()))
    else:
        arch = {n: int(np.argmax(logits_of[n].detach().cpu().numpy())) for n in muts}
    if arch_export_path:
        _write_arch(arch, arch_export_path)
    return arch, state, history


def single_shot_neural_architecture_search(
        input_shape, model_hp: Mapping[str, Any], training_hp: Mapping[str, Any],
        losses, datasets, backend_conf=None, metrics=None,
        arch_export_path: Optional[Union[str, Path]] = None,
        algorithm: str = "darts", eval_candidates: Optional[bool] = None,
        eval_metric: str = "accuracy", max_eval_archs: int = 16,
        latency_weight: float = 0.1,
        **model_kwargs) -> Tuple[Dict[str, Any], Any, Dict[str, Any]]:
    """Train the supernet once, export an architecture (module docstring):
    ``algorithm`` darts, spos, proxylessnas or enas. ``eval_candidates``
    (default on for spos, which trains no logits) scores candidate
    architectures on validation with the shared weights and exports the
    best. Returns (architecture, state, history); ``state.model`` is the
    trained supernet."""
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.train.training import train

    algorithm = str(algorithm).lower()
    sampling = {"darts": "softmax", "spos": "uniform", "enas": "sampled",
                "proxylessnas": "sampled"}.get(algorithm)
    if sampling is None:
        raise ValueError(f"Unknown single-shot NAS algorithm '{algorithm}' "
                         "(darts|spos|enas|proxylessnas)")
    if algorithm == "enas":
        return enas_neural_architecture_search(
            input_shape, model_hp, training_hp, losses, datasets, backend_conf=backend_conf,
            metrics=metrics, arch_export_path=arch_export_path, reward_metric=eval_metric,
            **model_kwargs)
    if eval_candidates is None:
        eval_candidates = algorithm == "spos"
    supernet = DeepcvModule(input_shape, model_hp, nas_mode="supernet",
                            nas_sampling=sampling, **model_kwargs)
    reg = None
    if algorithm == "proxylessnas" and latency_weight:
        costs = candidate_costs(supernet)
        if costs:
            _logger.info("proxylessnas candidate cost table: %s", costs)
            reg = expected_cost_regularizer(costs, weight=latency_weight)
    state, history = train(training_hp, supernet, losses, datasets, metrics=metrics,
                           backend_conf=backend_conf, param_regularizer=reg)
    arch = export_architecture(supernet)
    if eval_candidates:
        arch = _select_arch_by_validation(input_shape, model_hp, state, datasets, losses, arch,
                                          metric=eval_metric, max_archs=max_eval_archs,
                                          supernet=supernet, **model_kwargs)
    if arch_export_path:
        _write_arch(arch, arch_export_path)
        _logger.info("exported architecture to %s: %s", arch_export_path, arch)
    return arch, state, history


def _select_arch_by_validation(input_shape, model_hp, state, datasets, losses,
                               default_arch, metric: str = "accuracy",
                               max_archs: int = 16, supernet=None, **model_kwargs):
    """Score candidate architectures (every one when there are at most
    ``max_archs``, else ``max_archs`` drawn uniformly) by forcing each one's
    one-hot path on the trained supernet's weights; the best one."""
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.train.losses import WeightedLosses
    from deepcv_tpu_torch.train.metrics import METRIC_FNS

    axes = []
    for name, m in list_mutables(model_hp).items():
        axes.append([(name, i) if m["kind"] == "layer" else (name, [i])
                     for i in range(m["n_candidates"])])
    total = int(np.prod([len(a) for a in axes])) if axes else 0
    if not total:
        return default_arch
    if total <= max_archs:
        combos = list(itertools.product(*axes))
    else:
        rng = np.random.default_rng(0)
        seen = set()
        while len(seen) < max_archs:
            seen.add(tuple((n, tuple(c) if isinstance(c, list) else c)
                           for n, c in (a[rng.integers(len(a))] for a in axes)))
        combos = [tuple((n, list(c) if isinstance(c, tuple) else c) for n, c in combo)
                  for combo in seen]
        _logger.info("candidate evaluation sampled %d of %d architectures uniformly "
                     "(raise max_eval_archs for wider coverage)", max_archs, total)
    if supernet is None:
        supernet = state.model if state is not None else \
            DeepcvModule(input_shape, model_hp, nas_mode="supernet", **model_kwargs)
    x, y = _validation_batch(datasets, supernet.device)
    metric_fn = METRIC_FNS.get(metric)
    best, best_score = default_arch, -math.inf
    for combo in combos:
        arch = dict(combo)
        logits = _forced_logits(supernet, arch, x).float()
        if metric_fn is not None:
            score = float(metric_fn(logits, y))
        else:
            wl = losses if isinstance(losses, WeightedLosses) else WeightedLosses(losses)
            score = -float(wl(logits, y)[0])
        _logger.info("candidate arch %s: %s=%.4f", arch, metric, score)
        if score > best_score:
            best, best_score = arch, score
    return best

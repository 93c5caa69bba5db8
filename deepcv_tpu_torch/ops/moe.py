"""The V-MoE expert MLP (Riquelme et al., arXiv:2106.05974).

Counterpart of ``deepcv_tpu/ops/moe.py`` (``MoEMlp``): the same function,
routed the PyTorch way. The JAX module keeps shapes static with one-hot
(groups, tokens, experts, capacity) dispatch and combine tensors contracted
by einsums; at ViT-B/16's shapes (batch 256 in groups of 4 images: G 64,
gs 788, E 8, C 124) each of those is 50 M float32 entries and the two
einsums cost 154 GFLOP a layer against the experts' 599. Here routing is
index arithmetic instead: every (group, token, choice) gets a slot number
in an (E, G, C) buffer, the tokens are gathered into it
(``index_select``), the experts run as two batched GEMMs over the stacked
weights (``torch.baddbmm``), and each token gathers its choices' rows back,
weighted by their router probabilities. Shapes stay static (an overflowing
choice writes to one spare slot and reads some row with weight 0), so
nothing waits on the host. Slots no token fills hold another token's row:
their expert outputs are never read, so neither the output nor any
gradient sees them.

What the JAX module fixes, this one keeps:

* groups are whole images: the largest divisor of N not above
  ``group_size // T`` images (``group_size`` 0: one global group);
* each expert takes ``min(ceil(k * gs / E * capacity_factor), gs)`` tokens a
  group; a choice beyond that is dropped and its output is exactly 0;
* the router (``router``, (D, E)) runs in float32 whatever the autocast
  dtype; in training ``router_noise`` multiplies the logits by
  U[1 - eps, 1 + eps] drawn from ``generator`` (the training loop's);
* priority: choice j takes slots after every choice < j, and within a
  choice the slots go in token order;
* Switch's load-balance loss (arXiv:2101.03961, eq. 4) from the first
  choice: ``E * mean_g(sum_e(f_e * P_e))``, 1 at perfect balance; the last
  forward's value stays on the module as ``aux`` for the training loop;
* experts in the compute dtype, stacked weights ``expert_w1`` (E, D, M),
  ``expert_b1`` (E, M), ``expert_w2`` (E, M, D), ``expert_b2`` (E, D), exact
  or tanh GELU (``mlp_act``).

The last forward's routing stays on the module too (``routing``: each
choice's expert and whether it kept its slot), for reports. The JAX
package's ``expert_parallel_rules`` (sharding over chips) is not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from deepcv_tpu_torch.ops import nn as dnn
from deepcv_tpu_torch.ops.attention import MLP_ACTS, _no_autocast

__all__ = ["MoEMlp"]


def _largest_divisor_leq(n: int, cap: int) -> int:
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


class MoEMlp(nn.Module):
    """Token-routed MLP: each token of an (N, T, D) or (S, D) input goes to
    its top-``k`` of ``num_experts`` expert MLPs (Dense(mlp_dim) -> GELU ->
    Dense(D), the dense ``MlpBlock``'s geometry); output the input's shape
    and dtype."""

    def __init__(self, dim: int, num_experts: int, mlp_dim: int, k: int = 1,
                 capacity_factor: float = 1.25, router_noise: float = 0.0,
                 group_size: int = 0, mlp_act: str = "gelu"):
        super().__init__()
        if not 1 <= int(k) <= int(num_experts):
            raise ValueError(f"k={k} must be in [1, E={num_experts}]")
        if mlp_act not in MLP_ACTS:
            raise ValueError(f"MoEMlp: unknown mlp_act {mlp_act!r} (gelu|gelu_tanh)")
        e, d, m = int(num_experts), int(dim), int(mlp_dim)
        self.num_experts, self.k = e, int(k)
        self.capacity_factor, self.router_noise = float(capacity_factor), float(router_noise)
        self.group_size, self.act_fn = int(group_size), MLP_ACTS[mlp_act]
        self.router = nn.Parameter(torch.empty(d, e))
        self.expert_w1 = nn.Parameter(torch.empty(e, d, m))
        self.expert_b1 = nn.Parameter(torch.empty(e, m))
        self.expert_w2 = nn.Parameter(torch.empty(e, m, d))
        self.expert_b2 = nn.Parameter(torch.empty(e, d))
        #: set by the training loop: draws the router noise
        self.generator: Optional[torch.Generator] = None
        #: the last forward's load-balance loss (a float32 scalar)
        self.aux: Optional[torch.Tensor] = None
        #: the last forward's routing: (experts, kept), each (G, gs, k)
        self.routing = None

    def init_parameters(self, generator: torch.Generator):
        """flax's defaults as the JAX module draws them: LeCun-normal router
        (a normal truncated at 2 std, std sqrt(1 / D) after truncation),
        Xavier-uniform expert kernels per expert, zero biases."""
        with torch.no_grad():
            std = math.sqrt(1.0 / self.router.shape[0]) / 0.87962566103423978
            nn.init.trunc_normal_(self.router, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            for w in (self.expert_w1, self.expert_w2):
                for i in range(w.shape[0]):
                    dnn.xavier_uniform_with_gain(1.0)(w[i], generator)
            self.expert_b1.zero_()
            self.expert_b2.zero_()

    def _groups(self, x: torch.Tensor):
        """(G, gs) of the JAX module's group layout."""
        total = x.numel() // x.shape[-1]
        if self.group_size > 0 and x.dim() >= 3:
            n = int(x.shape[0])
            per = _largest_divisor_leq(n, max(1, self.group_size // (total // n)))
            return n // per, per * (total // n)
        if 0 < self.group_size < total:
            gs = _largest_divisor_leq(total, self.group_size)
            return total // gs, gs
        return 1, total

    def route(self, xs: torch.Tensor, cap: int):
        """Router, top-k and slots for tokens ``xs`` (G, gs, D): returns each
        choice's slot in the flattened (E, G, C) buffer (the spare slot
        E*G*C when dropped), its combine weight (its probability, 0 when
        dropped), the experts, the kept mask and the aux loss."""
        g, gs, _ = xs.shape
        e = self.num_experts
        with _no_autocast(xs.device):
            logits = torch.matmul(xs.float(), self.router.float())         # (G, gs, E)
            if self.training and self.router_noise > 0.0:
                eps = self.router_noise
                u = torch.empty_like(logits).uniform_(1.0 - eps, 1.0 + eps,
                                                      generator=self.generator)
                logits = logits * u
            probs = torch.softmax(logits, dim=-1)
        arange_e = torch.arange(e, device=xs.device)
        group = torch.arange(g, device=xs.device)[:, None]
        counts = torch.zeros(g, e, dtype=torch.long, device=xs.device)
        remaining = probs
        slots, weights, experts, kept, first = [], [], [], [], None
        for _ in range(self.k):
            ej = remaining.argmax(-1)                                      # (G, gs)
            pj = probs.gather(-1, ej[..., None])[..., 0]
            maskj = ej[..., None] == arange_e                              # (G, gs, E)
            if first is None:
                first = maskj
            # the slot inside expert ej: earlier tokens of this choice plus
            # every slot the earlier choices took
            within = (maskj.long().cumsum(1) - 1 + counts[:, None, :]).gather(
                -1, ej[..., None])[..., 0]
            keep = within < cap
            counts = counts + (maskj & keep[..., None]).long().sum(1)
            remaining = remaining.masked_fill(maskj, 0.0)
            slots.append(torch.where(keep, (ej * g + group) * cap + within, e * g * cap))
            weights.append(pj * keep)
            experts.append(ej)
            kept.append(keep)
        aux = e * (first.float().mean(1) * probs.mean(1)).sum(-1).mean()
        return slots, weights, torch.stack(experts, -1), torch.stack(kept, -1), aux

    def dispatch(self, xs: torch.Tensor, slots, cap: int) -> torch.Tensor:
        """The (E, G*C, D) expert inputs: each kept choice's token in its
        slot. An unfilled slot holds the token whose number is the slot's
        modulo G*gs: its row is never read back, and spreading the unfilled
        slots over the tokens keeps the backward's ``index_add`` from piling
        onto one row."""
        g, gs, d = xs.shape
        n_slots = self.num_experts * g * cap
        token = torch.arange(g * gs, device=xs.device)
        token_of_slot = torch.arange(n_slots + 1, device=xs.device) % (g * gs)
        for s in slots:
            token_of_slot.scatter_(0, s.reshape(-1), token)
        return xs.reshape(g * gs, d).index_select(0, token_of_slot[:-1]).reshape(
            self.num_experts, g * cap, d)

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """Every expert's MLP on its (G*C, D) rows: two batched GEMMs."""
        dt = xe.dtype
        h = self.act_fn(torch.baddbmm(self.expert_b1[:, None, :].to(dt), xe,
                                      self.expert_w1.to(dt)))
        return torch.baddbmm(self.expert_b2[:, None, :].to(dt), h, self.expert_w2.to(dt))

    def combine(self, ye: torch.Tensor, slots, weights) -> torch.Tensor:
        """Each token's sum over its choices of weight x its slot's row. A
        dropped choice (weight 0) reads the row numbered as its token, so
        that the dropped ones, spread over the rows, do not pile onto one
        row in the backward's ``index_add``."""
        rows = ye.reshape(-1, ye.shape[-1])
        n = rows.shape[0]
        y = None
        for s, wgt in zip(slots, weights):
            s = s.reshape(-1)
            s = torch.where(s < n, s, torch.arange(s.numel(), device=s.device) % n)
            part = rows.index_select(0, s) * wgt.reshape(-1, 1).to(rows.dtype)
            y = part if y is None else y + part
        return y

    def forward(self, x):
        g, gs = self._groups(x)
        xs = x.reshape(g, gs, x.shape[-1])
        cap = min(max(1, int(math.ceil(self.k * gs / self.num_experts * self.capacity_factor))),
                  gs)
        slots, weights, experts, kept, self.aux = self.route(xs, cap)
        self.routing = (experts, kept)
        ye = self.experts(self.dispatch(xs, slots, cap))
        return self.combine(ye, slots, weights).reshape(x.shape).to(x.dtype)

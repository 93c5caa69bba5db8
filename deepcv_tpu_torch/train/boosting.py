"""Boosting: SAMME multi-class AdaBoost over weak learners of one spec.

Counterpart of ``deepcv_tpu/train/boosting.py`` (``_weighted_ce``,
``BoostedEnsemble``, ``adaboost_train``). Each round trains a member from a
fresh seeded init against the current sample weights (the weights enter the
loss; batches are uniform draws), its weighted error sets its vote
``alpha = log((1 - err) / err) + log(C - 1)`` (Zhu et al. 2009), and the
misclassified samples are up-weighted for the next round. The ensemble
predicts the alpha-weighted vote of its members.

A round is the JAX package's ``lax.scan`` of SGD with momentum (optax's
trace form, which ``torch.optim.SGD`` computes) written as a loop on the
model's device: the members' convs run on K2 there. The batch indices come
from a CPU generator keyed by (seed, round), so the card and the CPU train
on the same batches; :func:`_train_round` takes the index batches as an
argument.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepcv_tpu_torch.ops.moe import MoEMlp
from deepcv_tpu_torch.ops.nn import Dropout

__all__ = ["adaboost_train", "BoostedEnsemble"]

_logger = logging.getLogger(__name__)

#: the largest vote a member gets (a perfect member's alpha is infinite)
ALPHA_CAP = 20.0


def _weighted_ce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of each row weighted by ``w``, normalized by the
    weights' sum (float32)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(1, y[:, None].long())[:, 0]
    return torch.sum(ce * w) / (torch.sum(w) + 1e-12)


def _reweight(w: torch.Tensor, pred: torch.Tensor, labels: torch.Tensor, c: int):
    """SAMME's update: the weighted error, the member's alpha and the
    normalized new weights."""
    wrong = (pred != labels).float()
    err = torch.sum(w * wrong) / (torch.sum(w) + 1e-12)
    alpha = torch.log((1.0 - err) / torch.clamp(err, min=1e-12)) + float(np.log(c - 1))
    w2 = w * torch.exp(alpha * wrong)
    return w2 / (torch.sum(w2) + 1e-12), err, alpha


def _as_tensor(images, device) -> torch.Tensor:
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
    return x.to(device)


class BoostedEnsemble:
    """Alpha-weighted vote over SAMME members.

    ``model`` is the members' architecture; each member is a ``state_dict``
    loaded into it in turn. ``predict`` returns class ids, ``vote_scores``
    the (N, C) vote mass (the sum of the alphas behind each class), both
    over chunks of ``eval_batch`` rows on the model's device.
    """

    def __init__(self, model: torch.nn.Module, members: Sequence[Dict[str, torch.Tensor]],
                 alphas: Sequence[float], num_classes: int, eval_batch: int = 512):
        if len(members) != len(alphas) or not members:
            raise ValueError("BoostedEnsemble needs one alpha per member "
                             "(and at least one member)")
        self.model = model
        self.members = list(members)
        self.alphas = [float(a) for a in alphas]
        self.num_classes = int(num_classes)
        self.eval_batch = int(eval_batch)

    def vote_scores(self, images) -> np.ndarray:
        device = next(self.model.parameters()).device
        x = _as_tensor(images, device)
        votes = torch.zeros((x.shape[0], self.num_classes), dtype=torch.float32, device=device)
        for member, alpha in zip(self.members, self.alphas):
            pred = _predict(self.model, member, x, self.eval_batch)
            votes += alpha * F.one_hot(pred, self.num_classes).float()
        return votes.cpu().numpy()

    def predict(self, images) -> np.ndarray:
        return np.argmax(self.vote_scores(images), axis=-1)

    def accuracy(self, images, labels) -> float:
        return float(np.mean(self.predict(images) == np.asarray(labels)))


def _predict(model: torch.nn.Module, member: Optional[Dict[str, torch.Tensor]],
             x: torch.Tensor, eval_batch: int) -> torch.Tensor:
    """Eval-mode argmax of ``member`` (the model's own weights when None)
    over chunks of ``eval_batch`` rows."""
    if member is not None:
        model.load_state_dict(member)
    was_training = model.training
    model.eval()
    with torch.no_grad():
        pred = torch.cat([model(x[lo:lo + eval_batch]).argmax(-1)
                          for lo in range(0, x.shape[0], eval_batch)])
    model.train(was_training)
    return pred


def _round_seeds(seed: int, k: int) -> Tuple[int, int]:
    """(init seed, batch seed) of round ``k``."""
    base = (int(seed) * 1_000_003 + int(k)) * 2
    return base % 2 ** 63, (base + 1) % 2 ** 63


def _train_round(model: torch.nn.Module, images: torch.Tensor, labels: torch.Tensor,
                 w: torch.Tensor, index_batches: Sequence[torch.Tensor], *, lr: float,
                 momentum: float, generator: torch.Generator) -> List[float]:
    """One member: an SGD step with momentum on the weighted cross-entropy
    of each index batch, in training mode (dropout from ``generator``, batch
    statistics updated); returns the losses."""
    for m in model.modules():
        if isinstance(m, (Dropout, MoEMlp)):
            m.generator = generator
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum or 0.0)
    model.train()
    losses = []
    for idx in index_batches:
        idx = idx.to(images.device)
        loss = _weighted_ce(model(images[idx]), labels[idx], w[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return [float(v) for v in losses]


def adaboost_train(model: torch.nn.Module, images, labels, *, rounds: int = 5,
                   num_classes: Optional[int] = None, inner_steps: int = 100,
                   batch_size: int = 64, lr: float = 0.05,
                   momentum: float = 0.9, eval_batch: int = 512,
                   seed: int = 0, log_every: int = 0,
                   ) -> Tuple[BoostedEnsemble, Dict[str, list]]:
    """SAMME AdaBoost over ``rounds`` members of ``model``'s spec (a
    DeepcvModule, trained on its device; its weights end as the last
    member's).

    Each member starts from a fresh init seeded per round and trains
    ``inner_steps`` SGD steps of weighted cross-entropy on batches of
    ``batch_size`` uniform draws. Rounds stop when a member is no better
    than chance on the weighted distribution (err >= 1 - 1/C: discarded) or
    perfect (err ~ 0). Returns ``(BoostedEnsemble, history)`` with each
    round's weighted error, alpha and the boosted vote's train accuracy.
    """
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    device = next(model.parameters()).device
    x = _as_tensor(images, device)
    y = _as_tensor(np.asarray(labels), device).long()
    n = int(x.shape[0])
    c = int(num_classes) if num_classes else int(y.max()) + 1
    eb = min(int(eval_batch), n)

    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    members: List[Dict[str, torch.Tensor]] = []
    alphas: List[float] = []
    history: Dict[str, list] = {"err": [], "alpha": [], "vote_accuracy": []}
    for k in range(rounds):
        init_seed, batch_seed = _round_seeds(seed, k)
        fresh = type(model)(model.input_shape, model.hp.to_dict(), device="cpu",
                            generator=torch.Generator().manual_seed(init_seed),
                            **model._ctor_options())
        model.load_state_dict(fresh.state_dict())
        batches = torch.Generator().manual_seed(batch_seed)
        index_batches = [torch.randint(0, n, (batch_size,), generator=batches)
                         for _ in range(inner_steps)]
        _train_round(model, x, y, w, index_batches, lr=lr, momentum=momentum,
                     generator=torch.Generator(device=device).manual_seed(batch_seed))
        pred = _predict(model, None, x, eb)
        w_next, err, alpha = _reweight(w, pred, y, c)
        err_f, alpha_f = float(err), float(alpha)
        if err_f >= 1.0 - 1.0 / c:
            # no better than chance on the weighted distribution: its vote
            # would be <= 0 (SAMME's stop rule)
            _logger.info("adaboost round %d: err %.3f >= 1-1/C, stopping without this "
                         "member", k, err_f)
            break
        members.append({k_: v.detach().clone() for k_, v in model.state_dict().items()})
        alphas.append(min(alpha_f, ALPHA_CAP))
        history["err"].append(err_f)
        history["alpha"].append(alphas[-1])
        history["vote_accuracy"].append(
            BoostedEnsemble(model, members, alphas, c, eb).accuracy(x, y.cpu().numpy()))
        if log_every and (k + 1) % log_every == 0:
            _logger.info("adaboost %d/%d: err %.3f alpha %.3f vote acc %.3f", k + 1, rounds,
                         err_f, alphas[-1], history["vote_accuracy"][-1])
        if err_f <= 1e-8:
            _logger.info("adaboost round %d: perfect member, stopping", k)
            break
        w = w_next
    if not members:
        raise RuntimeError("adaboost_train: the first weak learner was no better than "
                           "chance; train it longer (inner_steps/lr) or use a stronger spec")
    return BoostedEnsemble(model, members, alphas, c, eb), history

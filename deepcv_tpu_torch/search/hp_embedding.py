"""A sampled hyperparameter configuration as a fixed-size vector.

Counterpart of ``deepcv_tpu/search/hp_embedding.py``: each domain of a
:class:`~deepcv_tpu_torch.hyperparams.HyperparameterSpace` encodes to
features in [0, 1] (the position in its range, log-scaled for
``loguniform``; a one-hot for ``choice``), and :class:`HyperparamsEmbedding`,
a 3-layer MLP, maps the encoding to ``embedding_size``. Its layers are
named by the flax module's (``fc1``-``fc3``) and initialised as flax's
``Dense`` (lecun normal, zero bias), so flax weights load with
:func:`deepcv_tpu_torch.interop.load_jax_variables`.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from deepcv_tpu_torch.hyperparams import HyperparameterSpace
from deepcv_tpu_torch.ops.nn import lecun_normal_
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["encode_hp_sample", "encoding_size", "HyperparamsEmbedding"]


def encode_hp_sample(space: HyperparameterSpace, sample: Mapping[str, Any]) -> np.ndarray:
    """One sampled configuration as a flat float32 vector in [0, 1] (0.5 for
    a missing continuous value, zeros for a missing or unknown choice)."""
    feats = []
    for name, dom in space.domains.items():
        v = sample.get(name)
        if dom.kind == "choice":
            onehot = np.zeros((len(dom.values),), np.float32)
            if v in dom.values:
                onehot[dom.values.index(v)] = 1.0
            feats.append(onehot)
            continue
        lo, hi = float(dom.values[0]), float(dom.values[1])
        if v is None:
            feats.append(np.asarray([0.5], np.float32))
        elif dom.kind == "loguniform":
            t = (math.log(max(float(v), 1e-300)) - math.log(lo)) / \
                max(math.log(hi) - math.log(lo), 1e-12)
            feats.append(np.asarray([np.clip(t, 0, 1)], np.float32))
        else:
            t = (float(v) - lo) / max(hi - lo, 1e-12)
            feats.append(np.asarray([np.clip(t, 0, 1)], np.float32))
    return np.concatenate(feats) if feats else np.zeros((1,), np.float32)


def encoding_size(space: HyperparameterSpace) -> int:
    return sum(len(d.values) if d.kind == "choice" else 1
               for d in space.domains.values()) or 1


class HyperparamsEmbedding(nn.Module):
    """relu(fc1) -> relu(fc2) -> fc3 over an encoded hp vector of
    ``in_features`` (:func:`encoding_size`), on ``device`` (the card unless
    given), initialised from ``generator`` (seeded 0 when None)."""

    #: parameters named by their flax paths (``fc1/kernel`` -> ``fc1.weight``)
    jax_flat = True

    def __init__(self, in_features: int, embedding_size: int = 32, hidden_size: int = 64, *,
                 device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)
        self.fc3 = nn.Linear(hidden_size, embedding_size)
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for fc in (self.fc1, self.fc2, self.fc3):
                lecun_normal_(fc.weight, gen)
                fc.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, encoded: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(encoded))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)

    @staticmethod
    def embed(space: HyperparameterSpace, samples: Sequence[Mapping[str, Any]],
              embedding_size: int = 32, generator: Optional[torch.Generator] = None,
              device: Union[None, str, torch.device] = None):
        """Encode ``samples`` and embed them with a freshly initialised
        embedding (a random projection): (embeddings, module)."""
        mod = HyperparamsEmbedding(encoding_size(space), embedding_size, device=device,
                                   generator=generator)
        enc = torch.from_numpy(np.stack([encode_hp_sample(space, s) for s in samples]))
        with torch.no_grad():
            return mod(enc.to(mod.fc1.weight.device)), mod

"""The device topology of a training run: one process on one device.

Counterpart of ``deepcv_tpu/train/backend.py`` (``BackendConfig``) for
the case the port carries: one device, rank 0 of one process. The
reference's torch-specific keys (``dist_backend``, ``dist_url``,
``local_rank``, ``ngpus``) are accepted and ignored, as the JAX package
ignores them. A mesh, tensor parallelism, slices, ZeRO, a multi-process
run or more than one device raise, naming the key: data and model
parallelism across cards come with the scale-out slice (ROADMAP P15).
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Union

import torch

from deepcv_tpu_torch.utils import resolve_device

__all__ = ["BackendConfig"]

_logger = logging.getLogger(__name__)


class BackendConfig:
    """One device (CUDA unless ``device`` says otherwise), rank 0 of one
    process. ``str()`` names it in run directories (``cuda-x1``)."""

    def __init__(self, device: Union[None, str, torch.device] = None,
                 mesh_shape: Optional[Sequence[int]] = None,
                 n_devices: Optional[int] = None,
                 tensor_parallel: int = 1, slices: int = 1, zero: bool = False,
                 distributed: bool = False, axis_names: Optional[Sequence[str]] = None,
                 dist_backend: Optional[str] = None, dist_url: Optional[str] = None,
                 local_rank: Optional[int] = None, ngpus: Optional[int] = None,
                 **ignored):
        for k, v in dict(dist_backend=dist_backend, dist_url=dist_url, local_rank=local_rank,
                         ngpus=ngpus, axis_names=axis_names, **ignored).items():
            if v is not None:
                _logger.debug("BackendConfig: option %s=%r ignored (one device)", k, v)
        refused = {"mesh_shape": mesh_shape is not None,
                   "n_devices": n_devices not in (None, 1),
                   "tensor_parallel": int(tensor_parallel) != 1,
                   "slices": int(slices) != 1, "zero": bool(zero),
                   "distributed": bool(distributed)}
        for key, on in refused.items():
            if on:
                raise NotImplementedError(
                    f"backend_conf '{key}' = {locals()[key]!r}: the port trains on one "
                    "device; multi-device training comes with ROADMAP P15")
        self.device = resolve_device(device)

    @property
    def n_devices(self) -> int:
        return 1

    @property
    def rank(self) -> int:
        return 0

    @property
    def process_count(self) -> int:
        return 1

    def __str__(self):
        return f"{self.device.type}-x{self.n_devices}"

    def __repr__(self):
        return f"BackendConfig(device={str(self.device)!r}, processes=1)"

"""DeepcvModule — a YAML-declared model as an ``nn.Module``.

Counterpart of ``deepcv_tpu/spec/module.py`` (``DeepcvModule`` and its
``describe()``): the same hp handling (``HP_DEFAULTS``, required
``architecture``/``act_fn``), the same architecture compiler, the same
initialisers. The model owns its parameters, as PyTorch modules do.

Public layout stays the JAX package's: ``forward`` takes NHWC images
(``input_shape`` is (H, W, C)) and returns NHWC feature maps or (N, F)
rows; inside, tensors are NCHW-logical in ``torch.channels_last`` memory,
which is the same NHWC bytes, so the permutes at the edges copy nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn

from deepcv_tpu_torch.hyperparams import Hyperparameters, to_hyperparameters
from deepcv_tpu_torch.spec.creators import CreatorContext
from deepcv_tpu_torch.spec.graph import SpecError, SpecModule, define_nn_architecture
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["DeepcvModule", "DeepcvModuleDescriptor"]


class DeepcvModule(nn.Module):
    """A compiled YAML-spec model.

    ``device``: CUDA unless given (``"cpu"`` for the plain path, ``"meta"``
    for shapes and parameter counts without allocating). Parameters are
    initialised on the CPU from ``generator`` (a fresh one seeded 0 when
    None), then moved, so a seed gives the same weights on every device.
    """

    #: 'architecture' and 'act_fn' required; every norm technique optional
    HP_DEFAULTS: Dict[str, Any] = {
        "architecture": ...,
        "act_fn": ...,
        "dropout_prob": 0.0,
        "preactivation": False,
        "batch_norm": None,
        "layer_norm": None,
        "instance_norm": None,
        "group_norm": None,
        "local_response_norm": None,
        "layer_nrm_and_mean_batch_nrm": None,
        "weight_norm": None,
        "spectral_norm": None,
    }

    def __init__(self, input_shape: Sequence[int], hp: Mapping[str, Any], *,
                 device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        #: channel-last input shape WITHOUT batch dim, e.g. (224, 224, 3)
        self.input_shape = tuple(int(s) for s in input_shape)
        self._hp, _ = to_hyperparameters(hp, self.HP_DEFAULTS, raise_if_missing=True)
        for key in ("weight_norm", "spectral_norm"):
            if self._hp.get(key):
                raise SpecError(f"hp '{key}' is not ported yet")
        nchw = (1, self.input_shape[-1], *self.input_shape[:-1])
        metas, impls, refd, shapes = define_nn_architecture(
            self._hp["architecture"], self._hp, CreatorContext(hp=self._hp), nchw)
        self.module = SpecModule(metas, impls, refd)
        #: per-node output shapes at batch 1, channel-last like the JAX package's
        self.node_shapes = {k: _channel_last(s) for k, s in shapes.items()}
        if dev.type != "meta":
            self.to_empty(device="cpu")
            self.init_parameters(generator or torch.Generator().manual_seed(0))
            self.to(dev)

    @property
    def hp(self) -> Hyperparameters:
        return self._hp

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def output_shape(self):
        """Output shape at batch 1 (channel-last for feature maps)."""
        return self.node_shapes[self.module.node_metas[-1].name]

    def init_parameters(self, generator: torch.Generator) -> None:
        """(Re)initialise every parameter and buffer from ``generator``, in
        node order (the modules' ``init_parameters``)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_parameters"):
                m.init_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in; NHWC feature maps or (N, F) rows out."""
        y = self.module(x.movedim(-1, 1))
        return y.movedim(1, -1) if y.dim() > 2 else y

    def capacity(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def describe(self) -> "DeepcvModuleDescriptor":
        return DeepcvModuleDescriptor(self)


def _channel_last(shape):
    shape = tuple(shape)
    return (shape[0], *shape[2:], shape[1]) if len(shape) > 2 else shape


class DeepcvModuleDescriptor:
    """Human-readable model description: per-node output shapes (from the
    meta-device shape inference) and parameter counts."""

    def __init__(self, model: DeepcvModule):
        self.model = model
        self.features_shapes = dict(model.node_shapes)
        self.output_shape = model.output_shape
        self.submodules_capacities = {
            m.name: sum(p.numel() for p in model.module.nodes[m.name].parameters())
            if m.kind == "module" else 0 for m in model.module.node_metas}
        self.capacity = model.capacity()

    def __str__(self) -> str:
        lines = [f"DeepcvModule  input={self.model.input_shape}  "
                 f"capacity={self.capacity:,} params"]
        for meta in self.model.module.node_metas:
            refs = f"  <- {list(meta.refs)}" if meta.refs else ""
            lines.append(f"  {meta.name:40s} {meta.creator:18s} "
                         f"out={self.features_shapes[meta.name]} "
                         f"params={self.submodules_capacities[meta.name]:,}{refs}")
        lines.append(f"  output shape: {self.output_shape}")
        return "\n".join(lines)

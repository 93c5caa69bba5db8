"""DeepcvModule — a YAML-declared model as an ``nn.Module``.

Counterpart of ``deepcv_tpu/spec/module.py`` (``DeepcvModule`` and its
``describe()``): the same hp handling (``HP_DEFAULTS``, required
``architecture``/``act_fn``), the same architecture compiler, the same
initialisers. The model owns its parameters, as PyTorch modules do.

Public layout stays the JAX package's: ``forward`` takes NHWC images
(``input_shape`` is (H, W, C)) and returns NHWC feature maps, (N, T, D)
tokens, (N, F) rows or a list of NHWC maps (parallel streams); inside, feature maps are NCHW-logical in
``torch.channels_last`` memory, which is the same NHWC bytes, so the
permutes at the edges copy nothing. Clips (``input_shape`` (F, H, W, C),
``conv3d``) and 1-d signals ((W, C), ``conv1d``) are channel-first inside
in the same way; a 1-d signal's 3-d tensors are maps, not tokens.

``weight_norm`` (``{eps: ...}``) wraps the op of every conv and dense layer
in flax's ``WeightNorm`` (``spec/creators.py``); ``spectral_norm`` is not
ported yet and raises, also beside ``weight_norm`` (the JAX package takes
it first).

``dtype`` is the compute dtype, as the JAX package's ``DeepcvModule(dtype=)``:
with ``bfloat16`` the forward runs under ``torch.autocast`` (matmuls in
bf16, norms and softmax statistics in float32) while parameters stay
float32.

``quantize`` is the JAX package's too: ``'int8'`` computes every conv,
dense and transformer projection that the JAX package quantizes in w8a8
(:mod:`deepcv_tpu_torch.compression`; the convs on the ``int8_conv``
kernel, never on K2), with static activation scales where
``quantize_scales`` (from ``calibrate_int8_scales``) has the node's key and
dynamic ones elsewhere; ``'int<N>_qat'`` fake-quantizes them for
quantization-aware training. The parameters are the float build's, so a
trained ``state_dict`` loads unchanged and :meth:`with_options` rebuilds a
model with another mode on the same tensors. A real-int8 build is
inference-only: it starts in eval mode, and ``train()`` or a forward in
training mode raise, as the JAX package's ``apply(train=True)`` does.

``nas_mode``, ``nas_arch`` and ``nas_sampling`` are the JAX package's NAS
options (``spec/graph.py``): ``fixed`` builds the choices ``nas_arch``
names, ``supernet`` every candidate with its ``arch__*`` logits, mixed by
``softmax``, ``sampled`` or ``uniform``. :meth:`with_options` and pickling
keep them; :meth:`with_forced_arch` evaluates one architecture on a
supernet's own weights.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn

from deepcv_tpu_torch.compression import INFERENCE_ONLY_ERROR
from deepcv_tpu_torch.hyperparams import Hyperparameters, to_hyperparameters
from deepcv_tpu_torch.spec.creators import CreatorContext
from deepcv_tpu_torch.spec.graph import (NAS_MODES, SpecError, SpecModule,
                                         clone_with_forced_arch, define_nn_architecture)
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["DeepcvModule", "DeepcvModuleDescriptor"]


def _rebuild(cls, input_shape, hp, kw, state, training):
    model = cls(input_shape, hp, device="meta", **kw)
    model.load_state_dict(state, strict=True, assign=True)
    return model if model.inference_only else model.train(training)


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
                 generator: Optional[torch.Generator] = None,
                 dtype: Union[None, str, torch.dtype] = None,
                 quantize: Optional[str] = None,
                 quantize_scales: Optional[Mapping[str, float]] = None,
                 nas_mode: str = "fixed", nas_arch: Optional[Mapping[str, Any]] = None,
                 nas_sampling: str = "softmax"):
        super().__init__()
        if nas_mode not in NAS_MODES:
            raise SpecError(f"nas_mode must be one of {NAS_MODES}, got {nas_mode!r}")
        self.nas_mode = nas_mode
        self.nas_arch = dict(nas_arch or {})
        self.nas_sampling = nas_sampling
        dev = resolve_device(device)
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        #: compute dtype (None or float32: plain float32)
        self.dtype = None if dtype in (None, torch.float32) else dtype
        #: None, 'int8' or 'int<N>_qat'
        self.quantize = quantize or None
        self.quantize_scales = dict(quantize_scales or {})
        #: channel-last input shape WITHOUT batch dim, e.g. (224, 224, 3)
        self.input_shape = tuple(int(s) for s in input_shape)
        self._hp, _ = to_hyperparameters(hp, self.HP_DEFAULTS, raise_if_missing=True)
        if self._hp.get("spectral_norm"):
            raise SpecError("hp 'spectral_norm' is not ported yet")
        wn = self._hp.get("weight_norm")
        if wn and not isinstance(wn, Mapping):
            raise SpecError(f"hp 'weight_norm' must be a mapping such as {{eps: 1.0e-6}}, "
                            f"got {wn!r}")
        nchw = (1, self.input_shape[-1], *self.input_shape[:-1])
        #: a 1-d signal (W, C): its 3-d tensors are NCW maps, not tokens
        self._map_dims = 3 if len(self.input_shape) == 2 else 4
        metas, impls, refd, shapes = define_nn_architecture(
            self._hp["architecture"], self._hp,
            CreatorContext(hp=self._hp, weight_norm=wn or None,
                           signal_1d=self._map_dims == 3, quantize=self.quantize,
                           quantize_scales=self.quantize_scales, nas_mode=nas_mode,
                           nas_arch=self.nas_arch), nchw)
        self.module = SpecModule(metas, impls, refd, shapes, sampling=nas_sampling)
        #: per-node output shapes at batch 1, channel-last like the JAX package's
        self.node_shapes = {k: _channel_last(s, self._map_dims) for k, s in shapes.items()}
        if dev.type != "meta":
            self.to_empty(device="cpu")
            self.init_parameters(generator or torch.Generator().manual_seed(0))
            self.to(dev)
        if self.inference_only:
            self.eval()

    @property
    def inference_only(self) -> bool:
        """A real-int8 build: round and clip leave no gradient to train on."""
        return self.quantize is not None and not str(self.quantize).endswith("_qat")

    def train(self, mode: bool = True):
        if mode and self.inference_only:
            raise ValueError(INFERENCE_ONLY_ERROR.format(self.quantize))
        return super().train(mode)

    def _ctor_options(self) -> Dict[str, Any]:
        """The constructor options that rebuild this model."""
        return dict(dtype=self.dtype, quantize=self.quantize,
                    quantize_scales=self.quantize_scales, nas_mode=self.nas_mode,
                    nas_arch=self.nas_arch, nas_sampling=self.nas_sampling)

    def with_options(self, **overrides) -> "DeepcvModule":
        """This architecture rebuilt with other constructor options
        (``quantize``, ``quantize_scales``, ``dtype``; the NAS options are
        kept unless given) on the SAME parameter and buffer tensors, on their
        device, in this model's mode (eval for a real-int8 build)."""
        kw = self._ctor_options()
        kw.update(overrides)
        new = type(self)(self.input_shape, self._hp.to_dict(), device="meta", **kw)
        new.load_state_dict(self.state_dict(keep_vars=True), strict=True, assign=True)
        return new if new.inference_only else new.train(self.training)

    def __reduce__(self):
        """Pickled as its spec, its constructor options and its tensors (the
        nodes hold closures, which pickle cannot take): how the intermediate
        cache of partial runs keeps a model."""
        return (_rebuild, (type(self), self.input_shape, self._hp.to_dict(),
                           self._ctor_options(), self.state_dict(), self.training))

    def with_forced_arch(self, arch: Mapping[str, Any]) -> "DeepcvModule":
        """A shallow copy of this supernet that forces ``arch``'s choices
        (one-hot weights; the mean multi-hot for a list) on the SAME
        parameters and buffers: one architecture scored with the shared
        weights. Its modules are this model's, so ``train()``/``eval()`` on
        either moves both."""
        forced = copy.copy(self)
        forced.__dict__["_modules"] = dict(self._modules)
        forced.module = clone_with_forced_arch(self.module, arch)
        return forced

    def spec_modules(self) -> Dict[str, SpecModule]:
        """Every SpecModule of the model by its mutables' prefix ('' for the
        top level, '<nested>/' for a nested module)."""
        out: Dict[str, SpecModule] = {}

        def walk(spec: SpecModule, prefix: str):
            out[prefix] = spec
            for name, node in spec.nodes.items():
                if isinstance(node, SpecModule):
                    walk(node, f"{prefix}{name}/")
        walk(self.module, "")
        return out

    def arch_parameters(self) -> Dict[str, torch.nn.Parameter]:
        """The supernet's choice logits by mutable name ('<nested>/<local>'
        for a nested one)."""
        return {prefix + k: p for prefix, spec in self.spec_modules().items()
                for k, p in spec.arch_logits().items()}

    @property
    def hp(self) -> Hyperparameters:
        return self._hp

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def output_shape(self):
        """Output shape at batch 1 (channel-last for feature maps; a list of
        shapes for parallel streams)."""
        return self.node_shapes[self.module.node_metas[-1].name]

    def init_parameters(self, generator: torch.Generator) -> None:
        """(Re)initialise every parameter and buffer from ``generator``, in
        node order (the modules' ``init_parameters``)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_parameters"):
                m.init_parameters(generator)

    def forward(self, x: torch.Tensor):
        """NHWC in; NHWC feature maps, (N, T, D) tokens, (N, F) rows or a
        list of NHWC maps out."""
        if self.training and self.inference_only:
            raise ValueError(INFERENCE_ONLY_ERROR.format(self.quantize))
        x = x.movedim(-1, 1)
        if self.dtype is not None and x.device.type in ("cpu", "cuda"):
            with torch.autocast(x.device.type, dtype=self.dtype):
                y = self.module(x)
        else:
            y = self.module(x)
        if isinstance(y, (list, tuple)):
            return [t.movedim(1, -1) if t.dim() >= self._map_dims else t for t in y]
        return y.movedim(1, -1) if y.dim() >= self._map_dims else y

    def capacity(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def describe(self) -> "DeepcvModuleDescriptor":
        return DeepcvModuleDescriptor(self)


def _channel_last(shape, map_dims: int = 4):
    if isinstance(shape, list):
        return [_channel_last(s, map_dims) for s in shape]
    shape = tuple(shape)
    return (shape[0], *shape[2:], shape[1]) if len(shape) >= map_dims else shape


class DeepcvModuleDescriptor:
    """Human-readable model description: per-node output shapes (from the
    meta-device shape inference) and parameter counts."""

    def __init__(self, model: DeepcvModule):
        self.model = model
        self.features_shapes = dict(model.node_shapes)
        self.output_shape = model.output_shape
        spec = model.module
        self.submodules_capacities = {
            m.name: sum(p.numel() for p in spec.nodes[m.name].parameters())
            if m.kind == "module" else
            sum(p.numel() for i in range(m.n_candidates)
                for p in spec.nodes[f"{m.name}_cand{i}"].parameters())
            if m.kind == "choice" else 0 for m in spec.node_metas}
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

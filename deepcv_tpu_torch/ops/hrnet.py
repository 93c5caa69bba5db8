"""HRNet building blocks of the port: multi-resolution parallel streams.

Counterpart of ``deepcv_tpu/ops/hrnet.py`` (``ParallelConvolution``,
``MultiresolutionFusion``, ``HRNetInputStem`` and the representation heads
``HRNetV1RepresentationHead``, ``HRNetV2RepresentationHead`` and
``HRNetV2pRepresentationHead``). A stream set is a list of NCHW-logical
maps, highest resolution first; a single map is a set of one stream.

Every conv here is grouped, strided or a 1x1 mix that the JAX package
leaves to XLA (``flax.linen.Conv``, not its Pallas conv), so here they
are ``F.conv2d`` (:class:`~deepcv_tpu_torch.ops.nn.Conv2d`): the stem's
and the streams' convs Xavier-normal with the activation's gain, the
scaling, mixing and pyramid convs flax's LeCun-normal default, as there.

``jax_names`` maps the JAX variable names under a node to the module's own
paths, for ``interop``: the JAX modules create their norms in their own
scope, numbered per class in creation order (``MeanOnlyBatchNorm_0``,
``LayerNorm_0``, then stream 1's ``..._1``), and name their convs
``stream<i>_conv``, ``stem_conv<i>``, ``down_shared_<in>to<out>`` and
``up_shared_<in>to<out>`` (``down_<j>to<i>_<k>``, ``up_<j>to<i>`` and
``down_newbranch`` without ``reuse_scaling_convs``).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from deepcv_tpu_torch.ops import nn as dnn

__all__ = ["ParallelConvolution", "MultiresolutionFusion", "HRNetInputStem",
           "HRNetV1RepresentationHead", "HRNetV2RepresentationHead",
           "HRNetV2pRepresentationHead"]


def _as_streams(x) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _per_stream(value, n: int) -> List[Any]:
    """Broadcast a scalar spec to n streams; a shorter list repeats its last
    entry, a longer one is cut."""
    vals = list(value) if isinstance(value, (list, tuple)) else [value] * n
    return (vals + [vals[-1]] * (n - len(vals)))[:n]


def _layer_names(layers: Sequence[dnn.Layer], op_names: Sequence[str]) -> Dict[str, str]:
    """JAX names of layer units built in one scope: each op by its name,
    each norm by its class and that class's count so far."""
    names: Dict[str, str] = {}
    counts: Dict[str, int] = collections.Counter()
    for i, (layer, op_name) in enumerate(zip(layers, op_names)):
        names[op_name] = f"layers.{i}.op"
        for j, norm in enumerate(layer.norms):
            cls = type(norm).__name__
            names[f"{cls}_{counts[cls]}"] = f"layers.{i}.norms.{j}"
            counts[cls] += 1
    return names


def _layer(op: nn.Module, in_ch: int, out_ch: int, act_fn, dropout_prob, preactivation,
           norm_specs) -> dnn.Layer:
    return dnn.Layer(op=op, act_fn=act_fn, dropout_prob=dropout_prob,
                     preactivation=preactivation,
                     norms=dnn.normalization_techniques(norm_specs or {},
                                                        in_ch if preactivation else out_ch))


class ParallelConvolution(nn.Module):
    """One conv layer unit per stream, each with its own kernel size,
    groups and output channels. ``kernel_size`` must be a sequence of
    kernel-size pairs (a scalar or one pair is refused, as in the JAX
    module); per-stream values broadcast. ``groups`` snaps down to the
    nearest divisor of the stream's input and output channels (``[8, 6]``
    on 32 channels gives 8 and 4)."""

    def __init__(self, in_channels: Sequence[int], kernel_size, out_channels, groups=1,
                 act_fn: Optional[Callable] = None, dropout_prob: float = 0.0,
                 preactivation: bool = False,
                 norm_specs: Optional[Mapping[str, Any]] = None):
        super().__init__()
        ks = kernel_size
        if not (isinstance(ks, (list, tuple)) and ks and isinstance(ks[0], (list, tuple))):
            raise ValueError("parallel_conv 'kernel_size' must be a sequence of kernel-size "
                             f"pairs, e.g. [[3, 3], [5, 5]]; got {ks!r}")
        n = len(in_channels)
        kss, chs, grs = (_per_stream(v, n) for v in (ks, out_channels, groups))
        gain = dnn.get_gain(act_fn)
        layers = []
        for i, cin in enumerate(in_channels):
            k = tuple(int(v) for v in kss[i])
            cout, g = int(chs[i]), int(grs[i])
            while g > 1 and (cin % g or cout % g):
                g -= 1
            op = dnn.Conv2d(cin, cout, k, padding=tuple(v // 2 for v in k), groups=g, gain=gain)
            layers.append(_layer(op, cin, cout, act_fn, dropout_prob, preactivation, norm_specs))
        self.layers = nn.ModuleList(layers)
        self.jax_names = _layer_names(layers, [f"stream{i}_conv" for i in range(n)])

    def forward(self, x):
        streams = _as_streams(x)
        if len(streams) != len(self.layers):
            raise ValueError(f"parallel_conv built for {len(self.layers)} streams, "
                             f"got {len(streams)}")
        return [layer(s) for layer, s in zip(self.layers, streams)]


class MultiresolutionFusion(nn.Module):
    """Every stream rescaled to every other stream's resolution and summed
    into it, then the activation: a higher-resolution source goes down by
    ``i - j`` strided 3x3 convs (the first to the target's channels), a
    lower one up by a bilinear resize and a 1x1 conv. The sum is taken in
    the target's dtype. ``create_new_branch`` appends a stream at half the
    lowest resolution, a strided conv of the lowest stream
    (``new_branch_channels``, twice its channels by default).
    ``reuse_scaling_convs`` builds one conv per (direction, in, out) and
    calls it at every site with that signature, the new branch's included.
    ``in_shapes`` are the streams' NCHW shapes."""

    def __init__(self, in_shapes: Sequence[Sequence[int]], create_new_branch: bool = True,
                 new_branch_channels: Optional[int] = None,
                 reuse_scaling_convs: bool = False, act_fn: Optional[Callable] = None):
        super().__init__()
        chans = [int(s[1]) for s in in_shapes]
        n = len(chans)
        convs: Dict[str, nn.Module] = {}

        def conv(direction: str, cin: int, cout: int, tag: str) -> str:
            name = (f"{direction}_shared_{cin}to{cout}" if reuse_scaling_convs
                    else f"{direction}_{tag}")
            if name not in convs:
                convs[name] = (dnn.LecunConv2d(cin, cout, (3, 3), stride=(2, 2), padding=(1, 1))
                               if direction == "down" else dnn.LecunConv2d(cin, cout, (1, 1)))
            return name

        #: per target stream, its sources (j, conv names in order)
        self.routes: List[List[tuple]] = []
        for i in range(n):
            sources = []
            for j in range(n):
                if j < i:
                    names = [conv("down", chans[j], chans[i], f"{j}to{i}_0")]
                    names += [conv("down", chans[i], chans[i], f"{j}to{i}_{k}")
                              for k in range(1, i - j)]
                    sources.append((j, names))
                elif j > i:
                    sources.append((j, [conv("up", chans[j], chans[i], f"{j}to{i}")]))
            self.routes.append(sources)
        self.new_branch = None
        if create_new_branch:
            self.new_branch = conv("down", chans[-1],
                                   int(new_branch_channels or 2 * chans[-1]), "newbranch")
        self.convs = nn.ModuleDict(convs)
        self.act_fn = act_fn
        self.jax_names = {name: f"convs.{name}" for name in convs}

    def _act(self, y):
        return y if self.act_fn is None else self.act_fn(y)

    def forward(self, x):
        streams = _as_streams(x)
        if len(streams) != len(self.routes):
            raise ValueError(f"multiresolution_fusion built for {len(self.routes)} streams, "
                             f"got {len(streams)}")
        outs = []
        for i, (target, sources) in enumerate(zip(streams, self.routes)):
            acc = target
            for j, names in sources:
                y = streams[j]
                if j > i:
                    y = dnn.interpolate(y, target.shape[2:])
                for name in names:
                    y = self.convs[name](y)
                acc = acc + y.to(acc.dtype)
            outs.append(self._act(acc))
        if self.new_branch is not None:
            outs.append(self._act(self.convs[self.new_branch](streams[-1])))
        return outs


class HRNetInputStem(nn.Module):
    """``conv_count`` strided 3x3 conv layer units, each halving the
    resolution; a stream list in takes its first stream."""

    def __init__(self, in_channels: int, out_channels: int = 64, conv_count: int = 2,
                 act_fn: Optional[Callable] = None, dropout_prob: float = 0.0,
                 preactivation: bool = False,
                 norm_specs: Optional[Mapping[str, Any]] = None):
        super().__init__()
        gain = dnn.get_gain(act_fn)
        layers = []
        for i in range(int(conv_count)):
            cin = in_channels if i == 0 else out_channels
            op = dnn.Conv2d(cin, out_channels, (3, 3), stride=(2, 2), padding=(1, 1), gain=gain)
            layers.append(_layer(op, cin, out_channels, act_fn, dropout_prob, preactivation,
                                 norm_specs))
        self.layers = nn.ModuleList(layers)
        self.jax_names = _layer_names(layers, [f"stem_conv{i}" for i in range(len(layers))])

    def forward(self, x):
        x = _as_streams(x)[0]
        for layer in self.layers:
            x = layer(x)
        return x


class HRNetV1RepresentationHead(nn.Module):
    """Keep the highest-resolution stream."""

    def forward(self, x):
        return _as_streams(x)[0]


class HRNetV2RepresentationHead(nn.Module):
    """Every stream resized to the first one's resolution, concatenated on
    the channels, then a 1x1 conv ``mix`` (to ``out_channels``, the
    concatenation's width by default) and the activation."""

    def __init__(self, in_channels: Sequence[int], out_channels: Optional[int] = None,
                 act_fn: Optional[Callable] = None):
        super().__init__()
        total = sum(int(c) for c in in_channels)
        self.mix = dnn.LecunConv2d(total, int(out_channels or total), (1, 1))
        self.act_fn = act_fn

    def forward(self, x):
        streams = _as_streams(x)
        hw = streams[0].shape[2:]
        y = self.mix(torch.cat([streams[0]] + [dnn.interpolate(s, hw) for s in streams[1:]],
                               dim=1))
        return y if self.act_fn is None else self.act_fn(y)


class HRNetV2pRepresentationHead(nn.Module):
    """The V2 head (``v2``), then ``pyramid_levels - 1`` strided 3x3 convs
    (``pyr<i>``, each followed by the activation): a stream list out."""

    def __init__(self, in_channels: Sequence[int], out_channels: Optional[int] = None,
                 pyramid_levels: int = 3, act_fn: Optional[Callable] = None):
        super().__init__()
        self.v2 = HRNetV2RepresentationHead(in_channels, out_channels, act_fn)
        c = self.v2.mix.weight.shape[0]
        self.levels = int(pyramid_levels) - 1
        for i in range(self.levels):
            self.add_module(f"pyr{i}", dnn.LecunConv2d(c, c, (3, 3), stride=(2, 2),
                                                       padding=(1, 1)))
        self.act_fn = act_fn

    def forward(self, x):
        y = self.v2(x)
        outs = [y]
        for i in range(self.levels):
            y = getattr(self, f"pyr{i}")(y)
            if self.act_fn is not None:
                y = self.act_fn(y)
            outs.append(y)
        return outs

"""Programmatic model-zoo specs on top of the YAML spec language.

Counterpart of ``deepcv_tpu/spec/zoo.py`` (``resnet_spec``,
``RESNET_LAYERS``), copied so that the port imports nothing of the JAX
package: these functions emit plain architecture lists, the same dicts a user
could write in YAML. The layer unit applies op -> act -> norm, so a
bottleneck is conv -> relu -> bn; parameter counts are torchvision's
(resnet_spec(50) has 25,557,032).
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["resnet_spec", "RESNET_LAYERS"]

#: blocks per stage for the standard depths
RESNET_LAYERS = {
    18: ((2, 2, 2, 2), "basic"),
    34: ((3, 4, 6, 3), "basic"),
    50: ((3, 4, 6, 3), "bottleneck"),
    101: ((3, 4, 23, 3), "bottleneck"),
    152: ((3, 8, 36, 3), "bottleneck"),
}


def _norm_hp(norm: str, num_groups: int = 8):
    """The shared norm-technique spec (torch eps/momentum
    conventions; group count per family)."""
    return ({"momentum": 0.1, "eps": 1e-5} if norm == "batch_norm"
            else {"num_groups": num_groups, "eps": 1e-5})


def _conv(name, out_ch, k, stride=1, act=True, groups=1, bias=True):
    p: Dict[str, Any] = {"kernel_size": [k, k], "out_channels": out_ch,
                         "padding": k // 2}
    if stride != 1:
        p["stride"] = stride
    if groups != 1:
        p["groups"] = groups
    if not act:
        p["act_fn"] = None
    if not bias:
        p["use_bias"] = False
    return {"conv2d": [name, p]}


def resnet_spec(depth: int = 50, num_classes: int = 1000,
                norm: str = "batch_norm",
                width: int = 64, pool_kernel: int = 7,
                groups: int = 1, width_per_group: int = 64) -> Dict[str, Any]:
    """Full model hp dict (architecture + globals) for a ResNet of the given
    depth. ``norm`` picks the normalization technique globally ('batch_norm'
    canonical; 'group_norm' or None are the other choices).

    ``groups``/``width_per_group`` give the torchvision-exact variants of
    the bottleneck family: ResNeXt-50 32x4d = (50, groups=32,
    width_per_group=4); Wide ResNet-50-2 = (50, width_per_group=128)."""
    if depth not in RESNET_LAYERS:
        raise ValueError(f"depth must be one of {sorted(RESNET_LAYERS)}")
    layers, kind = RESNET_LAYERS[depth]
    if (groups != 1 or width_per_group != 64) and kind != "bottleneck":
        raise ValueError("groups/width_per_group need a bottleneck depth "
                         "(50/101/152)")
    # canonical ResNet: conv biases off when a norm follows each conv
    bias = not bool(norm)
    arch: List[Any] = [
        _conv("stem", width, 7, stride=2, bias=bias),
        {"max_pooling": ["stem_pool", {"kernel_size": [3, 3],
                                       "stride": [2, 2], "padding": 1}]},
    ]
    expansion = 4 if kind == "bottleneck" else 1
    in_name = "stem_pool"  # previous block output node
    c_in = width

    for s, n_blocks in enumerate(layers):
        c_mid = width * 2 ** s
        c_out = c_mid * expansion
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            blk = f"s{s}b{b}"
            prev = in_name  # block input (addressable for the shortcut)
            # ---- main path ------------------------------------------------ #
            if kind == "bottleneck":
                # torchvision Bottleneck width: planes * wpg/64 * groups
                c_w = int(c_mid * (width_per_group / 64.0)) * groups
                arch.append(_conv(f"{blk}_c1", c_w, 1, stride=1, bias=bias))
                arch.append(_conv(f"{blk}_c2", c_w, 3, stride=stride,
                                  groups=groups, bias=bias))
                arch.append(_conv(f"{blk}_c3", c_out, 1, act=False, bias=bias))
            else:
                arch.append(_conv(f"{blk}_c1", c_out, 3, stride=stride, bias=bias))
                arch.append(_conv(f"{blk}_c2", c_out, 3, act=False, bias=bias))
            main = f"{blk}_c3" if kind == "bottleneck" else f"{blk}_c2"
            # projection only when the shortcut must change shape (identity
            # otherwise — e.g. resnet18 stage 0, exactly like torchvision)
            needs_proj = b == 0 and (stride != 1 or c_in != c_out)
            if needs_proj:
                # ---- projection shortcut on a new branch from the input --- #
                arch.append({"_new_branch_from_tensor":
                             [f"{blk}_branch", {"_from": prev}]})
                arch.append(_conv(f"{blk}_proj", c_out, 1, stride=stride,
                                  act=False, bias=bias))
                arch.append({"residual_link":
                             [f"{blk}_sum", {"_from": main}]})
            else:
                arch.append({"residual_link":
                             [f"{blk}_sum", {"_from": prev}]})
            arch.append({"activation": [f"{blk}_out", {}]})
            in_name = f"{blk}_out"
            c_in = c_out

    # global average pool over the remaining spatial dims, then the head
    # (224 input -> 7 here; pass pool_kernel = input//32 for other sizes)
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None}})

    hp: Dict[str, Any] = {"act_fn": "relu", "architecture": arch}
    if norm:
        hp[norm] = _norm_hp(norm, num_groups=32)
    return hp

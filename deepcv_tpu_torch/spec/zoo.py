"""Programmatic model-zoo specs on top of the YAML spec language.

Counterpart of ``deepcv_tpu/spec/zoo.py`` (``resnet_spec``,
``RESNET_LAYERS``, ``vit_spec``, ``VIT_SETTINGS``), copied so that the port
imports nothing of the JAX package: these functions emit plain architecture
lists, the same dicts a user could write in YAML. The layer unit applies op
-> act -> norm, so a bottleneck is conv -> relu -> bn; parameter counts are
torchvision's (resnet_spec(50) has 25,557,032, vit_spec('b_16') at 224x224
has 86,567,656).
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["resnet_spec", "RESNET_LAYERS", "vit_spec", "VIT_SETTINGS"]

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


#: ViT variants (Dosovitskiy et al., arXiv:2010.11929; torchvision naming):
#: (patch, layers, heads, hidden dim, mlp dim)
VIT_SETTINGS = {
    "b_16": (16, 12, 12, 768, 3072),
    "b_32": (32, 12, 12, 768, 3072),
    "l_16": (16, 24, 16, 1024, 4096),
    "l_32": (32, 24, 16, 1024, 4096),
    "h_14": (14, 32, 16, 1280, 5120),
}

#: vit_spec's V-MoE arguments at their defaults: the MoE MLP is not ported
_MOE_DEFAULTS = {"moe_experts": 0, "moe_every": 2, "moe_k": 1,
                 "moe_capacity_factor": 1.25, "moe_router_noise": 0.0,
                 "moe_group_size": 0}


def vit_spec(variant: str = "b_16", num_classes: int = 1000,
             dropout: float = 0.0, attn_dropout: float = 0.0,
             stochastic_depth: float = 0.0,
             attn_impl: str = "xla",
             moe_experts: int = 0, moe_every: int = 2, moe_k: int = 1,
             moe_capacity_factor: float = 1.25,
             moe_router_noise: float = 0.0,
             moe_group_size: int = 0,
             mlp_act: str = "gelu",
             norm: str = "layer_norm") -> Dict[str, Any]:
    """Vision Transformer, torchvision's ``VisionTransformer`` wiring: patch
    embed (+[cls] + learned position table), ``layers`` pre-LN encoder
    blocks (exact-GELU MLP unless ``mlp_act='gelu_tanh'``), final norm (eps
    1e-6), [cls] token -> Linear head. ``attn_impl='flash'`` runs every
    block's attention through the flash-attention kernels. The V-MoE
    arguments are accepted at their defaults only: anything else raises."""
    moe = {"moe_experts": moe_experts, "moe_every": moe_every, "moe_k": moe_k,
           "moe_capacity_factor": moe_capacity_factor,
           "moe_router_noise": moe_router_noise, "moe_group_size": moe_group_size}
    bad = sorted(k for k, v in moe.items() if v != _MOE_DEFAULTS[k])
    if bad:
        raise NotImplementedError(f"vit_spec: {bad} (V-MoE) are not ported yet")
    if variant not in VIT_SETTINGS:
        raise ValueError(f"variant must be one of {sorted(VIT_SETTINGS)}, "
                         f"got {variant!r}")
    patch, layers, heads, hidden, mlp = VIT_SETTINGS[variant]
    arch: List[Any] = [
        {"patch_embed": ["embed", {"patch_size": patch, "embed_dim": hidden,
                                   "dropout_prob": dropout}]},
    ]
    for i in range(layers):
        # stochastic depth with the standard linear ramp: block i drops its
        # residual branches with prob p * i / (L - 1)
        dp = stochastic_depth * i / max(1, layers - 1)
        node = {"num_heads": heads, "mlp_dim": mlp,
                "dropout_prob": dropout,
                "attn_dropout_prob": attn_dropout,
                "drop_path_prob": round(dp, 6),
                "attn_impl": attn_impl}
        if mlp_act != "gelu":
            node["mlp_act"] = mlp_act
        if norm != "layer_norm":
            node["norm"] = norm
        arch.append({"transformer_block": [f"enc{i}", node]})
    arch.append({"norm": ["final_ln", {norm: {"eps": 1e-6}}]})
    arch.append({"take_token": {"index": 0}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None}})
    # the global act_fn is unused by the transformer nodes but required by
    # the engine; dropout rides per node
    return {"act_fn": "gelu", "architecture": arch, "dropout_prob": 0.0}

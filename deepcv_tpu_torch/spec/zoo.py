"""Programmatic model-zoo specs on top of the YAML spec language.

Counterpart of ``deepcv_tpu/spec/zoo.py`` (``resnet_spec``,
``RESNET_LAYERS``, ``vit_spec``, ``VIT_SETTINGS``, ``_make_divisible``,
``mobilenet_v2_spec``, ``efficientnet_b0_spec``, ``mobilenet_v3_spec``,
``convnext_spec``, ``swin_spec``, ``densenet_spec``, ``unet_spec`` and
their settings tables), copied so
that the port imports nothing of the JAX package: these functions emit
plain architecture lists, the same dicts a user could write in YAML and the
same dicts the JAX builders return for the same arguments. The layer unit
applies op -> act -> norm, so a bottleneck is conv -> relu -> bn; parameter
counts are torchvision's (resnet_spec(50) has 25,557,032, vit_spec('b_16')
at 224x224 has 86,567,656, mobilenet_v2_spec() 3,504,872,
mobilenet_v3_spec() 5,483,032 and ('small') 2,542,856,
efficientnet_b0_spec() 5,288,548, densenet_spec(121 / 169 / 201)
7,978,856 / 14,149,480 / 20,013,928, convnext_spec('tiny') 28,589,128,
swin_spec('t' / 's' / 'b') 28,288,354 / 49,606,258 / 87,768,224). vit_spec's
V-MoE arguments put an expert mixture in every ``moe_every``-th block
(bench.py config 13's ViT-B/16 with 8 experts on every 2nd block has
284,946,664). unet_spec() at 256x256 has 7,849,568 parameters, 7,849,700
with ``create_segmenter``'s 4-class head: the JAX model's 7,851,140 less
the 1,440 weights of its first conv's zero-padded input rows.
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["resnet_spec", "RESNET_LAYERS", "vit_spec", "VIT_SETTINGS",
           "mobilenet_v2_spec", "MOBILENET_V2_SETTINGS", "efficientnet_b0_spec",
           "EFFICIENTNET_B0_SETTINGS", "mobilenet_v3_spec", "MOBILENET_V3_SETTINGS",
           "convnext_spec", "CONVNEXT_SETTINGS", "swin_spec", "SWIN_SETTINGS",
           "densenet_spec", "DENSENET_SETTINGS", "unet_spec"]

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
    block's attention through the flash-attention kernels.

    V-MoE (Riquelme et al., arXiv:2106.05974): ``moe_experts`` > 0 swaps
    the MLP of every ``moe_every``-th block, counted from the back, for a
    top-``moe_k`` mixture of that many experts (ops/moe.py), routed in
    groups of whole images of at most ``moe_group_size`` tokens (0: one
    group); training adds ``hp['moe_aux_weight']`` times the mean
    load-balance loss to the objective."""
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
        # V-MoE placement: every moe_every-th block, counted from the back
        if moe_experts and (layers - 1 - i) % max(1, int(moe_every)) == 0:
            node["moe"] = {"num_experts": int(moe_experts), "k": int(moe_k),
                           "capacity_factor": float(moe_capacity_factor),
                           "router_noise": float(moe_router_noise),
                           "group_size": int(moe_group_size)}
        arch.append({"transformer_block": [f"enc{i}", node]})
    arch.append({"norm": ["final_ln", {norm: {"eps": 1e-6}}]})
    arch.append({"take_token": {"index": 0}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None}})
    # the global act_fn is unused by the transformer nodes but required by
    # the engine; dropout rides per node
    return {"act_fn": "gelu", "architecture": arch, "dropout_prob": 0.0}


#: MobileNetV2 inverted-residual settings (arXiv:1801.04381 table 2):
#: (expansion t, out channels c, repeats n, first stride s)
MOBILENET_V2_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                         (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                         (6, 320, 1, 1))


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding (all widths multiples of 8, never
    rounding below 90% of the target)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def mobilenet_v2_spec(num_classes: int = 1000, width_mult: float = 1.0,
                      norm: str = "batch_norm", pool_kernel: int = 7,
                      dropout: float = 0.2) -> Dict[str, Any]:
    """MobileNetV2 (Sandler et al., arXiv:1801.04381). Blocks: [1x1 expand
    t*c_in + relu6] -> 3x3 depthwise (``groups`` = channels) stride s +
    relu6 -> 1x1 linear projection (no act), with an identity residual iff
    stride 1 and c_in == c_out; stem 3x3 s2, head 1x1 to 1280, global pool,
    dropout, classifier. Channel widths use torchvision's multiple-of-8
    rounding, so width_mult=1.0 has torchvision mobilenet_v2's 3,504,872
    parameters. The 1x1 convs (expand, project, head) take K2, the relu6
    in its epilogue; the depthwise and strided convs ``F.conv2d``.
    ``pool_kernel`` = input_size // 32."""
    bias = not bool(norm)
    c_in = _make_divisible(32 * width_mult)
    arch: List[Any] = [_conv("stem", c_in, 3, stride=2, bias=bias)]
    in_name = "stem"

    for s, (t, c, n, stride0) in enumerate(MOBILENET_V2_SETTINGS):
        c_out = _make_divisible(c * width_mult)
        for b in range(n):
            stride = stride0 if b == 0 else 1
            blk = f"ir{s}b{b}"
            prev = in_name
            c_exp = c_in * t
            if t != 1:
                arch.append(_conv(f"{blk}_exp", c_exp, 1, bias=bias))
            arch.append(_conv(f"{blk}_dw", c_exp, 3, stride=stride,
                              groups=c_exp, bias=bias))
            # linear bottleneck: no activation after the projection
            arch.append(_conv(f"{blk}_proj", c_out, 1, act=False, bias=bias))
            if stride == 1 and c_in == c_out:
                arch.append({"residual_link": [f"{blk}_sum", {"_from": prev}]})
                in_name = f"{blk}_sum"
            else:
                in_name = f"{blk}_proj"
            c_in = c_out

    arch.append(_conv("head", _make_divisible(1280 * max(1.0, width_mult)),
                      1, bias=bias))
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None,
                                     "dropout_prob": dropout}})

    hp: Dict[str, Any] = {"act_fn": "relu6", "architecture": arch,
                          "dropout_prob": 0.0}
    if norm:
        hp[norm] = _norm_hp(norm, num_groups=8)
    return hp


#: EfficientNet-B0 MBConv settings (Tan & Le, arXiv:1905.11946 table 1):
#: (expansion t, out channels c, repeats n, first stride s, kernel k)
EFFICIENTNET_B0_SETTINGS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3),
                            (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
                            (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
                            (6, 320, 1, 1, 3))


def efficientnet_b0_spec(num_classes: int = 1000, norm: str = "batch_norm",
                         pool_kernel: int = 7,
                         dropout: float = 0.2) -> Dict[str, Any]:
    """EfficientNet-B0 (Tan & Le, arXiv:1905.11946): MBConv = the
    MobileNetV2 inverted residual + a squeeze-excitation cell between the
    depthwise conv and the linear projection (SE hidden width = block input
    channels // 4, silu inside), silu activations, 3x3/5x5 depthwise
    kernels per stage; torchvision efficientnet_b0's 5,288,548 parameters.
    width_mult is fixed at B0's 1.0; stochastic depth is not emitted.
    ``pool_kernel`` = input_size // 32."""
    bias = not bool(norm)
    c_in = _make_divisible(32)
    arch: List[Any] = [_conv("stem", c_in, 3, stride=2, bias=bias)]
    in_name = "stem"

    for s, (t, c, n, stride0, k) in enumerate(EFFICIENTNET_B0_SETTINGS):
        c_out = _make_divisible(c)
        for b in range(n):
            stride = stride0 if b == 0 else 1
            blk = f"mb{s}b{b}"
            prev = in_name
            c_exp = c_in * t
            if t != 1:
                arch.append(_conv(f"{blk}_exp", c_exp, 1, bias=bias))
            arch.append(_conv(f"{blk}_dw", c_exp, k, stride=stride,
                              groups=c_exp, bias=bias))
            # SE hidden = block input channels // 4 = c_exp // (4*t)
            arch.append({"squeeze_cell": [f"{blk}_se",
                                          {"reduction_ratio": 4 * t}]})
            arch.append(_conv(f"{blk}_proj", c_out, 1, act=False, bias=bias))
            if stride == 1 and c_in == c_out:
                arch.append({"residual_link": [f"{blk}_sum", {"_from": prev}]})
                in_name = f"{blk}_sum"
            else:
                in_name = f"{blk}_proj"
            c_in = c_out

    arch.append(_conv("head", _make_divisible(1280), 1, bias=bias))
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None,
                                     "dropout_prob": dropout}})

    hp: Dict[str, Any] = {"act_fn": "silu", "architecture": arch,
                          "dropout_prob": 0.0}
    if norm:
        hp[norm] = _norm_hp(norm, num_groups=8)
    return hp


#: MobileNetV3 per-block settings (Howard et al., arXiv:1905.02244 tables
#: 1-2, torchvision _mobilenet_v3_conf ordering): each row is
#: (kernel k, expanded channels, out channels, use_se, act name, stride).
#: The classifier hidden width (1280 large / 1024 small) follows the rows.
MOBILENET_V3_SETTINGS = {
    "large": (((3, 16, 16, False, "relu", 1),
               (3, 64, 24, False, "relu", 2),
               (3, 72, 24, False, "relu", 1),
               (5, 72, 40, True, "relu", 2),
               (5, 120, 40, True, "relu", 1),
               (5, 120, 40, True, "relu", 1),
               (3, 240, 80, False, "hard_swish", 2),
               (3, 200, 80, False, "hard_swish", 1),
               (3, 184, 80, False, "hard_swish", 1),
               (3, 184, 80, False, "hard_swish", 1),
               (3, 480, 112, True, "hard_swish", 1),
               (3, 672, 112, True, "hard_swish", 1),
               (5, 672, 160, True, "hard_swish", 2),
               (5, 960, 160, True, "hard_swish", 1),
               (5, 960, 160, True, "hard_swish", 1)), 1280),
    "small": (((3, 16, 16, True, "relu", 2),
               (3, 72, 24, False, "relu", 2),
               (3, 88, 24, False, "relu", 1),
               (5, 96, 40, True, "hard_swish", 2),
               (5, 240, 40, True, "hard_swish", 1),
               (5, 240, 40, True, "hard_swish", 1),
               (5, 120, 48, True, "hard_swish", 1),
               (5, 144, 48, True, "hard_swish", 1),
               (5, 288, 96, True, "hard_swish", 2),
               (5, 576, 96, True, "hard_swish", 1),
               (5, 576, 96, True, "hard_swish", 1)), 1024),
}


def mobilenet_v3_spec(variant: str = "large", num_classes: int = 1000,
                      width_mult: float = 1.0, norm: str = "batch_norm",
                      pool_kernel: int = 7,
                      dropout: float = 0.2) -> Dict[str, Any]:
    """MobileNetV3 (Howard et al., arXiv:1905.02244). Over MobileNetV2's
    inverted residual: hard_swish activations on the later stages (relu on
    the early rows, set per conv), 5x5 depthwise kernels, and SE cells
    between the depthwise conv and the linear projection with squeeze width
    ``_make_divisible(c_exp // 4)`` (pinned by ``hidden_channels``), relu
    inside and a hard-sigmoid gate. Head: 1x1 conv to 6x the last block
    width (+ norm + hard_swish), global pool, then a norm-free classifier
    pair FC(-> 1280 large / 1024 small) + hard_swish + dropout + FC(->
    classes). At width_mult=1.0 torchvision's mobilenet_v3_large 5,483,032
    / mobilenet_v3_small 2,542,856 parameters. ``pool_kernel`` =
    input_size // 32."""
    if variant not in MOBILENET_V3_SETTINGS:
        raise ValueError(f"variant must be one of "
                         f"{sorted(MOBILENET_V3_SETTINGS)}, got {variant!r}")
    settings, last_channel = MOBILENET_V3_SETTINGS[variant]

    def adj(v):                    # torchvision adjust_channels
        return _make_divisible(v * width_mult)

    bias = not bool(norm)
    c_in = adj(16)
    arch: List[Any] = [_conv("stem", c_in, 3, stride=2, bias=bias)]
    in_name = "stem"

    for i, (k, exp, c, use_se, act, stride) in enumerate(settings):
        c_exp, c_out = adj(exp), adj(c)
        blk = f"ir{i}"
        prev = in_name
        for nm, spec in (
                [(f"{blk}_exp", _conv(f"{blk}_exp", c_exp, 1, bias=bias))]
                if c_exp != c_in else []) + [
                (f"{blk}_dw", _conv(f"{blk}_dw", c_exp, k, stride=stride,
                                    groups=c_exp, bias=bias))]:
            if act != "hard_swish":      # global act is hard_swish
                spec["conv2d"][1]["act_fn"] = act
            arch.append(spec)
        if use_se:
            arch.append({"squeeze_cell": [
                f"{blk}_se", {"hidden_channels": _make_divisible(c_exp // 4),
                              "act_fn": "relu", "gate_fn": "hard_sigmoid"}]})
        arch.append(_conv(f"{blk}_proj", c_out, 1, act=False, bias=bias))
        if stride == 1 and c_in == c_out:
            arch.append({"residual_link": [f"{blk}_sum", {"_from": prev}]})
            in_name = f"{blk}_sum"
        else:
            in_name = f"{blk}_proj"
        c_in = c_out

    arch.append(_conv("head", 6 * c_in, 1, bias=bias))
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"fully_connected": [
        "pre_classifier", {"out_features": adj(last_channel),
                           "batch_norm": None, "group_norm": None}]})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None,
                                     "dropout_prob": dropout}})

    hp: Dict[str, Any] = {"act_fn": "hard_swish", "architecture": arch,
                          "dropout_prob": 0.0}
    if norm:
        hp[norm] = _norm_hp(norm, num_groups=8)
    return hp


#: ConvNeXt variants (Liu et al., arXiv:2201.03545; torchvision naming):
#: (blocks per stage, dims per stage)
CONVNEXT_SETTINGS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}


def convnext_spec(variant: str = "tiny", num_classes: int = 1000,
                  stochastic_depth: float = 0.1,
                  pool_kernel: int = 7,
                  norm: str = "layer_norm") -> Dict[str, Any]:
    """ConvNeXt (Liu et al., arXiv:2201.03545): patchify stem (reshape +
    Dense + LayerNorm), per stage a downsampling (LayerNorm + 2x2 stride-2
    conv) and blocks of depthwise 7x7 + LayerNorm + inverted 4x MLP (exact
    GELU) + layer scale + drop path; torchvision's parameter counts.
    ``stochastic_depth`` ramps linearly over all blocks (0.1 is
    torchvision's convnext_tiny default); ``norm='rms_norm'`` swaps the
    blocks' norms. Head: global average pool -> flatten -> LayerNorm(1e-6)
    -> Linear. No conv of it takes K2. ``pool_kernel`` = input_size //
    32."""
    if variant not in CONVNEXT_SETTINGS:
        raise ValueError(f"variant must be one of "
                         f"{sorted(CONVNEXT_SETTINGS)}, got {variant!r}")
    blocks, dims = CONVNEXT_SETTINGS[variant]
    total = sum(blocks)
    arch: List[Any] = [
        {"convnext_stem": ["stem", {"dim": dims[0], "patch": 4}]},
    ]
    bi = 0
    for s, (n_blocks, dim) in enumerate(zip(blocks, dims)):
        if s > 0:
            arch.append({"convnext_downsample": [f"down{s}", {"dim": dim}]})
        for b in range(n_blocks):
            dp = stochastic_depth * bi / max(1, total - 1)
            node: Dict[str, Any] = {"drop_path_prob": round(dp, 6)}
            if norm != "layer_norm":
                node["norm"] = norm
            arch.append({"convnext_block": [f"s{s}b{b}", node]})
            bi += 1
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"norm": ["head_ln", {"layer_norm": {"eps": 1e-6}}]})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None}})
    return {"act_fn": "gelu_exact", "architecture": arch,
            "dropout_prob": 0.0}


#: Swin variants (Liu et al., arXiv:2103.14030; torchvision naming):
#: (embed dim, depths per stage, heads per stage)
SWIN_SETTINGS = {
    "t": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "s": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "b": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}


def swin_spec(variant: str = "t", num_classes: int = 1000,
              window: int = 7, stochastic_depth: float = 0.2,
              pool_kernel: int = 7,
              norm: str = "layer_norm") -> Dict[str, Any]:
    """Swin Transformer: patchify stem (reshape + Dense + LayerNorm, the
    ConvNeXt stem at eps 1e-5), stages of W-MSA/SW-MSA pairs (shift =
    window // 2 on odd blocks, relative-position bias inside windows),
    PatchMerging (2x2 concat + LN + bias-free 2C Linear) between stages,
    final LN on the map, global pool, Linear head. Stochastic depth ramps
    linearly over all blocks (torchvision's 0.2 for swin_t). Parameter
    counts at 224 are torchvision's (swin_t 28,288,354). ``pool_kernel`` =
    input_size // 32; every stage's map must stay divisible by ``window``
    (224 -> 56/28/14/7 with window 7)."""
    if variant not in SWIN_SETTINGS:
        raise ValueError(f"variant must be one of {sorted(SWIN_SETTINGS)}, "
                         f"got {variant!r}")
    dim, depths, heads = SWIN_SETTINGS[variant]
    total = sum(depths)
    arch: List[Any] = [
        {"convnext_stem": ["stem", {"dim": dim, "patch": 4, "ln_eps": 1e-5}]},
    ]
    bi = 0
    for s, (n_blocks, nh) in enumerate(zip(depths, heads)):
        if s > 0:
            arch.append({"patch_merging": [f"merge{s}", {}]})
        for b in range(n_blocks):
            dp = stochastic_depth * bi / max(1, total - 1)
            node = {"num_heads": nh, "window": window,
                    "shift": 0 if b % 2 == 0 else window // 2,
                    "drop_path_prob": round(dp, 6)}
            if norm != "layer_norm":
                node["norm"] = norm
            arch.append({"swin_block": [f"s{s}b{b}", node]})
            bi += 1
    arch.append({"norm": ["head_ln", {"layer_norm": {"eps": 1e-5}}]})
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None}})
    return {"act_fn": "gelu_exact", "architecture": arch,
            "dropout_prob": 0.0}


#: DenseNet variants (Huang et al., arXiv:1608.06993; torchvision naming):
#: (growth rate k, layers per dense block)
DENSENET_SETTINGS = {
    121: (32, (6, 12, 24, 16)),
    169: (32, (6, 12, 32, 32)),
    201: (32, (6, 12, 48, 32)),
}


def densenet_spec(depth: int = 121, num_classes: int = 1000,
                  norm: str = "batch_norm",
                  pool_kernel: int = 7) -> Dict[str, Any]:
    """DenseNet (Huang et al., arXiv:1608.06993): every dense-block layer's
    input is the concat of the block input and all earlier layer outputs,
    in torch's channel order; layers are BN-ReLU-Conv (``preactivation:
    true``), a 1x1 bottleneck to 4k then a 3x3 to k = growth; transitions
    halve the channels (BN-ReLU-1x1) and average-pool; a final BN-ReLU
    before the classifier. torchvision's counts: densenet121 7,978,856 /
    densenet169 14,149,480 / densenet201 20,013,928. Every conv but the
    7x7 stride-2 stem takes K2, with no activation in its epilogue (the
    relu runs before the conv). ``pool_kernel`` = input_size // 32."""
    if depth not in DENSENET_SETTINGS:
        raise ValueError(f"depth must be one of {sorted(DENSENET_SETTINGS)}, "
                         f"got {depth}")
    k, blocks = DENSENET_SETTINGS[depth]
    c = 2 * k

    norm = norm or "batch_norm"     # preactivation needs some norm
    norm_spec = _norm_hp(norm)

    def pre_conv(name, out_ch, ksize):
        return {"conv2d": [name, {"kernel_size": [ksize, ksize],
                                  "out_channels": out_ch,
                                  "padding": ksize // 2,
                                  "use_bias": False,
                                  "preactivation": True}]}

    # stem in torch's order: conv0 -> norm0 -> relu0 -> pool0 (standalone
    # norm and activation nodes; a layer unit would emit conv -> relu -> BN)
    arch: List[Any] = [
        {"conv2d": ["stem", {"kernel_size": [7, 7], "out_channels": c,
                             "stride": 2, "padding": 3, "use_bias": False,
                             "act_fn": None, "batch_norm": None}]},
        {"norm": ["stem_bn", {norm: dict(norm_spec)}]},
        {"activation": ["stem_relu", {}]},
        {"max_pooling": ["stem_pool", {"kernel_size": [3, 3],
                                       "stride": [2, 2], "padding": 1}]},
    ]
    in_name = "stem_pool"
    for s, n_layers in enumerate(blocks):
        feats = [in_name]            # the dense block's growing feature set
        for l in range(n_layers):
            blk = f"d{s}l{l}"
            if len(feats) > 1:
                # restart the stream from the concat of the block input and
                # every earlier output, in torch's channel order
                arch.append({"_new_branch_from_tensor":
                             [f"{blk}_cat", {"_from": list(feats),
                                             "reduction": "concat"}]})
            arch.append(pre_conv(f"{blk}_b", 4 * k, 1))
            arch.append(pre_conv(f"{blk}_c", k, 3))
            feats.append(f"{blk}_c")
        c = c + n_layers * k
        # final concat of the block feeds the transition / head
        arch.append({"_new_branch_from_tensor":
                     [f"t{s}_in", {"_from": list(feats),
                                   "reduction": "concat"}]})
        if s < len(blocks) - 1:
            c = c // 2
            arch.append(pre_conv(f"t{s}_conv", c, 1))
            arch.append({"average_pooling": [f"t{s}_pool",
                                             {"kernel_size": [2, 2],
                                              "stride": [2, 2]}]})
            in_name = f"t{s}_pool"
    # final BN-ReLU (torch: features.norm5 + relu), pool, classifier
    arch.append({"norm": ["final_bn", {norm: dict(norm_spec)}]})
    arch.append({"activation": ["final_relu", {}]})
    arch.append({"average_pooling": {"kernel_size": [pool_kernel, pool_kernel],
                                     "stride": [pool_kernel, pool_kernel]}})
    arch.append({"flatten": {}})
    arch.append({"fully_connected": {"out_features": num_classes,
                                     "act_fn": None, "batch_norm": None,
                                     "group_norm": None}})
    hp: Dict[str, Any] = {"act_fn": "relu", "architecture": arch,
                          "dropout_prob": 0.0}
    hp[norm] = dict(norm_spec)
    return hp


def unet_spec(depth: int = 4, base_channels: int = 32,
              norm: str = "group_norm") -> Dict[str, Any]:
    """U-Net (Ronneberger et al., arXiv:1505.04597): the encoder halves the
    resolution per level (double 3x3 conv, then a 2x2 max pool), the
    decoder doubles it (an ``interpolate`` node, bilinear), concatenates
    the matching encoder output (``dense_link``) and runs a double conv.
    The output keeps the input's resolution and ``base_channels`` width;
    ``create_segmenter`` appends the 1x1 class conv. H and W must be
    divisible by 2**depth. Group norm (8 groups) by default; the convs
    have no bias when a norm follows."""
    arch: List[Any] = []
    c = int(base_channels)
    bias = not bool(norm)

    def double_conv(prefix, out_ch):
        arch.append(_conv(f"{prefix}a", out_ch, 3, bias=bias))
        arch.append(_conv(f"{prefix}b", out_ch, 3, bias=bias))

    enc_names = []
    for d in range(depth):
        double_conv(f"enc{d}_", c * 2 ** d)
        enc_names.append(f"enc{d}_b")
        arch.append({"max_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}})
    double_conv("mid_", c * 2 ** depth)
    for d in reversed(range(depth)):
        arch.append({"interpolate": {"scale": 2}})
        arch.append({"dense_link": [f"dec{d}_cat", {"_from": enc_names[d]}]})
        double_conv(f"dec{d}_", c * 2 ** d)
    hp: Dict[str, Any] = {"act_fn": "relu", "architecture": arch, "dropout_prob": 0.0}
    if norm:
        hp[norm] = _norm_hp(norm, num_groups=8)
    return hp

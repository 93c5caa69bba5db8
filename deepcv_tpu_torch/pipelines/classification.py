"""Image-classification pipelines: ``train_image_classifier`` (CIFAR-10),
``train_image_classifier_cifar100``, the wide classifiers on CIFAR-10
(``train_wide_classifier`` with batch norm, ``_gn`` with group norm, ``_ws``
with weight norm and no activation norm; all three trained with the
``train_wide_classifier`` hp), the ImageNet-224 zoo pipelines trained with
the ``train_resnet50`` hp (``train_resnet50``, ``train_vit``,
``train_mobilenet_v2``, ``train_mobilenet_v3``, ``train_convnext``,
``train_swin``, ``train_densenet``) and the preprocess-only
``preprocess_cifar10``, ``preprocess_cifar100`` and ``preprocess_mnist``:
all fifteen of the JAX package's.

Counterpart of ``deepcv_tpu/pipelines/classification.py``
(``create_model``, ``train``, ``get_pipelines``): preprocess -> create the
model from its conf (the input shape and the head's width from the
dataset) -> train. ``create_model`` carries every zoo builder and plain
architecture specs, nested modules included. The ``vit`` builder also
takes vit_spec's V-MoE arguments (``moe_experts``, ``moe_every``,
``moe_k``, ``moe_capacity_factor``, ``moe_router_noise``,
``moe_group_size``), so ``--params vit_model.moe_experts:8`` trains a V-MoE;
the JAX package's ``create_model`` passes them to no builder.
"""
from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Mapping

from deepcv_tpu_torch.config import ConfigError
from deepcv_tpu_torch.pipelines.framework import Node, Pipeline, preprocess_node
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.losses import cross_entropy_loss
from deepcv_tpu_torch.train.metrics import accuracy
from deepcv_tpu_torch.train.training import train as train_fn

__all__ = ["get_pipelines", "create_model", "train", "PORTED_ZOO", "UNPORTED_ZOO"]

_logger = logging.getLogger(__name__)

#: the JAX package's zoo builders, ported and not
PORTED_ZOO = ("resnet", "vit", "mobilenet_v2", "mobilenet_v3", "efficientnet_b0",
              "densenet", "convnext", "swin")
UNPORTED_ZOO = ()
#: vit_spec's V-MoE arguments, which the ``vit`` builder takes from the conf
VIT_MOE_ARGS = {"moe_experts": int, "moe_every": int, "moe_k": int,
                "moe_capacity_factor": float, "moe_router_noise": float,
                "moe_group_size": int}


def _reject(zoo, hp, *keys):
    bad = [k for k in keys if k in hp]
    if bad:
        raise ValueError(f"zoo '{zoo}' does not accept {bad}")


def create_model(datasets: Mapping[str, Any], model_params: Mapping[str, Any],
                 device=None) -> DeepcvModule:
    """The classifier from its conf: a zoo builder (``zoo: <name>``, other
    keys its arguments; each builder refuses the keys of the others, as the
    JAX package's) or a plain spec; the last ``fully_connected`` gets the
    dataset's class count. ``dtype`` is the model's compute dtype."""
    trainset = datasets["trainset"]
    input_shape = trainset.image_shape
    num_classes = trainset.num_classes
    hp = copy.deepcopy(dict(model_params))
    zoo = hp.pop("zoo", None)
    if zoo:
        from deepcv_tpu_torch.spec import zoo as builders
        pool = max(1, input_shape[0] // 32)
        classes = num_classes or 1000
        if str(zoo) == "mobilenet_v2":
            _reject(zoo, hp, "depth", "variant", "window", "groups", "width_per_group")
            built = builders.mobilenet_v2_spec(
                num_classes=classes, width_mult=float(hp.pop("width_mult", 1.0)),
                norm=hp.pop("norm", "batch_norm"), pool_kernel=pool)
        elif str(zoo) == "efficientnet_b0":
            _reject(zoo, hp, "depth", "width_mult", "variant", "window", "groups",
                    "width_per_group")
            built = builders.efficientnet_b0_spec(
                num_classes=classes, norm=hp.pop("norm", "batch_norm"), pool_kernel=pool)
        elif str(zoo) == "mobilenet_v3":
            _reject(zoo, hp, "depth", "window", "groups", "width_per_group")
            built = builders.mobilenet_v3_spec(
                variant=str(hp.pop("variant", "large")), num_classes=classes,
                width_mult=float(hp.pop("width_mult", 1.0)),
                norm=hp.pop("norm", "batch_norm"), pool_kernel=pool)
        elif str(zoo) == "densenet":
            _reject(zoo, hp, "width_mult", "variant", "window", "groups", "width_per_group")
            built = builders.densenet_spec(depth=int(hp.pop("depth", 121)),
                                           num_classes=classes,
                                           norm=hp.pop("norm", "batch_norm"),
                                           pool_kernel=pool)
        elif str(zoo) == "convnext":
            _reject(zoo, hp, "depth", "width_mult", "norm", "window", "groups",
                    "width_per_group")
            built = builders.convnext_spec(
                variant=str(hp.pop("variant", "tiny")), num_classes=classes,
                stochastic_depth=float(hp.pop("stochastic_depth", 0.1)), pool_kernel=pool)
        elif str(zoo) == "swin":
            _reject(zoo, hp, "depth", "width_mult", "norm", "groups", "width_per_group")
            built = builders.swin_spec(
                variant=str(hp.pop("variant", "t")), num_classes=classes,
                window=int(hp.pop("window", 7)),
                stochastic_depth=float(hp.pop("stochastic_depth", 0.2)), pool_kernel=pool)
        elif str(zoo) == "vit":
            _reject(zoo, hp, "depth", "width_mult", "norm", "window", "groups",
                    "width_per_group")
            built = builders.vit_spec(variant=str(hp.pop("variant", "b_16")),
                                      num_classes=classes,
                                      dropout=float(hp.pop("dropout", 0.0)),
                                      attn_dropout=float(hp.pop("attn_dropout", 0.0)),
                                      stochastic_depth=float(hp.pop("stochastic_depth", 0.0)),
                                      attn_impl=str(hp.pop("attn_impl", "xla")),
                                      **{k: cast(hp.pop(k)) for k, cast in VIT_MOE_ARGS.items()
                                         if k in hp})
        elif str(zoo) == "resnet":
            _reject(zoo, hp, "width_mult", "variant", "window")
            built = builders.resnet_spec(depth=int(hp.pop("depth", 50)),
                                         num_classes=classes,
                                         norm=hp.pop("norm", "batch_norm"),
                                         groups=int(hp.pop("groups", 1)),
                                         width_per_group=int(hp.pop("width_per_group", 64)),
                                         pool_kernel=pool)
        else:
            raise ValueError(f"Unknown zoo builder '{zoo}' (known: "
                             f"{', '.join(PORTED_ZOO + UNPORTED_ZOO)})")
        built.update(hp)
        hp = built
    arch = hp.get("architecture", [])
    if arch is None or not isinstance(arch, (list, tuple)):
        raise ConfigError(
            "model hp 'architecture' must be a list of layer entries, got "
            f"{type(arch).__name__} ({arch!r}) — check your --params override "
            "or parameters.yml")
    _inject_out_features(arch, num_classes)
    dtype = hp.pop("dtype", None)
    # 'int8_qat' makes the training pipeline quantization-aware (fake quant,
    # straight-through estimator); 'int8' builds the inference-only w8a8
    # graph, which the training loop then refuses
    quantize = hp.pop("quantize", None)
    model = DeepcvModule(input_shape, hp, device=device, dtype=dtype, quantize=quantize)
    _logger.info("created model: %s params on %s", f"{model.capacity():,}", model.device)
    return model


def _inject_out_features(arch, num_classes: int) -> bool:
    """Set ``out_features`` on the last ``fully_connected`` entry if unset,
    looking into nested modules too."""
    for entry in reversed(list(arch)):
        if not isinstance(entry, Mapping):
            continue
        for key, val in entry.items():
            if key in ("fully_connected", "linear"):
                params = val[1] if isinstance(val, (list, tuple)) else val
                if params.get("out_features") is None:
                    params["out_features"] = int(num_classes)
                return True
            if str(key).startswith("_nested"):
                sub = val.get("architecture") if isinstance(val, Mapping) else val
                if sub and _inject_out_features(sub, num_classes):
                    return True
    return False


def train(datasets, model: DeepcvModule, hp: Mapping[str, Any], trackers=()):
    """Training node: cross-entropy, accuracy, ``train()``."""
    state, history = train_fn(hp, model, cross_entropy_loss, datasets,
                              metrics={"accuracy": accuracy}, loggers=list(trackers))
    return {"state": state, "history": history, "model": model}


def get_pipelines() -> Dict[str, Pipeline]:
    def preprocess_pipeline(ds: str, pp_key: str) -> Pipeline:
        return Pipeline([
            Node(preprocess_node, [f"{ds}_train", f"{ds}_test", f"params:{pp_key}"],
                 "datasets", name=f"preprocess_{ds}"),
        ], name=f"preprocess_{ds}", tags={"preprocess"})

    def train_pipeline(name: str, model_key: str, training_key: str, ds: str,
                       pp_key: str) -> Pipeline:
        return Pipeline([
            Node(preprocess_node, [f"{ds}_train", f"{ds}_test", f"params:{pp_key}"],
                 "datasets", name="preprocess", tags=("preprocess",)),
            Node(create_model, ["datasets", f"params:{model_key}", "device"],
                 "model", name="create_model", tags=("model",)),
            Node(train, ["datasets", "model", f"params:{training_key}", "trackers"],
                 "train_results", name="train", tags=("train",)),
        ], name=name, tags={"train", "classification"})

    return {
        "preprocess_cifar10": preprocess_pipeline("cifar10", "cifar10_preprocessing"),
        "preprocess_cifar100": preprocess_pipeline("cifar100", "cifar100_preprocessing"),
        "preprocess_mnist": preprocess_pipeline("mnist", "mnist_preprocessing"),
        "train_image_classifier": train_pipeline(
            "train_image_classifier", "image_classifier_model", "train_image_classifier",
            ds="cifar10", pp_key="cifar10_preprocessing"),
        "train_image_classifier_cifar100": train_pipeline(
            "train_image_classifier_cifar100", "image_classifier_model",
            "train_image_classifier", ds="cifar100", pp_key="cifar100_preprocessing"),
        **{f"train_wide_classifier{suffix}": train_pipeline(
            f"train_wide_classifier{suffix}", f"wide_classifier{suffix}_model",
            "train_wide_classifier", ds="cifar10", pp_key="cifar10_preprocessing")
           for suffix in ("", "_gn", "_ws")},
        "train_resnet50": train_pipeline(
            "train_resnet50", "resnet50_model", "train_resnet50",
            ds="imagenet224", pp_key="imagenet224_preprocessing"),
        **{f"train_{family}": train_pipeline(
            f"train_{family}", f"{family}_model", "train_resnet50",
            ds="imagenet224", pp_key="imagenet224_preprocessing")
           for family in ("vit", "mobilenet_v2", "mobilenet_v3", "convnext", "swin",
                          "densenet")},
    }

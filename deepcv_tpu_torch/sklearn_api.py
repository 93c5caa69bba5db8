"""scikit-learn estimator facade over the port's models, with fine-tuning.

Counterpart of ``deepcv_tpu/sklearn_api.py``: :class:`DeepcvClassifier`
follows the sklearn estimator protocol (``get_params``/``set_params``/
``fit``/``predict``/``predict_proba``/``score``, the learned label
vocabulary ``classes_``) without importing sklearn, so it drops into sklearn
pipelines, cross-validation and grid search where sklearn is installed and
works standalone where it is not. It trains with the port's ``train()``
and predicts through its ``Predictor``, on the card unless ``device``
says otherwise. ``fine_tune`` continues training the fitted model (whose
weights it holds) on a small dataset, the parameters whose JAX path
matches ``freeze_params`` frozen.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["DeepcvClassifier", "DEFAULT_CNN_HP"]

#: a compact default CNN for fit() without an explicit architecture
DEFAULT_CNN_HP: Dict[str, Any] = {
    "act_fn": "relu",
    "batch_norm": {"affine": True, "eps": 1e-5, "momentum": 0.1},
    "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 32, "padding": 1}},
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 32, "padding": 1}},
        {"average_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 64, "padding": 1}},
        {"average_pooling": {"kernel_size": [2, 2], "stride": [2, 2]}},
        {"flatten": {}},
        {"fully_connected": {"act_fn": None, "batch_norm": None}},
    ],
}


class DeepcvClassifier:
    """sklearn-style image classifier over the spec engine.

    * ``model_hp``: a spec dict (``architecture`` + globals), by default
      :data:`DEFAULT_CNN_HP`; its last ``fully_connected`` gets
      ``out_features`` from the labels seen in ``fit``.
    * ``zoo``/``zoo_kw``: a named zoo family instead (``'resnet'`` ->
      ``spec.zoo.resnet_spec``).
    * ``epochs``/``batch_size``/``lr``/``optimizer``/``validset_ratio``/
      ``seed``/``dtype``: the training knobs; ``hp``: extra ``train()``
      hyperparameters merged last.
    * ``device``: where the model trains and predicts (CUDA unless given).
    """

    _PARAM_NAMES = ("model_hp", "zoo", "zoo_kw", "epochs", "batch_size", "lr",
                    "optimizer", "validset_ratio", "seed", "dtype", "hp", "device")

    def __init__(self, model_hp: Optional[Mapping[str, Any]] = None,
                 zoo: Optional[str] = None, zoo_kw: Optional[Mapping[str, Any]] = None,
                 epochs: int = 5, batch_size: int = 64, lr: float = 1e-3,
                 optimizer: str = "adamw", validset_ratio: float = 0.1,
                 seed: int = 0, dtype: Optional[str] = None,
                 hp: Optional[Mapping[str, Any]] = None, device: Optional[str] = None):
        self.model_hp = model_hp
        self.zoo = zoo
        self.zoo_kw = zoo_kw
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.optimizer = optimizer
        self.validset_ratio = validset_ratio
        self.seed = seed
        self.dtype = dtype
        self.hp = hp
        self.device = device

    # ------------------------------------------------- sklearn protocol ----
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def set_params(self, **params) -> "DeepcvClassifier":
        for k, v in params.items():
            if k not in self._PARAM_NAMES:
                raise ValueError(f"Invalid parameter {k!r} for DeepcvClassifier "
                                 f"(valid: {self._PARAM_NAMES})")
            setattr(self, k, v)
        return self

    # -------------------------------------------------------- internals ----
    def _build_model_hp(self, n_classes: int) -> Dict[str, Any]:
        if self.zoo:
            from deepcv_tpu_torch.spec import zoo as zoo_mod
            builder = getattr(zoo_mod, f"{self.zoo}_spec", None)
            if builder is None:
                raise ValueError(f"unknown zoo family {self.zoo!r}")
            return builder(num_classes=n_classes, **dict(self.zoo_kw or {}))
        from deepcv_tpu_torch.pipelines.classification import _inject_out_features
        hp = copy.deepcopy(dict(self.model_hp or DEFAULT_CNN_HP))
        _inject_out_features(hp["architecture"], n_classes)
        return hp

    def _dataset(self, X, y=None):
        from deepcv_tpu_torch.data.datasets import ArrayDataset
        X = np.asarray(X)
        if X.ndim != 4:
            raise ValueError(f"X must be (N, H, W, C) images, got {X.shape}")
        if y is None:
            return X
        codes = np.searchsorted(self.classes_, np.asarray(y).reshape(-1))
        return ArrayDataset(X, codes.astype(np.int64),
                            classes=[str(c) for c in self.classes_], name="sklearn_fit")

    def _train(self, X, y, *, epochs=None, lr=None, freeze_params=None):
        from deepcv_tpu_torch.data.preprocess import preprocess
        from deepcv_tpu_torch.train.losses import cross_entropy_loss
        from deepcv_tpu_torch.train.training import train

        data = preprocess({"trainset": self._dataset(X, y)},
                          {"seed": self.seed,
                           "split_dataset": {"validset_ratio": float(self.validset_ratio)},
                           "transforms": ["to_tensor"]})
        # base defaults < self.hp < the call's explicit arguments
        hp = {"epochs": int(self.epochs), "batch_size": int(self.batch_size),
              "optimizer": self.optimizer, "optimizer_opts": {"lr": float(self.lr)},
              "save_every_iters": 0, "log_progress_every_iters": 1_000_000,
              "seed": self.seed, "dtype": self.dtype, "freeze_params": None,
              **dict(self.hp or {})}
        if epochs is not None:
            hp["epochs"] = int(epochs)
        if lr is not None:
            hp["optimizer_opts"] = {**hp.get("optimizer_opts", {}), "lr": float(lr)}
        if freeze_params is not None:
            hp["freeze_params"] = freeze_params
        _, hist = train(hp, self.model_, cross_entropy_loss, data)
        # predict through the transform chain training saw
        self._batch_transform = lambda x: data["trainset"].batch_transform(x, augment=False)
        self.history_ = hist
        self._predictor = None
        return self

    # ---------------------------------------------------------- fitting ----
    def fit(self, X, y) -> "DeepcvClassifier":
        from deepcv_tpu_torch.spec import DeepcvModule

        X = np.asarray(X)
        self.classes_ = np.unique(np.asarray(y).reshape(-1))
        if len(self.classes_) < 2:
            raise ValueError("fit needs at least 2 classes")
        self.model_ = DeepcvModule(tuple(X.shape[1:]),
                                   self._build_model_hp(len(self.classes_)),
                                   device=self.device, dtype=self.dtype,
                                   generator=torch.Generator().manual_seed(int(self.seed)))
        return self._train(X, y)

    def fine_tune(self, X, y, *, epochs: int = 2, lr: Optional[float] = None,
                  freeze_params: Optional[str] = None) -> "DeepcvClassifier":
        """Continue training the fitted model on (small) new data whose labels
        come from the fitted ``classes_``, at ``lr`` (a tenth of ``self.lr``
        unless given)."""
        self._check_fitted()
        unseen = set(np.unique(np.asarray(y).reshape(-1))) - set(self.classes_)
        if unseen:
            raise ValueError(f"fine_tune labels not in classes_: {unseen}")
        return self._train(X, y, epochs=epochs,
                           lr=float(lr if lr is not None else self.lr * 0.1),
                           freeze_params=freeze_params)

    # -------------------------------------------------------- inference ----
    def _check_fitted(self):
        if not hasattr(self, "history_"):
            raise RuntimeError("This DeepcvClassifier instance is not fitted yet; "
                               "call fit(X, y) first")

    def predict_proba(self, X) -> np.ndarray:
        self._check_fitted()
        if self._predictor is None:
            from deepcv_tpu_torch.serve import Predictor
            self._predictor = Predictor(self.model_, batch_size=int(self.batch_size),
                                        preprocess=self._batch_transform,
                                        device=self.model_.device)
        logits = self._predictor(self._dataset(X))
        return torch.softmax(torch.from_numpy(logits), dim=-1).numpy()

    def predict(self, X) -> np.ndarray:
        proba = self.predict_proba(X)
        return self.classes_[proba.argmax(axis=1)]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y).reshape(-1)))

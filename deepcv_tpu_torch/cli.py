"""Command-line interface of the port.

Counterpart of ``deepcv_tpu/cli.py``'s subcommands (``_parse_extra_params``,
``_cmd_predict``, ``_cmd_serve``, ``_cmd_search``, ``_default_space_path``,
``_cmd_lr_find``) but ``bench``, which waits for the port's benchmark.
Usage::

    python -m deepcv_tpu_torch run [--pipeline=train_vit] \\
        --params vit_model.attn_impl:flash,train_resnet50.epochs:1 \\
        [--from-nodes N1,N2] [--to-nodes N1,N2] [--only-nodes N1,N2] \\
        [--tags T1,T2] [--no-persist] [--device cuda] [--export DIR]
    python -m deepcv_tpu_torch list
    python -m deepcv_tpu_torch describe [--pipeline=train_vit]
    python -m deepcv_tpu_torch test [--quick | --full] [pytest args...]
    python -m deepcv_tpu_torch docs [--out docs/_build] [--project-path .]
    python -m deepcv_tpu_torch dashboard [--root data/04_training/experiments] \\
        [--port 8050] [--tensorboard LOGDIR]
    python -m deepcv_tpu_torch serve --bundle DIR [--port 8000] \\
        [--batch-size 256] [--to-tensor] [--normalize M1,M2,M3/S1,S2,S3] \\
        [--quantize int8] [--device cuda]
    python -m deepcv_tpu_torch predict --bundle DIR --input x.npy \\
        [--output predictions.npy] [--batch-size 256] [--dtype bfloat16] \\
        [--quantize int8 [--calibrate N]] [--to-tensor] [--normalize ...] \\
        [--decode segmentation|detection[:g1,g2,...] [--top-k 16] [--nms-iou 0.5]] \\
        [--device cuda]
    python -m deepcv_tpu_torch search --pipeline=train_image_classifier \
        [--space space.json] [--trials 8] [--tuner tpe|random|grid] \
        [--metric valid_accuracy] [--training-params-key K] [--model-params-key K] \
        [--output-dir data/04_training/hp_search] [--params ...] [--device cuda]
    python -m deepcv_tpu_torch lr-find --pipeline=train_image_classifier \
        [--steps 100] [--batch-size 64] [--out data/04_training/lr_range_test.png] \
        [--device cuda]

``search`` runs the pipeline once per trial in this process, each trial's
``model:``/``training:`` params set on the model and training hp keys (the
pipeline's own name for the training hp, ``<task>_model`` for the model's),
checkpoints off unless set, intermediates not persisted, ``--params`` under
every trial's; the trials go to ``--output-dir`` (``trials.jsonl``,
``summary.json``) and one JSON line sums the search up. The space defaults to
``conf/base/hp_search_spaces/<pipeline>_hp_search_space.json``, or the file
named after the pipeline without ``train_``. ``lr-find`` runs the LR range
test on the classifier and data of ``train_image_classifier`` (CIFAR-100's
for ``..._cifar100``), writes the curve (a CSV where matplotlib is missing)
and prints the suggestion as one JSON line.

``run`` and ``describe`` take ``__default__`` (every registered pipeline,
one after another) without ``--pipeline``. ``test`` runs the port's tests
(``tests/test_torch_*.py``) in the JAX package's tiers: the smoke tier
(``-m smoke``) by default, ``--quick`` everything but ``slow``, ``--full``
everything; explicit pytest arguments replace the tier's. ``docs`` renders
``docs/*.md``, ``README.md`` and ``PARITY.md`` to HTML; ``dashboard``
serves the runs of an ``ExperimentTracker`` store, and with
``--tensorboard`` starts TensorBoard on a logdir and links it.

``run`` prints one JSON line summing up the training run (a partial run
reads the outputs of the nodes it leaves out from the intermediate cache
that earlier runs wrote; ``--export`` bundles the EMA weights, or the
schedule-free averaged iterate, where training kept them); typed config
faults (a bad ``--params`` override, a malformed spec) exit with code 2 and
a one-line message. ``predict`` writes its predictions (an ``.npy``; int32
argmax masks with ``--decode segmentation``; an ``.npz`` of boxes, scores
and classes with ``--decode detection``) and prints one JSON line;
``--quantize int8`` serves the float bundle in w8a8 with dynamic activation
scales, or static ones recorded on the first ``--calibrate N`` inputs. A
``.y4m`` input is read as its (T, H, W, 3) uint8 RGB frames.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, List

__all__ = ["main", "run", "build_parser"]


def _parse_extra_params(entries: List[str]) -> Dict[str, Any]:
    """``--params a.b:3,c:x`` -> {'a.b': 3, 'c': 'x'}; values are YAML, and
    commas inside brackets or braces do not split."""
    import yaml

    from deepcv_tpu_torch.config import ConfigError

    def split_top_level(s: str):
        parts, depth, cur = [], 0, []
        for ch in s:
            if ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        parts.append("".join(cur))
        return parts

    out: Dict[str, Any] = {}
    for entry in entries:
        for pair in split_top_level(entry):
            if not pair.strip():
                continue
            if ":" not in pair:
                raise ConfigError(f"--params entry '{pair}' must be 'dotted.key:value'")
            k, v = pair.split(":", 1)
            if not k.strip():
                raise ConfigError(f"--params entry '{pair}' has an empty key")
            try:
                out[k.strip()] = yaml.safe_load(v.strip())
            except yaml.YAMLError as e:
                raise ConfigError(f"--params value for '{k.strip()}' is not valid "
                                  f"YAML: {e}") from e
    return out


def _context(args):
    from deepcv_tpu_torch.pipelines import ProjectContext

    return ProjectContext(args.project_path,
                          extra_params=_parse_extra_params(getattr(args, "params", [])),
                          device=getattr(args, "device", None))


def run(argv: List[str]) -> Dict[str, Any]:
    """Execute a ``run`` command line (without the ``run`` word) and return
    the pipeline's data store; ``--export DIR`` saves the trained model as a
    serving bundle."""
    args = build_parser().parse_args(["run", *argv])

    def csv(v):
        return tuple(s.strip() for s in v.split(",")) if v else ()

    store = _context(args).run(args.pipeline, from_nodes=csv(args.from_nodes),
                               to_nodes=csv(args.to_nodes), only_nodes=csv(args.only_nodes),
                               tags=csv(args.tags), persist_intermediates=not args.no_persist)
    if args.export:
        from deepcv_tpu_torch.serve import save_model_bundle

        results = store.get("train_results") or {}
        if "model" not in results:
            raise SystemExit("--export: the pipeline produced no trained model to bundle")
        state = results.get("state")
        with state.eval_weights() if hasattr(state, "eval_weights") else contextlib.nullcontext():
            store["bundle"] = save_model_bundle(args.export, results["model"])
    return store


def _summary(pipeline: str, store: Dict[str, Any]) -> Dict[str, Any]:
    h = (store.get("train_results") or {}).get("history") or {}
    return {"pipeline": pipeline, "steps": h.get("steps"),
            "train": h.get("train", [])[-1:] and h["train"][-1],
            "valid": h.get("valid", [])[-1:] and h["valid"][-1],
            "throughput_img_s": h.get("throughput_img_s"),
            "run_dir": h.get("run_dir"),
            "bundle": str(store["bundle"]) if "bundle" in store else None}


def _parse_normalize(spec: str):
    m_s, s_s = spec.split("/")
    return [float(v) for v in m_s.split(",")], [float(v) for v in s_s.split(",")]


def _not_a_bundle(bundle: str) -> bool:
    if (Path(bundle) / "model.yaml").exists():
        return False
    print(f"error: --bundle {bundle!r} is not a model bundle (no model.yaml; expected a "
          "directory from serve.save_model_bundle)", file=sys.stderr)
    return True


def _preprocess_from_args(args):
    """(ok, preprocess): ``--to-tensor`` then ``--normalize``, or None."""
    from deepcv_tpu_torch.data.transforms import normalize, to_tensor

    mean = std = None
    if args.normalize:
        try:
            mean, std = _parse_normalize(args.normalize)
        except ValueError:
            print("error: --normalize expects 'm1,m2,m3/s1,s2,s3'", file=sys.stderr)
            return False, None
    if not (args.to_tensor or args.normalize):
        return True, None

    def preprocess(x):
        x = to_tensor(x)
        return x if mean is None else normalize(x, mean, std)
    return True, preprocess


def serving_predictor(args):
    """The ``serve`` command's Predictor (None after a printed refusal): the
    bundle's model, in w8a8 with dynamic activation scales under
    ``--quantize int8``, as the JAX package serves it."""
    from deepcv_tpu_torch.serve import Predictor, load_model_bundle

    if _not_a_bundle(args.bundle):
        return None
    ok, preprocess = _preprocess_from_args(args)
    if not ok:
        return None
    model = load_model_bundle(args.bundle, device=args.device, quantize=args.quantize)
    return Predictor(model, batch_size=args.batch_size, preprocess=preprocess,
                     dtype=args.dtype, device=args.device)


def _cmd_serve(args) -> int:
    """Online serving: bundle -> Predictor -> micro-batching HTTP server."""
    from deepcv_tpu_torch.server import InferenceServer

    pred = serving_predictor(args)
    if pred is None:
        return 2
    model = pred.model
    server = InferenceServer(pred, port=args.port, host=args.host,
                             max_batch=args.batch_size,
                             max_wait_ms=args.max_wait_ms,
                             input_shape=tuple(model.input_shape))
    # one forward before the first request, so /healthz reporting ready
    # means serving latency is the steady-state one
    server.warmup()
    print(f"serving {args.bundle} at {server.url} on {pred.device} "
          f"(batch {args.batch_size}, window {args.max_wait_ms}ms)", flush=True)
    server.serve_forever()
    return 0


def _cmd_predict(args) -> int:
    """Batch inference: bundle + .npy images -> predictions on disk."""
    import numpy as np
    import torch

    from deepcv_tpu_torch.serve import Predictor, load_model_bundle

    if _not_a_bundle(args.bundle):
        return 2
    if not Path(args.input).exists():
        print(f"error: --input file not found: {args.input!r}", file=sys.stderr)
        return 2
    if args.batch_size < 1:
        print(f"error: --batch-size must be >= 1 (got {args.batch_size})", file=sys.stderr)
        return 2
    if args.decode and args.decode != "segmentation" \
            and str(args.decode).partition(":")[0] != "detection":
        print(f"error: unknown --decode mode {args.decode!r} "
              "(known: detection[:g1,g2,...], segmentation)", file=sys.stderr)
        return 2
    ok, preprocess = _preprocess_from_args(args)
    if not ok:
        return 2
    if str(args.input).lower().endswith(".y4m"):
        from deepcv_tpu_torch.data.video_io import read_y4m

        images, _ = read_y4m(args.input)
    else:
        images = np.load(args.input)
    if preprocess is None and images.dtype == np.uint8:
        print("note: uint8 input without --to-tensor/--normalize — the model receives "
              "raw 0-255 values; pass the transforms training used", file=sys.stderr)
    model = load_model_bundle(args.bundle, device=args.device, dtype=args.dtype,
                              quantize=args.quantize)
    if args.quantize and args.calibrate > 0:
        from deepcv_tpu_torch.compression import calibrate_int8_scales

        # calibrate the float build on exactly what inference feeds the model
        # (the same preprocess), then rebuild quantized with the scales; the
        # input keeps its dtype until then, so to_tensor still scales uint8
        fmodel = model.with_options(quantize=None, quantize_scales=None)
        cal = torch.from_numpy(np.ascontiguousarray(images[:args.calibrate])).to(fmodel.device)
        if preprocess is not None:
            cal = preprocess(cal)
        scales = calibrate_int8_scales(fmodel, [cal.float()])
        model = model.with_options(quantize=args.quantize, quantize_scales=scales)
    out = Predictor(model, batch_size=args.batch_size, preprocess=preprocess,
                    device=args.device)(images)
    if args.decode == "segmentation":
        masks = np.argmax(out, axis=-1).astype(np.int32)
        np.save(args.output, masks)
        print(json.dumps({"inputs": len(images), "output": args.output,
                          "mask_shape": list(masks.shape),
                          "classes_present": sorted(int(c) for c in np.unique(masks))}))
        return 0
    if args.decode:
        from deepcv_tpu_torch.pipelines.detection import (decode_detections,
                                                          decode_detections_flat)

        rest = str(args.decode).partition(":")[2]
        raw = torch.from_numpy(out.astype(np.float32))
        if rest:
            grids = tuple(int(g) for g in rest.split(","))
            boxes, scores, classes = decode_detections_flat(
                raw, grids, top_k=args.top_k, nms_iou=args.nms_iou)
        else:
            boxes, scores, classes = decode_detections(raw, top_k=args.top_k,
                                                       nms_iou=args.nms_iou)
        out_path = str(Path(args.output).with_suffix(".npz"))
        np.savez(out_path, boxes=boxes.numpy().astype(np.float32),
                 scores=scores.numpy().astype(np.float32),
                 classes=classes.numpy().astype(np.int32))
        print(json.dumps({"inputs": len(images), "output": out_path, "top_k": args.top_k,
                          "detections_kept": int((scores > 0).sum())}))
        return 0
    np.save(args.output, out)
    print(json.dumps({"inputs": len(images), "output": args.output,
                      "output_shape": list(out.shape)}))
    return 0


#: the conf key of each search pipeline's model hp (others: image_classifier_model)
SEARCH_MODEL_KEYS = {"train_image_classifier": "image_classifier_model",
                     "train_image_classifier_cifar100": "image_classifier_model",
                     "train_keypoint_detector": "keypoints_encoder_model"}


def _default_space_path(project_path, pipeline: str) -> Path:
    """The search space of ``pipeline``: ``<pipeline>_hp_search_space.json``
    or the same without ``train_`` (the shipped spaces are named after the
    model), under ``conf/base/hp_search_spaces``."""
    space_dir = Path(project_path) / "conf" / "base" / "hp_search_spaces"
    cands = [space_dir / f"{pipeline}_hp_search_space.json",
             space_dir / (pipeline.removeprefix("train_") + "_hp_search_space.json")]
    return next((p for p in cands if p.exists()), cands[0])


def _cmd_search(args) -> int:
    """Hyperparameter search driving the pipeline once per trial, in this
    process."""
    from deepcv_tpu_torch.hyperparams import HyperparameterSpace
    from deepcv_tpu_torch.pipelines import ProjectContext
    from deepcv_tpu_torch.search import SearchRunner

    pipeline = args.pipeline
    training_key = args.training_params_key or pipeline
    model_key = args.model_params_key or SEARCH_MODEL_KEYS.get(pipeline,
                                                                "image_classifier_model")
    space_path = Path(args.space) if args.space else \
        _default_space_path(args.project_path, pipeline)
    if not space_path.exists():
        print(f"error: search space not found: {space_path}", file=sys.stderr)
        return 2
    space = HyperparameterSpace.from_nni_json(str(space_path))
    base = _parse_extra_params(args.params)

    def trial_fn(params, trial):
        extra = dict(base)
        for name, v in params.items():
            if name.startswith("model:"):
                extra[f"{model_key}.{name[len('model:'):]}"] = v
            elif name.startswith("training:"):
                extra[f"{training_key}.{name[len('training:'):]}"] = v
            else:
                extra[f"{training_key}.{name}"] = v
        extra.setdefault(f"{training_key}.save_every_iters", 0)
        ctx = ProjectContext(args.project_path, extra_params=extra, device=args.device)
        hist = ctx.run(pipeline, persist_intermediates=False)["train_results"]["history"]
        for v in hist["valid"]:
            trial.report_intermediate_result(v.get(args.metric, 0.0))
        trial.report_final_result(hist["valid"][-1].get(args.metric, 0.0)
                                  if hist["valid"] else 0.0)

    summary = SearchRunner(space, trial_fn, tuner=args.tuner, max_trials=args.trials,
                           output_dir=args.output_dir).run()
    best = summary["best"]
    print(json.dumps({"best_value": best["value"] if best else None,
                      "best_params": best["params"] if best else None,
                      "trials": len(summary["trials"]),
                      "trial_values": [t["value"] for t in summary["trials"]],
                      "trial_seconds": [t["seconds"] for t in summary["trials"]],
                      "total_seconds": summary["total_seconds"],
                      "output_dir": str(args.output_dir)}), flush=True)
    return 0


def _cmd_lr_find(args) -> int:
    """The LR range test on the image classifier of the pipeline's conf."""
    from deepcv_tpu_torch.pipelines.classification import create_model
    from deepcv_tpu_torch.pipelines.framework import preprocess_node
    from deepcv_tpu_torch.train.lr_finder import plot_search_curves, run_lr_range_test

    ctx = _context(args)
    ds = "cifar100" if "cifar100" in args.pipeline else "cifar10"
    data = preprocess_node(ctx.load_catalog_entry(f"{ds}_train"),
                           ctx.load_catalog_entry(f"{ds}_test"),
                           ctx.params(f"{ds}_preprocessing"))
    model = create_model(data, ctx.params("image_classifier_model"), device=ctx.device)
    res = run_lr_range_test(model, "cross_entropy", data["trainset"],
                            batch_size=args.batch_size, num_steps=args.steps)
    out = plot_search_curves(res, args.out)
    print(json.dumps({"best_lr": res["best_lr"], "suggested": res["suggested"],
                      "steps": len(res["lrs"]), "curve": str(out)}), flush=True)
    return 0


def _cmd_test(rest: List[str]) -> int:
    """pytest over the port's test files in a tier, or with ``rest``."""
    import pytest

    files = [str(p) for p in sorted((Path(__file__).resolve().parents[1] / "tests")
                                    .glob("test_torch_*.py"))]
    if rest and rest[0] == "--full":
        return int(pytest.main(rest[1:] or [*files, "-q"]))
    if rest and rest[0] == "--quick":
        return int(pytest.main(rest[1:] or [*files, "-q", "-m", "not slow"]))
    return int(pytest.main(rest or [*files, "-q", "-m", "smoke"]))


def _cmd_dashboard(args) -> int:
    from deepcv_tpu_torch.dashboard import DashboardServer

    tb_url = None
    if args.tensorboard:
        from deepcv_tpu_torch.profiling import start_tensorboard_server

        if start_tensorboard_server(args.tensorboard) is not None:
            tb_url = "http://127.0.0.1:6006/"
    server = DashboardServer(args.root, port=args.port, tensorboard_url=tb_url)
    print(f"dashboard: {server.url} (root={args.root})", flush=True)
    server.serve_forever()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="deepcv_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a pipeline")
    p_run.add_argument("--pipeline", default="__default__")
    p_run.add_argument("--params", action="append", default=[],
                       help="extra params: dotted.key:value[,key:value...]")
    p_run.add_argument("--project-path", default=".")
    p_run.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu' for the plain path")
    p_run.add_argument("--from-nodes", default=None, metavar="N1,N2",
                       help="start at the first of these nodes (earlier nodes' outputs "
                            "load from the intermediate cache)")
    p_run.add_argument("--to-nodes", default=None, metavar="N1,N2",
                       help="stop after the last of these nodes")
    p_run.add_argument("--only-nodes", "--node", dest="only_nodes", default=None,
                       metavar="N1,N2", help="run exactly these nodes")
    p_run.add_argument("--tags", "--tag", dest="tags", default=None, metavar="T1,T2",
                       help="run only nodes with any of these tags")
    p_run.add_argument("--no-persist", action="store_true",
                       help="do not write (or read) pipeline intermediates")
    p_run.add_argument("--export", default=None, metavar="DIR",
                       help="after the run, save the trained model as a serving bundle")
    p_list = sub.add_parser("list", help="list registered pipelines")
    p_list.add_argument("--project-path", default=".")
    p_desc = sub.add_parser("describe", help="describe a pipeline")
    p_desc.add_argument("--pipeline", default="__default__")
    p_desc.add_argument("--project-path", default=".")
    sub.add_parser("test", help="run the port's tests: the smoke tier, --quick (all but "
                                "slow) or --full; other arguments pass to pytest")
    p_docs = sub.add_parser("docs", help="build static HTML docs from docs/*.md, README.md "
                                         "and PARITY.md")
    p_docs.add_argument("--out", default="docs/_build")
    p_docs.add_argument("--project-path", default=".")
    p_dash = sub.add_parser("dashboard", help="serve the local runs dashboard")
    p_dash.add_argument("--root", default="data/04_training/experiments",
                        help="ExperimentTracker store to browse")
    p_dash.add_argument("--port", type=int, default=8050)
    p_dash.add_argument("--tensorboard", default=None, metavar="LOGDIR",
                        help="also start a TensorBoard server on this logdir and link it")
    p_pred = sub.add_parser("predict", help="batch inference from a saved model bundle")
    p_pred.add_argument("--bundle", required=True,
                        help="directory from serve.save_model_bundle")
    p_pred.add_argument("--input", required=True,
                        help=".npy file of NHWC images (uint8 or float), or a .y4m "
                             "video (its RGB frames)")
    p_pred.add_argument("--output", default="predictions.npy")
    p_pred.add_argument("--batch-size", type=int, default=256)
    p_pred.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                        help="the model's compute dtype")
    p_pred.add_argument("--quantize", default=None, choices=["int8"],
                        help="compute conv/dense in w8a8 (the float bundle loads "
                             "unchanged)")
    p_pred.add_argument("--calibrate", type=int, default=0, metavar="N",
                        help="with --quantize: static activation scales recorded on "
                             "the first N input images")
    p_pred.add_argument("--decode", default=None, metavar="MODE",
                        help="'detection' (single-grid head), 'detection:8,4' (FPN "
                             "flat layout, fine->coarse grids): an .npz of boxes, "
                             "scores, classes after class-aware NMS; 'segmentation': "
                             "int32 argmax masks (N, H, W)")
    p_pred.add_argument("--top-k", type=int, default=16,
                        help="with --decode: detections kept per image")
    p_pred.add_argument("--nms-iou", type=float, default=0.5,
                        help="with --decode: NMS IoU threshold (suppressed "
                             "candidates get score 0)")
    p_pred.add_argument("--to-tensor", action="store_true",
                        help="scale uint8 inputs to [0,1] before the model")
    p_pred.add_argument("--normalize", default=None, metavar="MEANS/STDS",
                        help="per-channel normalize AFTER to_tensor (the stats "
                             "training used)")
    p_pred.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain path")
    p_srv = sub.add_parser(
        "serve", help="online inference server with micro-batching "
                      "(POST /predict, GET /healthz, GET /stats)")
    p_srv.add_argument("--bundle", required=True,
                       help="directory from serve.save_model_bundle")
    p_srv.add_argument("--port", type=int, default=8000)
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--batch-size", type=int, default=256,
                       help="fixed batch of the underlying Predictor")
    p_srv.add_argument("--max-wait-ms", type=float, default=5.0,
                       help="how long the batcher holds the first request "
                            "open for followers (latency bound)")
    p_srv.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p_srv.add_argument("--quantize", default=None, choices=["int8"],
                       help="compute conv/dense in w8a8 with dynamic activation "
                            "scales (the float bundle loads unchanged)")
    p_srv.add_argument("--to-tensor", action="store_true",
                       help="scale uint8 inputs to [0,1] before the model")
    p_srv.add_argument("--normalize", default=None, metavar="MEANS/STDS",
                       help="per-channel normalize AFTER to_tensor (same "
                            "stats training used)")
    p_srv.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu' for the plain path")
    p_search = sub.add_parser("search", help="in-process hyperparameter search over a "
                                             "pipeline")
    p_search.add_argument("--pipeline", default="train_image_classifier")
    p_search.add_argument("--space", default=None,
                          help="NNI-format search-space JSON (default: conf/base/"
                               "hp_search_spaces/<pipeline>_hp_search_space.json)")
    p_search.add_argument("--trials", type=int, default=8)
    p_search.add_argument("--tuner", default="tpe", choices=["tpe", "random", "grid"])
    p_search.add_argument("--metric", default="valid_accuracy")
    p_search.add_argument("--training-params-key", default=None,
                          help="conf key of the training hp (default: the pipeline name)")
    p_search.add_argument("--model-params-key", default=None,
                          help="conf key of the model hp (default: <task>_model)")
    p_search.add_argument("--output-dir", default="data/04_training/hp_search",
                          help="where trials.jsonl and summary.json go")
    p_search.add_argument("--params", action="append", default=[],
                          help="params every trial takes: dotted.key:value[,...]")
    p_search.add_argument("--project-path", default=".")
    p_search.add_argument("--device", default="cuda",
                          help="'cuda' (default) or 'cpu' for the plain path")
    p_lr = sub.add_parser("lr-find", help="LR range test on a pipeline's model and data")
    p_lr.add_argument("--pipeline", default="train_image_classifier")
    p_lr.add_argument("--steps", type=int, default=100)
    p_lr.add_argument("--batch-size", type=int, default=64)
    p_lr.add_argument("--out", default="data/04_training/lr_range_test.png")
    p_lr.add_argument("--project-path", default=".")
    p_lr.add_argument("--device", default="cuda",
                      help="'cuda' (default) or 'cpu' for the plain path")
    return parser


def main(argv=None) -> int:
    from deepcv_tpu_torch.config import ConfigError
    from deepcv_tpu_torch.spec.graph import SpecError

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and args.command != "test":
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.command == "test":
        return _cmd_test(rest)
    if args.command == "docs":
        from deepcv_tpu_torch.docs_build import build_docs

        written = build_docs(out_dir=args.out, root=args.project_path)
        print(f"built {len(written)} pages -> {args.out}", flush=True)
        return 0
    if args.command == "dashboard":
        return _cmd_dashboard(args)
    if args.command == "serve":
        return _cmd_serve(args)
    if args.command == "predict":
        return _cmd_predict(args)
    if args.command in ("search", "lr-find"):
        try:
            return _cmd_search(args) if args.command == "search" else _cmd_lr_find(args)
        except (ConfigError, SpecError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.command in ("list", "describe"):
        args.device = "cpu"  # reads the conf only
        pipes = _context(args).pipelines
        if args.command == "list":
            for name, p in sorted(pipes.items()):
                print(f"{name:45s} tags={sorted(p.tags)} nodes={[n.name for n in p.nodes]}")
        else:
            print(pipes[args.pipeline].describe())
        return 0
    try:
        store = run(argv[1:])
    except (ConfigError, SpecError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(_summary(args.pipeline, store)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface of the port.

Counterpart of ``deepcv_tpu/cli.py``'s ``run``, ``list``, ``describe`` and
``serve`` subcommands (``_parse_extra_params``, ``_cmd_serve``); the other
subcommands come with later slices. Usage::

    python -m deepcv_tpu_torch run --pipeline=train_vit \\
        --params vit_model.attn_impl:flash,train_resnet50.epochs:1 \\
        [--device cuda] [--export DIR]
    python -m deepcv_tpu_torch list
    python -m deepcv_tpu_torch describe --pipeline=train_vit
    python -m deepcv_tpu_torch serve --bundle DIR [--port 8000] \\
        [--batch-size 256] [--to-tensor] [--normalize M1,M2,M3/S1,S2,S3] \\
        [--device cuda]

``run`` prints one JSON line summing up the training run; typed config
faults (a bad ``--params`` override, a malformed spec) exit with code 2 and
a one-line message.
"""
from __future__ import annotations

import argparse
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
    store = _context(args).run(args.pipeline)
    if args.export:
        from deepcv_tpu_torch.serve import save_model_bundle

        results = store.get("train_results") or {}
        if "model" not in results:
            raise SystemExit("--export: the pipeline produced no trained model to bundle")
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


def _cmd_serve(args) -> int:
    """Online serving: bundle -> Predictor -> micro-batching HTTP server."""
    from deepcv_tpu_torch.data.transforms import normalize, to_tensor
    from deepcv_tpu_torch.serve import Predictor, load_model_bundle
    from deepcv_tpu_torch.server import InferenceServer

    if args.quantize:
        print(f"error: --quantize {args.quantize} is not ported yet (it comes "
              "with the compression slice); serve the float model",
              file=sys.stderr)
        return 2
    if not (Path(args.bundle) / "model.yaml").exists():
        print(f"error: --bundle {args.bundle!r} is not a model bundle "
              "(no model.yaml; expected a directory from "
              "serve.save_model_bundle)", file=sys.stderr)
        return 2
    mean = std = None
    if args.normalize:
        try:
            mean, std = _parse_normalize(args.normalize)
        except ValueError:
            print("error: --normalize expects 'm1,m2,m3/s1,s2,s3'", file=sys.stderr)
            return 2
    model = load_model_bundle(args.bundle, device=args.device)
    preprocess = None
    if args.to_tensor or args.normalize:
        def preprocess(x):
            x = to_tensor(x)
            return x if mean is None else normalize(x, mean, std)
    pred = Predictor(model, batch_size=args.batch_size, preprocess=preprocess,
                     dtype=args.dtype, device=args.device)
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="deepcv_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a pipeline")
    p_run.add_argument("--pipeline", required=True)
    p_run.add_argument("--params", action="append", default=[],
                       help="extra params: dotted.key:value[,key:value...]")
    p_run.add_argument("--project-path", default=".")
    p_run.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu' for the plain path")
    p_run.add_argument("--export", default=None, metavar="DIR",
                       help="after the run, save the trained model as a serving bundle")
    p_list = sub.add_parser("list", help="list registered pipelines")
    p_list.add_argument("--project-path", default=".")
    p_desc = sub.add_parser("describe", help="describe a pipeline")
    p_desc.add_argument("--pipeline", required=True)
    p_desc.add_argument("--project-path", default=".")
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
                       help="not ported yet: refused")
    p_srv.add_argument("--to-tensor", action="store_true",
                       help="scale uint8 inputs to [0,1] before the model")
    p_srv.add_argument("--normalize", default=None, metavar="MEANS/STDS",
                       help="per-channel normalize AFTER to_tensor (same "
                            "stats training used)")
    p_srv.add_argument("--device", default="cuda",
                       help="'cuda' (default) or 'cpu' for the plain path")
    return parser


def main(argv=None) -> int:
    from deepcv_tpu_torch.config import ConfigError
    from deepcv_tpu_torch.spec.graph import SpecError

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.command == "serve":
        return _cmd_serve(args)
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

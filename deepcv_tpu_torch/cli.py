"""Command-line interface of the port.

Counterpart of ``deepcv_tpu/cli.py``'s ``serve`` subcommand (``_cmd_serve``);
the other subcommands come with later slices. Usage::

    python -m deepcv_tpu_torch serve --bundle DIR [--port 8000] \\
        [--batch-size 256] [--to-tensor] [--normalize M1,M2,M3/S1,S2,S3] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

__all__ = ["main"]


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deepcv_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
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
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.command == "serve":
        return _cmd_serve(args)
    return 2  # pragma: no cover — argparse enforces a known subcommand


if __name__ == "__main__":
    sys.exit(main())

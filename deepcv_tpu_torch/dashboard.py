"""Runs dashboard: one local web page over the training runs' records.

Counterpart of ``deepcv_tpu/dashboard.py`` (``scan_runs``,
``render_index``, ``render_run``, ``DashboardServer``), copied: a
standard-library HTTP server over the store of
:class:`deepcv_tpu_torch.train.loggers.ExperimentTracker`
(``<root>/<experiment>/<run_id>/{meta.json, params.json, metrics.jsonl,
artifacts/}``, the JAX package's layout):

* the run index (``GET /``), each run's last metrics and tags;
* a page per run (``GET /run/<experiment>/<run_id>``): hyperparameters,
  tags and every metric as an inline SVG curve, no plotting library;
* its artifacts (``GET /artifact/<experiment>/<run_id>/<path>``), refusing
  any path that resolves outside the run's directory.

``python -m deepcv_tpu_torch dashboard --root ... --port ...
[--tensorboard LOGDIR]`` serves it.
"""
from __future__ import annotations

import html
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional
from urllib.parse import unquote

__all__ = ["scan_runs", "render_index", "render_run", "DashboardServer"]

_logger = logging.getLogger(__name__)

_STYLE = """<style>
body { font-family: system-ui, sans-serif; margin: 2em; color: #1a1a1a; }
table { border-collapse: collapse; margin: 1em 0; }
td, th { border: 1px solid #ccc; padding: 4px 10px; font-size: 14px;
         text-align: left; }
th { background: #f0f0f0; }
h1, h2 { font-weight: 600; }
.curve { margin: 0.5em 1em 0.5em 0; display: inline-block; }
.curve text { font-size: 11px; fill: #444; }
a { color: #0b57d0; text-decoration: none; }
code { background: #f5f5f5; padding: 1px 4px; }
</style>"""


def scan_runs(root) -> List[Dict[str, Any]]:
    """Collect every run under an ExperimentTracker file store."""
    runs = []
    root = Path(root)
    if not root.is_dir():
        return runs
    for meta_path in sorted(root.glob("*/*/meta.json")):
        run_dir = meta_path.parent
        try:
            meta = json.loads(meta_path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        params_path = run_dir / "params.json"
        params = {}
        if params_path.exists():
            try:
                params = json.loads(params_path.read_text())
            except (OSError, json.JSONDecodeError):
                pass
        metrics: List[Dict[str, Any]] = []
        metrics_path = run_dir / "metrics.jsonl"
        if metrics_path.exists():
            for line in metrics_path.read_text().splitlines():
                try:
                    metrics.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        runs.append({"experiment": run_dir.parent.name, "run_id": run_dir.name,
                     "dir": run_dir, "meta": meta, "params": params,
                     "metrics": metrics})
    return runs


def _svg_curve(xs: List[float], ys: List[float], label: str,
               width: int = 320, height: int = 120) -> str:
    """A metric curve as a self-contained inline SVG (no plotting deps)."""
    if not xs:
        return ""
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y0, y1 = y0 - 0.5, y1 + 0.5
    pad, w, h = 8, width, height
    def sx(x):
        return pad + (w - 2 * pad) * (x - x0) / max(x1 - x0, 1e-12)
    def sy(y):
        return h - pad - (h - 2 * pad - 14) * (y - y0) / (y1 - y0)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    return (f'<svg class="curve" width="{w}" height="{h}" '
            f'xmlns="http://www.w3.org/2000/svg">'
            f'<rect width="{w}" height="{h}" fill="#fafafa" stroke="#ddd"/>'
            f'<polyline points="{pts}" fill="none" stroke="#0b57d0" '
            f'stroke-width="1.5"/>'
            f'<text x="{pad}" y="{h - 2}">{html.escape(label)}: '
            f'last={ys[-1]:.4g} min={min(ys):.4g} max={max(ys):.4g}</text>'
            f'</svg>')


def render_index(runs: List[Dict[str, Any]],
                 tensorboard_url: Optional[str] = None) -> str:
    rows = []
    for r in runs:
        last = {k: v for k, v in (r["metrics"][-1] if r["metrics"] else {}).items()
                if k not in ("step", "time")}
        last_txt = ", ".join(f"{k}={v:.4g}" for k, v in list(last.items())[:4])
        tags = ", ".join(f"{k}={v}" for k, v in
                         (r["meta"].get("tags") or {}).items())
        link = f'/run/{r["experiment"]}/{r["run_id"]}'
        rows.append(f"<tr><td><a href='{link}'>{html.escape(r['run_id'])}</a>"
                    f"</td><td>{html.escape(r['experiment'])}</td>"
                    f"<td>{html.escape(tags)}</td>"
                    f"<td>{len(r['metrics'])}</td>"
                    f"<td>{html.escape(last_txt)}</td></tr>")
    services = ""
    if tensorboard_url:
        services = (f"<p>Services: <a href='{html.escape(tensorboard_url)}'>"
                    f"TensorBoard</a> (profiles, histograms)</p>")
    return (f"<!doctype html><html><head><title>deepcv_tpu runs</title>"
            f"{_STYLE}</head><body><h1>deepcv_tpu — runs</h1>{services}"
            f"<table><tr><th>run</th><th>experiment</th><th>tags</th>"
            f"<th>#metric rows</th><th>latest</th></tr>"
            f"{''.join(rows) or '<tr><td colspan=5>no runs found</td></tr>'}"
            f"</table></body></html>")


def render_run(run: Dict[str, Any]) -> str:
    keys = sorted({k for m in run["metrics"] for k in m
                   if k not in ("step", "time")})
    curves = []
    for k in keys:
        pts = [(m.get("step", i), m[k]) for i, m in enumerate(run["metrics"])
               if k in m]
        curves.append(_svg_curve([float(p[0]) for p in pts],
                                 [float(p[1]) for p in pts], k))
    params = "".join(f"<tr><td><code>{html.escape(str(k))}</code></td>"
                     f"<td>{html.escape(str(v))}</td></tr>"
                     for k, v in sorted(run["params"].items()))
    arts = []
    art_dir = run["dir"] / "artifacts"
    if art_dir.is_dir():
        for p in sorted(art_dir.rglob("*")):
            if p.is_file():
                rel = p.relative_to(run["dir"])
                arts.append(f"<li><a href='/artifact/{run['experiment']}/"
                            f"{run['run_id']}/{rel}'>{html.escape(str(rel))}"
                            f"</a> ({p.stat().st_size} B)</li>")
    meta_txt = html.escape(json.dumps(run["meta"], indent=1))
    return (f"<!doctype html><html><head>"
            f"<title>{html.escape(run['run_id'])}</title>{_STYLE}</head>"
            f"<body><p><a href='/'>&larr; runs</a></p>"
            f"<h1>{html.escape(run['run_id'])}</h1>"
            f"<h2>metrics</h2>{''.join(curves) or '<p>none logged</p>'}"
            f"<h2>hyperparameters</h2><table>{params or ''}</table>"
            f"<h2>artifacts</h2><ul>{''.join(arts) or '<li>none</li>'}</ul>"
            f"<h2>meta</h2><pre>{meta_txt}</pre></body></html>")


class DashboardServer:
    """Threaded stdlib HTTP server over an ExperimentTracker store.

    ``port=0`` picks a free port (tests). Artifact serving resolves paths
    and refuses anything that escapes the run directory.
    """

    def __init__(self, root="data/04_training/experiments", port: int = 8050,
                 tensorboard_url: Optional[str] = None):
        self.root = Path(root)
        self.tensorboard_url = tensorboard_url
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                _logger.debug("dashboard: " + fmt, *args)

            def _send(self, body: bytes, ctype="text/html; charset=utf-8",
                      code=200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                parts = [unquote(p) for p in self.path.split("?")[0]
                         .strip("/").split("/") if p]
                runs = scan_runs(dash.root)
                if not parts:
                    return self._send(render_index(
                        runs, dash.tensorboard_url).encode())
                if parts[0] == "run" and len(parts) == 3:
                    for r in runs:
                        if (r["experiment"], r["run_id"]) == (parts[1], parts[2]):
                            return self._send(render_run(r).encode())
                    return self._send(b"run not found", "text/plain", 404)
                if parts[0] == "artifact" and len(parts) >= 4:
                    run_dir = (dash.root / parts[1] / parts[2]).resolve()
                    target = (run_dir / "/".join(parts[3:])).resolve()
                    if (run_dir.is_relative_to(Path(dash.root).resolve())
                            and target.is_relative_to(run_dir)
                            and target.is_file()):
                        return self._send(target.read_bytes(),
                                          "application/octet-stream")
                    return self._send(b"not found", "text/plain", 404)
                return self._send(b"not found", "text/plain", 404)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def start(self) -> "DashboardServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        _logger.info("dashboard serving %s at %s", self.root, self.url)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self):  # CLI entry
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover
            self.stop()

"""Online inference server with micro-batching.

Counterpart of ``deepcv_tpu/server.py`` (``MicroBatcher``,
``InferenceServer``), copied so that the port imports nothing of the JAX
package; it is stdlib and numpy only. Each model call has a fixed launch
overhead and the predictor runs a FIXED batch shape, so concurrent requests
are coalesced into one forward and the results split back per caller.

* :class:`MicroBatcher` — thread-safe request coalescing in front of any
  ``fn(images) -> outputs`` (normally a :class:`deepcv_tpu_torch.serve.Predictor`).
  A single worker thread drains the queue: it waits ``max_wait_ms`` for
  followers after the first request (latency bound), caps the coalesced
  group at ``max_batch`` rows, runs ONE predictor call, and resolves each
  caller's Future with its slice. One worker by design: the card runs one
  forward at a time — a thread pool here would only add queueing jitter.
* :class:`InferenceServer` — HTTP front end: ``POST /predict`` with a
  ``.npy`` body (``application/x-npy``) or JSON ``{"images": [...]}``;
  ``GET /healthz``; ``GET /stats`` (request/batch counters, so the
  coalescing ratio is observable in production).

CLI: ``python -m deepcv_tpu_torch serve --bundle <dir> --port 8000``.
"""
from __future__ import annotations

import collections
import io
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

import numpy as np

__all__ = ["MicroBatcher", "InferenceServer"]

_logger = logging.getLogger(__name__)


class MicroBatcher:
    """Coalesce concurrent inference requests into one forward.

    ``predict_fn`` must accept an ``(N, ...)`` batch and return an ``(N, ...)``
    array (row i of the output belongs to row i of the input) — exactly the
    :class:`deepcv_tpu_torch.serve.Predictor` contract, which also absorbs any N by
    padding to its fixed batch internally.

    ``start=False`` defers the worker thread (tests use it to queue a known
    set of requests and assert they coalesce into one batch).
    """

    def __init__(self, predict_fn: Callable[[np.ndarray], Any],
                 max_batch: int = 256, max_wait_ms: float = 5.0,
                 start: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        self.predict_fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._closed = False
        # guards the closed-flag check + enqueue in submit() against close()'s
        # flag-set + drain: without it a submit racing close() can enqueue
        # AFTER the drain and its Future never resolves
        self._lifecycle_lock = threading.Lock()
        self.stats = {"requests": 0, "items": 0, "batches": 0,
                      "max_coalesced": 0}
        self._stats_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._closed = False
            self._stop.clear()
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="microbatcher")
            self._worker.start()

    def close(self) -> None:
        """Stop the worker after it drains in-flight requests. Futures still
        queued when the worker exits (or if the join times out) are FAILED,
        not dropped — callers must never block until their own timeout on a
        batcher that will not serve them."""
        with self._lifecycle_lock:
            self._closed = True
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=30)
            if self._worker.is_alive():  # pragma: no cover — stuck predict_fn
                _logger.warning("MicroBatcher worker did not drain within "
                                "30s; failing queued requests")
            self._worker = None
        err = RuntimeError("MicroBatcher closed")
        with self._lifecycle_lock:
            while True:
                try:
                    _, fut = self._q.get_nowait()
                except queue.Empty:
                    break
                if not fut.cancelled():
                    fut.set_exception(err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ submission
    def submit(self, images: np.ndarray) -> Future:
        """Enqueue a request; the Future resolves to this request's rows of
        the batched prediction. ``images`` is (N, ...) — a single un-batched
        sample must be wrapped by the caller (the HTTP layer does)."""
        x = np.asarray(images)
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"empty request (shape {x.shape})")
        fut: Future = Future()
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher closed — submit() after "
                                   "close() would never resolve")
            self._q.put((x, fut))
        # count only requests actually enqueued — a rejected post-close
        # submit must not inflate /stats relative to batches served
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["items"] += int(x.shape[0])
        return fut

    def infer(self, images: np.ndarray, timeout: Optional[float] = 60.0):
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(images).result(timeout=timeout)

    # ------------------------------------------------------------ the worker
    def _run(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            group = [first]
            n = int(first[0].shape[0])
            deadline = time.perf_counter() + self.max_wait_ms / 1000.0
            # hold the door open for followers: bounded by wall time AND rows
            while n < self.max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    # drain instantly once the queue is non-empty; otherwise
                    # sleep out the remaining window in one timed get
                    nxt = self._q.get(timeout=max(0.0, remaining)) \
                        if remaining > 0 else self._q.get_nowait()
                except queue.Empty:
                    break
                group.append(nxt)
                n += int(nxt[0].shape[0])
            self._execute(group)

    def _execute(self, group) -> None:
        try:
            xs = np.concatenate([np.asarray(x) for x, _ in group], axis=0) \
                if len(group) > 1 else np.asarray(group[0][0])
            ys = np.asarray(self.predict_fn(xs))
            if ys.shape[0] != xs.shape[0]:
                raise RuntimeError(
                    f"predict_fn returned {ys.shape[0]} rows for "
                    f"{xs.shape[0]} inputs — MicroBatcher needs row-aligned "
                    "outputs to split them per request")
        except BaseException as e:
            if len(group) > 1:
                # one poisoned request (wrong sample shape/dtype slipping past
                # the front end) must not 500 its innocent coalesced
                # neighbors: fall back to executing each request alone, so
                # only the bad one carries the exception
                _logger.warning("coalesced batch of %d failed (%r); retrying "
                                "requests individually", len(group), e)
                for item in group:
                    self._execute([item])
            else:  # resolve the waiter, then keep serving
                for _, fut in group:
                    if not fut.cancelled():
                        fut.set_exception(e)
            return
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["max_coalesced"] = max(self.stats["max_coalesced"],
                                              len(group))
        off = 0
        for x, fut in group:
            k = int(np.asarray(x).shape[0])
            if not fut.cancelled():
                fut.set_result(ys[off:off + k])
            off += k


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


class InferenceServer:
    """HTTP front end over a :class:`MicroBatcher`.

    ``predict_fn`` is any row-aligned batch function (a Predictor). Requests:

    * ``POST /predict`` — body either a ``.npy`` file (header bytes
      ``\\x93NUMPY``; responded to in kind) or JSON ``{"images": <nested
      list>}`` (responded to as JSON ``{"outputs": [...]}``). A single
      sample (input_ndim dims) is auto-wrapped and unwrapped.
    * ``GET /healthz`` — liveness, plus ``ready``: whether the
      forward has produced rows (via :meth:`warmup` or a first served
      request) — false until the first forward has run.
    * ``GET /stats`` — MicroBatcher counters + uptime.

    ``port=0`` picks a free port (tests). The server threads only parse and
    serialize; all model work funnels through the single batcher worker.
    """

    def __init__(self, predict_fn: Callable[[np.ndarray], Any],
                 port: int = 8000, host: str = "127.0.0.1",
                 max_batch: int = 256, max_wait_ms: float = 5.0,
                 input_ndim: int = 3,
                 input_shape: Optional[tuple] = None):
        self.batcher = MicroBatcher(predict_fn, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)
        # full per-sample shape when known (the model's input_shape): a
        # request with the right RANK but wrong dims must be a 400 at the
        # front door, never reach a coalesced group and fail its neighbors
        self.input_shape = tuple(input_shape) if input_shape else None
        self.input_ndim = len(self.input_shape) if self.input_shape \
            else int(input_ndim)
        self._t0 = time.time()
        # end-to-end /predict latencies (parse -> batched forward -> result),
        # bounded window so /stats percentiles track the RECENT regime.
        # Handler threads append while /stats sorts — deque iteration during
        # mutation raises in CPython, so every access holds the lock.
        self._lat_ms = collections.deque(maxlen=1024)
        self._lat_lock = threading.Lock()
        # readiness = the forward has actually produced rows (via
        # warmup() or the first served request) — /healthz reports it so load
        # balancers don't route traffic into the first forward
        self._ready = threading.Event()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                _logger.debug("server: " + fmt, *args)

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj, code: int = 200):
                self._send(json.dumps(obj).encode(), "application/json", code)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path == "/healthz":
                    return self._send_json({"ok": True,
                                            "ready": server._ready.is_set()})
                if path == "/stats":
                    with server.batcher._stats_lock:
                        stats = dict(server.batcher.stats)
                    stats["uptime_s"] = round(time.time() - server._t0, 1)
                    with server._lat_lock:
                        lat = sorted(server._lat_ms)
                    if lat:
                        stats["latency_p50_ms"] = round(lat[len(lat) // 2], 2)
                        stats["latency_p99_ms"] = round(
                            lat[min(len(lat) - 1, int(len(lat) * 0.99))], 2)
                    return self._send_json(stats)
                return self._send_json({"error": f"unknown path {path}"}, 404)

            def do_POST(self):  # noqa: N802
                if self.path.split("?")[0] != "/predict":
                    return self._send_json(
                        {"error": f"unknown path {self.path}"}, 404)
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    if body[:6] == b"\x93NUMPY":
                        x = np.load(io.BytesIO(body), allow_pickle=False)
                        as_npy = True
                    else:
                        x = np.asarray(json.loads(body.decode())["images"])
                        as_npy = False
                except Exception as e:  # malformed request, caller's fault
                    return self._send_json({"error": f"bad request: {e}"}, 400)
                single = x.ndim == server.input_ndim
                if single:
                    x = x[None]
                if x.ndim != server.input_ndim + 1:
                    return self._send_json(
                        {"error": f"expected {server.input_ndim}-d sample or "
                                  f"{server.input_ndim + 1}-d batch, got "
                                  f"shape {list(x.shape)}"}, 400)
                if server.input_shape and \
                        tuple(x.shape[1:]) != server.input_shape:
                    return self._send_json(
                        {"error": f"sample shape {list(x.shape[1:])} does "
                                  f"not match the model's input shape "
                                  f"{list(server.input_shape)}"}, 400)
                try:
                    t0 = time.perf_counter()
                    y = np.asarray(server.batcher.infer(x))
                    with server._lat_lock:
                        server._lat_ms.append((time.perf_counter() - t0) * 1e3)
                    server._ready.set()
                except Exception as e:  # model-side failure
                    return self._send_json({"error": str(e)}, 500)
                if y.dtype.name == "bfloat16" or y.dtype.kind == "V":
                    y = y.astype(np.float32)
                if single:
                    y = y[0]
                if as_npy:
                    return self._send(_npy_bytes(y), "application/x-npy")
                return self._send_json({"outputs": y.tolist()})

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self.host, self.port = self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def warmup(self, sample: Optional[np.ndarray] = None) -> None:
        """Run one forward through the batcher (building the kernels on first
        use) and mark the server ready for /healthz. With no ``sample``,
        a zero sample of ``input_shape`` is used (requires ``input_shape``)."""
        if sample is None:
            if not self.input_shape:
                raise ValueError("warmup() without a sample needs "
                                 "input_shape= at construction")
            sample = np.zeros((1, *self.input_shape), np.float32)
        self.batcher.infer(np.asarray(sample), timeout=None)
        self._ready.set()

    def serve_forever(self) -> None:
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover — interactive stop
            pass
        finally:
            self.close()

    def start_background(self) -> "InferenceServer":
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="inference-server").start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.close()

    def __enter__(self):
        return self.start_background()

    def __exit__(self, *exc):
        self.close()

"""Profiling and tracing on ``torch.profiler``.

Counterpart of ``deepcv_tpu/profiling.py``:

* :func:`trace` captures a Chrome trace (``chrome://tracing``, Perfetto,
  TensorBoard's profile plugin) of everything inside the block, the CUDA
  device's kernels included where there is a card;
* :func:`annotate` names a span in it (``record_function``);
* :class:`StepTimer` times steps on the host clock, synchronising the card
  around each with ``sync=True``;
* :func:`device_memory_stats` reads ``torch.cuda.memory_stats`` per card;
* :func:`trace_op_summary` reads a trace's device kernels back as rows
  (``plane``, ``line``, ``op``, ``total_ms``, ``count``), and
  :func:`profile_op_breakdown` traces a callable and returns them;
* :func:`mfu_report` and :func:`model_flops`: model FLOPs and their
  utilization against the card's dense bf16 peak (:data:`PEAK_BF16_FLOPS`);
* :func:`check_determinism` and the TensorBoard server helpers.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import logging
import statistics
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "annotate", "StepTimer", "device_memory_stats",
           "check_determinism", "forced_sync_time", "mfu_report",
           "model_flops", "PEAK_BF16_FLOPS",
           "trace_op_summary", "profile_op_breakdown",
           "start_tensorboard_server", "stop_tensorboard_server"]

_logger = logging.getLogger(__name__)

#: dense bf16 peak FLOP/s by ``torch.cuda.get_device_name()`` (NVIDIA's
#: data sheet: the H100 SXM at its 700 W limit)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}

#: Chrome-trace categories of work on the device
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir="data/04_training/profile"):
    """Profile everything inside the block (the CPU, and the CUDA device
    where there is one) and write its Chrome trace to
    ``<log_dir>/trace_<time>.json`` on exit; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        _sync()
        prof.stop()
        path = Path(log_dir) / f"trace_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        _logger.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named span in profiler traces: ``with annotate('augment'): ...``"""
    return torch.profiler.record_function(name)


class StepTimer:
    """Host-clock step timing with a percentile summary; with ``sync`` the
    CUDA device is synchronised as each step starts and ends, so a step's
    time is its device work's."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        if self.sync:
            _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {"n": len(ts), "mean_s": statistics.fmean(ts),
                "p50_s": ts[len(ts) // 2], "p95_s": ts[int(len(ts) * 0.95)],
                "max_s": ts[-1]}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``torch.cuda.memory_stats`` of each card (bytes and counts), by
    ``cuda:<i>``; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                          if isinstance(v, (int, float))}
            for i in range(torch.cuda.device_count())}


def _host_leaves(out) -> List[np.ndarray]:
    return [t.detach().cpu().double().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float64) for t in tree_leaves(out)]


def check_determinism(fn, *args, n_runs: int = 2, atol: float = 0.0):
    """Run ``fn`` ``n_runs`` times on the same inputs and compare every
    output tensor: any divergence past ``atol`` means a host-side race or
    an uncaptured random draw (or a kernel whose sums change order between
    runs). Returns the largest deviation; raises AssertionError past
    ``atol``."""
    ref = _host_leaves(fn(*args))
    worst = 0.0
    for i in range(1, n_runs):
        for a, b in zip(ref, _host_leaves(fn(*args))):
            d = float(np.max(np.abs(a - b))) if a.size else 0.0
            worst = max(worst, d)
            if d > atol:
                raise AssertionError(
                    f"Non-determinism detected on run {i}: max deviation {d} > {atol} "
                    "(host-side race or uncaptured randomness)")
    return worst


_TB_PROCESS: Optional[subprocess.Popen] = None


def start_tensorboard_server(logdir="data/04_training", port: int = 6006):
    """Launch a background TensorBoard server; returns the Popen."""
    global _TB_PROCESS
    if _TB_PROCESS is not None and _TB_PROCESS.poll() is None:
        return _TB_PROCESS
    _TB_PROCESS = subprocess.Popen(
        ["tensorboard", "--logdir", str(logdir), "--port", str(port), "--bind_all"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    _logger.info("tensorboard started on :%d (logdir=%s)", port, logdir)
    return _TB_PROCESS


def stop_tensorboard_server():
    global _TB_PROCESS
    if _TB_PROCESS is not None and _TB_PROCESS.poll() is None:
        _TB_PROCESS.terminate()
        try:
            _TB_PROCESS.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover
            _TB_PROCESS.kill()
    _TB_PROCESS = None


# --------------------------------------------------------------------------- #
# Reading a trace back
# --------------------------------------------------------------------------- #

def _load_trace(path: Path) -> Dict[str, Any]:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def trace_op_summary(log_dir, plane_filter: str = "GPU") -> List[Dict[str, Any]]:
    """Total time per op of the newest Chrome trace (``*.json`` or
    ``*.json.gz``) under ``log_dir``, as :func:`trace` writes it.

    Device work (kernels, copies, memsets) is on plane ``GPU <device>``,
    line ``stream <stream>``; host ops on plane ``CPU``, line ``thread
    <tid>``. Returns ``{"plane", "line", "op", "total_ms", "count"}`` rows of
    the planes whose name contains ``plane_filter``, by descending time."""
    paths = sorted(Path(log_dir).rglob("*.json*"), key=lambda p: (p.stat().st_mtime_ns, p.name))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {log_dir}")
    agg: Dict[tuple, List[float]] = {}
    for ev in _load_trace(paths[-1]).get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat"), ev.get("args") or {}
        if cat in _DEVICE_CATEGORIES:
            plane = f"GPU {args.get('device', ev.get('pid'))}"
            line = f"stream {args.get('stream', ev.get('tid'))}"
        elif cat == "cpu_op":
            plane, line = "CPU", f"thread {ev.get('tid')}"
        else:
            continue
        if plane_filter not in plane:
            continue
        a = agg.setdefault((plane, line, ev.get("name", "")), [0.0, 0])
        a[0] += float(ev.get("dur", 0.0))
        a[1] += 1
    rows = [{"plane": p, "line": ln, "op": op, "total_ms": us / 1e3, "count": n}
            for (p, ln, op), (us, n) in agg.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def profile_op_breakdown(fn, *args, log_dir: Optional[str] = None, warmup: int = 1,
                         iters: int = 3, top: int = 20) -> List[Dict[str, Any]]:
    """Trace ``iters`` calls of ``fn(*args)`` (after ``warmup`` untraced
    ones) and return the top ``top`` ops by total time (all with ``top``
    0): the device's kernels where there is a card, else the host's ops.
    The trace goes to ``log_dir``, or to a temporary directory removed
    afterwards."""
    for _ in range(max(0, warmup)):
        fn(*args)
    _sync()
    with contextlib.ExitStack() as stack:
        if log_dir is None:
            log_dir = stack.enter_context(tempfile.TemporaryDirectory())
        with trace(log_dir):
            for _ in range(iters):
                fn(*args)
        rows = trace_op_summary(log_dir, "GPU" if torch.cuda.is_available() else "CPU")
    return rows[:top] if top else rows


# --------------------------------------------------------------------------- #
# MFU
# --------------------------------------------------------------------------- #

def _device_kind() -> str:
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def forced_sync_time(fn, *args, n: int = 20) -> float:
    """Mean wall seconds per call of ``fn(*args)``, after a warm-up call,
    ended by reading a scalar of the last result back to the host
    (``.item()``), which cannot return before the device's work."""
    def _read(r):
        leaf = next(t for t in tree_leaves(r) if isinstance(t, torch.Tensor))
        leaf.float().sum().item()

    _read(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    _read(r)
    return (time.perf_counter() - t0) / n


def _counted_flops(fn, *args) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def mfu_report(fn, *args, flops: Optional[float] = None, n: int = 20,
               peak_flops: Optional[float] = None) -> Dict[str, Any]:
    """Time ``fn(*args)`` end to end (:func:`forced_sync_time`) and report
    its model-FLOPs utilization.

    ``flops`` defaults to ``FlopCounterMode``'s count of one call (matmuls
    and convolutions at 2 x MACs). That count does not see K2's launches
    (a ``ctypes`` call): for a model on the card pass ``flops`` from
    :func:`model_flops`. ``peak_flops`` defaults to the card's entry of
    :data:`PEAK_BF16_FLOPS` (None, and so ``mfu`` None, elsewhere). Returns
    ``{'seconds', 'flops', 'tflops_per_s', 'mfu', 'device_kind'}``.
    """
    if flops is None:
        flops = _counted_flops(fn, *args)
    kind = _device_kind()
    peak = peak_flops if peak_flops is not None else PEAK_BF16_FLOPS.get(kind)
    secs = forced_sync_time(fn, *args, n=n)
    return {"seconds": secs, "flops": float(flops),
            "tflops_per_s": flops / secs / 1e12,
            "mfu": (flops / secs / peak) if peak else None,
            "device_kind": kind}


def model_flops(model, batch_size: int = 1, dtype=torch.float32,
                train: bool = False) -> Dict[str, Any]:
    """A DeepcvModule's static profile, computed on a copy of its spec on
    the meta device (nothing runs, nothing is allocated; the copy takes the
    plain route, which ``FlopCounterMode`` sees, where the card would
    launch K2).

    ``flops`` counts matmuls and convolutions at 2 x MACs and nothing
    element-wise: 305,610,752 an image for the conf's wide classifier at
    32x32x3 and 10 classes. The JAX package's count is XLA's cost analysis
    of its program, by XLA's rules and with its padded stem channels
    (284,923,712 an image for the same model). ``bytes_accessed`` is the least a forward must move: the
    parameters and the input read once, the output written once (XLA's
    number counts every fused op's traffic; there is no torch
    counterpart). Returns ``{'params', 'flops', 'flops_per_image',
    'bytes_accessed', 'batch_size'}``.
    """
    from torch.utils.flop_counter import FlopCounterMode

    twin = type(model)(model.input_shape, model.hp.to_dict(), device="meta",
                       **model._ctor_options()).train(train)
    x = torch.empty((int(batch_size), *model.input_shape), dtype=dtype, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        out = twin(x)
    flops = float(counter.get_total_flops())
    n_params = sum(p.numel() for p in twin.parameters())
    moved = sum(p.numel() * p.element_size() for p in twin.parameters()) + \
        x.numel() * x.element_size() + \
        sum(t.numel() * t.element_size() for t in tree_leaves(out))
    return {"params": n_params, "flops": flops,
            "flops_per_image": flops / int(batch_size),
            "bytes_accessed": float(moved), "batch_size": int(batch_size)}

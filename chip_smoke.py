#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepcv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # on a machine with one CUDA card

Phases, each printing one JSON line:

0. device — the card (``nvidia-smi`` name and power limit), torch and CUDA.
1. build — the port's CUDA kernel compiled by ``nvcc`` from ``csrc/``, with
   the build time and ``ptxas``'s registers, shared memory and spills.
2. kernel — the kernel against its plain PyTorch version at ResNet-50's
   stride-1 conv shapes at batch 64 (plus one ragged case), with and without
   bias, relu and none, float32 and bfloat16; error relative to max|ref|,
   kernel time (median of CUDA-event timed launches), its bound on the card,
   and the same ``F.conv2d`` call's time as a yardstick.
3. serve — ``resnet_spec(50)`` at 224x224x3, 1000 classes, weights from a
   seed: bundle saved and loaded, ``Predictor`` at batch 64 behind the
   port's ``InferenceServer``; four client threads POST ``.npy`` batches of
   1, 5, 17 and 64 images; every answer is held against the port's CPU path
   on the same weights; the kernel must have launched 46 times per forward.

Then the kernels line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without the last line. With no CUDA device, or without the
repository beside it, it exits non-zero at once. A hang dumps the stacks and
exits non-zero after ``HANG_LIMIT_S``.
"""
from __future__ import annotations

import collections
import faulthandler
import http.client
import io
import json
import platform
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deepcv_tpu_torch.data.transforms import normalize, to_tensor
from deepcv_tpu_torch.ops.kernels import _build
from deepcv_tpu_torch.ops.kernels.fused_layer import (
    fused_conv2d_bias_act, plain_conv2d_bias_act)
from deepcv_tpu_torch.ops.nn import FusedConv2d
from deepcv_tpu_torch.serve import Predictor, load_model_bundle, save_model_bundle
from deepcv_tpu_torch.server import InferenceServer
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import resnet_spec

REPO = Path(__file__).resolve().parent
HANG_LIMIT_S = 600
SEED = 20261017

# relative to max|ref|. f32: both accumulate in f32, in another order (3.2e-6
# measured at these shapes on an H100). bf16: both round one f32 result to
# bf16, so they differ by at most one ulp, 2**-7 of the largest value.
F32_TOL = 2e-5
BF16_TOL = 1e-2
SERVE_REL_L2 = 1e-3  # card vs CPU, both f32 with TF32 off

#: published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
#: cores, bf16 dense on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

#: ResNet-50's stride-1 conv shapes at the serving batch: (N, H, W, Cin, Cout, k)
PHASE2_SHAPES = [
    (64, 56, 56, 64, 64, 1), (64, 56, 56, 64, 64, 3), (64, 56, 56, 64, 256, 1),
    (64, 56, 56, 256, 64, 1), (64, 28, 28, 128, 128, 3), (64, 14, 14, 256, 256, 3),
    (64, 7, 7, 512, 512, 3), (64, 7, 7, 512, 2048, 1),
    (3, 13, 13, 5, 7, 5),  # ragged: partial tiles on every axis
]
DEVICE = "cuda"
IMAGE_SHAPE = (224, 224, 3)
SERVE_BATCH = 64
REQUEST_SIZES = (1, 5, 17, 64)
ROUNDS = 6
LAUNCHES_PER_FORWARD = 46
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def conv_bound(n, h, w, cin, cout, k, dtype: str, bias: bool):
    """Least time for the work on an H100 SXM: each input read once, the
    output written once, FLOPs at the type's peak. Returns (ms, bound_by)."""
    item = 4 if dtype == "float32" else 2
    flops = 2.0 * n * h * w * k * k * cin * cout
    nbytes = item * (n * h * w * cin + k * k * cin * cout + n * h * w * cout
                     + (cout if bias else 0))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": platform.python_version()})
    return card


def phase_build():
    t0 = time.perf_counter()
    path, log, seconds = _build.build("fused_conv2d_bias_act")
    _build.load("fused_conv2d_bias_act")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "kernel": "fused_conv2d_bias_act",
          "nvcc_s": round(seconds, 3), "wall_s": round(time.perf_counter() - t0, 3),
          "library": str(path.relative_to(REPO)), "ptxas": ptxas})


def _case_tensors(gen, n, h, w, cin, cout, k, dtype):
    x = torch.randn((n, cin, h, w), generator=gen, device=DEVICE)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((cout, cin, k, k), generator=gen, device=DEVICE)
          / float(cin * k * k) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((cout,), generator=gen, device=DEVICE)).to(dtype)
    return x, wt, b


def _rel_err(got, ref):
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    return err / max(r.abs().max().item(), 1e-30), err


def _library_call(x, w, b, act):
    k = w.shape[-1]

    def call():
        y = F.conv2d(x, w, b, padding=k // 2)
        return torch.relu(y) if act == "relu" else y
    return call


def phase_kernel(card):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (n, h, w, cin, cout, k) in PHASE2_SHAPES:
        for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            x, wt, b = _case_tensors(gen, n, h, w, cin, cout, k,
                                     getattr(torch, dtype))
            errs = {}
            for bias in (False, True):
                for act in (None, "relu"):
                    bb = b if bias else None
                    got = fused_conv2d_bias_act(x, wt, bb, act)
                    ref = plain_conv2d_bias_act(x, wt, bb, act)
                    torch.cuda.synchronize()
                    rel, _ = _rel_err(got, ref)
                    errs[f"{'bias' if bias else 'nobias'}_{act or 'none'}"] = rel
                    if not rel <= tol:
                        raise AssertionError(
                            f"kernel vs plain {dtype} {(n, h, w, cin, cout, k)} "
                            f"bias={bias} act={act}: rel err {rel:.3e} > {tol:.0e}")
            worst[dtype] = max(worst[dtype], max(errs.values()))
            bound_ms, bound_by = conv_bound(n, h, w, cin, cout, k, dtype, True)
            emit({"phase": "kernel", "shape_nhwc_cin_cout_k": [n, h, w, cin, cout, k],
                  "dtype": dtype, "rel_err": errs, "tol": tol,
                  "ms": cuda_ms(lambda: fused_conv2d_bias_act(x, wt, b, "relu")),
                  "plain_ms": cuda_ms(lambda: plain_conv2d_bias_act(x, wt, b, "relu")),
                  "library_ms": cuda_ms(_library_call(x, wt, b, "relu")),
                  "bound_ms": bound_ms, "bound_by": bound_by, "card": card})
            del x, wt, b
    torch.cuda.empty_cache()
    emit({"phase": "kernel_summary", "max_rel_err": worst,
          "tol": {"float32": F32_TOL, "bfloat16": BF16_TOL}, "card": card})


def _preprocess(x):
    return normalize(to_tensor(x), IMAGENET_MEAN, IMAGENET_STD)


def _main_path_kernels(model, card):
    """The kernel's calls in one forward of ``model`` at the serving batch:
    each distinct (input shape, weight, bias, act) checked against the plain
    version and timed; per-forward sums weighted by how often it occurs."""
    seen = collections.OrderedDict()

    def hook(mod, args):
        key = (tuple(args[0].shape), id(mod))
        seen[key] = mod

    convs = [m for m in model.modules() if isinstance(m, FusedConv2d)]
    handles = [m.register_forward_pre_hook(hook) for m in convs]
    try:
        x = torch.zeros((SERVE_BATCH, *model.input_shape), device=DEVICE)
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for hnd in handles:
            hnd.remove()
    if len(seen) != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{len(seen)} kernel convs per forward, expected "
                             f"{LAUNCHES_PER_FORWARD}")
    sigs = collections.Counter()
    first = {}
    for (shape, _), mod in seen.items():
        sig = (shape, tuple(mod.weight.shape), mod.bias is not None, mod.act)
        sigs[sig] += 1
        first.setdefault(sig, mod)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    tot = collections.Counter()
    max_abs = 0.0
    rows = []
    with torch.inference_mode():
        for sig, count in sigs.items():
            (n, cin, h, w), (cout, _, k, _), has_b, act = sig
            mod = first[sig]
            x = torch.randn((n, cin, h, w), generator=gen, device=DEVICE)
            x = x.contiguous(memory_format=torch.channels_last)
            wt, b = mod.weight, mod.bias
            got = fused_conv2d_bias_act(x, wt, b, act)
            ref = plain_conv2d_bias_act(x, wt, b, act)
            rel, err = _rel_err(got, ref)
            if not rel <= F32_TOL:
                raise AssertionError(f"main-path conv {sig}: rel err {rel:.3e}")
            max_abs = max(max_abs, err)
            ms = cuda_ms(lambda: fused_conv2d_bias_act(x, wt, b, act))
            plain_ms = cuda_ms(lambda: plain_conv2d_bias_act(x, wt, b, act))
            lib_ms = cuda_ms(_library_call(x, wt, b, act))
            bound_ms, bound_by = conv_bound(n, h, w, cin, cout, k, "float32", has_b)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", bound_ms)):
                tot[key] += count * v
            tot[bound_by] += count * bound_ms
            rows.append({"shape_nhwc_cin_cout_k": [n, h, w, cin, cout, k],
                         "act": act, "count": count, "rel_err": rel, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
    emit({"phase": "main_path_kernels", "dtype": "float32", "batch": SERVE_BATCH,
          "signatures": rows, "per_forward": dict(tot), "card": card})
    return tot, max_abs


def _post_npy(host, port, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        body = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"/predict answered {resp.status}: {body[:300]!r}")
    return np.load(io.BytesIO(body), allow_pickle=False), ms


def _get_json(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"GET {path} answered {resp.status}")
    return json.loads(body)


def phase_serve(card):
    t0 = time.perf_counter()
    model = DeepcvModule(IMAGE_SHAPE, resnet_spec(50), device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        save_model_bundle(d, model)
        gpu_model = load_model_bundle(d, device=DEVICE)
        cpu_model = load_model_bundle(d, device="cpu")
    del model
    build_s = time.perf_counter() - t0
    emit({"phase": "model", "spec": "resnet_spec(50)", "input_shape": list(IMAGE_SHAPE),
          "params": gpu_model.capacity(), "device": str(gpu_model.device),
          "build_save_load_s": round(build_s, 3)})

    kern_tot, max_abs = _main_path_kernels(gpu_model, card)

    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (n, *IMAGE_SHAPE), dtype=np.uint8)
              for n in REQUEST_SIZES]
    pred = Predictor(gpu_model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                     dtype=torch.float32, device=DEVICE)
    server = InferenceServer(pred, port=0, max_batch=SERVE_BATCH, max_wait_ms=5.0,
                             input_shape=IMAGE_SHAPE)
    answers = {i: [] for i in range(len(images))}
    latencies, failures = [], []

    def client(i):
        try:
            for _ in range(ROUNDS):
                y, ms = _post_npy(server.host, server.port, images[i])
                answers[i].append(y)
                latencies.append(ms)
        except Exception as e:  # reported and re-raised by the main thread
            failures.append(f"client {i}: {e!r}")

    # the main path: counts read from zero, right around it
    fused_conv2d_bias_act.launches = 0
    pred.forwards = 0
    try:
        server.start_background()
        server.warmup()
        health = _get_json(server.host, server.port, "/healthz")
        threads = [threading.Thread(target=client, args=(i,), name=f"client{i}")
                   for i in range(len(images))]
        t_req = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HANG_LIMIT_S / 2)
        wall = time.perf_counter() - t_req
        stats = _get_json(server.host, server.port, "/stats")
    finally:
        server.close()
    launches, forwards = fused_conv2d_bias_act.launches, pred.forwards
    if any(t.is_alive() for t in threads) or failures:
        raise RuntimeError(f"requests failed: {failures or 'client thread hung'}")
    if not health.get("ok") or not health.get("ready"):
        raise AssertionError(f"/healthz: {health}")
    if launches != LAUNCHES_PER_FORWARD * forwards or forwards == 0:
        raise AssertionError(f"{launches} kernel launches for {forwards} forwards; "
                             f"expected {LAUNCHES_PER_FORWARD} per forward")

    cpu_pred = Predictor(cpu_model, batch_size=SERVE_BATCH, preprocess=_preprocess,
                         dtype=torch.float32, device="cpu")
    ref_all = cpu_pred(np.concatenate(images))
    # how far the argmax check is from a tie: top-2 gap over the logits' range
    top2 = np.sort(ref_all, axis=-1)[:, -2:]
    margin = float(((top2[:, 1] - top2[:, 0]) / np.ptp(ref_all, axis=-1)).min())
    worst_l2, off = 0.0, 0
    for i, imgs in enumerate(images):
        ref = ref_all[off:off + len(imgs)]
        off += len(imgs)
        for y in answers[i]:
            if y.shape != ref.shape or not np.isfinite(y).all():
                raise AssertionError(f"answer shape {y.shape} / finite check failed")
            rel = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
            worst_l2 = max(worst_l2, rel)
            if not rel <= SERVE_REL_L2:
                raise AssertionError(f"request {i}: rel L2 {rel:.3e} vs CPU")
            if not (y.argmax(-1) == ref.argmax(-1)).all():
                raise AssertionError(f"request {i}: argmax differs from CPU")
    n_req = len(REQUEST_SIZES) * ROUNDS
    n_img = ROUNDS * sum(REQUEST_SIZES)
    emit({"phase": "serve", "requests": n_req, "images": n_img,
          "batches": stats.get("batches"), "max_coalesced": stats.get("max_coalesced"),
          "forwards": forwards, "kernel_launches": launches,
          "launches_per_forward": launches / forwards,
          "p50_ms": statistics.median(latencies), "server_p50_ms": stats.get("latency_p50_ms"),
          "img_per_s": n_img / wall, "rel_l2_vs_cpu": worst_l2, "tol": SERVE_REL_L2,
          "min_top2_margin": margin,
          "card": card})
    bench = pred.benchmark(batch=SERVE_BATCH, n_iters=10)
    emit({"phase": "predictor_benchmark", **bench, "card": card})
    return {"name": "fused_conv2d_bias_act", "route": "cuda",
            "source": "deepcv_tpu_torch/csrc/fused_conv2d_bias_act.cu",
            "replaces": "deepcv_tpu/ops/pallas/fused_layer.py:92",
            "launches": launches, "max_abs_err": max_abs,
            "ms": kern_tot["ms"], "plain_ms": kern_tot["plain_ms"],
            "bound_ms": kern_tot["bound_ms"],
            "bound_by": "operations" if kern_tot["operations"] >= kern_tot["bytes"] else "bytes",
            "library_ms": kern_tot["library_ms"],
            "per": f"one forward of resnet_spec(50) at batch {SERVE_BATCH}, float32",
            "card": card}


def main() -> int:
    faulthandler.dump_traceback_later(HANG_LIMIT_S, exit=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    # references in true float32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_device()
    phase_build()
    phase_kernel(card)
    emit({"kernels": [phase_serve(card)]})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

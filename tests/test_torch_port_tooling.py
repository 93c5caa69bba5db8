"""The port's tooling against the JAX package, on the CPU: the docs builder
(every repo Markdown page byte-equal), the dashboard over one tracker store
(the same runs, the same pages, the HTTP server and its path guard), the
notebook helpers, profiling on ``torch.profiler`` (Chrome traces read back
as op rows, ``model_flops`` of the wide classifier, MFU, determinism), the
type aliases, and the rest of the CLI (``__default__``, ``extra_modules``,
``test``, ``docs``, ``dashboard``)."""
import copy
import http.client
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from deepcv_tpu import dashboard as jdash
from deepcv_tpu import docs_build as jdocs
from deepcv_tpu import notebook as jnb
from deepcv_tpu import types_aliases as jtypes
from deepcv_tpu.config import load_yaml as jax_load_yaml
from deepcv_tpu.pipelines.registry import create_pipelines as jax_create_pipelines
from deepcv_tpu.spec import DeepcvModule as JaxModule
from deepcv_tpu_torch import cli as tcli
from deepcv_tpu_torch import dashboard as tdash
from deepcv_tpu_torch import docs_build as tdocs
from deepcv_tpu_torch import notebook as tnb
from deepcv_tpu_torch import profiling as tprof
from deepcv_tpu_torch import types_aliases as ttypes
from deepcv_tpu_torch.pipelines.registry import create_pipelines
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.train.loggers import ExperimentTracker

REPO = Path(__file__).resolve().parents[1]
#: every Markdown page at the repo root and under docs/ (none is written by a test)
MARKDOWN = sorted(p.relative_to(REPO).as_posix()
                  for p in [*REPO.glob("*.md"), *(REPO / "docs").glob("*.md")])
#: the wide classifier (group norm) at 32x32x3, 10 classes: six convs and the
#: dense, 152,805,376 multiply-adds an image
WIDE_GN_FLOPS = 2 * (32 * 32 * 3 * 64 * 9 + 32 * 32 * 64 * 64 * 9 + 16 * 16 * 64 * 128 * 9
                     + 16 * 16 * 128 * 128 * 9 + 8 * 8 * 128 * 256 * 9
                     + 8 * 8 * 256 * 256 * 9 + 4 * 4 * 256 * 10)


# --------------------------------------------------------------------------- #
# Docs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rel", MARKDOWN)
def test_md_to_html_is_byte_equal_to_jax_on_the_repo_pages(rel):
    md = (REPO / rel).read_text(encoding="utf-8")
    assert tdocs.md_to_html(md) == jdocs.md_to_html(md)


def test_build_docs_writes_the_jax_pages(tmp_path):
    got = tdocs.build_docs(out_dir=str(tmp_path / "port"), root=str(REPO))
    ref = jdocs.build_docs(out_dir=str(tmp_path / "jax"), root=str(REPO))
    assert [p.name for p in got] == [p.name for p in ref]
    assert "index.html" in {p.name for p in got} and "design.html" in {p.name for p in got}
    for g, r in zip(got, ref):
        assert g.read_bytes() == r.read_bytes(), g.name
    with pytest.raises(FileNotFoundError):
        tdocs.build_docs(src_dirs=("nope",), extra_files=(), out_dir=str(tmp_path / "x"),
                         root=str(tmp_path))


# --------------------------------------------------------------------------- #
# Dashboard
# --------------------------------------------------------------------------- #

@pytest.fixture()
def store(tmp_path):
    """Two runs written by the port's ExperimentTracker (the JAX layout)."""
    root = tmp_path / "experiments"
    for name, acc in [("alpha", 0.5), ("beta", 0.8)]:
        tr = ExperimentTracker(root=str(root), experiment="exp1", run_name=name)
        tr.log_params({"lr": 1e-3, "model": name, "opt": {"betas": [0.9, 0.99]}})
        tr.set_tags({"pipeline": "train_image_classifier"})
        for step in range(5):
            tr.log_metrics({"loss": 1.0 - 0.1 * step, "accuracy": acc}, step)
        art = tmp_path / f"{name}.txt"
        art.write_text(f"artifact of {name}")
        tr.log_artifact(art)
        tr.end_run()
    return root


def test_scan_runs_and_pages_equal_jax(store):
    got, ref = tdash.scan_runs(store), jdash.scan_runs(store)
    assert len(got) == 2 and got == ref
    for g, r in zip(got, ref):
        assert tdash.render_run(g) == jdash.render_run(r)
    assert tdash.render_index(got, "http://127.0.0.1:6006/") == \
        jdash.render_index(ref, "http://127.0.0.1:6006/")
    assert tdash.scan_runs(store / "missing") == []


def test_dashboard_server_lists_runs_and_guards_paths(store):
    secret = store.parent / "secret.txt"
    secret.write_text("do not serve")
    server = tdash.DashboardServer(store, port=0).start()
    try:
        resp = urllib.request.urlopen(server.url, timeout=10)
        index = resp.read().decode()
        assert resp.status == 200 and "alpha" in index and "beta" in index
        run = tdash.scan_runs(store)[0]
        name = run["meta"]["run_name"]
        art = urllib.request.urlopen(
            f"{server.url}artifact/exp1/{run['run_id']}/artifacts/{name}.txt",
            timeout=10).read().decode()
        assert art == f"artifact of {name}"
        for path in (f"/artifact/exp1/{run['run_id']}/../../../secret.txt", "/run/exp1/nope"):
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
            conn.request("GET", path)
            r = conn.getresponse()
            assert r.status == 404 and "do not serve" not in r.read().decode()
            conn.close()
    finally:
        server.stop()


# --------------------------------------------------------------------------- #
# Notebook helpers
# --------------------------------------------------------------------------- #

def test_notebook_helpers_match_jax():
    import matplotlib.pyplot as plt

    imgs = (np.random.default_rng(0).random((10, 8, 8, 3)) * 255).astype(np.uint8)
    kw = dict(labels=list(range(10)), classes=[f"c{i}" for i in range(10)], n_cols=4)
    got, ref = tnb.show_batch(torch.from_numpy(imgs), **kw), jnb.show_batch(imgs, **kw)
    assert len(got.axes) == len(ref.axes) == 12
    assert [a.get_title() for a in got.axes] == [a.get_title() for a in ref.axes]
    assert np.array_equal(got.axes[3].images[0].get_array(), ref.axes[3].images[0].get_array())
    history = {"train": [{"step": i, "loss": 1.0 / (i + 1)} for i in range(8)],
               "valid": [{"epoch": e, "valid_accuracy": 0.2 + 0.1 * e,
                          "valid_loss": 1.0 - 0.1 * e} for e in range(3)]}
    for metrics in (None, ["accuracy"]):
        g, r = tnb.plot_history(history, metrics), jnb.plot_history(history, metrics)
        assert [len(a.lines) for a in g.axes] == [len(a.lines) for a in r.axes]
    plt.close("all")
    model = DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": [
        {"flatten": {}}, {"fully_connected": {"out_features": 4}}]}, device="cpu")
    assert tnb.model_summary(model) == str(model.describe())


# --------------------------------------------------------------------------- #
# Profiling
# --------------------------------------------------------------------------- #

def _write_trace(path: Path, events):
    path.write_text(json.dumps({"traceEvents": events}))


def test_trace_op_summary_reads_device_kernels(tmp_path):
    """A Chrome trace as torch.profiler writes it on a card: kernels and
    copies by device and stream, host ops on the CPU plane."""
    kernel = "fused_conv2d_bias_act_tc_kernel<64, false>"
    events = [{"ph": "X", "cat": "kernel", "name": kernel, "pid": 0, "tid": 7, "dur": 12.5,
               "args": {"device": 0, "stream": 7}} for _ in range(6)]
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 8,
                "dur": 100.0, "args": {"device": 0, "stream": 8}},
               {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "tid": 1,
                "dur": 300.0, "args": {}},
               {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7}]
    _write_trace(tmp_path / "trace_1.json", events)
    rows = tprof.trace_op_summary(tmp_path)
    assert rows == [
        {"plane": "GPU 0", "line": "stream 8", "op": "Memcpy HtoD", "total_ms": 0.1, "count": 1},
        {"plane": "GPU 0", "line": "stream 7", "op": kernel, "total_ms": 0.075, "count": 6}]
    assert tprof.trace_op_summary(tmp_path, "CPU") == [
        {"plane": "CPU", "line": "thread 1", "op": "aten::conv2d", "total_ms": 0.3, "count": 1}]
    with pytest.raises(FileNotFoundError):
        tprof.trace_op_summary(tmp_path / "empty")


def test_profile_op_breakdown_traces_a_forward_on_the_cpu(tmp_path):
    model = DeepcvModule((8, 8, 3), {"act_fn": "relu", "architecture": [
        {"conv2d": {"kernel_size": [3, 3], "out_channels": 4, "padding": 1}},
        {"flatten": {}}, {"fully_connected": {"out_features": 2}}]}, device="cpu")
    x = torch.ones(2, 8, 8, 3)
    with torch.no_grad():
        rows = tprof.profile_op_breakdown(model, x, log_dir=str(tmp_path), iters=3, top=0)
    assert set(rows[0]) == {"plane", "line", "op", "total_ms", "count"}
    by_op = {r["op"]: r["count"] for r in rows}
    assert by_op["aten::convolution"] == 3 and by_op["aten::linear"] == 3
    assert list(tmp_path.glob("trace_*.json"))
    assert len(tprof.profile_op_breakdown(model, x, top=2)) == 2


def _wide_gn():
    hp = copy.deepcopy(jax_load_yaml("conf/base/parameters.yml")["wide_classifier_gn_model"])
    hp["architecture"][-1]["fully_connected"]["out_features"] = 10
    return hp


def test_model_flops_of_the_wide_classifier():
    """305,610,752 FLOPs an image on the plain route of a meta copy (K2's
    launch would hide the convs from FlopCounterMode on the card). The JAX
    count is XLA's cost analysis of its program (its own rules, the stem's
    padded channels in): 284,923,712 an image."""
    hp = _wide_gn()
    model = DeepcvModule((32, 32, 3), hp, device="cpu")
    rep = tprof.model_flops(model, batch_size=4)
    assert rep["flops_per_image"] == WIDE_GN_FLOPS == 305_610_752
    assert rep["flops"] == 4 * WIDE_GN_FLOPS and rep["batch_size"] == 4
    assert rep["params"] == model.capacity() == 1_188_170
    assert rep["bytes_accessed"] == 4 * (model.capacity() + 4 * 32 * 32 * 3 + 4 * 10)
    assert model.device.type == "cpu"
    from deepcv_tpu.profiling import model_flops as jax_model_flops
    ref = jax_model_flops(JaxModule((32, 32, 3), hp), batch_size=4)
    assert ref["flops_per_image"] == 284_923_712
    assert ref["params"] - rep["params"] == 3 * 3 * 5 * 64


def test_mfu_report_and_forced_sync_time_on_the_cpu():
    a = torch.ones(64, 64)
    rep = tprof.mfu_report(lambda x: x @ x, a, n=3)
    assert rep["flops"] == 2 * 64 ** 3 and rep["seconds"] > 0 and rep["tflops_per_s"] > 0
    assert rep["mfu"] is None and rep["device_kind"] == "cpu"
    rep = tprof.mfu_report(lambda x: x @ x, a, flops=1e6, n=2, peak_flops=1e12)
    assert rep["flops"] == 1e6 and rep["mfu"] == pytest.approx(1e6 / rep["seconds"] / 1e12)
    assert tprof.PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12}


def test_step_timer_annotate_memory_and_determinism():
    t = tprof.StepTimer(sync=True)
    for _ in range(3):
        with t, tprof.annotate("span"):
            torch.ones(4).sum()
    s = t.summary()
    assert s["n"] == 3 and s["mean_s"] > 0 and tprof.StepTimer().summary() == {}
    assert tprof.device_memory_stats() == {}
    assert tprof.check_determinism(lambda x: (x * 2, [x + 1]), torch.ones(4)) == 0.0
    counter = {"n": 0}

    def racy(x):
        counter["n"] += 1
        return x + counter["n"]

    with pytest.raises(AssertionError, match="Non-determinism"):
        tprof.check_determinism(racy, torch.ones(2))


def test_types_aliases_mirror_jax():
    assert ttypes.__all__ == jtypes.__all__
    assert ttypes.TENSOR_T is torch.Tensor


# --------------------------------------------------------------------------- #
# The registry and the CLI
# --------------------------------------------------------------------------- #

def test_default_pipeline_is_the_union_of_the_jax_registry():
    got, ref = create_pipelines(), jax_create_pipelines()
    assert set(got) == set(ref)
    assert [n.name for n in got["__default__"].nodes] == \
        [n.name for n in ref["__default__"].nodes]
    assert got["__default__"].tags == ref["__default__"].tags
    assert got["train_vit"].name == "train_vit"


PLUGIN = '''
from {pkg}.pipelines.framework import Node, Pipeline


def _echo(x):
    return x


def get_pipelines():
    return {{"echo_pipeline": Pipeline([Node(_echo, ["echo_in"], "echo_out", name="echo")],
                                       name="echo_pipeline", tags=["plugin"])}}
'''


def test_extra_modules_register_a_plugin_in_both_packages(tmp_path, monkeypatch):
    for pkg in ("deepcv_tpu", "deepcv_tpu_torch"):
        (tmp_path / f"plugin_{pkg}.py").write_text(PLUGIN.format(pkg=pkg))
    (tmp_path / "plugin_empty.py").write_text("X = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    plugins = {"enabled": ["video"]}
    got = create_pipelines({**plugins, "extra_modules": ["plugin_deepcv_tpu_torch"]})
    ref = jax_create_pipelines({**plugins, "extra_modules": ["plugin_deepcv_tpu"]})
    assert set(got) == set(ref) and "echo_pipeline" in got
    assert [n.name for n in got["__default__"].nodes] == \
        [n.name for n in ref["__default__"].nodes]
    with pytest.raises(ValueError, match="no get_pipelines"):
        create_pipelines({"extra_modules": ["plugin_empty"]})
    with pytest.raises(ValueError, match="Duplicate pipeline"):
        create_pipelines({"extra_modules": ["plugin_deepcv_tpu_torch",
                                            "plugin_deepcv_tpu_torch"]})
    with pytest.raises(ValueError, match="Unknown task package"):
        create_pipelines({"enabled": ["nope"]})
    # through a project's conf: `plugins:` in parameters.yml, as `list` reads it
    proj = tmp_path / "proj"
    (proj / "conf" / "base").mkdir(parents=True)
    (proj / "conf" / "base" / "parameters.yml").write_text(
        "plugins:\n  enabled: [video]\n  extra_modules: [plugin_deepcv_tpu_torch]\n")
    assert tcli.main(["describe", "--pipeline", "echo_pipeline",
                      "--project-path", str(proj)]) == 0


def test_cli_describe_defaults_to_default(capsys):
    assert tcli.main(["describe", "--project-path", str(REPO)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Pipeline '__default__'")
    names = [n.name for n in jax_create_pipelines()["__default__"].nodes]
    assert [ln.split(":")[0].strip() for ln in out.splitlines()[1:]] == names
    assert tcli.build_parser().parse_args(["run"]).pipeline == "__default__"


def test_cli_test_tiers_pass_through_to_pytest(monkeypatch):
    calls = []
    monkeypatch.setattr("pytest.main", lambda args: calls.append(list(args)) or 0)
    assert tcli.main(["test"]) == 0
    assert tcli.main(["test", "--quick"]) == 0
    assert tcli.main(["test", "--full", "-x", "tests/test_torch_port_meta.py"]) == 0
    assert tcli.main(["test", "-k", "dashboard"]) == 0
    files = [a for a in calls[0] if a.endswith(".py")]
    assert files and all(Path(f).name.startswith("test_torch_") for f in files)
    assert calls[0][-3:] == ["-q", "-m", "smoke"] and calls[1][-3:] == ["-q", "-m", "not slow"]
    assert calls[2] == ["-x", "tests/test_torch_port_meta.py"]
    assert calls[3] == ["-k", "dashboard"]
    with pytest.raises(SystemExit):
        tcli.main(["describe", "--bogus"])


def test_cli_docs_and_dashboard(tmp_path, capsys, store, monkeypatch):
    assert tcli.main(["docs", "--out", str(tmp_path / "site"),
                      "--project-path", str(REPO)]) == 0
    assert (tmp_path / "site" / "index.html").exists()
    assert "pages ->" in capsys.readouterr().out
    served = []
    monkeypatch.setattr(tdash.DashboardServer, "serve_forever",
                        lambda self: served.append((self.root, self.tensorboard_url))
                        or self._httpd.server_close())
    monkeypatch.setattr(tprof, "start_tensorboard_server", lambda logdir: object())
    assert tcli.main(["dashboard", "--root", str(store), "--port", "0",
                      "--tensorboard", str(tmp_path)]) == 0
    assert served == [(store, "http://127.0.0.1:6006/")]
    assert "dashboard: http://127.0.0.1:" in capsys.readouterr().out

"""The port stands alone: ``deepcv_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``deepcv_tpu``, and entry points run on CUDA
unless the caller asks for the CPU (raising, never falling back, when there
is no card)."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepcv_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "deepcv_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("rel", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_imports_nothing_of_jax_or_the_reference(rel):
    bad = [(root, ln) for root, ln in _imported_roots(REPO / rel)
           if root in FORBIDDEN_ROOTS]
    assert not bad, f"{rel} imports {bad}"


def test_import_and_cpu_forward_leave_jax_out_of_sys_modules():
    code = """
import json, sys
import numpy as np
import deepcv_tpu_torch
from deepcv_tpu_torch import cli, config, hyperparams, interop, server  # noqa
from deepcv_tpu_torch.data.transforms import to_tensor
from deepcv_tpu_torch.serve import Predictor
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import resnet_spec
import chip_smoke  # noqa
m = DeepcvModule((32, 32, 3), resnet_spec(50, width=8, num_classes=10, pool_kernel=1),
                 device="cpu")
y = Predictor(m, batch_size=2, preprocess=to_tensor, device="cpu")(
    np.zeros((3, 32, 32, 3), np.uint8))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "deepcv_tpu"))
print(json.dumps({"shape": list(y.shape), "bad": bad}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"shape": [3, 10], "bad": []}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card behaviour is moot")


def test_entry_points_without_device_raise_with_no_card(no_card, tmp_path):
    from deepcv_tpu_torch.cli import main
    from deepcv_tpu_torch.serve import Predictor, load_model_bundle, save_model_bundle
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import resnet_spec

    hp = resnet_spec(50, width=8, num_classes=10, pool_kernel=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepcvModule((32, 32, 3), hp)
    cpu = DeepcvModule((32, 32, 3), hp, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cpu, batch_size=2)
    save_model_bundle(tmp_path, cpu)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_bundle(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--bundle", str(tmp_path), "--port", "0"])
    assert load_model_bundle(tmp_path, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_without_the_repo(no_card, tmp_path):
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_vit_and_training_modules_leave_jax_out_of_sys_modules():
    code = """
import json, sys
import torch
from deepcv_tpu_torch import cli
from deepcv_tpu_torch.ops.attention import flash_attention
from deepcv_tpu_torch.ops.kernels import flash_attention as kernels  # noqa
from deepcv_tpu_torch.pipelines import ProjectContext
from deepcv_tpu_torch.pipelines import classification, registry  # noqa
from deepcv_tpu_torch.data import augmentation, datasets, preprocess, transforms  # noqa
from deepcv_tpu_torch.ops.kernels import fused_augment  # noqa
from deepcv_tpu_torch.ops import hrnet  # noqa
from deepcv_tpu_torch.train import checkpoint, losses, metrics, schedules, training  # noqa
from deepcv_tpu_torch.train import active_learning, boosting, meta_learning  # noqa
from deepcv_tpu_torch.data import training_metadata  # noqa
from deepcv_tpu_torch import dashboard, docs_build, notebook, profiling, types_aliases  # noqa
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import vit_spec
hp = vit_spec("b_16", num_classes=4, attn_impl="flash")
hp["architecture"] = hp["architecture"][:2] + hp["architecture"][-3:]
m = DeepcvModule((32, 32, 3), hp, device="cpu")
m(torch.zeros(2, 32, 32, 3)).sum().backward()
pipes = sorted(ProjectContext(".", device="cpu").pipelines)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "deepcv_tpu"))
print(json.dumps({"pipes": pipes, "bad": bad}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"pipes": ["__default__", "preprocess_cifar10", "preprocess_cifar100",
                             "preprocess_mnist",
                             "train_convnext", "train_densenet", "train_fpn_detector",
                             "train_image_classifier", "train_image_classifier_cifar100",
                             "train_keypoint_detector",
                             "train_mobilenet_v2", "train_mobilenet_v3",
                             "train_object_detector",
                             "train_optical_flow",
                             "train_pose_estimator", "train_resnet50",
                             "train_semantic_segmentation", "train_swin",
                             "train_temporal_classifier", "train_video_classifier",
                             "train_vit", "train_wide_classifier",
                             "train_wide_classifier_gn", "train_wide_classifier_ws"],
                   "bad": []}


def test_run_without_device_raises_with_no_card(no_card):
    from deepcv_tpu_torch.cli import main
    from deepcv_tpu_torch.pipelines import ProjectContext

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", "--pipeline=train_vit", "--project-path", str(REPO)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProjectContext(REPO)


def test_compression_serving_and_sklearn_modules_leave_jax_out_of_sys_modules():
    code = """
import json, sys
import numpy as np, torch
from deepcv_tpu_torch import compression, sklearn_api  # noqa
from deepcv_tpu_torch.ops.kernels import int8_conv  # noqa
from deepcv_tpu_torch.serve import EnsemblePredictor, StackedEnsemble  # noqa
from deepcv_tpu_torch.spec import DeepcvModule
from deepcv_tpu_torch.spec.zoo import resnet_spec
m = DeepcvModule((32, 32, 3), resnet_spec(18, width=8, num_classes=4, pool_kernel=1),
                 device="cpu").eval()
x = torch.zeros(2, 32, 32, 3)
scales = compression.calibrate_int8_scales(m, [x])
y = m.with_options(quantize="int8", quantize_scales=scales)(x)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "deepcv_tpu"))
print(json.dumps({"shape": list(y.shape), "scales": len(scales), "bad": bad}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"shape": [2, 4], "scales": 21, "bad": []}


@pytest.mark.parametrize("rel", sorted(str(p.relative_to(REPO))
                                       for p in (PORT / "csrc").glob("*.cu")))
def test_cuda_sources_are_plain_c_launchers_built_from_the_repo(rel):
    """Every kernel source (``int8_conv.cu`` among them) is one ``nvcc``
    unit with an ``extern "C"`` launcher, no PyTorch header, and a wrapper
    module that builds it by name through ``ops/kernels/_build.py``."""
    src = (REPO / rel).read_text()
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert 'extern "C"' in src and not any(
        h in ln for ln in includes for h in ("torch/", "ATen/", "c10/")), includes
    name = Path(rel).stem
    wrappers = [p for p in (PORT / "ops" / "kernels").glob("*.py")
                if f'_KERNEL = "{name}"' in p.read_text()]
    assert len(wrappers) == 1, (name, wrappers)


def test_predict_and_quantized_entry_points_raise_with_no_card(no_card, tmp_path):
    from deepcv_tpu_torch.cli import main
    from deepcv_tpu_torch.serve import load_model_bundle, save_model_bundle
    from deepcv_tpu_torch.sklearn_api import DeepcvClassifier
    from deepcv_tpu_torch.spec import DeepcvModule
    from deepcv_tpu_torch.spec.zoo import resnet_spec

    hp = resnet_spec(18, width=8, num_classes=4, pool_kernel=1)
    save_model_bundle(tmp_path, DeepcvModule((32, 32, 3), hp, device="cpu"))
    np.save(tmp_path / "x.npy", np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["predict", "--bundle", str(tmp_path), "--input", str(tmp_path / "x.npy"),
              "--output", str(tmp_path / "y.npy")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--bundle", str(tmp_path), "--port", "0", "--quantize", "int8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_bundle(tmp_path, quantize="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepcvModule((32, 32, 3), hp, quantize="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepcvClassifier().fit(np.zeros((4, 8, 8, 3), np.uint8), np.array([0, 1, 0, 1]))


#: a ``file:line`` citation of the JAX package (the ``kernels`` line's
#: ``replaces``, error messages naming the reference), which loads nothing
_CITATION = re.compile(r"deepcv_tpu/[\w/]+\.py:\d+")


def _code_strings(path: Path):
    """The string constants of a Python source that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value, node.lineno


def _c_code(text: str) -> str:
    """C/C++ source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("rel", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*")
     if p.suffix in (".py", ".cpp", ".cu") and "_build" not in p.parts] + ["chip_smoke.py"]))
def test_source_names_no_path_of_the_jax_package(rel):
    """No port source and not ``chip_smoke.py`` reaches into ``deepcv_tpu/``
    (its modules, its built ``runtime/*.so``): no string of the code names a
    path there, or the package's directory as a path part; citing a
    ``file.py:line`` of it is allowed."""
    path = REPO / rel
    if path.suffix == ".py":
        bad = [(s, ln) for s, ln in _code_strings(path)
               if "deepcv_tpu/" in _CITATION.sub("", s) or s.strip("/") == "deepcv_tpu"]
    else:
        bad = [ln for ln in _c_code(path.read_text()).splitlines() if "deepcv_tpu/" in ln]
    assert not bad, f"{rel} names a path of the JAX package: {bad}"


def test_the_host_runtime_loads_only_the_port_libraries():
    """The C++ loader and the range coder, built and used in a fresh
    process: every shared object it maps from the repository lies under
    ``deepcv_tpu_torch/_build/``, none under ``deepcv_tpu/``, and neither
    JAX nor the JAX package is imported."""
    code = """
import json, sys
import numpy as np
from deepcv_tpu_torch.runtime import NativeBatchLoader
from deepcv_tpu_torch.runtime.range_coder import rc_encode, rc_native_available
from deepcv_tpu_torch.codec import quantize_cdf
x = np.zeros((8, 2, 2, 3), np.uint8)
loader = NativeBatchLoader(x, np.arange(8), 4)
next(loader)
loader.close()
cdf = quantize_cdf(np.full((3, 4), 0.25))
rc_encode(np.zeros(3, np.uint16), cdf)
maps = sorted({ln.split()[-1] for ln in open("/proc/self/maps") if ln.rstrip().endswith(".so")
               or ".so." in ln})
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "deepcv_tpu"))
print(json.dumps({"maps": maps, "bad": bad, "native": rc_native_available()}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    ours = [m for m in res["maps"] if m.startswith(str(REPO))]
    assert res["bad"] == [] and res["native"]
    assert not [m for m in ours if "/deepcv_tpu/" in m], ours
    assert sorted(Path(m).name.split("-")[0] for m in ours
                  if Path(m).parent == PORT / "_build") == ["libdeepcv_io", "libdeepcv_rc"]

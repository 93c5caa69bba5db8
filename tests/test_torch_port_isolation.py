"""The port stands alone: ``deepcv_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of ``deepcv_tpu``, and entry points run on CUDA
unless the caller asks for the CPU (raising, never falling back, when there
is no card)."""
import ast
import json
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

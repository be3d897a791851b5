"""The port stands alone: ``src/repro_torch`` imports neither ``jax`` nor
the JAX package ``repro``, and its entry points default to the card."""
import ast
import inspect
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_no_jax_or_repro_import_in_the_port():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_entry_modules_load_without_jax_or_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop\n"
        "import repro_torch.fl.experiment, repro_torch.fed.runtime\n"
        "import repro_torch.fed.kernel_path, repro_torch.kernels.ops\n"
        "import repro_torch.launch.serve, repro_torch.models.transformer\n"
        "import repro_torch.models.mamba, repro_torch.models.moe\n"
        "import repro_torch.configs.registry\n"
        "from repro_torch.fl import Experiment, ExperimentSpec\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, cwd=str(ROOT))
    assert "LOADED []" in r.stdout, r.stdout + r.stderr[-2000:]


def test_entry_points_default_to_cuda():
    from repro_torch import resolve_device
    from repro_torch.fl import Experiment
    from repro_torch.fl.tasks import build_task
    assert inspect.signature(Experiment).parameters["device"].default == "cuda"
    assert inspect.signature(resolve_device).parameters[
        "device"].default == "cuda"
    assert "device" in inspect.signature(build_task).parameters
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            from repro_torch.fl import ExperimentSpec
            Experiment(ExperimentSpec())
    assert resolve_device("cpu").type == "cpu"

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
# msgpack too: the GPU machine has no package of it (the checkpoint codec is
# the port's own)
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


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


def test_port_leaves_the_reference_to_tracelint_tl005():
    """The JAX package's TL005 reads the sweep tables, the config
    dataclasses and the ``structural_config`` collapse it finds over the
    whole source tree; the collapse it keeps is the last one in path order,
    which would be the port's.  The port declares none of them in a form the
    rule reads, so the rule goes on checking the reference."""
    from repro.lint import rules_contracts as rc
    files = sorted(PORT.rglob("*.py"))
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        where = path.relative_to(ROOT)
        assert not any(rc._collapse_kwargs(tree).values()), where
        assert not [n.name for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)
                    and rc._is_dataclass_def(n)
                    and n.name in {c.class_name for c in rc._SPECS}], where
    ref = ast.parse((ROOT / "src/repro/fed/runtime.py").read_text())
    assert "seed" in rc._collapse_kwargs(ref)["fl"]


def test_entry_modules_load_without_jax_or_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop\n"
        "import repro_torch.fl.experiment, repro_torch.fed.runtime\n"
        "import repro_torch.fed.kernel_path, repro_torch.kernels.ops\n"
        "import repro_torch.launch.serve, repro_torch.models.transformer\n"
        "import repro_torch.models.mamba, repro_torch.models.moe\n"
        "import repro_torch.models.xlstm\n"
        "import repro_torch.configs.registry\n"
        "import repro_torch.obs, repro_torch.obs.manifest\n"
        "import repro_torch.fl.sweep, repro_torch.fl.tasks\n"
        "import repro_torch.checkpoint.store, repro_torch.obs.profiling\n"
        "import repro_torch.distribution, repro_torch.distribution.sharding\n"
        "import repro_torch.distribution.tensor_parallel\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.roofline\n"
        "from repro_torch.fl import Experiment, ExperimentSpec\n"
        "from repro_torch.fl import SweepSpec, run_sweep, build_task\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, cwd=str(ROOT))
    assert "LOADED []" in r.stdout, r.stdout + r.stderr[-2000:]


# names that would tie the captured round to the flight recorder
RECORDER_NAMES = {"recorder", "obs", "profiling", "annotate_chunk",
                  "_emit_chunk", "on_chunk", "on_round", "on_eval"}


def _round_functions(tree):
    """``RoundBody`` and every module-level function of the runtime that it
    calls, directly or through another: the code a CUDA graph captures."""
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    todo, seen = ["RoundBody"], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in ast.walk(defs[name]):
            if (isinstance(node, ast.Name) and node.id in defs
                    and isinstance(defs[node.id], ast.FunctionDef)):
                todo.append(node.id)
    return {name: defs[name] for name in seen}


def test_round_body_names_no_recorder():
    """The static half of the recorder's invisibility (the reference's
    TL009): ``RoundBody`` and the round functions it calls name no
    recorder, ``obs`` or profiling hook, so telemetry never reaches the
    captured round."""
    tree = ast.parse((PORT / "fed" / "runtime.py").read_text())
    funcs = _round_functions(tree)
    assert {"_round_math", "_round_math_streaming", "_round_tail",
            "_local_transmit", "_client_block"} <= set(funcs)
    bad = []
    for name, node in funcs.items():
        for sub in ast.walk(node):
            ident = (sub.id if isinstance(sub, ast.Name) else
                     sub.attr if isinstance(sub, ast.Attribute) else
                     sub.arg if isinstance(sub, ast.arg) else None)
            if ident in RECORDER_NAMES:
                bad.append(f"{name}:{sub.lineno} names {ident}")
    assert not bad, bad


# (module, function) of every public entry point that places tensors: each
# takes ``device`` and defaults to the card
ENTRY_POINTS = [
    ("repro_torch.device", "resolve_device"),
    ("repro_torch.fl.experiment", "Experiment"),
    ("repro_torch.fl.sweep", "run_sweep"),
    ("repro_torch.fl.tasks", "build_task"),
    ("repro_torch.interop", "params_from_jax"),
    ("repro_torch.interop", "state_from_jax"),
    ("repro_torch.interop", "model_params_from_jax"),
    ("repro_torch.models.transformer", "init_params"),
    ("repro_torch.models.transformer", "init_cache"),
    ("repro_torch.models.transformer", "init_sharded_params"),
    ("repro_torch.models.blocks", "init_block"),
    ("repro_torch.models.blocks", "init_block_cache"),
    ("repro_torch.models.layers", "init_rmsnorm"),
    ("repro_torch.models.layers", "rope_frequencies"),
    ("repro_torch.models.layers", "init_attention"),
    ("repro_torch.models.layers", "init_mlp"),
    ("repro_torch.models.layers", "init_embeddings"),
    ("repro_torch.models.layers", "init_kv_cache"),
    ("repro_torch.models.mamba", "init_mamba"),
    ("repro_torch.models.mamba", "init_mamba_cache"),
    ("repro_torch.models.moe", "init_moe"),
    ("repro_torch.models.xlstm", "init_mlstm"),
    ("repro_torch.models.xlstm", "init_slstm"),
    ("repro_torch.models.xlstm", "init_mlstm_cache"),
    ("repro_torch.models.xlstm", "init_slstm_cache"),
    ("repro_torch.models.simple", "init_mlp_classifier"),
    ("repro_torch.models.simple", "init_ridge"),
    ("repro_torch.launch.serve", "build_prefill_step"),
    ("repro_torch.launch.serve", "build_prefill_cache_step"),
    ("repro_torch.launch.serve", "build_decode_step"),
    ("repro_torch.launch.train", "build_train_step"),
    ("repro_torch.configs.registry", "make_dummy_inputs"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS,
                         ids=[f"{m.rsplit('.', 1)[1]}.{n}"
                              for m, n in ENTRY_POINTS])
def test_entry_points_default_to_cuda(module, name):
    import importlib
    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card():
    import numpy as np
    from repro_torch import interop, resolve_device
    from repro_torch.fl import Experiment, ExperimentSpec
    from repro_torch.fl.tasks import build_task
    assert "device" in inspect.signature(build_task).parameters
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            Experiment(ExperimentSpec())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            interop.model_params_from_jax({"w": np.zeros(2, np.float32)})
    assert resolve_device("cpu").type == "cpu"
    got = interop.params_from_jax({"w": np.ones(2, np.float32)},
                                  device="cpu")
    assert got["w"].device.type == "cpu"

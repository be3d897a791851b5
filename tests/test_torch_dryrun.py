"""The dry run (``repro_torch.launch.dryrun``) and the roofline
(``repro_torch.analysis.roofline``) against the JAX package's, on the CPU:

* ``plan_for`` gives the reference's plan for the ten configs x four input
  shapes x both production meshes x {``normalized``, ``mean``};
* ``model_flops_for``, ``finalize``'s three terms, ``bottleneck`` and
  ``useful_flops_ratio`` follow the reference's formulae on the same
  inputs (the reference's constants set to the H100's);
* ``ota_params_for`` solves Problem 3 as the reference does for the same
  ``h`` (the two packages draw ``h`` from their own generators);
* ``analyze_one`` (depths 1 and 2, extrapolated) equals ``lower_one`` at
  the full depth of a reduced config of three superblocks, exactly;
* the collective bytes of a (2, 1) mean step are the folds' all-to-alls
  and all-gathers worked out from the gradient's shapes;
* the fake process group is gone after a dry run, also after one that
  raised, and the CLI runs without ``jax`` or ``repro``.

The reference's module sets ``XLA_FLAGS`` for 512 devices on import, so it
runs in one subprocess for the file.  The dry runs here are reduced or
quick pairs; the full sweep is the CLI's (``--all --analysis --isolate``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import roofline as rl
from repro_torch.configs import registry as reg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distribution import ota_collectives as oc
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as tl
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": mesh_lib.ServingMesh(16, 16),
          "2x16x16": mesh_lib.ServingMesh(16, 16, pod=2)}
# the roofline's inputs: (chips, FLOPs, bytes, collective bytes, model FLOPs)
REPORTS = [
    dict(chips=256, flops=3.1e13, bytes=6.2e11, coll={"all-gather": 17},
         model_flops=5.0e15),
    dict(chips=512, flops=1.0e9, bytes=9.9e12, coll={"all-reduce": 4096,
                                                     "all-gather": 1 << 40},
         model_flops=1.0e11),
    dict(chips=256, flops=0.0, bytes=1.0, coll={}, model_flops=0.0),
]
# h for the solve: 16 clients (data), 32 ((pod, data)) and 2 (pod)
OTA = {"data": (("data",), 16), "pod_data": (("pod", "data"), 32),
       "pod": (("pod",), 2)}
# the Problem 3 solves of the two packages: b within SOLVE_REL (the same
# float64 bisection; measured: equal)
SOLVE_REL = 1e-12

REFERENCE_SCRIPT = r'''
import json
import sys

import numpy as np

from repro.analysis import roofline as rl
from repro.configs import registry as reg
from repro.configs.base import INPUT_SHAPES
from repro.launch import dryrun as D

args = json.loads(open(sys.argv[2]).read())


class Mesh:
    def __init__(self, shape):
        self.shape, self.axis_names = dict(shape), tuple(shape)


meshes = {"16x16": Mesh({"data": 16, "model": 16}),
          "2x16x16": Mesh({"pod": 2, "data": 16, "model": 16})}
out = {"plans": {}, "model_flops": {}, "reports": [], "ota": {}}
for arch in reg.ARCH_IDS:
    cfg = reg.get_config(arch)
    for s, shape in INPUT_SHAPES.items():
        out["model_flops"][f"{arch}/{s}"] = rl.model_flops_for(
            cfg, shape, cfg.active_param_count())
        for name, mesh in meshes.items():
            for scheme in ("normalized", "mean"):
                plan = D.plan_for(cfg, shape, mesh, scheme)
                out["plans"][f"{arch}/{s}/{name}/{scheme}"] = {
                    k: list(v) if isinstance(v, tuple) else v
                    for k, v in plan.items()}
rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW = args["constants"]
for c in args["reports"]:
    out["reports"].append(rl.RooflineReport(
        name="x", chips=c["chips"], flops_per_chip=c["flops"],
        bytes_per_chip=c["bytes"],
        coll_bytes_per_chip=sum(c["coll"].values()),
        coll_breakdown=c["coll"], model_flops=c["model_flops"]
    ).finalize().to_dict())
cfg = reg.get_config("granite-moe-1b-a400m")
for key, (axes, h) in args["ota"].items():
    D.chan.draw_channel = lambda _key, _ch, h=h: np.asarray(h)
    p = D.ota_params_for(cfg, meshes["2x16x16"], tuple(axes))
    out["ota"][key] = {"b": np.asarray(p.b).tolist(), "a": float(p.a),
                       "noise_var": p.noise_var}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("REF_DRYRUN_OK")
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _h(k: int) -> list:
    return (np.random.default_rng(k).rayleigh(1e-3, size=k)).tolist()


def _coll(c: dict) -> dict:
    return {k: int(c.get(k, 0)) for k in rl.COLLECTIVES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's plans, model FLOPs, reports and solves, from one
    subprocess."""
    tmp = tmp_path_factory.mktemp("ref_dryrun")
    script = tmp / "ref_dryrun.py"
    script.write_text(REFERENCE_SCRIPT)
    args = tmp / "args.json"
    args.write_text(json.dumps({
        "constants": [rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW],
        "reports": [dict(c, coll=_coll(c["coll"])) for c in REPORTS],
        "ota": {k: [list(axes), _h(n)] for k, (axes, n) in OTA.items()}}))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), str(tmp / "ref.json"),
                        str(args)], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert "REF_DRYRUN_OK" in r.stdout, r.stderr[-4000:]
    return json.loads((tmp / "ref.json").read_text())


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_plan_for_matches_reference(reference, arch):
    cfg = reg.get_config(arch)
    for s, shape in INPUT_SHAPES.items():
        for name, mesh in MESHES.items():
            for scheme in ("normalized", "mean"):
                plan = dryrun.plan_for(cfg, shape, mesh, scheme)
                got = {k: list(v) if isinstance(v, tuple) else v
                       for k, v in plan.items()}
                assert got == reference["plans"][
                    f"{arch}/{s}/{name}/{scheme}"], (s, name, scheme)


@pytest.mark.parametrize("arch", reg.ARCH_IDS)
def test_model_flops_match_reference(reference, arch):
    cfg = reg.get_config(arch)
    for s, shape in INPUT_SHAPES.items():
        assert rl.model_flops_for(cfg, shape, cfg.active_param_count()) \
            == reference["model_flops"][f"{arch}/{s}"], s


@pytest.mark.parametrize("i", range(len(REPORTS)))
def test_roofline_terms_follow_reference(reference, i):
    """The same formulae on the same inputs: every field equal."""
    c = REPORTS[i]
    got = rl.from_counts("x", c["chips"], c["flops"], c["bytes"], c["coll"],
                         c["model_flops"]).to_dict()
    want = reference["reports"][i]
    for k in ("chips", "flops_per_chip", "bytes_per_chip",
              "coll_bytes_per_chip", "coll_breakdown", "model_flops",
              "compute_s", "memory_s", "collective_s", "bottleneck",
              "useful_flops_ratio"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("key", list(OTA))
def test_ota_params_solve_as_reference(reference, key):
    axes, n = OTA[key]
    got = dryrun.ota_params_for(reg.get_config("granite-moe-1b-a400m"),
                                MESHES["2x16x16"], axes, h=_h(n))
    want = reference["ota"][key]
    np.testing.assert_allclose(np.asarray(got.b), want["b"], rtol=SOLVE_REL)
    assert got.a == pytest.approx(want["a"], rel=SOLVE_REL)
    assert got.noise_var == want["noise_var"] and len(got.h) == n


def _reduced(arch: str, superblocks: int) -> dict:
    """The overrides that make ``arch`` its reduced config of
    ``superblocks`` superblocks (the name kept, so the plan is the
    arch's), its chunks at 512 positions."""
    full = reg.get_config(arch)
    red = reg.reduce_config(full)
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
          if f.name != "name" and getattr(red, f.name) != getattr(full,
                                                                   f.name)}
    ov.update(num_layers=len(red.block_pattern) * superblocks,
              attn_q_chunk=512, loss_seq_chunk=512)
    if red.is_encoder_decoder:
        ov["num_encoder_layers"] = superblocks
    return ov


# (arch, multi_pod, scheme): an OTA client over data on 16x16, and on
# 2x16x16 the mean path with FSDP over (pod, data)
ANALYSIS_CASES = {"granite-16x16": ("granite-moe-1b-a400m", False,
                                    "normalized"),
                  "llama3-2x16x16": ("llama3-405b", True, "mean")}


@pytest.mark.parametrize("case", list(ANALYSIS_CASES))
def test_analysis_is_the_full_depth_count(case):
    """Three superblocks: the line through depths 1 and 2 meets the full
    count exactly (FLOPs, bytes, collective bytes by kind)."""
    arch, multi_pod, scheme = ANALYSIS_CASES[case]
    ov = _reduced(arch, 3)
    full = dryrun.lower_one(arch, "train_4k", multi_pod=multi_pod,
                            scheme=scheme, overrides=ov)
    cheap = dryrun.analyze_one(arch, "train_4k", multi_pod=multi_pod,
                               scheme=scheme, overrides=ov)
    assert full["status"] == cheap["status"] == "ok"
    assert cheap["n_superblocks"] == 3 and full["plan"] == cheap["plan"]
    a, b = full["roofline"], cheap["roofline"]
    for k in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
              "coll_breakdown"):
        assert a[k] == b[k], k
    assert a["flops_per_chip"] > 0 and a["coll_bytes_per_chip"] > 0
    assert full["bytes_per_rank"] == cheap["bytes_per_rank"]
    if multi_pod:
        assert full["plan"]["fsdp_axis"] == ["pod", "data"]


def test_recorded_bytes_are_the_running_contexts_log():
    """``tensor_parallel.running_context()`` is the context a ``run_ranks``
    program runs with (None outside one); its ``recorded_bytes`` are the
    bytes its open ``recorded()`` log holds, 0 once the log closes; and a
    train step's record carries them at its peak, within the peak."""
    from repro_torch.distribution import tensor_parallel as tp_lib
    assert tp_lib.running_context() is None

    def program(ctx):
        assert tp_lib.running_context() is ctx
        x = torch.arange(6.0).reshape(2, 3) + ctx.rank
        with ctx.recorded():
            with ctx.scope("s"):
                y = ctx.fold(x, "model", op=torch.maximum)
            held = ctx.recorded_bytes
        return held, ctx.recorded_bytes, y.numel() * y.element_size()

    for held, after, want in tp_lib.run_ranks(
            mesh_lib.make_host_mesh(1, 2, emulate=True), program):
        assert held == want == 24 and after == 0
    assert tp_lib.running_context() is None
    rec = dryrun.lower_one("granite-moe-1b-a400m", "train_4k",
                           overrides=_reduced("granite-moe-1b-a400m", 1))
    assert rec["status"] == "ok"
    assert 0 < rec["recorded_bytes_at_peak"] <= rec["peak_step_bytes"]


def test_mean_step_collectives_are_the_folds_all_gathers():
    """A physical (2, 1) mesh of the fake group, the mean path: every
    gradient leaf, the mask count, the loss and its two metrics fold over
    ``data`` (``ota_collectives.fold_over``: an all-to-all and an
    all-gather of 1 part each, and nothing else)."""
    cfg = dataclasses.replace(
        reg.reduce_config(reg.get_config("h2o-danube-1.8b")),
        dtype="float32")
    meta = torch.device("meta")
    params = T.init_params(cfg, torch.Generator(), device=meta)
    batch = {"tokens": torch.zeros((4, 64), dtype=torch.long, device=meta),
             "labels": torch.zeros((4, 64), dtype=torch.long, device=meta),
             "loss_mask": torch.zeros((4, 64), device=meta)}
    with dryrun.fake_group(2):
        mesh = mesh_lib.make_host_mesh(2, 1)
        assert mesh.physical and mesh.rank == 0
        step, place = tl.build_train_step(cfg, mesh, scheme="mean",
                                          device=meta)
        o = tl.sgd(1e-2)
        p, s, rows = place(params, o.init(params), batch)
        with oc.counting_collectives() as coll:
            step(p, s, rows)
    grads = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    scalars = 4 * 4            # count, loss, nll, aux: fp32
    assert coll == dict({k: 0 for k in rl.COLLECTIVES},
                        **{"all-to-all": grads + scalars,
                           "all-gather": grads + scalars})


def test_dry_run_tears_its_group_down():
    rec = dryrun.lower_one("h2o-danube-1.8b", "decode_32k")
    assert rec["status"] == "ok" and rec["fits"]
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="planted"):
        with dryrun.fake_group(4):
            assert torch.distributed.get_world_size() == 4
            raise RuntimeError("planted")
    assert not torch.distributed.is_initialized()
    # a fresh mesh is emulated again
    assert not mesh_lib.make_host_mesh(2, 2).physical


def test_cli_runs_without_jax(tmp_path):
    """The CLI on the multi-pod mesh (512 fake ranks): a record with the
    roofline, the bytes a rank and the plan, and no jax or repro
    loaded."""
    out = tmp_path / "dry.json"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['dryrun', '--arch', 'jamba-v0.1-52b', '--shape', "
        f"'long_500k', '--multi-pod', '--out', {str(out)!r}]\n"
        "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert "LOADED []" in r.stdout, r.stdout + r.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["plan"]["context_parallel"] is True
    assert rec["roofline"]["chips"] == 512
    assert rec["bytes_per_rank"]["cache"] > 0 and rec["fits"]


def _scan_bytes(mixer: str, s: int) -> int:
    """The counted bytes of a training scan's forward and backward over
    ``s`` steps, on meta tensors (reduced xlstm's sLSTM; a Mamba chunk of
    ``s`` steps at reduced jamba's width)."""
    from repro_torch.models import mamba, xlstm
    meta = torch.device("meta")
    if mixer == "slstm":
        cfg = reg.reduce_config(reg.get_config("xlstm-1.3b"))
        p = xlstm.init_slstm(torch.Generator(), cfg, device=meta)
        x = torch.empty((2, s, cfg.d_model), device=meta, requires_grad=True)

        def run():
            torch.autograd.grad(xlstm.slstm_mix(p, cfg, x).sum(), x)
    else:
        cfg = reg.reduce_config(reg.get_config("jamba-v0.1-52b"))
        shape = (2, s, cfg.mamba_d_inner, cfg.mamba_d_state)
        da = torch.empty(shape, device=meta, requires_grad=True)
        dbu = torch.empty(shape, device=meta, requires_grad=True)
        h0 = torch.zeros((2,) + shape[2:], device=meta)

        def run():
            torch.autograd.grad(mamba._chunk_scan(h0, da, dbu)[0].sum(),
                                (da, dbu))
    return dryrun.count(run)["bytes"]


@pytest.mark.parametrize("mixer", ["slstm", "mamba"])
def test_training_scans_move_bytes_linear_in_their_length(mixer):
    """A scan's backward writes each step's gradient once (the steps are
    ``unbind``'s views), not a zero-padded copy of its whole input a step:
    its bytes double with its length (measured 1.96 sLSTM, 2.01 Mamba;
    indexing a step, ``wx[:, t]``, read 2.74 and 3.90: quadratic)."""
    assert _scan_bytes(mixer, 64) / _scan_bytes(mixer, 32) < 2.2

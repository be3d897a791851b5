"""The port's tracelint (``repro_torch.lint``): its engine against the JAX
package's on the reference's own files, every rule on its fixtures, the
rules on mutated copies of the port, the port lints clean, and the CLI runs
without ``jax`` or ``repro``."""
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro.lint import engine as ref_engine
from repro_torch import lint
from repro_torch.lint import __main__ as cli
from repro_torch.lint import engine, rules_kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "lint_corpus" / "torch"
REF_CORPUS = ROOT / "tests" / "lint_corpus"
RULE_IDS = ("TL001", "TL002", "TL003", "TL004", "TL005", "TL006", "TL007",
            "TL009", "TL010")
REF_FILES = sorted(REF_CORPUS.glob("*.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file, as in the port's other tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def default_run():
    """The port's lint over its default paths, once."""
    return engine.lint(cli.DEFAULT_PATHS, root=ROOT)


def _fixture(stem):
    return next(CORPUS.glob(f"{stem}.*"))


def _lint(path, only=None, root=ROOT):
    _, active, suppressed = engine.lint(
        [str(path)], root=root, include_corpus=True,
        only=set(only) if only else None)
    return active, suppressed


def _rows(findings):
    return [(f.rule_id, f.path, f.line, f.message, f.fix) for f in findings]


# --- parity with the reference's engine ------------------------------------


@pytest.mark.parametrize("path", REF_FILES, ids=[p.name for p in REF_FILES])
def test_suppressions_parse_as_the_reference(path):
    lines = path.read_text().splitlines()
    assert ([dataclasses.astuple(s) for s in engine.parse_suppressions(lines)]
            == [dataclasses.astuple(s)
                for s in ref_engine.parse_suppressions(lines)])


def test_suppressions_parse_as_the_reference_over_src_repro():
    files = sorted((ROOT / "src" / "repro").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        lines = path.read_text().splitlines()
        assert ([dataclasses.astuple(s)
                 for s in engine.parse_suppressions(lines)]
                == [dataclasses.astuple(s)
                    for s in ref_engine.parse_suppressions(lines)]), path


def test_tl000_findings_as_the_reference():
    """TL000's findings (id, line, message, fix) on the reference's corpus
    and on ``src/repro``: the port's engine gives the reference's."""
    paths = ["src/repro"] + [str(p) for p in REF_FILES]
    _, mine, _ = engine.lint(paths, root=ROOT, include_corpus=True,
                             only={"TL000"})
    _, ref, _ = ref_engine.lint(paths, root=ROOT, include_corpus=True,
                                only={"TL000"})
    assert _rows(mine) == _rows(ref)
    assert any(f.rule_id == "TL000" for f in mine)


def test_tl000_fixes_as_the_reference(tmp_path):
    """``apply_fixes`` of TL000 rewrites the reference's corpus into the
    same text under either engine."""
    texts = {}
    for name, eng in (("port", engine), ("ref", ref_engine)):
        d = tmp_path / name / "lint_corpus"
        shutil.copytree(REF_CORPUS, d, ignore=shutil.ignore_patterns(
            "torch", "*.md"))
        project, active, _ = eng.lint([str(d)], root=tmp_path / name,
                                      include_corpus=True, only={"TL000"})
        assert eng.apply_fixes(project, active)
        texts[name] = {p.name: p.read_text() for p in sorted(d.glob("*.py"))}
    assert texts["port"] == texts["ref"]


# --- the corpus --------------------------------------------------------------


def test_registry():
    assert lint.names() == sorted(RULE_IDS)
    with pytest.raises(KeyError):
        lint.get("TL008")
    with pytest.raises(ValueError):
        lint.register(lint.get("TL001"))


@pytest.mark.parametrize("rid", ("TL000",) + RULE_IDS)
def test_rule_fires_on_bad_fixture(rid):
    active, _ = _lint(_fixture(f"{rid.lower()}_bad"))
    assert any(f.rule_id == rid for f in active), \
        f"{rid} silent on its known-bad fixture"


@pytest.mark.parametrize("rid", ("TL000",) + RULE_IDS)
def test_rule_quiet_on_good_fixture(rid):
    active, _ = _lint(_fixture(f"{rid.lower()}_ok"))
    noise = [f for f in active if f.rule_id == rid]
    assert not noise, f"{rid} false positive: {noise[0].message}"


@pytest.mark.parametrize("suffix", (".py", ".cu"))
def test_suppressions_suppress(suffix):
    active, suppressed = _lint(CORPUS / f"suppressed_ok{suffix}")
    assert not active, [f.message for f in active]
    assert suppressed


def test_cu_suppression_needs_a_reason(tmp_path):
    d = tmp_path / "lint_corpus"
    d.mkdir()
    src = (CORPUS / "suppressed_ok.cu").read_text().replace(
        "TL004 fixture: a deliberate half accumulator", "TL004")
    (d / "x.cu").write_text(src)
    active, suppressed = _lint(d / "x.cu", root=tmp_path)
    # as in the reference: the finding stays waived, the waiver is TL000
    assert [f.rule_id for f in active] == ["TL000"]
    assert [f.rule_id for f in suppressed] == ["TL004"]
    assert "`// tracelint: disable=TLxxx <why>`" in active[0].message
    assert active[0].fix[1].endswith(
        "// tracelint: disable=TL004 TODO: justify")


def test_fix_roundtrip(tmp_path):
    """``--fix`` gives each reasonless suppression the placeholder reason,
    and the re-lint is clean."""
    path = tmp_path / "fix_roundtrip.py"
    shutil.copy(CORPUS / "fix_roundtrip.py", path)
    assert cli.main([str(path), "--fix", "--root", str(tmp_path)]) == 0
    assert path.read_text() == \
        (CORPUS / "fix_roundtrip_fixed.py").read_text()


def test_self_test_passes():
    ok, report = engine.self_test(CORPUS, ROOT)
    assert ok, report
    for rid in ("TL000",) + RULE_IDS:
        assert f"ok   {rid}:" in report
    assert report.endswith("self-test: PASS")


def test_self_test_fails_when_a_fixture_is_silenced(tmp_path):
    corpus = tmp_path / "tests" / "lint_corpus" / "torch"
    shutil.copytree(CORPUS, corpus)
    shutil.copy(CORPUS / "tl004_ok.cu", corpus / "tl004_bad.cu")
    ok, report = engine.self_test(corpus, tmp_path)
    assert not ok and "FAIL TL004: no finding on tl004_bad.cu" in report
    assert cli.main(["--self-test", "--root", str(tmp_path)]) == 1
    assert cli.main(["--self-test", "--root", str(ROOT)]) == 0


# --- mutations on a copy ---------------------------------------------------

# the round's modules: runtime -> ota -> kernel_path -> ops -> kernels
ROUND_PATHS = ["src/repro_torch/fed", "src/repro_torch/core",
               "src/repro_torch/kernels", "src/repro_torch/fl/clients.py",
               "src/repro_torch/obs"]


def _copy_port(tmp_path):
    shutil.copytree(ROOT / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))


def _mutated(tmp_path, relpath, old, new, rule, paths=ROUND_PATHS):
    """Lint a copy of the port with ``old`` replaced by ``new`` in
    ``relpath``: the findings of ``rule`` in that file."""
    _copy_port(tmp_path)
    target = tmp_path / relpath
    text = target.read_text()
    assert text.count(old) == 1, old
    target.write_text(text.replace(old, new))
    _, active, _ = engine.lint(paths, root=tmp_path, only={rule})
    return [f for f in active if f.path == relpath]


RUNTIME = "src/repro_torch/fed/runtime.py"
DIAG_CORE = "    diag_core = {\n        \"grad_norm_mean\": torch.mean(norms),"


def test_item_in_round_math_fires_tl001(tmp_path):
    hits = _mutated(tmp_path, RUNTIME, DIAG_CORE,
                    "    tx_energy.item()\n" + DIAG_CORE, "TL001")
    assert hits and ".item()" in hits[0].message


def test_item_reached_across_modules_fires_tl001(tmp_path):
    """``aggregate_kernels`` is reached only through ``ota.aggregate``'s
    function-local import."""
    hits = _mutated(tmp_path, "src/repro_torch/fed/kernel_path.py",
                    "    n = flat.shape[1]\n",
                    "    n = flat.shape[1]\n    scale.sum().item()\n",
                    "TL001")
    assert len(hits) == 1 and ".item()" in hits[0].message


def test_item_in_stage_stays_quiet(tmp_path):
    """The same call in ``_stage``, the host's staging, is no finding."""
    old = "    t = torch.tensor(list(ts), dtype=torch.int64)"
    assert not _mutated(tmp_path, RUNTIME, old,
                        "    eta_first = torch.zeros(()).item()\n" + old,
                        "TL001")


def test_if_on_tensor_in_round_tail_fires_tl003(tmp_path):
    hits = _mutated(
        tmp_path, RUNTIME,
        "    new_params, new_opt_state = opt.update(y, opt_state, params, "
        "lr=r.eta)\n",
        "    if r.participants > 0:\n        y = y\n"
        "    new_params, new_opt_state = opt.update(y, opt_state, params, "
        "lr=r.eta)\n", "TL003")
    assert len(hits) == 1 and "`if`" in hits[0].message


def test_randn_without_generator_fires_tl002(tmp_path):
    hits = _mutated(tmp_path, "src/repro_torch/core/schemes.py",
                    "def _ones(st: DeviceStats) -> torch.Tensor:\n",
                    "def _ones(st: DeviceStats) -> torch.Tensor:\n"
                    "    torch.randn(st.sq_norm.shape)\n", "TL002")
    assert len(hits) == 1 and "generator" in hits[0].message


def test_dropping_a_batched_field_fires_tl005(tmp_path):
    hits = _mutated(tmp_path, RUNTIME,
                    'BATCHED_FL_FIELDS = ("seed", "eta", ',
                    'BATCHED_FL_FIELDS = ("seed", ', "TL005")
    assert any("FLConfig.eta is unclassified" in f.message for f in hits)
    assert any("collapses FLConfig.eta" in f.message for f in hits)


def test_new_field_fires_tl005(tmp_path):
    old = ("    active_gather: bool = False          # fixed-mode active-set "
           "gather\n")
    hits = _mutated(tmp_path, RUNTIME, old,
                    old + "    new_knob: float = 1.0\n", "TL005")
    assert any("new_knob" in f.message for f in hits)


def test_ninth_diag_key_fires_tl006(tmp_path):
    hits = _mutated(tmp_path, RUNTIME,
                    '"num_participants", "csi_gain_err")',
                    '"num_participants", "csi_gain_err", "ninth")',
                    "TL006")
    assert any("ninth" in f.message for f in hits)


def test_recorder_in_round_tail_fires_tl009(tmp_path):
    hits = _mutated(
        tmp_path, RUNTIME,
        "    if r.empty is not None:\n        y = schemes.tree_map(",
        "    recorder.emit({'kind': 'round'})\n"
        "    if r.empty is not None:\n        y = schemes.tree_map(",
        "TL009")
    assert len(hits) == 1 and "emit" in hits[0].message


MOMENTS = "src/repro_torch/kernels/csrc/moments.cu"


@pytest.mark.parametrize("old,new,what", [
    ("  float sq = 0.f, s = 0.f;", "  __nv_bfloat16 sq = 0.f, s = 0.f;",
     "accumulates in __nv_bfloat16"),
    ("    part_sq[k * nchunks + j] = sq;", "    atomicAdd(part_sq + k, sq);",
     "sums a float value by atomics"),
], ids=["bf16_accumulator", "float_atomic"])
def test_moments_mutation_fires_tl004(tmp_path, old, new, what):
    hits = _mutated(tmp_path, MOMENTS, old, new, "TL004",
                    paths=["src/repro_torch/kernels/csrc"])
    assert hits and what in hits[0].message


def test_spill_log_fires_tl010(tmp_path):
    """A compile log of ``moments`` with spills, where ``build.log_path``
    puts it, fires at the kernel's ``__global__`` line."""
    _copy_port(tmp_path)
    from repro_torch.kernels import build
    log = tmp_path / build.log_path("moments").relative_to(ROOT)
    log.parent.mkdir(parents=True)
    log.write_text(_fixture("tl010_bad").read_text())
    project, active, _ = engine.lint(["src/repro_torch/kernels"],
                                     root=tmp_path, only={"TL010"})
    assert [(f.path, f.line) for f in active] == [
        (MOMENTS, rules_kernels.global_line(
            (ROOT / MOMENTS).read_text(), "moments_kernel"))]
    assert "8 bytes stores" in active[0].message
    assert project.ptxas_read == {str(log.relative_to(tmp_path)): 1}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN43_GLOBAL__N__137d2b45_10_moments_cu_0937812314moments_kernelILb1EEE"
     "vPKfxiPfS3_S3_S3_Pj", "moments_kernel"),
    ("_ZN49_GLOBAL__N__c432ba72_16_ota_superpose_cu_295093ee21superpose_fold_"
     "kernelEPKfS1_S1_ixPf", "superpose_fold_kernel"),
    ("_Z14moments_kernelILb0EEvPKf", "moments_kernel"),
    ("plain_c_kernel", "plain_c_kernel"),
], ids=["anonymous_namespace", "no_template", "global", "extern_c"])
def test_entry_names_of_ptxas(mangled, name):
    """The kernel's own name in ptxas's entry symbols (nvcc puts a file's
    kernels in an anonymous namespace), for TL010's anchor."""
    assert rules_kernels.demangled_name(mangled) == name


def test_log_paths_are_build_s():
    """TL010 finds each source's log where ``build.log_path`` writes it,
    reading ``build.py`` as text."""
    from repro_torch.kernels import build
    project = engine.build_project(["src/repro_torch/kernels"], root=ROOT)
    got = {name: log for name, _, log in rules_kernels.build_logs(project)}
    assert got == {name: build.log_path(name).resolve()
                   for name in build.SOURCES}


def test_parse_ptxas_is_build_s():
    from repro_torch.kernels import build
    text = _fixture("tl010_bad").read_text() + _fixture("tl010_ok").read_text()
    mine = rules_kernels.parse_ptxas(text)
    for row in mine.values():
        row.pop("line")
    assert mine == build.parse_ptxas(text)


# --- the repo is clean -------------------------------------------------------


def test_port_lints_clean(default_run):
    project, active, suppressed = default_run
    assert not active, "\n".join(
        f"{f.path}:{f.line}: {f.rule_id} {f.message}" for f in active)
    from repro_torch.kernels import build
    # every kernel source is linted (seven since the channel-noise kernel)
    assert len(project.modules) > 100 and len(project.sources) == len(
        build.SOURCES) == 7
    assert {f.rule_id for f in suppressed} <= {"TL001", "TL003"}


def test_json_report_shape(default_run):
    project, active, suppressed = default_run
    payload = json.loads(engine.render_json(
        active, suppressed, engine.n_files(project), project.ptxas_read))
    assert [r["id"] for r in payload["rules"]] == sorted(RULE_IDS)
    assert payload["findings"] == []
    assert payload["files"] == len(project.modules) + 7
    assert set(payload["ptxas"]) == {"logs", "entries"}


def test_captured_round_reach(default_run):
    """The captured round spans the modules of the round, and the host's
    staging is outside it."""
    from repro_torch.lint.context import find_captured
    cap = find_captured(default_run[0])
    for module, name in [
            ("repro_torch.fed.runtime", "__call__"),
            ("repro_torch.fed.runtime", "_round_math_streaming"),
            ("repro_torch.core.ota", "aggregate"),
            ("repro_torch.fed.kernel_path", "aggregate_kernels"),
            ("repro_torch.kernels.ops", "ota_superpose"),
            ("repro_torch.kernels.grad_norm", "batched_moments_cuda"),
            ("repro_torch.optim.optimizers", "update")]:
        assert cap.reached(module, name), (module, name)
    for module, name in [("repro_torch.fed.runtime", "_stage"),
                         ("repro_torch.fed.runtime", "_refresh"),
                         ("repro_torch.fed.runtime", "_emit_chunk"),
                         ("repro_torch.channels.models", "init")]:
        assert not cap.reached(module, name), (module, name)


# --- no jax ------------------------------------------------------------------


def test_cli_runs_without_jax():
    """``python -m repro_torch.lint`` with ``jax`` and ``repro`` blocked."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['lint', 'src/repro_torch/lint', '--json']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.lint', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('EXIT', e.code)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.stdout.rstrip().endswith("EXIT 0"), r.stdout + r.stderr[-3000:]
    payload = json.loads(r.stdout[:r.stdout.rindex("EXIT")])
    assert payload["findings"] == [] and payload["files"] >= 9

"""tracelint driver: file collection, suppressions, output, self-test, --fix
(the JAX package's ``lint/engine.py``, widened to the CUDA sources and
ptxas logs the port's kernel rules read).

Suppression syntax (checked by the TL000 meta-rule):

    x = t.item()   # tracelint: disable=TL001 host-side setup path
    # tracelint: disable=TL002,TL003 fixture draws from the global stream
    y = draw()

An inline comment suppresses its own line; a comment-only line suppresses the
next line.  The free text after the rule list is the *reason* and is
mandatory: a reasonless suppression is itself a finding (TL000), fixable by
``--fix`` into a canonical ``TODO: justify`` placeholder so the gap stays
visible in review.  A ``.cu`` source writes the same comment with ``//``
(``// tracelint: disable=TL004 <reason>``).

Files: ``*.py`` (parsed), ``*.cu`` (read as text, for TL004) under the given
paths, and ``*.log`` files named explicitly (ptxas reports, for TL010).  A
path with ``*`` in it is a glob from the root.  TL010 also finds the compile
logs of ``kernels/build.py``'s sources by itself.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import base
from .base import Finding

# directories never linted as part of a normal run: the corpus is known-bad
# by design and only consulted by --self-test / the unit tests.
EXCLUDED_PARTS = {"lint_corpus", "__pycache__", ".git"}
# the suffixes a directory is searched for; a .log is read only when named
DIR_SUFFIXES = (".py", ".cu")
FILE_SUFFIXES = (".py", ".cu", ".log")

SUPPRESS_RE = re.compile(
    r"#\s*tracelint:\s*disable=([A-Za-z0-9,\s]*?[A-Za-z0-9])(?:\s+(.+))?\s*$")
CU_SUPPRESS_RE = re.compile(
    r"//\s*tracelint:\s*disable=([A-Za-z0-9,\s]*?[A-Za-z0-9])(?:\s+(.+))?\s*$")
CANONICAL_SUPPRESS = "# tracelint: disable={ids} {reason}"
CU_CANONICAL_SUPPRESS = "// tracelint: disable={ids} {reason}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int              # the line the suppression APPLIES to
    comment_line: int      # the line the comment sits on
    rule_ids: Tuple[str, ...]
    reason: Optional[str]
    raw: str               # full original line text (for --fix)


@dataclasses.dataclass
class ModuleInfo:
    path: pathlib.Path
    relpath: str
    text: str
    lines: List[str]
    tree: ast.Module
    suppressions: List[Suppression]
    _nodes: Optional[List[ast.AST]] = None

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree (``ast.walk`` order), walked once."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes


@dataclasses.dataclass
class TextInfo:
    """A file read as text: a ``.cu`` source or a ptxas ``.log``."""
    path: pathlib.Path
    relpath: str
    text: str
    lines: List[str]
    suppressions: List[Suppression]


@dataclasses.dataclass
class Project:
    root: pathlib.Path
    modules: List[ModuleInfo]
    sources: List[TextInfo] = dataclasses.field(default_factory=list)
    logs: List[TextInfo] = dataclasses.field(default_factory=list)
    # analyses shared by several rules (the captured round), made once
    cache: Dict[str, object] = dataclasses.field(default_factory=dict)
    # what TL010 read: log relpath -> entry functions in it
    ptxas_read: Dict[str, int] = dataclasses.field(default_factory=dict)

    def suppressions_for(self, relpath: str) -> Dict[int, List[Suppression]]:
        for mod in list(self.modules) + self.sources + self.logs:
            if mod.relpath == relpath:
                out: Dict[int, List[Suppression]] = {}
                for sup in mod.suppressions:
                    out.setdefault(sup.line, []).append(sup)
                return out
        return {}


def parse_suppressions(lines: List[str],
                       pattern: "re.Pattern" = SUPPRESS_RE
                       ) -> List[Suppression]:
    out: List[Suppression] = []
    for i, line in enumerate(lines, start=1):
        m = pattern.search(line)
        if not m:
            continue
        ids = tuple(s.strip().upper() for s in m.group(1).split(",")
                    if s.strip())
        reason = m.group(2).strip() if m.group(2) else None
        # comment-only line guards the NEXT line; inline guards its own
        code_before = line[:m.start()].strip()
        target = i + 1 if code_before == "" else i
        out.append(Suppression(line=target, comment_line=i, rule_ids=ids,
                               reason=reason, raw=line))
    return out


def _relpath(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


def load_module(path: pathlib.Path, root: pathlib.Path
                ) -> Optional[ModuleInfo]:
    try:
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError) as exc:
        print(f"tracelint: skipping unparsable {path}: {exc}", file=sys.stderr)
        return None
    lines = text.splitlines()
    return ModuleInfo(path=path, relpath=_relpath(path, root), text=text,
                      lines=lines, tree=tree,
                      suppressions=parse_suppressions(lines))


def load_text(path: pathlib.Path, root: pathlib.Path) -> Optional[TextInfo]:
    try:
        text = path.read_text()
    except (UnicodeDecodeError, OSError) as exc:
        print(f"tracelint: skipping unreadable {path}: {exc}", file=sys.stderr)
        return None
    lines = text.splitlines()
    sups = parse_suppressions(lines, CU_SUPPRESS_RE) \
        if path.suffix == ".cu" else []
    return TextInfo(path=path, relpath=_relpath(path, root), text=text,
                    lines=lines, suppressions=sups)


def collect_files(paths: Sequence[str], root: pathlib.Path,
                  include_corpus: bool = False) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        if "*" in p:
            matched = sorted(root.glob(p))
        else:
            path = pathlib.Path(p)
            matched = [path if path.is_absolute() else root / path]
        for path in matched:
            if path.is_file() and path.suffix in FILE_SUFFIXES:
                files.append(path)
            elif path.is_dir():
                files.extend(sorted(f for f in path.rglob("*")
                                    if f.suffix in DIR_SUFFIXES
                                    and f.is_file()))
    excluded = EXCLUDED_PARTS - ({"lint_corpus"} if include_corpus else set())
    seen: Set[pathlib.Path] = set()
    out = []
    for f in files:
        if set(f.parts) & excluded or f in seen:
            continue
        seen.add(f)
        out.append(f)
    return out


def build_project(paths: Sequence[str], root: Optional[pathlib.Path] = None,
                  include_corpus: bool = False) -> Project:
    root = root or pathlib.Path.cwd()
    project = Project(root=root, modules=[])
    for f in collect_files(paths, root, include_corpus=include_corpus):
        if f.suffix == ".py":
            mod = load_module(f, root)
            if mod is not None:
                project.modules.append(mod)
            continue
        info = load_text(f, root)
        if info is not None:
            (project.sources if f.suffix == ".cu" else
             project.logs).append(info)
    return project


def _tl000(project: Project) -> List[Finding]:
    """Meta-rule: every suppression must carry a reason string."""
    findings: List[Finding] = []
    for mod in list(project.modules) + project.sources:
        cu = mod.relpath.endswith(".cu")
        pattern = CU_SUPPRESS_RE if cu else SUPPRESS_RE
        for sup in mod.suppressions:
            if sup.reason:
                continue
            canonical = (CU_CANONICAL_SUPPRESS if cu else
                         CANONICAL_SUPPRESS).format(
                ids=",".join(sup.rule_ids), reason="TODO: justify")
            m = pattern.search(sup.raw)
            fixed = sup.raw[:m.start()] + canonical if m else sup.raw
            lead = "//" if cu else "#"
            findings.append(Finding(
                "TL000", mod.relpath, sup.comment_line,
                f"suppression of {','.join(sup.rule_ids)} has no reason; "
                f"`{lead} tracelint: disable=TLxxx <why>` documents the "
                f"waiver", fix=(sup.raw, fixed)))
    return findings


def run_rules(project: Project,
              only: Optional[Set[str]] = None) -> List[Finding]:
    findings = [] if (only and "TL000" not in only) else _tl000(project)
    for rule in base.all_rules():
        if only and rule.id not in only:
            continue
        findings.extend(rule.check(project))
    return findings


def split_suppressed(project: Project, findings: List[Finding]
                     ) -> Tuple[List[Finding], List[Finding]]:
    """(active, suppressed).  TL000 is never suppressible by itself — a
    reasonless suppression cannot waive its own hygiene finding."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    by_path: Dict[str, Dict[int, List[Suppression]]] = {}
    for f in findings:
        sups = by_path.setdefault(f.path, project.suppressions_for(f.path))
        hit = any(f.rule_id in s.rule_ids
                  for s in sups.get(f.line, ()))
        if hit and f.rule_id != "TL000":
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed


def lint(paths: Sequence[str], root: Optional[pathlib.Path] = None,
         include_corpus: bool = False,
         only: Optional[Set[str]] = None
         ) -> Tuple[Project, List[Finding], List[Finding]]:
    project = build_project(paths, root, include_corpus=include_corpus)
    findings = run_rules(project, only=only)
    active, suppressed = split_suppressed(project, findings)
    active.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return project, active, suppressed


def apply_fixes(project: Project, findings: Iterable[Finding]) -> List[str]:
    """Apply whole-line fixes whose original text still matches on disk.
    Returns the relpaths that were rewritten."""
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        if f.fix is not None:
            by_path.setdefault(f.path, []).append(f)
    touched: List[str] = []
    for relpath, fs in sorted(by_path.items()):
        mod = next((m for m in list(project.modules) + project.sources
                    if m.relpath == relpath), None)
        if mod is None:
            continue
        lines = mod.path.read_text().splitlines(keepends=True)
        changed = False
        for f in fs:
            idx = f.line - 1
            orig, new = f.fix
            if 0 <= idx < len(lines) and lines[idx].rstrip("\n") == orig:
                eol = "\n" if lines[idx].endswith("\n") else ""
                lines[idx] = new + eol
                changed = True
        if changed:
            mod.path.write_text("".join(lines))
            touched.append(relpath)
    return touched


def n_files(project: Project) -> int:
    """The files a run linted: the parsed modules and the CUDA sources."""
    return len(project.modules) + len(project.sources)


def render_human(active: List[Finding], suppressed: List[Finding],
                 n_files: int) -> str:
    out = []
    for f in active:
        tag = " [fixable]" if f.fix is not None else ""
        out.append(f"{f.path}:{f.line}: {f.rule_id} {f.message}{tag}")
    out.append(f"tracelint: {len(active)} finding(s) "
               f"({len(suppressed)} suppressed) across {n_files} file(s), "
               f"{len(base.names())} rules")
    return "\n".join(out)


def render_json(active: List[Finding], suppressed: List[Finding],
                n_files: int,
                ptxas: Optional[Dict[str, int]] = None) -> str:
    """The report; ``ptxas`` is ``Project.ptxas_read`` (log -> entry
    functions), given as ``{"logs": [...], "entries": n}``."""
    ptxas = ptxas or {}
    return json.dumps({
        "rules": [{"id": r.id, "name": r.name, "summary": r.summary,
                   "contract": r.contract, "fixable": r.fixable}
                  for r in base.all_rules()],
        "files": n_files,
        "findings": [f.to_json() for f in active],
        "suppressed": [f.to_json() for f in suppressed],
        "ptxas": {"logs": sorted(ptxas), "entries": sum(ptxas.values())},
    }, indent=2)


def _fixture(corpus_dir: pathlib.Path, stem: str) -> Optional[pathlib.Path]:
    for suffix in FILE_SUFFIXES:
        path = corpus_dir / f"{stem}{suffix}"
        if path.exists():
            return path
    return None


def self_test(corpus_dir: pathlib.Path, root: pathlib.Path
              ) -> Tuple[bool, str]:
    """Prove every registered rule fires on its known-bad fixture and stays
    quiet on its known-good twin; prove suppressions suppress.  A fixture
    has the suffix its rule reads (``.py``, ``.cu`` or ``.log``).  Returns
    (ok, report)."""
    report: List[str] = []
    ok = True
    rule_ids = ["TL000"] + base.names()
    for rule_id in rule_ids:
        low = rule_id.lower()
        bad = _fixture(corpus_dir, f"{low}_bad")
        good = _fixture(corpus_dir, f"{low}_ok")
        if bad is None:
            ok = False
            report.append(f"FAIL {rule_id}: missing corpus fixture "
                          f"{low}_bad.*")
            continue
        _, active, _ = lint([str(bad)], root=root, include_corpus=True)
        fired = [f for f in active if f.rule_id == rule_id]
        if fired:
            report.append(f"ok   {rule_id}: fires on {bad.name} "
                          f"({len(fired)} finding(s))")
        else:
            ok = False
            report.append(f"FAIL {rule_id}: no finding on {bad.name}")
        if good is not None:
            _, active_g, _ = lint([str(good)], root=root, include_corpus=True)
            noise = [f for f in active_g if f.rule_id == rule_id]
            if noise:
                ok = False
                report.append(f"FAIL {rule_id}: false positive on "
                              f"{good.name}:{noise[0].line}")
    for sup in sorted(corpus_dir.glob("suppressed_ok.*")):
        _, active_s, suppressed_s = lint([str(sup)], root=root,
                                         include_corpus=True)
        if active_s:
            ok = False
            report.append(f"FAIL suppressions: {len(active_s)} finding(s) "
                          f"leaked through {sup.name} "
                          f"(first: {active_s[0].rule_id}:{active_s[0].line})")
        elif not suppressed_s:
            ok = False
            report.append(f"FAIL suppressions: nothing to suppress in "
                          f"{sup.name}")
        else:
            report.append(f"ok   suppressions: {len(suppressed_s)} "
                          f"finding(s) suppressed in {sup.name}")
    report.append("self-test: " + ("PASS" if ok else "FAIL"))
    return ok, "\n".join(report)

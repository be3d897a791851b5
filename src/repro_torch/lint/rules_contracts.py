"""Config-classification and diagnostics-sync contracts: TL005, TL006 (the
reference's checks, over the port's declarations).

TL005 guards the sweep engine's batchable/structural split: every field of
``FLConfig`` / ``ChannelConfig`` / ``ClientConfig`` must be claimed by
exactly one of the ``BATCHED_*_FIELDS`` tables or the ``STRUCTURAL_*_FIELDS``
tables, every batched field must be collapsed by the port's structural
signature ``runtime._structural_collapse`` (else two configs that differ in
it would share one engine and its CUDA graph), and the collapse must not
touch a structural field.  ``OTAConfig`` has no batched lanes, so its whole
field set must be claimed by ``STRUCTURAL_OTA_FIELDS``.  The port declares
its configs with ``@config`` (``repro_torch._config``), not
``@dataclasses.dataclass``: the reference's TL005 reads the latter, and the
reference's own ``structural_config``, over the whole source tree, so the
port keeps out of its way.

TL006 keeps ``DIAG_KEYS`` and the history dicts assembled in
``fed/runtime.py`` in lockstep: each ``diag_core`` literal must be a subset,
and each final ``diag`` literal (with ``**diag_core`` expanded) must equal
``DIAG_KEYS`` exactly -- ``RoundBody`` stacks ``diag[k] for k in DIAG_KEYS``
into the [T, 8] history, so a key missing from the dict fails there and a
key missing from ``DIAG_KEYS`` is dropped.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, Rule, register
from .context import dotted

# the port's structural signature (the reference names it structural_config)
COLLAPSE_FUNCTION = "_structural_collapse"
# decorators that declare a config record
CONFIG_DECORATORS = ("config", "dataclass")


@dataclasses.dataclass(frozen=True)
class _ClassSpec:
    class_name: str
    batched_table: Optional[str]
    structural_table: str
    # how the collapse reaches the class: 'fl' = replace(cfg, ...), any
    # other name = replace(cfg.<name>, ...), None = not collapsed
    collapse: Optional[str]


_SPECS = (
    _ClassSpec("FLConfig", "BATCHED_FL_FIELDS", "STRUCTURAL_FL_FIELDS", "fl"),
    _ClassSpec("ChannelConfig", "BATCHED_CHANNEL_FIELDS",
               "STRUCTURAL_CHANNEL_FIELDS", "channel"),
    _ClassSpec("ClientConfig", "BATCHED_CLIENT_FIELDS",
               "STRUCTURAL_CLIENT_FIELDS", "client"),
    _ClassSpec("OTAConfig", None, "STRUCTURAL_OTA_FIELDS", None),
)

# nested configs the collapse rebuilds through replace(cfg.<attr>, ...); the
# FLConfig keywords that pass them back are not collapsed fields
_NESTED_COLLAPSE = ("channel", "client")


def is_config_def(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        name = dotted(dec.func if isinstance(dec, ast.Call) else dec)
        if name.rsplit(".", 1)[-1] in CONFIG_DECORATORS:
            return True
    return False


def _fields(node: ast.ClassDef) -> List[Tuple[str, int]]:
    """(field, lineno) for every annotated field."""
    out = []
    for stmt in node.body:
        if isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            if "ClassVar" in ast.dump(stmt.annotation):
                continue
            out.append((stmt.target.id, stmt.lineno))
    return out


def string_tuple(tree: ast.Module, name: str
                 ) -> Optional[Tuple[List[str], int]]:
    """The strings of a module-level ``name = (...)`` and its line."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    vals = [e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)]
                    return vals, node.lineno
    return None


def collapse_kwargs(tree: ast.Module) -> Tuple[Dict[str, Set[str]], int]:
    """Keyword names of the ``dataclasses.replace`` calls in the collapse,
    keyed by 'fl' (first argument a bare name) or the nested attribute
    (``cfg.channel``, ``cfg.client``), and the collapse's line (0: none)."""
    out: Dict[str, Set[str]] = {"fl": set()}
    out.update({k: set() for k in _NESTED_COLLAPSE})
    line = 0
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name == COLLAPSE_FUNCTION):
            continue
        line = fn.lineno
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and dotted(node.func).endswith("replace") and node.args:
                first = node.args[0]
                if isinstance(first, ast.Name):
                    kind = "fl"
                elif isinstance(first, ast.Attribute) and first.attr in out:
                    kind = first.attr
                else:
                    continue
                out[kind] |= {kw.arg for kw in node.keywords if kw.arg}
    return out, line


def _tl005(project) -> List[Finding]:
    findings: List[Finding] = []
    # classes, tables and the collapse live in different modules
    # (runtime.py: FLConfig, its tables and the collapse; channel.py:
    # ChannelConfig; clients.py and ota.py: theirs)
    classes: Dict[str, Tuple[str, ast.ClassDef]] = {}
    tables: Dict[str, Tuple[str, List[str], int]] = {}
    collapse: Dict[str, Set[str]] = {}
    collapse_at: Tuple[Optional[str], int] = (None, 0)
    names = {s.class_name for s in _SPECS}
    for mod in project.modules:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef) and node.name in names \
                    and is_config_def(node):
                classes[node.name] = (mod.relpath, node)
        for spec in _SPECS:
            for tname in (spec.batched_table, spec.structural_table):
                if tname and tname not in tables:
                    hit = string_tuple(mod.tree, tname)
                    if hit is not None:
                        tables[tname] = (mod.relpath, hit[0], hit[1])
        got, line = collapse_kwargs(mod.tree)
        if line:
            collapse, collapse_at = got, (mod.relpath, line)

    for spec in _SPECS:
        if spec.class_name not in classes:
            continue
        cls_path, cls_node = classes[spec.class_name]
        fields = _fields(cls_node)
        field_names = {f for f, _ in fields}
        batched = tables.get(spec.batched_table or "", ("", [], 0))[1]
        structural = tables.get(spec.structural_table, ("", [], 0))[1]

        for fname, lineno in fields:
            in_b, in_s = fname in batched, fname in structural
            if not in_b and not in_s:
                findings.append(Finding(
                    "TL005", cls_path, lineno,
                    f"{spec.class_name}.{fname} is unclassified: add it to "
                    f"{spec.batched_table or 'a batched table'} (sweep lane) "
                    f"or {spec.structural_table} (structural axis)"))
            elif in_b and in_s:
                findings.append(Finding(
                    "TL005", cls_path, lineno,
                    f"{spec.class_name}.{fname} is claimed by BOTH "
                    f"{spec.batched_table} and {spec.structural_table}; "
                    f"a field has exactly one classification"))

        for tname in (spec.batched_table, spec.structural_table):
            if tname and tname in tables:
                tpath, tvals, tline = tables[tname]
                for stale in [v for v in tvals if v not in field_names]:
                    findings.append(Finding(
                        "TL005", tpath, tline,
                        f"{tname} lists {stale!r} which is not a field of "
                        f"{spec.class_name} (stale classification entry)"))

        path, line = collapse_at
        if spec.collapse is None or path is None:
            continue
        ckw = collapse[spec.collapse]
        for fname in batched:
            if fname in field_names and fname not in ckw:
                findings.append(Finding(
                    "TL005", path, line,
                    f"batched field {spec.class_name}.{fname} is not "
                    f"collapsed by {COLLAPSE_FUNCTION}; two configs "
                    f"differing only in it would share one engine (one CUDA "
                    f"graph) with distinct structure"))
        for kname in sorted(ckw):
            if kname in field_names and kname not in batched \
                    and not (spec.collapse == "fl"
                             and kname in _NESTED_COLLAPSE):
                findings.append(Finding(
                    "TL005", path, line,
                    f"{COLLAPSE_FUNCTION} collapses {spec.class_name}."
                    f"{kname} which is not in {spec.batched_table}; "
                    f"structurally-distinct configs would alias"))
    return findings


def _dict_assigns(mod, names: Tuple[str, ...]
                  ) -> List[Tuple[str, ast.Dict, int]]:
    out = []
    for node in mod.nodes:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in names:
                    out.append((t.id, node.value, node.lineno))
    return out


def _dict_keys(d: ast.Dict) -> Tuple[Set[str], List[str]]:
    """(string keys, names of **-unpacked dicts)."""
    keys: Set[str] = set()
    unpacked: List[str] = []
    for k, v in zip(d.keys, d.values):
        if k is None:
            if isinstance(v, ast.Name):
                unpacked.append(v.id)
        elif isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
    return keys, unpacked


def _tl006(project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        hit = string_tuple(mod.tree, "DIAG_KEYS")
        if hit is None:
            continue
        diag_keys, dk_line = set(hit[0]), hit[1]
        assigns = _dict_assigns(mod, ("diag", "diag_core"))
        core_sets = [_dict_keys(d)[0] for n, d, _ in assigns
                     if n == "diag_core"]
        produced: Set[str] = set()
        for name, d, lineno in assigns:
            keys, unpacked = _dict_keys(d)
            if name == "diag_core":
                extra = keys - diag_keys
                if extra:
                    findings.append(Finding(
                        "TL006", mod.relpath, lineno,
                        f"diag_core writes keys {sorted(extra)} that are not "
                        f"in DIAG_KEYS (line {dk_line})"))
                produced |= keys
                continue
            # the final diag: expand **diag_core against every diag_core
            # variant (the dense and the streaming round must BOTH complete
            # the key set)
            variants = core_sets if ("diag_core" in unpacked and core_sets) \
                else [set()]
            for core in variants:
                full = keys | core
                missing, extra = diag_keys - full, full - diag_keys
                if missing:
                    findings.append(Finding(
                        "TL006", mod.relpath, lineno,
                        f"diag dict is missing DIAG_KEYS entries "
                        f"{sorted(missing)}; the round stacks every key "
                        f"into its history row"))
                if extra:
                    findings.append(Finding(
                        "TL006", mod.relpath, lineno,
                        f"diag dict writes keys {sorted(extra)} that are not "
                        f"in DIAG_KEYS; they would be dropped silently"))
            produced |= keys
        if assigns:
            never = diag_keys - produced - set().union(*core_sets)
            for key in sorted(never):
                findings.append(Finding(
                    "TL006", mod.relpath, dk_line,
                    f"DIAG_KEYS entry {key!r} is never written by any diag "
                    f"dict in this module"))
    return findings


register(Rule(
    id="TL005", name="config-classification-completeness",
    summary="every config field claimed by the batched or the structural "
            "tables, and _structural_collapse consistent with them",
    contract="run_batched's engine sharing (one CUDA graph a structural "
             "group; each lane bitwise its own run)",
    check=_tl005))

register(Rule(
    id="TL006", name="diag-keys-sync",
    summary="history-dict keys in fed/runtime.py match DIAG_KEYS exactly",
    contract="the [T, 8] history rows RoundBody writes (both drivers)",
    check=_tl006))

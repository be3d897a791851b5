"""The CUDA kernels' contracts: TL004 fp32 accumulation without float
atomics, and TL010 no ptxas spills (the counterpart of the reference's
``rules_pallas.py``).

TL004 reads the ``.cu`` text with regular expressions over declarations.
In every ``__global__`` or ``__device__`` function:

(a) an accumulator -- the target of ``+=`` / ``-=``, of ``x = x + ...``, or of
    an ``fmaf`` / ``__fmaf_rn`` / ``__hfma`` / ``__hadd`` chain ``x = f(...,
    x)`` -- is never declared ``half``, ``__half``, ``__half2``,
    ``__nv_bfloat16`` or ``__nv_bfloat162`` (a pointer or array of them
    included): the port sums in fp32 (``float``, ``double``, ``float2``,
    ``float4``); integer and pointer arithmetic is not accumulation;
(b) no atomic sums a value: ``atomicAdd`` / ``atomicAdd_block`` /
    ``atomicAdd_system`` / ``atomicSub`` whose target or value is declared
    float, double, half or bf16 (or is a float literal), and ``fetch_add`` /
    ``fetch_sub`` / ``+=`` on a ``cuda::atomic_ref`` / ``cuda::atomic`` of
    such a type, are findings.  An atomic over integers (the arrival
    counters of ``moments.cu``) is allowed: summing by atomics in arrival
    order is what would make two launches' bits differ.

Limits: the declaration of a name is the last one before its use in the
function (or its parameter list), read by pattern, not by a C++ parser: a
type spelled through a ``typedef``/``using`` alias or a template parameter
is not resolved (and not flagged), nor is an ``atomicCAS`` loop that
emulates a float add, nor an expression target other than ``name`` /
``name[...]`` / ``*name``.

TL010 reads the ptxas report (``nvcc -Xptxas -v``) of each source in
``kernels/build.py``'s ``SOURCES`` whose compile log exists
(``build.log_path``: ``build/kernels/lib<name>_<hash>.log``, the hash of the
source and the flags), and of any ``.log`` named on the command line.  An
entry function with spill stores or loads above 0 is a finding, at its
``__global__`` line where the mangled name gives it, else at line 1 of the
log.  ``SOURCES``, ``NVCC_FLAGS`` and the log's name are read from
``build.py``'s text, and ``parse_ptxas`` is a copy: linting loads no kernel
library.  With no log (a host without ``nvcc``) TL010 reads nothing.
"""
from __future__ import annotations

import ast
import hashlib
import pathlib
import re
from typing import Dict, List, Optional, Tuple

from .base import Finding, Rule, register

HALF_TYPES = {"half", "__half", "__half2", "__nv_bfloat16", "__nv_bfloat162",
              "nv_bfloat16", "nv_bfloat162", "half2"}
FLOAT_TYPES = {"float", "double", "float2", "float4", "double2"} | HALF_TYPES
_KEYWORDS = {"return", "else", "case", "goto", "sizeof", "new", "delete",
             "throw", "typename", "struct", "class", "using", "if", "for",
             "while", "do", "switch", "co_return", "operator", "template"}

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_STRING_RE = re.compile(r'"(?:\\.|[^"\\\n])*"')
_FUNC_RE = re.compile(r"\b(__global__|__device__)\b")
_AUG_RE = re.compile(
    r"(?<![\w.>])(\*\s*)?([A-Za-z_]\w*)\s*(?:\[[^\]\n]*\]\s*)*([+-])=(?!=)")
_SELF_RE = re.compile(
    r"(?<![\w.>])([A-Za-z_]\w*)(\s*(?:\[[^\]\n]*\]\s*)*)=\s*"
    r"(?:(fmaf|__fmaf_rn|__fma_rn|fma|__hfma|__hfma2|__hadd|__hadd2)"
    r"\s*\(([^;]*)\)|\1\2\s*[+-])")
_ATOMIC_RE = re.compile(r"\b(atomicAdd(?:_block|_system)?|atomicSub)\s*\(")
_ATOMIC_REF_RE = re.compile(
    r"\batomic(?:_ref)?\s*<\s*(?:const\s+)?([A-Za-z_]\w*)[^>]*>\s*"
    r"([A-Za-z_]\w*)")
_FLOAT_LIT_RE = re.compile(r"^\s*[-+]?(\d+\.\d*|\.\d+|\d+)(e[-+]?\d+)?[fF]\s*$"
                           r"|^\s*[-+]?\d+\.\d*\s*$")


def _blank(text: str) -> str:
    """Comments and strings blanked out (lengths and newlines kept)."""
    def keep_lines(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return _COMMENT_RE.sub(keep_lines, _STRING_RE.sub(keep_lines, text))


def _match_brace(text: str, open_at: int) -> int:
    depth = 0
    for i in range(open_at, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    return len(text)


def device_functions(code: str) -> List[Tuple[int, int, int]]:
    """(signature start, body start, body end) of every ``__global__`` /
    ``__device__`` function definition in comment-free ``code``."""
    out = []
    pos = 0
    while True:
        m = _FUNC_RE.search(code, pos)
        if m is None:
            return out
        brace = code.find("{", m.end())
        semi = code.find(";", m.end())
        if brace < 0:
            return out
        if 0 <= semi < brace:          # a declaration or a __device__ var
            pos = m.end()
            continue
        end = _match_brace(code, brace)
        out.append((m.start(), brace, end))
        pos = end


def declared_type(code: str, start: int, use: int, name: str
                  ) -> Optional[str]:
    """The type of the last declaration of ``name`` in ``code[start:use]``
    (a function's signature and body up to a use), or None."""
    pat = re.compile(
        r"(?<![\w.>])(?:const\s+|volatile\s+|static\s+|__shared__\s+|"
        r"register\s+|unsigned\s+|signed\s+)*"
        r"([A-Za-z_][\w:]*(?:\s*<[^<>;{}()]*>)?)\s*(?:\*\s*|&\s*)*"
        r"(?:const\s+)?(?:__restrict__\s+)?"
        r"(?:[A-Za-z_]\w*(?:\s*\[[^\]]*\])*\s*(?:=\s*[^,;{}()]*?)?\s*,\s*)*"
        r"\b" + re.escape(name) + r"\b(?=\s*(?:\[|=(?!=)|;|,|\)|\(|\{))")
    best = None
    for m in pat.finditer(code, start, use):
        ty = m.group(1).split("<")[0].strip().split("::")[-1]
        if ty in _KEYWORDS or ty == name:
            continue
        best = ty
    return best


def _line(code: str, pos: int) -> int:
    return code.count("\n", 0, pos) + 1


def _first_name(expr: str) -> Optional[str]:
    m = re.search(r"[A-Za-z_]\w*", expr.replace("&", " "))
    return m.group(0) if m else None


def _split_args(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def check_cuda(relpath: str, text: str) -> List[Finding]:
    """TL004's findings in one ``.cu`` source."""
    code = _blank(text)
    findings: List[Finding] = []
    seen = set()

    def add(pos, msg):
        key = (_line(code, pos), msg)
        if key not in seen:
            seen.add(key)
            findings.append(Finding("TL004", relpath, key[0], msg))

    for sig, body, end in device_functions(code):
        for m in _AUG_RE.finditer(code, body, end):
            name = m.group(2)
            ty = declared_type(code, sig, m.start(), name)
            if ty in HALF_TYPES:
                add(m.start(), f"`{name} {m.group(3)}=` accumulates in {ty}; "
                    f"declare the accumulator float (fp32 accumulation)")
        for m in _SELF_RE.finditer(code, body, end):
            name = m.group(1)
            if m.group(3) and name not in re.findall(r"\w+", m.group(4)):
                continue               # fmaf(...) that does not chain name
            ty = declared_type(code, sig, m.start(), name)
            if ty in HALF_TYPES:
                add(m.start(), f"`{name}` accumulates in {ty} through "
                    f"`{m.group(3) or name + ' +'}`; declare the accumulator "
                    f"float (fp32 accumulation)")
        for m in _ATOMIC_RE.finditer(code, body, end):
            close = _match_paren(code, m.end() - 1)
            args = _split_args(code[m.end():close])
            types = []
            for arg in args[:2]:
                nm = _first_name(arg)
                if _FLOAT_LIT_RE.match(arg):
                    types.append("float")
                elif nm is not None:
                    types.append(declared_type(code, sig, m.start(), nm))
            bad = [t for t in types if t in FLOAT_TYPES]
            if bad:
                add(m.start(), f"`{m.group(1)}` sums a {bad[0]} value by "
                    f"atomics: the order of arrival decides the bits; write "
                    f"partials and fold them in a fixed order")
        for m in _ATOMIC_REF_RE.finditer(code, body, end):
            ty, var = m.group(1), m.group(2)
            if ty not in FLOAT_TYPES:
                continue
            use = re.search(r"\b" + re.escape(var)
                            + r"\s*(?:\.\s*fetch_(?:add|sub)\s*\(|[+-]=)",
                            code[m.end():end])
            if use is not None:
                add(m.end() + use.start(),
                    f"`{var}` (atomic of {ty}) sums a value by atomics: the "
                    f"order of arrival decides the bits")
    return findings


def _match_paren(code: str, open_at: int) -> int:
    depth = 0
    for i in range(open_at, len(code)):
        if code[i] == "(":
            depth += 1
        elif code[i] == ")":
            depth -= 1
            if depth == 0:
                return i
    return len(code)


def _tl004(project) -> List[Finding]:
    findings: List[Finding] = []
    for src in project.sources:
        findings.extend(check_cuda(src.relpath, src.text))
    return findings


# --- TL010 -----------------------------------------------------------------


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """The per-entry report in the text of an ``nvcc -Xptxas -v`` run (a
    copy of ``kernels/build.py``'s, with the line each entry starts at)."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for lineno, line in enumerate(log.splitlines(), start=1):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {"registers": 0, "smem": 0,
                                                "stack": 0, "spill_stores": 0,
                                                "spill_loads": 0,
                                                "line": lineno})
            continue
        if entry is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                entry[key] = int(m.group(1))
    return out


def demangled_name(mangled: str) -> Optional[str]:
    """The function's own name in an Itanium-mangled symbol
    (``_Z14moments_kernelILb1EEvPKf...`` -> ``moments_kernel``; a nested
    ``_ZN2ns4nameE...`` -> ``name``), or the symbol itself for an
    ``extern "C"`` kernel."""
    if not mangled.startswith("_Z"):
        return mangled if re.fullmatch(r"[A-Za-z_]\w*", mangled) else None
    s = mangled[2:]
    nested = s.startswith("N")
    if nested:
        s = s[1:]
    name = None
    while True:
        m = re.match(r"(\d+)", s)
        if m is None:
            return name
        n = int(m.group(1))
        name = s[m.end():m.end() + n]
        s = s[m.end() + n:]
        if not nested or s.startswith("E") or s.startswith("I"):
            return name


def global_line(text: str, name: str) -> Optional[int]:
    """The line of the ``__global__`` that declares kernel ``name``."""
    code = _blank(text)
    for m in re.finditer(r"\b__global__\b", code):
        brace = code.find("{", m.end())
        semi = code.find(";", m.end())
        stop = min(x for x in (brace, semi, len(code)) if x >= 0)
        if re.search(r"\b" + re.escape(name) + r"\s*\(", code[m.end():stop]):
            return _line(code, m.start())
    return None


def _literal(tree: ast.Module, name: str):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def build_logs(project) -> List[Tuple[str, pathlib.Path, pathlib.Path]]:
    """``(name, source, log)`` of ``kernels/build.py``'s ``SOURCES`` in the
    project, each log where ``build.log_path(name)`` puts it (it may not
    exist)."""
    out = []
    for mod in project.modules:
        parts = pathlib.PurePath(mod.relpath).parts
        if parts[-3:] != ("repro_torch", "kernels", "build.py"):
            continue
        sources = _literal(mod.tree, "SOURCES")
        flags = _literal(mod.tree, "NVCC_FLAGS")
        if not isinstance(sources, dict) or not isinstance(flags, tuple):
            continue
        csrc = mod.path.resolve().parent / "csrc"
        build_dir = mod.path.resolve().parents[3] / "build" / "kernels"
        for name, file in sources.items():
            src = csrc / file
            if not src.exists():
                continue
            digest = hashlib.sha256(src.read_bytes() + " ".join(
                flags).encode()).hexdigest()[:16]
            out.append((name, src, build_dir / f"lib{name}_{digest}.log"))
    return out


def _relpath(project, path: pathlib.Path) -> str:
    try:
        return str(path.relative_to(project.root.resolve()))
    except ValueError:
        return str(path)


def _tl010(project) -> List[Finding]:
    findings: List[Finding] = []
    logs: List[Tuple[str, str, Optional[pathlib.Path]]] = [
        (log.relpath, log.text, None) for log in project.logs]
    for _, src, log in build_logs(project):
        if log.exists():
            logs.append((_relpath(project, log), log.read_text(), src))
    for log_rel, text, src in logs:
        report = parse_ptxas(text)
        project.ptxas_read[log_rel] = len(report)
        for entry, row in report.items():
            if not (row["spill_stores"] or row["spill_loads"]):
                continue
            path, line = log_rel, row["line"]
            name = demangled_name(entry)
            if src is not None and name is not None:
                at = global_line(src.read_text(), name)
                if at is not None:
                    path, line = _relpath(project, src), at
            elif src is not None:
                path, line = _relpath(project, src), 1
            findings.append(Finding(
                "TL010", path, line,
                f"ptxas: `{entry}` spills ({row['spill_stores']} bytes "
                f"stores, {row['spill_loads']} bytes loads, "
                f"{row['registers']} registers) in {log_rel}"))
    return findings


register(Rule(
    id="TL004", name="cuda-fp32-accumulation",
    summary="no half/bf16 accumulator and no atomic that sums a float in "
            "a __global__/__device__ function of a .cu source",
    contract="fp32 accumulation in a fixed order: kernel vs plain version "
             "and launch vs launch bitwise (moments.cu:55-62)",
    check=_tl004))

register(Rule(
    id="TL010", name="ptxas-spills",
    summary="no entry function of a built kernel spills registers (ptxas "
            "-v report of each kernels/build.py source)",
    contract="chip_smoke.py's build gate, without a card",
    check=_tl010))

"""Captured-round rules: TL001 host syncs, TL003 Python branches on
tensors, and TL002 explicit generators.

TL001 and TL003 work on ``context.find_captured``'s set and share its taint
pass.  A host sync in the captured round fails the CUDA-graph capture on
the card (or, in a round that runs eagerly for its collective, stalls the
stream each round), while on the CPU the same line passes every test.
TL001 has no mechanical fix: the reference's ``np.`` -> ``jnp.`` rewrite
has no counterpart (a host value has to be staged by ``_stage`` instead).

TL002 is the counterpart of the reference's key discipline, over the port's
package (``src/repro_torch``): every torch random draw names its
``generator=``, so a run's draws come from the seeded streams of
``repro_torch.rng`` and never from the global generator, and nothing seeds
the global generator (``torch.manual_seed`` and friends).
"""
from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List

from .base import Finding, Rule, register
from .context import (Taint, dotted, find_captured, lambda_as_fn,
                      walk_statements)


def stmt_exprs(stmt: ast.stmt) -> Iterable[ast.expr]:
    """Expressions belonging to ``stmt`` itself, not to nested statements.

    ``walk_statements`` already yields nested statements separately, so rules
    scanning expressions per-statement must not descend into child blocks or
    they would report each finding once per nesting level.
    """
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return
    for field in ("value", "test", "msg", "exc", "iter", "target", "targets"):
        val = getattr(stmt, field, None)
        if val is None:
            continue
        if isinstance(val, list):
            yield from (v for v in val if isinstance(v, ast.expr))
        elif isinstance(val, ast.expr):
            yield val
    for item in getattr(stmt, "items", ()) or ():
        yield item.context_expr


def walk_expr(expr: ast.expr, taint: Taint):
    """``(node, taint)`` over ``expr``; a lambda's body is walked with its
    parameters tainted (``lambda l: l.item()`` on the leaves of a tree)."""
    stack = [(expr, taint)]
    while stack:
        node, t = stack.pop()
        yield node, t
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Lambda):
                inner = Taint(lambda_as_fn(child), t.host_call)
                # the lambda's parameters shadow the enclosing names
                inner.tainted |= t.tainted - {a.arg for a in
                                              child.args.args}
                inner.masks |= t.masks
                stack.append((child.body, inner))
            else:
                stack.append((child, t))


# host copies of a tensor, as methods
_HOST_METHODS = {"item": "forces a device-to-host copy and a sync",
                 "tolist": "forces a device-to-host copy and a sync",
                 "cpu": "copies to the host and syncs",
                 "numpy": "needs a host tensor (a copy and a sync)"}
# shapes that depend on the data: the host waits for the count
_DYNAMIC_SHAPE = {"nonzero", "masked_select", "unique", "unique_consecutive",
                  "argwhere"}


def _host_call(node: ast.Call, taint: Taint):
    """The message of a host sync at ``node``, or None."""
    fn = dotted(node.func)
    tail = fn.rsplit(".", 1)[-1]
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.value is not None]
    recv = node.func.value if isinstance(node.func, ast.Attribute) else None
    if fn in ("float", "int", "bool") and node.args \
            and any(taint.is_tainted(a) for a in node.args):
        return (f"`{fn}()` of a tensor copies it to the host and syncs "
                "inside the captured round")
    if recv is not None and tail in _HOST_METHODS \
            and taint.is_tainted(recv):
        return f"`.{tail}()` on a tensor {_HOST_METHODS[tail]}"
    if recv is not None and tail == "to" and taint.is_tainted(recv) and any(
            isinstance(a, ast.Constant) and a.value == "cpu" for a in args):
        return "`.to('cpu')` on a tensor copies to the host and syncs"
    if tail == "synchronize":
        return f"`{fn}()` blocks the host on the card"
    if fn in ("torch.tensor", "torch.from_numpy") or (
            fn == "torch.as_tensor" and node.args
            and not taint.is_tainted(node.args[0])):
        return (f"`{fn}` of host data is a host-to-device copy inside the "
                "captured round; stage it (``_stage``) instead")
    if tail in _DYNAMIC_SHAPE and (fn.startswith("torch.") or (
            recv is not None and taint.is_tainted(recv))):
        return (f"`{tail}` has a data-dependent shape: the host waits for "
                "the count")
    if fn == "torch.where" and len(node.args) == 1 and not node.keywords:
        return ("one-argument `torch.where` has a data-dependent shape: "
                "the host waits for the count")
    return None


def _check_host_calls(expr: ast.expr, taint: Taint, path: str,
                      findings: List[Finding]) -> None:
    for node, t in walk_expr(expr, taint):
        msg = None
        if isinstance(node, ast.Call):
            msg = _host_call(node, t)
        elif isinstance(node, ast.Subscript) and t.is_tainted(node.value) \
                and t.is_mask(node.slice):
            msg = ("boolean-mask indexing has a data-dependent shape: the "
                   "host waits for the count")
        if msg is not None:
            findings.append(Finding("TL001", path, node.lineno,
                                    msg + " (captured round)"))


def run_taint(fn, taint: Taint, on_stmt) -> List[Finding]:
    findings: List[Finding] = []
    for stmt in walk_statements(fn):
        on_stmt(stmt, taint, findings)
        if isinstance(stmt, ast.Assign):
            taint.assign(stmt.targets, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            taint.assign([stmt.target], stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            if taint.is_tainted(stmt.value):
                taint.assign([stmt.target], stmt.value)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            taint.assign([stmt.target], stmt.iter)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    taint.assign([item.optional_vars], item.context_expr)
    return findings


def _tl001(project) -> List[Finding]:
    findings: List[Finding] = []
    cap = find_captured(project)
    for mod, fn in cap.functions:
        def on_stmt(stmt, taint, out, _path=mod.relpath):
            for expr in stmt_exprs(stmt):
                _check_host_calls(expr, taint, _path, out)

        findings.extend(run_taint(fn, cap.taint(fn), on_stmt))
    for mod, lam in cap.lambdas:
        _check_host_calls(lam.body, cap.taint(lam), mod.relpath, findings)
    return findings


def _branch(test: ast.expr, taint: Taint, path: str, kind: str,
            out: List[Finding]) -> None:
    if taint.is_tainted(test):
        out.append(Finding(
            "TL003", path, test.lineno,
            f"Python `{kind}` on a tensor reads its value on the host (a "
            f"sync, and a branch a CUDA graph freezes); use torch.where or "
            f"stage the decision on the host"))


def _tl003(project) -> List[Finding]:
    findings: List[Finding] = []
    cap = find_captured(project)
    for mod, fn in cap.functions:
        path = mod.relpath

        def on_stmt(stmt, taint, out, _path=path):
            if isinstance(stmt, ast.If):
                _branch(stmt.test, taint, _path, "if", out)
            elif isinstance(stmt, ast.While):
                _branch(stmt.test, taint, _path, "while", out)
            elif isinstance(stmt, ast.Assert):
                _branch(stmt.test, taint, _path, "assert", out)
            for expr in stmt_exprs(stmt):
                for node, t in walk_expr(expr, taint):
                    if isinstance(node, ast.IfExp):
                        _branch(node.test, t, _path, "... if ... else", out)

        findings.extend(run_taint(fn, cap.taint(fn), on_stmt))
    for mod, lam in cap.lambdas:
        taint = cap.taint(lam)
        for node, t in walk_expr(lam.body, taint):
            if isinstance(node, ast.IfExp):
                _branch(node.test, t, mod.relpath, "... if ... else",
                        findings)
    return findings


# torch draws: function forms (torch.<name>) and in-place methods
_DRAWS = {"randn", "rand", "randint", "normal", "bernoulli", "multinomial",
          "randperm", "randn_like", "rand_like", "randint_like", "poisson"}
# in-place draws, and the tensor method bernoulli()
_METHOD_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                 "exponential_", "cauchy_", "log_normal_", "geometric_",
                 "bernoulli"}
_GLOBAL_SEEDING = {"torch.manual_seed", "torch.seed", "torch.initial_seed",
                   "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                   "torch.cuda.seed", "torch.cuda.seed_all",
                   "torch.random.manual_seed", "torch.random.seed",
                   "torch.set_rng_state", "torch.cuda.set_rng_state",
                   "torch.cuda.set_rng_state_all"}


def in_package(relpath: str) -> bool:
    """TL002's scope: the port's package (and the corpus's fixtures)."""
    parts = pathlib.PurePath(relpath).parts
    return "repro_torch" in parts or "lint_corpus" in parts


def _tl002(project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if not in_package(mod.relpath):
            continue
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = dotted(node.func)
            tail = fn.rsplit(".", 1)[-1]
            has_gen = any(kw.arg == "generator" for kw in node.keywords)
            if fn in _GLOBAL_SEEDING:
                findings.append(Finding(
                    "TL002", mod.relpath, node.lineno,
                    f"`{fn}` seeds the global generator; draw from a "
                    f"`torch.Generator` (repro_torch.rng) instead"))
            elif not has_gen and (
                    (tail in _DRAWS and fn.split(".", 1)[0] == "torch")
                    or (tail in _METHOD_DRAWS
                        and isinstance(node.func, ast.Attribute))):
                findings.append(Finding(
                    "TL002", mod.relpath, node.lineno,
                    f"`{fn}` draws from the global generator; pass "
                    f"`generator=` (a seeded torch.Generator)"))
    return findings


register(Rule(
    id="TL001", name="host-sync-in-captured-round",
    summary=".item()/.tolist()/.cpu()/.numpy()/float()/synchronize/host "
            "copies/data-dependent shapes inside the captured round",
    contract="the scan driver's CUDA graph of the round (RoundBody makes no "
             "host sync); scan == python bitwise",
    check=_tl001))

register(Rule(
    id="TL002", name="explicit-generators",
    summary="every torch random draw passes generator=; no global seeding",
    contract="one seed -> the same draws on the CPU and the card "
             "(repro_torch.rng streams)",
    check=_tl002))

register(Rule(
    id="TL003", name="python-branch-on-tensor",
    summary="Python if/while/assert/ternary on tensor values inside the "
            "captured round",
    contract="a captured round takes no host decision (they live in _stage)",
    check=_tl003))

"""Buffer-lifetime rules: TL007 (a CUDA graph's fixed buffers); the
reference's TL008 has no counterpart.

TL007 (the reference: a ``donate_argnums`` buffer read after the call that
invalidated it).  In the port the buffers a later call invalidates are a
CUDA graph's: the scan driver's engine (``fed/runtime.py::_GraphChunks``)
captures a round over fixed tensors (``hist``, ``static``, ``staged``,
``cursor``), and every ``replay()`` rewrites them in place.  A value handed
out of the engine as a view of one of them changes under its reader at the
next replay.  So, in a class that replays a ``torch.cuda.CUDAGraph``:

* its *graph buffers* are the ``self.<attr>`` the captured code reads: the
  body of the ``with torch.cuda.graph(...)`` block and the methods of the
  class that it calls, followed through ``self.<method>()``;
* a method not named ``_...`` (what the engine hands out) must not
  ``return`` a graph buffer, or a subscript, attribute or view
  (``view``/``reshape``/``narrow``/``t``/``flatten``/``detach``/...) of one,
  unless a copy is taken: ``.cpu()``, ``.clone()``, ``.to(...)``,
  ``.tolist()``, ``.item()``, ``.numpy()``, ``.copy_()`` into another
  tensor, ``torch.stack``/``torch.cat``, or a project helper whose name
  says it copies (``_clone``).

The check is local to the class; a buffer passed out through a mutable
argument, or returned by a private helper that a public method passes on,
is not seen.

TL008 (the reference: a ``lax.scan`` carry's arity) has no counterpart: the
port has no scan.  Its scan driver replays one round's graph a chunk of
rounds, and its Python driver loops the same body; the state a round hands
the next is the ``(params, opt_state, cstate)`` triple the body returns,
copied into the graph's buffers by ``_copy_into``, whose tree structure a
mismatch fails at once on the CPU too.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from .base import Finding, Rule, register
from .context import dotted

_VIEWS = {"view", "reshape", "narrow", "t", "flatten", "detach", "squeeze",
          "unsqueeze", "expand", "permute", "transpose", "select", "unbind",
          "split", "chunk", "view_as", "as_strided", "contiguous", "float"}
_COPIES = {"cpu", "clone", "to", "tolist", "item", "numpy", "stack", "cat",
           "_clone", "deepcopy", "copy"}


def _self_attrs(node: ast.AST) -> Set[str]:
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "self"}


def _self_calls(node: ast.AST) -> Set[str]:
    return {n.func.attr for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "self"}


def _graph_blocks(fn: ast.FunctionDef) -> List[ast.With]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.With) and any(
        isinstance(i.context_expr, ast.Call)
        and dotted(i.context_expr.func).endswith("cuda.graph")
        for i in n.items)]


def graph_buffers(cls: ast.ClassDef) -> Set[str]:
    """The ``self`` attributes the captured code of ``cls`` reads (empty if
    the class captures no graph)."""
    methods: Dict[str, ast.FunctionDef] = {
        n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}
    buffers: Set[str] = set()
    todo: List[ast.AST] = []
    for fn in methods.values():
        todo.extend(_graph_blocks(fn))
    seen: Set[str] = set()
    while todo:
        node = todo.pop()
        body = node.body if isinstance(node, ast.With) else [node]
        for stmt in body:
            buffers |= _self_attrs(stmt)
            for name in _self_calls(stmt):
                if name in methods and name not in seen:
                    seen.add(name)
                    todo.append(methods[name])
    return buffers - set(methods)


def _escapes(expr: ast.expr, buffers: Set[str]) -> str:
    """The graph buffer ``expr`` hands out without a copy, or ''."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr if expr.attr in buffers else ""
    if isinstance(expr, ast.Subscript):
        return _escapes(expr.value, buffers)
    if isinstance(expr, ast.Attribute):
        return _escapes(expr.value, buffers)
    if isinstance(expr, ast.Call):
        tail = dotted(expr.func).rsplit(".", 1)[-1] \
            if not isinstance(expr.func, ast.Attribute) else expr.func.attr
        if tail in _COPIES:
            return ""
        if isinstance(expr.func, ast.Attribute) and tail in _VIEWS:
            return _escapes(expr.func.value, buffers)
        return ""
    if isinstance(expr, (ast.Tuple, ast.List)):
        for e in expr.elts:
            hit = _escapes(e, buffers)
            if hit:
                return hit
        return ""
    if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
        return _escapes(expr.elt, buffers) if any(
            _escapes(g.iter, buffers) for g in expr.generators) or \
            _escapes(expr.elt, buffers) else ""
    return ""


def _tl007(project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        for cls in mod.nodes:
            if not isinstance(cls, ast.ClassDef) or not any(
                    isinstance(n, ast.Attribute) and n.attr == "replay"
                    for n in ast.walk(cls)):
                continue
            buffers = graph_buffers(cls)
            if not buffers:
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef) \
                        or fn.name.startswith("_"):
                    continue
                for node in ast.walk(fn):
                    if isinstance(node, ast.Return) and node.value is not None:
                        hit = _escapes(node.value, buffers)
                        if hit:
                            findings.append(Finding(
                                "TL007", mod.relpath, node.lineno,
                                f"`{cls.name}.{fn.name}` hands out "
                                f"`self.{hit}`, a buffer of the captured "
                                f"graph, without a copy: the next replay() "
                                f"rewrites it under the reader (return "
                                f".clone() or .cpu())"))
    return findings


register(Rule(
    id="TL007", name="graph-buffer-escape",
    summary="a CUDA graph's fixed buffer handed out without a copy",
    contract="the scan driver's chunk results (rows, state) stay what they "
             "were after the next chunk's replays",
    check=_tl007))

"""The captured round: discovery and value taint (the port's counterpart of
the JAX package's ``find_traced``).

The trace rules (TL001, TL003, TL009) apply inside **the captured round**:
the code a CUDA graph records when the scan driver captures a round, or
that a round with a collective runs eagerly in the same body.  On the CPU
that code passes every test whatever it does; on the card a host sync in it
breaks the capture.  This module finds it statically:

* *Seeds*: ``RoundBody.__call__`` (``fed/runtime.py``); the callables of the
  ``register(Scheme(...))`` and ``register(ClientAlgorithm(...))`` records
  (lambdas, or functions of the module); the ``update`` callables handed to
  ``Optimizer(...)`` records (the server step); and the functions handed to
  ``torch.func.vmap`` / ``torch.func.grad`` (and ``functional_call``) where
  they name a function of the project.  The ``register(ChannelModel(...))``
  callables are **not** seeds: the port runs them on the host, in
  ``_stage``.
* *Reach*: the set is closed over calls across modules.  A call resolves
  through the calling module's own imports (``import a.b as m``, ``from a
  import b``, relative imports, function-local imports included) to a
  function of a project file: ``ota.aggregate``, ``kernel_path.
  aggregate_kernels``, ``ops.grad_norm``, ``from ... import f``; ``self.m()``
  to a method of the enclosing class; a bare name to a function of the same
  module (nested ones included).  The nested functions of a reached function
  are reached too.  **Calls through parameters or attributes of values**
  (``grad_fn``, ``block_batch_fn``, ``opt.update``, ``sch.device_scale``)
  are not followed: the seeds above stand for the registered ones, and the
  model's gradient function (``grad_fn``) is the caller's.

The taint pass is the reference's, with the port's names: a value is
*tensor-derived* unless it is static.  Static are the parameters named
``cfg``, ``sch``, ``opt``, ``ocfg``, ``ocfg2``, ``alg``, ``self``, ``mesh``
(and the other config-like names of ``STATIC_PARAM_NAMES``), parameters with
a host annotation (``int``, ``str``, ``torch.dtype``, ...) or a non-None
constant default, and what is read off them; tensor metadata (``.shape``,
``.dtype``, ``.device``, ``.dim()``, ``.numel()``, ...) is static too.
The pass is linear and name-based: it does not narrow through
``isinstance`` and does not see a closure's captured values.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, List, Optional, Set, Tuple, Union

# Attribute reads that stay host values on a tensor (metadata).
META_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
              "requires_grad", "layout", "is_sparse", "is_leaf", "grad_fn",
              "type", "index"}
# Methods that return host metadata of a tensor without touching its data.
META_METHODS = {"dim", "numel", "size", "stride", "is_contiguous", "data_ptr",
                "element_size", "nelement", "get_device", "storage_offset",
                "is_floating_point", "is_complex", "ndimension"}
# Calls that concretize or inspect without a host sync.
CONCRETIZING_CALLS = {"len", "isinstance", "type", "getattr", "hasattr",
                      "callable", "id", "range", "enumerate", "zip",
                      "sorted"}
# torch functions that return host values
TORCH_HOST_CALLS = {"is_grad_enabled", "is_available", "current_device",
                    "device", "Size", "current_stream", "get_default_dtype",
                    "finfo", "iinfo", "is_tensor", "is_initialized",
                    "is_current_stream_capturing", "device_count",
                    "get_world_size", "get_rank", "Generator",
                    "is_inference_mode_enabled"}

# Parameter names that carry static configuration into the round (config
# records, the scheme and client-algorithm records, the optimizer, sizes).
STATIC_PARAM_NAMES = {
    "cfg", "sch", "opt", "ocfg", "ocfg2", "alg", "self", "mesh", "cls",
    "shape", "shapes", "dtype", "dtypes", "device",
    # the scheme record under its long name, the mesh's rank context and
    # cut layout (records whose methods take the tensors)
    "scheme", "ctx", "cut",
    # callables handed in (calls through them are not followed)
    "grad_fn", "block_batch_fn",
}
# the words of an annotation (a parameter's, or a function's return) that
# name host values; an annotation made of these alone is static
HOST_TYPE_WORDS = {
    "int", "float", "bool", "str", "bytes", "None", "Optional", "Union",
    "Tuple", "List", "Sequence", "Iterable", "Dict", "Set", "FrozenSet",
    "Mapping", "slice", "Path", "pathlib", "ctypes", "CDLL", "torch",
    "dtype", "device", "Size", "Generator",
    # the port's static records
    "Scheme", "ClientAlgorithm", "OTAConfig", "FLConfig", "ChannelConfig",
    "ClientConfig", "Optimizer", "ChannelModel", "CutLayout", "DeviceMesh",
    "PieceMap", "schemes", "clients", "ota", "optim", "sharding",
}

# where the seeds' records are made
_SEED_RECORDS = ("Scheme", "ClientAlgorithm")
# torch.func transforms whose first argument is run under the transform
_FUNC_TRANSFORMS = {"vmap", "grad", "grad_and_value", "vjp", "jvp",
                    "jacrev", "jacfwd", "functional_call"}

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]


def dotted(node: Optional[ast.expr]) -> str:
    """Best-effort dotted-name rendering of an expression ('' if complex)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        head = dotted(node.value)
        return f"{head}.{node.attr}" if head else node.attr
    return ""


def module_name(relpath: str) -> str:
    """The dotted module name of a project file: ``src/repro_torch/fed/
    runtime.py`` -> ``repro_torch.fed.runtime`` (the part after ``src``),
    ``tools/x.py`` -> ``tools.x``."""
    parts = list(pathlib.PurePath(relpath).with_suffix("").parts)
    if "src" in parts:
        parts = parts[len(parts) - parts[::-1].index("src"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclasses.dataclass
class ModuleIndex:
    """One module's functions and imports."""
    name: str
    # bare name -> functions (top level and nested; not methods)
    functions: Dict[str, List[FuncNode]]
    # "Class.method" -> method
    methods: Dict[str, FuncNode]
    # alias -> ("module", dotted) or ("symbol", module dotted, name)
    imports: Dict[str, Tuple[str, ...]]


def _index(mod) -> ModuleIndex:
    name = module_name(mod.relpath)
    is_pkg = mod.relpath.endswith("__init__.py")
    functions: Dict[str, List[FuncNode]] = {}
    methods: Dict[str, FuncNode] = {}
    for node in mod.nodes:
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[f"{node.name}.{sub.name}"] = sub
    method_ids = {id(m) for m in methods.values()}
    for node in mod.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) not in method_ids:
            functions.setdefault(node.name, []).append(node)
    imports: Dict[str, Tuple[str, ...]] = {}
    package = name if is_pkg else name.rpartition(".")[0]
    for node in mod.nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = ("module", alias.name)
                else:
                    head = alias.name.split(".")[0]
                    imports[head] = ("module", head)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg = package.split(".") if package else []
                pkg = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 \
                    else pkg
                base = ".".join(pkg + ([base] if base else []))
            for alias in node.names:
                imports[alias.asname or alias.name] = ("symbol", base,
                                                       alias.name)
    return ModuleIndex(name, functions, methods, imports)


@dataclasses.dataclass
class Captured:
    """The captured round of a project: every reached function, with the
    module it lives in, and the seed lambdas."""
    functions: List[Tuple[object, FuncNode]]     # (ModuleInfo, node)
    lambdas: List[Tuple[object, ast.Lambda]]
    names: Set[Tuple[str, str]]                  # (module, function name)
    resolver: "_Resolver"
    # id(function or lambda) -> (its module's index, its class or None)
    where: Dict[int, Tuple[ModuleIndex, Optional[str]]]

    def reached(self, module: str, name: str) -> bool:
        return (module, name) in self.names

    def taint(self, fn) -> "Taint":
        """The taint pass of a reached function or seed lambda, which
        knows the host return annotations of the functions it calls."""
        idx, cls = self.where[id(fn)]

        def host_call(node: ast.Call) -> bool:
            hits = self.resolver.resolve(idx, cls, node.func)
            return bool(hits) and all(host_annotation(f.returns)
                                      for _, f in hits)

        if isinstance(fn, ast.Lambda):
            fn = lambda_as_fn(fn)
        return Taint(fn, host_call)


class _Resolver:
    def __init__(self, project):
        self.mods = {}
        self.infos = {}
        # module -> id(method) -> its class
        self.classes: Dict[str, Dict[int, str]] = {}
        for mod in project.modules:
            idx = _index(mod)
            self.mods[idx.name] = idx
            self.infos[idx.name] = mod
            self.classes[idx.name] = {
                id(fn): key.split(".", 1)[0]
                for key, fn in idx.methods.items()}

    def _in_module(self, modname: str, parts: List[str]
                   ) -> List[Tuple[str, FuncNode]]:
        """Functions that ``parts`` names inside module ``modname``."""
        idx = self.mods.get(modname)
        if idx is None or not parts:
            return []
        if len(parts) == 1:
            hits = idx.functions.get(parts[0], [])
            if hits:
                return [(modname, fn) for fn in hits]
            # a name the module imports from elsewhere (re-exports)
            imp = idx.imports.get(parts[0])
            if imp and imp[0] == "symbol":
                return self._symbol(imp[1], imp[2], [])
            return []
        sub = f"{modname}.{parts[0]}"
        if sub in self.mods:
            return self._in_module(sub, parts[1:])
        imp = idx.imports.get(parts[0])
        if imp is not None:
            return self._alias(imp, parts[1:])
        meth = idx.methods.get(f"{parts[0]}.{parts[1]}")
        return [(modname, meth)] if meth is not None and len(parts) == 2 \
            else []

    def _symbol(self, modname: str, sym: str, rest: List[str]):
        sub = f"{modname}.{sym}"
        if sub in self.mods:
            return self._in_module(sub, rest)
        return self._in_module(modname, [sym] + rest)

    def _alias(self, imp: Tuple[str, ...], rest: List[str]):
        if imp[0] == "module":
            return self._in_module(imp[1], rest)
        return self._symbol(imp[1], imp[2], rest)

    def resolve(self, idx: ModuleIndex, cls: Optional[str],
                func: ast.expr) -> List[Tuple[str, FuncNode]]:
        name = dotted(func)
        if not name:
            return []
        parts = name.split(".")
        if parts[0] == "self" and cls is not None and len(parts) == 2:
            meth = idx.methods.get(f"{cls}.{parts[1]}")
            return [(idx.name, meth)] if meth is not None else []
        if len(parts) == 1 and parts[0] in idx.functions:
            return [(idx.name, fn) for fn in idx.functions[parts[0]]]
        imp = idx.imports.get(parts[0])
        if imp is None:
            return []
        return self._alias(imp, parts[1:])


def _record_callables(rec: ast.Call) -> List[ast.expr]:
    return [kw.value for kw in rec.keywords if kw.value is not None] \
        + list(rec.args)


def find_captured(project) -> Captured:
    """The captured round of ``project`` (cached on it)."""
    hit = project.cache.get("captured")
    if hit is not None:
        return hit
    res = _Resolver(project)
    seeds: List[Tuple[str, FuncNode]] = []
    lambdas: List[Tuple[object, ast.Lambda]] = []

    where: Dict[int, Tuple[ModuleIndex, Optional[str]]] = {}

    def callable_arg(idx, node, into):
        if isinstance(node, ast.Lambda):
            lambdas.append((res.infos[idx.name], node))
            where[id(node)] = (idx, None)
        elif isinstance(node, (ast.Name, ast.Attribute)):
            into.extend(res.resolve(idx, None, node))

    for idx in res.mods.values():
        if "RoundBody.__call__" in idx.methods:
            seeds.append((idx.name, idx.methods["RoundBody.__call__"]))
        for node in res.infos[idx.name].nodes:
            if not isinstance(node, ast.Call):
                continue
            tail = dotted(node.func).rsplit(".", 1)[-1]
            if tail == "register" and node.args \
                    and isinstance(node.args[0], ast.Call) \
                    and dotted(node.args[0].func).rsplit(".", 1)[-1] \
                    in _SEED_RECORDS:
                for value in _record_callables(node.args[0]):
                    if isinstance(value, (ast.Lambda, ast.Name)):
                        callable_arg(idx, value, seeds)
            elif tail == "Optimizer":
                # Optimizer(init, update, name): the update is the server
                # step of every round
                upd = node.args[1] if len(node.args) > 1 else next(
                    (kw.value for kw in node.keywords if kw.arg == "update"),
                    None)
                if upd is not None:
                    callable_arg(idx, upd, seeds)
            elif tail in _FUNC_TRANSFORMS and node.args \
                    and dotted(node.func).startswith(("torch.func",
                                                      "func.", tail)):
                callable_arg(idx, node.args[0], seeds)

    reached: Dict[int, Tuple[str, FuncNode]] = {}
    todo = list(seeds)
    while todo:
        modname, fn = todo.pop()
        if id(fn) in reached:
            continue
        reached[id(fn)] = (modname, fn)
        idx = res.mods[modname]
        cls = res.classes[modname].get(id(fn))
        where[id(fn)] = (idx, cls)
        for node in ast.walk(fn):
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                todo.append((modname, node))
            elif isinstance(node, ast.Call):
                todo.extend(res.resolve(idx, cls, node.func))
    functions = [(res.infos[m], fn) for m, fn in reached.values()]
    functions.sort(key=lambda p: (p[0].relpath, p[1].lineno))
    out = Captured(functions=functions, lambdas=lambdas,
                   names={(m, fn.name) for m, fn in reached.values()},
                   resolver=res, where=where)
    project.cache["captured"] = out
    return out


def host_annotation(node: Optional[ast.expr]) -> bool:
    """Whether an annotation names host values only (``Optional[int]``,
    ``Dict[str, float]``, ``torch.dtype``, ``schemes.Scheme``)."""
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return False
    words = [n.id if isinstance(n, ast.Name) else n.attr
             for n in ast.walk(node) if isinstance(n, (ast.Name,
                                                       ast.Attribute))]
    consts = [n for n in ast.walk(node) if isinstance(n, ast.Constant)
              and n.value not in (None, Ellipsis)]
    return bool(words) and not consts and all(w in HOST_TYPE_WORDS
                                              for w in words)


class Taint:
    """Per-function forward taint pass over names.

    A name is *tainted* when it (may) hold a tensor.  Parameters are
    tainted unless static (see the module docstring).  Assignments
    propagate expression taint; attribute reads off untainted bases stay
    untainted; metadata never taints.  ``masks`` are the names that hold a
    boolean tensor (a comparison of tensors, ``.bool()``), for the
    boolean-mask indexing check."""

    def __init__(self, fn: FuncNode, host_call=None):
        self.tainted: Set[str] = set()
        self.masks: Set[str] = set()
        # call -> whether it resolves to project functions that return host
        # values (by their return annotations)
        self.host_call = host_call or (lambda node: False)
        args = list(fn.args.posonlyargs) + list(fn.args.args)
        defaults = dict(zip(reversed(args), reversed(fn.args.defaults)))
        defaults.update({a: d for a, d in zip(fn.args.kwonlyargs,
                                              fn.args.kw_defaults)
                         if d is not None})
        for a in args + list(fn.args.kwonlyargs):
            if a.arg in STATIC_PARAM_NAMES:
                continue
            d = defaults.get(a)
            if isinstance(d, ast.Constant) and d.value is not None:
                continue
            if host_annotation(a.annotation):
                continue
            self.tainted.add(a.arg)
        for a in (fn.args.vararg, fn.args.kwarg):
            if a is not None and a.arg not in STATIC_PARAM_NAMES:
                self.tainted.add(a.arg)

    def is_tainted(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `is` / `is not` / `in` compare Python identity or membership
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return (self.is_tainted(node.left)
                    or any(self.is_tainted(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, (ast.Constant, ast.JoinedStr, ast.Lambda)):
            return False
        if isinstance(node, ast.Dict):
            return any(v is not None and self.is_tainted(v)
                       for v in list(node.keys) + list(node.values))
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                             ast.DictComp)):
            inner = self.copy()
            for gen in node.generators:
                inner.assign([gen.target], gen.iter)
            if isinstance(node, ast.DictComp):
                return inner.is_tainted(node.key) or inner.is_tainted(
                    node.value)
            return inner.is_tainted(node.elt)
        # the rest: tainted if any name in it is
        return any(isinstance(n, ast.Name) and n.id in self.tainted
                   for n in ast.walk(node))

    def _call_tainted(self, node: ast.Call) -> bool:
        fn = dotted(node.func)
        tail = fn.rsplit(".", 1)[-1]
        if fn in CONCRETIZING_CALLS:
            return False
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in META_METHODS | {"item", "tolist"}:
                return False      # host values (.item() is TL001's question)
        if self.host_call(node):
            return False
        root = fn.split(".", 1)[0]
        if root == "torch":
            return tail not in TORCH_HOST_CALLS
        if fn in ("float", "int", "bool", "str", "math.prod", "math.sqrt"):
            return False
        # unknown callee: tainted if its receiver or any argument is
        recv = node.func.value if isinstance(node.func, ast.Attribute) \
            else None
        return ((recv is not None and self.is_tainted(recv))
                or any(self.is_tainted(a) for a in node.args)
                or any(kw.value is not None and self.is_tainted(kw.value)
                       for kw in node.keywords))

    def copy(self) -> "Taint":
        out = Taint.__new__(Taint)
        out.tainted, out.masks = set(self.tainted), set(self.masks)
        out.host_call = self.host_call
        return out

    def is_mask(self, node: ast.expr) -> bool:
        """Whether ``node`` holds a boolean tensor."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.is_tainted(node)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            return node.func.attr == "bool" and self.is_tainted(
                node.func.value)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        return False

    def assign(self, targets: List[ast.expr], value: ast.expr) -> None:
        tainted = self.is_tainted(value)
        mask = self.is_mask(value)
        for t in targets:
            for name in target_names(t):
                (self.tainted.add if tainted else self.tainted.discard)(name)
                (self.masks.add if mask else self.masks.discard)(name)


def target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in target.elts:
            out.extend(target_names(e))
        return out
    if isinstance(target, ast.Starred):
        return target_names(target.value)
    return []


def walk_statements(fn: FuncNode):
    """Yield statements of ``fn`` in source order, skipping nested defs
    (they get their own treatment)."""

    def _walk(body):
        for stmt in body:
            yield stmt
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    yield from _walk(sub)
            for handler in getattr(stmt, "handlers", ()) or ():
                yield from _walk(handler.body)

    yield from _walk(fn.body)


def lambda_as_fn(lam: ast.Lambda) -> ast.FunctionDef:
    fn = ast.FunctionDef(name="<lambda>", args=lam.args,
                         body=[ast.Return(value=lam.body)],
                         decorator_list=[], returns=None, type_params=[])
    return ast.fix_missing_locations(ast.copy_location(fn, lam))

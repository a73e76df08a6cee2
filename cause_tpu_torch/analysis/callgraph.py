"""Module indexing and the jit-reachability call graph.

causelint's rules need one non-local fact: *is this function reachable
from traced code?* A host helper may read the clock or the environment
freely; the same read inside anything `jax.jit`/`vmap`/`shard_map`/
`pallas_call` ultimately traces is a program-identity or purity hazard.
This module computes that fact with stdlib ``ast`` only:

- every scanned file becomes a :class:`ModuleInfo` (dotted name derived
  from its path, functions/lambdas as :class:`FuncInfo` nodes with
  lexical parents, per-scope import aliases, and the raw call list of
  each body);
- **seeding**: any function handed to a tracing wrapper — a
  ``@jax.jit`` / ``@partial(jax.jit, ...)`` / ``@partial(shard_map,
  ...)`` decorator, a ``jax.jit(f)`` / ``jax.vmap(f)`` /
  ``pallas_call(kernel, ...)`` call (nested wrappers recurse:
  ``jax.jit(jax.vmap(f))`` seeds ``f``), or a lambda in any of those
  positions — is a trace root;
- **reachability**: BFS over name-resolved call edges. Resolution is
  lexical (own nested defs, enclosing functions, module scope) then
  import-based (aliases resolved against the scanned module set, so
  ``mesh.step -> vmap lambda -> merge_weave_kernel_v3 ->
  bitonic.sort_pairs -> switches.resolve`` is a real path). Unresolved
  calls (methods on unknown objects, builtins) drop silently — the
  graph is lint-grade, deliberately best-effort, and biased toward
  under-approximation so rules stay low-noise.

No jax or torch import anywhere (the lint runs before either is installed).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

# A call whose callee's terminal name is one of these receives
# functions that will be traced: its function-valued arguments (and
# decorated defs) seed the reachability BFS.
TRACE_WRAPPERS = frozenset(
    {"jit", "vmap", "pmap", "shard_map", "pallas_call", "grad",
     "value_and_grad", "checkpoint", "remat"}
)
# partial(...) forwards its function arguments; recurse through it when
# hunting wrapped callables inside decorators.
_FORWARDERS = frozenset({"partial"})


def dotted_parts(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for non-name expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class FuncInfo:
    """One function-like scope (def, async def, or lambda)."""

    __slots__ = ("fid", "node", "module", "parent", "qualname",
                 "local_funcs", "imports", "calls", "class_name")

    def __init__(self, fid: str, node: ast.AST, module: "ModuleInfo",
                 parent: Optional["FuncInfo"], qualname: str,
                 class_name: Optional[str]):
        self.fid = fid
        self.node = node
        self.module = module
        self.parent = parent
        self.qualname = qualname
        self.class_name = class_name      # enclosing class, if a method
        self.local_funcs: Dict[str, str] = {}   # name -> fid
        self.imports: Dict[str, str] = {}       # alias -> dotted target
        # (parts, lineno) per call whose callee is a name chain
        self.calls: List[Tuple[List[str], int]] = []

    def body_nodes(self):
        """This scope's own statements, excluding nested function/
        lambda bodies (those are their own FuncInfo)."""
        roots = (self.node.body if isinstance(self.node.body, list)
                 else [self.node.body])
        stack = list(roots)
        while stack:
            n = stack.pop()
            yield n
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                stack.append(child)


class ModuleInfo:
    """One scanned file: AST, source, scopes, suppressions."""

    __slots__ = ("name", "path", "tree", "source", "lines", "funcs",
                 "top_funcs", "imports", "parse_error", "_pending_roots")

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.tree: Optional[ast.Module] = None
        self.source = ""
        self.lines: List[str] = []
        self.funcs: Dict[str, FuncInfo] = {}
        self.top_funcs: Dict[str, str] = {}   # module-level name -> fid
        self.imports: Dict[str, str] = {}     # module-level aliases
        self.parse_error: Optional[SyntaxError] = None
        self._pending_roots: tuple = ((), ())

    @property
    def segments(self) -> Tuple[str, ...]:
        return tuple(self.name.split("."))


def module_name_for(path: str, root: str) -> str:
    """Dotted module name of ``path`` relative to the scan root
    (``a/b/c.py`` -> ``a.b.c``; package ``__init__`` collapses onto the
    package name). Paths outside the root fall back to the stem."""
    try:
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    except ValueError:  # pragma: no cover - windows cross-drive
        rel = os.path.basename(path)
    if rel.startswith(".."):
        rel = os.path.basename(path)
    name = rel[:-3] if rel.endswith(".py") else rel
    name = name.replace(os.sep, ".").replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _resolve_relative(module: ModuleInfo, level: int,
                      target: Optional[str]) -> str:
    """``from ..x import y`` inside package ``a.b.c`` -> ``a.x``."""
    parts = list(module.segments[:-1])  # the module's package
    for _ in range(level - 1):
        if parts:
            parts.pop()
    if target:
        parts.extend(target.split("."))
    return ".".join(parts)


class _Indexer(ast.NodeVisitor):
    """Builds FuncInfo scopes with lexical parents and call lists."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.scope: Optional[FuncInfo] = None
        self.class_stack: List[str] = []
        self.roots: List[str] = []   # fids seeded by trace wrappers
        # (scope, parts) seeds that need the cross-module index —
        # resolved by build_program once every file is indexed
        self.named_roots: List[Tuple[Optional[FuncInfo], List[str]]] = []

    # ------------------------------------------------------- imports
    def _record_import(self, alias: str, target: str) -> None:
        table = (self.scope.imports if self.scope is not None
                 else self.module.imports)
        table[alias] = target

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self._record_import(a.asname or a.name.split(".")[0],
                                a.name if a.asname else
                                a.name.split(".")[0])
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = (node.module or "")
        if node.level:
            base = _resolve_relative(self.module, node.level, node.module)
        for a in node.names:
            if a.name == "*":
                continue
            self._record_import(a.asname or a.name,
                                f"{base}.{a.name}" if base else a.name)
        self.generic_visit(node)

    # -------------------------------------------------------- scopes
    def _enter(self, node, display: str) -> FuncInfo:
        qual = (f"{self.scope.qualname}.{display}" if self.scope
                else ".".join(self.class_stack + [display]))
        fid = f"{self.module.name}::{qual}"
        info = FuncInfo(fid, node, self.module, self.scope, qual,
                        self.class_stack[-1] if self.class_stack else None)
        self.module.funcs[fid] = info
        if self.scope is not None:
            self.scope.local_funcs[display] = fid
        elif not self.class_stack:
            self.module.top_funcs[display] = fid
        else:
            # methods are addressable as Class.method at module level
            self.module.top_funcs[qual] = fid
        return info

    def _visit_func(self, node, display: str) -> None:
        info = self._enter(node, display)
        if not isinstance(node, ast.Lambda):
            for dec in node.decorator_list:
                if self._is_trace_wrapper(dec):
                    self.roots.append(info.fid)
        outer, self.scope = self.scope, info
        self.generic_visit(node)
        self.scope = outer

    def visit_FunctionDef(self, node):  # noqa: N802
        self._visit_func(node, node.name)

    def visit_AsyncFunctionDef(self, node):  # noqa: N802
        self._visit_func(node, node.name)

    def visit_Lambda(self, node):  # noqa: N802
        self._visit_func(node, f"<lambda@{node.lineno}>")

    def visit_ClassDef(self, node):  # noqa: N802
        if self.scope is None:
            self.class_stack.append(node.name)
            self.generic_visit(node)
            self.class_stack.pop()
        else:
            self.generic_visit(node)

    # --------------------------------------------------------- calls
    def _is_trace_wrapper(self, node: ast.AST) -> bool:
        """Whether this decorator/callee expression ends in a tracing
        wrapper, directly (``jax.jit``) or through a forwarder call
        (``partial(jax.jit, ...)`` / ``partial(shard_map, ...)``)."""
        parts = dotted_parts(node)
        if parts is not None:
            return parts[-1].lstrip("_") in TRACE_WRAPPERS
        if isinstance(node, ast.Call):
            cparts = dotted_parts(node.func)
            if cparts is not None and (
                    cparts[-1].lstrip("_") in TRACE_WRAPPERS
                    or cparts[-1] in _FORWARDERS):
                if cparts[-1] in _FORWARDERS:
                    return any(self._is_trace_wrapper(a)
                               for a in node.args)
                return True
        return False

    def _seed_from_args(self, call: ast.Call) -> None:
        """``jax.jit(f)`` / ``vmap(lambda: ...)`` — function-valued
        arguments of a tracing wrapper become roots; nested wrapper
        calls recurse."""
        for arg in call.args:
            if isinstance(arg, ast.Lambda):
                # the lambda's FuncInfo is minted when generic_visit
                # reaches it; compute its fid the same way
                qual = (f"{self.scope.qualname}.<lambda@{arg.lineno}>"
                        if self.scope else f"<lambda@{arg.lineno}>")
                self.roots.append(f"{self.module.name}::{qual}")
            elif isinstance(arg, ast.Call):
                cparts = dotted_parts(arg.func)
                if cparts is not None and (
                        cparts[-1].lstrip("_") in TRACE_WRAPPERS
                        or cparts[-1] in _FORWARDERS):
                    self._seed_from_args(arg)
            else:
                parts = dotted_parts(arg)
                if parts is not None:
                    fid = resolve_name(self.scope, self.module, parts)
                    if fid is not None:
                        self.roots.append(fid)
                    else:
                        # imported function handed to a wrapper:
                        # resolvable only once every module is indexed
                        self.named_roots.append((self.scope, parts))

    def visit_Assign(self, node: ast.Assign) -> None:  # noqa: N802
        # function aliases: ``_compressed = merge_weave_kernel_v2`` and
        # ``batched = functools.partial(fn, ...)`` create call-graph
        # edges exactly like imports do, so record them in the same
        # per-scope alias table (value resolved lazily at BFS time)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            value = node.value
            if isinstance(value, ast.Call):
                cparts = dotted_parts(value.func)
                if (cparts is not None and cparts[-1] in _FORWARDERS
                        and value.args):
                    value = value.args[0]
            parts = dotted_parts(value)
            if parts is not None:
                dotted = self._alias_target(parts)
                if dotted is not None:
                    self._record_import(node.targets[0].id, dotted)
        self.generic_visit(node)

    def _alias_target(self, parts: List[str]) -> Optional[str]:
        """Dotted global name an aliased value will resolve to, or
        None when the head is unknown (plain data assignments)."""
        head = parts[0]
        s = self.scope
        while s is not None:
            if head in s.local_funcs and len(parts) == 1:
                # nested defs are addressed by fid, not dotted name;
                # keep the qualname path so the index lookup works
                return None
            if head in s.imports:
                return ".".join([s.imports[head]] + parts[1:])
            s = s.parent
        if head in self.module.top_funcs and len(parts) == 1:
            return f"{self.module.name}.{head}"
        if head in self.module.imports:
            return ".".join([self.module.imports[head]] + parts[1:])
        return None

    def visit_Call(self, node: ast.Call) -> None:
        parts = dotted_parts(node.func)
        if parts is not None:
            if self.scope is not None:
                self.scope.calls.append((parts, node.lineno))
            if parts[-1].lstrip("_") in TRACE_WRAPPERS:
                self._seed_from_args(node)
        self.generic_visit(node)


def resolve_name(scope: Optional[FuncInfo], module: ModuleInfo,
                 parts: List[str],
                 index: Optional[Dict[str, str]] = None) -> Optional[str]:
    """Resolve a dotted name to a FuncInfo fid: lexical scopes first
    (nested defs), then per-scope and module imports, then module-level
    defs, then the cross-module index of every scanned file."""
    head = parts[0]
    s = scope
    while s is not None:
        if head in s.local_funcs and len(parts) == 1:
            return s.local_funcs[head]
        if head in s.imports:
            return _resolve_dotted(
                ".".join([s.imports[head]] + parts[1:]), index)
        s = s.parent
    if head in module.top_funcs and len(parts) == 1:
        return module.top_funcs[head]
    if len(parts) == 2 and f"{head}.{parts[1]}" in module.top_funcs:
        return module.top_funcs[f"{head}.{parts[1]}"]
    if head == "self" and scope is not None and scope.class_name:
        meth = f"{scope.class_name}.{parts[-1]}"
        if meth in module.top_funcs:
            return module.top_funcs[meth]
    if head in module.imports:
        return _resolve_dotted(
            ".".join([module.imports[head]] + parts[1:]), index)
    return None


def _resolve_dotted(dotted: str,
                    index: Optional[Dict[str, str]]) -> Optional[str]:
    return None if index is None else index.get(dotted)


class Program:
    """The scanned module set plus the jit-reachability answer."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = modules
        # dotted global name ("pkg.mod.fn" / "pkg.mod.Cls.meth") -> fid
        self.index: Dict[str, str] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self.roots: List[str] = []
        for m in modules:
            self.funcs.update(m.funcs)
            for name, fid in m.top_funcs.items():
                self.index[f"{m.name}.{name}"] = fid
        self._reachable: Optional[Set[str]] = None

    def add_roots(self, fids: List[str]) -> None:
        self.roots.extend(f for f in fids if f in self.funcs)

    def resolve_call(self, info: FuncInfo,
                     parts: List[str]) -> Optional[str]:
        return resolve_name(info, info.module, parts, self.index)

    def reachable(self) -> Set[str]:
        """fids reachable from any trace root (roots included)."""
        if self._reachable is None:
            seen: Set[str] = set()
            queue = [f for f in self.roots if f in self.funcs]
            while queue:
                fid = queue.pop()
                if fid in seen:
                    continue
                seen.add(fid)
                info = self.funcs[fid]
                for parts, _ln in info.calls:
                    target = self.resolve_call(info, parts)
                    if target is not None and target not in seen:
                        queue.append(target)
            self._reachable = seen
        return self._reachable

    def reachable_from(self, fids: List[str]) -> Set[str]:
        """Closure over the call graph from an explicit seed list
        (used by rule TID003 to scope a cached program's trace)."""
        seen: Set[str] = set()
        queue = [f for f in fids if f in self.funcs]
        while queue:
            fid = queue.pop()
            if fid in seen:
                continue
            seen.add(fid)
            info = self.funcs[fid]
            for parts, _ln in info.calls:
                target = self.resolve_call(info, parts)
                if target is not None and target not in seen:
                    queue.append(target)
        return seen


def index_module(path: str, root: str) -> ModuleInfo:
    """Parse and index one file. Parse failures are recorded on the
    ModuleInfo (the core turns them into findings), never raised."""
    mod = ModuleInfo(module_name_for(path, root), path)
    try:
        with open(path, encoding="utf-8") as f:
            mod.source = f.read()
        mod.lines = mod.source.splitlines()
        mod.tree = ast.parse(mod.source, filename=path)
    except SyntaxError as e:
        mod.parse_error = e
        return mod
    except (OSError, UnicodeDecodeError) as e:
        mod.parse_error = SyntaxError(str(e))
        return mod
    indexer = _Indexer(mod)
    indexer.visit(mod.tree)
    mod._pending_roots = (indexer.roots, indexer.named_roots)
    return mod


def build_program(paths: List[str], root: str) -> Program:
    """Index every file and wire the cross-module call graph."""
    modules = [index_module(p, root) for p in paths]
    prog = Program(modules)
    for m in modules:
        fids, named = m._pending_roots if m._pending_roots else ([], [])
        prog.add_roots(fids)
        for scope, parts in named:
            fid = resolve_name(scope, m, parts, prog.index)
            if fid is not None:
                prog.add_roots([fid])
    return prog

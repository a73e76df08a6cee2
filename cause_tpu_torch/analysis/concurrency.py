"""The LCK family: lock discipline for the serve/net/WAL substrate.

The serving plane is concurrent host code (serve tick/watchdog
threads, per-connection net handler threads, the WAL's fsync/rotate/GC
protocol), and its bugs fall into a few classes that this module
checks mechanically:

- **LCK001** — guarded-by violations. For every class that owns a
  ``threading.Lock``/``RLock``/``Condition`` attribute, infer the
  guarded-by set of each ``self.*`` attribute from where it is
  *written*: a write inside a ``with self._lock:`` region (or inside a
  ``*_locked``-suffixed method, the repo's caller-holds-the-lock
  convention) marks the attribute lock-guarded. Any lock-free read or
  write of a guarded attribute in another thread-reachable method is a
  finding (boundary-reject stats bumped lock-free; a non-atomic
  filter->offer->advance).
- **LCK002** — lock-order cycles. Build the lock-acquisition order
  graph across the call graph (an edge A->B when B is acquired, lexically
  or through calls, while A is held) and flag every edge on a cycle
  plus reacquisition of a non-reentrant ``Lock``.
- **LCK003** — blocking calls while holding a lock: ``fsync``,
  ``recv``, ``sleep``, ``join``, socket ``connect``/``accept``,
  ``select`` and the ``subprocess`` family, directly or through
  resolved helpers. Calls into ``*_locked`` helpers are the class's
  *declared* under-lock protocol and are not followed.
- **LCK004** — commit-step reentrancy: a function that seals/rotates/
  commits state reachable from itself through an error path (the
  double-seal shape: ``_fsync_locked`` failure handling calling
  back into ``_rotate_locked``).

Thread-reachability is seeded from ``threading.Thread(target=...)``
spawns (watchdog closures, socket handler spawns) and callback
registration surfaces (``on_*=``/``callback=`` keywords, the
LiveMonitor ``attach(on_alert=[...])`` surface), then closed over the
call graph. The resolver extends the callgraph's name resolution with
attribute types recovered from ``__init__`` (direct construction,
annotated parameters, annotated return types), so
``handler -> self.queue.offer`` edges resolve cross-class.

Known approximations: the
model is flow-insensitive; a class is only checked once some method of
it is thread-reachable or it spawns threads itself; ``acquire()`` /
``release()`` pairs outside ``with`` are invisible; cross-object lock
identity is per-class, so two instances sharing a lock object are not
distinguished. Stdlib-only, like the rest of causelint.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .callgraph import FuncInfo, ModuleInfo, Program, dotted_parts
from .rules import Context, Finding, _finding, rule

_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})
# attribute method calls that mutate the receiver object in place
_MUTATORS = frozenset(
    {"append", "add", "update", "setdefault", "pop", "clear", "extend",
     "insert", "popitem", "remove", "discard"}
)
# blocking terminal names (LCK003); `join` and `connect` carry extra
# shape checks so str.join / os.path.join / sqlite3.connect never flag
_BLOCKING_BARE = frozenset(
    {"fsync", "fdatasync", "recv", "recv_into", "recvfrom", "accept",
     "sleep", "select"}
)
_SUBPROCESS_CALLS = frozenset(
    {"run", "call", "check_call", "check_output", "Popen"}
)
# commit-protocol verbs for the reentrancy rule: only cycles touching
# one of these are flagged, so ordinary recursion stays quiet
_COMMIT_VERBS = ("rotate", "seal", "commit", "fsync", "checkpoint",
                 "flush", "close", "gc", "retire")
# guard marker for attributes whose only write sites are *_locked
# convention methods (guarded, but by an unnamed lock)
_CONVENTION = "<*_locked convention>"

_CRASH_SEAMS = frozenset({"should_crash", "stall_point"})


def _last_name(qualname: str) -> str:
    return qualname.split(".")[-1].split("<")[0] or qualname


def _is_locked_name(qualname: str) -> bool:
    return qualname.split(".")[-1].endswith("_locked")


def _is_dunder(qualname: str) -> bool:
    n = qualname.split(".")[-1]
    return n.startswith("__") and n.endswith("__")


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X`` (one level only), else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _chain_self_attr(node: ast.AST) -> Optional[str]:
    """The first attribute off ``self`` in an access chain:
    ``self.X``, ``self.X[i]``, ``self.X.y[i]`` all -> ``X``."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        attr = _self_attr(node)
        if attr is not None:
            return attr
        node = node.value
    return None


def _ann_name(node: Optional[ast.AST]) -> Optional[str]:
    """Terminal class name of an annotation (``IngestQueue``,
    ``serve.IngestQueue``, ``"IngestQueue"``, ``Optional[X]`` -> X)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip("'\" ]")
    if isinstance(node, ast.Subscript):
        return _ann_name(node.slice)
    parts = dotted_parts(node)
    return parts[-1] if parts else None


class _ClassModel:
    __slots__ = ("name", "module", "lock_attrs", "methods",
                 "spawns_thread", "attr_types")

    def __init__(self, name: str, module: ModuleInfo):
        self.name = name
        self.module = module
        self.lock_attrs: Dict[str, str] = {}     # attr -> Lock/RLock/...
        self.methods: List[FuncInfo] = []        # incl. nested closures
        self.spawns_thread = False
        self.attr_types: Dict[str, str] = {}     # attr -> class name


def _lock_factory_kind(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Call):
        parts = dotted_parts(value.func)
        if parts and parts[-1] in _LOCK_FACTORIES:
            if len(parts) == 1 or parts[-2] in ("threading", "th"):
                return parts[-1]
    return None


class _EventWalker:
    """Walks one function body tracking the lexically held lock set.

    Yields tuples:
      ("call",  node, held, in_err)
      ("read",  attr, node, held)
      ("write", attr, node, held)
      ("acquire", lock_id, node, held_before)
    Nested function/lambda bodies are their own scopes and are skipped
    (a closure defined under a lock does not *run* under it).
    """

    def __init__(self, info: FuncInfo, class_locks: Dict[str, str],
                 module_locks: Dict[str, str], module_name: str):
        self.info = info
        self.class_locks = class_locks
        self.module_locks = module_locks
        self.module_name = module_name
        self.events: List[tuple] = []

    def _lock_id(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.class_locks:
            return f"{self.info.class_name}.{attr}"
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return f"{self.module_name}.{expr.id}"
        return None

    def run(self) -> List[tuple]:
        body = (self.info.node.body
                if isinstance(self.info.node.body, list)
                else [ast.Expr(value=self.info.node.body)])
        self._stmts(body, frozenset(), False)
        return self.events

    def _stmts(self, stmts, held: FrozenSet[str], in_err: bool) -> None:
        for s in stmts:
            self._node(s, held, in_err)

    def _node(self, n, held: FrozenSet[str], in_err: bool) -> None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                lid = self._lock_id(item.context_expr)
                self._node(item.context_expr, held, in_err)
                if lid is not None:
                    self.events.append(
                        ("acquire", lid, item.context_expr, held))
                    held = held | {lid}
            self._stmts(n.body, held, in_err)
            return
        if isinstance(n, ast.Try):
            self._stmts(n.body, held, in_err)
            for h in n.handlers:
                self._stmts(h.body, held, True)
            self._stmts(n.orelse, held, in_err)
            self._stmts(n.finalbody, held, True)
            return
        if isinstance(n, ast.Call):
            self.events.append(("call", n, held, in_err))
            # the callee chain: self.meth() is dispatch, not a state
            # read; self.X.append() mutates X; deeper chains read X
            func = n.func
            if isinstance(func, ast.Attribute):
                recv = func.value
                attr = _chain_self_attr(recv)
                if attr is not None:
                    kind = ("write" if func.attr in _MUTATORS
                            else "read")
                    self.events.append((kind, attr, func, held))
                    # still walk subscript indices inside the receiver
                    self._children(recv, held, in_err, skip_attrs=True)
                elif _self_attr(func) is None:
                    self._node(recv, held, in_err)
            else:
                self._node(func, held, in_err)
            for a in n.args:
                self._node(a, held, in_err)
            for kw in n.keywords:
                self._node(kw.value, held, in_err)
            return
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (n.targets if isinstance(n, ast.Assign)
                       else [n.target])
            for t in targets:
                attr = _chain_self_attr(t)
                if attr is not None:
                    self.events.append(("write", attr, t, held))
                    self._children(t, held, in_err, skip_attrs=True)
                else:
                    self._node(t, held, in_err)
            value = getattr(n, "value", None)
            if value is not None:
                self._node(value, held, in_err)
            return
        if isinstance(n, ast.Attribute):
            attr = _self_attr(n)
            if attr is not None:
                kind = ("write" if isinstance(n.ctx, (ast.Store, ast.Del))
                        else "read")
                self.events.append((kind, attr, n, held))
                return
            self._node(n.value, held, in_err)
            return
        self._children(n, held, in_err)

    def _children(self, n, held, in_err, skip_attrs: bool = False):
        for name, value in ast.iter_fields(n):
            if skip_attrs and name in ("value",):
                continue
            for c in (value if isinstance(value, list) else [value]):
                if isinstance(c, ast.AST):
                    self._node(c, held, in_err)


def _blocking_op(call: ast.Call) -> Optional[str]:
    """The blocking-operation label of a call, or None."""
    parts = dotted_parts(call.func)
    if parts is None:
        return None
    last = parts[-1]
    quals = parts[:-1]
    if "subprocess" in parts and (last in _SUBPROCESS_CALLS
                                  or parts[0] == "subprocess"):
        return f"subprocess.{last}"
    if last in _BLOCKING_BARE:
        if last == "sleep" and quals and quals[-1] not in ("time",):
            # anything.sleep() beyond time.sleep is rare; still count
            pass
        return last
    if last == "join":
        # Thread.join blocks; str.join / os.path.join never do. A
        # thread join has no positional args (or a numeric timeout).
        if "path" in parts or parts[0] == "os":
            return None
        if not call.args and not call.keywords:
            return "join"
        if (len(call.args) == 1 and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, (int, float))):
            return "join"
        if any(kw.arg == "timeout" for kw in call.keywords):
            return "join"
        return None
    if last == "connect" and "sqlite3" not in parts:
        return "connect"
    return None


class ConcurrencyModel:
    """Whole-program lock/thread facts, built once per analysis run."""

    def __init__(self, program: Program):
        self.program = program
        self.classes: Dict[str, Dict[str, _ClassModel]] = {}
        self.module_locks: Dict[str, Dict[str, str]] = {}
        self.class_index: Dict[str, ModuleInfo] = {}
        self.lock_kinds: Dict[str, str] = {}      # lock id -> kind
        self.events: Dict[str, List[tuple]] = {}  # fid -> event list
        self.thread_entries: Set[str] = set()
        self.thread_reachable: Set[str] = set()
        self.crash_sites: Dict[str, List[tuple]] = {}  # module -> sites
        self._build()

    # ------------------------------------------------------ structure
    def _build(self) -> None:
        for m in self.program.modules:
            if m.tree is None:
                continue
            self._index_module(m)
        for m in self.program.modules:
            if m.tree is None:
                continue
            self._type_attrs(m)
        self._walk_all()
        self._seed_threads()
        self.thread_reachable = self._closure(sorted(self.thread_entries))

    def _index_module(self, m: ModuleInfo) -> None:
        locks: Dict[str, str] = {}
        for n in m.tree.body:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                kind = _lock_factory_kind(n.value)
                if kind:
                    locks[n.targets[0].id] = kind
                    self.lock_kinds[f"{m.name}.{n.targets[0].id}"] = kind
        self.module_locks[m.name] = locks
        classes: Dict[str, _ClassModel] = {}
        for info in m.funcs.values():
            if info.class_name is None:
                continue
            cm = classes.get(info.class_name)
            if cm is None:
                cm = classes[info.class_name] = _ClassModel(
                    info.class_name, m)
                self.class_index.setdefault(info.class_name, m)
            cm.methods.append(info)
        # lock attributes: `self.X = threading.Lock()` anywhere
        for cm in classes.values():
            for info in cm.methods:
                for n in info.body_nodes():
                    if isinstance(n, ast.Assign):
                        attr = (_self_attr(n.targets[0])
                                if len(n.targets) == 1 else None)
                        kind = _lock_factory_kind(n.value)
                        if attr and kind:
                            cm.lock_attrs[attr] = kind
                            self.lock_kinds[f"{cm.name}.{attr}"] = kind
                    if isinstance(n, ast.Call):
                        parts = dotted_parts(n.func)
                        if parts and parts[-1] == "Thread":
                            cm.spawns_thread = True
        self.classes[m.name] = classes

    def _type_attrs(self, m: ModuleInfo) -> None:
        """attr -> class-name map per class, from ``__init__`` shapes:
        direct construction, annotated parameters, and calls whose
        resolved target has an annotated return type."""
        for cm in self.classes[m.name].values():
            for info in cm.methods:
                params: Dict[str, str] = {}
                if not isinstance(info.node, ast.Lambda):
                    for a in (list(info.node.args.args)
                              + list(info.node.args.kwonlyargs)):
                        t = _ann_name(a.annotation)
                        if t and t in self.class_index:
                            params[a.arg] = t
                for n in info.body_nodes():
                    attr, value = None, None
                    if isinstance(n, ast.Assign) and len(n.targets) == 1:
                        attr, value = _self_attr(n.targets[0]), n.value
                    elif isinstance(n, ast.AnnAssign):
                        attr = _self_attr(n.target)
                        t = _ann_name(n.annotation)
                        if attr and t and t in self.class_index:
                            cm.attr_types.setdefault(attr, t)
                        value = n.value
                    if attr is None or value is None:
                        continue
                    if isinstance(value, ast.Name) \
                            and value.id in params:
                        cm.attr_types.setdefault(attr, params[value.id])
                    elif isinstance(value, ast.Call):
                        parts = dotted_parts(value.func)
                        if parts is None:
                            continue
                        if parts[-1] in self.class_index:
                            cm.attr_types.setdefault(attr, parts[-1])
                        else:
                            fid = self.program.resolve_call(info, parts)
                            fn = (self.program.funcs.get(fid)
                                  if fid else None)
                            rt = (_ann_name(getattr(fn.node, "returns",
                                                    None))
                                  if fn is not None and not isinstance(
                                      fn.node, ast.Lambda) else None)
                            if rt and rt in self.class_index:
                                cm.attr_types.setdefault(attr, rt)

    def _walk_all(self) -> None:
        for m in self.program.modules:
            if m.tree is None:
                continue
            crash: List[tuple] = []
            for fid, info in m.funcs.items():
                class_locks = {}
                if info.class_name:
                    cm = self.classes[m.name].get(info.class_name)
                    if cm is not None:
                        class_locks = cm.lock_attrs
                ev = _EventWalker(info, class_locks,
                                  self.module_locks[m.name],
                                  m.name).run()
                self.events[fid] = ev
                for kind, *rest in ev:
                    if kind != "call":
                        continue
                    node, held, _err = rest
                    parts = dotted_parts(node.func)
                    if parts and parts[-1] in _CRASH_SEAMS and held:
                        crash.append((node, frozenset(held), info))
            self.crash_sites[m.name] = crash

    # -------------------------------------------------------- threads
    def resolve(self, info: FuncInfo,
                parts: List[str]) -> Optional[str]:
        """callgraph resolution plus typed-attribute dispatch:
        ``self.queue.offer`` resolves through the attr-type map.

        Deep ``self.X.y`` chains deliberately do NOT fall back to the
        callgraph's ``Class.y`` guess (fine for reachability over-
        approximation, wrong for lock analysis: ``self._fh.close()``
        is not ``Class.close``) — they resolve through the typed
        attribute map or not at all."""
        if (len(parts) >= 3 and parts[0] == "self"
                and info.class_name is not None):
            cm = self.classes.get(info.module.name, {}).get(
                info.class_name)
            target_cls = (cm.attr_types.get(parts[1])
                          if cm is not None else None)
            if target_cls is not None:
                tmod = self.class_index.get(target_cls)
                if tmod is not None:
                    return tmod.top_funcs.get(
                        f"{target_cls}.{parts[-1]}")
            return None
        return self.program.resolve_call(info, parts)

    def _resolve_callback(self, info: FuncInfo,
                          value: ast.AST) -> Iterator[str]:
        values = (value.elts if isinstance(value, (ast.List, ast.Tuple))
                  else [value])
        for v in values:
            parts = dotted_parts(v)
            if parts is None:
                continue
            fid = self.resolve(info, parts)
            if fid is None and len(parts) >= 3 and parts[0] == "self":
                fid = self.resolve(info, parts)
            if fid is not None:
                yield fid

    def _seed_threads(self) -> None:
        for m in self.program.modules:
            for fid, info in m.funcs.items():
                for n in info.body_nodes():
                    if not isinstance(n, ast.Call):
                        continue
                    parts = dotted_parts(n.func)
                    is_thread = parts is not None and \
                        parts[-1] == "Thread"
                    for kw in n.keywords:
                        if kw.arg is None:
                            continue
                        if (is_thread and kw.arg == "target") or \
                                kw.arg.startswith("on_") or \
                                kw.arg in ("callback", "callbacks"):
                            self.thread_entries.update(
                                self._resolve_callback(info, kw.value))

    def _closure(self, seeds: List[str]) -> Set[str]:
        seen: Set[str] = set()
        queue = [f for f in seeds if f in self.program.funcs]
        while queue:
            fid = queue.pop()
            if fid in seen:
                continue
            seen.add(fid)
            info = self.program.funcs[fid]
            for parts, _ln in info.calls:
                t = self.resolve(info, parts)
                if t is not None and t not in seen:
                    queue.append(t)
        return seen

    # ---------------------------------------------------- derived sets
    def class_is_threaded(self, cm: _ClassModel) -> bool:
        return cm.spawns_thread or any(
            f.fid in self.thread_reachable for f in cm.methods)

    def may_block(self) -> Dict[str, Set[str]]:
        """fid -> blocking-op labels it may perform, transitively.
        Propagation never crosses a ``*_locked`` callee boundary: those
        helpers are the class's declared under-lock protocol."""
        blocks: Dict[str, Set[str]] = {}
        for fid, ev in self.events.items():
            ops = {op for kind, *rest in ev if kind == "call"
                   for op in [_blocking_op(rest[0])] if op}
            if ops:
                blocks[fid] = ops
        changed = True
        while changed:
            changed = False
            for fid, info in self.program.funcs.items():
                for parts, _ln in info.calls:
                    t = self.resolve(info, parts)
                    if t is None or t == fid or t not in blocks:
                        continue
                    if _is_locked_name(
                            self.program.funcs[t].qualname):
                        continue
                    cur = blocks.setdefault(fid, set())
                    if not blocks[t] <= cur:
                        cur.update(blocks[t])
                        changed = True
        return blocks

    def may_acquire(self) -> Dict[str, Set[str]]:
        """fid -> lock ids it may acquire, transitively."""
        acq: Dict[str, Set[str]] = {}
        for fid, ev in self.events.items():
            lids = {rest[0] for kind, *rest in ev if kind == "acquire"}
            if lids:
                acq[fid] = lids
        changed = True
        while changed:
            changed = False
            for fid, info in self.program.funcs.items():
                for parts, _ln in info.calls:
                    t = self.resolve(info, parts)
                    if t is None or t == fid or t not in acq:
                        continue
                    cur = acq.setdefault(fid, set())
                    if not acq[t] <= cur:
                        cur.update(acq[t])
                        changed = True
        return acq


def model_for(ctx: Context) -> ConcurrencyModel:
    model = getattr(ctx, "_concurrency_model", None)
    if model is None:
        model = ConcurrencyModel(ctx.program)
        ctx._concurrency_model = model
    return model


def _lock_desc(lids) -> str:
    names = sorted(lids)
    return " + ".join(n if n != _CONVENTION
                      else "the class lock (held by *_locked convention)"
                      for n in names)


# ---------------------------------------------------------------- LCK001

@rule("LCK001",
      "lock-free access to a lock-guarded attribute in a "
      "thread-reachable method (guarded-by inference from `with "
      "self._lock:` regions and the *_locked naming convention)")
def check_lck001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    model = model_for(ctx)
    for cm in model.classes.get(module.name, {}).values():
        if not cm.lock_attrs or not model.class_is_threaded(cm):
            continue
        guarded: Dict[str, Set[str]] = {}
        writers: Dict[str, str] = {}
        accesses: List[tuple] = []
        for info in cm.methods:
            locked_conv = _is_locked_name(info.qualname)
            dunder = _is_dunder(info.qualname)
            for kind, *rest in model.events.get(info.fid, ()):
                if kind not in ("read", "write"):
                    continue
                attr, node, held = rest
                if attr in cm.lock_attrs:
                    continue
                if kind == "write":
                    if held:
                        guarded.setdefault(attr, set()).update(held)
                        writers.setdefault(attr, info.qualname)
                    elif locked_conv:
                        guarded.setdefault(attr, set()).add(_CONVENTION)
                        writers.setdefault(attr, info.qualname)
                if dunder or locked_conv:
                    continue
                accesses.append((attr, kind, node, held, info))
        seen_lines: Set[tuple] = set()
        for attr, kind, node, held, info in accesses:
            guards = guarded.get(attr)
            if not guards or held:
                continue
            key = (attr, getattr(node, "lineno", 0))
            if key in seen_lines:
                continue
            seen_lines.add(key)
            verb = "written" if kind == "write" else "read"
            yield _finding(
                "LCK001", module, node,
                f"self.{attr} is written under {_lock_desc(guards)} "
                f"(e.g. in {writers[attr]}) but {verb} lock-free in "
                f"{info.qualname}, which threads reach — take the "
                "lock, or move the access into a *_locked helper "
                "(the boundary-stats shape)")


# ---------------------------------------------------------------- LCK002

def _lock_edges(model: ConcurrencyModel):
    """(A, B) -> (module_name, node, via) acquisition-order edges."""
    acq = model.may_acquire()
    edges: Dict[Tuple[str, str], tuple] = {}
    for m in model.program.modules:
        for fid, info in m.funcs.items():
            for kind, *rest in model.events.get(fid, ()):
                if kind == "acquire":
                    lid, node, held = rest
                    for h in held:
                        edges.setdefault((h, lid), (m.name, node, None))
                    if not held:
                        continue
                elif kind == "call":
                    node, held, _err = rest
                    if not held:
                        continue
                    parts = dotted_parts(node.func)
                    t = model.resolve(info, parts) if parts else None
                    if t is None:
                        continue
                    via = model.program.funcs[t].qualname
                    for lid in acq.get(t, ()):
                        for h in held:
                            edges.setdefault((h, lid),
                                             (m.name, node, via))
    return edges


def _cyclic_nodes(edges) -> Set[str]:
    """Lock ids that sit on a cycle of >= 2 distinct locks."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        if a != b:
            graph.setdefault(a, set()).add(b)
    cyc: Set[str] = set()
    for start in graph:
        # DFS: can we come back to start?
        stack, seen = [start], set()
        while stack:
            n = stack.pop()
            for nxt in graph.get(n, ()):
                if nxt == start:
                    cyc.add(start)
                    stack = []
                    break
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
    return cyc


@rule("LCK002",
      "lock-acquisition order cycle across the call graph (deadlock "
      "potential), or reacquisition of a non-reentrant Lock")
def check_lck002(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    model = model_for(ctx)
    edges = getattr(ctx, "_lck002_edges", None)
    if edges is None:
        edges = ctx._lck002_edges = _lock_edges(model)
    cyc = getattr(ctx, "_lck002_cyc", None)
    if cyc is None:
        cyc = ctx._lck002_cyc = _cyclic_nodes(edges)
    for (a, b), (mod_name, node, via) in edges.items():
        if mod_name != module.name:
            continue
        if a == b:
            if model.lock_kinds.get(a) == "Lock":
                yield _finding(
                    "LCK002", module, node,
                    f"reacquisition of non-reentrant lock {a} on a "
                    "path that already holds it — self-deadlock; use "
                    "an RLock or split a *_locked helper"
                    + (f" (via {via}())" if via else ""))
            continue
        if a in cyc and b in cyc:
            yield _finding(
                "LCK002", module, node,
                f"acquiring {b} while holding {a}"
                + (f" (via {via}())" if via else "")
                + " completes a lock-order cycle — two threads "
                "interleaving the opposite orders deadlock; pick one "
                "global order and document it")


# ---------------------------------------------------------------- LCK003

@rule("LCK003",
      "blocking call (fsync/recv/sleep/join/connect/accept/select/"
      "subprocess) while holding a lock, directly or through resolved "
      "helpers")
def check_lck003(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    model = model_for(ctx)
    blocks = getattr(ctx, "_lck003_blocks", None)
    if blocks is None:
        blocks = ctx._lck003_blocks = model.may_block()
    for fid, info in module.funcs.items():
        for kind, *rest in model.events.get(fid, ()):
            if kind != "call":
                continue
            node, held, _err = rest
            if not held:
                continue
            op = _blocking_op(node)
            parts = dotted_parts(node.func)
            if op is not None:
                yield _finding(
                    "LCK003", module, node,
                    f"{'.'.join(parts)}() blocks on {op} while "
                    f"holding {_lock_desc(held)} — every thread "
                    "contending for the lock stalls behind the IO; "
                    "move the blocking call outside the region (or "
                    "suppress with the design reason)")
                continue
            t = model.resolve(info, parts) if parts else None
            if t is None or t not in blocks:
                continue
            callee = model.program.funcs[t]
            if _is_locked_name(callee.qualname):
                # declared under-lock protocol (caller holds by design)
                continue
            ops = "/".join(sorted(blocks[t]))
            yield _finding(
                "LCK003", module, node,
                f"call into {callee.qualname}() while holding "
                f"{_lock_desc(held)} — it blocks on {ops}; move the "
                "call outside the lock-held region (or suppress with "
                "the design reason)")


# ---------------------------------------------------------------- LCK004

def _error_edges(model: ConcurrencyModel):
    """Resolved call edges, each tagged with whether the call site sits
    on an error path (except handler / finally body)."""
    edges: Dict[Tuple[str, str], bool] = {}
    for fid, info in model.program.funcs.items():
        for kind, *rest in model.events.get(fid, ()):
            if kind != "call":
                continue
            node, _held, in_err = rest
            parts = dotted_parts(node.func)
            t = model.resolve(info, parts) if parts else None
            if t is None:
                continue
            key = (fid, t)
            edges[key] = edges.get(key, False) or in_err
    return edges


def _sccs(edges) -> List[Set[str]]:
    """Tarjan SCCs (iterative) over the edge dict's node set."""
    graph: Dict[str, List[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]
    for root in graph:
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = graph[node]
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                comp: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return out


@rule("LCK004",
      "commit-step reentrancy: a function that seals/rotates/commits "
      "state is reachable from itself through an error path (the "
      "double-seal shape)")
def check_lck004(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    model = model_for(ctx)
    cycles = getattr(ctx, "_lck004_cycles", None)
    if cycles is None:
        edges = _error_edges(model)
        cycles = []
        for comp in _sccs(edges):
            if len(comp) < 2 and not any(
                    (f, f) in edges for f in comp):
                continue
            in_err = any(err for (a, b), err in edges.items()
                         if a in comp and b in comp)
            if not in_err:
                continue
            verbs = [f for f in comp if any(
                v in _last_name(
                    model.program.funcs[f].qualname).lower()
                for v in _COMMIT_VERBS)]
            if verbs:
                cycles.append((comp, sorted(verbs)))
        ctx._lck004_cycles = cycles
    for comp, verbs in cycles:
        for fid in verbs:
            info = model.program.funcs[fid]
            if info.module.name != module.name:
                continue
            path = " -> ".join(sorted(
                model.program.funcs[f].qualname for f in comp))
            yield _finding(
                "LCK004", module, info.node,
                f"{info.qualname} commits/seals/rotates state and is "
                f"reachable from itself through an error path "
                f"({path}) — reentry applies the commit step twice "
                "(the double-seal shape); break the cycle by "
                "letting the caller decide the retry")

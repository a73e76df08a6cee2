"""The DUR (commit protocol) and EVD (evidence contract) families.

The WAL/checkpoint substrate commits state with one idiom:
write a tmp file, ``flush`` + ``os.fsync`` the fd, ``os.replace`` onto
the final name, then ``fsync_dir`` the parent so the rename itself is
durable. The admission path has a twin invariant: the
journal append *dominates* the ack (journal-before-ack), or a crash
between the two loses an acknowledged batch. And the serve/net
boundary has a convention of its own: every
refusal is evidence — a nack/shed/raise that emits no obs event is
invisible to the evidence ledger. These rules mechanize all three:

- **DUR001** — an ``os.replace``/``os.rename`` whose source file was
  opened for writing in the same function, with no ``os.fsync`` before
  the rename: the rename can land while the data is still in the page
  cache, committing a torn file.
- **DUR002** — same shape, but missing the ``fsync_dir`` directory
  sync after the rename (scoped to ``serve`` modules, where the
  ``wal.fsync_dir`` idiom applies — the rename is not durable until
  the directory entry is).
- **DUR003** — journal-before-ack: a function that appends to a
  journal/WAL must not return an admission ack lexically before the
  append (crash window loses an acked batch).
- **DUR004** — chaos crash seams (``should_crash``/``stall_point``)
  inside a lock-held region: a seam that fires while a lock is held
  models a crash no real process exhibits (locks die with the
  process), and a *stall* seam holding a lock serializes every other
  thread behind the fault injector.
- **EVD001** — a serve/net boundary refusal (``raise CausalError`` or
  an explicit nack/``Admission(False)`` return) on a path that emits
  no obs event/counter, directly or through a resolved helper (the
  "every refusal is evidence" invariant).

All flow-insensitive per-function (lexical order stands in for
dominance — the repo's commit helpers are small and straight-line),
stdlib-only, and riding the shared suppression/baseline machinery.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from .callgraph import FuncInfo, ModuleInfo, dotted_parts
from .concurrency import _lock_desc, model_for
from .rules import Context, Finding, _finding, rule

_WRITE_MODES = ("w", "a", "x", "+")
_ACK_OPS = frozenset({"ack", "admit", "welcome"})
_EVIDENCE_CALLS = frozenset({"event", "counter", "gauge", "span"})
_OBS_QUALS = frozenset({"obs", "_obs"})


def _in_serve_or_net(module: ModuleInfo) -> bool:
    segs = module.segments
    return "serve" in segs or "net" in segs


def _src_key(node: ast.AST) -> Optional[str]:
    """Identity of a file-path expression for matching an open() target
    against a rename source: a bare name or a self attribute."""
    if isinstance(node, ast.Name):
        return f"n:{node.id}"
    if isinstance(node, ast.Attribute):
        parts = dotted_parts(node)
        if parts is not None:
            return "a:" + ".".join(parts)
    return None


def _opened_for_write(info: FuncInfo) -> Dict[str, int]:
    """path-key -> first line where the function opens it writable."""
    out: Dict[str, int] = {}
    for n in info.body_nodes():
        if not isinstance(n, ast.Call):
            continue
        parts = dotted_parts(n.func)
        if parts is None or parts[-1] != "open" or not n.args:
            continue
        if parts[-1] == "open" and len(parts) > 1 \
                and parts[-2] not in ("io", "os"):
            continue  # foo.open() on an unknown object
        mode = None
        if len(n.args) >= 2 and isinstance(n.args[1], ast.Constant):
            mode = n.args[1].value
        for kw in n.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        if not isinstance(mode, str) \
                or not any(c in mode for c in _WRITE_MODES):
            continue
        key = _src_key(n.args[0])
        if key is not None:
            out.setdefault(key, n.lineno)
    return out


def _renames(info: FuncInfo):
    """(call node, src-key) for every os.replace/os.rename."""
    for n in info.body_nodes():
        if not isinstance(n, ast.Call):
            continue
        parts = dotted_parts(n.func)
        if (parts is not None and len(parts) >= 2
                and parts[-2] == "os"
                and parts[-1] in ("replace", "rename")
                and len(n.args) >= 2):
            yield n, _src_key(n.args[0])


def _call_lines(info: FuncInfo, pred) -> List[int]:
    return sorted(n.lineno for n in info.body_nodes()
                  if isinstance(n, ast.Call)
                  and pred(dotted_parts(n.func) or []))


# ---------------------------------------------------------------- DUR001

@rule("DUR001",
      "os.replace/os.rename of a file written in-function with no "
      "os.fsync on the tmp fd before the rename (torn-commit "
      "hazard)")
def check_dur001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    for info in module.funcs.values():
        writes = _opened_for_write(info)
        if not writes:
            continue
        fsyncs = _call_lines(
            info, lambda p: p and p[-1] in ("fsync", "fdatasync"))
        for call, src in _renames(info):
            if src is None or src not in writes:
                continue
            if not any(ln < call.lineno for ln in fsyncs):
                yield _finding(
                    "DUR001", module, call,
                    "os.replace() commits a file this function wrote "
                    "without an os.fsync on the tmp fd first — after "
                    "a crash the rename can be durable while the data "
                    "is not, publishing a torn file; fsync the file "
                    "object before renaming (see wal._write_manifest_"
                    "locked for the idiom)")


# ---------------------------------------------------------------- DUR002

@rule("DUR002",
      "os.replace/os.rename of a file written in-function with no "
      "fsync_dir on the parent directory afterwards (serve modules: "
      "the rename is not durable until the directory entry is)")
def check_dur002(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if "serve" not in module.segments:
        return
    for info in module.funcs.values():
        writes = _opened_for_write(info)
        if not writes:
            continue
        dir_syncs = _call_lines(
            info, lambda p: bool(p) and p[-1].endswith("fsync_dir"))
        for call, src in _renames(info):
            if src is None or src not in writes:
                continue
            if not any(ln > call.lineno for ln in dir_syncs):
                yield _finding(
                    "DUR002", module, call,
                    "os.replace() commits a file but the parent "
                    "directory is never fsynced afterwards — the "
                    "rename itself can be lost on crash; call "
                    "wal.fsync_dir(dirname) after the rename")


# ---------------------------------------------------------------- DUR003

def _is_ack_return(n: ast.Return) -> bool:
    v = n.value
    if isinstance(v, ast.Call):
        parts = dotted_parts(v.func)
        if parts is not None and parts[-1] == "Admission":
            if v.args and isinstance(v.args[0], ast.Constant):
                return v.args[0].value is True
            for kw in v.keywords:
                if kw.arg == "admitted" \
                        and isinstance(kw.value, ast.Constant):
                    return kw.value.value is True
    if isinstance(v, ast.Dict):
        for k, val in zip(v.keys, v.values):
            if (isinstance(k, ast.Constant) and k.value == "op"
                    and isinstance(val, ast.Constant)
                    and val.value in _ACK_OPS):
                return True
    return False


@rule("DUR003",
      "admission ack returned lexically before the journal/WAL append "
      "in the same function (journal-before-ack: a crash between ack "
      "and append loses an acknowledged batch)")
def check_dur003(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    for info in module.funcs.values():
        appends = _call_lines(
            info, lambda p: len(p) >= 2 and p[-1] == "append"
            and any(q in ("journal", "_journal", "wal", "_wal")
                    for q in p[:-1]))
        if not appends:
            continue
        first_append = min(appends)
        for n in info.body_nodes():
            if isinstance(n, ast.Return) and _is_ack_return(n) \
                    and n.lineno < first_append:
                yield _finding(
                    "DUR003", module, n,
                    "admission acked before the journal append that "
                    "records it — a crash in between loses an "
                    "acknowledged batch; append to the journal first, "
                    "ack after (journal-before-ack)")


# ---------------------------------------------------------------- DUR004

@rule("DUR004",
      "chaos crash seam (should_crash/stall_point) inside a lock-held "
      "region — a simulated crash-with-lock-held models no real "
      "failure, and a stall seam serializes threads behind the "
      "injector")
def check_dur004(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    model = model_for(ctx)
    for node, held, info in model.crash_sites.get(module.name, ()):
        parts = dotted_parts(node.func)
        yield _finding(
            "DUR004", module, node,
            f"{'.'.join(parts)}() fires while holding "
            f"{_lock_desc(held)} — crash seams belong between "
            "lock-held regions so the simulated failure matches a "
            "real process death (locks die with the process; stalls "
            "must not serialize other threads)")


# ---------------------------------------------------------------- EVD001

def _is_evidence_call(parts: List[str]) -> bool:
    if not parts or parts[-1] not in _EVIDENCE_CALLS:
        return False
    return (any(q in _OBS_QUALS for q in parts[:-1])
            or parts[0].startswith("_obs"))


def _emits_evidence(ctx: Context) -> Set[str]:
    """fids that call obs.event/counter/gauge/span, transitively."""
    model = model_for(ctx)
    emits: Set[str] = set()
    for fid, info in ctx.program.funcs.items():
        for parts, _ln in info.calls:
            if _is_evidence_call(parts):
                emits.add(fid)
                break
    changed = True
    while changed:
        changed = False
        for fid, info in ctx.program.funcs.items():
            if fid in emits:
                continue
            for parts, _ln in info.calls:
                t = model.resolve(info, parts)
                if t is not None and t in emits:
                    emits.add(fid)
                    changed = True
                    break
    return emits


def _is_refusal(n: ast.stmt):
    """A refusal statement: raise CausalError(...) or a nack /
    Admission(False) return. Returns a description or None."""
    if isinstance(n, ast.Raise) and isinstance(n.exc, ast.Call):
        parts = dotted_parts(n.exc.func)
        if parts is not None and parts[-1].endswith("CausalError"):
            return "raise CausalError"
    if isinstance(n, ast.Return):
        v = n.value
        if isinstance(v, ast.Call):
            parts = dotted_parts(v.func)
            if parts is not None and parts[-1] == "Admission":
                refused = False
                if v.args and isinstance(v.args[0], ast.Constant):
                    refused = v.args[0].value is False
                for kw in v.keywords:
                    if kw.arg == "admitted" \
                            and isinstance(kw.value, ast.Constant):
                        refused = kw.value.value is False
                if refused:
                    return "refusing Admission(False)"
        if isinstance(v, ast.Dict):
            for k, val in zip(v.keys, v.values):
                if (isinstance(k, ast.Constant) and k.value == "op"
                        and isinstance(val, ast.Constant)
                        and val.value == "nack"):
                    return "nack return"
    return None


class _RefusalWalker:
    """Walks a function body in lexical order tracking whether an
    evidence emission (direct obs call or resolved helper that emits)
    has occurred on the path so far. Lenient at joins: evidence in any
    branch counts for what follows — the rule hunts refusal paths with
    NO evidence anywhere upstream, not exact dominance."""

    def __init__(self, ctx: Context, info: FuncInfo, emits: Set[str]):
        self.ctx = ctx
        self.model = model_for(ctx)
        self.info = info
        self.emits = emits
        self.findings: List[ast.stmt] = []
        self.descs: List[str] = []

    def _stmt_has_evidence(self, n: ast.AST) -> bool:
        for c in ast.walk(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(c, ast.Call):
                parts = dotted_parts(c.func)
                if parts is None:
                    continue
                if _is_evidence_call(parts):
                    return True
                t = self.model.resolve(self.info, parts)
                if t is not None and t in self.emits:
                    return True
        return False

    def walk(self) -> None:
        body = self.info.node.body
        if isinstance(body, list):
            self._stmts(body, False)

    def _stmts(self, stmts, flag: bool) -> bool:
        for s in stmts:
            flag = self._stmt(s, flag)
        return flag

    def _stmt(self, s, flag: bool) -> bool:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return flag
        desc = _is_refusal(s)
        if desc is not None:
            if not flag and not self._stmt_has_evidence(s):
                self.findings.append(s)
                self.descs.append(desc)
            return flag
        if isinstance(s, ast.If):
            pre = flag or self._stmt_has_evidence(s.test)
            b = self._stmts(s.body, pre)
            e = self._stmts(s.orelse, pre)
            return b or e
        if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
            b = self._stmts(s.body, flag)
            e = self._stmts(s.orelse, b)
            return e
        if isinstance(s, (ast.With, ast.AsyncWith)):
            pre = flag or any(self._stmt_has_evidence(i.context_expr)
                              for i in s.items)
            return self._stmts(s.body, pre)
        if isinstance(s, ast.Try):
            b = self._stmts(s.body, flag)
            h = flag
            for handler in s.handlers:
                h = self._stmts(handler.body, b) or h
            o = self._stmts(s.orelse, b)
            return self._stmts(s.finalbody, b or h or o)
        return flag or self._stmt_has_evidence(s)


@rule("EVD001",
      "serve/net boundary refusal (raise CausalError, nack, "
      "Admission(False)) on a path that emits no obs event — every "
      "refusal is evidence, or operators debug blind")
def check_evd001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _in_serve_or_net(module):
        return
    emits = getattr(ctx, "_evd_emits", None)
    if emits is None:
        emits = ctx._evd_emits = _emits_evidence(ctx)
    for info in module.funcs.values():
        if _is_dunder_name(info.qualname):
            continue
        w = _RefusalWalker(ctx, info, emits)
        w.walk()
        for node, desc in zip(w.findings, w.descs):
            yield _finding(
                "EVD001", module, node,
                f"{desc} on a serve/net boundary path with no obs "
                "event/counter emitted on the path — refusals that "
                "leave no evidence are undebuggable in production; "
                "emit an obs event under `if obs.enabled():` before "
                "refusing (or suppress with the reason the path is "
                "pre-stream)")


def _is_dunder_name(qualname: str) -> bool:
    n = qualname.split(".")[-1]
    return n.startswith("__") and n.endswith("__")

"""The causelint rule families.

- **TID** — trace-identity soundness. The CAUSE_TPU_* strategy
  switches are read at trace time, so they are program identity:
  every name must be registered (TRACE_SWITCHES or KNOWN_ENV_KNOBS),
  never restated as a literal outside switches.py, and every host-side
  cache of a traced program must fold the switch snapshot into its key
  (a stale program served across a switch flip).
- **JPH** — jit-purity hazards. Host effects inside jit-reachable
  code run at trace time only (or break retracing): env reads, clock
  reads, print, open, ``.item()``, mutation of module-level state.
- **OBS** — obs-off invariance. ``cause_tpu_torch/obs`` must read zero
  TRACE_SWITCHES env vars on any path the disabled mode reaches, and
  traced code may only touch the guarded no-op instrument factories.
- **LCA** — lane-cache aliasing. LaneArena columns are shared by
  every view of a tree; in-place stores outside the arena-owning
  ``lanecache`` module corrupt sibling views silently.

Every rule is a function ``(ctx, module) -> yields Finding`` registered
in :data:`REGISTRY`. Rules receive the cross-module
:class:`~cause_tpu_torch.analysis.callgraph.Program` via ``ctx`` so the
jit-reachability answer is shared, not recomputed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import FrozenSet, Iterator, List, NamedTuple, Optional

from .callgraph import FuncInfo, ModuleInfo, Program, dotted_parts

# imported from the one authority — the module rule this linter
# enforces applies to the linter too
from .switches import KNOWN_ENV_KNOBS, TRACE_SWITCHES

SWITCH_HELPERS = frozenset({"resolve", "raw_key", "raw_switch_key"})
_ENV_READ_ATTRS = frozenset({"get", "pop", "setdefault", "__getitem__"})
_CACHE_DECOS = frozenset({"lru_cache", "cache"})
_OBS_GUARDED = frozenset({"span", "counter", "gauge", "event"})
_OBS_UNGUARDED = frozenset(
    {"flush", "configure", "reset", "counters_snapshot", "events",
     "export_jsonl", "set_platform", "load_jsonl"}
)
ARENA_COLS = frozenset(
    {"ts", "site", "tx", "cause_idx", "vclass", "cause_hi", "cause_lo"}
)
# the arena-owning module: its committed-mutation sites (extend_view's
# in-place append, sync_ranks' rank upgrade) are the whitelist the LCA
# family is defined around
_ARENA_OWNER = "lanecache"


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    @property
    def family(self) -> str:
        return self.rule.rstrip("0123456789")


@dataclass
class RuleSpec:
    rule_id: str
    help: str
    check: object  # callable(ctx, module) -> Iterator[Finding]


REGISTRY: dict = {}

# Bumped whenever rule logic or the rule set changes; the incremental
# cache (core.cached_run) keys on it so a rule-set change invalidates
# every cached verdict even when no analyzed file changed.
RULESET_VERSION = 5  # SHP001 gates the telemetry-ship layer


def rule(rule_id: str, help_text: str):
    def deco(fn):
        REGISTRY[rule_id] = RuleSpec(rule_id, help_text, fn)
        return fn
    return deco


class Context:
    """Shared per-run state handed to every rule."""

    def __init__(self, program: Program):
        self.program = program
        self.reachable = program.reachable()

    def reachable_funcs(self, module: ModuleInfo) -> List[FuncInfo]:
        return [f for fid, f in module.funcs.items()
                if fid in self.reachable]


# --------------------------------------------------------------- utils

def _finding(rule_id: str, module: ModuleInfo, node: ast.AST,
             message: str) -> Finding:
    line = getattr(node, "lineno", 1)
    snippet = (module.lines[line - 1].strip()
               if 0 < line <= len(module.lines) else "")
    return Finding(rule_id, module.path, line,
                   getattr(node, "col_offset", 0), message, snippet)


def _env_read_key(node: ast.Call) -> Optional[ast.expr]:
    """The key expression of an ``os.environ.get/pop/...`` or
    ``os.getenv`` call, else None."""
    parts = dotted_parts(node.func)
    if parts is None:
        return None
    if parts[-1] == "getenv" or (
            len(parts) >= 2 and parts[-2] == "environ"
            and parts[-1] in _ENV_READ_ATTRS):
        return node.args[0] if node.args else None
    return None


def _environ_subscript(node: ast.AST) -> Optional[ast.expr]:
    """``os.environ[KEY]`` (read or write target) -> KEY, else None."""
    if isinstance(node, ast.Subscript):
        parts = dotted_parts(node.value)
        if parts is not None and parts[-1] == "environ":
            return node.slice
    return None


def _iter_env_keys(tree_nodes) -> Iterator[ast.expr]:
    """Every env-var key expression (call-style and subscript-style)
    in an AST node stream."""
    for n in tree_nodes:
        if isinstance(n, ast.Call):
            key = _env_read_key(n)
            if key is not None:
                yield key
        key = _environ_subscript(n)
        if key is not None:
            yield key


def _literal(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_switches_module(module: ModuleInfo) -> bool:
    return module.segments[-1] == "switches"


def _in_obs_package(module: ModuleInfo) -> bool:
    return "obs" in module.segments[:-1] or module.segments[-1] == "obs"


def _docstring_lines(module: ModuleInfo) -> set:
    """Line spans of docstring constants (skipped by literal rules)."""
    out = set()
    if module.tree is None:
        return out
    for n in ast.walk(module.tree):
        if isinstance(n, (ast.Module, ast.FunctionDef,
                          ast.AsyncFunctionDef, ast.ClassDef)):
            body = getattr(n, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                c = body[0].value
                out.update(range(c.lineno, (c.end_lineno or c.lineno) + 1))
    return out


# ----------------------------------------------------------------- TID

@rule("TID001",
      "trace-reachable read of a CAUSE_TPU_* env var that is not a "
      "registered TRACE_SWITCHES member")
def check_tid001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if _is_switches_module(module):
        return
    registered = set(TRACE_SWITCHES) | set(KNOWN_ENV_KNOBS)
    for info in ctx.reachable_funcs(module):
        for key in _iter_env_keys(info.body_nodes()):
            name = _literal(key)
            if (name and name.startswith("CAUSE_TPU_")
                    and name not in registered):
                yield _finding(
                    "TID001", module, key,
                    f"jit-reachable code reads {name!r}, which is in "
                    "neither TRACE_SWITCHES nor KNOWN_ENV_KNOBS — an "
                    "unregistered trace-time config axis never reaches "
                    "program-cache keys (import the registry in "
                    "cause_tpu_torch/analysis/switches.py, never invent "
                    "names)")
    # helper misuse is a hazard anywhere: resolve()/raw_key() on an
    # unknown name silently returns "" forever
    if module.tree is None:
        return
    for n in ast.walk(module.tree):
        if isinstance(n, ast.Call):
            parts = dotted_parts(n.func)
            if (parts is not None and parts[-1] in ("resolve", "raw_key")
                    and n.args):
                name = _literal(n.args[0])
                if (name and name.startswith("CAUSE_TPU_")
                        and name not in TRACE_SWITCHES):
                    yield _finding(
                        "TID001", module, n,
                        f"switch helper called with {name!r}, which is "
                        "not a TRACE_SWITCHES member — the read can "
                        "never be part of program identity")


@rule("TID002",
      "TRACE_SWITCHES name restated as a string literal outside "
      "switches.py (module rule: import, never restate)")
def check_tid002(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if _is_switches_module(module) or module.tree is None:
        return
    doc_lines = _docstring_lines(module)
    # literals passed straight to the switch helpers are the sanctioned
    # read pattern, not a restatement
    helper_args = set()
    for n in ast.walk(module.tree):
        if isinstance(n, ast.Call):
            parts = dotted_parts(n.func)
            if parts is not None and parts[-1] in SWITCH_HELPERS:
                for a in n.args:
                    helper_args.add(id(a))
    for n in ast.walk(module.tree):
        if not isinstance(n, ast.Constant) or not isinstance(n.value, str):
            continue
        if n.lineno in doc_lines or id(n) in helper_args:
            continue
        head = n.value.split("=", 1)[0]
        if head in TRACE_SWITCHES:
            yield _finding(
                "TID002", module, n,
                f"switch name {head!r} restated as a literal — a copy "
                "that drifts from switches.py silently serves/keys a "
                "different program config; import TRACE_SWITCHES / "
                "BESTSTREAM_FLIPS instead (or suppress with a reason "
                "for deliberate A/B flips)")


@rule("TID003",
      "host-side cache of a traced program whose key omits the switch "
      "snapshot (stale-program hazard)")
def check_tid003(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    for fid, info in module.funcs.items():
        node = info.node
        if isinstance(node, ast.Lambda):
            continue
        if not any(
            (dotted_parts(d) or ["?"])[-1] in _CACHE_DECOS
            or (isinstance(d, ast.Call)
                and (dotted_parts(d.func) or ["?"])[-1] in _CACHE_DECOS)
            for d in node.decorator_list
        ):
            continue
        # trace roots lexically inside this cached factory
        inner = [f for f in ctx.program.roots
                 if f.startswith(fid + ".")] + (
            [fid] if fid in ctx.program.roots else [])
        if not inner:
            continue
        traced = ctx.program.reachable_from(inner)
        reads_switches = False
        for tfid in traced:
            tinfo = ctx.program.funcs[tfid]
            for parts, _ln in tinfo.calls:
                if parts[-1] in SWITCH_HELPERS:
                    reads_switches = True
            for key in _iter_env_keys(tinfo.body_nodes()):
                name = _literal(key)
                if name in TRACE_SWITCHES:
                    reads_switches = True
        if not reads_switches:
            continue
        params = {a.arg for a in (
            list(node.args.posonlyargs) + list(node.args.args)
            + list(node.args.kwonlyargs))}
        if "switches" not in params:
            yield _finding(
                "TID003", module, node,
                f"{info.qualname} caches a traced program that reads "
                "TRACE_SWITCHES at trace time, but its cache key has "
                "no `switches` parameter — after a switch flip the "
                "cache serves the program traced under the OLD config "
                "(fold switches.raw_switch_key() into the key)")


# ----------------------------------------------------------------- JPH

_JPH_EXEMPT_LAST_SEG = frozenset({"switches"})


def _jph_applies(module: ModuleInfo) -> bool:
    # switches.py's resolve/raw_key ARE the sanctioned trace-time env
    # readers; the obs package's guard discipline is the OBS family's
    # job (its factories run host-side at trace time by design)
    return (module.segments[-1] not in _JPH_EXEMPT_LAST_SEG
            and not _in_obs_package(module))


@rule("JPH001",
      "direct os.environ access inside jit-reachable code (route "
      "trace-time config through switches.resolve/raw_key)")
def check_jph001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _jph_applies(module):
        return
    for info in ctx.reachable_funcs(module):
        for key in _iter_env_keys(info.body_nodes()):
            name = _literal(key)
            yield _finding(
                "JPH001", module, key,
                "jit-reachable code reads the environment directly"
                + (f" ({name!r})" if name else "")
                + " — the value binds at trace time and never joins "
                "program identity; use switches.resolve()/raw_key() "
                "(registered switches) or hoist the read to host code")


@rule("JPH002",
      "clock read (time.*) inside jit-reachable code")
def check_jph002(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _jph_applies(module):
        return
    for info in ctx.reachable_funcs(module):
        for n in info.body_nodes():
            if isinstance(n, ast.Call):
                parts = dotted_parts(n.func)
                if (parts is not None and len(parts) >= 2
                        and parts[-2] == "time"):
                    yield _finding(
                        "JPH002", module, n,
                        f"time.{parts[-1]}() inside jit-reachable code "
                        "runs once at trace time, not per step — hoist "
                        "to the host caller (obs spans time host-side)")


@rule("JPH003", "print() inside jit-reachable code")
def check_jph003(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _jph_applies(module):
        return
    for info in ctx.reachable_funcs(module):
        for n in info.body_nodes():
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "print"):
                yield _finding(
                    "JPH003", module, n,
                    "print() inside jit-reachable code fires at trace "
                    "time only (silent after the first call) — use "
                    "jax.debug.print or host-side obs events")


@rule("JPH004", "open() inside jit-reachable code")
def check_jph004(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _jph_applies(module):
        return
    for info in ctx.reachable_funcs(module):
        for n in info.body_nodes():
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "open"):
                yield _finding(
                    "JPH004", module, n,
                    "open() inside jit-reachable code is a host file "
                    "effect at trace time — hoist it to the caller")


@rule("JPH005",
      ".item()/float()-on-parameter inside jit-reachable code "
      "(forces a device sync / fails under trace)")
def check_jph005(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _jph_applies(module):
        return
    for info in ctx.reachable_funcs(module):
        params = set()
        if not isinstance(info.node, ast.Lambda):
            args = info.node.args
            params = {a.arg for a in (
                list(args.posonlyargs) + list(args.args)
                + list(args.kwonlyargs))}
        for n in info.body_nodes():
            if not isinstance(n, ast.Call):
                continue
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "item" and not n.args):
                yield _finding(
                    "JPH005", module, n,
                    ".item() on a traced value aborts tracing (or "
                    "blocks on device sync) — keep reductions in the "
                    "program and fetch on the host")
            elif (isinstance(n.func, ast.Name) and n.func.id == "float"
                    and n.args and isinstance(n.args[0], ast.Name)
                    and n.args[0].id in params):
                yield _finding(
                    "JPH005", module, n,
                    "float() on a traced argument aborts tracing — "
                    "use .astype()/jnp casts inside the program")


@rule("JPH006",
      "mutation of module-level state inside jit-reachable code "
      "(trace-time side effect; silently stale on cache hits)")
def check_jph006(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _jph_applies(module):
        return
    module_level = set(module.top_funcs)
    if module.tree is not None:
        for n in module.tree.body:
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        module_level.add(t.id)
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
                if isinstance(n.target, ast.Name):
                    module_level.add(n.target.id)
    mutators = {"append", "add", "update", "setdefault", "pop",
                "clear", "extend", "insert", "popitem"}
    for info in ctx.reachable_funcs(module):
        declared_global = set()
        for n in info.body_nodes():
            if isinstance(n, ast.Global):
                declared_global.update(n.names)
        for n in info.body_nodes():
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if (isinstance(base, ast.Name) and base is not t
                        and base.id in module_level):
                    yield _finding(
                        "JPH006", module, t,
                        f"jit-reachable code mutates module-level "
                        f"{base.id!r} — runs at trace time only, so "
                        "cached executions silently skip it")
                elif isinstance(t, ast.Name) and t.id in declared_global:
                    yield _finding(
                        "JPH006", module, t,
                        f"jit-reachable code rebinds global {t.id!r} "
                        "at trace time only")
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in mutators
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in module_level):
                yield _finding(
                    "JPH006", module, n,
                    f"jit-reachable code calls .{n.func.attr}() on "
                    f"module-level {n.func.value.id!r} — a trace-time "
                    "side effect cached executions skip")


# ----------------------------------------------------------------- OBS

@rule("OBS001",
      "cause_tpu_torch/obs reads a TRACE_SWITCHES env var (obs-off "
      "invariance: disabled mode must add zero identity-adjacent "
      "env reads)")
def check_obs001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if not _in_obs_package(module) or module.tree is None:
        return
    for key in _iter_env_keys(ast.walk(module.tree)):
        name = _literal(key)
        if name is None:
            yield _finding(
                "OBS001", module, key,
                "obs reads an env var through a non-literal key — "
                "causelint cannot prove it is not a TRACE_SWITCHES "
                "member; read via a literal, or suppress with a "
                "reason at the one sanctioned enabled-span snapshot")
        elif name in TRACE_SWITCHES:
            yield _finding(
                "OBS001", module, key,
                f"obs reads trace switch {name!r} — the obs-off "
                "contract is ZERO TRACE_SWITCHES reads (program "
                "identity must not depend on whether obs is on)")


@rule("OBS002",
      "jit-reachable code calls an unguarded obs API (only the no-op "
      "factories span/counter/gauge/event may sit on traced paths)")
def check_obs002(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if _in_obs_package(module):
        return
    for info in ctx.reachable_funcs(module):
        for parts, lineno in info.calls:
            if parts[-1] not in _OBS_UNGUARDED:
                continue
            target = ctx.program.resolve_call(info, parts)
            if target is not None:
                tmod = target.split("::", 1)[0]
                is_obs = "obs" in tmod.split(".")
            else:
                # unresolved: trust the spelling — obs.flush(),
                # _obs_flush(), aliased obs module attributes
                is_obs = (len(parts) >= 2 and "obs" in parts[:-1]) or \
                    parts[0].startswith("_obs")
            if not is_obs:
                continue
            node = ast.Constant(value="")
            node.lineno, node.col_offset = lineno, 0
            yield _finding(
                "OBS002", module, node,
                f"obs.{parts[-1]}() inside jit-reachable code does "
                "unconditional work even with obs disabled — hot "
                "paths route through span()/counter()/gauge()/"
                "event(), which collapse to shared no-ops")


def _is_enabled_name(name: str) -> bool:
    """The sanctioned guard in any of the repo's import spellings:
    ``obs.enabled()``, ``devprof.enabled()``, or the aliased
    ``from ..obs import enabled as _obs_enabled`` style lanecache
    uses — matching only the literal ``enabled`` would flag
    correctly-guarded code the moment an aliasing module becomes
    jit-reachable."""
    return name == "enabled" or name.endswith("_enabled")


def _mentions_enabled(test: ast.expr) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            parts = dotted_parts(n.func)
            if parts and _is_enabled_name(parts[-1]):
                return True
    return False


def _is_not_enabled_exit(s: ast.stmt) -> bool:
    """``if not ...enabled(): return/raise/continue/break`` — the
    early-return guard style; everything after it in the same
    statement list only runs with obs on."""
    return (isinstance(s, ast.If) and not s.orelse
            and isinstance(s.test, ast.UnaryOp)
            and isinstance(s.test.op, ast.Not)
            and _mentions_enabled(s.test.operand)
            and bool(s.body)
            and isinstance(s.body[-1], (ast.Return, ast.Raise,
                                        ast.Continue, ast.Break)))


def _calls_with_guards(info: FuncInfo):
    """(Call node, guarded) pairs over one scope's own statements,
    where ``guarded`` means the call sits inside the body of an
    ``if ...enabled()...:`` test, or after an
    ``if not ...enabled(): return`` early exit in the same statement
    list. Nested function/lambda bodies are their own scopes (they
    get their own FuncInfo)."""

    def walk_stmts(stmts, guarded):
        for s in stmts:
            yield from walk(s, guarded)
            if _is_not_enabled_exit(s):
                guarded = True

    def walk(n, guarded):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return
        if isinstance(n, ast.Call):
            yield n, guarded
        if isinstance(n, ast.If):
            # polarity matters: `if enabled():` guards the BODY,
            # `if not enabled():` guards the ELSE branch — marking
            # both bodies guarded whenever the test mentions enabled()
            # would sanction obs-off-only code and flag the correctly
            # guarded else of a negated test
            if (isinstance(n.test, ast.UnaryOp)
                    and isinstance(n.test.op, ast.Not)
                    and _mentions_enabled(n.test.operand)):
                body_g, else_g = guarded, True
            elif _mentions_enabled(n.test):
                body_g, else_g = True, guarded
            else:
                body_g = else_g = guarded
            yield from walk(n.test, guarded)
            yield from walk_stmts(n.body, body_g)
            yield from walk_stmts(n.orelse, else_g)
            return
        for name, value in ast.iter_fields(n):
            if name in ("body", "orelse", "finalbody") \
                    and isinstance(value, list):
                yield from walk_stmts(value, guarded)
                continue
            for c in (value if isinstance(value, list) else [value]):
                if isinstance(c, ast.AST):
                    yield from walk(c, guarded)

    if isinstance(info.node.body, list):
        yield from walk_stmts(info.node.body, False)
    else:
        yield from walk(info.node.body, False)


# --------------------------------------------- guarded-API rule table
#
# OBS003-007, CHS001, SRV001, NET001 and DSK001 all share one shape:
# a subsystem whose APIs do real host work the moment obs (or chaos)
# is on, matched by distinctive bare names plus module qualifiers,
# excused by the sanctioned ...enabled() guard spellings, and scoped
# away from the subsystem's own package. Only the table rows differ,
# so the rows are data and one checker body serves them all.


class _GuardSpec(NamedTuple):
    rule_id: str
    help: str
    apis: FrozenSet[str]       # distinctive bare names
    quals: FrozenSet[str]      # module-qualifier spellings
    skip: object               # module -> bool, extra exclusions
    guard_desc: str            # "an obs.enabled()" / chaos variant
    work_desc: str             # why the call is real work
    prefix: Optional[str] = None   # message head; None -> dotted path
    sanctioned: FrozenSet[str] = frozenset()


_GUARD_RULES = (
    _GuardSpec(
        "OBS003",
        "devprof API reached from jit-reachable code without an "
        "obs.enabled() guard (device-program telemetry samples live "
        "arrays and AOT-compiles the moment obs is on)",
        frozenset({"profile_program", "program_cost",
                   "sample_device_memory", "arena_footprint"}),
        frozenset({"devprof", "_devprof"}),
        lambda module: False,
        "an obs.enabled()",
        "unlike the no-op span/counter factories, devprof does real "
        "work when obs is on",
        prefix="devprof"),
    _GuardSpec(
        "OBS004",
        "semantic-event/fleet API reached from jit-reachable code "
        "without an obs.enabled() guard (the CRDT-semantic layer "
        "assembles real field dicts and walks weaves/version vectors "
        "the moment obs is on)",
        frozenset({"sync_applied", "sync_full_bag", "sync_rejected",
                   "sync_quarantined", "sync_readmitted",
                   "observe_wave", "session_overflow",
                   "token_headroom", "gc_compacted",
                   "lazy_materialized", "fleet_report"}),
        frozenset({"semantic", "_semantic", "_sem"}),
        lambda module: False,
        "an obs.enabled()",
        "unlike the no-op span/counter factories, the semantic layer "
        "builds event payloads (staleness bookkeeping, weave scans) "
        "when obs is on",
        prefix="semantic"),
    _GuardSpec(
        "OBS005",
        "costmodel API reached from jit-reachable code without an "
        "obs.enabled() guard (the wave cost model takes locks and "
        "assembles dispatch/divergence records the moment obs is on)",
        frozenset({"record_dispatch", "register_program",
                   "note_delta_ops", "note_full_bag", "wave_begin",
                   "wave_abandon", "wave_cost", "costmodel_digest",
                   "cost_vs_divergence", "gap_report"}),
        frozenset({"costmodel", "_costmodel", "_cm"}),
        lambda module: False,
        "an obs.enabled()",
        "unlike the no-op span/counter factories, the cost model "
        "takes registry locks and builds per-wave dispatch records "
        "when obs is on",
        prefix="costmodel"),
    _GuardSpec(
        "OBS006",
        "convergence-lag API reached from jit-reachable code without "
        "an obs.enabled() guard (the lag tracer takes registry locks, "
        "stamps wall clocks and assembles per-op records the moment "
        "obs is on)",
        frozenset({"op_created", "ops_applied", "wave_observed",
                   "level_observed", "pending_ops", "lag_summary",
                   "set_slo"}),
        frozenset({"lag", "_lag"}),
        lambda module: False,
        "an obs.enabled()",
        "unlike the no-op span/counter factories, the lag tracer "
        "reads monotonic clocks and mutates the bounded op registry "
        "when obs is on",
        prefix="lag"),
    # distinctive bare names only: generic verbs (attach/feed/poll/
    # snapshot) are matched through the ``live`` module qualifier, or
    # they would flag every unrelated object with a feed()
    _GuardSpec(
        "OBS007",
        "live-telemetry API reached from jit-reachable code without "
        "an obs.enabled() guard (the live layer folds records, takes "
        "monitor locks and evaluates alert rules the moment obs is "
        "on)",
        frozenset({"LiveMonitor", "LiveFold", "LiveAttachment",
                   "emit_snapshot", "default_rules", "parse_rule"}),
        frozenset({"live", "_live"}),
        lambda module: False,
        "an obs.enabled()",
        "unlike the no-op span/counter factories, the live monitor "
        "drains subscriber queues, folds records and evaluates alert "
        "rules when obs is on",
        prefix="live"),
    # distinctive bare names only: ``hop``/``bind_ops``/``trace_of``
    # are unambiguous; a generic spelling like ``reset`` matches
    # through the ``xtrace`` module qualifier instead
    _GuardSpec(
        "XTR001",
        "cross-process tracing API reached from jit-reachable code "
        "without an obs.enabled() guard (the xtrace layer takes the "
        "span-registry lock, mints span ids and assembles hop/clock "
        "event payloads the moment obs is on)",
        frozenset({"hop", "new_trace", "bind_ops", "trace_of",
                   "traces_of", "wire_context", "continue_from",
                   "clock_sample", "reply_stamp", "last_span"}),
        frozenset({"xtrace", "_xtrace"}),
        lambda module: False,
        "an obs.enabled()",
        "unlike the no-op span/counter factories, the tracer takes "
        "the registry lock, mints span ids and builds hop records "
        "when obs is on",
        prefix="xtrace"),
    # ``run_dispatch``/``is_transient`` are SANCTIONED unguarded —
    # run_dispatch IS the dispatch path (its idle cost is one
    # chaos.enabled() read and a try frame)
    _GuardSpec(
        "CHS001",
        "chaos/recovery API reached from jit-reachable code without a "
        "chaos.enabled()/obs.enabled() guard (fault hooks draw RNG "
        "and take the engine lock; recovery telemetry assembles event "
        "payloads the moment obs is on)",
        frozenset({"mangle_items", "dispatch_fault", "budget_exhaust",
                   "should_crash", "stall_point", "chaos_report",
                   "restore_recorded"}),
        frozenset({"chaos", "_chaos", "recovery", "_recovery"}),
        lambda module: ("chaos" in module.segments
                        or module.segments[-1] == "recovery"),
        "a chaos.enabled()/obs.enabled()",
        "fault hooks advance seeded RNG streams under the engine lock "
        "and recovery telemetry builds event payloads when enabled",
        sanctioned=frozenset({"run_dispatch", "is_transient",
                              "suspended"})),
    # distinctive bare names per subsystem; generic verbs (offer/
    # drain, pump/dial, append/gc) are matched through the module
    # qualifiers instead, or they would flag every unrelated queue,
    # socket helper and list.append in the tree. These layers are
    # HOST work by definition (locks, sockets, fsyncs) — reaching
    # them from jit-reachable code unguarded is a structural smell,
    # not just an overhead one.
    _GuardSpec(
        "SRV001",
        "sync-service API reached from jit-reachable code without an "
        "obs.enabled() guard (the serve layer takes admission-queue "
        "locks, appends to the write-ahead journal and packs/restores "
        "checkpoint-grade state — host lifecycle work that must "
        "never sit on a traced path)",
        frozenset({"IngestQueue", "IngestJournal", "BatchController",
                   "ResidencyManager", "SyncService",
                   # the cross-tenant batch scheduler marshals
                   # heterogeneous window packs and walks per-tenant
                   # frontiers on the host before its one fused
                   # dispatch — same never-on-a-traced-path contract
                   "BatchScheduler", "wave_fleet"}),
        frozenset({"serve", "_serve"}),
        lambda module: "serve" in module.segments,
        "an obs.enabled()",
        "the serve layer takes queue locks, journals admissions and "
        "spills/restores checkpoint packs"),
    _GuardSpec(
        "NET001",
        "network-transport API reached from jit-reachable code "
        "without an obs.enabled() guard (the net layer blocks on "
        "sockets, sleeps out reconnect backoff and takes connection "
        "locks — host transport work that must never sit on a traced "
        "path)",
        frozenset({"NetClient", "ReplicationServer", "FrameStream",
                   "Backoff", "loopback_pair"}),
        frozenset({"net", "_net", "transport", "_transport"}),
        lambda module: "net" in module.segments,
        "an obs.enabled()",
        "the net layer blocks on socket IO, sleeps out backoff "
        "ladders and mutates connection state"),
    _GuardSpec(
        "DSK001",
        "WAL/scrubber API reached from jit-reachable code without an "
        "obs.enabled() guard (the durable-storage layer fsyncs file "
        "descriptors, rotates/retires segment files and walks "
        "segment directories re-checking CRCs — host storage work "
        "that must never sit on a traced path)",
        frozenset({"WriteAheadLog", "open_journal", "scrub_wal",
                   "scrub_checkpoints", "bench_fsync"}),
        frozenset({"wal", "_wal", "scrub", "_scrub"}),
        lambda module: "serve" in module.segments,
        "an obs.enabled()",
        "the durable-storage layer fsyncs descriptors, rotates and "
        "retires segment files and re-checks CRCs over whole "
        "directories"),
    # the telemetry-shipping layer — the exporter spawns a
    # pump thread and dials sockets, the collector binds listeners
    # and appends to a WAL; both are obs-off no-ops ONLY through
    # attach_exporter's subscribe gate, so reaching the classes
    # directly from jit-reachable code must carry the guard
    _GuardSpec(
        "SHP001",
        "telemetry-shipping API reached from jit-reachable code "
        "without an obs.enabled() guard (the ship layer spawns pump "
        "threads, dials collector sockets and buffers records; the "
        "collector binds listeners and appends WAL segments — host "
        "plumbing that must never sit on a traced path)",
        frozenset({"ShipExporter", "CollectorServer",
                   "attach_exporter"}),
        frozenset({"ship", "_ship", "collector", "_collector"}),
        lambda module: False,
        "an obs.enabled()",
        "the shipping layer spawns threads, dials sockets and "
        "persists segments when obs is on",
        prefix="ship"),
)


def _check_guarded_api(spec: _GuardSpec, ctx: Context,
                       module: ModuleInfo) -> Iterator[Finding]:
    if _in_obs_package(module) or spec.skip(module):
        return
    for info in ctx.reachable_funcs(module):
        for call, guarded in _calls_with_guards(info):
            parts = dotted_parts(call.func)
            if parts is None:
                continue
            if _is_enabled_name(parts[-1]) \
                    or parts[-1] in spec.sanctioned:
                # ...enabled() IS the sanctioned guard — flagging it
                # would gate the exact pattern the docs prescribe
                continue
            hit = (parts[-1] in spec.apis
                   or any(q in spec.quals for q in parts[:-1]))
            if hit and not guarded:
                head = (f"{spec.prefix}.{parts[-1]}" if spec.prefix
                        else ".".join(parts))
                yield _finding(
                    spec.rule_id, module, call,
                    f"{head}() on a jit-reachable path without "
                    f"{spec.guard_desc} guard — {spec.work_desc}; "
                    "gate the call (or hoist it off the traced path)")


def _register_guard_rules() -> None:
    for spec in _GUARD_RULES:
        def check(ctx, module, _spec=spec):
            return _check_guarded_api(_spec, ctx, module)
        rule(spec.rule_id, spec.help)(check)


_register_guard_rules()


# ----------------------------------------------------------------- LCA

@rule("LCA001",
      "in-place store into a LaneArena column outside the arena-owning "
      "lanecache module (aliased views share those arrays)")
def check_lca001(ctx: Context, module: ModuleInfo) -> Iterator[Finding]:
    if module.segments[-1] == _ARENA_OWNER or module.tree is None:
        return
    for info in module.funcs.values():
        # names bound from <expr>.arena in this scope (plus parameters
        # conventionally named `arena`)
        aliases = set()
        if not isinstance(info.node, ast.Lambda):
            aliases = {a.arg for a in info.node.args.args
                       if a.arg == "arena"}
        for n in info.body_nodes():
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], (ast.Name, ast.Tuple)):
                tgts = (n.targets[0].elts
                        if isinstance(n.targets[0], ast.Tuple)
                        else [n.targets[0]])
                vals = (n.value.elts
                        if isinstance(n.value, ast.Tuple)
                        and isinstance(n.targets[0], ast.Tuple)
                        and len(n.value.elts) == len(tgts)
                        else [n.value] * len(tgts))
                for t, v in zip(tgts, vals):
                    if (isinstance(t, ast.Name)
                            and isinstance(v, ast.Attribute)
                            and v.attr == "arena"):
                        aliases.add(t.id)
        for n in info.body_nodes():
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, ast.AugAssign):
                targets = [n.target]
            for t in targets:
                if not (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and t.value.attr in ARENA_COLS):
                    continue
                base = t.value.value
                is_arena = (
                    (isinstance(base, ast.Name) and base.id in aliases)
                    or (isinstance(base, ast.Attribute)
                        and base.attr == "arena")
                )
                if is_arena:
                    yield _finding(
                        "LCA001", module, t,
                        f"in-place store into arena column "
                        f"'{t.value.attr}' outside weaver/lanecache — "
                        "every LaneView over this arena aliases that "
                        "array, so sibling tree versions see the "
                        "mutation; copy via _copy_arena/build_view or "
                        "add the site to lanecache's committed-append "
                        "path")


def all_rule_ids() -> List[str]:
    return sorted(REGISTRY)

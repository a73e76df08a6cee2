"""The port's causelint (``cause_tpu_torch.analysis``) against the JAX
package's (``cause_tpu.analysis``).

Every case of ``tests/test_analysis.py`` runs here against the port's
analyser, on the same fixtures in ``tests/analysis_fixtures/``. The
fixtures are written against the reference's switch registry
(``cause_tpu.switches``); the port's own registry
(``cause_tpu_torch/analysis/switches.py``) has no trace switch and lists
only the knobs the port reads. So every fixture case runs with the
port's rule tables set to the reference's values (the ``ref_tables``
fixture in-process, ``RUNNER`` in a subprocess); the cases on the port's
own tree run with its own tables.

Beyond the mirror:
- on every fixture the port's findings equal the reference's in rule,
  relative path, line, column and snippet, and in message once the
  registry's path is mapped and the reference's history tags are
  dropped; the suppressed findings are equal too;
- the port's tree (``cause_tpu_torch/`` and ``chip_smoke.py``) has zero
  findings, every suppression in it carries a reason;
- every ``CAUSE_TPU_*`` variable the port reads is in its registry, and
  every registered knob is read;
- the CLI analyses the port's tree with jax, jaxlib, numpy and torch all
  blocked.

The analyser is AST-only: fixtures are parsed, never imported.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from cause_tpu import switches as ref_switches
from cause_tpu.analysis import core as ref_core
from cause_tpu_torch.analysis import core, report, rules
from cause_tpu_torch.analysis import switches as port_switches

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIX = os.path.join(HERE, "analysis_fixtures")
PORT_TREE = [os.path.join(REPO, "cause_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]

# the port's CLI with its rule tables set to the reference's registry
RUNNER = textwrap.dedent("""\
    import sys
    from cause_tpu.switches import KNOWN_ENV_KNOBS, TRACE_SWITCHES
    from cause_tpu_torch.analysis import rules
    from cause_tpu_torch.analysis.__main__ import main
    rules.TRACE_SWITCHES = TRACE_SWITCHES
    rules.KNOWN_ENV_KNOBS = KNOWN_ENV_KNOBS
    sys.exit(main(sys.argv[1:]))
""")


@pytest.fixture
def ref_tables(monkeypatch):
    """The port's rule tables set to the reference's switch registry,
    which the shared fixtures are written against."""
    monkeypatch.setattr(rules, "TRACE_SWITCHES", ref_switches.TRACE_SWITCHES)
    monkeypatch.setattr(rules, "KNOWN_ENV_KNOBS",
                        ref_switches.KNOWN_ENV_KNOBS)


def run_api(*paths, root=REPO):
    return core.run([os.path.join(FIX, p) if not os.path.isabs(p)
                     and not os.path.exists(p) else p for p in paths],
                    root=root)


def run_cli(*args, cwd=REPO, tables="reference"):
    """The port's CLI in a subprocess: with the reference's rule tables
    (``RUNNER``) for the fixtures, or as a user runs it
    (``tables="port"``)."""
    env = dict(os.environ)
    if os.path.abspath(cwd) != REPO:  # keep both packages importable
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = ([sys.executable, "-c", RUNNER] if tables == "reference"
           else [sys.executable, "-m", "cause_tpu_torch.analysis"])
    return subprocess.run([*cmd, *args], capture_output=True, text=True,
                          cwd=cwd, timeout=120, env=env)


def rules_of(result):
    return sorted({f.rule for f in result.findings})


# ------------------------------------------------------- rule families

def test_tid_bad_fixture(ref_tables):
    res = run_api(os.path.join(FIX, "tid_bad.py"))
    rules_ = rules_of(res)
    assert "TID001" in rules_ and "TID002" in rules_ and "TID003" in rules_
    tid1 = [f for f in res.findings if f.rule == "TID001"]
    # both the traced unregistered read and the helper misuse
    assert len(tid1) == 2
    tid3 = [f for f in res.findings if f.rule == "TID003"]
    assert "make_cached_program" in tid3[0].message


def test_tid_good_fixture_is_clean(ref_tables):
    res = run_api(os.path.join(FIX, "tid_good.py"))
    assert res.findings == []


def test_jph_bad_fixture():
    res = run_api(os.path.join(FIX, "jph_bad.py"))
    rules_ = rules_of(res)
    for expected in ("JPH001", "JPH002", "JPH003", "JPH004", "JPH005",
                     "JPH006"):
        assert expected in rules_, (expected, rules_)
    # float() on a traced parameter is JPH005 too
    jph5 = [f for f in res.findings if f.rule == "JPH005"]
    assert len(jph5) == 2


def test_jph_good_fixture_is_clean():
    res = run_api(os.path.join(FIX, "jph_good.py"))
    assert res.findings == []


def test_obs_bad_fixture(ref_tables):
    res = run_api(os.path.join(FIX, "obs", "obs_bad.py"))
    obs1 = [f for f in res.findings if f.rule == "OBS001"]
    # one literal TRACE_SWITCHES read + one unprovable non-literal key
    assert len(obs1) == 2


def test_obs_good_fixture_is_clean(ref_tables):
    res = run_api(os.path.join(FIX, "obs", "obs_good.py"))
    assert res.findings == []


def test_obs_unguarded_call_on_traced_path():
    res = run_api(os.path.join(FIX, "obs_caller_bad.py"))
    obs2 = [f for f in res.findings if f.rule == "OBS002"]
    # exactly one: flush() flagged, the guarded span() factory is not
    assert len(obs2) == 1
    assert obs2[0].message.startswith("obs.flush()")


def test_devprof_unguarded_call_on_traced_path():
    """OBS003: the plain unguarded call and the body of a negated test;
    every guard spelling is sanctioned."""
    res = run_api(os.path.join(FIX, "devprof_caller_bad.py"))
    obs3 = [f for f in res.findings if f.rule == "OBS003"]
    assert len(obs3) == 2, [f.message for f in obs3]
    assert all("sample_device_memory" in f.message for f in obs3)
    assert rules_of(res) == ["OBS003"]


def test_semantic_unguarded_call_on_traced_path():
    """OBS004: the plain unguarded call and the body of a negated
    test."""
    res = run_api(os.path.join(FIX, "semantic_caller_bad.py"))
    obs4 = [f for f in res.findings if f.rule == "OBS004"]
    assert len(obs4) == 2, [f.message for f in obs4]
    assert "observe_wave" in obs4[0].message
    assert "sync_applied" in obs4[1].message
    assert rules_of(res) == ["OBS004"]


def test_costmodel_unguarded_call_on_traced_path():
    """OBS005: the plain unguarded call and the body of a negated
    test."""
    res = run_api(os.path.join(FIX, "costmodel_caller_bad.py"))
    obs5 = [f for f in res.findings if f.rule == "OBS005"]
    assert len(obs5) == 2, [f.message for f in obs5]
    assert "record_dispatch" in obs5[0].message
    assert "note_full_bag" in obs5[1].message
    assert rules_of(res) == ["OBS005"]


def test_lag_unguarded_call_on_traced_path():
    """OBS006: the plain unguarded call and the body of a negated
    test."""
    res = run_api(os.path.join(FIX, "lag_caller_bad.py"))
    obs6 = [f for f in res.findings if f.rule == "OBS006"]
    assert len(obs6) == 2, [f.message for f in obs6]
    assert "op_created" in obs6[0].message
    assert "level_observed" in obs6[1].message
    assert rules_of(res) == ["OBS006"]


def test_live_unguarded_call_on_traced_path():
    """OBS007: the plain unguarded call, a distinctive bare name, and
    the body of a negated test; generic verbs on non-live objects never
    flag."""
    res = run_api(os.path.join(FIX, "live_caller_bad.py"))
    obs7 = [f for f in res.findings if f.rule == "OBS007"]
    assert len(obs7) == 3, [f.message for f in obs7]
    assert "attach" in obs7[0].message
    assert "LiveMonitor" in obs7[1].message
    assert "attach" in obs7[2].message
    assert rules_of(res) == ["OBS007"]


def test_xtrace_unguarded_call_on_traced_path():
    """XTR001: the plain unguarded hop and a generic verb reached
    through the module qualifier."""
    res = run_api(os.path.join(FIX, "xtrace_caller_bad.py"))
    xtr = [f for f in res.findings if f.rule == "XTR001"]
    assert len(xtr) == 2, [f.message for f in xtr]
    assert "hop" in xtr[0].message
    assert "reset" in xtr[1].message
    assert rules_of(res) == ["XTR001"]


def test_chaos_unguarded_call_on_traced_path():
    """CHS001: two plain unguarded calls and the body of a negated
    test; the ladder's own execution seam is sanctioned."""
    res = run_api(os.path.join(FIX, "chaos_caller_bad.py"))
    chs = [f for f in res.findings if f.rule == "CHS001"]
    assert len(chs) == 3, [f.message for f in chs]
    assert "stall_point" in chs[0].message
    assert "recovery.step" in chs[1].message
    assert "recovery.step" in chs[2].message
    assert rules_of(res) == ["CHS001"]


def test_serve_unguarded_call_on_traced_path():
    """SRV001: the plain unguarded call, a distinctive bare name, and
    the body of a negated test."""
    res = run_api(os.path.join(FIX, "serve_caller_bad.py"))
    srv = [f for f in res.findings if f.rule == "SRV001"]
    assert len(srv) == 3, [f.message for f in srv]
    assert "IngestQueue" in srv[0].message
    assert "SyncService" in srv[1].message
    assert "IngestJournal" in srv[2].message
    assert rules_of(res) == ["SRV001"]


def test_batch_scheduler_unguarded_call_on_traced_path():
    """SRV001 on the batch scheduler: the constructor, a bare name,
    ``wave_fleet`` on an opaque receiver, and the body of a negated
    test."""
    res = run_api(os.path.join(FIX, "batch_caller_bad.py"))
    srv = [f for f in res.findings if f.rule == "SRV001"]
    assert len(srv) == 4, [f.message for f in srv]
    assert "BatchScheduler" in srv[0].message
    assert "BatchScheduler" in srv[1].message
    assert "wave_fleet" in srv[2].message
    assert "BatchScheduler" in srv[3].message
    assert rules_of(res) == ["SRV001"]


def test_net_unguarded_call_on_traced_path():
    """NET001: the module-qualified call, a bare name, and the body of
    a negated test."""
    res = run_api(os.path.join(FIX, "net_caller_bad.py"))
    net = [f for f in res.findings if f.rule == "NET001"]
    assert len(net) == 3, [f.message for f in net]
    assert "net.dial" in net[0].message
    assert "NetClient" in net[1].message
    assert "net.Backoff" in net[2].message
    assert rules_of(res) == ["NET001"]


def test_wal_unguarded_call_on_traced_path():
    """DSK001: the module-qualified call, a bare name, and the body of
    a negated test; no SRV001 shadows."""
    res = run_api(os.path.join(FIX, "wal_caller_bad.py"))
    dsk = [f for f in res.findings if f.rule == "DSK001"]
    assert len(dsk) == 3, [f.message for f in dsk]
    assert "wal.open_journal" in dsk[0].message
    assert "scrub_wal" in dsk[1].message
    assert "wal.open_journal" in dsk[2].message
    assert rules_of(res) == ["DSK001"]


def test_ship_unguarded_call_on_traced_path():
    """SHP001: the module-qualified factory, a bare name, and the
    collector constructor under a local alias."""
    res = run_api(os.path.join(FIX, "ship_caller_bad.py"))
    shp = [f for f in res.findings if f.rule == "SHP001"]
    assert len(shp) == 3, [f.message for f in shp]
    assert "attach_exporter" in shp[0].message
    assert "attach_exporter" in shp[1].message
    assert "CollectorServer" in shp[2].message
    assert rules_of(res) == ["SHP001"]


def test_lck_guard_bad_fixture():
    """LCK001: the lock-free bump of lock-guarded stats."""
    res = run_api(os.path.join(FIX, "lck_guard_bad.py"))
    lck = [f for f in res.findings if f.rule == "LCK001"]
    assert len(lck) == 1, [f.message for f in lck]
    assert "self.stats" in lck[0].message
    assert "BoundaryServer._reject" in lck[0].message
    assert rules_of(res) == ["LCK001"]


def test_lck_watermark_bad_fixture():
    """LCK001: the watermark advanced lock-free after the append."""
    res = run_api(os.path.join(FIX, "lck_watermark_bad.py"))
    lck = [f for f in res.findings if f.rule == "LCK001"]
    assert len(lck) == 1, [f.message for f in lck]
    assert "self._wm" in lck[0].message
    assert "_wm_lock" in lck[0].message
    assert rules_of(res) == ["LCK001"]


def test_lck_order_bad_fixture():
    """LCK002: both edges of the order cycle, plus the reacquisition of
    a non-reentrant Lock through a resolved helper call."""
    res = run_api(os.path.join(FIX, "lck_order_bad.py"))
    lck = [f for f in res.findings if f.rule == "LCK002"]
    assert len(lck) == 3, [f.message for f in lck]
    assert sum("lock-order cycle" in f.message for f in lck) == 2
    reacq = [f for f in lck if "reacquisition" in f.message]
    assert len(reacq) == 1 and "_settle" in reacq[0].message
    assert rules_of(res) == ["LCK002"]


def test_lck_block_bad_fixture():
    """LCK003: a direct os.fsync under the lock and a lock-held call
    into a helper that sleeps."""
    res = run_api(os.path.join(FIX, "lck_block_bad.py"))
    lck = [f for f in res.findings if f.rule == "LCK003"]
    assert len(lck) == 2, [f.message for f in lck]
    assert "fsync" in lck[0].message
    assert "_settle" in lck[1].message and "sleep" in lck[1].message
    assert rules_of(res) == ["LCK003"]


def test_lck_reentrant_bad_fixture():
    """LCK004: both members of the commit cycle flag, naming it."""
    res = run_api(os.path.join(FIX, "lck_reentrant_bad.py"))
    lck = [f for f in res.findings if f.rule == "LCK004"]
    assert len(lck) == 2, [f.message for f in lck]
    assert all("error path" in f.message for f in lck)
    assert all("_seal_locked" in f.message for f in lck)
    assert rules_of(res) == ["LCK004"]


def test_dur_rename_bad_fixture():
    """DUR001/DUR002: the missing tmp fsync before the rename and the
    missing directory fsync after it."""
    res = run_api(os.path.join(FIX, "serve", "dur_rename_bad.py"))
    assert rules_of(res) == ["DUR001", "DUR002"]
    d1 = [f for f in res.findings if f.rule == "DUR001"]
    assert len(d1) == 1 and "torn" in d1[0].message


def test_dur_rename_good_fixture_is_clean():
    res = run_api(os.path.join(FIX, "serve", "dur_rename_good.py"))
    assert res.findings == []


def test_dur_ack_bad_fixture():
    """DUR003: the ack returned before the journal append."""
    res = run_api(os.path.join(FIX, "dur_ack_bad.py"))
    dur = [f for f in res.findings if f.rule == "DUR003"]
    assert len(dur) == 1, [f.message for f in dur]
    assert "journal-before-ack" in dur[0].message
    assert rules_of(res) == ["DUR003"]


def test_dur_crashpoint_bad_fixture():
    """DUR004: a chaos crash seam firing while the lock is held."""
    res = run_api(os.path.join(FIX, "dur_crashpoint_bad.py"))
    dur = [f for f in res.findings if f.rule == "DUR004"]
    assert len(dur) == 1, [f.message for f in dur]
    assert "should_crash" in dur[0].message
    assert rules_of(res) == ["DUR004"]


def test_evd_bad_fixture():
    """EVD001: a serve-boundary raise with no obs evidence."""
    res = run_api(os.path.join(FIX, "serve", "evd_bad.py"))
    evd = [f for f in res.findings if f.rule == "EVD001"]
    assert len(evd) == 1, [f.message for f in evd]
    assert "raise CausalError" in evd[0].message
    assert rules_of(res) == ["EVD001"]


def test_evd_good_fixture_is_clean():
    res = run_api(os.path.join(FIX, "serve", "evd_good.py"))
    assert res.findings == []


def test_lca_bad_fixture():
    res = run_api(os.path.join(FIX, "lca_bad.py"))
    lca = [f for f in res.findings if f.rule == "LCA001"]
    assert len(lca) == 2  # aliased store + direct .arena.col store


def test_lca_good_fixture_is_clean():
    res = run_api(os.path.join(FIX, "lca_good.py"))
    assert res.findings == []


# -------------------------------------------- parity with the reference

FIXTURES = sorted(
    os.path.relpath(os.path.join(d, f), FIX)
    for d, _dirs, files in os.walk(FIX) for f in files
    if f.endswith(".py"))


def port_message(ref_message: str) -> str:
    """The reference's message as the port words it: its registry's
    path, and no history tag."""
    msg = ref_message.replace("cause_tpu/switches.py",
                              "cause_tpu_torch/analysis/switches.py")
    return re.sub(r"\(the PR-\d+ ", "(the ", msg)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixture_findings_equal_the_reference(ref_tables, fixture):
    path = os.path.join(FIX, fixture)
    want = ref_core.run([path], root=REPO)
    got = core.run([path], root=REPO)

    def key(f):
        return (f.rule, f.path, f.line, f.col, f.snippet)

    assert [key(f) for f in got.findings] == [key(f) for f in want.findings]
    assert [f.message for f in got.findings] == [
        port_message(f.message) for f in want.findings]
    assert [key(f) for f in got.suppressed] == [
        key(f) for f in want.suppressed]
    assert got.files == want.files == 1


def test_fixtures_cover_both_subdirectories():
    assert len(FIXTURES) == 33
    assert {os.path.dirname(f) for f in FIXTURES} == {"", "obs", "serve"}


def test_rule_catalog_equals_the_reference():
    assert [r for r, _ in core.list_rules()] == [
        r for r, _ in ref_core.list_rules()]
    from cause_tpu.analysis.rules import RULESET_VERSION as ref_version

    assert rules.RULESET_VERSION == ref_version


# -------------------------------------------------------- suppressions

def test_suppressions_same_line_and_next_line(ref_tables):
    res = run_api(os.path.join(FIX, "suppressed.py"))
    # two real violations neutralized; the wrong-family token does not
    # suppress the TID002 AND is itself reported as a stale
    # suppression (GEN002) on the full-rule run
    assert len(res.suppressed) == 2
    assert rules_of(res) == ["GEN002", "TID002"]
    tid = [f for f in res.findings if f.rule == "TID002"]
    assert "CAUSE_TPU_SEARCH" in tid[0].snippet


def test_unused_suppression_only_reported_on_full_runs(ref_tables):
    res = core.run([os.path.join(FIX, "suppressed.py")], root=REPO,
                   rule_ids=["TID002"])
    # under a rule subset, "unused" just means "rule not run"
    assert rules_of(res) == ["TID002"]


def test_suppression_inside_string_is_inert(ref_tables, tmp_path):
    # the suppression-syntax EXAMPLE inside the string literal sits on
    # the line right above the real violation: only real comments count
    mod = tmp_path / "mod.py"
    mod.write_text(
        'DOC = """example:\n'
        '# causelint: disable-next-line=TID002 -- just an example\n'
        '"""; FLIP = {"CAUSE_TPU_SORT": "matrix"}\n'
    )
    res = core.run([str(mod)], root=str(tmp_path))
    assert rules_of(res) == ["TID002"]
    assert res.suppressed == []


def test_suppression_parser():
    supps = core.parse_suppressions([
        'x = 1  # causelint: disable=TID002 -- why not',
        '# causelint: disable-next-line=JPH001,JPH002',
        'y = 2',
    ])
    assert supps[1][0].tokens == {"TID002"}
    assert supps[1][0].reason == "why not"
    assert supps[3][0].tokens == {"JPH001", "JPH002"}


# -------------------------------------------------- reachability depth

def test_transitive_reachability(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""\
        import os
        import jax

        def helper(x):
            return os.environ.get("HELPER_VAR", "")

        @jax.jit
        def traced(x):
            return helper(x)

        def host_only(x):
            return os.environ.get("HOST_VAR", "")
    """))
    res = core.run([str(tmp_path / "mod.py")], root=str(tmp_path))
    jph1 = [f for f in res.findings if f.rule == "JPH001"]
    assert len(jph1) == 1
    assert "HELPER_VAR" in jph1[0].message  # flagged through the call
    assert not any("HOST_VAR" in f.message for f in res.findings)


# ------------------------------------------------------ JSON reporter

def test_json_reporter_schema():
    out = run_cli(os.path.join(FIX, "jph_bad.py"), "--format", "json")
    assert out.returncode == 1
    data = json.loads(out.stdout)
    for key in ("version", "tool", "files", "total", "suppressed",
                "baseline_filtered", "counts", "findings"):
        assert key in data, key
    assert data["tool"] == "causelint" and data["version"] == 1
    assert data["total"] == len(data["findings"]) > 0
    assert sum(data["counts"].values()) == data["total"]
    for f in data["findings"]:
        for key in ("rule", "family", "path", "line", "col", "message",
                    "snippet", "fingerprint"):
            assert key in f, key
        assert f["rule"].startswith(f["family"])


# ------------------------------------------------------- CLI contract

def test_cli_exit_codes():
    assert run_cli(os.path.join(FIX, "tid_bad.py")).returncode == 1
    assert run_cli(os.path.join(FIX, "tid_good.py")).returncode == 0
    assert run_cli("/nonexistent/nope.py").returncode == 2
    assert run_cli(".", "--rules", "NOT_A_RULE").returncode == 2


@pytest.mark.parametrize("fixture", [
    "tid_bad.py", "jph_bad.py", os.path.join("obs", "obs_bad.py"),
    "obs_caller_bad.py", "devprof_caller_bad.py",
    "semantic_caller_bad.py", "costmodel_caller_bad.py",
    "lag_caller_bad.py", "live_caller_bad.py",
    "xtrace_caller_bad.py",
    "chaos_caller_bad.py", "serve_caller_bad.py",
    "batch_caller_bad.py", "net_caller_bad.py",
    "wal_caller_bad.py", "ship_caller_bad.py", "lca_bad.py",
    "lck_guard_bad.py", "lck_watermark_bad.py", "lck_order_bad.py",
    "lck_block_bad.py", "lck_reentrant_bad.py", "dur_ack_bad.py",
    "dur_crashpoint_bad.py",
    os.path.join("serve", "dur_rename_bad.py"),
    os.path.join("serve", "evd_bad.py"),
])
def test_cli_gates_each_known_bad_fixture(fixture):
    assert run_cli(os.path.join(FIX, fixture)).returncode == 1


def test_cli_list_rules():
    out = run_cli("--list-rules", tables="port")
    assert out.returncode == 0
    for rid in ("TID001", "TID002", "TID003", "JPH001", "JPH006",
                "OBS001", "OBS002", "OBS003", "OBS004", "OBS005",
                "OBS006", "OBS007", "XTR001", "CHS001", "SRV001",
                "NET001",
                "DSK001", "SHP001", "LCA001", "GEN001", "LCK001",
                "LCK002",
                "LCK003", "LCK004", "DUR001", "DUR002", "DUR003",
                "DUR004", "EVD001"):
        assert rid in out.stdout


def test_cli_works_without_jax_numpy_or_torch(tmp_path):
    """The lint runs from a bare checkout: block jax, jaxlib, numpy AND
    torch outright and the CLI must still analyse the port's tree."""
    script = tmp_path / "blocked.py"
    script.write_text(textwrap.dedent("""\
        import os
        import sys

        sys.path.insert(0, os.getcwd())

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "numpy",
                                          "torch"):
                    raise ImportError("BLOCKED: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        sys.argv = ["causelint", "cause_tpu_torch", "chip_smoke.py"]
        import runpy
        runpy.run_module("cause_tpu_torch.analysis", run_name="__main__")
    """))
    out = subprocess.run([sys.executable, str(script)],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "0 finding(s)" in out.stdout


def test_cli_defaults_to_the_port_tree():
    """With no paths the CLI analyses ``cause_tpu_torch/`` and
    ``chip_smoke.py``, and the port's tree is clean."""
    out = run_cli(tables="port")
    assert out.returncode == 0, out.stdout + out.stderr
    n_files = len(core.collect_files(PORT_TREE))
    assert f"0 finding(s) in {n_files} file(s)" in out.stdout


# --------------------------------------------- incremental cache mode

def _write_flagged(path):
    """A module with one deterministic, file-local finding (GEN001)."""
    path.write_text("def broken(:\n")


def test_cache_warm_hit_replays_without_reanalyzing(tmp_path):
    mod = tmp_path / "mod.py"
    cache = tmp_path / "cache.json"
    _write_flagged(mod)
    first = core.cached_run([str(mod)], root=str(tmp_path),
                            cache_path=str(cache))
    assert rules_of(first) == ["GEN001"]
    # a warm hit replays the (tampered) payload verbatim, proving the
    # second run never re-analysed the file
    payload = json.loads(cache.read_text())
    payload["findings"][0][4] = "TAMPERED-SENTINEL"
    cache.write_text(json.dumps(payload))
    second = core.cached_run([str(mod)], root=str(tmp_path),
                             cache_path=str(cache))
    assert second.findings[0].message == "TAMPERED-SENTINEL"


def test_cache_invalidates_on_content_change(tmp_path):
    mod = tmp_path / "mod.py"
    cache = tmp_path / "cache.json"
    _write_flagged(mod)
    assert core.cached_run([str(mod)], root=str(tmp_path),
                           cache_path=str(cache)).exit_code == 1
    mod.write_text("def fixed():\n    return 1\n")
    res = core.cached_run([str(mod)], root=str(tmp_path),
                          cache_path=str(cache))
    assert res.findings == [] and res.exit_code == 0
    # and the cache now records the clean verdict for the new hash
    assert json.loads(cache.read_text())["findings"] == []


def test_cache_invalidates_on_ruleset_version_bump(tmp_path):
    mod = tmp_path / "mod.py"
    cache = tmp_path / "cache.json"
    _write_flagged(mod)
    core.cached_run([str(mod)], root=str(tmp_path),
                    cache_path=str(cache))
    # a cache written by an older analyser: same hashes, stale rule-set
    # version, poisoned verdict
    payload = json.loads(cache.read_text())
    payload["ruleset"] = payload["ruleset"] - 1
    payload["findings"] = []
    cache.write_text(json.dumps(payload))
    res = core.cached_run([str(mod)], root=str(tmp_path),
                          cache_path=str(cache))
    assert rules_of(res) == ["GEN001"]  # re-analysed, not replayed
    refreshed = json.loads(cache.read_text())
    assert refreshed["ruleset"] == rules.RULESET_VERSION


def test_cache_keyed_on_rule_selection(tmp_path):
    mod = tmp_path / "mod.py"
    cache = tmp_path / "cache.json"
    _write_flagged(mod)
    full = core.cached_run([str(mod)], root=str(tmp_path),
                           cache_path=str(cache))
    assert rules_of(full) == ["GEN001"]
    # poison the full-run verdict: another rule selection keys
    # differently, so it must re-analyse instead of replaying this
    payload = json.loads(cache.read_text())
    payload["findings"][0][4] = "TAMPERED-SENTINEL"
    cache.write_text(json.dumps(payload))
    sub = core.cached_run([str(mod)], root=str(tmp_path),
                          rule_ids=["TID001"], cache_path=str(cache))
    assert sub.findings and sub.findings[0].message != "TAMPERED-SENTINEL"


def test_corrupt_cache_falls_back_to_analysis(tmp_path):
    mod = tmp_path / "mod.py"
    cache = tmp_path / "cache.json"
    _write_flagged(mod)
    cache.write_text("{not json")
    res = core.cached_run([str(mod)], root=str(tmp_path),
                          cache_path=str(cache))
    assert rules_of(res) == ["GEN001"]


def _git(cwd, *args):
    out = subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        capture_output=True, text=True, cwd=cwd, timeout=60)
    assert out.returncode == 0, out.stderr
    return out


def test_changed_mode_reports_only_diffed_files(tmp_path):
    _write_flagged(tmp_path / "a.py")
    _write_flagged(tmp_path / "b.py")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "seed")

    # nothing changed yet: fast exit 0, even though both files have
    # findings a full run would gate on
    out = run_cli("--changed", "HEAD", ".", cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "no analyzed files changed" in out.stdout

    # touch b.py (still flagged) and add an untracked c.py: both are
    # reported, the unchanged a.py is filtered from the report
    (tmp_path / "b.py").write_text("def broken(:  # still\n")
    _write_flagged(tmp_path / "c.py")
    out = run_cli("--changed", "HEAD", "--format", "json", ".",
                  cwd=str(tmp_path))
    assert out.returncode == 1
    data = json.loads(out.stdout)
    flagged = sorted(os.path.basename(f["path"])
                     for f in data["findings"])
    assert flagged == ["b.py", "c.py"]


def test_changed_mode_with_bad_ref_runs_full(tmp_path):
    _write_flagged(tmp_path / "a.py")
    _git(tmp_path, "init", "-q")
    out = run_cli("--changed", "no-such-ref", ".", cwd=str(tmp_path))
    assert out.returncode == 1
    assert "running the full analysis" in out.stderr


# ----------------------------------------------------------- baseline

def test_baseline_freezes_existing_findings_only(tmp_path):
    mod = tmp_path / "mod.py"
    base = tmp_path / "base.json"
    with open(os.path.join(FIX, "tid_bad.py")) as f:
        mod.write_text(f.read())
    wrote = run_cli(str(mod), "--write-baseline", str(base))
    assert wrote.returncode == 0
    frozen = json.loads(base.read_text())
    assert frozen["fingerprints"]
    # frozen findings no longer gate
    assert run_cli(str(mod), "--baseline", str(base)).returncode == 0
    # a NEW violation still does (and line shifts don't unfreeze)
    mod.write_text("X_NEW = 0\n" + mod.read_text()
                   + '\nNEW = {"CAUSE_TPU_SCATTER": "hint"}\n')
    out = run_cli(str(mod), "--baseline", str(base))
    assert out.returncode == 1
    assert "CAUSE_TPU_SCATTER" in out.stdout
    assert out.stdout.count(": TID") == 1  # only the new one


def test_missing_baseline_is_empty(tmp_path):
    fps = report.load_baseline(str(tmp_path / "absent.json"))
    assert fps == set()


def test_rules_gen_only_runs_no_family_rules():
    """--rules GEN001 selects the core's parse check alone — it must
    NOT silently expand to every rule (empty selection != full run)."""
    out = run_cli(os.path.join(FIX, "tid_bad.py"), "--rules", "GEN001")
    assert out.returncode == 0, out.stdout
    assert "TID" not in out.stdout


def test_duplicate_lines_get_distinct_fingerprints(tmp_path):
    """Freezing one occurrence of a flagged line must not baseline a
    LATER identical copy of it: duplicates carry an occurrence index."""
    mod = tmp_path / "mod.py"
    base = tmp_path / "base.json"
    line = 'F = {"CAUSE_TPU_SORT": "matrix"}\n'
    mod.write_text(line)
    assert run_cli(str(mod), "--write-baseline",
                   str(base)).returncode == 0
    assert run_cli(str(mod), "--baseline", str(base)).returncode == 0
    mod.write_text(line + line)  # a new identical violation
    out = run_cli(str(mod), "--baseline", str(base))
    assert out.returncode == 1
    assert out.stdout.count("TID002") == 1  # only the new copy gates


# -------------------------------------------- the port's own tree

def test_shipped_tree_has_zero_findings():
    """The port's tree is clean under its own registry, and every
    intentional exception carries a suppression with a reason: the
    init-lock builds (nvcc, the native weaver), the WAL's close fsync
    and gc seam, residency's caller-fsynced dir swaps and the pre-stream
    restore raise."""
    res = core.run(PORT_TREE, root=REPO)
    assert res.findings == [], [
        f"{f.path}:{f.line} {f.rule} {f.message}" for f in res.findings]
    assert len(res.suppressed) >= 7
    for path in core.collect_files(PORT_TREE):
        with open(path) as f:
            lines = f.read().splitlines()
        for line, supps in core.parse_suppressions(lines).items():
            for s in supps:
                assert s.reason.strip(), f"{path}:{line} has no reason"


def test_port_registry_has_no_trace_switch():
    """The port traces no program: no variable is program identity,
    and the registry is the module the TID/JPH rules exempt by name."""
    assert port_switches.TRACE_SWITCHES == ()
    assert rules.TRACE_SWITCHES is port_switches.TRACE_SWITCHES
    assert rules.KNOWN_ENV_KNOBS is port_switches.KNOWN_ENV_KNOBS
    assert port_switches.__name__.rsplit(".", 1)[-1] == "switches"


def _env_names(paths):
    names = {}
    for path in core.collect_files(paths):
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for key in rules._iter_env_keys(ast.walk(tree)):
            name = rules._literal(key)
            if name and name.startswith("CAUSE_TPU_"):
                names.setdefault(name, []).append(
                    f"{os.path.relpath(path, REPO)}:{key.lineno}")
    return names


def test_every_env_knob_the_port_reads_is_registered():
    """Every ``CAUSE_TPU_*`` variable the port reads (or sets for a
    child process) is in its registry, and every registered knob is
    one the port reads: the registry is neither short nor padded."""
    names = _env_names(PORT_TREE)
    assert set(names) <= set(port_switches.KNOWN_ENV_KNOBS), {
        n: w for n, w in names.items()
        if n not in port_switches.KNOWN_ENV_KNOBS}
    assert set(port_switches.KNOWN_ENV_KNOBS) == set(names)
    assert len(set(port_switches.KNOWN_ENV_KNOBS)) == len(
        port_switches.KNOWN_ENV_KNOBS)


def test_env_scan_finds_each_read_form(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(textwrap.dedent("""\
        import os
        a = os.environ.get("CAUSE_TPU_A", "")
        b = os.environ["CAUSE_TPU_B"]
        c = os.getenv("CAUSE_TPU_C")
        os.environ["CAUSE_TPU_D"] = "1"
        e = os.environ.get("OTHER", "")
    """))
    assert sorted(_env_names([str(mod)])) == [
        "CAUSE_TPU_A", "CAUSE_TPU_B", "CAUSE_TPU_C", "CAUSE_TPU_D"]


def test_analysis_modules_import_only_the_standard_library():
    """The analyser's own modules import nothing beyond the standard
    library and each other: the lint runs where nothing is installed."""
    pkg = os.path.join(REPO, "cause_tpu_torch", "analysis")
    stdlib = sys.stdlib_module_names
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(pkg, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in stdlib | {"__future__"}, (name, m)

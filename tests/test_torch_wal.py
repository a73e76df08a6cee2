"""The port's segmented write-ahead log and scrubber against the JAX
package's.

Mirrors ``tests/test_wal.py``: each scenario runs in both packages
(``test_torch_serve.both``) and returns what it observed — seqs,
``skipped``/``corrupt`` counts, stats, GC reports, scrub reports, the
records themselves and, where the stamps are fixed, the segment bytes;
the port's record must equal the reference's. The chaos ``disk`` plans
are armed in each package's own engine. The telemetry halves
(``serve.disk``/``serve.shed`` events) and the two telemetry-only cases
(``test_live_fold_disk_axes_and_default_rules``,
``test_prometheus_exports_disk_metrics``) wait for the telemetry port
(ROADMAP A.13).
"""

import json
import os

import pytest

from test_torch_serve import (PORT, REF, _fresh_state, both,  # noqa: F401
                              payload)


def _arm(P, faults, seed=7):
    P.chaos.configure(plan={"seed": seed, "faults": faults})


def _fill(w, n, start=0, uuid="doc1", site="siteA", ts=None):
    for i in range(n):
        w.append(uuid, site, [{"k": start + i}],
                 ts_us=None if ts is None else ts + i)


def _segs(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".seg"))


def _recs(w, seq=0):
    """Records above ``seq`` without their wall-clock stamps."""
    return [{k: v for k, v in e.items() if k != "ts_us"}
            for e in w.iter_from(seq)]


# ---------------------------------------------------------------- codec


def test_record_codec_roundtrip_and_classification():
    def scen(P):
        rec = {"seq": 3, "uuid": "u", "site": "s",
               "items": [{"a": "b\tc"}], "ts_us": 1}
        line = P.wal.encode_record(rec)
        kind, e = P.wal.decode_line(line)
        assert kind == "rec" and e == rec
        kind, e = P.wal.decode_line(json.dumps(rec) + "\n")
        assert kind == "legacy" and e == rec
        bad = line.replace('"seq": 3', '"seq": 7')
        assert P.wal.decode_line(bad)[0] == "corrupt"
        assert P.wal.decode_line(line[: len(line) // 2])[0] == "torn"
        assert P.wal.decode_line("   \n")[0] == "blank"
        return line, [P.wal.decode_line(x)[0]
                      for x in (line, bad, line[:9], "  \n")]

    both(scen)


# ----------------------------------------------------- journal contract


def test_wal_roundtrip_seq_resume_and_iter_from(tmp_path):
    def scen(P, root):
        p = str(root / "wal")
        w = P.WriteAheadLog(p, fsync="none")
        assert w.append("u1", "sA", [{"k": 0}], ts_us=5) == 1
        assert w.append("u2", "sB", [{"k": 1}], ts_us=6) == 2
        w.close()
        w2 = P.open_journal(p)
        assert isinstance(w2, P.WriteAheadLog)
        assert w2.append("u1", "sA", [{"k": 2}], ts_us=7) == 3
        got = list(w2.iter_from(1))
        assert [e["seq"] for e in got] == [2, 3]
        assert got[0]["uuid"] == "u2" and got[0]["site"] == "sB"
        assert got[0]["items"] == [{"k": 1}]
        assert w2.skipped == 0 and w2.corrupt == 0
        w2.close()
        return got, [(n, open(os.path.join(p, n), "rb").read())
                     for n in _segs(p)]

    both(scen, tmp_path)


def test_open_journal_routes_legacy_file_to_ingest_journal(tmp_path):
    def scen(P, root):
        fp = str(root / "wal.jsonl")
        j = P.IngestJournal(fp)
        j.append("u", "s", [{"k": 1}], ts_us=3)
        j.close()
        j2 = P.open_journal(fp)
        assert isinstance(j2, P.IngestJournal) and j2.path == fp
        got = list(j2.iter_from(0))
        assert [e["seq"] for e in got] == [1]
        j2.close()
        return got

    both(scen, tmp_path)


def test_crc_detects_bit_rot_on_disk(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), fsync="none")
        _fill(w, 4)
        w.close()
        seg = os.path.join(w.path, "wal-00000001.seg")
        data = bytearray(open(seg, "rb").read())
        data[10] ^= 0x04
        open(seg, "wb").write(bytes(data))
        w2 = P.WriteAheadLog(str(root / "wal"), fsync="none")
        seqs = [e["seq"] for e in w2.iter_from(0)]
        assert seqs == [2, 3, 4]
        assert w2.corrupt == 1 and w2.skipped == 0
        w2.close()
        return seqs, w2.corrupt, w2.skipped

    both(scen, tmp_path)


# ------------------------------------------------------------- rotation


def test_rotation_by_size_and_age(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=150,
                            fsync="none")
        _fill(w, 6, ts=100)
        segs = _segs(w.path)
        assert len(segs) >= 3
        assert [e["seq"] for e in w.iter_from(0)] == list(range(1, 7))
        blobs = [open(os.path.join(w.path, n), "rb").read() for n in segs]
        w.close()
        w2 = P.WriteAheadLog(str(root / "wal2"), rotate_s=0.0,
                             fsync="none")
        _fill(w2, 3)
        segs2 = _segs(w2.path)
        assert len(segs2) == 3 and w2.stats["rotations"] == 2
        w2.close()
        return segs, blobs, segs2, w.stats["rotations"]

    both(scen, tmp_path)


# ------------------------------------------------------------------- GC


def test_gc_retires_below_watermark_and_replay_is_identical(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=120,
                            fsync="none")
        _fill(w, 10)
        before = list(w.iter_from(4))
        rep = w.gc(4)
        assert rep["retired"] >= 1 and not rep["aborted"]
        assert list(w.iter_from(4)) == before
        assert [e["seq"] for e in w.iter_from(4)] == [5, 6, 7, 8, 9, 10]
        m = json.load(open(os.path.join(w.path, "wal_manifest.json")))
        assert m["gc_watermark"] == 4 and m["~wal_manifest"] == 1
        w.close()
        rep = {k: v for k, v in rep.items() if k != "ms"}
        m = {k: v for k, v in m.items() if not k.startswith("ts")}
        return rep, m, _segs(w.path)

    both(scen, tmp_path)


def test_gc_of_everything_still_resumes_seq(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=60,
                            fsync="none")
        _fill(w, 5)
        w._rotate_locked()
        w.gc(5)
        assert list(w.iter_from(0)) == []
        w.close()
        w2 = P.WriteAheadLog(str(root / "wal"), fsync="none")
        seq = w2.append("u", "s", [{"k": 9}])
        assert seq == 6
        w2.close()
        return seq

    both(scen, tmp_path)


def test_gc_retire_dir_archives_instead_of_unlinking(tmp_path):
    def scen(P, root):
        retired = str(root / "retired")
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=60,
                            fsync="none", retire_dir=retired)
        _fill(w, 6)
        w.gc(3)
        archived = sorted(os.listdir(retired))
        assert archived
        seqs = []
        for name in archived:
            for kind, e in P.wal.scan_segment_file(
                    os.path.join(retired, name)):
                assert kind == "rec"
                seqs.append(e["seq"])
        assert seqs == sorted(seqs) and max(seqs) <= 3
        w.close()
        return archived, seqs

    both(scen, tmp_path)


def test_dir_bytes_bounded_across_gc_cycles(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=200,
                            fsync="none")
        sizes = []
        for cycle in range(3):
            _fill(w, 20, start=cycle * 20, ts=1000)
            w.gc(w._seq)
            sizes.append(w.dir_bytes())
        assert w.appended_bytes > max(sizes) * 2
        assert max(sizes) <= min(sizes) * 3
        w.close()
        return sizes, w.appended_bytes

    both(scen, tmp_path)


# ---------------------------------------------------------------- fsync


def _count_fsyncs(monkeypatch):
    calls = {"n": 0}
    real = os.fsync

    def counted(fd):
        calls["n"] += 1
        return real(fd)

    monkeypatch.setattr(os, "fsync", counted)
    return calls


def test_fsync_policy_none_batch_always(tmp_path, monkeypatch):
    calls = _count_fsyncs(monkeypatch)

    def scen(P, root):
        counts = []
        calls["n"] = 0
        w = P.WriteAheadLog(str(root / "a"), fsync="none")
        _fill(w, 10)
        w.close()
        counts.append(calls["n"])
        assert calls["n"] == 0
        calls["n"] = 0
        w = P.WriteAheadLog(str(root / "b"), fsync="always")
        _fill(w, 10)
        counts.append(calls["n"])
        assert calls["n"] == 10
        w.close()
        calls["n"] = 0
        w = P.WriteAheadLog(str(root / "c"), fsync="batch",
                            fsync_batch_n=4, fsync_batch_ms=1e9)
        _fill(w, 10)
        counts.append(calls["n"])
        assert calls["n"] == 2
        w.close()
        counts.append(calls["n"])
        assert calls["n"] == 3
        return counts

    both(scen, tmp_path)


def test_fsync_env_knob_and_bad_policy(tmp_path, monkeypatch):
    monkeypatch.setenv("CAUSE_TPU_WAL_FSYNC", "always")

    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"))
        assert w.fsync_policy == "always"
        w.close()
        with pytest.raises(ValueError):
            P.WriteAheadLog(str(root / "wal2"), fsync="sometimes")
        return w.fsync_policy, sorted(P.wal.FSYNC_POLICIES)

    both(scen, tmp_path)


def test_bench_fsync_reports_all_policies(tmp_path):
    def scen(P, root):
        rep = P.scrub.bench_fsync(n=50, tmp_dir=str(root))
        assert set(rep) == {"none", "batch", "always"}
        for r in rep.values():
            assert r["n"] == 50 and r["us_per_append"] > 0
        assert rep["none"]["fsyncs"] == 0
        assert rep["always"]["fsyncs"] == 50
        return {k: (v["n"], v["fsyncs"]) for k, v in rep.items()}

    both(scen, tmp_path)


# --------------------------------------------------- disk chaos family


def test_chaos_off_invariance(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), fsync="none")
        _fill(w, 20)
        assert w.stats["append_failures"] == 0
        assert list(P.chaos.injected()) == []
        w.close()
        return w.stats["appends"]

    both(scen, tmp_path)


def test_enospc_refuses_append_via_durability_rung(tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "disk", "site": "serve.wal",
                  "mode": "enospc", "at": [2]}])
        w = P.WriteAheadLog(str(root / "wal"), fsync="none")
        q = P.IngestQueue(max_ops=64, journal=w)
        items = payload(P, 2)
        out = [q.offer("doc1", "siteA", items)]
        assert out[0].admitted
        out.append(q.offer("doc1", "siteA", items))
        assert not out[1].admitted and out[1].rung == "durability"
        assert out[1].reason == "wal-enospc"
        assert out[1].retry_after_ms > 0
        assert q.stats["shed_by_rung"]["durability"] == 1
        assert w.stats["append_failures"] == 1
        out.append(q.offer("doc1", "siteA", items))
        assert out[2].admitted
        seqs = [e["seq"] for e in w.iter_from(0)]
        assert seqs == [1, 2]
        w.close()
        return ([(a.admitted, a.seq, a.rung, a.reason) for a in out],
                q.stats, w.stats["append_failures"], seqs,
                [r["mode"] for r in P.chaos.injected()])

    both(scen, tmp_path)


def test_torn_write_refuses_and_next_scan_counts_the_tear(tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "disk", "site": "serve.wal", "mode": "torn",
                  "at": [2]}])
        w = P.WriteAheadLog(str(root / "wal"), fsync="none")
        w.append("u", "s", [{"k": 0}], ts_us=1)
        with pytest.raises(P.CausalError) as ei:
            w.append("u", "s", [{"k": 1}], ts_us=2)
        assert "wal-torn" in ei.value.info["causes"]
        assert w.append("u", "s", [{"k": 2}], ts_us=3) == 2
        seqs = [e["seq"] for e in w.iter_from(0)]
        assert seqs == [1, 2]
        assert w.skipped == 1 and w.corrupt == 0
        w.close()
        return seqs, open(os.path.join(w.path, _segs(w.path)[0]),
                          "rb").read()

    both(scen, tmp_path)


def test_bitrot_acks_but_scan_detects_and_oracle_reads_chaos_log(
        tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "disk", "site": "serve.wal",
                  "mode": "bitrot", "at": [2]}])
        w = P.WriteAheadLog(str(root / "wal"), fsync="none")
        w.append("u", "s", [{"k": 0}], ts_us=1)
        assert w.append("u", "s", [{"k": 1}], ts_us=2) == 2
        w.append("u", "s", [{"k": 2}], ts_us=3)
        seqs = [e["seq"] for e in w.iter_from(0)]
        assert seqs == [1, 3]
        assert w.corrupt == 1 and w.skipped == 0
        rots = [r for r in P.chaos.injected() if r["mode"] == "bitrot"]
        assert len(rots) == 1
        assert rots[0]["rec"]["seq"] == 2
        assert rots[0]["rec"]["items"] == [{"k": 1}]
        w.close()
        return seqs, rots[0]["rec"], rots[0].get("index"), open(
            os.path.join(w.path, _segs(w.path)[0]), "rb").read()

    both(scen, tmp_path)


def test_fsync_failure_rotates_with_evidence(tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "disk", "site": "serve.wal", "mode": "fsync",
                  "at": [1]}])
        w = P.WriteAheadLog(str(root / "wal"), fsync="always")
        w.append("u", "s", [{"k": 0}])
        w.append("u", "s", [{"k": 1}])
        assert w.stats["fsync_failures"] == 1
        assert w.stats["rotations"] == 1
        seqs = [e["seq"] for e in w.iter_from(0)]
        assert seqs == [1, 2]
        w.close()
        return seqs, w.stats["fsync_failures"], _segs(w.path)

    both(scen, tmp_path)


def test_fsync_failure_during_rotation_replays_exactly_once(tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "disk", "site": "serve.wal", "mode": "fsync",
                  "at": [1]}])
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=60,
                            fsync="batch", fsync_batch_n=10_000,
                            fsync_batch_ms=1e9)
        _fill(w, 6)
        assert w.stats["fsync_failures"] == 1
        index_names = [sg["name"] for sg in w._index]
        assert len(index_names) == len(set(index_names))
        segs = _segs(w.path)
        assert sorted(index_names + [w._active["name"]]) == segs
        seqs = [e["seq"] for e in w.iter_from(0)]
        assert seqs == [1, 2, 3, 4, 5, 6]
        w.close()
        w2 = P.WriteAheadLog(str(root / "wal"), fsync="none")
        assert [e["seq"] for e in w2.iter_from(0)] == seqs
        w2.close()
        return index_names, segs, seqs

    both(scen, tmp_path)


def test_gc_rename_failure_aborts_with_segments_intact(tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "disk", "site": "serve.wal",
                  "mode": "rename", "at": [1]}])
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=60,
                            fsync="none")
        _fill(w, 6)
        before = _segs(w.path)
        rep = w.gc(6)
        assert rep["aborted"] and rep["retired"] == 0
        assert _segs(w.path) == before
        assert w.gc_watermark == 0
        rep2 = w.gc(6)
        assert not rep2["aborted"] and rep2["retired"] >= 1
        w.close()
        return ({k: v for k, v in rep.items() if k != "ms"},
                {k: v for k, v in rep2.items() if k != "ms"}, before)

    both(scen, tmp_path)


def test_mid_gc_crash_leaves_replay_unaffected(tmp_path):
    def scen(P, root):
        _arm(P, [{"family": "crash", "site": "serve.wal.gc", "at": [1]}])
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=60,
                            fsync="none")
        _fill(w, 6)
        before = _recs(w, 3)
        with pytest.raises(P.ServiceCrashed):
            w.gc(3)
        w.close()
        w2 = P.WriteAheadLog(str(root / "wal"), fsync="none")
        assert w2.gc_watermark == 3
        assert _recs(w2, 3) == before
        rep = w2.gc(3)
        assert rep["retired"] >= 1
        assert _recs(w2, 3) == before
        w2.close()
        return before, rep["retired"]

    both(scen, tmp_path)


def test_disk_schedule_is_seed_deterministic(tmp_path):
    plan = [{"family": "disk", "site": "serve.wal", "mode": "bitrot",
             "prob": 0.3}]

    def scen(P, root):
        def run(sub):
            P.chaos.reset()
            _arm(P, plan, seed=42)
            w = P.WriteAheadLog(str(root / sub), fsync="none")
            _fill(w, 30)
            w.close()
            return [(r["mode"], r["seq"], r.get("index"))
                    for r in P.chaos.injected()]

        a, b = run("a"), run("b")
        assert a == b and len(a) > 0
        return a

    both(scen, tmp_path)


# ------------------------------------------------------------ scrubber


def test_scrub_clean_and_corrupt_exit_codes(tmp_path, capsys):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=120,
                            fsync="none")
        _fill(w, 8)
        w.close()
        assert P.scrub.cli(["scrub", "--wal", w.path]) == 0
        out = capsys.readouterr().out
        assert "clean" in out
        seg = os.path.join(w.path, "wal-00000001.seg")
        data = bytearray(open(seg, "rb").read())
        data[8] ^= 0x01
        open(seg, "wb").write(bytes(data))
        assert P.scrub.cli(["scrub", "--wal", w.path, "--json"]) == 1
        rep = json.loads(capsys.readouterr().out)
        assert rep["wal"]["crc_failures"] == 1
        assert rep["wal"]["clean"] is False
        return rep["wal"]["crc_failures"], rep["wal"]["records"], \
            sorted(rep["wal"])

    both(scen, tmp_path)


def test_scrub_reports_gc_eligible_bytes(tmp_path):
    def scen(P, root):
        w = P.WriteAheadLog(str(root / "wal"), rotate_bytes=120,
                            fsync="none")
        _fill(w, 10, ts=5000)
        w.close()
        rep = P.scrub.scrub_wal(w.path, watermark=4)
        assert rep["clean"] and rep["records"] == 10
        assert rep["gc_eligible_segments"] >= 1
        assert rep["gc_eligible_bytes"] > 0
        w2 = P.WriteAheadLog(str(root / "wal"), fsync="none")
        w2.gc(4)
        w2.close()
        rep2 = P.scrub.scrub_wal(w2.path)
        assert rep2["watermark"] == 4
        assert rep2["gc_eligible_segments"] == 0
        assert rep2["clean"]
        strip = ("path", "ms", "scanned_at")
        return ({k: v for k, v in rep.items() if k not in strip},
                {k: v for k, v in rep2.items() if k not in strip})

    both(scen, tmp_path)


def test_scrub_checkpoints_flags_missing_and_bad_packs(tmp_path):
    def scen(P, root):
        ck = root / "ckpt"
        ck.mkdir()
        manifest = {"~serve_manifest": 1, "gc_watermark": 5,
                    "tenants": {"u1": {"file": "u1.ckpt.json", "seq": 5},
                                "u2": {"file": "u2.ckpt.json",
                                       "seq": 3}}}
        (ck / "serve_manifest.json").write_text(json.dumps(manifest))
        (ck / "u1.ckpt.json").write_text(json.dumps({"ok": 1}))
        (ck / "u2.ckpt.json").write_text("{not json")
        (ck / "stale.ckpt.json.tmp.999").write_text("x")
        rep = P.scrub.scrub_checkpoints(str(ck))
        assert rep["manifest_ok"] and rep["tenants"] == 2
        assert rep["packs_ok"] == 1
        assert rep["packs_bad"] == ["u2.ckpt.json"]
        assert rep["stray_files"] == ["stale.ckpt.json.tmp.999"]
        assert rep["errors"] == 1
        assert rep["gc_watermark"] == 5
        assert P.scrub.cli(["scrub", "--checkpoint", str(ck)]) == 1
        return {k: v for k, v in rep.items() if k != "path"}

    both(scen, tmp_path)


# -------------------------------------------------------- cross-package


def test_reference_wal_scrubbed_and_replayed_by_the_port(tmp_path):
    """A WAL the reference wrote (rotated, one record rotted, GC'd once)
    scrubs and replays identically through the port's scrubber and
    ``WriteAheadLog``, and the port's WAL fed the same records writes
    the same segment bytes."""
    ref = REF.WriteAheadLog(str(tmp_path / "ref"), rotate_bytes=150,
                            fsync="none")
    port = PORT.WriteAheadLog(str(tmp_path / "port"), rotate_bytes=150,
                              fsync="none")
    for w in (ref, port):
        _fill(w, 12, uuid="doc7", site="sWAL000000001", ts=77)
        w.gc(3)
        w.close()
    for name in _segs(ref.path):
        assert open(os.path.join(ref.path, name), "rb").read() == open(
            os.path.join(port.path, name), "rb").read()
    assert _segs(ref.path) == _segs(port.path)
    seg = os.path.join(ref.path, _segs(ref.path)[-1])
    data = bytearray(open(seg, "rb").read())
    data[12] ^= 0x02
    open(seg, "wb").write(bytes(data))
    assert PORT.scrub.scrub_wal(ref.path) == REF.scrub.scrub_wal(ref.path)
    assert PORT.scrub.cli(["scrub", "--wal", ref.path]) == 1
    r = REF.WriteAheadLog(ref.path, fsync="none")
    p = PORT.WriteAheadLog(ref.path, fsync="none")
    assert list(p.iter_from(0)) == list(r.iter_from(0))
    assert (p.corrupt, p.skipped, p._seq) == (r.corrupt, r.skipped, r._seq)
    r.close()
    p.close()

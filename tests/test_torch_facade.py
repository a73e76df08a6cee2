"""The package facade of ``cause_tpu_torch``: every name it exports
resolves to the object of the module that holds it, and
``import cause_tpu_torch`` loads neither torch nor numpy until a device
name is first touched (its host names — bases, collections, ids, serde,
sync, gc — stay free of both).
"""

import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import cause_tpu_torch as ct

ROOT = Path(__file__).resolve().parent.parent

# every name the facade exported before its device names became lazy,
# with the module that holds it
HOME = {
    "CausalBase": "cbase", "Ref": "cbase", "is_ref": "cbase",
    "new_causal_base": "cbase", "uuid_to_ref": "cbase",
    "CausalCounter": "collections.ccounter",
    "new_causal_counter": "collections.ccounter",
    "CausalList": "collections.clist",
    "new_causal_list": "collections.clist",
    "CausalMap": "collections.cmap", "new_causal_map": "collections.cmap",
    "CausalSet": "collections.cset", "new_causal_set": "collections.cset",
    "CausalError": "collections.shared", "CausalTree": "collections.shared",
    "causal_to_edn": "collections.shared",
    "H_HIDE": "ids", "H_SHOW": "ids", "HIDE": "ids", "ROOT_ID": "ids",
    "SPECIALS": "ids", "K": "ids", "Keyword": "ids", "is_special": "ids",
    "new_site_id": "ids", "new_uid": "ids", "node": "ids",
    "dumps": "serde", "loads": "serde",
    "compact": "gc", "compact_stats": "gc", "stability_frontier": "gc",
    "sync_base_pair": "sync", "sync_pair": "sync", "sync_stream": "sync",
    "version_vector": "sync",
    "LANE_KEYS5": "benchgen", "lanes_from_numpy": "benchgen",
    "default_device": "device", "resolve_device": "device",
    "use_device": "device",
    "FleetSession": "parallel.session",
    "flat_fold": "parallel.tree", "merge_tree": "parallel.tree",
    "merge_tree_report": "parallel.tree",
    "WaveBuffers": "parallel.wave", "WaveResult": "parallel.wave",
    "merge_wave": "parallel.wave",
    "MapWaveResult": "weaver.mapw", "merge_map_wave": "weaver.mapw",
    "batched_merge_weave_v5": "weaver.torchw5",
    "batched_merge_weave_v5f": "weaver.torchw5f",
    "batched_delta_weave": "weaver.torchwd",
    "batched_weave_digest": "weaver.torchwd",
}
# the facade's own functions and aliases
OWN = {"append", "base", "blame", "ccounter", "clist", "cmap",
       "content_digest", "cset", "get_collection", "get_nodes",
       "get_site_id", "get_ts", "get_uuid", "get_weave", "h_hide", "h_show",
       "hide", "insert", "merge", "merge_all", "redo", "root_id",
       "set_site_id", "transact", "undo", "weft"}


def test_exports_are_unchanged():
    assert set(ct.__all__) == set(HOME) | OWN
    assert len(ct.__all__) == len(set(ct.__all__))
    assert set(ct.__all__) <= set(dir(ct))


@pytest.mark.parametrize("name", sorted(HOME))
def test_each_exported_name_is_its_modules_object(name):
    mod = importlib.import_module(f"cause_tpu_torch.{HOME[name]}")
    assert getattr(ct, name) is getattr(mod, name)
    ns = {}
    exec(f"from cause_tpu_torch import {name} as got", ns)
    assert ns["got"] is getattr(mod, name)


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no_such_name"):
        ct.no_such_name  # noqa: B018
    assert not hasattr(ct, "no_such_name")


def _fresh(code: str):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)


def test_import_loads_neither_torch_nor_numpy_until_a_device_name():
    out = _fresh("""\
        import sys
        import cause_tpu_torch as ct

        def loaded():
            return sorted(m for m in ("torch", "numpy") if m in sys.modules)

        assert loaded() == [], loaded()
        a = ct.clist("x", "y").conj("z")
        b = ct.CausalList(a.ct.evolve(site_id=ct.new_site_id())).conj("w")
        assert sorted(a.merge(b).causal_to_edn()) == ["w", "x", "y", "z"]
        ct.cmap("k", 1).assoc("j", 2)
        ct.base().transact([[None, None, {ct.K("p"): ["t"]}]])
        ct.loads(ct.dumps(a))
        assert loaded() == [], loaded()
        ct.merge_wave
        assert loaded() == ["numpy", "torch"], loaded()
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_host_names_import_with_torch_and_numpy_blocked():
    """The facade, its host names and the analyser load where neither
    torch nor numpy can; a device name then fails on the missing
    dependency, not earlier."""
    out = _fresh("""\
        import sys

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "numpy",
                                          "torch"):
                    raise ImportError("BLOCKED: " + name)
                return None

        sys.meta_path.insert(0, Blocker())
        import cause_tpu_torch as ct
        import cause_tpu_torch.analysis
        assert ct.clist("a").conj("b").causal_to_edn() == ["a", "b"]
        try:
            ct.merge_wave
        except ImportError as e:
            assert "BLOCKED" in str(e)
        else:
            raise AssertionError("merge_wave resolved without torch")
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

"""Serialization: tagged JSON round-trip of causal collections, bases
and plain values.

Copy of ``cause_tpu.serde``: the same tag scheme and the same bytes, so
a collection or a base encodes to the data the reference encodes it to.
Only ``nodes`` is serialized per tree; decoding rebuilds yarns and the
weave with the tree's weave function, so a decoded tree is also a proof
of cache idempotency.

The ``weaver`` field names the weave backend. The reference's device
weaver is ``"jax"``; this package's is ``"torch"``, and decoding maps
``"jax"`` to ``"torch"`` (``collections.shared.weaver_name``, which the
constructors also apply), so a reference checkpoint of a device tree
loads onto this package's device path. ``"pure"`` and ``"native"``
decode as they are.

Tag scheme (single-``~``-key JSON objects; plain scalars pass through):

====================  =========================================
``{"~k": name}``      Keyword
``{"~f": name}``      non-finite float (``nan`` / ``inf`` / ``-inf``)
``{"~s": name}``      Special (``hide`` / ``h.hide`` / ``h.show``)
``{"~r": uuid}``      Ref to a nested collection
``{"~t": [...]}``     tuple
``{"~set": [...]}``   set; ``{"~fset": [...]}`` frozenset
``{"~d": [[k,v]..]}`` dict (keys can be any encodable value)
``{"~causal": ...}``  CausalList / CausalMap / CausalSet / CausalCounter /
                      CausalBase
====================  =========================================

Node ids and id-valued causes are stored as plain ``[ts, site, tx]``
arrays: positionally unambiguous (map keys are hashable, so a raw
Python list can never be a key).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from .cbase import CB, CausalBase, Ref
from .collections import ccounter as c_counter
from .collections import clist as c_list
from .collections import cmap as c_map
from .collections import cset as c_set
from .collections import shared as s
from .collections.ccounter import CausalCounter
from .collections.clist import CausalList
from .collections.cmap import CausalMap
from .collections.cset import CausalSet
from .collections.shared import CausalTree
from .ids import Keyword, Special, is_id

__all__ = [
    "to_data",
    "from_data",
    "dumps",
    "loads",
    "encode_node_items",
    "decode_node_items",
]

_INF = float("inf")


def _encode_id(nid) -> list:
    return [nid[0], nid[1], nid[2]]


def _encode_cause(cause):
    """A cause is an id (lists) or a key (maps). Ids go positional."""
    if is_id(cause):
        return _encode_id(cause)
    return to_data(cause)


def _decode_cause(d):
    if type(d) is list and len(d) == 3 and type(d[1]) is str:
        return (d[0], d[1], d[2])
    return from_data(d)


def encode_node_items(nodes_map: dict) -> list:
    """The on-wire node-triple encoding ``[id, cause, value]`` shared
    by tree checkpoints and sync frames — one definition so the two
    can never drift apart."""
    return [
        [_encode_id(nid), _encode_cause(cause), to_data(value)]
        for nid, (cause, value) in sorted(nodes_map.items())
    ]


def decode_node_items(data: list) -> dict:
    """Inverse of ``encode_node_items``."""
    out = {}
    for enc_id, enc_cause, enc_value in data:
        nid = (enc_id[0], enc_id[1], enc_id[2])
        out[nid] = (_decode_cause(enc_cause), from_data(enc_value))
    return out


def _encode_tree(ct: CausalTree) -> dict:
    nodes = encode_node_items(ct.nodes)
    return {
        "~causal": ct.type,
        "uuid": ct.uuid,
        "site_id": ct.site_id,
        "lamport_ts": ct.lamport_ts,
        "weaver": ct.weaver,
        "nodes": nodes,
    }


def _decode_tree(d: dict) -> CausalTree:
    """Reconstitute a tree from its bag of nodes: rebuild yarns, ts and
    the weave from scratch (refresh-caches parity, shared.cljc:259-266),
    then restore the recorded clock (it may run ahead of the max node
    ts, e.g. after tombstone-only activity elsewhere in a base)."""
    kind = d["~causal"]
    weaver = d["weaver"]  # the constructors map "jax" to "torch"
    nodes = decode_node_items(d["nodes"])
    if kind == s.LIST_TYPE:
        fresh, weave_fn = c_list.new_causal_tree(weaver), c_list.weave
    elif kind == s.MAP_TYPE:
        fresh, weave_fn = c_map.new_causal_tree(weaver), c_map.weave
    elif kind == c_set.SET_TYPE:
        fresh, weave_fn = c_set.new_causal_tree(weaver), c_list.weave
    elif kind == c_counter.COUNTER_TYPE:
        fresh, weave_fn = (c_counter.new_causal_tree(weaver),
                           c_list.weave)
    else:
        raise s.CausalError("unknown causal tag", {"tag": kind})
    nodes.update(fresh.nodes)  # the seeded root sentinel (list trees)
    ct = fresh.evolve(uuid=d["uuid"], site_id=d["site_id"], nodes=nodes)
    ct = s.refresh_caches(weave_fn, ct)
    return ct.evolve(lamport_ts=max(ct.lamport_ts, d["lamport_ts"]))


def _encode_base(cb: CB) -> dict:
    return {
        "~causal": "base",
        "uuid": cb.uuid,
        "site_id": cb.site_id,
        "lamport_ts": cb.lamport_ts,
        "weaver": cb.weaver,
        "root_uuid": cb.root_uuid,
        "first_undo_lamport_ts": cb.first_undo_lamport_ts,
        "last_undo_lamport_ts": cb.last_undo_lamport_ts,
        "last_redo_lamport_ts": cb.last_redo_lamport_ts,
        "history": [[_encode_id(nid), uuid] for nid, uuid in cb.history],
        "collections": [to_data(c) for c in cb.collections.values()],
    }


def _decode_base(d: dict) -> CausalBase:
    collections = {}
    for enc in d["collections"]:
        coll = from_data(enc)
        collections[coll.get_uuid()] = coll
    cb = CB(
        lamport_ts=d["lamport_ts"],
        uuid=d["uuid"],
        site_id=d["site_id"],
        history=[((e[0][0], e[0][1], e[0][2]), e[1]) for e in d["history"]],
        first_undo_lamport_ts=d["first_undo_lamport_ts"],
        last_undo_lamport_ts=d["last_undo_lamport_ts"],
        last_redo_lamport_ts=d["last_redo_lamport_ts"],
        root_uuid=d["root_uuid"],
        collections=collections,
        weaver=s.weaver_name(d["weaver"]),
    )
    return CausalBase(cb)


def to_data(x) -> Any:
    """Encode a value (a collection, a base or plain data) to JSON-able
    tagged data.
    Non-finite floats get a tag so the emitted JSON stays strict RFC
    8259."""
    if isinstance(x, float) and x != x:
        return {"~f": "nan"}
    if isinstance(x, float) and (x == _INF or x == -_INF):
        return {"~f": "inf" if x > 0 else "-inf"}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, Keyword):
        return {"~k": x.name}
    if isinstance(x, Special):
        return {"~s": x.name}
    if isinstance(x, Ref):
        return {"~r": x.uuid}
    if isinstance(x, (CausalList, CausalMap, CausalSet, CausalCounter)):
        return _encode_tree(x.ct)
    if isinstance(x, CausalTree):
        return _encode_tree(x)
    if isinstance(x, CausalBase):
        return _encode_base(x.cb)
    if isinstance(x, CB):
        return _encode_base(x)
    if isinstance(x, tuple):
        return {"~t": [to_data(v) for v in x]}
    if isinstance(x, frozenset):
        return {"~fset": sorted((to_data(v) for v in x), key=repr)}
    if isinstance(x, set):
        return {"~set": sorted((to_data(v) for v in x), key=repr)}
    if isinstance(x, dict):
        return {"~d": [[to_data(k), to_data(v)] for k, v in x.items()]}
    if isinstance(x, list):
        return [to_data(v) for v in x]
    raise s.CausalError(
        "value is not serializable", {"type": type(x).__name__}
    )


def from_data(d) -> Any:
    """Decode tagged data produced by ``to_data``. Decoded trees come
    back wrapped in their handles (CausalList / CausalMap / CausalSet /
    CausalCounter), bases as CausalBase."""
    if d is None or isinstance(d, (bool, int, float, str)):
        return d
    if isinstance(d, list):
        return [from_data(v) for v in d]
    if isinstance(d, dict):
        if "~f" in d:
            return {"nan": float("nan"), "inf": _INF, "-inf": -_INF}[d["~f"]]
        if "~k" in d:
            return Keyword(d["~k"])
        if "~s" in d:
            return Special(d["~s"])
        if "~r" in d:
            return Ref(d["~r"])
        if "~t" in d:
            return tuple(from_data(v) for v in d["~t"])
        if "~set" in d:
            return set(from_data(v) for v in d["~set"])
        if "~fset" in d:
            return frozenset(from_data(v) for v in d["~fset"])
        if "~d" in d:
            return {from_data(k): from_data(v) for k, v in d["~d"]}
        if "~causal" in d:
            if d["~causal"] == "base":
                return _decode_base(d)
            ct = _decode_tree(d)
            handle = {
                s.LIST_TYPE: CausalList,
                s.MAP_TYPE: CausalMap,
                c_set.SET_TYPE: CausalSet,
                c_counter.COUNTER_TYPE: CausalCounter,
            }[ct.type]
            return handle(ct)
    raise s.CausalError("undecodable data", {"data": type(d).__name__})


def dumps(x, indent: Optional[int] = None) -> str:
    """Serialize a collection, a base or a plain value to strict
    RFC-compliant JSON."""
    return json.dumps(to_data(x), indent=indent, allow_nan=False)


def loads(text: str) -> Any:
    """Deserialize ``dumps`` output back to live values."""
    return from_data(json.loads(text))

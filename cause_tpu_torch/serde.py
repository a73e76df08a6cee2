"""Serialization: tagged JSON round-trip of causal lists and plain values.

Copy of ``cause_tpu.serde`` holding what a list fleet's checkpoint
needs (``FleetSession.checkpoint``): the same tag scheme and the same
bytes, so a list encodes to the data the reference encodes it to. Only
``nodes`` is serialized per tree; decoding rebuilds yarns and the weave
with the tree's weave function.

Tag scheme (single-``~``-key JSON objects; plain scalars pass through):

====================  =========================================
``{"~k": name}``      Keyword
``{"~f": name}``      non-finite float (``nan`` / ``inf`` / ``-inf``)
``{"~s": name}``      Special (``hide`` / ``h.hide`` / ``h.show``)
``{"~t": [...]}``     tuple
``{"~set": [...]}``   set; ``{"~fset": [...]}`` frozenset
``{"~d": [[k,v]..]}`` dict (keys can be any encodable value)
``{"~causal": ...}``  CausalList
====================  =========================================

Node ids and id-valued causes are stored as plain ``[ts, site, tx]``
arrays. Maps, sets, counters, bases and refs (``{"~r": uuid}``) raise a
``CausalError``: their modules are not ported yet (ROADMAP A.10 and
A.16).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from .collections import clist as c_list
from .collections import shared as s
from .collections.clist import CausalList
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


def _not_ported(what: str) -> s.CausalError:
    return s.CausalError(
        f"{what} is not ported yet (ROADMAP A.10 / A.16): only lists "
        "and plain values serialize", {"causes": {"not-ported"},
                                       "what": what})


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
    """The on-wire node-triple encoding ``[id, cause, value]`` of tree
    checkpoints (and, in the reference, sync frames)."""
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
    if ct.type != s.LIST_TYPE:
        raise _not_ported(f"a {ct.type!r} tree")
    return {
        "~causal": ct.type,
        "uuid": ct.uuid,
        "site_id": ct.site_id,
        "lamport_ts": ct.lamport_ts,
        "weaver": ct.weaver,
        "nodes": encode_node_items(ct.nodes),
    }


def _decode_tree(d: dict) -> CausalTree:
    """Reconstitute a list from its bag of nodes: rebuild yarns, ts and
    the weave from scratch, then restore the recorded clock (it may run
    ahead of the max node ts)."""
    kind = d["~causal"]
    if kind != s.LIST_TYPE:
        raise _not_ported(f"a {kind!r} tree")
    nodes = decode_node_items(d["nodes"])
    fresh = c_list.new_causal_tree(d["weaver"])
    nodes.update(fresh.nodes)  # the seeded root sentinel
    ct = fresh.evolve(uuid=d["uuid"], site_id=d["site_id"], nodes=nodes)
    ct = s.refresh_caches(c_list.weave, ct)
    return ct.evolve(lamport_ts=max(ct.lamport_ts, d["lamport_ts"]))


def to_data(x) -> Any:
    """Encode a value (a list or plain data) to JSON-able tagged data.
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
    if isinstance(x, CausalList):
        return _encode_tree(x.ct)
    if isinstance(x, CausalTree):
        return _encode_tree(x)
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
    """Decode tagged data produced by ``to_data``; lists come back as
    ``CausalList`` handles."""
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
            raise _not_ported("a ref")
        if "~t" in d:
            return tuple(from_data(v) for v in d["~t"])
        if "~set" in d:
            return set(from_data(v) for v in d["~set"])
        if "~fset" in d:
            return frozenset(from_data(v) for v in d["~fset"])
        if "~d" in d:
            return {from_data(k): from_data(v) for k, v in d["~d"]}
        if "~causal" in d:
            return CausalList(_decode_tree(d))
    raise s.CausalError("undecodable data", {"data": type(d).__name__})


def dumps(x, indent: Optional[int] = None) -> str:
    """Serialize a list or plain value to strict RFC-compliant JSON."""
    return json.dumps(to_data(x), indent=indent, allow_nan=False)


def loads(text: str) -> Any:
    """Deserialize ``dumps`` output back to live values."""
    return from_data(json.loads(text))

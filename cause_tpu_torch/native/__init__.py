"""Native host weaver: ctypes bindings over the C++ linearizer.

A copy of ``cause_tpu.native``: full reweaves and merges on the host go
through ``weaver.cpp``'s O(n) preorder construction instead of the
O(n^2) sequential replay. The shared library is built with g++ on first
use into ``cause_tpu_torch/_build/`` (keyed by a hash of the source, so
an edited source rebuilds); ``available()`` reports whether the
toolchain produced one. A failed build warns once and every caller
falls back to the pure weaver: this is a host path, not the card's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

__all__ = ["available", "weave_list_ranks", "weave_map_ranks", "lib"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "weaver.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD, f"libct_weaver-{h.hexdigest()[:16]}.so")


def _build() -> ctypes.CDLL:
    """Compile weaver.cpp to a shared library unless a current one
    exists. The compile goes to a per-pid temp file and is renamed into
    place, so concurrent first use across processes never loads a torn
    library."""
    so = _so_path()
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", *_CXX_FLAGS, "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(so)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ct_weave_list.restype = ctypes.c_int32
    lib.ct_weave_list.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    lib.ct_weave_map.restype = ctypes.c_int32
    lib.ct_weave_map.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p,
                                 i32p, i32p, i32p]
    return lib


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None when the build failed."""
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                try:
                    # one-time lazy build under the init lock: double-
                    # checked, every later caller takes the fast path
                    _lib = _build()
                except (OSError, subprocess.CalledProcessError) as e:
                    _build_failed = True
                    detail = getattr(e, "stderr", "") or str(e)
                    warnings.warn(
                        "cause_tpu_torch native weaver build failed; "
                        'weaver="native" degrades to the pure host path: '
                        f"{detail.strip()[:400]}",
                        RuntimeWarning,
                        stacklevel=3,
                    )
    return _lib


def available() -> bool:
    return lib() is not None


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def weave_list_ranks(cause_idx, vclass):
    """Weave rank for one list tree's lanes (ascending id order, lane 0
    = root). Raises RuntimeError when the library is missing or the
    lanes are malformed."""
    L = lib()
    if L is None:
        raise RuntimeError("native weaver unavailable")
    cause_idx = _i32(cause_idx)
    vclass = _i32(vclass)
    n = cause_idx.shape[0]
    rank = np.empty(n, np.int32)
    rc = L.ct_weave_list(n, _ptr(cause_idx), _ptr(vclass), _ptr(rank))
    if rc != 0:
        raise RuntimeError(f"ct_weave_list failed with code {rc}")
    return rank


def weave_map_ranks(cause_idx, key_rank, vclass, n_keys: int):
    """(rank, key_out) for one map tree's lanes: a forest preorder where
    each key's lanes are contiguous in that key's weave order."""
    L = lib()
    if L is None:
        raise RuntimeError("native weaver unavailable")
    cause_idx = _i32(cause_idx)
    key_rank = _i32(key_rank)
    vclass = _i32(vclass)
    n = cause_idx.shape[0]
    rank = np.empty(n, np.int32)
    key_out = np.empty(n, np.int32)
    rc = L.ct_weave_map(
        n, n_keys, _ptr(cause_idx), _ptr(key_rank), _ptr(vclass),
        _ptr(rank), _ptr(key_out),
    )
    if rc != 0:
        raise RuntimeError(f"ct_weave_map failed with code {rc}")
    return rank, key_out

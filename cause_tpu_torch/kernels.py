"""Build, load and count the hand-written CUDA kernels.

The port's kernels live in ``csrc/*.cu`` (B1 ``sort.cu``, B2
``euler_walk.cu``, B3 ``fphase.cu``, and the fused token kernels B4-B6
``befuse_k1.cu``, ``befuse_k2.cu``, ``befuse_k4.cu``), each with a plain
C interface; the headers ``csrc/*.cuh`` hold code they share (the radix
row sort, the bitonic networks, the fused kernels' building blocks).
On first use they are compiled for Hopper with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into one shared library each under
``cause_tpu_torch/_build/`` (one ``nvcc`` per source, all started
together) and loaded with ``ctypes``. A library is keyed by a hash of
its source, the headers and the flags, so an edited source or header
rebuilds and an unchanged one is reused.

Every kernel wrapper adds one to its entry of ``launches`` where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels (``reset_launches`` before, read after).

Nothing here runs at import time: a machine without ``nvcc`` or a card
imports the package, and only a launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["SOURCES", "launches", "reset_launches", "build_all", "load",
           "library", "check", "stream_handle"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "_build"

# kernel name -> source file; the names are the keys of ``launches``
SOURCES = {
    "sort": "sort.cu",
    "euler_walk": "euler_walk.cu",
    "fphase": "fphase.cu",
    "k1_sort_redirect": "befuse_k1.cu",
    "k2_runs": "befuse_k2.cu",
    "k4_rank_kills": "befuse_k4.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Dict[str, int] = {name: 0 for name in SOURCES}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cause_sort_rows": [ctypes.POINTER(_VP), ctypes.POINTER(_VP), _I, _I,
                        _I, _I, _VP, _VP],
    "cause_sort_smem_limit": [],
    "cause_euler_walk_scratch_words": [_I],
    "cause_euler_walk": [_VP] * 5 + [_I, _I, _VP, _VP],
    "cause_fphase_expand": [_VP] * 9 + [_I, _I, _I, _I, _VP],
    "cause_fphase_ctas_per_sm": [],
    "cause_k1_scratch_words": [_I],
    "cause_k1_ctas_per_sm": [_I, _I],
    "cause_k1_sort_redirect": [_VP] * 16 + [_I] * 3 + [_VP, _VP],
    "cause_k2_scratch_words": [_I, _I],
    "cause_k2_ctas_per_sm": [_I, _I, _I],
    "cause_k2_runs": [_VP] * 16 + [_I] * 5 + [_VP, _VP],
    "cause_k4_scratch_words": [_I, _I],
    "cause_k4_ctas_per_sm": [_I, _I, _I],
    "cause_k4_rank_kills": [_VP] * 17 + [_I] * 6 + [_VP, _VP],
    # only in a build with -DCAUSE_PHASE_CLOCKS (chip_smoke.py --phases)
    "cause_phase_cycles_take": [_VP],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{h[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel source that has no current library, one
    ``nvcc`` process per source, all running at once. Returns the
    library paths. Raises with the compiler's output if any fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for name, p in todo.items():
            tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            (BUILD / f"{name}.log").write_text(out)
            if verbose:
                print(f"[nvcc {SOURCES[name]}]\n{out}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]} (rc {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(path) -> ctypes.CDLL:
    """Load one built library and declare its C entry points."""
    cdll = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(cdll, fn, None)
        if f is not None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return cdll


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all kernels first if
    any library is missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            for n, p in build_all().items():
                if n not in _LIBS:
                    _LIBS[n] = load(p)
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_handle(device) -> Optional[int]:
    """PyTorch's current stream on ``device`` as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

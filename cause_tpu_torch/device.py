"""Where the port's device work runs.

Every device entry point takes ``device=`` and defaults to ``"cuda"``.
The handle-level paths (``weaver="torch"`` reweaves and merges,
``merge_wave``) read the package default instead, which only an
explicit ``use_device`` call changes — the CPU tests call
``use_device("cpu")``. Asking for CUDA where there is none raises: no
entry point carries on quietly on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["use_device", "default_device", "resolve_device"]

_DEFAULT = "cuda"


def use_device(device) -> None:
    """Set the device the handle-level paths run on."""
    global _DEFAULT
    _DEFAULT = str(torch.device(device))


def default_device() -> torch.device:
    return torch.device(_DEFAULT)


def resolve_device(device=None) -> torch.device:
    """``device`` (the package default when None) as a torch device;
    raises when it names CUDA and no card is available."""
    dev = torch.device(_DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (or call "
            "cause_tpu_torch.use_device('cpu')) to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev

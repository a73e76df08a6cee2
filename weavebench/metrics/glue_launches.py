"""CUDA kernels a wave launches that are not the port's own (PyTorch's
ops: the v5 glue), counted in the trace."""

from ..trace import clipped, is_port_kernel


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n = sum(1 for name, k, _s, _e in clipped(tr)
            if k == "kernel" and not is_port_kernel(name, ctx["port_kernels"]))
    return n / tr["waves"]

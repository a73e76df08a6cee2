"""Per-layer metric readers, one module each, found by the metric's
name in ``BENCHMARK.json``. Each has ``read(ctx)``, which returns the
metric's value from the traced run's context, or None where it finds
nothing to read (the harness then leaves the metric out of the line).

The context (``run.trace_context``) holds ``trace`` (the summary of
``trace.summarize``, or None without device activity), ``entry_ms``
(the host time of each untraced wave of the traced run inside the
entry call), ``port_launches_per_wave`` (from
``cause_tpu_torch.kernels.launches``), ``port_kernels`` (the kernel
names ``csrc/`` defines), ``wave_bytes`` (what a wave must move) and
``peak_bytes_per_s`` (the card's published memory bandwidth, or None).
"""

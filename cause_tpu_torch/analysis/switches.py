"""The port's registry of ``CAUSE_TPU_*`` environment variables.

causelint's TID rules hold every ``CAUSE_TPU_*`` read to this registry:
a name must be a member of exactly one of the two tables, or a typo'd
variable would become a config axis nothing keys on.

- ``TRACE_SWITCHES`` names the variables that are program identity: read
  while a device program is traced, so every cache of a traced program
  must fold them into its key. The port traces no program (its kernels
  are CUDA sources built once, and its PyTorch code runs eagerly), so
  the table is empty.
- ``KNOWN_ENV_KNOBS`` names the variables that are not program identity:
  telemetry, sampling, durability and fault-injection knobs whose values
  never reach a kernel. Each is one the port reads.

The module is called ``switches`` on purpose: the TID and JPH rules
exempt a module by that last segment, as they exempt the registry of the
package they lint. Import-free, like the rest of the analyser.
"""

TRACE_SWITCHES = ()

KNOWN_ENV_KNOBS = (
    "CAUSE_TPU_OBS",
    "CAUSE_TPU_OBS_OUT",
    "CAUSE_TPU_OBS_RING",
    "CAUSE_TPU_OBS_SHIP",
    "CAUSE_TPU_BODY_SAMPLE",
    "CAUSE_TPU_LEDGER",
    "CAUSE_TPU_LAG_SLO_MS",
    "CAUSE_TPU_CHAOS",
    "CAUSE_TPU_WAL_FSYNC",
)

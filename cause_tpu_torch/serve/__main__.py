"""``python -m cause_tpu_torch.serve`` — the storage scrubber CLI
(:mod:`cause_tpu_torch.serve.scrub`). Host-only: it reads a dead
service's directories and needs no card."""

import sys

from .scrub import cli

if __name__ == "__main__":
    sys.exit(cli())

"""Run the port's veleslint over the repository.

    python -m veles_tpu_torch.tools.veleslint                 # full scan
    python -m veles_tpu_torch.tools.veleslint --rule atomic-write
    python -m veles_tpu_torch.tools.veleslint --sync-docs     # knob table
    python -m veles_tpu_torch.tools.veleslint --sync-lock-order
    python -m veles_tpu_torch.tools.veleslint --write-baseline

It scans ``veles_tpu_torch/`` and ``chip_smoke.py`` with the 13 rules of
:mod:`veles_tpu_torch.analysis` against the port's baseline and locking
law (``veles_tpu_torch/analysis/baseline.json`` and
``lock_order.json``), and checks the knob and threading-model tables in
README.md's port section.  Exit 0 when no finding is new, 1 otherwise,
2 on a usage or baseline error.
"""

import sys

from veles_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())

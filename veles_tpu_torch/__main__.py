"""The port's command line.

    python -m veles_tpu_torch [-b auto|cuda|cpu] [-s SEED] WORKFLOW.py
        [CONFIG.py ...] [root.x.y=value ...]
    python -m veles_tpu_torch --serve-models NAME=PKG.vpkg [NAME=PKG ...]
        [-b auto|cuda|cpu] [--max-batch N] [--max-wait-ms MS]

The first trains: config files run in order, then the ``root.*``
overrides, then the launcher drives the workflow file (its
``run(launcher)`` or ``create_workflow(launcher)``) on the card, or on
the CPU with ``-b cpu``.  The second starts the serving process
(``veles_tpu_torch/serve/hive.py``).  Not ported yet, and so refused:
``--snapshot``, ``--dp``, ``--optimize``, ``--ensemble-*``,
``--profile``, the fleet router and the supervisor.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="Train a workflow with the PyTorch/CUDA port "
                    "(--serve-models NAME=PKG starts the serving "
                    "process instead)")
    p.add_argument("files", nargs="+",
                   help="workflow file, then config files")
    p.add_argument("-b", "--backend", default="auto",
                   help="auto|cuda (CUDA device 0; fails without one) "
                        "or cpu")
    p.add_argument("-s", "--seed", type=int, default=1234)
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve-models" in argv:
        from veles_tpu_torch.serve import hive
        return hive.main([a for a in argv if a != "--serve-models"])
    from veles_tpu_torch.config import is_override, parse_overrides

    # root.* overrides may appear anywhere and apply after config files
    overrides = [a for a in argv if is_override(a)]
    args = build_parser().parse_args([a for a in argv
                                      if a not in overrides])
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")

    from veles_tpu_torch.launcher import (Launcher, apply_config_file,
                                          drive_workflow)
    workflow_file, *config_files = args.files
    for cf in config_files:
        apply_config_file(cf)
    parse_overrides(overrides)
    launcher = Launcher(backend=args.backend, seed=args.seed)
    try:
        drive_workflow(launcher, workflow_file)
    except RuntimeError as e:
        if "defines neither" in str(e):
            print(str(e), file=sys.stderr)
            return 2
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``python -m veles_tpu_torch --serve-models NAME=PKG.vpkg ...``

The port's command line.  This slice carries the serving process only
(``veles_tpu_torch/serve/hive.py``); training workflows, the fleet
router and the supervisor come with later slices.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve-models" in argv:
        from veles_tpu_torch.serve import hive
        return hive.main([a for a in argv if a != "--serve-models"])
    print("usage: python -m veles_tpu_torch --serve-models NAME=PKG.vpkg "
          "[NAME=PKG ...] [-b auto|cuda|cpu] [--max-batch N] "
          "[--max-wait-ms MS]\n(only the serving process is ported so "
          "far)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())

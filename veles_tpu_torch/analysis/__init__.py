"""The port's analysis package (the counterpart of
``veles_tpu/analysis/``).

- The runtime lock-order witness (:mod:`.witness`): the locks the
  port's thread-spawning modules make through its factories record the
  (held -> acquired) pairs real execution takes.
- Veleslint (:mod:`.engine`, :mod:`.rules`, :mod:`.flow`,
  :mod:`.concurrency`, :mod:`.cli`): the reference's 13 AST rules over
  the port's own tree (atomic writes, the knob and event registries,
  host syncs in device-side step code, the exit-code contract, lock
  discipline, the residency seam, thread lifecycles, the wire protocol,
  trace wire keys, the lock order, blocking under a lock, waiter
  discipline), with inline ``# veleslint: disable=<rule>`` waivers, the
  checked-in ``baseline.json`` and the locking law
  ``lock_order.json``, which names exactly the witness's
  ``LOCK_NAMES``.  ``python -m veles_tpu_torch.tools.veleslint`` runs
  it.
"""

from veles_tpu_torch.analysis.engine import (  # noqa: F401
    Config,
    Finding,
    check_knob_table,
    load_baseline,
    load_config,
    load_contexts,
    new_findings,
    project_findings,
    repo_root,
    repo_scan,
    run_lint,
    scan_source,
    write_baseline,
)
from veles_tpu_torch.analysis.rules import (  # noqa: F401
    PROJECT_RULES,
    RULES,
    rule_names,
)

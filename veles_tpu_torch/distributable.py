"""Distribution hooks (the port's copy of ``veles_tpu/distributable.py``).

The master--slave mode (``server.py``, ``client.py``) calls these hooks
on the units that carry them: ``generate_data_for_slave`` /
``apply_data_from_master`` move a job's share of a unit's state from
the master to a slave, ``apply_data_from_slave`` takes a result back on
the master, and ``drop_slave`` tells a unit that a slave went silent.
The port keeps only the hooks its master and slave call.  Data parallelism over
``torch.distributed`` (``parallel/``) does not use them: its gradients
are summed inside the step.

Overrides, as the reference's: ``loader/base.py`` ``Loader`` (a job's
minibatch indices), ``ops/decision.py`` ``DecisionGD`` (a job's class
metrics) and ``workflow.py`` ``Workflow`` (no-ops).
"""

from __future__ import annotations

from typing import Any, Optional


class Distributable:
    """Mixin with default no-op distribution hooks."""

    def generate_data_for_slave(self, slave: Optional[Any] = None) -> Any:
        return None

    def apply_data_from_master(self, data: Any) -> None:
        pass

    def apply_data_from_slave(self, data: Any,
                              slave: Optional[Any] = None) -> None:
        pass

    def drop_slave(self, slave: Optional[Any] = None) -> None:
        pass

"""The Unit: a node of the dataflow graph (the port's copy of
``veles_tpu/units.py``).

- A ``Unit`` has ``initialize()`` and ``run()``.
- Control edges: ``link_from(src)``.  A unit fires when ALL its linked
  predecessors have fired since its own last firing.
- Data edges: ``link_attrs(src, "a", ("mine", "theirs"))`` aliases
  attributes to the source unit.
- ``gate_block`` stops propagation through the unit; ``gate_skip``
  skips ``run()`` but still propagates.  Both are lazily evaluated
  ``Bool``s, so a decision's ``complete`` flag can gate a loop.

The graph is host-side Python and holds no tensors itself: compute is
in an ``AcceleratedUnit``'s ``apply``.  Per-unit wall time is summed
for the workflow's timing report.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Set, Tuple, Union

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.mutable import Bool, LinkableAttribute


class Unit(Logger):
    """A schedulable node. Subclasses override ``initialize`` and ``run``."""

    def __init__(self, workflow: Optional["Unit"] = None,
                 name: Optional[str] = None, **kwargs: Any) -> None:
        self._name = name
        self.workflow = None
        self.links_from: Dict[Unit, bool] = {}
        self.links_to: Set[Unit] = set()
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._initialized = False
        self.run_count = 0
        self.run_time = 0.0
        if workflow is not None:
            workflow.add_unit(self)
        self.__dict__.setdefault("_attr_links", {})

    # -- identity ------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name or type(self).__name__

    @name.setter
    def name(self, value: str) -> None:
        self._name = value

    def __repr__(self) -> str:
        return f"<{type(self).__name__} '{self.name}'>"

    # -- data edges ----------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        links = self.__dict__.get("_attr_links")
        if links and name in links:
            return links[name].get()
        raise AttributeError(
            f"{type(self).__name__} '{self.__dict__.get('_name') or ''}' "
            f"has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        links = self.__dict__.get("_attr_links")
        if links and name in links:
            links[name].set(value)
            return
        object.__setattr__(self, name, value)

    def link_attrs(self, other: "Unit",
                   *names: Union[str, Tuple[str, str]]) -> "Unit":
        """Alias attributes of ``self`` to attributes of ``other``: each
        name is ``"attr"`` (the same on both sides) or ``("mine",
        "theirs")``.  Reads and writes pass through to ``other``, so a
        consumer always sees the producer's current value."""
        for n in names:
            mine, theirs = (n, n) if isinstance(n, str) else n
            LinkableAttribute(self, mine, other, theirs)
        return self

    # -- control edges -------------------------------------------------

    def link_from(self, *units: "Unit") -> "Unit":
        for u in units:
            self.links_from[u] = False
            u.links_to.add(self)
        return self

    def unlink_from(self, *units: "Unit") -> "Unit":
        for u in units:
            self.links_from.pop(u, None)
            u.links_to.discard(self)
        return self

    def unlink_all(self) -> None:
        for u in list(self.links_from):
            self.unlink_from(u)
        for u in list(self.links_to):
            u.unlink_from(self)

    @property
    def ready(self) -> bool:
        return all(self.links_from.values()) if self.links_from else True

    def _reset_trigger_state(self) -> None:
        for u in self.links_from:
            self.links_from[u] = False

    # -- lifecycle -----------------------------------------------------

    def initialize(self, **kwargs: Any) -> None:
        """Allocate state.  ``Workflow.initialize`` calls it in
        dependency order, again while it raises ``AttributeError``."""

    def run(self) -> None:
        """Do the unit's work for one firing."""

    def stop(self) -> None:
        """Called when the workflow stops (a clean-up hook)."""

    # -- snapshots -----------------------------------------------------

    _unpicklable = ("device",)

    def __getstate__(self) -> dict:
        """Everything but the device handle pickles, the graph's cycles
        included; ``initialize`` binds a device again."""
        d = dict(self.__dict__)
        for k in self._unpicklable:
            d.pop(k, None)
        return d

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        for k in self._unpicklable:
            self.__dict__.setdefault(k, None)
        self._initialized = False

    def fire(self) -> bool:
        """One firing; True when ``run()`` actually ran."""
        if bool(self.gate_skip):
            return False
        t0 = time.perf_counter()
        self.run()
        self.run_time += time.perf_counter() - t0
        self.run_count += 1
        return True


class TrivialUnit(Unit):
    """A unit that does nothing when it fires."""


class Container(Unit):
    """A unit that owns other units (the base of Workflow)."""

    def __init__(self, workflow: Optional[Unit] = None, **kwargs: Any) -> None:
        self.units: list = []
        super().__init__(workflow, **kwargs)

    def add_unit(self, unit: Unit) -> None:
        self.units.append(unit)
        unit.workflow = self

    def del_unit(self, unit: Unit) -> None:
        if unit in self.units:
            self.units.remove(unit)
            unit.unlink_all()

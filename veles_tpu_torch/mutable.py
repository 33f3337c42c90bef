"""Lazily evaluated booleans and linkable attributes (the port's copy of
``veles_tpu/mutable.py``).

- ``Bool`` objects compose with ``&``, ``|`` and ``~`` into expression
  trees evaluated at each read.  Units use them as gates
  (``gate_block``, ``gate_skip``), so one decision's ``complete`` flag
  can gate both the loop-back edge and the end point.
- ``LinkableAttribute`` aliases an attribute of one object to an
  attribute of another: the data edges of ``Unit.link_attrs``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class Bool:
    """A mutable boolean whose value may be derived from an expression
    over other Bools, evaluated lazily at each read."""

    __slots__ = ("_value", "_expr", "on_change")

    def __init__(self, value: bool = False) -> None:
        self._value = bool(value)
        self._expr: Optional[Callable[[], bool]] = None
        self.on_change: Optional[Callable[[bool], None]] = None

    @classmethod
    def from_expr(cls, expr: Callable[[], bool]) -> "Bool":
        b = cls()
        b._expr = expr
        return b

    def __bool__(self) -> bool:
        if self._expr is not None:
            return bool(self._expr())
        return self._value

    def __invert__(self) -> "Bool":
        return Bool.from_expr(lambda: not bool(self))

    def __and__(self, other: Any) -> "Bool":
        return Bool.from_expr(lambda: bool(self) and bool(other))

    def __or__(self, other: Any) -> "Bool":
        return Bool.from_expr(lambda: bool(self) or bool(other))

    def __lshift__(self, value: Any) -> "Bool":
        """``b << True`` assigns (the upstream ``<<=`` idiom)."""
        self.set(bool(value))
        return self

    def set(self, value: bool) -> None:
        if self._expr is not None:
            raise ValueError("cannot assign to a derived Bool")
        changed = self._value != bool(value)
        self._value = bool(value)
        if changed and self.on_change is not None:
            self.on_change(self._value)

    def __repr__(self) -> str:
        kind = "expr" if self._expr is not None else "value"
        return f"Bool({bool(self)}, {kind})"

    # a derived Bool holds closures: a snapshot keeps only its value
    def __getstate__(self) -> dict:
        return {"value": bool(self)}

    def __setstate__(self, state: dict) -> None:
        self._value = state["value"]
        self._expr = None
        self.on_change = None


class LinkableAttribute:
    """Alias ``owner.name`` to ``source.attr``, two-way by default:
    writes go through to the source object.  The link lives in the
    owner's ``_attr_links`` dict, so instances of one class may link to
    different sources."""

    def __init__(self, owner: Any, name: str, source: Any, attr: str,
                 two_way: bool = True) -> None:
        self.source = source
        self.attr = attr
        self.two_way = two_way
        links = owner.__dict__.get("_attr_links")
        if links is None:
            links = {}
            object.__setattr__(owner, "_attr_links", links)
        links[name] = self
        # an instance attribute of that name would shadow the link
        owner.__dict__.pop(name, None)

    def get(self) -> Any:
        return getattr(self.source, self.attr)

    def set(self, value: Any) -> None:
        if not self.two_way:
            raise AttributeError(f"attribute linked one-way to "
                                 f"{self.source}.{self.attr}")
        setattr(self.source, self.attr, value)

"""Declared ``VELES_*`` environment knobs (the port's own copy).

Counterpart of ``veles_tpu/knobs.py``: every knob is declared once,
with its name, default, parser and a one-line doc, and read through
:func:`get`.  ``flag`` knobs are on for any non-empty value but
``"0"``; the others parse with their declared type and fall back to the
default on a malformed value, so an env typo degrades instead of taking
down a run.

This copy holds the online-learning tier's knobs, with the reference's
names, defaults and types.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


def flag(raw: str) -> bool:
    """Set and not ``"0"`` means on."""
    return bool(raw) and raw != "0"


class Knob:
    """One declared environment knob."""

    __slots__ = ("name", "default", "parser", "doc")

    def __init__(self, name: str, default: Any,
                 parser: Callable[[str], Any], doc: str) -> None:
        self.name = name
        self.default = default
        self.parser = parser
        self.doc = doc

    def read(self, environ: Optional[Dict[str, str]] = None) -> Any:
        env = os.environ if environ is None else environ
        raw = env.get(self.name)
        if raw is None or raw == "":
            return self.default
        try:
            return self.parser(raw)
        except (TypeError, ValueError):
            return self.default


#: every declared knob, by name
KNOBS: Dict[str, Knob] = {}


def _knob(name: str, default: Any, parser: Callable[[str], Any],
          doc: str) -> str:
    assert name.startswith("VELES_"), name
    assert name not in KNOBS, f"duplicate knob {name}"
    KNOBS[name] = Knob(name, default, parser, doc)
    return name


def get(name: str, environ: Optional[Dict[str, str]] = None) -> Any:
    """The parsed value of a declared knob (its default when unset or
    malformed).  KeyError for an undeclared name."""
    return KNOBS[name].read(environ)


# -- online learning ------------------------------------------------------

ONLINE = _knob(
    "VELES_ONLINE", False, flag,
    "Arm the online-learning tier inside a hive (--serve-models): "
    "tapped traffic fills a replay buffer, a scavenger trains shadow "
    "params in serving idle gaps, and the promotion gate swaps them in "
    "on the device when the held-out slice improves by "
    "$VELES_ONLINE_PROMOTE_MARGIN.")
ONLINE_TAP_FRAC = _knob(
    "VELES_ONLINE_TAP_FRAC", 1.0, float,
    "Deterministic fraction of admitted requests the tap mirrors into "
    "the replay buffer (an error-diffusion accumulator, not a coin "
    "flip).")
ONLINE_BUFFER_ROWS = _knob(
    "VELES_ONLINE_BUFFER_ROWS", 4096, int,
    "Replay-buffer capacity in sample rows per learning model "
    "(reservoir-sampled once full); rows store as uint8 when the "
    "model's ingest codec round-trips them.")
ONLINE_HOLDOUT_EVERY = _knob(
    "VELES_ONLINE_HOLDOUT_EVERY", 8, int,
    "Every Nth labeled tapped request lands in the held-out slice the "
    "promotion gate scores (never trained on).")
ONLINE_MICRO_BATCH = _knob(
    "VELES_ONLINE_MICRO_BATCH", 32, int,
    "Rows per scavenged fine-tune step: the one fixed train shape.")
ONLINE_MIN_STEPS = _knob(
    "VELES_ONLINE_MIN_STEPS", 8, int,
    "Fine-tune steps between promotion-gate rounds (and before the "
    "first one).")
ONLINE_PROMOTE_MARGIN = _knob(
    "VELES_ONLINE_PROMOTE_MARGIN", 1.0, float,
    "Held-out error-% margin the shadow must beat the incumbent by to "
    "be promoted; a shadow worse by this margin rolls back to the "
    "incumbent's params.")
ONLINE_IDLE_MS = _knob(
    "VELES_ONLINE_IDLE_MS", 2.0, float,
    "Milliseconds every serving batcher must have been idle (empty "
    "queue, nothing in flight) before the scavenger takes a step.")
ONLINE_SLO_P99_MS = _knob(
    "VELES_ONLINE_SLO_P99_MS", 0.0, float,
    "The scavenger skips steps while its EMA step cost exceeds this "
    "many milliseconds (a step that long would set the p99 of a "
    "request arriving under it); 0 disables the check.")
ONLINE_LR_SCALE = _knob(
    "VELES_ONLINE_LR_SCALE", 0.1, float,
    "Fine-tune learning-rate scale applied to each gradient unit's "
    "packaged rate.")
ONLINE_DUTY = _knob(
    "VELES_ONLINE_DUTY", 0.5, float,
    "Ceiling on the scavenger's duty cycle (0..1): after each step it "
    "rests cost*(1-duty)/duty, so host cores and the GIL stay mostly "
    "free for the serving threads.")

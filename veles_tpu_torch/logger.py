"""Logging: the ``Logger`` mixin, the console set-up and the JSON-lines
event sink (the port's copy).

Counterpart of ``veles_tpu/logger.py``: ``Logger`` gives a class
``self.info`` / ``debug`` / ``warning`` / ``error`` on a per-instance
``veles.<name>`` logger; :func:`setup_logging` puts a console handler
(colored on a terminal) on the ``veles`` namespace and routes every
record through :data:`event_hooks`; :func:`add_jsonl_sink` appends each
record to a file as one JSON line (``ts``, ``level``, ``unit``,
``message``), the reference's run-event sink; and WARNING and above also
land in the telemetry journal as ``log.record`` events and in the
flight recorder's ring as ``log.<level>`` entries.  The port's
modules that log under ``veles_tpu_torch.*`` get the same hook and a
WARNING console handler.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Callable, List

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"

#: hooks called with every log record (the event sink's seam)
event_hooks: List[Callable[[logging.LogRecord], None]] = []


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


class _HookHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        # a copy: a failing hook may unregister itself mid-iteration
        for hook in list(event_hooks):
            hook(record)


def add_jsonl_sink(path: str) -> Callable[[], None]:
    """Append every ``veles.*`` log record to ``path`` as one JSON line.
    Returns a detach function that unregisters the hook and closes the
    file."""
    f = open(path, "a", buffering=1)

    def hook(record: logging.LogRecord) -> None:
        try:
            f.write(json.dumps({
                "ts": round(record.created or time.time(), 3),
                "level": record.levelname,
                "unit": record.name,
                "message": record.getMessage(),
            }) + "\n")
        except (ValueError, OSError):
            # a closed file or a full disk: the sink is an aid, never a
            # reason to stop the run
            if hook in event_hooks:
                event_hooks.remove(hook)

    event_hooks.append(hook)

    def detach() -> None:
        if hook in event_hooks:
            event_hooks.remove(hook)
        f.close()

    return detach


def _journal_hook(record: logging.LogRecord) -> None:
    """WARNING and above into the telemetry journal and the flight
    recorder's ring, so the run's timeline holds its warnings beside its
    events."""
    if record.levelno < logging.WARNING:
        return
    try:
        from veles_tpu_torch import events as _ev
        from veles_tpu_torch import telemetry as _tm
        from veles_tpu_torch import trace as _tr
        _tm.event(_ev.EV_LOG_RECORD, level=record.levelname,
                  unit=record.name, message=record.getMessage())
        _tr.record("log." + record.levelname.lower(),
                   unit=record.name, message=record.getMessage())
    except Exception:  # noqa: BLE001 — observability never takes down
        pass           # the unit that logged


_configured = False


def setup_logging(level: int = logging.INFO) -> None:
    global _configured
    rootlog = logging.getLogger("veles")
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        rootlog.addHandler(handler)
        rootlog.addHandler(_HookHandler())
        rootlog.propagate = False
        if _journal_hook not in event_hooks:
            event_hooks.append(_journal_hook)
        # the port's own namespace: the same hook, and its warnings on
        # the console; it keeps propagating to the root's handlers
        plog = logging.getLogger("veles_tpu_torch")
        perr = logging.StreamHandler(sys.stderr)
        perr.setLevel(logging.WARNING)
        plog.addHandler(perr)
        plog.addHandler(_HookHandler())
        _configured = True
    rootlog.setLevel(level)


class Logger:
    """Mixin giving ``self.info/debug/warning/error`` on a per-class (or
    per-unit, once ``name`` exists) logger."""

    @property
    def logger(self) -> logging.Logger:
        name = getattr(self, "name", None) or type(self).__name__
        return logging.getLogger(f"veles.{name}")

    def debug(self, msg: str, *args) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)

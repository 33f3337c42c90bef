"""Deterministic, seeded fault injection (the port's copy).

Counterpart of ``veles_tpu/faults.py``: injection points are named and
armed from one environment variable, so a child process inherits the
arming, and a disarmed call site costs one module attribute load and a
falsy check.

Arming syntax (``VELES_FAULTS``)::

    VELES_FAULTS="hive.slow_dispatch@label=alpha&times=6&seconds=1.5"

- entries are comma-separated; each is ``point[@qual=val[&qual=val...]]``;
- a qualifier matches when the call site passed a context key of that
  name whose ``str()`` equals the value; a qualifier the call site did
  not supply never matches;
- ``times``/``seconds``/``silent``/``after`` never take part in
  matching: ``times=N`` caps how often the entry fires (default 1;
  ``times=*`` is unlimited) and the rest ride on the returned payload
  for the call site to read.

The registry knows the reference's points (``POINTS``), so a string
that arms the reference arms the port the same way.  The port wires
every one of them but ``stream.corrupt_file`` (the image loader):
``multihost.peer_exit`` in ``launcher.init_multihost`` (``process`` =
the rank), ``evaluator.hang`` and
``evaluator.garbage_line`` in the GA evaluator, ``snapshot.torn_write``
in the snapshotter, ``checkpoint.corrupt`` in the GA's state file,
``device.oom_on_put`` on the streaming upload, the resident data set's
upload and a GA cohort, ``preempt.sigterm`` and
``supervisor.child_crash`` through :func:`maybe_inject_sigterm` and
:func:`maybe_inject_child_crash`, ``online.poison_batch`` in the tap,
``online.swap_mid_request`` in the promotion, and the serving fleet's
four:

==========================  ==========================================
``hive.slow_dispatch``      a serving micro-batch dispatch stalls
                            (``label`` = model name; knob: ``seconds``
                            per dispatch): the slow replica that drags
                            the fleet's p99 without dying
``hive.wedge``              a serving request is swallowed unanswered
                            while heartbeats and stats keep flowing
                            (``model``)
``hive.garbage_response``   a response's probability payload is
                            replaced with deterministic garbage after
                            the integrity crc was computed from the
                            clean one (``model``)
``fleet.replica_flap``      a hive SIGKILLs itself ``after`` seconds
                            past its hello, on every respawn when
                            armed with ``times=*``
==========================  ==========================================

Determinism: no clock and no global RNG; an entry fires on exactly the
calls its qualifiers select, in call order, and ``garbage()``/``rng()``
derive their bytes from ``VELES_FAULTS_SEED`` (default 0) and the point
name.
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Any, Dict, List, Optional

from veles_tpu_torch import knobs

ENV_VAR = knobs.FAULTS
SEED_ENV_VAR = knobs.FAULTS_SEED

#: every valid injection-point name — ``arm()`` rejects unknown points
#: so a typo'd drill fails loudly instead of silently injecting nothing
POINTS = frozenset((
    "evaluator.hang",
    "evaluator.garbage_line",
    "stream.corrupt_file",
    "snapshot.torn_write",
    "checkpoint.corrupt",
    "device.oom_on_put",
    "multihost.peer_exit",
    "preempt.sigterm",
    "supervisor.child_crash",
    "hive.slow_dispatch",
    "hive.wedge",
    "hive.garbage_response",
    "online.poison_batch",
    "online.swap_mid_request",
    "fleet.replica_flap",
))

_log = logging.getLogger("veles.faults")

#: qualifier names that are knobs for the call site, not matchers —
#: ``evaluator.hang@seq=1&silent=1`` matches on ``seq`` only and
#: hands ``silent`` to the injection site via the payload
KNOBS = frozenset(("times", "seconds", "silent", "after"))


class FaultSpec:
    """One armed entry: a point name, its match qualifiers, and a
    remaining-fire budget."""

    __slots__ = ("point", "quals", "remaining")

    def __init__(self, point: str, quals: Dict[str, str],
                 times: int) -> None:
        self.point = point
        self.quals = quals
        #: fires left; -1 = unlimited
        self.remaining = times

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if self.remaining == 0:
            return False
        for k, v in self.quals.items():
            if k in KNOBS:
                continue
            if k not in ctx or str(ctx[k]) != v:
                return False
        return True

    def __repr__(self) -> str:
        qs = "&".join(f"{k}={v}" for k, v in self.quals.items())
        return f"FaultSpec({self.point}@{qs} remaining={self.remaining})"


#: armed specs by point name; EMPTY when disarmed — the fast path
_specs: Dict[str, List[FaultSpec]] = {}


def parse(spec_str: str) -> Dict[str, List[FaultSpec]]:
    """Parse an arming string into specs (see module docstring)."""
    specs: Dict[str, List[FaultSpec]] = {}
    for entry in spec_str.split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, _, quals_s = entry.partition("@")
        point = point.strip()
        if point not in POINTS:
            raise ValueError(
                f"{ENV_VAR}: unknown injection point {point!r} "
                f"(known: {sorted(POINTS)})")
        quals: Dict[str, str] = {}
        times = 1
        if quals_s:
            for q in quals_s.split("&"):
                k, sep, v = q.partition("=")
                if not sep:
                    raise ValueError(
                        f"{ENV_VAR}: qualifier {q!r} of {point} is not "
                        f"key=value")
                if k == "times":
                    times = -1 if v in ("*", "inf") else int(v)
                else:
                    quals[k.strip()] = v.strip()
        specs.setdefault(point, []).append(FaultSpec(point, quals, times))
    return specs


def arm(spec_str: Optional[str] = None) -> None:
    """(Re)arm the registry: from ``spec_str``, or from the
    environment when None.  ``arm("")`` disarms.  Drills and tests use
    this to inject in-process; production arming is the env var at
    process start (module import calls ``arm(None)``)."""
    global _specs
    if spec_str is None:
        spec_str = knobs.get(ENV_VAR)
    _specs = parse(spec_str) if spec_str else {}
    if _specs:
        _log.warning("FAULT INJECTION ARMED: %s",
                     {p: [repr(s) for s in ss]
                      for p, ss in _specs.items()})


def active() -> bool:
    """True when any fault is armed (cheap pre-check for call sites
    that need to assemble expensive context)."""
    return bool(_specs)


def fire(point: str, **ctx: Any) -> Optional[Dict[str, str]]:
    """Should this call site inject?  Returns the matched entry's
    qualifier payload (always truthy: includes ``point``) and consumes
    one fire from its budget; None when disarmed or unmatched.

    Disarmed cost: one global load + one falsy check.
    """
    if not _specs:
        return None
    for spec in _specs.get(point, ()):
        if spec.matches(ctx):
            if spec.remaining > 0:
                spec.remaining -= 1
            _log.warning("FAULT INJECTED: %s ctx=%r", point, ctx)
            payload = {"point": point}
            payload.update(spec.quals)
            return payload
    return None


def seed() -> int:
    return int(knobs.get(SEED_ENV_VAR))


def rng(point: str):
    """A numpy Generator seeded from (VELES_FAULTS_SEED, point) — the
    deterministic randomness source for injected garbage."""
    import numpy as np
    return np.random.default_rng(
        (seed() << 32) ^ zlib.crc32(point.encode()))


def garbage(n: int = 48, point: str = "garbage") -> bytes:
    """``n`` deterministic garbage bytes for ``point``."""
    return rng(point).integers(0, 256, size=n, dtype="uint8").tobytes()


def garbage_text(n: int = 48, point: str = "garbage") -> str:
    """A deterministic printable NON-JSON garbage line (protocol-tear
    simulation: never parses, never empty, no newline)."""
    import string
    alphabet = string.ascii_letters + string.digits + "#%&*<>|"
    idx = rng(point).integers(0, len(alphabet), size=n)
    return "\x15" + "".join(alphabet[i] for i in idx)


def hang(seconds: float = 3600.0) -> None:
    """The canonical injected hang: sleep in 1s slices (so an external
    kill lands promptly) for ``seconds``."""
    import time
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        time.sleep(min(1.0, max(0.0, deadline - time.monotonic())))


def maybe_inject_sigterm(**ctx: Any) -> None:
    """``preempt.sigterm``: deliver a real SIGTERM to this process
    (after ``after`` seconds, from a timer thread), so a drill rehearses
    a preemption notice end to end: the graceful-stop handler must
    snapshot and exit 14 within ``$VELES_PREEMPT_GRACE``.  Call sites
    pass ``attempt`` (``$VELES_SUPERVISE_ATTEMPT``) so a resumed child
    is not preempted again."""
    f = fire("preempt.sigterm", **ctx)
    if not f:
        return
    import signal
    import threading
    import time
    delay = float(f.get("after", 0.0))

    def _term() -> None:
        if delay > 0:
            time.sleep(delay)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=_term, daemon=True,
                     name="fault-preempt-sigterm").start()


def maybe_inject_child_crash(**ctx: Any) -> None:
    """``supervisor.child_crash``: SIGKILL this process (no handler, no
    snapshot, no atexit flush); the supervisor must resume the run from
    the newest intact snapshot or GA state.  Call sites pass
    ``attempt`` / ``gen`` so a drill targets exactly one crash.  The
    flight recorder's ring is dumped first (``sigkill``): SIGKILL skips
    atexit and the telemetry flush, so it is written now or never."""
    if fire("supervisor.child_crash", **ctx):
        import signal
        import sys
        try:
            # imported here: faults loads before almost everything, and
            # a failed dump must not soften the crash being rehearsed
            from veles_tpu_torch import trace
            trace.dump("sigkill")
        except Exception:  # noqa: BLE001
            pass
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    """A torn write: keep only the leading fraction of ``path`` (at
    least 1 byte, strictly less than the whole)."""
    size = os.path.getsize(path)
    keep = max(1, min(size - 1, int(size * keep_fraction)))
    os.truncate(path, keep)


# arm from the environment at import: children of an armed process
# inherit the env var, so one export covers the whole process tree
arm(None)

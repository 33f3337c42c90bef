"""Whole-workflow snapshots and resume (the port's own copy).

Counterpart of ``veles_tpu/snapshotter.py``.  A snapshot pickles the
whole training workflow with the named numpy streams' state
(``prng.snapshot_state``), inside the same CRC32 envelope the reference
writes: ``MAGIC | <QI length, crc32> | pickle``, inside the compression
stream the file's suffix picks (``.gz``, ``.bz2``, ``.xz`` or none).
The envelope is shared, the payload is not: it pickles the PORT's
classes, so a port snapshot resumes only in the port, and
:func:`verify_snapshot` (which never unpickles) accepts either.

- Only host state is pickled: the fused runner moves its params,
  velocities and partial class metrics to numpy, loaders drop the data
  they regenerate, and nothing holds a device tensor, so a snapshot
  opens without a card.  ``initialize`` re-binds the device.
- Writes go through a pid-unique temp file and ``os.replace``
  (:func:`atomic_write`), so no reader or concurrent writer sees a torn
  file.  :func:`load_workflow` verifies the envelope; with
  ``fallback=True`` a torn or corrupt file resumes from the newest
  intact sibling of its lineage (:func:`snapshot_candidates`), and
  raises when none is intact: a corrupt snapshot never becomes a fresh
  start.
- The resume manifest (``resume_manifest.json`` next to the snapshot,
  and at ``$VELES_RESUME_MANIFEST`` when the supervisor exported one)
  points at the newest snapshot, so ``--supervise`` resumes a stopped
  run with no operator flags.
- :class:`Snapshotter` runs after the decision on a validation
  improvement and writes ``<prefix>_epoch<N>_<err>pt.pickle.gz``,
  keeping the newest ``keep``; in a data-parallel group only rank 0
  writes (every rank holds the same params), and the group itself never
  reaches the pickle: a resumed run installs data parallelism again.
- Telemetry: saves and loads are timed into
  ``snapshot.save_seconds`` / ``snapshot.load_seconds``, saves and
  lineage fallbacks counted and journalled; the resume manifest records
  the run's metrics dir.  Fault point ``snapshot.torn_write`` truncates
  the temp file before its rename, as a torn write would.

The default
directory is the port's own (``~/.veles_tpu_torch/snapshots``), so a
fallback walk never tries to unpickle a reference snapshot.
"""

from __future__ import annotations

import bz2
import contextlib
import gzip
import json
import logging
import lzma
import os
import pickle
import struct
import tempfile
import time
import zlib
from typing import Any, List, Optional

from veles_tpu_torch import events, faults, knobs, telemetry

log = logging.getLogger("veles.snapshotter")

_OPENERS = {".gz": gzip.open, ".bz2": bz2.open, ".xz": lzma.open}

#: CRC-envelope magic (the reference's format 2)
MAGIC = b"VSNPCRC2"
_HEADER = struct.Struct("<QI")   # payload length, crc32

#: where the supervisor tells a child to keep the resume manifest (in
#: addition to the copy next to the snapshot)
MANIFEST_ENV = knobs.RESUME_MANIFEST
MANIFEST_NAME = "resume_manifest.json"
DEFAULT_DIRECTORY = os.path.join("~", ".veles_tpu_torch", "snapshots")


class SnapshotCorruptError(RuntimeError):
    """A snapshot file is torn or corrupt (short read, CRC mismatch, or
    a codec or unpickling error consistent with truncation)."""


def _opener(path: str):
    for suffix, op in _OPENERS.items():
        if path.endswith(suffix):
            return op
    return open


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb", opener=open,
                 before_replace=None):
    """Open a pid-unique temp file next to ``path`` (through
    ``opener``) and ``os.replace`` it over ``path`` on a clean exit
    (after ``before_replace(temp path)``, when given); on an error the
    temp file is removed."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        with opener(tmp, mode) as f:
            yield f
        if before_replace is not None:
            before_replace(tmp)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def save_workflow(workflow: Any, path: str,
                  streams: Optional[dict] = None) -> str:
    """Pickle (workflow, stream state) to ``path`` inside the CRC
    envelope, compressed as its suffix says, atomically.  ``streams``:
    a :func:`prng.snapshot_state` taken earlier (a save on a thread of
    its own), else the process's now."""
    from veles_tpu_torch import prng
    t0 = time.perf_counter()
    if streams is None:
        streams = prng.snapshot_state()
    payload = {"format": 2, "workflow": workflow, "prng": streams,
               "timestamp": time.time()}
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    torn = faults.fire("snapshot.torn_write", path=path)
    with atomic_write(path, "wb", _opener(path),
                      faults.truncate_file if torn else None) as f:
        f.write(MAGIC)
        f.write(_HEADER.pack(len(blob), zlib.crc32(blob) & 0xFFFFFFFF))
        f.write(blob)
    dt = time.perf_counter() - t0
    telemetry.histogram(events.HIST_SNAPSHOT_SAVE_SECONDS).record(dt)
    telemetry.counter(events.CTR_SNAPSHOT_SAVES).inc()
    telemetry.event(events.EV_SNAPSHOT_SAVE, path=os.path.basename(path),
                    bytes=len(blob), seconds=round(dt, 3))
    return path


def _read_blob(path: str) -> Optional[bytes]:
    """The verified pickle bytes of an enveloped file, or None for a
    file without the envelope; SnapshotCorruptError on a short read or
    a CRC mismatch."""
    with _opener(path)(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            return None
        meta = f.read(_HEADER.size)
        if len(meta) != _HEADER.size:
            raise SnapshotCorruptError(f"{path}: truncated envelope header")
        length, crc = _HEADER.unpack(meta)
        blob = f.read(length)
    if len(blob) != length:
        raise SnapshotCorruptError(
            f"{path}: truncated payload ({len(blob)}/{length} bytes)")
    if (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
        raise SnapshotCorruptError(f"{path}: CRC mismatch")
    return blob


def _read_payload(path: str) -> dict:
    try:
        blob = _read_blob(path)
        if blob is None:
            raise SnapshotCorruptError(f"{path}: no snapshot envelope")
        return pickle.loads(blob)
    except SnapshotCorruptError:
        raise
    except (OSError, EOFError, zlib.error, lzma.LZMAError,
            pickle.UnpicklingError, ValueError, struct.error,
            AttributeError, ImportError, IndexError, MemoryError) as e:
        # a codec error or short read is a tear; Attribute/ImportError
        # means classes that no longer resolve: not an intact snapshot
        raise SnapshotCorruptError(f"{path}: {type(e).__name__}: {e}") \
            from e


def verify_snapshot(path: str) -> bool:
    """True when ``path`` holds an intact envelope: its CRC checked
    WITHOUT unpickling, so a supervisor can probe candidates cheaply
    and without importing the classes they pickle."""
    try:
        return _read_blob(path) is not None
    except Exception:  # noqa: BLE001 — any read error: not intact
        return False


def snapshot_candidates(path: str) -> List[str]:
    """Sibling snapshot files of ``path`` (same directory, same lineage
    prefix), newest first by mtime, ``path`` itself excluded: the
    fallback order for a corrupt snapshot.  The lineage prefix is what
    comes before ``_epoch`` (the Snapshotter's files) or ``_final``
    (the launcher's final snapshots), else the name without its
    extension."""
    directory = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    stem = base.split("_epoch")[0].split("_final")[0]
    if stem == base:
        stem = os.path.splitext(base)[0]
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    cands = [os.path.join(directory, n) for n in entries
             if n != base and n.startswith(stem)
             and not n.endswith((".tmp", ".json"))]
    cands = [c for c in cands if os.path.isfile(c)]
    cands.sort(key=os.path.getmtime, reverse=True)
    return cands


def write_json_atomic(path: str, payload: dict) -> None:
    with atomic_write(path, "w") as f:
        json.dump(payload, f, indent=1)


def read_resume_manifest(path: str) -> Optional[dict]:
    """The manifest, or None when it is missing or unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_resume_manifest(snapshot: Optional[str] = None,
                          reason: Optional[str] = None,
                          ga_state: Optional[str] = None) -> List[str]:
    """Merge-update the resume manifest(s): the one at
    ``$VELES_RESUME_MANIFEST`` and, for a ``snapshot``, the one next to
    it.  ``snapshot`` and ``ga_state`` (a GA's per-generation state
    file) are pointers; a field not given keeps its value, so a GA
    checkpoint never clobbers a snapshot pointer nor the reverse.  A
    manifest that cannot be written is skipped: it must never take the
    run down."""
    targets = []
    env_path = knobs.get(MANIFEST_ENV)
    if env_path:
        targets.append(env_path)
    if snapshot:
        nxt = os.path.join(os.path.dirname(os.path.abspath(snapshot)),
                           MANIFEST_NAME)
        if nxt not in targets:
            targets.append(nxt)
    written = []
    for path in targets:
        payload = read_resume_manifest(path) or {"format": 1}
        if snapshot:
            payload["snapshot"] = os.path.abspath(snapshot)
        if ga_state:
            payload["ga_state"] = os.path.abspath(ga_state)
        if reason:
            payload["reason"] = reason
        payload["metrics_dir"] = telemetry.metrics_dir()
        payload["pid"] = os.getpid()
        payload["ts"] = round(time.time(), 3)
        try:
            write_json_atomic(path, payload)
        except OSError as e:
            log.warning("resume manifest %s not written: %s", path, e)
            continue
        written.append(path)
    return written


def load_workflow(path: str, fallback: bool = False):
    """The workflow pickled in ``path``, with the streams' state put
    back; the caller must ``initialize`` it before ``run``.  With
    ``fallback=True`` a torn or corrupt ``path`` resumes from the
    newest intact sibling instead; the original error is raised when
    none is intact."""
    from veles_tpu_torch import prng
    t0 = time.perf_counter()
    try:
        payload = _read_payload(path)
    except SnapshotCorruptError as e:
        if not fallback:
            raise
        log.warning("snapshot %s is corrupt (%s); looking for the newest "
                    "intact predecessor", path, e)
        payload = None
        for cand in snapshot_candidates(path):
            try:
                payload = _read_payload(cand)
            except SnapshotCorruptError as e2:
                log.warning("predecessor %s is corrupt too (%s)", cand, e2)
                continue
            telemetry.counter(events.CTR_SNAPSHOT_FALLBACKS).inc()
            telemetry.event(events.EV_SNAPSHOT_FALLBACK, corrupt=path,
                            used=cand)
            log.warning("resuming from intact predecessor %s instead of "
                        "corrupt %s", cand, path)
            break
        if payload is None:
            telemetry.event(events.EV_SNAPSHOT_UNRECOVERABLE, path=path)
            raise
    telemetry.histogram(events.HIST_SNAPSHOT_LOAD_SECONDS).record(
        time.perf_counter() - t0)
    prng.restore_state(payload["prng"])
    return payload["workflow"]


class Snapshotter:
    """Writes a snapshot of its workflow when run (the workflow runs it
    after the decision on a validation improvement), every
    ``interval``-th time, and keeps the newest ``keep`` files.
    ``compression``: "gz", "bz2", "xz" or "" (none); the launcher's
    final snapshot follows it too."""

    def __init__(self, workflow: Any = None, name: str = "snapshotter",
                 prefix: str = "snapshot", directory: Optional[str] = None,
                 compression: str = "gz", interval: int = 1,
                 keep: int = 3) -> None:
        self.workflow = workflow
        self.name = name
        self.prefix = prefix
        self.directory = directory or os.path.expanduser(DEFAULT_DIRECTORY)
        self.compression = compression.lstrip(".")
        self.interval = interval
        self.keep = keep
        self.decision = None
        self.last_path: Optional[str] = None
        #: snapshots written, and the seconds the last one took
        self.saves = 0
        self.last_seconds = 0.0
        self._epoch_count = 0
        self._written: List[str] = []

    @property
    def suffix(self) -> str:
        return f".pickle.{self.compression}" if self.compression \
            else ".pickle"

    def run(self) -> None:
        self._epoch_count += 1
        if self.interval > 1 and self._epoch_count % self.interval:
            return
        from veles_tpu_torch.parallel.mesh import is_writer
        if not is_writer():
            return   # a data-parallel group's snapshots are rank 0's
        err = "" if self.decision is None else \
            f"_{self.decision.epoch_error_pct[1]:.2f}pt"
        epoch = self.workflow.loader.epoch_number
        path = os.path.join(self.directory,
                            f"{self.prefix}_epoch{epoch}{err}{self.suffix}")
        t0 = time.perf_counter()
        save_workflow(self.workflow, path)
        self.last_seconds = time.perf_counter() - t0
        self.saves += 1
        self.last_path = path
        # a kill between epochs still leaves the supervisor this path
        write_resume_manifest(path)
        log.info("snapshot -> %s (%.2fs)", path, self.last_seconds)
        self._written.append(path)
        while len(self._written) > self.keep:
            with contextlib.suppress(OSError):
                os.remove(self._written.pop(0))

"""The Hive serving process of the port: one card, many models.

``python -m veles_tpu_torch --serve-models NAME=PKG.vpkg [NAME=PKG ...]``

Counterpart of ``veles_tpu/serve/hive.py``; the wire protocol is the
reference's, byte for byte.  One persistent process owns the device,
announces itself with a hello line, emits heartbeat lines, and speaks
JSON lines over stdin/stdout:

- every model is a Forge ensemble package (``pack_ensemble``: manifest
  + workflow entry + members npz).  The entry must build the PORT's
  workflow (it imports ``veles_tpu_torch``); the members npz is the
  framework-neutral one, mapped onto the port's layout by
  ``convert.params_from_jax``;
- requests (``{"id", "model", "rows"}`` with an optional absolute
  ``"deadline_ms"``) route through the model's engine ``submit()``, and
  the micro-batching loop coalesces concurrent requests into ONE
  fixed-shape dispatch;
- models stay resident under the budget; the LRU one spills to host;
- SIGTERM drains: accepted requests finish, and the process exits 14.

Protocol lines (stdout; writes serialized under one lock)::

    {"ready": true, "pid", "platform", "backend", "models": {...},
     "max_batch", "max_wait_ms", ...}                 -- hello
    {"hb": n, "pid"}                                  -- heartbeat
    {"id", "model", "pred": [...], "probs": [[...]],
     "rows_n": n, "crc": c}                           -- response
    {"id", "error": "..."}                            -- failed request
    {"id", "error": "...", "expired": true}           -- past deadline
    {"id", "stats": {...}}                            -- op=stats

``crc`` is the crc32 of the clean float32 probability payload.
Before its hello the hive warms every resident model up: one dispatch
of ``max_batch`` rows of zeros (the batcher's padded shape), answers
discarded (``EnsembleEvalEngine.warm_up``), so cuDNN's first use and
the kernels' first launches land there and not in a client's first
request.  The warm-up feeds no tap, buffer or learner and counts in no
request or dispatch counter; it sets the first-dispatch gauge and the
``serve.first_dispatch`` event.

``stats`` carries the port's own counters: ``requests``,
``request_errors``, ``dispatches``, ``rows``, ``max_batch_rows``,
``spills``, ``kernel_launches`` (``{"lrn_fwd": n}``, and ``"lrn_bwd"``
when a learner is armed; the warm-up's launches not included),
``warmup`` (``{"dispatches", "seconds", "kernel_launches"}``), the
residency ``ledger`` and per-model rows;
and beside them the process's telemetry snapshot (``counters``,
``gauges``, ``histograms``: ``veles_tpu_torch/telemetry.py``), which is
what the reference's hive answers and what the fleet router reads
(``serve.dispatch_seconds``, ``serve.batch_rows``, ``serve.batches``).

Fault points (``veles_tpu_torch/faults.py``, armed by
``$VELES_FAULTS``): ``hive.wedge`` swallows a request unanswered,
``hive.garbage_response`` replaces an answer's probabilities after its
crc was computed, ``fleet.replica_flap`` SIGKILLs the process ``after``
seconds past its hello, and the batcher's ``hive.slow_dispatch`` stalls
a dispatch.

With ``--online`` (``veles_tpu_torch/online``) a request may carry
``"label"`` (per-row ground truth) for the learning tap; truth known
only later joins by wire id through ``{"label_of": <id>, "label":
[...]}`` (no response line); ``{"op": "learn", "id"}`` answers ``{"id",
"learn": {model: {state, steps, buffer_rows, ...}}}``, the learner's
row per model; ``{"op": "learner_suspend" | "learner_resume", "id"}``
answers ``{"id", "learner_ctl": {"online", "suspended"}}``; and
``stats`` gains an ``online`` entry (steps, gate rounds, skips, tap
counts).  A learning model's loader loads its data set on the host once,
for the codec's dequantization (``loader.dequant``) that the replay
buffer stores rows by, as the reference's hive has it
(:func:`attach_dequant`).  The learner stops before the SIGTERM drain.

``--metrics-dir DIR`` (or ``$VELES_METRICS_DIR``) persists the
process's telemetry there in the reference's formats: the snapshot is
flushed after the hello, every heartbeat at most every
``telemetry.FLUSH_EVERY`` seconds, and at shutdown, after the
``serve.drain`` and ``serve.shutdown`` events.

Tracing (``veles_tpu_torch/trace.py``): a request carrying the router's
trace fields is admitted under a child span of the sending leg
(``from_wire`` -> ``child`` -> ``use``), handed to the engine and the tap
with it, and recorded as ``hive.request`` in the flight recorder's ring;
the ring is dumped on a SIGTERM drain (``sigterm``) and before the
flapping replica's SIGKILL (``flap``).  The locks come from the lock-order
witness's factories: ``hive.emit`` (the reference's) and ``hive.stats``
(the port's own request counts).

``--mesh N`` (or ``$VELES_SERVE_MESH``; the reference's
``hive.py:233-245``): the replica owns a mesh of N places
(``parallel/mesh.py`` ``make_mesh``: on the card place i is ``cuda:(i //
$VELES_MESH_RANKS_PER_CARD)``), one ``MeshDevice`` that the residency
manager and the engines read.  Budgets are per place, and a model over
one place's budget serves member-sharded and resident
(``$VELES_SERVE_MESH_SHARD``, ``serve/residency.py``).  The hello
advertises ``devices`` N and each model's ``sharded``; ``op=stats``'s
model rows carry ``sharded`` too.  A mesh the visible cards cannot hold
exits 2 naming ``$VELES_MESH_RANKS_PER_CARD``.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import queue
import signal
import sys
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch import events, faults, knobs, telemetry, trace
from veles_tpu_torch.analysis import witness
from veles_tpu_torch.serve.batcher import DeadlineExpired

#: the exit code the supervisor reads as "preempted, resume me"
EXIT_PREEMPTED = 14


class _FL:
    """The launcher stand-in ``create_workflow`` expects."""
    workflow = None


def load_model_package(name: str, pkg_path: str, device: Any,
                       install_dir: str, pristine: Dict[str, Any]):
    """One Forge ensemble package -> a HostedModel ready to register.

    Installs (checksum-verified), rebuilds the config tree from
    ``pristine`` + the package's config files, seeds every stream from
    the first member's seed, builds the entry's workflow, gives its
    forwards their shapes, and pairs the forward chain with the members
    converted to the port's layout.  ``meta`` records the workflow, the
    package's version and file name, and the seed."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.ensemble.packaging import load_members
    from veles_tpu_torch.forge import ForgePackage
    from veles_tpu_torch.launcher import apply_config_file, \
        load_workflow_module
    from veles_tpu_torch.ops.nn_units import ForwardUnit
    from veles_tpu_torch.serve.residency import HostedModel

    manifest = ForgePackage.install(pkg_path, install_dir)
    pkg_root = manifest["root"]
    snap = manifest.get("snapshot")
    if not snap or not snap.endswith(".npz"):
        raise ValueError(
            f"{pkg_path}: serving needs an ensemble package (members "
            f"npz snapshot); this one carries {snap!r}")
    members = load_members(os.path.join(pkg_root, snap))

    root.__dict__.clear()
    root.__dict__.update(copy.deepcopy(pristine))
    for cf in manifest.get("configs", []):
        apply_config_file(os.path.join(pkg_root, cf))
    # every stream from the package's seed, as the reference seeds them
    seed = int(members[0].get("seed", 1234))
    prng.seed_all(seed)
    mod = load_workflow_module(os.path.join(pkg_root, manifest["entry"]))
    create = getattr(mod, "create_workflow", None)
    if create is None:
        raise ValueError(f"{pkg_path}: entry {manifest['entry']!r} "
                         f"exposes no create_workflow(launcher)")
    w = create(_FL())
    if not all(isinstance(f, ForwardUnit) for f in w.forwards):
        raise ValueError(
            f"{pkg_path}: entry {manifest['entry']!r} did not build a "
            f"veles_tpu_torch workflow (a reference-framework entry?)")
    w.initialize(device=device)
    return HostedModel(
        name, w.forwards,
        [params_from_jax(m["params"]) for m in members],
        meta={"workflow": w, "version": manifest.get("version"),
              "package": os.path.basename(pkg_path),
              # keys the online tier's sample stream (the offline
              # replay's contract)
              "seed": seed},
        sample_shape=tuple(w.loader.sample_shape))


def attach_dequant(w) -> Any:
    """Give a packaged workflow's loader its ``dequant``, as the
    reference's hive has it after initializing the workflow: the loader
    loads its data set on the host and decides the codec
    (``post_load_data``), then drops the arrays; nothing goes to the
    device.  Returns the dequantization (None without the codec)."""
    ld = getattr(w, "loader", None)
    if ld is None or not hasattr(ld, "post_load_data"):
        return None
    ld.load_data()
    ld.post_load_data()
    for key in ("host_data", "host_labels", "host_targets"):
        if hasattr(ld, key):
            setattr(ld, key, None)
    return ld.dequant


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch --serve-models",
        description="Hive (PyTorch/CUDA port): device-resident "
                    "multi-model serving with dynamic micro-batching")
    p.add_argument("models", nargs="+", metavar="NAME=PKG",
                   help="model name = Forge ensemble package path")
    p.add_argument("-b", "--backend", default="auto",
                   help="auto|cuda (CUDA device 0; fails without one) "
                        "or cpu")
    p.add_argument("--mesh", type=int,
                   default=int(knobs.get(knobs.SERVE_MESH)),
                   help="places this replica owns ($VELES_SERVE_MESH): >1 "
                        "binds an N-place mesh; budgets are per place and "
                        "a model over one place's budget serves member-"
                        "sharded and resident instead of spilling "
                        "($VELES_SERVE_MESH_SHARD)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="rows per micro-batch: the one dispatch shape")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="longest a queued request waits for "
                        "co-batchable traffic")
    p.add_argument("--hbm-budget", type=int, default=0,
                   help="residency budget in bytes (default: half the "
                        "card's memory; 8 GiB on the CPU)")
    p.add_argument("--heartbeat-every", type=float, default=5.0,
                   help="seconds between heartbeat lines (0 disables)")
    p.add_argument("--online", action="store_true",
                   default=bool(knobs.get(knobs.ONLINE)),
                   help="arm the online-learning tier: tap labeled "
                        "traffic, fine-tune in serving idle gaps, "
                        "promote on the device through the gate (also "
                        "$VELES_ONLINE; knobs: $VELES_ONLINE_TAP_FRAC, "
                        "$VELES_ONLINE_PROMOTE_MARGIN, ...)")
    p.add_argument("--install-dir", default=None,
                   help="package install directory (default: a temp "
                        "dir)")
    p.add_argument("--metrics-dir", default=None,
                   help="persist telemetry snapshots and the journal "
                        "into this directory (also $VELES_METRICS_DIR)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import lrn_cuda
    from veles_tpu_torch.serve.residency import (ResidencyManager,
                                                 install_process_arbiter)

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.INFO, stream=sys.stderr)
    if args.metrics_dir:
        telemetry.configure(args.metrics_dir)
    specs: List[tuple] = []
    for spec in args.models:
        name, _, path = spec.partition("=")
        if not name or not path:
            print(f"--serve-models: bad model spec {spec!r} "
                  f"(want NAME=PACKAGE.vpkg)", file=sys.stderr)
            return 2
        if not os.path.isfile(path):
            print(f"--serve-models: no such package {path!r}",
                  file=sys.stderr)
            return 2
        specs.append((name, path))
    install_dir = args.install_dir or tempfile.mkdtemp(
        prefix="hive_models_")

    if args.mesh and args.mesh > 1:
        # the replica owns a mesh of places: one MeshDevice, which the
        # residency manager and the engines read their places from
        from veles_tpu_torch.parallel import MeshDevice, make_mesh
        try:
            device = MeshDevice(make_mesh(int(args.mesh), args.backend))
        except ValueError as e:
            print(f"--serve-models --mesh {args.mesh}: {e}",
                  file=sys.stderr)
            return 2
    else:
        device = make_device(args.backend)
    residency = ResidencyManager(
        device, budget_bytes=args.hbm_budget or None,
        max_batch=max(1, args.max_batch),
        max_wait_s=max(0.0, args.max_wait_ms) / 1000.0)
    # this manager is the process's device-memory ledger: the online
    # tier's shadow and buffer charge the budget the LRU reads
    install_process_arbiter(residency)
    pristine = copy.deepcopy(dict(root.__dict__))
    for name, path in specs:
        residency.register(load_model_package(name, path, device,
                                              install_dir, pristine))
        # admit eagerly in CLI order: the budget may spill the colder
        # ones right back
        residency.ensure(name)

    emit_lock = witness.lock("hive.emit")

    def emit(obj: Dict[str, Any]) -> None:
        line = json.dumps(obj)
        with emit_lock:
            print(line, flush=True)

    # the warm-up: one padded dispatch a resident model, before the hello
    # and before the learner (its launches count apart)
    launches0 = lrn_cuda.lrn_fwd.launches
    warmup = {"dispatches": 0, "seconds": 0.0}
    for m in residency.models.values():
        if m.resident:
            warmup["seconds"] += m.engine.warm_up(residency.max_batch,
                                                  m.sample_shape)
            warmup["dispatches"] += 1
    warmup["kernel_launches"] = {
        "lrn_fwd": lrn_cuda.lrn_fwd.launches - launches0}

    learner = None
    if args.online:
        from veles_tpu_torch.online import OnlineLearner
        for name, _ in specs:
            attach_dequant(residency.models[name].meta["workflow"])
        learner = OnlineLearner(residency)
        if any([learner.arm_model(name) for name, _ in specs]):
            learner.start()
        else:
            learner = None

    emit({
        "ready": True, "pid": os.getpid(),
        "backend": device.backend_name, "platform": device.platform,
        "max_batch": residency.max_batch,
        "max_wait_ms": residency.max_wait_s * 1000.0,
        "online": learner is not None,
        # the replica's real capacity (places x the per-place budget),
        # which the fleet's placement reads
        "devices": residency.n_devices,
        "device_budget": residency.budget_bytes,
        "models": {
            m.name: {"members": len(m.member_params),
                     "param_bytes": m.param_bytes,
                     "resident": m.resident,
                     "sharded": bool(m.engine is not None
                                     and m.engine.member_sharded),
                     "version": m.meta.get("version")}
            for m in residency.models.values()},
    })
    telemetry.event(events.EV_SERVE_READY, pid=os.getpid(),
                    platform=device.platform,
                    models=sorted(residency.models),
                    max_batch=residency.max_batch)
    telemetry.flush()

    flap = faults.fire("fleet.replica_flap")
    if flap:
        # the flapping replica: SIGKILL ``after`` seconds past hello;
        # armed with times=* every respawn inherits it and flaps again
        flap_after = float(flap.get("after", 1.0))

        def _flap() -> None:
            time.sleep(flap_after)
            try:
                trace.dump("flap")
            except Exception:  # noqa: BLE001 — the kill is the point
                pass
            os.kill(os.getpid(), signal.SIGKILL)

        threading.Thread(target=_flap, daemon=True,
                         name="fault-replica-flap").start()

    counts = {"requests": 0, "request_errors": 0}
    # a lock of the port only (the reference counts through telemetry
    # alone): nothing is taken under it
    counts_lock = witness.lock("hive.stats")

    def bump(key: str) -> None:
        with counts_lock:
            counts[key] += 1

    def stats() -> Dict[str, Any]:
        models = {}
        for m in residency.models.values():
            b = m.engine.batcher if m.engine is not None else None
            models[m.name] = {
                "resident": m.resident,
                "sharded": bool(m.engine is not None
                                and m.engine.member_sharded),
                "dispatches": m.engine.dispatches if m.engine else 0,
                "rows": b.rows if b is not None else 0,
                "max_batch_rows": b.max_rows if b is not None else 0}
        with counts_lock:
            out = dict(counts)
        launches = {"lrn_fwd": lrn_cuda.lrn_fwd.launches -
                    warmup["kernel_launches"]["lrn_fwd"]}
        if learner is not None:
            launches["lrn_bwd"] = lrn_cuda.lrn_bwd.launches
            out["online"] = learner.counters()
        out.update(
            dispatches=sum(r["dispatches"] for r in models.values()),
            rows=sum(r["rows"] for r in models.values()),
            max_batch_rows=max([r["max_batch_rows"]
                                for r in models.values()] or [0]),
            spills=residency.spills,
            warmup=warmup,
            h2d_bytes=device.h2d_bytes,
            kernel_launches=launches, ledger=residency.ledger(),
            models=models)
        # the reference's answer: the telemetry snapshot, beside the keys
        # above
        out.update(telemetry.snapshot())
        return out

    stop = {"signal": None}
    stop_event = threading.Event()

    def _on_term(signum, frame) -> None:
        # flag only: the main loop owns the drain; a second signal
        # exits at once
        if stop["signal"] is not None:
            os.write(2, b"hive: second signal - hard exit\n")
            os._exit(EXIT_PREEMPTED)
        stop["signal"] = signum
        stop_event.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    hb_stop = threading.Event()

    def _hb_loop() -> None:
        n = 0
        while not hb_stop.wait(args.heartbeat_every):
            emit({"hb": n, "pid": os.getpid()})
            telemetry.maybe_flush()
            n += 1

    if args.heartbeat_every > 0:
        threading.Thread(target=_hb_loop, daemon=True,
                         name="hive-heartbeat").start()

    jobs: "queue.Queue[Optional[str]]" = queue.Queue()

    def _read_stdin() -> None:
        for line in sys.stdin:
            jobs.put(line)
        jobs.put(None)   # EOF

    threading.Thread(target=_read_stdin, daemon=True,
                     name="hive-stdin").start()

    def handle(line: str) -> bool:
        """One request line; False when the loop should end."""
        line = line.strip()
        if not line:
            return True
        try:
            job = json.loads(line)
        except ValueError:
            emit({"error": f"bad request line: {line[:120]!r}"})
            return True
        op = job.get("op")
        if op == "shutdown":
            return False
        if op == "stats":
            emit({"id": job.get("id"), "stats": stats()})
            return True
        if op == "learn":
            emit({"id": job.get("id"),
                  "learn": learner.status() if learner else {}})
            return True
        if op in ("learner_suspend", "learner_resume"):
            # a no-op acknowledgement when no learner is armed
            if learner is not None:
                if op == "learner_suspend":
                    learner.suspend()
                else:
                    learner.resume()
            emit({"id": job.get("id"), "learner_ctl": {
                "online": learner is not None,
                "suspended": bool(learner is not None
                                  and learner.suspended)}})
            return True
        if "label_of" in job:
            # late ground truth for an earlier request: no answer line
            # (an orphan only counts)
            if learner is not None:
                learner.tap.label_for(job["label_of"], job.get("label"))
            return True
        jid = job.get("id")
        bump("requests")
        telemetry.counter(events.CTR_SERVE_REQUESTS).inc()
        if faults.fire("hive.wedge", model=job.get("model")):
            # the wedge drill: the request vanishes while heartbeats and
            # stats keep flowing; the caller's deadline must catch it
            return True
        # the router's context off the wire: this process's admission
        # span parents under the sending leg, and the batcher attributes
        # queue wait and dispatch to it
        wctx = trace.from_wire(job)
        sctx = wctx.child() if wctx is not None else None
        try:
            with trace.use(sctx):
                model = job["model"]
                rows = np.asarray(job["rows"], np.float32)
                engine = residency.ensure(model)
                fut = engine.submit(rows,
                                    deadline_ms=job.get("deadline_ms"),
                                    ctx=sctx)
        except Exception as e:  # noqa: BLE001 — a bad request answers
            # with an error; the process serves on
            bump("request_errors")
            telemetry.counter(events.CTR_SERVE_REQUEST_ERRORS).inc()
            emit({"id": jid, "error": f"{type(e).__name__}: {e}"})
            return True
        if sctx is not None and sctx.sampled:
            trace.record("hive.request", ctx=sctx, model=model,
                         rows=int(len(rows)))
        if learner is not None:
            # tapped after admission: only rows the engine accepted may
            # enter the replay buffer
            learner.tap.tap(model, jid, rows, job.get("label"), ctx=sctx)

        def _deliver(f, jid=jid, model=model) -> None:
            try:
                probs = f.result()
            except DeadlineExpired as e:
                emit({"id": jid, "error": str(e), "expired": True})
                return
            except Exception as e:  # noqa: BLE001 — dispatch-side error
                bump("request_errors")
                emit({"id": jid, "error": f"{type(e).__name__}: {e}"})
                return
            probs32 = np.asarray(probs, np.float32)
            # the integrity echo: crc over the clean payload, computed
            # before any injected corruption so the router catches it
            crc = zlib.crc32(probs32.tobytes())
            payload = probs32
            if faults.fire("hive.garbage_response", model=model):
                payload = faults.rng("hive.garbage_response") \
                    .standard_normal(probs32.shape).astype(np.float32)
            emit({"id": jid, "model": model,
                  "pred": np.argmax(probs32, axis=-1).tolist(),
                  "probs": payload.tolist(),
                  "rows_n": int(len(probs32)), "crc": int(crc)})

        fut.add_done_callback(_deliver)
        return True

    while not stop_event.is_set():
        try:
            line = jobs.get(timeout=0.2)
        except queue.Empty:
            continue
        if line is None or not handle(line):   # EOF or shutdown
            break

    # -- drain: accept what is already on the wire, then let every
    # model's batcher finish its queue
    if stop_event.is_set():
        time.sleep(0.3)
    n_late = 0
    while True:
        try:
            line = jobs.get_nowait()
        except queue.Empty:
            break
        if line is not None:
            n_late += 1
            handle(line)
    if learner is not None:
        # the scavenger stops before the drain: no fine-tune step races
        # the batchers' last dispatches
        learner.stop()
    drained = residency.drain_all()
    telemetry.event(events.EV_SERVE_DRAIN, late_requests=n_late,
                    complete=bool(drained))
    reason, rc = None, 0
    if stop["signal"] is not None:
        reason, rc = signal.Signals(stop["signal"]).name, EXIT_PREEMPTED
        # the flight recorder's SIGTERM hook: the ring and the journal's
        # tail reach the disk even if the final flush below never ends
        trace.dump("sigterm")
    telemetry.event(events.EV_SERVE_SHUTDOWN, reason=reason, code=rc)
    hb_stop.set()
    telemetry.flush()
    if rc:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    residency.close()
    return 0

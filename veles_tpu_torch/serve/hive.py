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

``crc`` is the crc32 of the float32 probability payload.  ``stats``
carries the port's own counters: ``requests``, ``request_errors``,
``dispatches``, ``rows``, ``max_batch_rows``, ``spills``,
``kernel_launches`` (``{"lrn_fwd": n}``) and per-model rows.  Not in
this slice (argparse rejects them): ``--online``, ``--mesh``,
``--metrics-dir``.
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
    ``pristine`` + the package's config files, builds the entry's
    workflow, gives its forwards their shapes, and pairs the forward
    chain with the members converted to the port's layout."""
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
        meta={"workflow": w, "version": manifest.get("version")},
        sample_shape=tuple(w.loader.sample_shape))


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
    p.add_argument("--install-dir", default=None,
                   help="package install directory (default: a temp "
                        "dir)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import lrn_cuda
    from veles_tpu_torch.serve.residency import ResidencyManager

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.INFO, stream=sys.stderr)
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

    device = make_device(args.backend)
    residency = ResidencyManager(
        device, budget_bytes=args.hbm_budget or None,
        max_batch=max(1, args.max_batch),
        max_wait_s=max(0.0, args.max_wait_ms) / 1000.0)
    pristine = copy.deepcopy(dict(root.__dict__))
    for name, path in specs:
        residency.register(load_model_package(name, path, device,
                                              install_dir, pristine))
        # admit eagerly in CLI order: the budget may spill the colder
        # ones right back
        residency.ensure(name)

    emit_lock = threading.Lock()

    def emit(obj: Dict[str, Any]) -> None:
        line = json.dumps(obj)
        with emit_lock:
            print(line, flush=True)

    emit({
        "ready": True, "pid": os.getpid(),
        "backend": device.backend_name, "platform": device.platform,
        "max_batch": residency.max_batch,
        "max_wait_ms": residency.max_wait_s * 1000.0,
        "online": False, "devices": 1,
        "device_budget": residency.budget_bytes,
        "models": {
            m.name: {"members": len(m.member_params),
                     "param_bytes": m.param_bytes,
                     "resident": m.resident, "sharded": False,
                     "version": m.meta.get("version")}
            for m in residency.models.values()},
    })

    counts = {"requests": 0, "request_errors": 0}
    counts_lock = threading.Lock()

    def bump(key: str) -> None:
        with counts_lock:
            counts[key] += 1

    def stats() -> Dict[str, Any]:
        models = {}
        for m in residency.models.values():
            b = m.engine.batcher if m.engine is not None else None
            models[m.name] = {
                "resident": m.resident,
                "dispatches": m.engine.dispatches if m.engine else 0,
                "rows": b.rows if b is not None else 0,
                "max_batch_rows": b.max_rows if b is not None else 0}
        with counts_lock:
            out = dict(counts)
        out.update(
            dispatches=sum(r["dispatches"] for r in models.values()),
            rows=sum(r["rows"] for r in models.values()),
            max_batch_rows=max([r["max_batch_rows"]
                                for r in models.values()] or [0]),
            spills=residency.spills,
            h2d_bytes=device.h2d_bytes,
            kernel_launches={"lrn_fwd": lrn_cuda.lrn_fwd.launches},
            models=models)
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
        jid = job.get("id")
        bump("requests")
        try:
            model = job["model"]
            rows = np.asarray(job["rows"], np.float32)
            engine = residency.ensure(model)
            fut = engine.submit(rows, deadline_ms=job.get("deadline_ms"))
        except Exception as e:  # noqa: BLE001 — a bad request answers
            # with an error; the process serves on
            bump("request_errors")
            emit({"id": jid, "error": f"{type(e).__name__}: {e}"})
            return True

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
            emit({"id": jid, "model": model,
                  "pred": np.argmax(probs32, axis=-1).tolist(),
                  "probs": probs32.tolist(),
                  "rows_n": int(len(probs32)),
                  "crc": int(zlib.crc32(probs32.tobytes()))})

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
    while True:
        try:
            line = jobs.get_nowait()
        except queue.Empty:
            break
        if line is not None:
            handle(line)
    residency.drain_all()
    hb_stop.set()
    if stop["signal"] is not None:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_PREEMPTED)
    residency.close()
    return 0

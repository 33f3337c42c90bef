"""Genome evaluation workers (the port's counterpart of
``veles_tpu/genetics/worker.py``).

One-shot mode, the CPU fan-out's unit::

    python -m veles_tpu_torch.genetics.worker workflow.py [config.py ...]
        [root.x=v ...] --values '<json {path: value}>' [-b cpu] [-s SEED]

trains ONE genome (its Tune markers substituted) and prints
``{"fitness": <best validation n_err>}``.  The process boundary isolates
the global ``root`` and any crash.

Serve mode, the evaluator that owns the card::

    python -m veles_tpu_torch.genetics.worker --serve workflow.py [...]
        -b cuda [-s SEED] [--cohort N] [--dp N]

makes the device ONCE and announces it with a hello line (``{"ready":
true, "pid", "backend", "platform", "is_accelerator", "device"}``, read
from the device it actually got; ``-b cuda`` without a card dies before
the hello), then answers JSON jobs on stdin: ``{"id", "values", "seed"}``
with ``{"id", "fitness", "pid"}``, and a cohort ``{"id", "members":
[values, ...], "seed"}`` with ``{"id", "fitnesses", "fallbacks",
"stats", "pid"}`` (or ``{"id", "error"}``: a bad genome never kills the
evaluator).  Before every job the pristine config tree is restored, then
the config files, the overrides and the genome's values are applied:
the isolation a process per genome gives.  A daemon thread prints
``{"hb": n, "pid", "job"}`` every ``--heartbeat-every`` seconds.

A cohort (``_evaluate_cohort``) first builds each member's workflow on
the host to read its per-layer rates and decays; a member whose build
fails, or whose structure differs from the first member's, scores inf
alone.  The rest train as ``PopulationTrainEngine`` chunks, capped by
the card's memory (``TorchDevice.total_memory``, :func:`_hbm_cohort_cap`).
A chunk that fails (``torch.cuda.OutOfMemoryError`` included) is split
in half and retried, and a failing singleton is trained per genome: the
reference's semantics for a bad genome.  Every such split and
per-genome fallback is counted in the result's ``fallbacks``.  Each
trained chunk adds ``{"members", "seconds", "minibatches", "places",
"cap", "change_norms", "kernel_launches"}`` to the result's ``stats``:
``change_norms`` is each member's (P, leaves) distance from its start
(``PopulationTrainEngine.change_norms``), which a fitness that did not
move cannot show, and ``kernel_launches`` the LRN kernels' launches
during its run.

``--dp N`` member-shards every cohort over a mesh of N places of this
one process (``parallel/mesh.py`` ``make_mesh``; the reference's
``worker.py:198-211``): P/N members a place, the cohort cap N times one
place's (one place's budget is its card's memory over the places that
card holds, ``$VELES_MESH_RANKS_PER_CARD``), unless
``$VELES_MESH_SHARD_MEMBERS`` says never.  Fewer cards than the mesh
needs: exit 2 naming the knob.  The hello carries ``places``.

Telemetry: each job is the ``evaluator.job_seconds`` span (journalled)
and counts into ``evaluator.jobs`` / ``evaluator.job_errors``; the
process flushes its snapshot after the hello and after every job,
before its result line, so the pool merges a dead evaluator's numbers
at most one genome stale.  Fault points (``job``, ``seq``: the job's
ordinal in this evaluator, ``gen``): ``evaluator.hang`` stalls a job
``seconds`` (3600), its heartbeats silenced too with ``silent=1``;
``evaluator.garbage_line`` prints a line of garbage before a result.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import logging
import os
import sys
import threading
import time
from typing import Any

from veles_tpu_torch import knobs

log = logging.getLogger("veles.genetics.worker")

#: the memory budget where the device reports no size (the CPU)
HOST_BUDGET = 8 << 30


def _split_files(files):
    overrides = [a for a in files if a.startswith("root.") and "=" in a]
    workflow_file, *config_files = [a for a in files if a not in overrides]
    return workflow_file, config_files, overrides


def _evaluate(workflow_file: str, backend: str, seed: int) -> float:
    """One genome's training run -> its fitness.  ``root`` must already
    hold the substituted config."""
    from veles_tpu_torch.launcher import (Launcher, drive_workflow,
                                          workflow_fitness)
    launcher = Launcher(backend=backend, seed=seed)
    try:
        drive_workflow(launcher, workflow_file)
        return workflow_fitness(launcher.workflow)
    finally:
        _release(launcher)


def _release(launcher) -> None:
    """Drop a finished genome's device tensors: an evaluator lives
    through many generations, and device memory must not accumulate."""
    import torch
    launcher.workflow = None
    gc.collect()
    if launcher.device.platform == "cuda":
        torch.cuda.empty_cache()


def _rebuild_root(pristine, config_files, overrides, values) -> None:
    """The config tree of one genome: pristine -> config files ->
    overrides -> Tune substitution."""
    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.genetics import substitute_tunes
    from veles_tpu_torch.launcher import apply_config_file
    root.__dict__.clear()
    root.__dict__.update(copy.deepcopy(pristine))
    for cf in config_files:
        apply_config_file(cf)
    parse_overrides(overrides)
    substitute_tunes(root, values)


class _CohortTooBig(Exception):
    """The chunk is over the memory budget; carries the admissible cap."""

    def __init__(self, cap: int) -> None:
        super().__init__(f"cohort over the device memory budget; cap {cap}")
        self.cap = max(1, cap)


def _hbm_cohort_cap(workflow, requested: int, mesh: Any = None) -> int:
    """The most members one cohort may stack.  A member holds about four
    param-sized f32 buffers (params, velocities, the compute-dtype cast,
    the gradients); half the device's memory (``total_memory``, else
    HOST_BUDGET) is left to the data set and the activations.
    ``requested`` > 0 caps it further.  On a ``mesh`` of N places the
    budget is one place's (``Mesh.place_memory``, else HOST_BUDGET), N
    times over unless ``$VELES_MESH_SHARD_MEMBERS`` says never: each
    place stacks only P/N members."""
    import numpy as np
    param_bytes = 0
    for f in workflow.forwards:
        if f.input_shape is None:
            continue
        for shape in f.param_shapes(f.input_shape).values():
            param_bytes += int(np.prod(shape)) * 4
    per_member = max(param_bytes * 4, 1)
    if mesh is not None and mesh.size > 1:
        from veles_tpu_torch.parallel.mesh import shard_mode
        budget = mesh.place_memory() or HOST_BUDGET
        if shard_mode(knobs.get(knobs.MESH_SHARD_MEMBERS)) != "never":
            budget *= mesh.size
    else:
        budget = workflow.device.total_memory() or HOST_BUDGET
    cap = max(1, (budget // 2) // per_member)
    if requested:
        cap = min(cap, max(1, requested))
    return cap


def _mesh(args):
    """The mesh of ``--dp`` places (None for one device)."""
    dp = int(getattr(args, "dp", 0) or 0)
    if dp < 2:
        return None
    from veles_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(dp, args.backend)


def _structure_sig(workflow):
    """The layer configs without the liftable hyperparameters: members
    of one cohort must agree on it, since the engine trains every member
    at the first member's shapes."""
    from veles_tpu_torch.genetics.core import LIFTABLE_HYPERS
    sig = []
    for cfg in getattr(workflow, "layers_config", []):
        back = {k: v for k, v in dict(cfg.get("<-", {})).items()
                if k not in LIFTABLE_HYPERS}
        sig.append((cfg.get("type"),
                    repr(sorted(dict(cfg.get("->", {})).items())),
                    repr(sorted(back.items()))))
    return tuple(sig)


def _train_cohort_chunk(create, pristine, config_files, overrides, args,
                        members, hypers, idxs, seed, stats):
    """Train one same-signature chunk with the population engine;
    returns its fitnesses in ``idxs`` order.  Raises _CohortTooBig when
    the memory budget asks for a split first."""
    import numpy as np

    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import lrn_cuda
    from veles_tpu_torch.ops.fused import PopulationTrainEngine

    _rebuild_root(pristine, config_files, overrides, members[idxs[0]])
    launcher = Launcher(backend=args.backend, seed=seed)
    engine = None
    try:
        launcher.create_workflow(create)
        launcher.initialize()
        w = launcher.workflow
        mesh = _mesh(args)
        cap = _hbm_cohort_cap(w, args.cohort, mesh)
        if len(idxs) > cap:
            raise _CohortTooBig(cap)
        engine = PopulationTrainEngine(
            w, np.stack([hypers[i][0] for i in idxs]),
            np.stack([hypers[i][1] for i in idxs]), mesh=mesh)
        launches = (lrn_cuda.lrn_fwd.launches, lrn_cuda.lrn_bwd.launches)
        fits = [float(f) for f in engine.run()]
        stats.append({"members": len(idxs), "seconds": engine.seconds,
                      "minibatches": engine.minibatches,
                      "places": len(engine.placement.places), "cap": cap,
                      "change_norms": engine.change_norms().tolist(),
                      "kernel_launches": {
                          "lrn_fwd": lrn_cuda.lrn_fwd.launches - launches[0],
                          "lrn_bwd": lrn_cuda.lrn_bwd.launches -
                          launches[1]}})
        return fits
    finally:
        if engine is not None:
            engine.release()
        _release(launcher)


def _evaluate_cohort(workflow_file, config_files, overrides, pristine, args,
                     members, seed):
    """One same-signature cohort -> (fitnesses, fallbacks, stats).

    Each member is built on the host first, to read its gradient units'
    rates and decays; one whose build fails or whose structure differs
    scores inf alone.  The valid members train in chunks; a failing
    chunk splits in half, a failing singleton trains per genome, and
    each split or per-genome fallback adds one to ``fallbacks``."""
    import numpy as np

    from veles_tpu_torch import prng
    from veles_tpu_torch.launcher import load_workflow_module

    create = getattr(load_workflow_module(workflow_file),
                     "create_workflow", None)
    if create is None:
        raise RuntimeError(f"{workflow_file}: cohort evaluation needs "
                           f"create_workflow(launcher)")

    class _FL:
        workflow = None

    n = len(members)
    fits = [float("inf")] * n
    hypers = [None] * n
    sig_ref = None
    valid = []
    for i, values in enumerate(members):
        try:
            _rebuild_root(pristine, config_files, overrides, values)
            prng.seed_all(seed)
            w = create(_FL())
            sig = (len(w.gds), _structure_sig(w))
            if sig_ref is None:
                sig_ref = sig
            elif sig != sig_ref:
                raise ValueError("model structure differs from the "
                                 "cohort's first member")
            hypers[i] = (
                np.asarray([[gd.learning_rate, gd.learning_rate_bias]
                            if gd is not None else [0.0, 0.0]
                            for gd in w.gds], np.float32),
                np.asarray([[gd.weight_decay, gd.weight_decay_bias]
                            if gd is not None else [0.0, 0.0]
                            for gd in w.gds], np.float32))
            valid.append(i)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — a bad gene scores inf
            log.warning("cohort member %d invalid (%s: %s); scoring inf",
                        i, type(e).__name__, e)
    fallbacks = 0
    stats: list = []
    pending = [valid] if valid else []
    while pending:
        idxs = pending.pop(0)
        try:
            chunk = _train_cohort_chunk(create, pristine, config_files,
                                        overrides, args, members, hypers,
                                        idxs, seed, stats)
            for i, f in zip(idxs, chunk):
                fits[i] = f
        except KeyboardInterrupt:
            raise
        except _CohortTooBig as e:
            log.info("cohort of %d over the memory budget; chunking at %d",
                     len(idxs), e.cap)
            pending = [idxs[j:j + e.cap]
                       for j in range(0, len(idxs), e.cap)] + pending
        except Exception as e:  # noqa: BLE001 — split, never crash
            fallbacks += 1
            if len(idxs) == 1:
                log.warning("cohort singleton %d failed batched (%s: %s); "
                            "training it per genome", idxs[0],
                            type(e).__name__, e)
                try:
                    _rebuild_root(pristine, config_files, overrides,
                                  members[idxs[0]])
                    fits[idxs[0]] = _evaluate(workflow_file, args.backend,
                                              seed)
                except KeyboardInterrupt:
                    raise
                except Exception as e2:  # noqa: BLE001
                    log.warning("per-genome run of member %d failed too "
                                "(%s); scoring inf", idxs[0], e2)
            else:
                half = len(idxs) // 2
                log.warning("cohort chunk of %d failed (%s: %s); splitting "
                            "and retrying", len(idxs), type(e).__name__, e)
                pending = [idxs[:half], idxs[half:]] + pending
    return fits, fallbacks, stats


def serve(args) -> int:
    """The evaluator loop: one device for the whole GA run."""
    from veles_tpu_torch import events, faults, telemetry, trace
    from veles_tpu_torch.analysis import witness
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    workflow_file, config_files, overrides = _split_files(args.files)
    # the config tree BEFORE any config file ran: each job rebuilds root
    # from here, so no substitution leaks into the next
    pristine = copy.deepcopy(dict(root.__dict__))
    try:
        mesh = _mesh(args)
    except ValueError as e:
        print(f"--dp {args.dp}: {e}", file=sys.stderr)
        return 2
    device = make_device(args.backend)
    hello = {"ready": True, "pid": os.getpid(),
             "backend": device.backend_name, "platform": device.platform,
             "is_accelerator": device.platform == "cuda",
             "device": _device_name(device),
             "places": mesh.size if mesh is not None else 1}
    # one lock for every protocol line: the heartbeat thread must never
    # interleave bytes into a result
    emit_lock = witness.lock("worker.emit")

    def emit(obj) -> None:
        with emit_lock:
            print(json.dumps(obj), flush=True)

    emit(hello)
    telemetry.flush()   # even a job-less evaluator leaves a snapshot
    hb_state = {"job": None, "silent": False}
    hb_stop = threading.Event()

    def hb_loop() -> None:
        n = 0
        while not hb_stop.wait(args.heartbeat_every):
            if hb_state["silent"]:
                continue
            emit({"hb": n, "pid": os.getpid(), "job": hb_state["job"]})
            n += 1

    if args.heartbeat_every > 0:
        threading.Thread(target=hb_loop, daemon=True,
                         name="serve-heartbeat").start()
    seq = 0   # the job's ordinal in this evaluator's life
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        job = json.loads(line)
        if job.get("op") == "shutdown":
            break
        result = {"id": job["id"], "pid": os.getpid()}
        hb_state["job"] = job["id"]
        fault_ctx = {"job": job["id"], "seq": seq}
        if "gen" in job:
            fault_ctx["gen"] = job["gen"]
        seq += 1
        seed = int(job.get("seed", args.seed))
        telemetry.counter(events.CTR_EVALUATOR_JOBS).inc()
        # the pool's per-job trace root off the wire: under a child span
        # of it every journaled event of the job (its span included)
        # carries the trace
        wctx = trace.from_wire(job)
        try:
            with trace.use(wctx.child() if wctx is not None else None), \
                    telemetry.span(events.SPAN_EVALUATOR_JOB_SECONDS,
                                   journal=True, job=job["id"],
                                   cohort=len(job.get("members", []))
                                   or None):
                hang = faults.fire("evaluator.hang", **fault_ctx)
                if hang:
                    # a stall mid-genome: heartbeats go on unless the
                    # drill asked for a wedged process (silent)
                    hb_state["silent"] = bool(hang.get("silent"))
                    faults.hang(float(hang.get("seconds", 3600.0)))
                    hb_state["silent"] = False
                if "members" in job:
                    fits, fallbacks, stats = _evaluate_cohort(
                        workflow_file, config_files, overrides, pristine,
                        args, job["members"], seed)
                    result.update(fitnesses=fits, fallbacks=fallbacks,
                                  stats=stats)
                else:
                    _rebuild_root(pristine, config_files, overrides,
                                  job["values"])
                    result["fitness"] = _evaluate(workflow_file,
                                                  args.backend, seed)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — bad genes score inf at
            # the parent; the evaluator outlives them
            result["error"] = f"{type(e).__name__}: {e}"
            telemetry.counter(events.CTR_EVALUATOR_JOB_ERRORS).inc()
        hb_state["job"] = None
        # before the result line: once the parent has it, it may kill
        # and merge at any time
        telemetry.flush()
        if faults.fire("evaluator.garbage_line", **fault_ctx):
            # a torn protocol line: the pool must read it as noise and
            # proof of life, never as a result
            with emit_lock:
                print(faults.garbage_text(point="evaluator"), flush=True)
        emit(result)
    hb_stop.set()
    return 0


def _device_name(device) -> str:
    if device.platform == "cuda":
        import torch
        return torch.cuda.get_device_name(device.device)
    return "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="veles_tpu_torch.genetics.worker")
    p.add_argument("files", nargs="+")
    p.add_argument("--values", default=None,
                   help="JSON {tune_path: value} (one-shot mode)")
    p.add_argument("--serve", action="store_true",
                   help="the evaluator that owns the device: genome jobs "
                        "as JSON lines on stdin, results on stdout")
    p.add_argument("--cohort", type=int, default=0,
                   help="serve mode: the most members of one cohort "
                        "(0: the device memory budget alone decides)")
    p.add_argument("--dp", type=int, default=0,
                   help="serve mode: member-shard every cohort over a mesh "
                        "of N places of this process (P/N members a "
                        "place; the cohort cap N times one place's)")
    p.add_argument("--heartbeat-every", type=float,
                   default=float(knobs.get(knobs.HEARTBEAT_EVERY)),
                   help="serve mode: seconds between heartbeat lines "
                        "(0 disables)")
    p.add_argument("-b", "--backend", default="auto")
    p.add_argument("-s", "--seed", type=int, default=1234)
    args = p.parse_args(argv)
    # genome workers are the GA's children: a signal kills them plainly
    # and the parent's retry/inf contract handles it
    os.environ[knobs.PREEMPT_DISABLE] = "1"
    if args.serve:
        return serve(args)
    if args.values is None:
        p.error("--values is required without --serve")

    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.genetics import substitute_tunes
    from veles_tpu_torch.launcher import apply_config_file

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    workflow_file, config_files, overrides = _split_files(args.files)
    for cf in config_files:
        apply_config_file(cf)
    parse_overrides(overrides)
    substitute_tunes(root, json.loads(args.values))
    t0 = time.perf_counter()
    try:
        fitness = _evaluate(workflow_file, args.backend, args.seed)
    except RuntimeError as e:
        if "defines neither" in str(e):
            print(str(e), file=sys.stderr)
            return 2
        raise
    print(json.dumps({"fitness": fitness,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

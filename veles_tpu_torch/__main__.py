"""The port's command line.

    python -m veles_tpu_torch [--supervise] [-b auto|cuda|cpu] [-s SEED]
        [--dp N] [--multihost] [--listen-address ADDR | --master-address ADDR]
        [--snapshot FILE] [--profile DIR] [--metrics-dir DIR]
        [--log-events FILE] [-p] [--plots-endpoint ENDPOINT]
        [--status-server URL] [-v] [--dump-config] WORKFLOW.py
        [CONFIG.py ...] [root.x.y=value ...]
    python -m veles_tpu_torch --optimize POP:GEN [-b auto|cuda|cpu|
        cuda-evaluator|cpu-evaluator] [--ga-workers N] [--ga-cohort N]
        [--ga-state FILE] [--ga-eval-timeout S] [--heartbeat-deadline S]
        WORKFLOW.py [CONFIG.py ...] [root.x.y=value ...]
    python -m veles_tpu_torch [--ensemble-train N] [--ensemble-test]
        [--ensemble-file FILE] [--ensemble-device auto|host] [-b ...]
        WORKFLOW.py [CONFIG.py ...]
    python -m veles_tpu_torch --serve-models NAME=PKG.vpkg [NAME=PKG ...]
        [-b auto|cuda|cpu] [--max-batch N] [--max-wait-ms MS]
        [--metrics-dir DIR]
    python -m veles_tpu_torch --serve-fleet N NAME=PKG.vpkg [NAME=PKG ...]
        [-b auto|cuda|cpu] [--canary CNAME=PRIMARY[:FRACTION]] [--hot NAME]
        [--max-batch N] [--max-wait-ms MS] [--hbm-budget BYTES]
        [--slo-p99-ms MS] [--max-inflight N] [--deadline-ms MS]
        [--metrics-dir DIR]

The first trains: config files run in order, then the ``root.*``
overrides, then the launcher drives the workflow file (its
``run(launcher)`` or ``create_workflow(launcher)``) on the card, or on
the CPU with ``-b cpu``.  ``--snapshot FILE`` resumes the run pickled
in FILE (or, if FILE is torn, its newest intact sibling); a snapshot
that cannot be read is a usage error (exit 2).  SIGTERM or SIGINT stops
the run before its next firing, writes a final snapshot and exits 14.
``--supervise`` runs the same command as a child and resumes it from
its newest intact snapshot (a GA: its ``--ga-state``) whenever it ends
early (``veles_tpu_torch/supervisor.py``).  ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the run and its per-layer FLOPs table
(``flops_table.json``) into DIR.  ``--metrics-dir DIR`` persists the
run's telemetry in DIR (``metrics-<pid>.json`` snapshots and
``journal-<pid>.jsonl``, the reference's formats; exported as
``$VELES_METRICS_DIR``, so GA evaluators and a supervised child write
there too), and ``--log-events FILE`` appends every ``veles.*`` log
record to FILE as one JSON line.  ``python -m
veles_tpu_torch.tools.obs_report DIR`` renders such a dir.  ``-p``
renders the standard plots (error and loss curves, the confusion
matrix, the first layer's weights) once per epoch to
``$VELES_PLOTS_DIR`` (``plots``), and ``--plots-endpoint ENDPOINT``
also publishes them on a zmq PUB socket for
``python -m veles_tpu_torch.graphics_client``; ``-p`` needs
``matplotlib`` and ``--plots-endpoint`` ``zmq``, and each is refused
(exit 2, naming the package) where it does not import, before anything
touches the card.  ``--status-server URL`` POSTs the run's status after
every epoch to a web status page (``python -m
veles_tpu_torch.web_status``).  ``-v`` logs at DEBUG, and
``--dump-config`` prints the configuration tree after the config files
and overrides, and exits.

``--dp N`` trains data parallel over N ranks on this host
(``veles_tpu_torch/parallel/``): the command starts N processes of
itself with ``--multihost`` and a local rendezvous
(``launcher.run_ranks``), each on its own card (``cuda:LOCAL_RANK``,
NCCL) or, with ``$VELES_MESH_RANKS_PER_CARD=N``, N of them on one card
(gloo), or on the CPU with ``-b cpu`` (gloo); fewer cards than that
needs is refused (exit 2) before anything starts.  ``--multihost``
joins a group from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): ``torchrun
--nnodes H --nproc-per-node C -m veles_tpu_torch --multihost ...`` on
every host.  A rank whose peer died exits 13 after a final snapshot;
``--supervise`` resumes 13 as it resumes 14.

``--listen-address ADDR`` runs the workflow as the master of the
master--slave mode (``veles_tpu_torch/server.py``: it owns the params
and issues one-minibatch jobs), and ``--master-address ADDR`` as a slave
of the master at ADDR (``client.py``: it computes jobs with the fused
step on its device), each over zmq (``tcp://host:port``); either flag is
refused (exit 2, naming ``zmq``) where zmq does not import.  As the
reference's: a master computes nothing, so ``--dp`` does not shard it
(one process runs); a slave with ``--dp N`` or ``--multihost`` is one
slave computing each job data parallel over its group.  A master with
``--multihost`` is refused (exit 2): every process of the group would
bind the one address.

``--optimize POP:GEN`` tunes the config values wrapped in ``Tune(...)``
(``veles_tpu_torch/genetics/``): a population of POP genomes for GEN
generations, each genome's fitness its best validation ``n_err``.
Execution modes, by ``-b``:

    cpu             one ``genetics.worker --values`` subprocess per
                    genome on the CPU, ``--ga-workers`` at a time
    auto, cuda      ONE evaluator process (``genetics.worker --serve -b
                    cuda``) owns the card, ``--ga-workers`` host threads
                    feed it, and genomes of one shape signature train as
                    one cohort (``--ga-cohort 1``: per genome).  Without
                    a card, or if the evaluator does not come up, the run
                    exits 1 naming the card: there is no CPU fallback
    cuda-evaluator, the same evaluator mode on the named device
    cpu-evaluator

``--ga-state FILE`` checkpoints every generation and resumes from an
existing FILE; SIGTERM/SIGINT stops at the next generation boundary and
exits 14.  ``--ensemble-train N`` trains N members (seeds ``seed +
7919 i``) and saves them to ``--ensemble-file`` (``ensemble.npz``);
``--ensemble-test`` loads them and reports the averaged members'
validation error, through the engine on the run's device
(``--ensemble-device auto``) or the CPU member loop (``host``).  The
fourth form starts the serving process (``veles_tpu_torch/serve/hive.py``),
the last a fleet of N of them behind one router
(``veles_tpu_torch/serve/router.py``: placement, failover, hedging,
ejection, admission control).  Not ported yet, and so refused: ``--dp``
or ``--multihost`` with ``--optimize`` or ``--ensemble-*`` (exit 2), and
the fleet's ``--mesh``.
"""

from __future__ import annotations

import argparse
import atexit
import json
import logging
import os
import sys
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="Train a workflow with the PyTorch/CUDA port "
                    "(--serve-models NAME=PKG starts the serving "
                    "process instead)")
    p.add_argument("files", nargs="+",
                   help="workflow file, then config files")
    p.add_argument("-b", "--backend", default="auto",
                   choices=["auto", "cuda", "cpu", "cuda-evaluator",
                            "cpu-evaluator"],
                   help="auto|cuda (CUDA device 0; fails without one) or "
                        "cpu; cuda-evaluator and cpu-evaluator are "
                        "--optimize only: one evaluator process on the "
                        "named device")
    p.add_argument("-s", "--seed", type=int, default=1234)
    p.add_argument("--dp", type=int, default=None, metavar="N",
                   help="train data parallel over N ranks on this host "
                        "(one process each)")
    p.add_argument("--multihost", action="store_true",
                   help="join a data-parallel group from torchrun's "
                        "environment (MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE, RANK, LOCAL_RANK)")
    p.add_argument("--master-address", default=None, metavar="ADDR",
                   help="run as a slave of the master at ADDR (zmq, "
                        "tcp://host:port); needs zmq")
    p.add_argument("--listen-address", default=None, metavar="ADDR",
                   help="run as the master, listening at ADDR (zmq, "
                        "tcp://host:port); needs zmq")
    p.add_argument("--snapshot", default=None, metavar="FILE",
                   help="resume from this snapshot")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run and a "
                        "per-layer FLOPs table into DIR")
    p.add_argument("--metrics-dir", default=None, metavar="DIR",
                   help="write per-process telemetry snapshots "
                        "(metrics-<pid>.json) and the run journal "
                        "(journal-<pid>.jsonl) into DIR; exported as "
                        "$VELES_METRICS_DIR so child processes write "
                        "there too")
    p.add_argument("--log-events", default=None, metavar="FILE",
                   help="append every log record to FILE as JSON lines")
    p.add_argument("--optimize", default=None, metavar="POP:GEN",
                   help="GA-tune the config values wrapped in Tune(...): "
                        "population size : generations (e.g. 8:5)")
    p.add_argument("--ga-workers", type=int, default=0,
                   help="parallel GA workers (0: up to 4).  With -b cpu "
                        "genome subprocesses; in the evaluator modes host "
                        "threads that feed the one evaluator")
    p.add_argument("--ga-eval-timeout", "--eval-timeout", type=float,
                   default=3600, dest="ga_eval_timeout",
                   help="seconds before a genome's run is killed and "
                        "scored inf (default 3600); the evaluator also "
                        "has an adaptive per-genome deadline")
    p.add_argument("--heartbeat-deadline", type=float, default=60,
                   help="evaluator modes: seconds of evaluator silence "
                        "before it is declared hung and replaced "
                        "(default 60; 0 disables)")
    p.add_argument("--ga-cohort", type=int, default=0,
                   help="evaluator modes: the most genomes of one shape "
                        "signature trained as one cohort (0: the device "
                        "memory decides; 1: per genome)")
    p.add_argument("--ga-state", default=None, metavar="FILE",
                   help="per-generation GA checkpoint; an existing FILE "
                        "resumes the run")
    p.add_argument("--ensemble-train", type=int, default=None, metavar="N",
                   help="train N ensemble members (the workflow file must "
                        "expose create_workflow) into --ensemble-file")
    p.add_argument("--ensemble-test", action="store_true",
                   help="load --ensemble-file and report the averaged "
                        "members' validation error")
    p.add_argument("--ensemble-file", default="ensemble.npz",
                   metavar="FILE",
                   help="the members file of --ensemble-train/-test "
                        "(default ensemble.npz)")
    p.add_argument("--ensemble-device", default="auto",
                   choices=["auto", "host"],
                   help="--ensemble-test: 'auto' predicts with the engine "
                        "on the run's device, 'host' with the CPU member "
                        "loop (the oracle)")
    p.add_argument("-p", "--plotters", action="store_true",
                   help="render per-epoch plots (error and loss curves, "
                        "confusion, weight tiles) to $VELES_PLOTS_DIR; "
                        "needs matplotlib")
    p.add_argument("--plots-endpoint", default=None,
                   help="also publish plot events on this zmq PUB "
                        "endpoint for graphics_client viewers (implies "
                        "-p); needs zmq")
    p.add_argument("--status-server", default=None, metavar="URL",
                   help="POST the run's status after every epoch to this "
                        "web status page (http://host:port)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="log at DEBUG")
    p.add_argument("--dump-config", action="store_true",
                   help="print the configuration tree and exit")
    return p


def missing_plot_packages(args) -> Optional[str]:
    """The message refusing ``-p`` without matplotlib or
    ``--plots-endpoint`` without zmq; None when both import."""
    need = []
    if args.plotters or args.plots_endpoint:
        need.append(("matplotlib", "-p"))
    if args.plots_endpoint:
        need.append(("zmq", "--plots-endpoint"))
    for package, flag in need:
        try:
            __import__(package)
        except ImportError as e:
            return (f"{flag} needs {package}, which does not import "
                    f"here ({e})")
    return None


def refused_master_slave(args) -> Optional[str]:
    """The message refusing ``--listen-address`` / ``--master-address``
    without zmq, or a master with ``--multihost``; None when they may
    start (or are not given)."""
    flags = [f for f, on in (("--listen-address", args.listen_address),
                             ("--master-address", args.master_address))
             if on]
    if not flags:
        return None
    try:
        __import__("zmq")
    except ImportError as e:
        return (f"{' / '.join(flags)} needs zmq, which does not import "
                f"here ({e})")
    if args.listen_address and not args.master_address and args.multihost:
        return ("--listen-address with --multihost is refused: every "
                "process of the group would bind the one address, and a "
                "master computes nothing to share")
    return None


def _is_master(args) -> bool:
    return bool(args.listen_address) and not args.master_address


def refused_parallel(args) -> Optional[str]:
    """The message refusing a data-parallel command line the port does
    not run, or one whose cards are missing; None when it may start.
    ``--dp`` with ``--optimize``, ``--ensemble-*`` or ``-b *-evaluator``
    exits 2, a deliberate deviation: the reference shards none of these
    and ignores ``--dp`` there (``veles_tpu/__main__.py:200-212``; its
    evaluator command, ``:432-436``, passes no ``--dp``).  Member-sharded
    cohorts run in the GA evaluator, ``python -m
    veles_tpu_torch.genetics.worker --serve --dp N``."""
    if args.dp is None and not args.multihost:
        return None
    if args.dp is not None and args.dp < 1:
        return f"--dp {args.dp}: N must be at least 1"
    for flag, on in (("--optimize", args.optimize),
                     ("--ensemble-train / --ensemble-test",
                      args.ensemble_train is not None or args.ensemble_test),
                     ("-b " + args.backend,
                      args.backend.endswith("-evaluator"))):
        if on:
            return (f"--dp / --multihost with {flag} is refused: data "
                    f"parallelism does not shard that path (the reference "
                    f"ignores --dp there); member-sharded cohorts run in "
                    f"the GA evaluator, python -m "
                    f"veles_tpu_torch.genetics.worker --serve --dp N")
    if args.dp and args.dp > 1 and not args.multihost \
            and not _is_master(args):
        from veles_tpu_torch.parallel.mesh import check_cards
        try:
            check_cards(args.dp, args.backend)
        except ValueError as e:
            return f"--dp {args.dp}: {e}"
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve-models" in argv:
        from veles_tpu_torch.serve import hive
        return hive.main([a for a in argv if a != "--serve-models"])
    if "--serve-fleet" in argv:
        # N hive replicas behind one router; the replica count is the
        # first positional
        from veles_tpu_torch.serve import router
        return router.main([a for a in argv if a != "--serve-fleet"])
    if "--supervise" in argv:
        from veles_tpu_torch import supervisor
        logging.basicConfig(level=logging.INFO,
                            format="%(levelname)s %(name)s: %(message)s")
        return supervisor.run([a for a in argv if a != "--supervise"])
    from veles_tpu_torch.config import is_override, parse_overrides

    # root.* overrides may appear anywhere and apply after config files
    overrides = [a for a in argv if is_override(a)]
    args = build_parser().parse_args([a for a in argv
                                      if a not in overrides])
    refused = missing_plot_packages(args) or refused_master_slave(args) \
        or refused_parallel(args)
    if refused:
        print(refused, file=sys.stderr)
        return 2
    level = logging.DEBUG if args.verbose else logging.INFO
    logging.basicConfig(level=level,
                        format="%(levelname)s %(name)s: %(message)s")
    if _is_master(args) and args.dp is not None and args.dp > 1:
        logging.getLogger("veles.launcher").info(
            "--dp %d: a master computes nothing; one process serves the "
            "jobs", args.dp)
        args.dp = None
    if args.dp is not None and args.dp > 1 and not args.multihost:
        from veles_tpu_torch.launcher import run_ranks
        return run_ranks(argv, args.dp)
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.logger import add_jsonl_sink, setup_logging
    setup_logging(level)
    if args.log_events:
        atexit.register(add_jsonl_sink(args.log_events))
    if args.metrics_dir:
        telemetry.configure(args.metrics_dir)

    from veles_tpu_torch.launcher import (Launcher, apply_config_file,
                                          drive_workflow)
    from veles_tpu_torch.snapshotter import SnapshotCorruptError
    workflow_file, *config_files = args.files
    for cf in config_files:
        apply_config_file(cf)
    parse_overrides(overrides)
    if args.dump_config:
        from veles_tpu_torch.config import root
        root.print_()
        return 0
    if args.plots_endpoint:
        from veles_tpu_torch import graphics_server
        graphics_server.get_server().endpoint = args.plots_endpoint
        graphics_server.get_server().bind()
        args.plotters = True   # an endpoint without plotters is silence
    if args.optimize:
        return run_optimizer(args, workflow_file, config_files, overrides)
    if args.backend.endswith("-evaluator"):
        print(f"-b {args.backend} is for --optimize only", file=sys.stderr)
        return 2
    if args.ensemble_train is not None or args.ensemble_test:
        return run_ensemble(args, workflow_file)
    try:
        launcher = Launcher(backend=args.backend, seed=args.seed,
                            snapshot=args.snapshot, profile=args.profile,
                            plotters=args.plotters,
                            status_server=args.status_server,
                            verbose=args.verbose, multihost=args.multihost,
                            dp=args.dp, master_address=args.master_address,
                            listen_address=args.listen_address)
    except (RuntimeError, ValueError) as e:
        if not args.multihost:
            raise
        print(f"--multihost: {e}", file=sys.stderr)
        return 2
    try:
        drive_workflow(launcher, workflow_file)
        launcher.close()
    except SnapshotCorruptError as e:
        print(f"--snapshot {args.snapshot}: no intact snapshot ({e})",
              file=sys.stderr)
        return 2
    except RuntimeError as e:
        if "defines neither" in str(e):
            print(str(e), file=sys.stderr)
            return 2
        raise
    return 0


def _ga_worker_count(args) -> int:
    if args.ga_workers:
        return max(1, args.ga_workers)
    return min(4, max(1, (os.cpu_count() or 2) // 2))


def _evaluator_device(backend: str) -> Optional[str]:
    """The evaluator's ``-b`` for an evaluator mode, None for the CPU
    fan-out (``-b cpu``)."""
    if backend in ("auto", "cuda", "cuda-evaluator"):
        return "cuda"
    if backend == "cpu-evaluator":
        return "cpu"
    return None


def run_ensemble(args, workflow_file: str) -> int:
    """``--ensemble-train N`` trains N members and saves them;
    ``--ensemble-test`` reports the averaged members' validation error
    (one JSON line each)."""
    import numpy as np

    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.ensemble import (EnsemblePredictor,
                                          EnsembleTrainer, load_members,
                                          normalize_npz_path, save_members)
    from veles_tpu_torch.launcher import load_workflow_module
    from veles_tpu_torch.loader.base import VALID

    create = getattr(load_workflow_module(workflow_file),
                     "create_workflow", None)
    if create is None:
        print(f"--ensemble-train/test need {workflow_file} to expose "
              f"create_workflow(launcher)", file=sys.stderr)
        return 2

    class _FL:
        workflow = None

    def factory():
        return create(_FL())

    def device_factory():
        return make_device(args.backend)

    members = None
    if args.ensemble_train is not None:
        members = EnsembleTrainer(factory, device_factory,
                                  n_members=args.ensemble_train,
                                  base_seed=args.seed).train()
        path = save_members(args.ensemble_file, members)
        print(json.dumps({
            "members": len(members),
            "member_valid_errors_pct": [round(m["valid_error"], 4)
                                        for m in members],
            "file": path}), flush=True)
        if not args.ensemble_test:
            return 0
    if members is None:
        fname = normalize_npz_path(args.ensemble_file)
        try:
            members = load_members(fname)
        except FileNotFoundError:
            print(f"--ensemble-test: {fname!r} does not exist (train one "
                  f"first with --ensemble-train N)", file=sys.stderr)
            return 2
    pred = EnsemblePredictor(factory, device_factory, members,
                             device=args.ensemble_device)
    ld = pred.workflow.loader
    n = ld.class_lengths[VALID]
    if not n:
        print("--ensemble-test: the workflow's loader has no validation "
              "split", file=sys.stderr)
        return 2
    off = ld.class_offset(VALID)
    x = ld.normalized_host_rows(slice(off, off + n))
    if ld.host_labels is not None:
        y = np.asarray(ld.host_labels[off:off + n])
    else:
        y = pred.workflow.device.get(ld.original_labels[off:off + n])
    err = pred.error_pct(x, y, chunk=max(1, ld.max_minibatch_size))
    print(json.dumps({
        "members": len(members),
        "ensemble_valid_error_pct": round(err, 4),
        "ensemble_eval_engine": "device" if pred.engine is not None
        else "host",
        "member_valid_errors_pct": [round(m["valid_error"], 4)
                                    for m in members]}), flush=True)
    return 0


def run_optimizer(args, workflow_file: str, config_files, overrides) -> int:
    """``--optimize POP:GEN``: the GA over the config's Tune markers,
    each genome scored by a short training run in the execution mode
    ``-b`` names (the module docstring's table).  Prints the best genome
    and its fitness as one JSON line (with the pool's counters in an
    evaluator mode); exits 14 after a graceful stop, 1 when every
    evaluation failed or the evaluator did not come up."""
    import math
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    from veles_tpu_torch import faults, knobs
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import GeneticOptimizer, find_tunes
    from veles_tpu_torch.supervisor import install_ga_stop

    tunes = find_tunes(root)
    if not tunes:
        print("--optimize: no Tune(...) markers in the config tree",
              file=sys.stderr)
        return 2
    pop_s, _, gen_s = args.optimize.partition(":")
    pop, gen = int(pop_s), int(gen_s or 3)
    workers = _ga_worker_count(args)
    evaluator = _evaluator_device(args.backend)
    files = [workflow_file, *config_files, *overrides]
    pool = None
    if evaluator is not None:
        from veles_tpu_torch.genetics.pool import ChipEvaluatorPool
        serve_cmd = [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
                     "--serve", *files, "-b", evaluator, "-s",
                     str(args.seed), "--cohort", str(max(0, args.ga_cohort))]
        pool = ChipEvaluatorPool(serve_cmd, workers=workers,
                                 timeout=args.ga_eval_timeout,
                                 heartbeat_deadline=args.heartbeat_deadline,
                                 seed=args.seed)
        try:
            hello = pool.start()
        except Exception as e:  # noqa: BLE001 — reported, then exit 1
            pool.close()
            what = "a CUDA card" if evaluator == "cuda" else "the CPU"
            print(f"--optimize -b {args.backend}: the evaluator did not "
                  f"come up on {what} ({e}); -b cpu runs the GA on the "
                  f"CPU", file=sys.stderr)
            return 1
        if evaluator == "cuda" and not pool.is_accelerator:
            pool.close()
            print(f"--optimize -b {args.backend}: the evaluator landed on "
                  f"{pool.platform}, not on a CUDA card", file=sys.stderr)
            return 1
        print(f"--optimize: evaluator pid {hello['pid']} owns "
              f"{pool.device_name}; {workers} prep workers feed it",
              file=sys.stderr, flush=True)
    base_cmd = [sys.executable, "-m", "veles_tpu_torch.genetics.worker",
                *files, "-b", "cpu", "-s", str(args.seed)]

    def evaluate_one_subprocess(values) -> float:
        try:
            res = subprocess.run(base_cmd + ["--values", json.dumps(values)],
                                 capture_output=True, text=True,
                                 timeout=args.ga_eval_timeout)
            if res.returncode != 0:
                raise RuntimeError(
                    f"worker rc={res.returncode}: "
                    f"{res.stderr.strip().splitlines()[-1:]!r}")
            return float(json.loads(
                res.stdout.strip().splitlines()[-1])["fitness"])
        except Exception as e:  # noqa: BLE001 — bad genes score inf
            print(f"--optimize: genome {values} failed: {e}",
                  file=sys.stderr)
            return float("inf")

    def evaluate_many_subprocess(values_list):
        with ThreadPoolExecutor(workers) as tp:
            return list(tp.map(evaluate_one_subprocess, values_list))

    if pool is not None:
        evaluate_one, evaluate_many = pool.evaluate_one, pool.evaluate_many
    else:
        evaluate_one, evaluate_many = evaluate_one_subprocess, \
            evaluate_many_subprocess
    evaluate_cohort = pool.evaluate_cohort \
        if pool is not None and args.ga_cohort != 1 else None
    stop_check, finish_preempt = install_ga_stop()
    faults.maybe_inject_sigterm(attempt=knobs.get(knobs.SUPERVISE_ATTEMPT),
                                mode="ga")
    try:
        opt = GeneticOptimizer(evaluate_one, tunes, population=pop,
                               generations=gen, evaluate_many=evaluate_many,
                               evaluate_cohort=evaluate_cohort,
                               state_path=args.ga_state,
                               stop_check=stop_check)
        best, fitness = opt.run()
    finally:
        if pool is not None:
            pool.close()
        preempt_code = finish_preempt()
    out = {"best": best, "fitness": fitness,
           "evaluations": opt.eval_count,
           "eval_seconds": opt.eval_seconds,
           "cohort_sizes": opt.cohort_sizes,
           "cohort_fallbacks": opt.cohort_fallbacks}
    if pool is not None:
        out["evaluator"] = {"device": pool.device_name,
                            "platform": pool.platform,
                            "fallbacks": pool.fallbacks,
                            "restarts": pool.restarts,
                            "genomes_lost": pool.genomes_lost,
                            "cohort_stats": pool.cohort_stats}
    if preempt_code is not None:
        out["preempted"] = True
        print(json.dumps(out), flush=True)
        return preempt_code
    if not math.isfinite(fitness):
        print("--optimize: every evaluation failed (fitness inf); check "
              "that the workflow runs on its own first", file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GA core: Tune markers, tree walking, the optimizer loop.

The port's own copy of ``veles_tpu/genetics/core.py`` (numpy only),
under the same names.  The operators draw from the ``"genetics"`` stream
of ``veles_tpu_torch.prng``, whose numpy generator is bitwise the
reference's, so one seed breeds the same populations; the state file is
the reference's JSON (format 2) with its embedded CRC32, ``.prev``
rotation and atomic write, readable by either package.  Counters on
the optimizer: ``eval_count`` / ``eval_seconds``, ``cohort_sizes``
(each generation's bucket sizes) and ``cohort_fallbacks`` (buckets
whose cohort evaluation failed and went per genome); beside them the
reference's ``ga.*`` telemetry and journal events.  Each generation's
number is exported as ``$VELES_GA_GENERATION`` for the evaluators and
fault qualifiers.  Fault points: ``supervisor.child_crash`` after a
generation's evaluation, before its checkpoint
(:func:`~veles_tpu_torch.faults.maybe_inject_child_crash`), and
``checkpoint.corrupt`` (``gen``), a torn state file.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import events, faults, knobs, prng, telemetry
from veles_tpu_torch.config import Config

log = logging.getLogger("veles.genetics")


class Tune:
    """Marks a config value as a GA gene: ``Tune(default, min, max)``.
    Integer defaults breed integers (e.g. layer widths), float defaults
    breed floats (e.g. learning rates, log-uniform when min > 0)."""

    def __init__(self, value: Any, minv: float, maxv: float) -> None:
        if minv > maxv:
            raise ValueError(f"Tune: min {minv} > max {maxv}")
        self.value = value
        self.minv = minv
        self.maxv = maxv
        self.is_int = isinstance(value, (int, np.integer)) and \
            not isinstance(value, bool)
        #: log-scale breeding for positive float ranges spanning >=10x
        self.log_scale = (not self.is_int and minv > 0
                          and maxv / minv >= 10.0)

    def clip(self, x: float) -> Any:
        x = float(np.clip(x, self.minv, self.maxv))
        return int(round(x)) if self.is_int else x

    def __repr__(self) -> str:
        return f"Tune({self.value}, {self.minv}, {self.maxv})"


def _walk(obj: Any, path: str, out: Dict[str, Tune]) -> None:
    if isinstance(obj, Tune):
        out[path] = obj
    elif isinstance(obj, Config):
        for k, v in obj.__dict__.items():
            _walk(v, f"{path}.{k}" if path else k, out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk(v, f"{path}[{k!r}]", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk(v, f"{path}[{i}]", out)


def find_tunes(tree: Any) -> Dict[str, Tune]:
    """All Tune markers under a Config tree / dict / list, keyed by a
    path expression usable with substitute_tunes."""
    out: Dict[str, Tune] = {}
    _walk(tree, "", out)
    return out


def _set_path(tree: Any, path: str, value: Any) -> None:
    # path grammar produced by _walk: dotted attrs + [key] indexers
    tokens = re.findall(r"[A-Za-z_][A-Za-z_0-9]*|\[[^\]]+\]", path)
    cur = tree
    for i, tok in enumerate(tokens):
        last = i == len(tokens) - 1
        if tok.startswith("["):
            key = eval(tok[1:-1])  # noqa: S307 — our own repr'd keys
            if last:
                cur[key] = value
            else:
                cur = cur[key]
        else:
            if last:
                setattr(cur, tok, value)
            else:
                cur = getattr(cur, tok)


def substitute_tunes(tree: Any, values: Dict[str, Any]) -> None:
    """Replace each Tune marker with a concrete value, in place."""
    for path, v in values.items():
        _set_path(tree, path, v)


#: gradient-unit hyperparameters a float gene may set WITHOUT changing
#: any array shape — the population-batched trainer lifts these into
#: per-member vectors (``lr_rates`` / ``update_params(decays=...)``),
#: so genomes differing only here share one vmapped training dispatch
LIFTABLE_HYPERS = ("learning_rate", "learning_rate_bias",
                   "weight_decay", "weight_decay_bias")


def liftable_tune(path: str, tune: Tune) -> bool:
    """True when this gene only scales a per-member SGD hyperparameter
    (float learning rate / weight decay in a layer's ``"<-"`` dict).
    Integer genes (layer widths, kernel counts) always change the
    decoded model's SHAPE SIGNATURE and split cohorts instead."""
    if tune.is_int:
        return False
    return any(path.endswith(f"[{k!r}]") for k in LIFTABLE_HYPERS)


def shape_signature(values: Dict[str, Any],
                    tunes: Dict[str, Tune]) -> Tuple:
    """The cohort key of a decoded genome: every NON-liftable decoded
    value, in path order.  Two genomes with equal signatures decode to
    identical model structure/data/optimizer topology and may train as
    members of one vmapped cohort."""
    return tuple((p, values[p]) for p in sorted(tunes)
                 if not liftable_tune(p, tunes[p]))


class GeneticOptimizer:
    """Tournament-select / blend-crossover / gaussian-mutate GA.

    ``evaluate(values: {path: value}) -> fitness`` — LOWER is better
    (validation error).  Failed evaluations (exceptions) score inf and
    are selected against instead of aborting the run.
    """

    def __init__(self, evaluate: Callable[[Dict[str, Any]], float],
                 tunes: Dict[str, Tune],
                 population: int = 8,
                 generations: int = 5,
                 elite: int = 2,
                 mutation_rate: float = 0.25,
                 mutation_sigma: float = 0.15,
                 rng_stream: str = "genetics",
                 evaluate_many: Optional[Callable[
                     [List[Dict[str, Any]]], List[float]]] = None,
                 evaluate_cohort: Optional[Callable[
                     [List[Dict[str, Any]]], List[float]]] = None,
                 state_path: Optional[str] = None,
                 stop_check: Optional[Callable[[], bool]] = None) \
            -> None:
        if not tunes:
            raise ValueError("no Tune(...) markers found to optimize")
        self.evaluate = evaluate
        #: batch evaluator — N genomes at once (subprocess fan-out);
        #: None = sequential in-process map over ``evaluate``
        self._evaluate_many = evaluate_many
        #: cohort evaluator — N genomes OF ONE SHAPE SIGNATURE trained
        #: as a single population-batched dispatch (the tpu-evaluator
        #: pool's vmapped path).  When set, _fitness_many buckets each
        #: generation by shape_signature() and dispatches one cohort
        #: per bucket; a bucket whose cohort evaluation fails falls
        #: back to the per-genome path — the parity oracle.
        self._evaluate_cohort = evaluate_cohort
        #: cohort sizes of the most recent generation
        self.last_cohort_sizes: List[int] = []
        #: per-generation checkpoint file; run() resumes from it when
        #: it exists (reference parity: Genetics "spawns many workflow
        #: runs" and long GA runs must survive restarts)
        self.state_path = state_path
        #: graceful stop: a callable polled at each generation
        #: boundary; True = stop breeding now and return the best so
        #: far (the checkpoint already on disk is the resume point)
        self._stop_check = stop_check
        self.tunes = tunes
        self.paths = sorted(tunes)
        self.population = max(population, 2 + elite)
        self.generations = generations
        self.elite = elite
        self.mutation_rate = mutation_rate
        self.mutation_sigma = mutation_sigma
        self.rng = prng.get(rng_stream).numpy
        #: [(fitness, values)] per generation, best first
        self.history: List[List[Tuple[float, Dict[str, Any]]]] = []
        #: evaluation throughput accounting (see _fitness_many)
        self.eval_count = 0
        self.eval_seconds = 0.0
        #: every generation's cohort sizes, in order
        self.cohort_sizes: List[List[int]] = []
        #: cohort buckets that failed and went per genome
        self.cohort_fallbacks = 0

    # -- genome <-> values --------------------------------------------

    def _to_gene(self, t: Tune, x: float) -> float:
        return float(np.log(x)) if t.log_scale else float(x)

    def _from_gene(self, t: Tune, g: float) -> Any:
        return t.clip(np.exp(g) if t.log_scale else g)

    def _bounds(self, t: Tune) -> Tuple[float, float]:
        if t.log_scale:
            return float(np.log(t.minv)), float(np.log(t.maxv))
        return float(t.minv), float(t.maxv)

    def _decode(self, genome: np.ndarray) -> Dict[str, Any]:
        return {p: self._from_gene(self.tunes[p], g)
                for p, g in zip(self.paths, genome)}

    # -- GA operators --------------------------------------------------

    def _initial_population(self) -> np.ndarray:
        pop = []
        # individual 0 = the config's own defaults
        pop.append([self._to_gene(self.tunes[p], self.tunes[p].value)
                    for p in self.paths])
        for _ in range(self.population - 1):
            genome = []
            for p in self.paths:
                lo, hi = self._bounds(self.tunes[p])
                genome.append(self.rng.uniform(lo, hi))
            pop.append(genome)
        return np.asarray(pop, np.float64)

    def _tournament(self, fits: np.ndarray, k: int = 2) -> int:
        picks = self.rng.choice(len(fits), size=k, replace=False)
        return int(picks[np.argmin(fits[picks])])

    def _crossover(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        alpha = self.rng.uniform(-0.25, 1.25, size=a.shape)  # BLX-like
        return a + alpha * (b - a)

    def _mutate(self, g: np.ndarray) -> np.ndarray:
        g = g.copy()
        for i, p in enumerate(self.paths):
            if self.rng.random() < self.mutation_rate:
                lo, hi = self._bounds(self.tunes[p])
                g[i] += self.rng.normal(0.0, self.mutation_sigma) \
                    * (hi - lo)
            lo, hi = self._bounds(self.tunes[p])
            g[i] = np.clip(g[i], lo, hi)
        return g

    # -- the loop ------------------------------------------------------

    def _fitness(self, genome: np.ndarray) -> float:
        values = self._decode(genome)
        try:
            return float(self.evaluate(values))
        except Exception as e:  # noqa: BLE001 — GA must survive bad genes
            log.warning("evaluation failed for %s: %s", values, e)
            return float("inf")

    def _fitness_many(self, genomes: np.ndarray,
                      gen: Optional[int] = None) -> np.ndarray:
        if gen is not None:
            os.environ[knobs.GA_GENERATION] = str(gen)
        t0 = time.perf_counter()
        fits = self._fitness_many_inner(genomes)
        dt = time.perf_counter() - t0
        #: cumulative (evaluations, seconds): the GA's own throughput
        #: record, comparable across execution modes
        self.eval_count += len(genomes)
        self.eval_seconds += dt
        telemetry.counter(events.CTR_GA_EVALUATIONS).inc(len(genomes))
        telemetry.counter(events.CTR_GA_EVAL_SECONDS).inc(dt)
        telemetry.histogram(events.HIST_GA_GENERATION_SECONDS).record(dt)
        telemetry.event(events.EV_GA_GENERATION_EVALUATED, gen=gen,
                        genomes=len(genomes), seconds=round(dt, 2))
        if dt > 0:
            log.info("generation %s: evaluated %d genomes in %.1fs "
                     "(%.2f genomes/s)", gen, len(genomes), dt,
                     len(genomes) / dt)
        # the worst crash point: after the generation's work, before its
        # checkpoint (the resumed run re-evaluates it bit-identically)
        faults.maybe_inject_child_crash(
            gen=gen, site="ga_generation",
            attempt=knobs.get(knobs.SUPERVISE_ATTEMPT))
        return fits

    def _fitness_many_inner(self, genomes: np.ndarray) -> np.ndarray:
        if self._evaluate_cohort is not None:
            return self._fitness_cohorts(genomes)
        return self._fitness_serial(genomes)

    def _fitness_cohorts(self, genomes: np.ndarray) -> np.ndarray:
        """Bucket the generation by shape signature and train each
        bucket as ONE population-batched cohort.  A genome whose decode
        fails scores inf without poisoning its cohort; a bucket whose
        cohort dispatch fails falls back to the per-genome oracle."""
        fits = np.full(len(genomes), float("inf"), np.float64)
        decoded: List[Optional[Dict[str, Any]]] = []
        for g in genomes:
            try:
                decoded.append(self._decode(g))
            except Exception as e:  # noqa: BLE001 — bad genes score inf
                log.warning("genome decode failed (%s); scoring inf", e)
                decoded.append(None)
        buckets: Dict[Tuple, List[int]] = {}
        for i, v in enumerate(decoded):
            if v is None:
                continue
            buckets.setdefault(shape_signature(v, self.tunes),
                               []).append(i)
        self.last_cohort_sizes = [len(ix) for ix in buckets.values()]
        self.cohort_sizes.append(list(self.last_cohort_sizes))
        if buckets:
            log.info("cohorts: %d signature bucket(s), sizes %s",
                     len(buckets), self.last_cohort_sizes)
        for idxs in buckets.values():
            try:
                bf = self._evaluate_cohort([decoded[i] for i in idxs])
                if len(bf) != len(idxs):
                    raise ValueError(
                        f"cohort evaluator returned {len(bf)} "
                        f"fitnesses for {len(idxs)} genomes")
                bf = [float("inf") if f is None else float(f)
                      for f in bf]
            except Exception as e:  # noqa: BLE001 — fall back, never
                # abort: the per-genome path is the parity oracle
                self.cohort_fallbacks += 1
                log.warning(
                    "cohort evaluation failed for a %d-genome bucket "
                    "(%s); falling back to per-genome evaluation",
                    len(idxs), e)
                bf = self._fitness_serial(genomes[idxs]).tolist()
            fits[idxs] = bf
        return fits

    def _fitness_serial(self, genomes: np.ndarray) -> np.ndarray:
        if self._evaluate_many is None:
            return np.array([self._fitness(g) for g in genomes],
                            np.float64)
        try:
            fits = self._evaluate_many(
                [self._decode(g) for g in genomes])
            # batch evaluators (e.g. the chip pool) may mark a lost
            # genome None — same contract as a failure: inf, selected
            # against
            fits = [float("inf") if f is None else float(f)
                    for f in fits]
            return np.asarray(fits, np.float64)
        except Exception as e:  # noqa: BLE001 — same contract as
            # _fitness: failures score inf, never abort the run
            log.warning("batch evaluation failed (%s); falling back "
                        "to per-genome evaluation", e)
            return np.array([self._fitness(g) for g in genomes],
                            np.float64)

    # -- checkpoint / resume -------------------------------------------

    def _save_state(self, gen: int, pop: np.ndarray,
                    fits: np.ndarray) -> None:
        """Atomic per-generation checkpoint: next generation to run,
        its (already evaluated) population, the full history, and the
        GA RNG state, so a resumed run continues bit-identically.  The
        state carries a CRC32 over the canonical JSON of everything
        else, goes through a pid-unique temp file, and the previous
        checkpoint is rotated to ``<state_path>.prev``, so a torn write
        always leaves an intact predecessor.  The resume manifest then
        points at the state file (``ga_state``)."""
        if not self.state_path:
            return
        from veles_tpu_torch.snapshotter import write_resume_manifest
        state = {
            "format": 2,
            "paths": self.paths,
            "generation": gen,
            "population": pop.tolist(),
            "fits": fits.tolist(),
            "history": [[(f, v) for f, v in g] for g in self.history],
            "rng_state": self.rng.bit_generator.state,
        }
        state["crc32"] = zlib.crc32(
            json.dumps(state, sort_keys=True).encode()) & 0xFFFFFFFF
        directory = os.path.dirname(os.path.abspath(self.state_path)) \
            or "."
        fd, tmp = tempfile.mkstemp(
            dir=directory, suffix=".tmp",
            prefix=os.path.basename(self.state_path) + ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(state, f)
            if faults.fire("checkpoint.corrupt", gen=gen):
                faults.truncate_file(tmp)
            if os.path.exists(self.state_path):
                os.replace(self.state_path, self.state_path + ".prev")
            os.replace(tmp, self.state_path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        write_resume_manifest(ga_state=self.state_path)

    @staticmethod
    def _read_state_file(path: str) -> dict:
        """Parse + verify one checkpoint file; raises
        SnapshotCorruptError on a torn/corrupt one."""
        from veles_tpu_torch.snapshotter import SnapshotCorruptError
        try:
            with open(path) as f:
                state = json.load(f)
            if int(state.get("format", 1)) >= 2:
                want = state.pop("crc32", None)
                if want is None:
                    raise SnapshotCorruptError(
                        f"{path}: format-2 checkpoint without its "
                        f"embedded CRC (torn write)")
                got = zlib.crc32(json.dumps(
                    state, sort_keys=True).encode()) & 0xFFFFFFFF
                if got != int(want):
                    raise SnapshotCorruptError(f"{path}: CRC mismatch")
        except SnapshotCorruptError:
            raise
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise SnapshotCorruptError(
                f"{path}: {type(e).__name__}: {e}") from e
        return state

    def _load_state(self):
        """Resume data from the newest INTACT checkpoint: the state
        file itself, else its ``.prev`` predecessor (resume then
        re-runs one generation bit-identically).  Both corrupt raises
        — a torn checkpoint must never silently restart the run."""
        from veles_tpu_torch.snapshotter import SnapshotCorruptError
        if not self.state_path or not (
                os.path.exists(self.state_path)
                or os.path.exists(self.state_path + ".prev")):
            return None
        state = None
        errors = []
        for path in (self.state_path, self.state_path + ".prev"):
            if not os.path.exists(path):
                continue
            try:
                state = self._read_state_file(path)
            except SnapshotCorruptError as e:
                errors.append(str(e))
                log.warning("GA checkpoint %s is corrupt (%s); "
                            "trying predecessor", path, e)
                continue
            if path != self.state_path:
                telemetry.counter(events.CTR_GA_CHECKPOINT_FALLBACKS).inc()
                telemetry.event(events.EV_GA_CHECKPOINT_FALLBACK,
                                corrupt=self.state_path, used=path)
                log.warning("resuming from intact predecessor %s", path)
            break
        if state is None:
            telemetry.event(events.EV_GA_CHECKPOINT_UNRECOVERABLE,
                            path=self.state_path)
            raise SnapshotCorruptError(
                f"GA checkpoint {self.state_path} and its .prev "
                f"predecessor are both corrupt ({errors}); remove "
                f"them to start a fresh run")
        if state["paths"] != self.paths:
            raise ValueError(
                f"GA state file {self.state_path} was written for "
                f"genes {state['paths']}, current config has "
                f"{self.paths} — remove the stale state file")
        self.history = [[(float(f), v) for f, v in g]
                        for g in state["history"]]
        self.rng.bit_generator.state = state["rng_state"]
        return (int(state["generation"]),
                np.asarray(state["population"], np.float64),
                np.asarray(state["fits"], np.float64))

    # -- the loop ------------------------------------------------------

    def run(self) -> Tuple[Dict[str, Any], float]:
        """One full GA run.  ``history`` afterwards holds exactly
        ``generations + 1`` entries: the ranked population at the
        START of each of the ``generations`` breeding steps, plus the
        final bred-and-evaluated population appended after the loop.
        Safe to call twice on one optimizer: a fresh (non-resumed)
        run resets ``history`` first, and a resumed run restores it
        from the checkpoint — either way the final-generation entry is
        never duplicated."""
        resumed = self._load_state()
        if resumed is not None:
            start_gen, pop, fits = resumed
            telemetry.event(events.EV_GA_RESUMED, generation=start_gen,
                            state=self.state_path)
            log.info("resumed GA at generation %d from %s", start_gen,
                     self.state_path)
        else:
            start_gen = 0
            # a second run() on the same optimizer starts a FRESH run:
            # stale history would otherwise keep the previous run's
            # generations+1 entries and duplicate the final append
            self.history = []
            pop = self._initial_population()
            fits = self._fitness_many(pop, gen=0)
            self._save_state(0, pop, fits)
        for gen in range(start_gen, self.generations):
            if self._stop_check is not None and self._stop_check():
                # graceful stop at the generation boundary: the
                # checkpoint written after the previous generation is
                # the resume point; a resumed run continues the
                # remaining generations bit-identically
                telemetry.event(events.EV_PREEMPT_GA_STOP, generation=gen)
                log.warning(
                    "graceful stop: breeding halted before generation "
                    "%d; resume continues from the checkpoint", gen)
                break
            order = np.argsort(fits)
            pop, fits = pop[order], fits[order]
            self.history.append([(float(f), self._decode(g))
                                 for f, g in zip(fits, pop)])
            telemetry.event(events.EV_GA_GENERATION, gen=gen,
                            best=float(fits[0]))
            log.info("generation %d: best=%.4f %s", gen, fits[0],
                     self._decode(pop[0]))
            nxt = list(pop[:self.elite])
            while len(nxt) < self.population:
                a = pop[self._tournament(fits)]
                b = pop[self._tournament(fits)]
                child = self._mutate(self._crossover(a, b))
                nxt.append(child)
            new = np.asarray(nxt)
            new_fits = np.concatenate([
                fits[:self.elite],
                self._fitness_many(new[self.elite:], gen=gen + 1)])
            pop, fits = new, new_fits
            self._save_state(gen + 1, pop, fits)
        # the last bred population WAS evaluated — record it, or
        # history[-1] silently under-reports the final state (e.g.
        # EnsembleTrainer.from_ga would seed from the previous
        # generation's ranking even when final offspring beat it);
        # history length lands at generations + 1
        order = np.argsort(fits)
        pop, fits = pop[order], fits[order]
        self.history.append([(float(f), self._decode(g))
                             for f, g in zip(fits, pop)])
        best = self._decode(pop[0])
        log.info("GA done: best fitness %.4f with %s", fits[0], best)
        return best, float(fits[0])

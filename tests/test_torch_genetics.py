"""The port's GA core (``veles_tpu_torch/genetics/core.py``) against the
JAX package's (``veles_tpu/genetics/core.py``), which is numpy only.

- ``Tune``, ``find_tunes``, ``substitute_tunes``, ``liftable_tune`` and
  ``shape_signature`` give the reference's outputs on the same trees.
- ``GeneticOptimizer`` on a quadratic, seeded alike, keeps a ``history``
  equal to the reference's bit for bit (the ``"genetics"`` streams are
  bitwise equal), per-genome, batched and bucketed into cohorts.
- A state file the reference wrote mid-run resumes in the port to the
  reference's own final history, and one the port wrote resumes in the
  reference the same way (the JSON with its CRC, ``.prev`` rotation).
  A torn state resumes from ``.prev``; both torn raise.
- Cohort bucketing: one cohort per shape signature; a genome whose
  decode fails scores inf without poisoning its bucket; a failing
  bucket goes per genome and is counted in ``cohort_fallbacks``.
"""

import json

import numpy as np
import pytest

from veles_tpu import prng as ref_prng
from veles_tpu.config import Config as RefConfig
from veles_tpu.genetics import GeneticOptimizer as RefOptimizer
from veles_tpu.genetics import Tune as RefTune
from veles_tpu.genetics import find_tunes as ref_find_tunes
from veles_tpu.genetics import liftable_tune as ref_liftable
from veles_tpu.genetics import shape_signature as ref_signature
from veles_tpu.genetics import substitute_tunes as ref_substitute
from veles_tpu_torch import prng
from veles_tpu_torch.config import Config
from veles_tpu_torch.genetics import (GeneticOptimizer, Tune, find_tunes,
                                      liftable_tune, shape_signature,
                                      substitute_tunes)
from veles_tpu_torch.snapshotter import SnapshotCorruptError

LR = "m.layers[0]['<-']['learning_rate']"
WD = "m.layers[0]['<-']['weight_decay']"
WIDTH = "m.layers[0]['->']['output_sample_shape']"


@pytest.fixture(autouse=True)
def _streams(monkeypatch):
    monkeypatch.delenv("VELES_RESUME_MANIFEST", raising=False)
    monkeypatch.delenv("VELES_FAULTS", raising=False)
    yield
    prng._streams.clear()
    prng.seed_all(1234)


def _seed_both(seed):
    ref_prng._streams.clear()
    ref_prng.seed_all(seed)
    prng._streams.clear()
    prng.seed_all(seed)


def _tree(config_cls, tune_cls):
    cfg = config_cls("root")
    cfg.m.lr = tune_cls(0.1, 0.01, 1.0)
    cfg.m.layers = [
        {"type": "all2all", "->": {"output_sample_shape": tune_cls(32, 8,
                                                                   128)},
         "<-": {"learning_rate": tune_cls(0.3, 0.01, 1.0),
                "weight_decay": tune_cls(0.0, 0.0, 0.01)}},
        {"type": "softmax", "->": {"output_sample_shape": 10}}]
    cfg.m.loader = {"minibatch_size": tune_cls(32.0, 8.0, 64.0)}
    cfg.plain = 5
    return cfg


@pytest.mark.parametrize("args", [(16, 4, 64), (0.1, 0.01, 1.0),
                                  (0.5, 0.0, 1.0), (0.001, 0.0001, 0.01),
                                  (True, 0, 1)])
def test_tune_is_the_references(args):
    a, b = Tune(*args), RefTune(*args)
    assert (a.is_int, a.log_scale, repr(a)) == \
        (b.is_int, b.log_scale, repr(b))
    for x in (-5.0, 0.004, 0.5, 5.4, 999.0):
        assert a.clip(x) == b.clip(x)
    with pytest.raises(ValueError):
        Tune(1, 5, 2)


def test_find_and_substitute_are_the_references():
    port, ref = _tree(Config, Tune), _tree(RefConfig, RefTune)
    tunes, ref_tunes = find_tunes(port), ref_find_tunes(ref)
    assert sorted(tunes) == sorted(ref_tunes)
    assert {p: repr(t) for p, t in tunes.items()} == \
        {p: repr(t) for p, t in ref_tunes.items()}
    values = {p: t.clip(t.maxv * 0.7) for p, t in tunes.items()}
    substitute_tunes(port, values)
    ref_substitute(ref, values)
    assert port.todict() == ref.todict()
    assert not find_tunes(port)


@pytest.mark.parametrize("path,tune", [
    (LR, (0.1, 0.01, 1.0)), (WD, (0.001, 0.0, 0.1)),
    ("m.layers[1]['<-']['learning_rate_bias']", (0.1, 0.01, 1.0)),
    ("m.layers[2]['<-']['weight_decay_bias']", (0.1, 0.0, 1.0)),
    (LR, (1, 1, 8)), (WIDTH, (16, 8, 32)),
    ("m.loader['minibatch_size']", (32.0, 8.0, 64.0)),
    ("m.layers[0]['<-']['gradient_moment']", (0.9, 0.0, 0.99))])
def test_liftable_tune_is_the_references(path, tune):
    assert liftable_tune(path, Tune(*tune)) == \
        ref_liftable(path, RefTune(*tune))


def test_shape_signature_is_the_references():
    tunes = {WIDTH: Tune(16, 8, 32), LR: Tune(0.1, 0.01, 1.0),
             WD: Tune(0.0, 0.0, 0.01)}
    ref_tunes = {p: RefTune(t.value, t.minv, t.maxv)
                 for p, t in tunes.items()}
    for values in ({WIDTH: 16, LR: 0.3, WD: 0.0},
                   {WIDTH: 16, LR: 0.9, WD: 0.005},
                   {WIDTH: 24, LR: 0.3, WD: 0.0}):
        assert shape_signature(values, tunes) == \
            ref_signature(values, ref_tunes)
    a = shape_signature({WIDTH: 16, LR: 0.3, WD: 0.0}, tunes)
    assert a == shape_signature({WIDTH: 16, LR: 0.9, WD: 0.01}, tunes)
    assert a != shape_signature({WIDTH: 24, LR: 0.3, WD: 0.0}, tunes)


# -- the optimizer loop ------------------------------------------------------

def _quadratic(values):
    return (values["a"] - 1.0) ** 2 + (values["b"] - 7) ** 2 + \
        values.get("c", 0.0)


def _tunes(tune_cls):
    return {"a": tune_cls(0.5, 0.01, 2.0), "b": tune_cls(3, 0, 10),
            "c": tune_cls(0.2, 0.0, 1.0)}


def _run(optimizer_cls, tune_cls, seed=77, **kwargs):
    opt = optimizer_cls(_quadratic, _tunes(tune_cls), population=6,
                        generations=3, **kwargs)
    best = opt.run()
    return opt, best


@pytest.mark.parametrize("mode", ["serial", "many", "cohort"])
def test_history_is_the_references_bitwise(mode):
    def many(values_list):
        return [_quadratic(v) for v in values_list]
    kwargs = {"serial": {}, "many": {"evaluate_many": many},
              "cohort": {"evaluate_cohort": many}}[mode]
    _seed_both(77)
    ref, ref_best = _run(RefOptimizer, RefTune, **kwargs)
    port, best = _run(GeneticOptimizer, Tune, **kwargs)
    assert port.history == ref.history
    assert best == ref_best
    assert len(port.history) == 4 and port.eval_count == ref.eval_count
    if mode == "cohort":
        # b is an integer gene: it splits the cohorts as in the reference
        assert port.last_cohort_sizes == ref.last_cohort_sizes
        assert len(port.cohort_sizes) == 4
        assert port.cohort_fallbacks == 0


def _stop_after(n_checks):
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > n_checks
    return stop


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_file_resumes_across_packages(tmp_path, writer):
    _seed_both(5)
    full, full_best = _run(RefOptimizer, RefTune)
    state = str(tmp_path / "ga_state.json")
    _seed_both(5)
    first_cls, tune_cls, resume_cls, resume_tune = \
        (RefOptimizer, RefTune, GeneticOptimizer, Tune) \
        if writer == "reference" else \
        (GeneticOptimizer, Tune, RefOptimizer, RefTune)
    first, _ = _run(first_cls, tune_cls, state_path=state,
                    stop_check=_stop_after(1))
    with open(state) as f:
        saved = json.load(f)
    assert saved["format"] == 2 and saved["generation"] == 1
    assert "crc32" in saved and (tmp_path / "ga_state.json.prev").exists()
    # the resumed run draws from the restored state, not the stream
    _seed_both(999)
    resumed, best = _run(resume_cls, resume_tune, state_path=state)
    assert resumed.history == full.history
    assert best == full_best


def test_torn_state_resumes_from_prev_and_both_torn_raise(tmp_path):
    state = tmp_path / "ga_state.json"
    _seed_both(5)
    full, full_best = _run(GeneticOptimizer, Tune)
    _seed_both(5)
    _run(GeneticOptimizer, Tune, state_path=str(state),
         stop_check=_stop_after(2))
    state.write_text(state.read_text()[:40])          # torn write
    resumed, best = _run(GeneticOptimizer, Tune, state_path=str(state))
    assert resumed.history == full.history and best == full_best
    state.write_text("{")
    (tmp_path / "ga_state.json.prev").write_text("{")
    with pytest.raises(SnapshotCorruptError):
        _run(GeneticOptimizer, Tune, state_path=str(state))


def test_state_points_the_resume_manifest(tmp_path, monkeypatch):
    manifest = tmp_path / "resume.json"
    monkeypatch.setenv("VELES_RESUME_MANIFEST", str(manifest))
    state = tmp_path / "ga_state.json"
    _run(GeneticOptimizer, Tune, state_path=str(state))
    assert json.loads(manifest.read_text())["ga_state"] == str(state)


# -- cohort bucketing ----------------------------------------------------------

BUCKET_TUNES = {WIDTH: (16, 8, 32), LR: (0.5, 0.2, 1.0)}


def _fit(values):
    return values[WIDTH] + values[LR]


def _bucket_opt(tunes=None, **kwargs):
    tunes = tunes or {p: Tune(*t) for p, t in BUCKET_TUNES.items()}
    return GeneticOptimizer(_fit, tunes, population=4, generations=1,
                            **kwargs)


def test_cohorts_bucket_by_signature():
    calls = []

    def cohort(values_list):
        calls.append([v[WIDTH] for v in values_list])
        return [_fit(v) for v in values_list]
    opt = _bucket_opt(evaluate_cohort=cohort)
    assert opt.paths == [WIDTH, LR]
    fits = opt._fitness_many(np.asarray(
        [[16.0, 0.3], [16.0, 0.9], [24.0, 0.5], [16.0, 0.25]]))
    assert np.allclose(fits, [16.3, 16.9, 24.5, 16.25])
    assert sorted(len(c) for c in calls) == [1, 3]
    assert sorted(opt.last_cohort_sizes) == [1, 3]
    assert opt.cohort_fallbacks == 0


def test_failed_decode_scores_inf_without_poisoning():
    class BoomTune(Tune):
        def clip(self, x):
            if x > 20:
                raise ValueError("boom")
            return super().clip(x)

    seen = []

    def cohort(values_list):
        seen.extend(v[WIDTH] for v in values_list)
        return [1.0 for _ in values_list]
    opt = _bucket_opt({WIDTH: BoomTune(16, 8, 32), LR: Tune(0.5, 0.2, 1.0)},
                      evaluate_cohort=cohort)
    fits = opt._fitness_many(np.asarray([[16.0, 0.3], [28.0, 0.3],
                                         [16.0, 0.5]]))
    assert fits[1] == float("inf") and fits[0] == fits[2] == 1.0
    assert seen == [16, 16]


def test_failed_bucket_goes_per_genome_and_is_counted():
    def cohort(values_list):
        raise RuntimeError("cohort path down")
    opt = _bucket_opt(evaluate_cohort=cohort)
    fits = opt._fitness_many(np.asarray([[16.0, 0.3], [16.0, 0.9],
                                         [24.0, 0.5]]))
    assert np.allclose(fits, [16.3, 16.9, 24.5])
    assert opt.cohort_fallbacks == 2      # two buckets, both per genome
    assert opt.cohort_sizes == [[2, 1]]


def test_failing_evaluations_score_inf():
    def boom(values):
        raise RuntimeError("bad genome")
    opt = GeneticOptimizer(boom, {"a": Tune(0.5, 0.0, 1.0)}, population=4,
                           generations=1)
    best, fitness = opt.run()
    assert fitness == float("inf") and set(best) == {"a"}
    with pytest.raises(ValueError):
        GeneticOptimizer(_quadratic, {})

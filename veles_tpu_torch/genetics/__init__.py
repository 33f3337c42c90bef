"""Genetic-algorithm hyperparameter tuning (the port's counterpart of
``veles_tpu/genetics/``).

Config values wrapped in ``Tune(default, min, max)`` become genes;
``GeneticOptimizer`` breeds them (tournament selection, blend
crossover, gaussian mutation, elitism) from the ``"genetics"`` stream
and scores each genome by a short training run.  Evaluation is
pluggable: in process, one ``genetics/worker.py --values`` subprocess
per genome (``-b cpu``), or ``ChipEvaluatorPool`` (``genetics/pool.py``),
where ONE evaluator process owns the card and trains same-signature
genomes as one population-batched cohort.  ``GAServingHandoff``
(``genetics/handoff.py``) serves a cohort's best members without a host
round trip::

    root.mnist.layers[0]["<-"]["learning_rate"] = Tune(0.1, 0.01, 1.0)
    python -m veles_tpu_torch --optimize 8:5 workflow.py config.py
"""

from veles_tpu_torch.genetics.core import (GeneticOptimizer, Tune,
                                           find_tunes, liftable_tune,
                                           shape_signature,
                                           substitute_tunes)

__all__ = ["Tune", "GeneticOptimizer", "find_tunes", "substitute_tunes",
           "liftable_tune", "shape_signature", "ChipEvaluatorPool",
           "GAServingHandoff"]


def __getattr__(name):
    # pool.py and handoff.py pull in subprocess and serving machinery;
    # workers that only need Tune keep the import light
    if name == "ChipEvaluatorPool":
        from veles_tpu_torch.genetics.pool import ChipEvaluatorPool
        return ChipEvaluatorPool
    if name == "GAServingHandoff":
        from veles_tpu_torch.genetics.handoff import GAServingHandoff
        return GAServingHandoff
    raise AttributeError(name)

"""The GA -> serving handoff that never leaves the device (the port's
counterpart of ``veles_tpu/genetics/handoff.py``).

The classic path from "the GA finished" to "the winner serves" is a
host round trip: snapshot the best genomes, write an npz, package it,
start a hive on the package, upload the params again.  But the final
generation's trained members are already stacked on the device along
the cohort engine's member axis, and the serving tier already has the
on-device adoption primitive (``ResidencyManager.swap_params``, the
online promotion's swap).  So:

1. the serving scaffold, a registered ``HostedModel`` with its engine
   (and optionally one warm-up request through it), is built AHEAD of
   the final generation from placeholder params, off the handoff's
   critical path;
2. the handoff itself is one ``index_select`` along the member axis of
   every leaf of the cohort's stacked tree (top K members, card to
   card) plus one ``swap_params`` attribute store;
3. the host member copies a later spill restores from are refreshed
   AFTER serving started (:meth:`GAServingHandoff.refresh_host`).

Either side may be member-sharded over a mesh of places
(``engine/core.py`` ``MemberPlacement``; the reference's
``handoff.py:95-120``): a sharded cohort's members are gathered from
their places' tiles onto the head place, and a sharded serving engine
tiles the adopted tree on its own places, padding it with the best
member (``EnsembleEvalEngine.adopt_stacked_params``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch import events, telemetry
from veles_tpu_torch.serve.residency import HostedModel, ResidencyManager

log = logging.getLogger("veles_tpu_torch.genetics.handoff")


class GAServingHandoff:
    """One model's pre-built serving scaffold and the on-device adopt.

    Construct it before (or while) the final generation trains: the
    engine build and the optional warm-up overlap training, so
    :meth:`adopt` pays only the gather and the swap."""

    def __init__(self, manager: ResidencyManager, name: str,
                 forwards: List[Any],
                 member_params: List[Dict[str, Dict[str, Any]]],
                 meta: Optional[Dict[str, Any]] = None,
                 sample_shape=None, warm_rows: int = 1) -> None:
        self.manager = manager
        self.name = name
        self.k = len(member_params)
        manager.register(HostedModel(name, forwards, member_params,
                                     meta=meta, sample_shape=sample_shape))
        #: the pre-built serving engine, serving the placeholder params
        #: until the first adopt lands
        self.engine = manager.ensure(name)
        #: host seconds of the last adopt (gather and swap)
        self.adopt_seconds = None
        if warm_rows and sample_shape is not None:
            self.warm(warm_rows, sample_shape)

    def warm(self, rows: int, sample_shape) -> None:
        """One dummy request through the serving path, so the first real
        request after the adopt pays a dispatch and no first-use set-up
        (cuDNN's algorithm choice, the allocator's first blocks)."""
        dummy = np.zeros((int(rows),) + tuple(sample_shape), np.float32)
        self.engine.submit(dummy).result()

    # -- the handoff ---------------------------------------------------

    def top_k(self, fitness: np.ndarray) -> np.ndarray:
        """The indices of the K best (lowest fitness: every cohort
        engine's fitness is lower-is-better) members, in a stable order,
        so ties keep the cohort's member order, as the per-genome GA
        sorts."""
        order = np.argsort(np.asarray(fitness, np.float64), kind="stable")
        return np.ascontiguousarray(order[:self.k].astype(np.int32))

    @staticmethod
    def _gather(stacked_params: Any, idx: np.ndarray):
        """Members ``idx`` of every leaf of a member-stacked tree,
        gathered on the tree's device."""
        index = None
        out = {}
        for fn, ps in stacked_params.items():
            out[fn] = {}
            for pn, t in ps.items():
                if index is None:
                    index = torch.as_tensor(idx, dtype=torch.int64,
                                            device=t.device)
                out[fn][pn] = t.index_select(0, index)
        return out

    def prewarm(self, cohort_engine: Any) -> None:
        """Run the adopt's gather once against the live cohort stack
        and drop the result: the first use of the gather's kernels
        happens off the timed handoff."""
        stacked = cohort_engine._params
        if stacked is None:
            raise RuntimeError("cohort engine has no live stacked params "
                               "to prewarm the gather against")
        self._gather(stacked, np.arange(self.k, dtype=np.int32))
        self.manager.device.synchronize()

    def adopt(self, stacked_params: Any, member_indices: np.ndarray):
        """Gather ``member_indices`` out of a cohort-stacked tree (card
        to card) and swap the result into the serving engine.  Returns
        the engine, already serving the trained members; no param
        touches the host on this path."""
        t0 = time.perf_counter()
        idx = np.asarray(member_indices, np.int32)
        if len(idx) != self.k:
            raise ValueError(
                f"handoff needs exactly {self.k} members (the pre-built "
                f"engine's stack), got {len(idx)}")
        engine = self.manager.swap_params(
            self.name, self._gather(stacked_params, idx))
        self.adopt_seconds = time.perf_counter() - t0
        telemetry.event(events.EV_GA_HANDOFF, model=self.name,
                        members=self.k, seconds=round(self.adopt_seconds, 5))
        log.info("GA handoff: %d members adopted on the device into %r "
                 "in %.2f ms (host time)", self.k, self.name,
                 1000.0 * self.adopt_seconds)
        return engine

    def adopt_cohort(self, cohort_engine: Any, fitness: np.ndarray):
        """The whole move for a just-trained cohort: top K by fitness,
        gather, swap.  ``cohort_engine`` exposes its member-stacked tree
        as ``_params`` (of a member-sharded cohort, its real members
        gathered on the head place): ``PopulationTrainEngine``
        (supervised and CD-k RBM cohorts) or ``SOMPopulationEngine``,
        whose ``run`` returned ``fitness``.  It must not be released
        yet."""
        stacked = cohort_engine._params
        if stacked is None:
            raise RuntimeError(
                "cohort engine already released its stacked params; "
                "adopt_cohort must run before release()")
        return self.adopt(stacked, self.top_k(fitness))

    def refresh_host(self) -> None:
        """Fetch host member copies of the served params and hand them
        to the residency manager (what a spill restores from): off the
        handoff's critical path, after serving started."""
        dev = self.manager.device
        host = {fn: {pn: dev.get(t) for pn, t in ps.items()}
                for fn, ps in self.engine.stacked_params.items()}
        self.manager.refresh_host_params(self.name, [
            {fn: {pn: a[i] for pn, a in ps.items()}
             for fn, ps in host.items()} for i in range(self.k)])

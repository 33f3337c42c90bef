"""Ensembles: members trained one after another, predictions averaged.

Counterpart of ``veles_tpu/ensemble/core.py`` (``EnsembleTrainer``,
``EnsemblePredictor``).

- :class:`EnsembleTrainer` trains N members of a workflow factory, member
  ``i`` seeded ``base_seed + 7919 * i``; with ``member_values`` (a GA's
  top genomes, :meth:`EnsembleTrainer.from_ga`) the factory is called
  with each member's values.  A member is a dict: its trained params in
  the REFERENCE's layout (``convert.params_to_jax``), so the members npz
  of ``ensemble/packaging.py`` serves both frameworks, its validation
  error %, seed, GA values and forward names.
- :class:`EnsemblePredictor` averages member probabilities through one
  template workflow.  ``device="auto"`` stacks the members once on the
  workflow's device (the card unless the caller asked for the CPU) and
  predicts with ``ops/fused.py``'s ``EnsembleEvalEngine``;
  ``device="host"`` is the member loop through each forward's
  ``apply_fwd`` on the CPU in f32, kept as the oracle the engine is held
  against.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.convert import params_from_jax, params_to_jax

log = logging.getLogger("veles.ensemble")


class EnsembleTrainer:
    """``train()`` -> the member dicts (and ``self.members``)."""

    def __init__(self, workflow_factory: Callable[..., Any],
                 device_factory: Callable[[], Any], n_members: int = 4,
                 base_seed: int = 1234,
                 member_values: Optional[List[Dict[str, Any]]] = None
                 ) -> None:
        self.workflow_factory = workflow_factory
        self.device_factory = device_factory
        self.member_values = member_values
        self.n_members = n_members if member_values is None \
            else len(member_values)
        self.base_seed = base_seed
        self.members: List[Dict[str, Any]] = []

    @classmethod
    def from_ga(cls, optimizer, workflow_factory: Callable[..., Any],
                device_factory: Callable[[], Any], k: int = 4,
                base_seed: int = 1234) -> "EnsembleTrainer":
        """Members from a finished GA's final generation, best first:
        ``workflow_factory(values)`` builds each."""
        if not getattr(optimizer, "history", None):
            raise ValueError("run the GA first: optimizer.history is empty")
        top = optimizer.history[-1][:max(1, k)]
        return cls(workflow_factory, device_factory, base_seed=base_seed,
                   member_values=[dict(v) for _, v in top])

    def train(self) -> List[Dict[str, Any]]:
        for i in range(self.n_members):
            seed = self.base_seed + 7919 * i
            prng.seed_all(seed)
            values = self.member_values[i] \
                if self.member_values is not None else None
            w = self.workflow_factory(values) if values is not None \
                else self.workflow_factory()
            w.initialize(device=self.device_factory(), train=True)
            w.run()
            err = w.decision.epoch_error_pct[1]
            self.members.append({
                "params": params_to_jax(w.fused.host_params()),
                "valid_error": err, "seed": seed, "values": values,
                "forward_names": [f.name for f in w.forwards]})
            log.info("member %d/%d (seed %d%s): valid error %.2f%%",
                     i + 1, self.n_members, seed,
                     f", {values}" if values else "", err)
        return self.members


class EnsemblePredictor:
    """Mean member probabilities over one template workflow, whose
    forwards give the chain and whose loader gives the data."""

    def __init__(self, workflow_factory: Callable[[], Any],
                 device_factory: Callable[[], Any],
                 members: List[Dict[str, Any]], device: str = "auto") -> None:
        if not members:
            raise ValueError("empty ensemble")
        if device not in ("auto", "host"):
            raise ValueError(f"device={device!r}: use 'auto' (the engine "
                             f"on the workflow's device) or 'host' (the "
                             f"CPU member loop)")
        self.members = members
        prng.seed_all(members[0]["seed"])
        self.workflow = workflow_factory()
        self.workflow.initialize(device=device_factory(), train=True)
        self._forwards = list(self.workflow.forwards)
        self._host_params: Optional[list] = None
        self.engine = None
        if device == "auto":
            from veles_tpu_torch.ops.fused import EnsembleEvalEngine
            self.engine = EnsembleEvalEngine(
                self._forwards, [params_from_jax(m["params"])
                                 for m in members], self.workflow.device)
            log.info("ensemble predictor: %d members stacked on %r",
                     len(members), self.workflow.device)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Mean member probabilities of a batch (NHWC or (B, ...))."""
        if self.engine is not None:
            return self.engine.predict_proba(x)
        return self.predict_proba_host(x)

    @torch.inference_mode()
    def predict_proba_host(self, x: np.ndarray) -> np.ndarray:
        """The oracle: members x layers of ``apply_fwd`` on the CPU in
        f32, summed left to right and divided by the member count."""
        if self._host_params is None:
            # the members in the port's layout, f32 on the CPU
            self._host_params = [
                {fn: {pn: torch.from_numpy(a) for pn, a in ps.items()}
                 for fn, ps in params_from_jax(m["params"]).items()}
                for m in self.members]
        xt = torch.from_numpy(np.asarray(x, np.float32))
        acc: Optional[torch.Tensor] = None
        for params in self._host_params:
            out = xt
            for f in self._forwards:
                out, _ = f.apply_fwd(params[f.name], out, rng=None,
                                     train=False)
            acc = out if acc is None else acc + out
        return (acc / len(self._host_params)).numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=-1)

    def error_pct(self, x: np.ndarray, labels: np.ndarray,
                  chunk: int = 256) -> float:
        """Ensemble classification error %, in chunks of ``chunk``
        rows."""
        labels = np.asarray(labels)
        if self.engine is not None:
            return self.engine.error_pct(x, labels, chunk=chunk)
        wrong = 0
        for i in range(0, len(x), chunk):
            wrong += int((np.argmax(self.predict_proba_host(
                x[i:i + chunk]), axis=-1) != labels[i:i + chunk]).sum())
        return 100.0 * wrong / max(len(x), 1)

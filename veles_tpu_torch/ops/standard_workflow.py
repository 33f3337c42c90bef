"""StandardWorkflow, forward-building subset.

Counterpart of ``veles_tpu/ops/standard_workflow.py``: a declarative
``layers`` list of ``{"type": ..., "->": {forward kwargs}, "<-": {gd
kwargs}}`` becomes a chain of forward units named ``fwd{i}_{kind}``
(the names key the members npz, so they must match the reference's).
:meth:`initialize` propagates shapes from the loader's sample shape.

The training half (evaluator, gradient units, decision, snapshotter,
lr policy, the fused step) and its configs belong to the training
slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.ops.registry import forward_registry


class StandardWorkflow:
    def __init__(self, workflow: Any = None, loader: Any = None,
                 loader_factory: Optional[Callable[..., Any]] = None,
                 layers: Optional[List[Dict[str, Any]]] = None,
                 name: str = "StandardWorkflow") -> None:
        self.workflow = workflow
        self.name = name
        self.layers_config = layers or []
        if loader is None:
            if loader_factory is None:
                raise ValueError("need loader or loader_factory")
            loader = loader_factory(self)
        self.loader = loader
        self.device = None
        self.forwards: List[Any] = []
        for i, cfg in enumerate(self.layers_config):
            kind = cfg["type"]
            if kind not in forward_registry:
                raise ValueError(f"unknown layer type {kind!r}; have "
                                 f"{sorted(forward_registry)}")
            self.forwards.append(forward_registry[kind](
                self, name=f"fwd{i}_{kind}", **dict(cfg.get("->", {}))))

    def initialize(self, device: Any = None, batch: int = 1) -> None:
        """Bind the device and give every forward its input shape."""
        self.device = device
        shape = (batch,) + tuple(self.loader.sample_shape)
        for f in self.forwards:
            f.initialize(shape)
            shape = f.output_shape

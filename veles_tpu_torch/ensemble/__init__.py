"""Ensembles: training N members, averaging their predictions, and the
members npz (the port's counterparts of ``veles_tpu/ensemble/``)."""

from veles_tpu_torch.ensemble.core import EnsemblePredictor, EnsembleTrainer
from veles_tpu_torch.ensemble.packaging import (load_members,
                                                normalize_npz_path,
                                                pack_ensemble, save_members)

__all__ = ["EnsembleTrainer", "EnsemblePredictor", "save_members",
           "load_members", "pack_ensemble", "normalize_npz_path"]

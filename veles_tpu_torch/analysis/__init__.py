"""The port's analysis package: so far only the runtime lock-order
witness (:mod:`veles_tpu_torch.analysis.witness`), the counterpart of
``veles_tpu/analysis/witness.py``.  The reference's static rules
(veleslint) come with a later slice."""

"""The online-learning tier of the hive (the port's counterpart of
``veles_tpu/online/``).

A served model is frozen at package time; this tier fine-tunes it
inside the serving process, on the device:

- :mod:`~veles_tpu_torch.online.tap`: a deterministic fraction of
  admitted request rows (``$VELES_ONLINE_TAP_FRAC``), with their labels
  (the ``label`` wire field, or a late ``label_of`` join by wire id),
  mirrors into
- :mod:`~veles_tpu_torch.online.buffer`: a bounded reservoir-sampled
  replay buffer, uint8 when the model's dequantization round-trips the
  rows, its bytes charged against the residency budget;
- :mod:`~veles_tpu_torch.online.trainer`: the scavenger, a fine-tune
  micro-step (the fused train body under ``torch.func.vmap`` over the
  ensemble's member axis) that fires only when every serving batcher is
  idle, within the SLO headroom and the duty cycle;
- :mod:`~veles_tpu_torch.online.promote`: the gate, which scores shadow
  against incumbent on the tap's held-out slice and promotes past
  ``$VELES_ONLINE_PROMOTE_MARGIN`` by swapping the params on the device
  under the residency lock, or rolls the shadow back.
"""

from veles_tpu_torch.online.buffer import ReplayBuffer  # noqa: F401
from veles_tpu_torch.online.promote import GATE_STATES  # noqa: F401
from veles_tpu_torch.online.tap import TrafficTap  # noqa: F401
from veles_tpu_torch.online.trainer import OnlineLearner  # noqa: F401

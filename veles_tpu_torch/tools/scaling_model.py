"""Analytic data-parallel scaling model (the port's counterpart of
``scripts/scaling_model.py``).

A card count the machine does not have cannot be measured; what can be
written down is the communication arithmetic a claim rests on, fed by a
step time measured on ONE card:

  per-card step time        T_c   the caller's, read on a card it names
  gradient all-reduce bytes B     the sum of the param sizes (the model)
  ring all-reduce traffic   2 * B * (N-1)/N sent per card per step
  scaling efficiency        T_c / (T_c + T_comm exposed)

The port sums each layer's gradients over the group inside the
backward (``engine/core.py`` ``build_backward``), once a minibatch, so
the model works at minibatch granularity.  The table gives the worst
case (no overlap of the all-reduce with compute) and the best (full
overlap); hardware lies between the two.

Interconnect rates are the H100's published per-direction spec values,
not measurements (:data:`LINKS`).  There is no default step time: no
number taken on another device carries over.

    python -m veles_tpu_torch.tools.scaling_model --step-ms MS \\
        --card "NVIDIA H100 80GB HBM3, 700.00 W" [--minibatch 128]

prints one JSON object: AlexNet-1000's f32 param bytes, the table a
link for a ring of :data:`N_CARDS` cards (the reference's 8), and the
row-sharded residency of ``--minibatch`` x 8 distinct 227x227x3 f32
rows over them (:func:`sharded_residency_prediction`).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, List, Optional

import numpy as np

#: per-direction bytes/s of the interconnects an H100 all-reduce crosses,
#: from NVIDIA's datasheets (spec values, not readings): NVLink 4 on the
#: SXM part, 900 GB/s in all, so 450 a direction; PCIe Gen5 x16, 128 GB/s
#: in all, 64 a direction
LINKS = (("nvlink4_sxm", 450e9), ("pcie_gen5_x16", 64e9))
#: cards in the modelled ring, the reference's
N_CARDS = 8


def param_bytes(forwards: Iterable, dtype_bytes: int = 4) -> int:
    """Bytes of every param of initialized forwards (their
    ``input_shape`` set) at ``dtype_bytes`` an element."""
    total = 0
    for f in forwards:
        for shape in f.param_shapes(f.input_shape).values():
            total += int(np.prod(shape)) * dtype_bytes
    return total


def sharded_residency_prediction(n_rows: int, row_bytes: int,
                                 n_devices: int) -> dict:
    """Bytes a device of a row-sharded resident data set: the rows
    padded to a whole tile a device, 1/N of them a device.  A replicated
    set costs ``n_rows * row_bytes`` on every device; sharding divides
    it by N for at most one padded row a device."""
    rows_padded = -(-int(n_rows) // int(n_devices)) * int(n_devices)
    per_device = rows_padded // int(n_devices) * int(row_bytes)
    return {
        "n_rows": int(n_rows),
        "rows_padded": int(rows_padded),
        "n_devices": int(n_devices),
        "per_device_bytes": int(per_device),
        "replicated_per_device_bytes": int(n_rows) * int(row_bytes),
        "reduction_x": round(
            (int(n_rows) * int(row_bytes)) / max(per_device, 1), 3),
    }


def scaling_rows(param_bytes_f32: int, step_ms: float) -> List[dict]:
    """One row a link: the ring all-reduce's bytes a card a step, their
    ms at the link's rate, and the scaling at no and at full overlap."""
    rows = []
    traffic = 2.0 * param_bytes_f32 * (N_CARDS - 1) / N_CARDS
    for name, rate in LINKS:
        t_comm_ms = traffic / rate * 1000.0
        worst = step_ms / (step_ms + t_comm_ms)
        rows.append({
            "link": name, "spec_GBps_per_direction": rate / 1e9,
            "allreduce_MB_per_card_per_step": round(traffic / 1e6, 1),
            "t_comm_ms": round(t_comm_ms, 3),
            "scaling_x_zero_overlap": round(N_CARDS * worst, 3),
            "scaling_x_full_overlap": float(N_CARDS)})
    return rows


def alexnet_forwards():
    """AlexNet-1000's forward chain with its shapes, no data and no
    params drawn."""
    from veles_tpu_torch.models import alexnet

    class _Launcher:
        workflow = None

    w = alexnet.create_workflow(_Launcher())
    w.initialize()
    return w.forwards


def model(step_ms: float, card: str, minibatch: int = 128,
          forwards=None) -> dict:
    """The whole table for a step of ``step_ms`` ms read on ``card``."""
    if not step_ms or step_ms <= 0:
        raise ValueError("step_ms must be a positive measured step time")
    if not card:
        raise ValueError("card must name where step_ms was measured")
    b = param_bytes(alexnet_forwards() if forwards is None else forwards)
    row_b = 227 * 227 * 3 * 4
    return {"model": "AlexNet-1000", "param_bytes_f32": b,
            "per_card_minibatch": int(minibatch),
            "measured_step_ms": float(step_ms), "measured_on": card,
            "n_cards": N_CARDS,
            "links_are": "published spec values, not measurements",
            "rows": scaling_rows(b, float(step_ms)),
            "sharded_residency": sharded_residency_prediction(
                minibatch * 8, row_b, N_CARDS)}


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="veles_tpu_torch.tools.scaling_model",
                                description=__doc__.split("\n")[0])
    p.add_argument("--step-ms", type=float, required=True,
                   help="one card's measured ms a training minibatch")
    p.add_argument("--card", required=True,
                   help="the card the step was read on, with its power "
                        "limit (nvidia-smi's name and power.limit)")
    p.add_argument("--minibatch", type=int, default=128,
                   help="rows a card a minibatch (default 128)")
    args = p.parse_args(argv)
    try:
        out = model(args.step_ms, args.card, args.minibatch)
    except ValueError as e:
        print(f"scaling_model: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The rank layout, the process group, and the three placements.

Counterpart of ``veles_tpu/parallel/mesh.py``.  The reference is one
process driving a ``jax.sharding.Mesh`` of N devices; the port runs one
process per rank, each owning one device, and the collectives are
explicit ``torch.distributed`` calls.  Only ``all_reduce`` and
``broadcast`` are used, so both backends serve every collective: NCCL
when every rank owns a card, gloo on the CPU and when several ranks
share one card (``$VELES_MESH_RANKS_PER_CARD``, the counterpart of the
reference's virtual devices: NCCL refuses two ranks on one GPU).

- :func:`env_layout` reads the layout ``torchrun`` exports (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), the
  port's counterpart of ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_COORDINATOR_ADDRESS``.
- :func:`init_group` joins the group over a ``TCPStore`` hosted by rank
  0 and returns the rank's :class:`RankGroup`: its device (``cuda:``
  ``LOCAL_RANK // ranks_per_card``, or the CPU), the store (the
  liveness watchdog's key-value channel) and the collectives.  Fewer
  visible cards than the layout needs is refused, as ``make_mesh``
  refuses: a rank never quietly shares a card or falls back to the CPU.
- Placements, per rank: **replicated** is a plain ``device.put`` on
  every rank (params, scalars, data sets that fit one device's budget);
  **row-sharded** (:func:`put_row_sharded`) keeps rank r's
  ``padded_rows(R, N) / N`` rows, the tail zero-padded to a whole tile;
  **member-sharded** (:func:`put_member_sharded`) keeps rank r's P/N
  members of a stacked member axis already padded to a multiple of N.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import knobs

#: how long joining the group and a collective may wait for a peer; a
#: dead peer is caught sooner by the liveness watchdog
#: (``launcher.py``, ``$VELES_MULTIHOST_DEADLINE``)
GROUP_TIMEOUT = datetime.timedelta(seconds=600)

#: the torchrun variables a rank joins from
LAYOUT_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK")


def env_layout(environ: Optional[Dict[str, str]] = None) -> Optional[dict]:
    """``{"addr", "port", "world_size", "rank", "local_rank"}`` from the
    torchrun variables, or None when any of them is unset
    (``LOCAL_RANK`` defaults to ``RANK``)."""
    env = os.environ if environ is None else environ
    need = [v for v in LAYOUT_VARS if v != "LOCAL_RANK" and not env.get(v)]
    if need:
        return None
    rank = int(env["RANK"])
    return {"addr": env["MASTER_ADDR"], "port": int(env["MASTER_PORT"]),
            "world_size": int(env["WORLD_SIZE"]), "rank": rank,
            "local_rank": int(env.get("LOCAL_RANK") or rank)}


def ranks_per_card() -> int:
    return max(1, int(knobs.get(knobs.MESH_RANKS_PER_CARD)))


def check_cards(local_ranks: int, backend: str) -> None:
    """Refuse a layout of ``local_ranks`` ranks on this host that the
    visible cards cannot hold at ``$VELES_MESH_RANKS_PER_CARD`` ranks a
    card (a ValueError naming the knob).  The CPU holds any number."""
    if backend == "cpu":
        return
    per = ranks_per_card()
    need = -(-int(local_ranks) // per)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise ValueError(
            f"{local_ranks} ranks need {need} CUDA card(s) at {per} "
            f"rank(s) a card, only {have} visible; set "
            f"{knobs.MESH_RANKS_PER_CARD}=N to put N ranks on one card "
            f"(over gloo), or pass -b cpu")


class RankGroup:
    """One rank's view of the data-parallel group: its rank, the group's
    size, its device, the store, and the two collectives the port uses.
    ``stats[kind]`` counts the calls of each kind (``grads``, ``gather``,
    ``metrics``, ``stop``, ``broadcast``) and the seconds spent in them:
    the host's clock around each synchronous call, which for a CUDA
    tensor includes waiting for the kernels that made it."""

    def __init__(self, rank: int, world_size: int, device: torch.device,
                 backend: str = "gloo", store: Any = None,
                 layout: Optional[dict] = None) -> None:
        #: the env_layout the group joined from (the watchdog's store
        #: clients connect to its address)
        self.layout = layout
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.backend = backend
        self.store = store
        #: kind -> [calls, seconds]
        self.stats: Dict[str, list] = {}

    def _timed(self, kind: str, fn, *args) -> None:
        import time
        t0 = time.perf_counter()
        fn(*args)
        st = self.stats.setdefault(kind, [0, 0.0])
        st[0] += 1
        st[1] += time.perf_counter() - t0

    def all_reduce_(self, t: torch.Tensor, kind: str = "metrics"
                    ) -> torch.Tensor:
        """Sum ``t`` over the group in place; returns it."""
        import torch.distributed as dist
        if dist.is_initialized():
            self._timed(kind, dist.all_reduce, t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        import torch.distributed as dist
        if dist.is_initialized():
            self._timed("broadcast", dist.broadcast, t, src)
        return t

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any rank."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.all_reduce_(t, "stop").item() > 0)

    def rows(self, total: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``total`` rows (``total`` a
        multiple of the group's size)."""
        per = int(total) // self.world_size
        return self.rank * per, (self.rank + 1) * per

    def __repr__(self) -> str:
        return (f"<RankGroup {self.rank}/{self.world_size} "
                f"{self.backend} on {self.device}>")


def init_group(layout: dict, backend: str) -> RankGroup:
    """Join the group ``layout`` describes (:func:`env_layout`) on
    ``backend`` ("cpu" or "cuda"), and return this rank's group.  The
    TCPStore is hosted by rank 0 at ``addr:port``."""
    import torch.distributed as dist

    world, rank = layout["world_size"], layout["rank"]
    if backend == "cpu":
        device, pg_backend = torch.device("cpu"), "gloo"
    else:
        per = ranks_per_card()
        card = layout["local_rank"] // per
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if card >= have:
            raise ValueError(
                f"rank {rank} (local rank {layout['local_rank']}) needs "
                f"CUDA card {card} at {per} rank(s) a card, only {have} "
                f"visible; set {knobs.MESH_RANKS_PER_CARD}=N to share a "
                f"card, or pass -b cpu")
        device = torch.device("cuda", card)
        torch.cuda.set_device(device)
        pg_backend = "gloo" if per > 1 else "nccl"
    store = dist.TCPStore(layout["addr"], layout["port"], world,
                          is_master=rank == 0, timeout=GROUP_TIMEOUT)
    dist.init_process_group(pg_backend, store=store, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    return RankGroup(rank, world, device, pg_backend, store, layout)


def is_writer() -> bool:
    """True where this process writes shared files (snapshots): outside
    a process group, or on its rank 0."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def shard_mode(value: str) -> str:
    """Normalize a ``VELES_MESH_SHARD_*`` knob or constructor value to
    one of ``"never"`` / ``"auto"`` / ``"always"``."""
    v = str(value).strip().lower()
    if v in ("0", "never", "false", "no", "off"):
        return "never"
    if v in ("1", "always", "true", "yes", "on"):
        return "always"
    return "auto"


def padded_rows(n_rows: int, n_ranks: int) -> int:
    """Leading-axis length after padding to a whole per-rank tile (the
    padded rows are placement filler: no loader index points at them)."""
    return -(-int(n_rows) // int(n_ranks)) * int(n_ranks)


def put_row_sharded(group: RankGroup, device: Any, array: np.ndarray
                    ) -> Tuple[torch.Tensor, int]:
    """Rank r's ``padded_rows(R, N) / N`` rows of ``array`` on
    ``device`` (the tail zero-padded), and R.  Consumers never index
    past R."""
    n = group.world_size
    n_real = len(array)
    per = padded_rows(n_real, n) // n
    lo = group.rank * per
    rows = np.asarray(array[lo:min(lo + per, n_real)])
    if len(rows) < per:
        rows = np.concatenate(
            [rows, np.zeros((per - len(rows),) + rows.shape[1:],
                            rows.dtype)])
    return device.put(rows), n_real


def put_member_sharded(group: RankGroup, device: Any, array: np.ndarray
                       ) -> torch.Tensor:
    """Rank r's P/N members of a stacked member axis on ``device``; the
    caller has padded P to a multiple of N."""
    n = group.world_size
    if len(array) % n:
        raise ValueError(f"member axis {len(array)} not a multiple of the "
                         f"{n}-rank group; pad members first")
    per = len(array) // n
    return device.put(array[group.rank * per:(group.rank + 1) * per])

"""The two layouts of several devices, and the three placements.

Counterpart of ``veles_tpu/parallel/mesh.py``.  The reference is one
process driving a ``jax.sharding.Mesh`` of N devices.  The port has two
layouts, one for each of the reference's uses of its mesh:

- **A rank group (data parallelism, ROADMAP item 10a).**  One process a
  rank, each owning one device; the collectives are explicit
  ``torch.distributed`` calls.  Only ``all_reduce`` and ``broadcast``
  are used, so both backends serve every collective: NCCL when every
  rank owns a card, gloo on the CPU and when several ranks share one
  card (``$VELES_MESH_RANKS_PER_CARD``, the counterpart of the
  reference's virtual devices: NCCL refuses two ranks on one GPU).
  :func:`env_layout` reads the layout ``torchrun`` exports (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), the
  port's counterpart of ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_COORDINATOR_ADDRESS``; :func:`init_group` joins the group over a
  ``TCPStore`` hosted by rank 0 and returns the rank's
  :class:`RankGroup`: its device (``cuda:`` ``LOCAL_RANK //
  ranks_per_card``, or the CPU), the store (the liveness watchdog's
  key-value channel) and the collectives.
- **A mesh of places (member sharding, item 10b).**  One process owning
  N places, each a torch device (:func:`make_mesh`, :class:`Mesh`): a
  ``--mesh N`` hive replica and the GA evaluator's ``--dp N``, as in the
  reference (``veles_tpu/serve/hive.py:233-245``,
  ``veles_tpu/genetics/worker.py:204-211``).  Members are independent,
  so nothing crosses places inside a step: each place runs its P/N
  members, and the only moves are copies of a minibatch or a request's
  rows to each place and of results back to the head place (place 0).
  On CUDA, place i is ``cuda:(i // $VELES_MESH_RANKS_PER_CARD)``: the
  knob says how many places a card holds, and they share its memory.

Fewer visible cards than a layout needs is refused (:func:`check_cards`,
a ValueError naming the knob): a rank or a place never quietly shares a
card or falls back to the CPU.  On the CPU every rank and place is
``cpu``.

Placements: **replicated** is a plain ``device.put`` on every rank
(params, scalars, data sets that fit one device's budget), and one copy a
place on a mesh (``MeshDevice.put_replicated``); **row-sharded** keeps
rank r's, or place r's, ``padded_rows(R, N) / N`` rows, the tail
zero-padded to a whole tile (:func:`put_row_sharded`,
``MeshDevice.put_sharded``); **member-sharded**
(:func:`put_member_sharded`) puts place r's P/N members of a stacked
member axis already padded to a multiple of N (``batching.pad_members``)
on place r.
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


def check_cards(local_ranks: int, backend: str, what: str = "rank"
                ) -> None:
    """Refuse a layout of ``local_ranks`` ranks (or mesh places, ``what
    ="place"``) on this host that the visible cards cannot hold at
    ``$VELES_MESH_RANKS_PER_CARD`` a card (a ValueError naming the
    knob).  The CPU holds any number."""
    if backend == "cpu":
        return
    per = ranks_per_card()
    need = -(-int(local_ranks) // per)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        how = " (over gloo)" if what == "rank" else ""
        raise ValueError(
            f"{local_ranks} {what}s need {need} CUDA card(s) at {per} "
            f"{what}(s) a card, only {have} visible; set "
            f"{knobs.MESH_RANKS_PER_CARD}=N to put N {what}s on one card"
            f"{how}, or pass -b cpu")


class Mesh:
    """N places of one process, each a torch device; place 0 is the
    head, where unsharded work and every result lands.  ``per_card``
    is how many places share one card (1 on the CPU, where every place
    is ``cpu``)."""

    def __init__(self, places, per_card: int = 1) -> None:
        self.places = tuple(torch.device(p) for p in places)
        if not self.places:
            raise ValueError("a mesh needs at least one place")
        self.per_card = int(per_card)

    @property
    def size(self) -> int:
        return len(self.places)

    @property
    def head(self) -> torch.device:
        return self.places[0]

    def sharing(self, i: int) -> int:
        """How many places share place ``i``'s device (its memory)."""
        return sum(p == self.places[i] for p in self.places)

    def place_memory(self) -> Optional[int]:
        """One place's share of its card's memory (the least over the
        places: a budget must fit every place), or None on the CPU."""
        if self.head.type != "cuda":
            return None
        return min(int(torch.cuda.get_device_properties(p).total_memory)
                   // self.sharing(i) for i, p in enumerate(self.places))

    def __repr__(self) -> str:
        return f"<Mesh {self.size} places {[str(p) for p in self.places]}>"


def make_mesh(n: int, backend: str = "cpu") -> Mesh:
    """A mesh of ``n`` places on ``backend`` ("cpu", or "auto" / "cuda"
    / "gpu"): on CUDA place i is ``cuda:(i // ranks_per_card())``, and
    fewer visible cards than that needs is refused (:func:`check_cards`,
    a ValueError naming the knob); on the CPU every place is ``cpu``.
    The counterpart of ``veles_tpu/parallel/mesh.py`` ``make_mesh``."""
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one place, got {n}")
    if backend == "cpu":
        return Mesh([torch.device("cpu")] * n)
    check_cards(n, backend, what="place")
    per = ranks_per_card()
    return Mesh([torch.device("cuda", i // per) for i in range(n)], per)


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


def shard_rows(nbytes: int) -> bool:
    """Whether a split of ``nbytes`` goes row-sharded over a mesh's
    places (the reference's ``attach_dataset`` decision,
    ``veles_tpu/ops/fused.py:985-1000``): ``$VELES_MESH_SHARD_DATA``
    ``always``, or ``auto`` and over ``$VELES_MAX_RESIDENT_BYTES``."""
    mode = shard_mode(knobs.get(knobs.MESH_SHARD_DATA))
    return mode == "always" or (
        mode == "auto" and nbytes > int(knobs.get(knobs.MAX_RESIDENT_BYTES)))


def padded_rows(n_rows: int, n_ranks: int) -> int:
    """Leading-axis length after padding to a whole per-rank tile (the
    padded rows are placement filler: no loader index points at them)."""
    return -(-int(n_rows) // int(n_ranks)) * int(n_ranks)


def row_tile(array: np.ndarray, r: int, n: int) -> np.ndarray:
    """Tile ``r`` of ``n``: rows ``[r * T, (r + 1) * T)`` of ``array``
    with ``T = padded_rows(R, n) / n``, the tail zero-padded."""
    n_real = len(array)
    per = padded_rows(n_real, n) // n
    lo = r * per
    rows = np.asarray(array[lo:min(lo + per, n_real)])
    if len(rows) < per:
        rows = np.concatenate(
            [rows, np.zeros((per - len(rows),) + rows.shape[1:],
                            rows.dtype)])
    return rows


def put_row_sharded(group: RankGroup, device: Any, array: np.ndarray
                    ) -> Tuple[torch.Tensor, int]:
    """Rank r's ``padded_rows(R, N) / N`` rows of ``array`` on
    ``device`` (the tail zero-padded), and R.  Consumers never index
    past R."""
    return device.put(row_tile(array, group.rank, group.world_size)), \
        len(array)


def put_member_sharded(mesh: Mesh, device: Any, array: np.ndarray
                       ) -> list:
    """Place p's P/N members of a stacked member axis on place p, for
    every place of ``mesh``: the list of tiles, put through ``device``
    (whose ``h2d_bytes`` is charged the padded total once).  The caller
    has padded P to a multiple of N (``batching.pad_members``)."""
    n = mesh.size
    if len(array) % n:
        raise ValueError(f"member axis {len(array)} not a multiple of the "
                         f"{n}-place mesh; pad members first")
    per = len(array) // n
    return [device.put(array[i * per:(i + 1) * per], to=place)
            for i, place in enumerate(mesh.places)]

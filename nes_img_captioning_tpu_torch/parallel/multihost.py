"""Multi-process runs (port of ``nes_img_captioning_tpu/parallel/multihost.py``).

The reference scales across nodes with a TCP Redis master, per-node relay
mirrors and a shared filesystem for .pth transport (reference:
src/dist.py, SURVEY.md §2.2). Here every process runs the same program:
``torch.distributed`` wires them through a ``tcp://`` rendezvous, each
rank rolls out its shard of the population (``mesh.ShardPlan``), and
nothing is pickled between them but the rendezvous' own bookkeeping.

What a run needs:

* ``tpu.seed``: every rank draws the same seed and batch streams, so the
  ranks see the same inputs with no host-to-host traffic (the masters
  refuse a group without it);
* file writes on the primary only: a non-primary rank keeps its
  bookkeeping in a private scratch directory (``master_base.
  setup_log_dir``), so its host logic stays the primary's bit for bit.

The rendezvous is a ``TCPStore``. Ranks joined by ``--coordinator`` meet
at rank 0's address, where rank 0 binds the store. Ranks that one process
starts on its host (``main.py`` with ``tpu.mesh_shape``) meet at a store
that the starting process binds to port 0 and holds until they end
(``hold_rendezvous``): no port is chosen, released and bound again, so no
other process can take it in between. A group of one needs no socket.

Each rank's device is explicit: ``cuda:{rank % device_count}`` unless the
caller names one. The backend follows one rule, logged at start: NCCL when
every rank has a card of its own; gloo on the CPU, or when two ranks share
a card (NCCL refuses two ranks on one device). The default group is gloo
either way (it carries the exchange of each rank's host and device that
the rule reads), and NCCL, when chosen, is a group over all ranks beside
it. Nothing retries with another backend after a failure.

The process group is process-wide state in ``torch.distributed`` itself;
``current_group`` hands this process's ``RankGroup`` to the masters.
"""

from __future__ import annotations

import datetime
import logging
import socket

import torch

from .mesh import RankGroup
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["current_group", "hold_rendezvous", "init_multihost",
           "is_primary", "process_count", "shutdown_multihost"]

# a collective or the rendezvous waiting this long fails the run
TIMEOUT = datetime.timedelta(seconds=600)

_GROUP: RankGroup | None = None


def hold_rendezvous(world: int, timeout: datetime.timedelta = TIMEOUT):
    """The store of a group of ``world`` ranks that this process starts on
    its host, bound to a port the system picks and held while the returned
    object lives: pass ``store.port`` to the ranks, which join it with
    ``init_multihost(f"127.0.0.1:{port}", ..., launcher_store=True)``."""
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                         timeout=timeout, wait_for_workers=False)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` for this rank: None or a bare "cuda" means the card
    ``rank % device_count``; a rank with no card raises unless it asks for
    the CPU (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None,
                   timeout: datetime.timedelta = TIMEOUT,
                   launcher_store: bool = False) -> int:
    """Join the group of ``num_processes`` ranks as rank ``process_id``,
    rendezvous at ``coordinator`` ("host:port": rank 0 binds the store
    there, or with ``launcher_store`` the process that started the ranks
    holds it, ``hold_rendezvous``, and every rank connects; none for a
    group of one). No-op without ``num_processes``. ``device``: as
    ``_rank_device``; ``timeout`` bounds the rendezvous and every
    collective. Returns this process's rank."""
    global _GROUP
    import torch.distributed as dist

    if num_processes is None:
        return 0
    if _GROUP is not None:
        raise RuntimeError(f"this process is rank {_GROUP.rank} of a group "
                           "already")
    if num_processes < 1 or process_id is None \
            or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id!r} of {num_processes} "
                         "processes")
    if coordinator is None and num_processes > 1:
        raise ValueError("--coordinator host:port (rank 0's) is needed for "
                         "more than one process")
    dev = _rank_device(device, process_id)
    if coordinator is None:
        store = dist.HashStore()
    else:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0 and not launcher_store,
                              timeout=timeout)
    dist.init_process_group("gloo", store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    peers = [None] * num_processes
    dist.all_gather_object(peers, (socket.gethostname(), str(dev)))
    own_cards = (all(d.startswith("cuda") for _, d in peers)
                 and len(set(peers)) == num_processes)
    if own_cards:
        torch.cuda.set_device(dev)
        group = dist.new_group(backend="nccl", timeout=timeout)
        backend, why = "nccl", "every rank has a card of its own"
    else:
        group = None
        backend = "gloo"
        why = ("the ranks run on the CPU" if dev.type == "cpu" else
               "ranks share a card; CUDA tensors are staged through pinned "
               "host memory")
    _GROUP = RankGroup(process_id, num_processes, dev, backend, group)
    logger.info("rank %d of %d on %s (host %s): collectives over %s, as %s",
                process_id, num_processes, dev, socket.gethostname(),
                backend, why)
    return process_id


def current_group() -> RankGroup | None:
    """This process's ``RankGroup``, None outside a group."""
    return _GROUP


def shutdown_multihost():
    """Leave the group (no-op outside one)."""
    global _GROUP
    import torch.distributed as dist

    if _GROUP is None:
        return
    _GROUP = None
    dist.destroy_process_group()


def is_primary() -> bool:
    return _GROUP is None or _GROUP.rank == 0


def process_count() -> int:
    return 1 if _GROUP is None else _GROUP.world

"""The population sharded over processes (port of ``nes_img_captioning_tpu/parallel/mesh.py``).

The reference's only scaling axis is population parallelism: N stateless
worker processes pulling (mutation, batch) tasks through Redis (reference:
src/dist.py, SURVEY.md §2.10). The JAX package shards the population axis
of a device mesh. Here the axis is the ranks of a ``torch.distributed``
group (``multihost.init_multihost``): every rank draws the same seeds and
batches from the shared ``tpu.seed``, rolls out its own contiguous shard of
the population, and the ranks exchange only the shard's fitnesses
(``all_gather``) and, for NES, one partial gradient (``all_reduce_sum``).
Theta, the parents and everything else are whole on every rank.

A shard plan (``ShardPlan``) pads the population up to ``world * per_rank``
members by repeating the last one, as ``engine_base._lay_out`` pads a
sweep: pad members are rolled out (valid inputs, redundant work), their
results are dropped and their gradient weight is 0.

Both collectives return the same bits on every rank and do not depend on
the backend's reduction order: ``all_reduce_sum`` gathers the partial sums
and adds them in rank order on each rank. Over gloo, CUDA tensors are
staged through pinned host memory explicitly (``RankGroup.staged``, logged
at start by ``init_multihost``); NCCL takes them where they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RankGroup", "ShardPlan", "all_gather", "all_reduce_sum",
           "make_mesh", "pop_axis_size", "shard_plan"]


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """One process's place in the group: its rank of ``world``, its
    device, and the backend and process group of the collectives
    (``group`` None: the default group)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: object = None

    @property
    def staged(self) -> bool:
        """Whether a CUDA tensor goes through host memory for a collective
        (gloo's CUDA collectives are not all there: every one is staged)."""
        return self.backend == "gloo"


def make_mesh(mesh_shape=None) -> RankGroup | None:
    """The population mesh of this process: its ``RankGroup`` after
    ``init_multihost``, else None (one process, no collectives). A
    ``mesh_shape`` must hold as many ranks as the group."""
    from .multihost import current_group

    group = current_group()
    if mesh_shape:
        n = int(np.prod(mesh_shape))
        world = pop_axis_size(group)
        if n != world:
            raise ValueError(
                f"tpu.mesh_shape {list(mesh_shape)} holds {n} ranks; this "
                f"process group has {world}")
    return group


def pop_axis_size(mesh: RankGroup | None) -> int:
    return mesh.world if mesh is not None else 1


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous shards of an ``n``-member population over ``world``
    ranks: rank r holds members ``r * per_rank`` .. ``(r + 1) * per_rank -
    1``, those past ``n - 1`` repeating member ``n - 1`` (pads)."""

    n: int
    world: int = 1
    rank: int = 0

    @property
    def per_rank(self) -> int:
        return -(-self.n // self.world)

    def _span(self, rank) -> np.ndarray:
        r = self.rank if rank is None else rank
        return np.arange(r * self.per_rank, (r + 1) * self.per_rank)

    def index(self, rank: int | None = None) -> np.ndarray:
        """The population index of each of a rank's members (this rank's
        by default), pads included."""
        return np.minimum(self._span(rank), self.n - 1)

    def real(self, rank: int | None = None) -> np.ndarray:
        """Which of a rank's members are real (not pads)."""
        return self._span(rank) < self.n

    def local(self, arr):
        """A host array's rows (n, ...) -> this rank's (per_rank, ...)."""
        return np.asarray(arr)[self.index()]

    def local_weights(self, w: torch.Tensor) -> torch.Tensor:
        """Per-member weights (n,) -> this rank's (per_rank,), pads 0."""
        lo = self.rank * self.per_rank
        part = w[lo:lo + self.per_rank]
        return torch.nn.functional.pad(part, (0, self.per_rank - part.shape[0]))


def shard_plan(mesh: RankGroup | None, n: int) -> ShardPlan:
    """The shard plan of an ``n``-member sweep on this rank (one shard of
    everything without a group)."""
    if mesh is None:
        return ShardPlan(n)
    return ShardPlan(n, mesh.world, mesh.rank)


def all_gather(mesh: RankGroup, t: torch.Tensor) -> torch.Tensor:
    """Each rank's (k, ...) tensor -> (world * k, ...), rank 0's rows first,
    on ``t``'s device, the same on every rank."""
    import torch.distributed as dist

    src = t.detach().contiguous()
    if mesh.staged and src.is_cuda:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        src = host.copy_(src)
    elif not mesh.staged:
        src = src.to(mesh.device)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def all_reduce_sum(mesh: RankGroup, t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of each rank's ``t``, added in rank order on every
    rank (((t_0 + t_1) + t_2) ...), so every rank gets the same bits
    whatever the backend's own reduction order."""
    parts = all_gather(mesh, t[None])
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc

"""Shared population-engine machinery (port of ``nes_img_captioning_tpu/algorithms/engine_base.py``).

A sweep is laid out as (n_chunks, chunk, ...): one kernel launch per chunk,
n_chunks launches in sequence bounding live memory to chunk x dim. The
population is padded up to n_chunks * chunk by repeating the final member;
results are sliced back to the true count and callers give pad lanes
gradient weight 0.

Under a process group (``mesh``, ``parallel/mesh.py``) each rank sweeps
its own contiguous shard of the population (``_shard``: a ``ShardPlan``)
in those waves, and the engines gather the shard's fitnesses in
population order (``_gather``, ``host_fitness``) and sum NES's partial
gradients in rank order (``_reduce``). The JAX package shards each wave
over its devices instead, with the chunk rounded up to a mesh multiple;
either way every member is rolled out once and pads weigh 0.

Both engines also share the SM-G sensitivity settings and their host
operands: the batch rows and the probe estimator's matrix (``probes_of``,
the tests' seam), sent to the card without a host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sensitivity import probe_matrix, resolve_probes
from ..parallel.mesh import all_gather, all_reduce_sum, shard_plan

__all__ = ["PopulationEngine", "to_device"]


def to_device(arr, device) -> torch.Tensor:
    """A host array on ``device`` without a host sync: on the card through
    pinned memory and a non-blocking copy."""
    t = torch.as_tensor(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class PopulationEngine:
    def __init__(self, task, pop_chunk: int = 0, mutation=None,
                 sens_underflow: float = 0.01,
                 sens_precision: str = "float32", sens_probes: int = 0,
                 mesh=None):
        """``sens_*``: the SM-G sweep's underflow, product precision
        (``tpu.sensitivity_precision``) and probe count
        (``tpu.sensitivity_probes``, SM-G-SUM only) for ``mutation``;
        ``mesh``: this rank's ``RankGroup``, None for one process."""
        self.task = task
        self.pop_chunk = pop_chunk
        self.mesh = mesh
        self.dim = task.spec.num_params
        self.mutation = mutation
        self._sens_underflow = float(sens_underflow)
        self._sens_precision = sens_precision
        self._sens_probes = (resolve_probes(mutation, sens_probes)
                             if mutation is not None else 0)

    def probes_of(self, seed0: int, probes: int, groups: int):
        """The (probes, groups) Rademacher matrix of the generation whose
        member-0 seed is ``seed0`` (``ops/sensitivity.probe_matrix``, on
        the host). Tests replace this with the JAX package's matrix."""
        return probe_matrix(seed0, probes, groups)

    def _sens_operands(self, sens_idx, seed0: int, device):
        """(the batch rows ``sens_idx`` as a long tensor, the probe matrix
        of ``seed0`` or None) on ``device``."""
        idx_d = to_device(np.asarray(sens_idx, np.int64), device)
        if not self._sens_probes:
            return idx_d, None
        return idx_d, to_device(np.array(self.probes_of(
            seed0, self._sens_probes, self.task.sensitivity_groups),
            np.float32), device)

    # ---- the population over the ranks --------------------------------------

    def _shard(self, n: int):
        """This rank's ``ShardPlan`` of an n-member sweep (all of it
        without a group)."""
        return shard_plan(self.mesh, n)

    def _gather(self, local: torch.Tensor, plan) -> torch.Tensor:
        """The rank's (per_rank, ...) results -> the population's (n, ...),
        in population order, on every rank."""
        if self.mesh is not None:
            local = all_gather(self.mesh, local)
        return local[:plan.n]

    def _reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """A rank's partial sum -> the sum over ranks in rank order (the
        same bits on every rank)."""
        return partial if self.mesh is None else all_reduce_sum(self.mesh,
                                                                partial)

    def host_fitness(self, artifacts, idx, n: int) -> np.ndarray:
        """The fitnesses of an n-member sweep from its artifacts (the
        rank's shard under a group): ``task.host_fitness`` of the rank's
        members, gathered in population order. idx: (B,), the batch of
        every member, or (n, B), each member's own (its rows of the rank's
        members are taken here)."""
        plan = self._shard(n)
        idx = np.asarray(idx)
        fit = np.asarray(self.task.host_fitness(
            artifacts, plan.local(idx) if idx.ndim > 1 else idx))
        return self._gather(torch.from_numpy(fit), plan).numpy()

    def _plan(self, n: int) -> tuple[int, int]:
        """(n_waves, chunk) for an n-member sweep: the chunk defaults to the
        full population and is capped at n."""
        chunk = max(min(self.pop_chunk or n, n), 1)
        return -(-n // chunk), chunk

    @staticmethod
    def _lay_out(arr: np.ndarray, n_chunks: int, chunk: int) -> np.ndarray:
        """(N, ...) host array -> (n_chunks, chunk, ...) padded by repeating
        the last member."""
        arr = np.asarray(arr)
        pad = n_chunks * chunk - arr.shape[0]
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
        return arr.reshape(n_chunks, chunk, *arr.shape[1:])

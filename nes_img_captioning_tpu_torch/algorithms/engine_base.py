"""Shared population-engine machinery (port of ``nes_img_captioning_tpu/algorithms/engine_base.py``).

A sweep is laid out as (n_chunks, chunk, ...): one kernel launch per chunk,
n_chunks launches in sequence bounding live memory to chunk x dim. The
population is padded up to n_chunks * chunk by repeating the final member;
results are sliced back to the true count and callers give pad lanes
gradient weight 0. One card: the chunk is not rounded to a mesh multiple.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PopulationEngine"]


class PopulationEngine:
    def __init__(self, task, pop_chunk: int = 0):
        self.task = task
        self.pop_chunk = pop_chunk
        self.dim = task.spec.num_params

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

"""Host-side epoch index sampler (port of ``nes_img_captioning_tpu/data/core.py``).

numpy only: the index stream is drawn on the host and the batches are
gathered on the device by the task (``train_fc[idx]``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["EpochSampler", "build_sampler"]


class EpochSampler:
    """Shuffled epoch index stream.

    Mirrors the reference's shuffle-per-epoch dataloaders
    (src/algorithm/tools/experiment.py:84-90, captioning BlobFetcher
    shuffle-on-wrap). ``batch(bs)`` yields consecutive index vectors from a
    per-epoch permutation; ``member_batches(F, bs)`` draws F independent
    batches for the reference's single_batch=false regime where every worker
    advances its own loader (src/algorithm/nic_nes/nic_nes_worker.py:121-128)
    — statistically equivalent to F independent loader positions.
    """

    def __init__(self, n: int, seed: int | None = 0):
        self.n = int(n)
        self._rng = np.random.default_rng(seed)
        self._refill()

    def _refill(self):
        # pre-permutation rng state: state_dict() stores it so a restored
        # sampler can redraw this exact permutation
        self._perm_rng_state = self._rng.bit_generator.state
        self._perm = self._rng.permutation(self.n)
        self._pos = 0

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of the full stream position: the rng
        state before the live permutation was drawn (to redraw it), the
        offset into it, and the CURRENT rng state (batch wraps and
        member_batches advance the rng past the permutation draw). A
        restored sampler continues the index stream exactly where the
        checkpointed one stopped — closing the reference's
        dataloader-position-not-restored resume gap
        (reference: src/captioning/dataloader.py:238-240, the loaders
        restart at position 0 after from_infos)."""
        return {
            "n": self.n,
            "pos": int(self._pos),
            "perm_rng_state": self._perm_rng_state,
            "rng_state": self._rng.bit_generator.state,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "EpochSampler":
        self = cls(int(state["n"]), seed=0)
        self._rng.bit_generator.state = state["perm_rng_state"]
        self._refill()
        self._pos = int(state["pos"])
        self._rng.bit_generator.state = state["rng_state"]
        return self

    def batch(self, bs: int) -> np.ndarray:
        """Next (bs,) indices from the epoch stream (wraps with reshuffle)."""
        if bs > self.n:
            return self._rng.integers(0, self.n, size=bs).astype(np.int32)
        if self._pos + bs > self.n:
            self._refill()
        out = self._perm[self._pos : self._pos + bs]
        self._pos += bs
        return out.astype(np.int32)

    def member_batches(self, members: int, bs: int) -> np.ndarray:
        """(members, bs) independent uniform batches (without replacement
        within a member)."""
        if bs <= self.n:
            rows = [
                self._rng.choice(self.n, size=bs, replace=False)
                for _ in range(members)
            ]
        else:
            rows = [self._rng.integers(0, self.n, size=bs) for _ in range(members)]
        return np.stack(rows).astype(np.int32)


def build_sampler(train_n: int, rng, pending_state: dict | None = None
                  ) -> EpochSampler:
    """Fresh epoch sampler, or one restored from a checkpoint's
    z_loader_state sidecar (algorithms/snapshot.load_loader_state) so a
    from_infos resume continues the exact batch stream. A stale sidecar
    whose dataset size no longer matches is ignored with a warning (e.g.
    resuming against different data)."""
    import logging

    log = logging.getLogger(__name__)
    if pending_state is not None:
        if int(pending_state.get("n", -1)) == int(train_n):
            try:
                return EpochSampler.from_state_dict(pending_state)
            except Exception as e:  # corrupt/hand-edited/foreign-BitGenerator
                log.warning(
                    "loader-state sidecar could not be restored (%s: %s) — "
                    "starting a fresh epoch stream", type(e).__name__, e)
        else:
            log.warning(
                "loader-state sidecar is for %s training samples but the "
                "task has %s — starting a fresh epoch stream",
                pending_state.get("n"), train_n)
    return EpochSampler(train_n, seed=int(rng.integers(0, 2**31 - 1)))

"""Indexed CIDEr scoring facade (port of ``nes_img_captioning_tpu/fitness/scorer.py``).

``IndexedCiderScorer`` is what the task's host validation consumes: fit once
on the per-image ground-truth list, then score (candidates, image indices)
batches. This port runs the pure-Python core (``ciderd.py``), the oracle of
the JAX package's native C++ core; binding ``native/ciderd.cpp`` comes with
the native scorer, later.
"""

from __future__ import annotations

import numpy as np

from .ciderd import CiderScorer

__all__ = ["IndexedCiderScorer"]


class IndexedCiderScorer:
    """Fit on per-image reference lists, score candidates by image index.

    ``frozen_df``: optional ``(df, ref_len)`` from
    :func:`~nes_img_captioning_tpu_torch.fitness.ciderd.load_df_pickle` —
    score against a frozen DF table instead of fitting it from
    ``gts_list``."""

    def __init__(self, gts_list: list, variant: str = "cider-d",
                 n: int = 4, sigma: float = 6.0,
                 frozen_df: tuple | None = None):
        self.variant = variant
        self.n, self.sigma = n, sigma
        self._gts = [np.asarray(g, dtype=np.int32) for g in gts_list]
        self._py = CiderScorer(n=n, sigma=sigma, variant=variant)
        if frozen_df is not None:
            self._py.set_df(*frozen_df)
        else:
            self._py.fit_df(self._gts)

    def score(self, cands, img_idx):
        """cands (R, T) int tokens, img_idx (R,) fitted-image indices
        -> (mean, per-candidate scores)."""
        cands = np.ascontiguousarray(cands, dtype=np.int32)
        img_idx = np.ascontiguousarray(img_idx, dtype=np.int64)
        if cands.shape[0] != img_idx.shape[0]:
            raise ValueError(f"{cands.shape[0]} candidates for "
                             f"{img_idx.shape[0]} image indices")
        return self._py.score(cands, [self._gts[i] for i in img_idx])

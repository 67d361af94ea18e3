"""NIC-ES pieces (port of ``nes_img_captioning_tpu/algorithms/es.py``).

Only the device podium merge is ported so far; NES's fused validation uses
it. The ES engine and master are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["podium_merge"]


def podium_merge(e_rows: torch.Tensor, e_scores: torch.Tensor,
                 c_rows: torch.Tensor, c_scores: torch.Tensor):
    """Merge candidates into the device scoreboard with
    ``Podium.record_elites``' exact semantics: one stable descending sort
    over the incumbents, then the candidates, so a tie keeps the incumbent
    and equal-scored candidates enter in their order. e_rows (E, dim),
    e_scores (E,), c_rows (C, dim), c_scores (C,) -> (rows (E, dim), scores
    (E,)), on the device, with no host sync. The rows are selected with
    ``index_select``, which copies them exactly (JAX: es.py:50-64, a one-hot
    product there)."""
    E = e_rows.shape[0]
    scores = torch.cat([e_scores, c_scores])
    top = torch.argsort(-scores, stable=True)[:E]
    pool = torch.cat([e_rows, c_rows])
    return pool.index_select(0, top), scores.index_select(0, top)

"""Centered-rank fitness shaping (port of ``nes_img_captioning_tpu/ops/ranks.py``).

Reference: src/algorithm/nic_nes/nic_nes_master.py:184-205.
"""

from __future__ import annotations

import torch

__all__ = ["compute_ranks", "compute_centered_ranks"]


def compute_ranks(x: torch.Tensor) -> torch.Tensor:
    """Ranks in [0, len(x)): ``ranks[x.argsort()] = arange(len(x))``. The
    sort is stable, so tied fitnesses rank in position order — the JAX
    package's documented tie rule (README "Deliberate behavioral
    deviations")."""
    if x.dim() != 1:
        raise ValueError(f"compute_ranks takes a 1-D tensor, got {x.dim()}-D")
    order = torch.argsort(x, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(x.shape[0], device=x.device)
    return ranks


def compute_centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """Fitnesses (any shape) -> centered ranks in [-0.5, 0.5], f32."""
    y = compute_ranks(x.reshape(-1)).reshape(x.shape).to(torch.float32)
    y = y / (x.numel() - 1)
    return y - 0.5

"""Mutation ops (port of ``nes_img_captioning_tpu/ops/mutation.py``).

Every perturbation is a pure function of an integer seed: the noise is drawn
from a ``torch.Generator`` seeded with it (Philox on CUDA, mt19937 on the
CPU), so only the seed is kept and the noise is drawn again wherever it is
needed (evaluation and gradient). torch cannot reproduce JAX's threefry/rbg
streams, so the realized noise differs from the JAX package's for the same
seed — a documented deviation of the same class as the JAX package's own
from the reference's torch RNG. The in-kernel noise path
(``tpu.kernel_noise``) draws from another stream again, a Philox counter
keyed on (seed, element index) that replaces the TPU's hardware PRNG
(``ops/noise.py``): a deviation of the same kind.
"""

from __future__ import annotations

import enum

import torch

__all__ = ["MutationKind", "normal_from_seed", "shape_noise"]


class MutationKind(enum.Enum):
    """Mirror of the reference Mutation enum (src/algorithm/nets.py:16-21)."""

    DEFAULT = ""
    SAFE_GRAD_SUM = "SM-G-SUM"
    SAFE_GRAD_ABS = "SM-G-ABS"
    SAFE_VECTOR = "SM-VECTOR"
    SAFE_PROPORTIONAL = "SM-PROPORTIONAL"

    @property
    def is_safe(self) -> bool:
        """Safe kinds divide the noise by a sensitivity vector
        (reference: src/algorithm/nets.py:98-101,106-108)."""
        return self in (MutationKind.SAFE_GRAD_SUM, MutationKind.SAFE_GRAD_ABS,
                        MutationKind.SAFE_VECTOR)

    @property
    def is_proportional(self) -> bool:
        return self is MutationKind.SAFE_PROPORTIONAL


def normal_from_seed(seed: int, n: int, device) -> torch.Tensor:
    """N(0, 1)^n in f32 from a fresh generator seeded with ``seed``: the
    same seed on the same device gives the same tensor bit for bit."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n,), generator=gen, dtype=torch.float32,
                       device=device)


def shape_noise(noise: torch.Tensor, theta: torch.Tensor,
                sensitivity: torch.Tensor | None = None,
                proportional: bool = False) -> torch.Tensor:
    """Safe / proportional shaping of raw noise (reference evolve(),
    src/algorithm/nets.py:102-113): safe divides by the sensitivity;
    proportional multiplies by |theta|, exact zeros replaced by mean|theta|
    (the mean taken before the replacement)."""
    if sensitivity is not None:
        noise = noise / sensitivity
    if proportional:
        mean = theta.abs().mean()
        noise = noise * torch.where(theta == 0.0, mean, theta.abs())
    return noise

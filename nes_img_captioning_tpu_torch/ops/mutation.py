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

__all__ = ["MutationKind", "build_children", "normal_from_seed",
           "proportional_factor", "shape_noise"]


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


def proportional_factor(theta: torch.Tensor) -> torch.Tensor:
    """SM-PROPORTIONAL's noise factor of one flat theta: |theta| with exact
    zeros replaced by mean|theta| (the mean taken before the replacement)."""
    mean = theta.abs().mean()
    return torch.where(theta == 0.0, mean, theta.abs())


def shape_noise(noise: torch.Tensor, theta: torch.Tensor,
                sensitivity: torch.Tensor | None = None,
                proportional: bool = False) -> torch.Tensor:
    """Safe / proportional shaping of raw noise (reference evolve(),
    src/algorithm/nets.py:102-113): safe divides by the sensitivity;
    proportional multiplies by ``proportional_factor(theta)``."""
    if sensitivity is not None:
        noise = noise / sensitivity
    if proportional:
        noise = noise * proportional_factor(theta)
    return noise


def build_children(parents: torch.Tensor, pidx: torch.Tensor,
                   noise: torch.Tensor, sigma: float,
                   factors: torch.Tensor | None = None) -> torch.Tensor:
    """NIC-ES's children: row i is ``parent + shape_noise(sigma * noise_i,
    parent, proportional=factors is not None)`` with parent =
    ``parents[pidx[i]]``. parents (P, dim); pidx (M,) int64 on their device;
    noise (M, dim) N(0, 1); factors (P, dim), ``proportional_factor`` of
    each parent row, or None. Every operation after the factors is
    elementwise, so a child's bits do not depend on which other children
    are built with it: the sweep and the rebuild of its winners give the
    same bits. Rows are picked with ``index_select``, which copies them
    exactly (JAX: es.py:134-143, a one-hot product there)."""
    delta = sigma * noise
    if factors is not None:
        delta = delta * factors.index_select(0, pidx)
    return parents.index_select(0, pidx) + delta

"""The in-kernel noise stream (``tpu.kernel_noise``), plain PyTorch version.

The JAX package draws the kernel-noise delta from the TPU's hardware PRNG
(``nes_img_captioning_tpu/ops/decode_pallas.py:_unit_normal``,
``_gen_deltas``), which no other machine reproduces. The port fixes its own
stream as a pure function of the pair's uint32 seed and the element's index
``j`` in the flat decode-ordered vector (``DecodeLayout.flat_dec`` order),
independent of tiles, blocks and launch order:

* random bits: Philox4x32-10 with key ``(seed, 0)`` and counter
  ``(j >> 1, 0, 0, 0)``; element ``j`` takes output words ``2*(j & 1)`` and
  ``2*(j & 1) + 1`` as ``b1`` and ``b2``;
* N(0, 1): the arithmetic of ``_unit_normal`` — ``u = f32((b >> 9) |
  0x3F800000) - 1``, ``n = sqrt(-2 log(1 - u1)) * cos(f32(2 pi) * u2)``,
  the cosine branch only;
* ``delta_j = scale_j * n_j`` rounded to f32. Pad lanes have scale 0, so
  their delta is exactly 0 and the padded logit bias stays ``NEG``.

``csrc/decode.cu`` implements the same stream in one ``__device__``
function that K5 (``decode_pair_rng``), K6 (``pair_grad_rng``) and K7
(``pair_delta_dump``) share, so their deltas are bitwise equal to one
another. The stream differs from the TPU's: a deliberate deviation of the
same kind as the port's per-seed ``torch.Generator`` noise
(``ops/mutation.py``).

torch has no uint32 multiply-high, and the product of two 32-bit operands
overflows int64, so the Philox products are formed from 16-bit limbs of the
counter word in int64 arithmetic.
"""

from __future__ import annotations

import torch

__all__ = ["PHILOX_M", "PHILOX_W", "TWO_PI_F32", "philox4x32_10",
           "philox_normal_plain", "unit_normal_plain"]

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl key increments
_U32 = 0xFFFFFFFF
TWO_PI_F32 = 6.28318530717958  # rounds to 0x40C90FDB in f32


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``a``
    and the uint32 values ``b`` (int64 tensor). b = bh*2^16 + bl: each
    partial product is below 2^48, and the carry into the high word is
    added after the low 32 bits are split off."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (s >> 32) + (p_hi >> 16), s & _U32


def philox4x32_10(ctr: list, key: tuple) -> list:
    """Philox4x32-10 on int64 tensors holding uint32 values: ``ctr`` four
    counter words, ``key`` two key words (ints or tensors). Returns the four
    output words (Random123's round function and key schedule)."""
    c = list(ctr)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _U32
            k1 = (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits into an exponent-1 float: u in [0, 1)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def unit_normal_plain(seed: int, j: torch.Tensor) -> torch.Tensor:
    """N(0, 1) f32 of the elements ``j`` (int64) of seed ``seed``'s
    stream."""
    zero = torch.zeros_like(j)
    words = philox4x32_10([j >> 1, zero, zero, zero], (int(seed) & _U32, 0))
    odd = (j & 1).bool()
    b1 = torch.where(odd, words[2], words[0])
    b2 = torch.where(odd, words[3], words[1])
    r = torch.sqrt(-2.0 * torch.log(1.0 - _uniform(b1)))
    two_pi = torch.tensor(TWO_PI_F32, dtype=torch.float32, device=j.device)
    return r * torch.cos(two_pi * _uniform(b2))


def philox_normal_plain(seed: int, j: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """delta_j = scale_j * N(0, 1)_j, f32: the delta the kernels realize for
    ``seed`` at the flat decode indices ``j`` (the plain version of K7)."""
    return scale.to(torch.float32) * unit_normal_plain(seed, j)

"""The in-kernel noise stream (``tpu.kernel_noise``) and the sampling stream,
plain PyTorch version.

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

The sampling stream (K3, the Gumbel-max sampling decode) comes from the same
Philox4x32-10 under other key words, so it never meets the delta stream:

* lane seeds: member (pair seed, sign) draws ``seq_per_img`` lanes; lane
  ``i`` takes word 0 of key ``(pair seed, LANE_KEY1)`` and counter ``(i,
  1 for + / 2 for -, 0, 0)`` (the JAX package's ``fold_in(key, 1 or 2)``
  and ``bits(fold_in(key, i))``, which torch cannot reproduce);
* Gumbel values: step ``t``, row ``r`` and column ``c`` of a lane take word
  ``c & 3`` of key ``(lane seed, GUMBEL_KEY1)`` and counter ``(c >> 2, r,
  t, 0)``, so one Philox call serves four neighbouring columns; ``r`` is
  the row's index in the whole batch, so a launch over rows ``row0..`` of
  a larger batch draws that batch's values; the bits
  become G by the JAX kernel's arithmetic (``decode_pallas.py:207-216``):
  ``u = f32((b >> 9) | 0x3F800000) - 1``, ``u = u * f32(1 - 2e-7) +
  f32(1e-7)``, ``G = -log(-log(u))``, every product and sum rounded to f32.

torch has no uint32 multiply-high, and the product of two 32-bit operands
overflows int64, so the Philox products are formed from 16-bit limbs of the
counter word in int64 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PHILOX_M", "PHILOX_W", "TWO_PI_F32", "GUMBEL_KEY1", "LANE_KEY1",
           "philox4x32_10", "philox_normal_plain", "unit_normal_plain",
           "lane_seeds", "gumbel_plain", "gumbel_of_bits"]

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl key increments
_U32 = 0xFFFFFFFF
TWO_PI_F32 = 6.28318530717958  # rounds to 0x40C90FDB in f32
GUMBEL_KEY1 = 1  # key word 1 of the Gumbel stream (the delta stream's is 0)
LANE_KEY1 = 2    # key word 1 of the lane-seed derivation
_GUMBEL_SCALE = 0.9999998  # f32(1 - 2e-7), 0x3F7FFFFD
_GUMBEL_OFFSET = 1e-7      # f32(1e-7), 0x33D6BF95


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


def lane_seeds(seeds, signs, n_lanes: int) -> np.ndarray:
    """(N, n_lanes) uint32 lane seeds of the N members (seeds[k], signs[k]),
    sign +1 or -1: word 0 of Philox4x32-10 under key (seed, LANE_KEY1) at
    counter (lane, 1 for + / 2 for -, 0, 0)."""
    seed = torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1, 1)) & _U32
    sign = torch.as_tensor(np.asarray(signs).reshape(-1, 1))
    lane = torch.arange(n_lanes, dtype=torch.int64)[None, :]
    zero = torch.zeros_like(seed * lane)
    word = philox4x32_10(
        [lane + zero, torch.where(sign > 0, 1, 2) + zero, zero, zero],
        (seed, LANE_KEY1))[0]
    return word.numpy().astype(np.uint32)


def gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) f32 from uint32 bits (int64 tensor): the uniform of the
    top 23 bits, squeezed into (0, 1), then -log(-log(u))."""
    f32 = torch.float32
    u = _uniform(bits) * torch.tensor(_GUMBEL_SCALE, dtype=f32) \
        + torch.tensor(_GUMBEL_OFFSET, dtype=f32)
    return -torch.log(-torch.log(u))


def gumbel_plain(seeds: torch.Tensor, t: int, rows: int, Vpad: int,
                 row0: int = 0) -> torch.Tensor:
    """Step ``t``'s Gumbel values of lanes with uint32 seeds ``seeds``
    (int64 tensor of any shape S) for batch rows ``row0 .. row0 + rows -
    1``: (*S, rows, Vpad) f32, the values K3 draws in the kernel. Vpad is a
    multiple of 4."""
    dev = seeds.device
    q = torch.arange(Vpad // 4, dtype=torch.int64, device=dev)
    r = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=dev)[:, None]
    key = (seeds.to(torch.int64) & _U32)[..., None, None]
    zero = torch.zeros_like(key + r + q)
    words = philox4x32_10([q + zero, r + zero, zero + int(t), zero],
                          (key, GUMBEL_KEY1))
    bits = torch.stack(words, -1).reshape(*zero.shape[:-1], Vpad)
    return gumbel_of_bits(bits)

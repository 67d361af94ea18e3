"""The card's peaks and the work of a decode, counted from its shapes.

Published peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s on
the tensor cores in bf16, 3.35 TB/s of HBM. A roofline share states the
least time the card could take for a launch (the larger of its operations
over the peak rate and its bytes, each read or written once, over the
bandwidth) as a share of the time the launch took.
"""

from __future__ import annotations

import torch

__all__ = ["PEAK_BF16", "HBM_BYTES_PER_S", "decode_flops",
           "executed_steps", "rows_flops", "bound_s", "pair_launch_bound_s"]

PEAK_BF16 = 989e12       # FLOP/s
HBM_BYTES_PER_S = 3.35e12
ROW_BLOCK = 128          # rows of one validation launch's block


def decode_flops(n_steps, B: int, F: int, V1: int, E: int, R: int) -> float:
    """Multiply-adds x 2 of one decode: per batch of B rows that exits
    together (a cluster's), the image product, the image step's input gate
    product (its h is 0, so no h2h), both gate products of every token step
    and the logits over the V1 real vocabulary columns (not the padding).
    ``n_steps``: a tensor of the token steps of each batch."""
    n = float(n_steps.sum())
    batches = n_steps.numel()
    return 2.0 * B * (batches * (F * E + E * 5 * R)
                      + n * ((E + R) * 5 * R + R * V1))


def executed_steps(seq, T: int):
    """Token steps each batch ran before its early exit, seq (..., B, T):
    up to and including the step on which its last row emitted 0."""
    zero = seq == 0
    first0 = torch.where(zero.any(-1), zero.int().argmax(-1), T - 1)
    return (first0.max(-1).values + 1).clamp(max=T)


def rows_flops(seq, F: int, V1: int, E: int, R: int) -> float:
    """``decode_flops`` of a row-block decode of seq (N, T): each block of
    ``ROW_BLOCK`` rows with its real rows, until its longest row ends."""
    T = seq.shape[-1]
    return sum(decode_flops(executed_steps(blk[None], T), blk.shape[0], F,
                            V1, E, R)
               for blk in (seq[lo:lo + ROW_BLOCK]
                           for lo in range(0, seq.shape[0], ROW_BLOCK)))


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a launch: bytes once over HBM or the products on
    the tensor cores, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16)


def pair_launch_bound_s(pairs: int, B: int, F: int, V1: int, E: int, R: int,
                        dim_dec: int, steps_per_batch: float, T: int
                        ) -> float:
    """The bound of one pair-kernel launch (K2): ``pairs`` antithetic pairs,
    each sign's B rows one batch running ``steps_per_batch`` token steps on
    average. Bytes: the f32 base and each pair's delta once, the pairs' bf16
    features, the int32 tokens written."""
    steps = torch.full((2 * pairs,), float(steps_per_batch))
    flops = decode_flops(steps, B, F, V1, E, R)
    nbytes = (dim_dec * 4 + pairs * dim_dec * 4
              + pairs * B * F * 2 + pairs * 2 * B * T * 4)
    return bound_s(nbytes, flops)

"""Fused greedy and sampled decode of the FC captioner: CUDA C++ kernels for
Hopper.

Port of ``nes_img_captioning_tpu/ops/decode_pallas.py``:

* ``decode_fused`` (K1) replaces the Pallas ``decode_fused`` with
  ``greedy=True, vocab_tile=0`` (``decode_pallas.py:614-689``, body
  ``_decode_core`` ``:52-239``): one member's greedy caption for a batch of
  images;
* ``decode_sample`` (K3), or ``decode_fused(greedy=False, seeds=...)``,
  replaces the Pallas ``decode_fused`` with ``greedy=False``
  (``decode_pallas.py:658``, branch ``:198-226``): L Gumbel-max samples per
  member, ``argmax(logits + G)`` with G drawn in the kernel from each lane's
  uint32 seed (``ops/noise.py``; ``row0`` places the launch's rows in a
  larger batch's stream), or read from a host table (``gumbel=...``, the
  form of ``host_rng=True``); lp = logit[token] - lse;
* ``decode_tiled`` (K4), or ``decode_fused(vocab_tile=N)``, replaces the
  Pallas ``decode_fused`` with ``vocab_tile > 0`` (``:112-157,170-182``):
  K1 with the logit reduction merged over vocab tiles in order, so the
  tokens are K1's bit for bit and lp sums in the tiled order;
* ``decode_rows`` is K1 (K4 with ``vocab_tile``) over any number of rows of
  one member in one launch, a cluster per block of 128 rows, all reading
  the one member's weights: validation's decode (the JAX package maps the
  Pallas ``decode_fused`` over the val chunks, ``tasks/captioning.py:
  704-714``), the tokens and lp of one launch per block;
* ``decode_pair_perturb`` (K2) replaces the Pallas ``decode_pair_perturb``
  (``decode_pallas.py:295-354``, body ``_pair_kernel`` ``:251-288``): both
  signs of one antithetic pair, the weights formed as
  ``dt(f32(base) + sign * f32(delta))`` inside the kernel;
* ``decode_pair_rng`` (K5) replaces the Pallas ``decode_pair_rng``
  (``decode_pallas.py:466-518``): K2 with the f32 delta
  ``scale * N(0, 1)`` drawn on the card from the pair's uint32 seed;
* ``pair_grad_rng`` (K6) replaces the Pallas ``pair_grad_rng``
  (``decode_pallas.py:575-607``): ``sum_i w_i * delta(seed_i)``, each delta
  drawn again from its seed; ``pair_grad_rng_flat`` is its launch on the
  flat decode-ordered scale, the one the engine calls;
* ``pair_delta_dump`` (K7) replaces the Pallas ``pair_delta_dump``
  (``decode_pallas.py:526-551``): the delta K5 and K6 realize for a seed;
  ``pair_delta_dump_flat`` is its launch on the flat scale, without the
  per-tensor copies.

K5-K7 share one noise stream, a Philox4x32-10 counter keyed on (seed,
element index) (``ops/noise.py`` has its definition and plain version), so
their deltas are bitwise equal; the stream is not the TPU's (a deliberate
deviation, README). K6 and K7 are elementwise and bound by the instructions
each normal issues; they run the library's ``logf``, ``sqrtf`` and ``cosf``
narrowed to the stream's 2^23 inputs each, which ``box_muller_table`` holds
to the library calls bit for bit. The notes in ``csrc/decode.cu`` give each
kernel's design.

Kernel sources: ``csrc/decode.cu``, built with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (loaded with ``ctypes``) on first
use, into ``_build/`` inside this package: one library per width E = R in
``KERNEL_WIDTHS`` (128, 256, 512, 1024; ``-DNES_W``), each built at the first
launch of its width, so a run at 128 does not pay for the others. One
``nvcc`` with ``--split-compile=0`` runs the optimiser and ``ptxas`` on the
file's many kernel instantiations in parallel over the machine's cores.

What bounds them on an H100, and the design. A launch takes at most 128
rows of each member, lane or pair (callers split a larger batch,
``tasks/captioning.py``; the row-block launch takes each 128 rows of its N
as one batch), and a member's, lane's or sign's batch takes one early exit,
the JAX kernel's: every row writes its token (0 once it has ended) and lp
until no row of the batch is unfinished. A CTA holds a block of
``cluster_rows(width)`` rows (all 128 at E = R = 128, 64, 32 and 16 at
256, 512 and 1024, so that its x_t and h fit its shared memory), and past
128 one cluster holds all of a batch's blocks: 2 column halves x 2, 4 or 8
blocks (4, 8 or 16 CTAs) per member or lane, 2 signs x 2 halves x the
blocks (8 or 16) per pair, and at 1024 2 halves x 8 blocks per sign of a
pair (16 CTAs; 32 would exceed a cluster). A batch above 128 rows is
decoded in launches of 128 (``tasks/captioning.py``); with lp those run
with ``min_steps`` = T, no exit of their own, and ``join_row_blocks``
gives the one-launch result. The figures below are those of 128. The
17-step recurrence is serial; the work per step is three products (i2h,
h2h: 128x128x640 each; logits: 128x128xVpad) whose
weights (~5.8 MB per member in bf16, far above an SM's 227 KB of shared
memory) stream as tiles into shared memory. K1, K3 and K4 give each member
(K3: each member and sample lane) a cluster of 2 CTAs (one per column half,
96 CTAs for 48 members), fed by a
ring of the member's own weight tiles copied by TMA and read in place by
the products (no conversion pass), each warp releasing a slot on its own;
K4 folds the halves' row partials at the end of every vocab tile behind a
split cluster barrier. K2 and K5 give each pair a cluster of 4 CTAs (2
signs x 2 column halves, 96 CTAs for 24 pairs): the two signs of a half
share each raw base and delta tile, copied once by multicast into a ring,
and each forms ``dt(base + sign*delta)`` from it, so no perturbed weight
vector is written out. Past E = R = 128 a member's and a pair's
cluster also hold their row blocks: each tile reaches every block (and
both signs) of a half by one multicast copy, each warp releases the slot
on its own, and the member kernel reads the bf16 tile in place while the
pair kernel converts ``dt(base + sign*delta)`` once per column group. K5
first draws each pair's delta once over the
whole card (K7's loop) into a (P, dim) scratch. In both cluster kernels
the halves split every product's columns and swap h and the logit
partials through distributed shared memory. With bf16 weights the logit
product runs on the tensor cores (``mma.sync`` m16n8k16, f32 accumulate);
the gate products multiply the unrounded f32 ``h`` and stay f32 FMAs on
the CUDA cores, as does every product of the f32 path; those FMAs and the
HBM stream of the chunk's weights bound K1, K2, K4 and K5. The logits
never leave registers: each thread keeps a running max / first-index
argmax / online sum-of-exp over its columns, merged across threads with
ties to the smaller index. A launch covers a whole chunk of members or
pairs (the JAX package ``vmap``s over the chunk). K3's 240 clusters (48
members x 5 lanes) run in about 3.6 waves; it draws T * B * Vpad Gumbel
values per lane, a quarter of a Philox call each, and takes the two
``logf`` of ``-log(-log u)`` only for a value that can still beat its row's
running key (an exact skip: the tokens and lp are those of drawing every
value).

Each kernel has a plain PyTorch twin with the same signature, following the
JAX kernel's rounding points (weights and feats in ``dt``, products with f32
accumulation, ``h`` kept f32 for the h2h product and rounded to ``dt`` for
the logits, gates/c/h in f32). The wrappers run the twin only for CPU
tensors; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .noise import TWO_PI_F32, gumbel_plain, philox4x32_10, philox_normal_plain

__all__ = ["PAD_LANE", "NEG", "pad_vocab", "kernel_shape",
           "prepare_decode_params",
           "decode_fused", "decode_fused_plain", "decode_sample",
           "decode_sample_plain", "decode_tiled", "decode_tiled_plain",
           "decode_rows", "decode_rows_plain",
           "gumbel_table", "gumbel_counts", "decode_pair_perturb",
           "decode_pair_perturb_plain", "decode_pair_rng",
           "decode_pair_rng_plain", "join_row_blocks", "pair_delta_dump",
           "pair_delta_dump_flat",
           "pair_delta_dump_plain", "pair_grad_rng", "pair_grad_rng_flat",
           "pair_grad_rng_plain", "philox_words", "box_muller_table",
           "build_kernels",
           "pair_cluster_info", "member_cluster_info", "PAIR_TENSORS"]

PAD_LANE = 128
NEG = -1e9

# the widths the kernels are built for, E = R (one library each, built at
# the first launch of that width); a launch takes at most MAX_ROWS rows of
# each member or pair, a cluster cluster_rows(width) of them; the feature
# width is a multiple of 128 at every width
KERNEL_WIDTHS = (128, 256, 512, 1024)
MAX_ROWS = 128
FEAT_MULTIPLE = 128

PAIR_TENSORS = ("img_w", "img_b", "i2h_w", "i2h_b", "h2h_w", "h2h_b",
                "logit_w", "logit_b", "embed")
_BIASES = ("img_b", "i2h_b", "h2h_b", "logit_b")

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "decode.cu",)
_BUILD_DIR = _PKG / "_build"


def pad_vocab(v1: int) -> int:
    return ((v1 + PAD_LANE - 1) // PAD_LANE) * PAD_LANE


def cluster_rows(width: int) -> int:
    """The image rows a cluster of the kernels holds at E = R = ``width``:
    128 * 128 / width (128, 64, 32, 16), so that a CTA's f32 x_t and h fit
    its shared memory (csrc/decode.cu, the note on W and ROWS)."""
    _check(width in KERNEL_WIDTHS, f"E = R = {width}: the kernels take "
           f"E = R in {KERNEL_WIDTHS}")
    return MAX_ROWS * MAX_ROWS // width


def kernel_shape(E: int, R: int, F: int) -> tuple[int, int]:
    """(W, F_k): the shape the kernels decode a captioner of embedding E,
    R cells and F-wide features at. W is the smallest of KERNEL_WIDTHS at
    least max(E, R), F_k is F rounded up to a multiple of 128; the decode
    layout (``DecodeLayout(pad=True)``) zero-pads the model to it, which
    leaves its decode unchanged. Raises above the widest library."""
    need = max(E, R)
    _check(0 < need <= KERNEL_WIDTHS[-1],
           f"input_encoding_size={E}, rnn_size={R}: the CUDA decode "
           f"kernels take E and R up to {KERNEL_WIDTHS[-1]} (a model is "
           f"zero-padded to the next of the built widths "
           f"{', '.join(map(str, KERNEL_WIDTHS))}); set tpu.fused_decode: "
           "false to decode it eagerly")
    W = next(w for w in KERNEL_WIDTHS if w >= need)
    return W, -(-F // FEAT_MULTIPLE) * FEAT_MULTIPLE


def prepare_decode_params(spec, theta: torch.Tensor, options,
                          dtype=torch.float32, pad: bool | None = None
                          ) -> dict:
    """Flat torch-order theta -> the padded-weight dict the kernels take:
    ``DecodeLayout(pad=pad).prep(to_dec(theta))``. Weights are transposed
    to (in, out) and cast to ``dtype``; vocab axes are padded to the 128
    multiple; biases stay f32 and (1, N)-shaped, the padded logit bias at
    ``NEG`` so a pad token never wins the argmax. ``pad`` (default: theta
    on the card) lays the model out at ``kernel_shape``, width pads 0.
    Every tensor is a copy with its own storage, so it is aligned for the
    kernels' bulk copies whatever its offset in theta."""
    from .decode_layout import DecodeLayout

    lay = DecodeLayout(spec, options, pad=theta.is_cuda if pad is None
                       else pad)
    return {k: v.clone() for k, v in lay.prep(lay.to_dec(theta),
                                               dtype).items()}


def _pad_feats(feats: torch.Tensor, F_k: int) -> torch.Tensor:
    """feats (..., F) -> (..., F_k), zero columns after the model's F (the
    kernels' feature width, ``kernel_shape``); unchanged when F = F_k."""
    F = feats.shape[-1]
    _check(F <= F_k, f"feats of width {F} for weights of {F_k} rows")
    return feats if F == F_k else torch.nn.functional.pad(feats,
                                                          (0, F_k - F))


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _batched(params: dict, feats: torch.Tensor):
    """Lift an unbatched (one member) call to the batched layout: params
    gain a leading member axis and feats become (M, B, F), zero-padded to
    the weights' feature rows."""
    single = params["img_w"].dim() == 2
    if single:
        params = {k: v[None] for k, v in params.items()}
    feats = _pad_feats(feats, params["img_w"].shape[-2])
    if feats.dim() == 2:
        feats = feats[None].expand(params["img_w"].shape[0], *feats.shape)
    return params, feats, single


def _tiled_argmax_lse(logits: torch.Tensor, vocab_tile: int,
                      need_logprobs: bool):
    """K4's logit reduction, the arithmetic of the Pallas logits_streamed
    (decode_pallas.py:132-157): per vocab tile the max, the first argmax
    and the sum of exp against the new running max, tiles merged in
    increasing order (running max from NEG, strict > for the argmax).
    Returns (argmax, max, lse or None), each (...,)."""
    lead = logits.shape[:-1]
    run_max = torch.full((*lead, 1), NEG, dtype=torch.float32,
                         device=logits.device)
    run_arg = torch.zeros((*lead, 1), dtype=torch.long, device=logits.device)
    run_sum = torch.zeros_like(run_max)
    for lo in range(0, logits.shape[-1], vocab_tile):
        part = logits[..., lo:lo + vocab_tile]
        mx_t = part.amax(-1, keepdim=True)
        arg_t = part.argmax(-1, keepdim=True)  # first index on ties
        new_max = torch.maximum(run_max, mx_t)
        if need_logprobs:
            run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
                part - new_max).sum(-1, keepdim=True)
        run_arg = torch.where(mx_t > run_max, arg_t + lo, run_arg)
        run_max = new_max
    lse = run_max + torch.log(run_sum) if need_logprobs else None
    return run_arg[..., 0], run_max[..., 0], \
        None if lse is None else lse[..., 0]


def _decode_plain(params: dict, feats: torch.Tensor, seq_length: int,
                  need_logprobs: bool, *, lanes: int = 1, gumbel_at=None,
                  vocab_tile: int = 0, top2_gap: bool = False,
                  min_steps: int = 0):
    """The plain decode shared by the twins of K1, K3 and K4. params: a
    batch of M members (leading axis), feats (M, B, F). Each member decodes
    ``lanes`` copies of its B rows, lane-major ((M, lanes * B) rows), each
    copy with its own batch-wide early exit, as one cluster of the kernels
    and the JAX kernel's launch; the exit waits until ``min_steps`` steps
    are written (``seq_length``: no exit), as the kernels' does.
    ``gumbel_at(t)``: the (M, lanes * B, Vpad) noise of step t; the token is
    then argmax(logits + G) and lp = logit[token] - lse (K3). ``vocab_tile``:
    K4's tiled reduction. Returns (seq, lp[, gap]), each (M, lanes * B, T);
    gap is each step's gap between the two largest of logits (+ G) — how
    near a tie each choice was, for holding a kernel that sums in another
    order to these tokens."""
    f32 = torch.float32
    dt = params["img_w"].dtype
    R = params["h2h_w"].shape[-2]
    M, B = feats.shape[0], feats.shape[1]
    N = lanes * B
    dev = feats.device

    def dott(x, w):  # products of dt values are exact in f32; f32 sums
        return torch.matmul(x.to(f32), w.to(f32))

    def lstm(xt, h, c):
        a = (dott(xt, params["i2h_w"]) + params["i2h_b"]
             + dott(h, params["h2h_w"]) + params["h2h_b"])
        gates = torch.sigmoid(a[..., :3 * R])
        i_g, f_g, o_g = gates[..., :R], gates[..., R:2 * R], gates[..., 2 * R:]
        cand = torch.maximum(a[..., 3 * R:4 * R], a[..., 4 * R:])
        c2 = f_g * c + i_g * cand
        return o_g * torch.tanh(c2), c2

    x0 = dott(feats.to(dt), params["img_w"]) + params["img_b"]
    zeros = torch.zeros((M, B, R), dtype=f32, device=dev)
    h, c = lstm(x0.to(dt), zeros, zeros)
    # every lane starts from the same image step
    h, c = h.repeat(1, lanes, 1), c.repeat(1, lanes, 1)

    rows = torch.arange(M, device=dev)[:, None]
    tok = torch.zeros((M, N), dtype=torch.long, device=dev)
    unfin = torch.ones((M, N), dtype=torch.bool, device=dev)
    # each lane's batch shares one early exit
    alive = torch.ones((M, lanes), dtype=torch.bool, device=dev)
    seq, lps, gaps = [], [], []
    for t in range(seq_length):
        h, c = lstm(params["embed"][rows, tok], h, c)
        logits = dott(h.to(dt), params["logit_w"]) + params["logit_b"]
        key = logits if gumbel_at is None else logits + gumbel_at(t)
        row_alive = alive.repeat_interleave(B, dim=-1, output_size=N)
        if top2_gap:
            top = key.topk(2, dim=-1).values
            gaps.append(torch.where(row_alive, top[..., 0] - top[..., 1], 0.0))
        if vocab_tile:
            new, mx, lse = _tiled_argmax_lse(logits, vocab_tile, need_logprobs)
        else:
            new = key.argmax(dim=-1)  # first index on ties, like jnp.argmax
            if need_logprobs:
                mx = logits.max(dim=-1, keepdim=True).values
                lse = (mx + torch.log(torch.exp(logits - mx).sum(
                    -1, keepdim=True)))[..., 0]
                mx = mx[..., 0]
        if not need_logprobs:
            lp_tok = torch.zeros((M, N), dtype=f32, device=dev)
        elif gumbel_at is None:
            lp_tok = mx - lse
        else:  # the sampled token's logit
            lp_tok = logits.gather(-1, new[..., None])[..., 0] - lse
        unfin = unfin & (new > 0)
        tok = new * unfin
        # a batch whose rows have all finished skips its remaining steps:
        # its outputs stay 0, as in the kernel; until then a finished row
        # writes token 0 and its argmax lp
        seq.append(torch.where(row_alive, tok, 0).to(torch.int32))
        lps.append(torch.where(row_alive, lp_tok, 0.0))
        alive = alive & (unfin.view(M, lanes, B).any(-1) | (t + 1 < min_steps))
    out = [torch.stack(seq, -1), torch.stack(lps, -1)]
    if top2_gap:
        out.append(torch.stack(gaps, -1))
    return tuple(out)


def decode_fused_plain(params: dict, feats: torch.Tensor,
                       seq_length: int = 16, need_logprobs: bool = True, *,
                       greedy: bool = True, seeds=None, gumbel=None,
                       vocab_tile: int = 0, top2_gap: bool = False,
                       row0: int = 0, min_steps: int = 0):
    """Plain twin of ``decode_fused``, the same signature: K1's for a greedy
    untiled call, else K3's (``decode_sample_plain``) or K4's
    (``decode_tiled_plain``). params: one member's dict
    (prepare_decode_params) or a batch of them with a leading member axis
    M; feats (B, F) or (M, B, F). Returns (seq (…, B, T) int32, lp (…, B,
    T) f32), and with ``top2_gap`` also each step's gap between the two
    largest logits (…, B, T)."""
    _check_variant(params, greedy, seeds, gumbel, vocab_tile)
    if not greedy:
        return decode_sample_plain(params, feats, seq_length, need_logprobs,
                                   seeds=seeds, gumbel=gumbel,
                                   top2_gap=top2_gap, row0=row0,
                                   min_steps=min_steps)
    params, feats, single = _batched(params, feats)
    out = _decode_plain(params, feats, seq_length, need_logprobs,
                        vocab_tile=vocab_tile, top2_gap=top2_gap,
                        min_steps=min_steps)
    return tuple(o[0] for o in out) if single else out


def decode_tiled_plain(params: dict, feats: torch.Tensor, vocab_tile: int,
                       seq_length: int = 16, need_logprobs: bool = True, *,
                       top2_gap: bool = False, min_steps: int = 0):
    """Plain twin of K4: K1's decode with the logits reduced over vocab
    tiles of ``vocab_tile`` columns (a multiple of 128 dividing Vpad)."""
    return decode_fused_plain(params, feats, seq_length, need_logprobs,
                              vocab_tile=vocab_tile, top2_gap=top2_gap,
                              min_steps=min_steps)


def decode_rows_plain(params: dict, feats: torch.Tensor,
                      seq_length: int = 16, need_logprobs: bool = True, *,
                      vocab_tile: int = 0, top2_gap: bool = False):
    """Plain twin of ``decode_rows``: K1's (K4's) plain twin on each block
    of 128 rows of feats (N, F), one member's params; (seq, lp[, gap]),
    each (N, T). Each block takes its own early exit, as each of the
    kernel's clusters and each of the JAX package's validation chunks
    (``lax.map`` of ``decode_fused`` over chunks of at most 128 rows) does,
    so lp is theirs too; a batch of one launch (``tasks/captioning.py``'s
    row blocks with lp) shares one exit instead."""
    outs = [decode_fused_plain(params, feats[lo:lo + MAX_ROWS],
                               seq_length, need_logprobs,
                               vocab_tile=vocab_tile, top2_gap=top2_gap)
            for lo in range(0, feats.shape[0], MAX_ROWS)]
    return tuple(torch.cat(o) for o in zip(*outs))


def _check_lanes(seeds, gumbel, row0: int):
    """A sampling call takes exactly one of seeds and gumbel; a row offset
    places seeded rows in a larger batch (a table holds its own rows)."""
    _check((seeds is None) != (gumbel is None),
           "sampling takes exactly one of seeds and gumbel")
    _check(row0 >= 0 and (row0 == 0 or gumbel is None),
           f"row0={row0}: a non-negative offset of seeded rows")


def _lanes(params: dict, seeds, gumbel):
    """(single member?, M, L, seeds (M, L) uint32 or None, gumbel (M, L, T,
    B, Vpad) or None) of a sampling call; one member takes seeds (L,) or a
    gumbel (L, T, B, Vpad)."""
    single = params["img_w"].dim() == 2
    if seeds is not None:
        u32 = np.asarray(seeds.cpu() if torch.is_tensor(seeds) else seeds)
        u32 = (u32.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        u32 = u32[None] if single else u32
        _check(u32.ndim == 2, f"seeds: shape {u32.shape} is not (members, "
               "lanes), or (lanes,) for one member")
        return single, u32.shape[0], u32.shape[1], u32, None
    g = gumbel[None] if single else gumbel
    _check(g.dim() == 5, f"gumbel: shape {tuple(gumbel.shape)} is not "
           "(members, lanes, T, B, Vpad), or (lanes, T, B, Vpad) for one "
           "member")
    return single, g.shape[0], g.shape[1], None, g


def decode_sample_plain(params: dict, feats: torch.Tensor,
                        seq_length: int = 16, need_logprobs: bool = True, *,
                        seeds=None, gumbel=None, top2_gap: bool = False,
                        row0: int = 0, min_steps: int = 0):
    """Plain twin of K3: L sampled captions per member, each lane's Gumbel
    values drawn from its uint32 lane seed (``seeds`` (M, L), the stream of
    ops/noise.py, for batch rows ``row0 ..``) or read from ``gumbel`` (M,
    L, T, B, Vpad) f32. One member: seeds (L,), gumbel (L, T, B, Vpad).
    Returns (seq, lp[, gap]) of shape (M, L, B, T), or (L, B, T) for one
    member; gap is that of logits + G."""
    _check_lanes(seeds, gumbel, row0)
    single, M, L, u32, g = _lanes(params, seeds, gumbel)
    params, feats, _ = _batched(params, feats)
    B, Vpad = feats.shape[1], params["logit_w"].shape[-1]
    if u32 is not None:
        s64 = torch.from_numpy(u32.astype(np.int64)).to(feats.device)

        def gumbel_at(t):
            return gumbel_plain(s64, t, B, Vpad, row0).reshape(M, L * B, Vpad)
    else:
        def gumbel_at(t):
            return g[:, :, t].to(torch.float32).reshape(M, L * B, Vpad)
    out = _decode_plain(params, feats, seq_length, need_logprobs, lanes=L,
                        gumbel_at=gumbel_at, top2_gap=top2_gap,
                        min_steps=min_steps)
    out = tuple(o.reshape(M, L, B, seq_length) for o in out)
    return tuple(o[0] for o in out) if single else out


def _perturbed(base: dict, delta: dict, sign: float, dtype) -> dict:
    """dt(f32(base) + sign * f32(delta)); biases stay f32 — the arithmetic
    of DecodeLayout.prep(base_vec ± delta)."""
    return {k: (base[k] + sign * delta[k].to(torch.float32)).to(
        torch.float32 if k in _BIASES else dtype) for k in PAIR_TENSORS}


def decode_pair_perturb_plain(base: dict, delta: dict, feats: torch.Tensor,
                              seq_length: int = 16, dtype=torch.float32,
                              need_logprobs: bool = False,
                              min_steps: int = 0):
    """Plain twin of K2. base: f32 dict (one member, unbatched). delta: the
    same shapes in f32 or bf16, for one pair or with a leading pair axis P.
    feats (B, F) or (P, B, F). Returns (seq, lp) of shape (2, B, T) for one
    pair or (P, 2, B, T); index 0 is +delta."""
    outs = [decode_fused_plain(_perturbed(base, delta, s, dtype), feats,
                               seq_length, need_logprobs,
                               min_steps=min_steps) for s in (1.0, -1.0)]
    axis = 0 if delta["img_w"].dim() == 2 else 1
    return (torch.stack([o[0] for o in outs], axis),
            torch.stack([o[1] for o in outs], axis))


def _seeds_u32(seeds) -> tuple[np.ndarray, bool]:
    """Host seeds (an int, or a 1-D sequence / array / CPU tensor) -> (P,)
    uint32 and whether a single seed was given."""
    arr = np.asarray(seeds.cpu() if torch.is_tensor(seeds) else seeds)
    single = arr.ndim == 0
    return (arr.reshape(-1).astype(np.int64) & 0xFFFFFFFF).astype(
        np.uint32), single


def _flat_scale(scale: dict) -> torch.Tensor:
    """A decode-layout dict -> the flat f32 vector in decode order (the
    element index ``j`` of the noise stream)."""
    return torch.cat([scale[k].to(torch.float32).reshape(-1)
                      for k in PAIR_TENSORS])


def _as_dict(flat: torch.Tensor, like: dict) -> dict:
    """(..., dim) in decode order -> a dict of (..., *shape) contiguous
    tensors shaped like ``like``."""
    out, off = {}, 0
    for k in PAIR_TENSORS:
        n = like[k].numel()
        out[k] = flat[..., off:off + n].reshape(
            *flat.shape[:-1], *like[k].shape).contiguous()
        off += n
    return out


def _deltas_plain(flat: torch.Tensor, u32: np.ndarray) -> torch.Tensor:
    """(P, dim) f32: the plain delta of each seed on the flat scale."""
    j = torch.arange(flat.shape[0], device=flat.device)
    return torch.stack([philox_normal_plain(int(s), j, flat) for s in u32])


def _weights(weights, n: int, device) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=device).reshape(-1).contiguous()
    _check(w.shape[0] == n, f"{w.shape[0]} weights for {n} seeds")
    return w


def _grad_plain(flat: torch.Tensor, u32: np.ndarray,
                w: torch.Tensor) -> torch.Tensor:
    """(dim,) f32: sum_i w[i] * delta(u32[i]) in pair order, each product
    rounded to f32 before it is added."""
    j = torch.arange(flat.shape[0], device=flat.device)
    g = torch.zeros_like(flat)
    for i, s in enumerate(u32):
        g = g + w[i] * philox_normal_plain(int(s), j, flat)
    return g


def pair_delta_dump_plain(scale: dict, seeds) -> dict:
    """Plain twin of K7: the f32 delta ``scale * N(0, 1)`` of each seed, as
    a dict shaped like ``scale`` (a leading seed axis P unless ``seeds`` is
    a single int)."""
    u32, single = _seeds_u32(seeds)
    deltas = _deltas_plain(_flat_scale(scale), u32)
    return _as_dict(deltas[0] if single else deltas, scale)


def pair_grad_rng_plain(scale: dict, seeds, weights) -> dict:
    """Plain twin of K6: ``sum_i weights[i] * delta(seeds[i])`` in pair
    order, each product rounded to f32 before it is added — the kernel's
    order. Returns an f32 dict shaped like ``scale``."""
    u32, _ = _seeds_u32(seeds)
    flat = _flat_scale(scale)
    return _as_dict(_grad_plain(flat, u32, _weights(weights, u32.shape[0],
                                                     flat.device)), scale)


def decode_pair_rng_plain(base: dict, scale: dict, seeds, feats: torch.Tensor,
                          seq_length: int = 16, dtype=torch.float32,
                          need_logprobs: bool = False, min_steps: int = 0):
    """Plain twin of K5: K2's plain twin fed K7's plain f32 delta of each
    seed. Returns (seq, lp) of shape (2, B, T) for a single seed or
    (P, 2, B, T); index 0 is +delta."""
    return decode_pair_perturb_plain(base, pair_delta_dump_plain(scale, seeds),
                                     feats, seq_length, dtype, need_logprobs,
                                     min_steps)


def join_row_blocks(outs, axis: int):
    """(seq, lp) of a batch decoded in row blocks with no early exit of
    their own (``min_steps`` = T) -> the result of one launch over the whole
    batch, the JAX kernel's: the blocks joined along the row ``axis`` (T
    last), and lp 0 after the batch's last live step, the latest step at
    which one of its rows emitted its first token 0 (a row that never did
    keeps the batch alive to the end). Before it, a finished row keeps its
    token 0 and argmax lp, as in one launch."""
    seq, lp = (torch.cat(o, axis) for o in zip(*outs))
    T = seq.shape[-1]
    ended = seq == 0
    first = torch.where(ended.any(-1), ended.to(torch.int8).argmax(-1), T - 1)
    last = first.amax(dim=axis + 1 if axis < 0 else axis, keepdim=True)
    steps = torch.arange(T, device=seq.device)
    return seq, torch.where(steps <= last[..., None], lp, 0.0)


# ---------------------------------------------------------------------------
# kernel build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the decode kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return found


def build_kernels(width: int = 128, nice: int = 0) -> tuple[Path, str]:
    """Compile ``csrc/decode.cu`` at E = R = ``width`` (``-DNES_W``) for
    sm_90a into ``_build/libnes_decode_w<width>_<digest>.so`` unless a
    library built from the same sources is already there; ``nice`` > 0 runs
    ``nvcc`` at that niceness (a build needed later, beside one needed
    now). Returns (library path, the compiler's ptxas report; empty when
    nothing was compiled)."""
    _check(width in KERNEL_WIDTHS,
           f"E = R = {width}: the kernels are built for {KERNEL_WIDTHS}")
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _SOURCES))
    lib = _BUILD_DIR / f"libnes_decode_w{width}_{digest.hexdigest()[:12]}.so"
    if lib.is_file():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    lower = ["nice", "-n", str(nice)] if nice > 0 and shutil.which("nice") \
        else []
    cmd = [*lower, _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "--split-compile=0", "-shared", "-Xcompiler",
           "-fPIC", f"-DNES_W={width}", "-Xptxas", "-v", "-o", str(tmp),
           *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


_LIBS: dict[int, ctypes.CDLL] = {}


def _kernels(width: int | None = None) -> ctypes.CDLL:
    """The library of E = R = ``width``, built and bound at its first use;
    ``width=None`` (the width-free noise kernels, which every library
    holds): one already loaded, else the one of 128."""
    if width is None:
        width = next(iter(_LIBS), KERNEL_WIDTHS[0])
    if width not in _LIBS:
        _LIBS[width] = _bind(ctypes.CDLL(str(build_kernels(width)[0])), width)
    return _LIBS[width]


def _bind(lib: ctypes.CDLL, width: int) -> ctypes.CDLL:
    rows = ctypes.c_int()
    _check(lib.nes_width(ctypes.byref(rows)) == width
           and rows.value == cluster_rows(width),
           f"the library of E = R = {width} reports another width")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nes_decode_fused.argtypes = [ci] * 8 + [vp] * 10 + [vp] * 2 + [vp]
    lib.nes_decode_fused.restype = ci
    lib.nes_decode_tiled.argtypes = [ci] * 9 + [vp] * 10 + [vp] * 2 + [vp]
    lib.nes_decode_tiled.restype = ci
    lib.nes_decode_rows.argtypes = [ci] * 7 + [vp] * 10 + [vp] * 2 + [vp]
    lib.nes_decode_rows.restype = ci
    lib.nes_decode_sample.argtypes = [ci] * 10 + [vp] * 10 + [vp] * 3 + [vp]
    lib.nes_decode_sample.restype = ci
    lib.nes_decode_sample_table.argtypes = \
        [ci] * 9 + [vp] * 10 + [vp] * 3 + [vp]
    lib.nes_decode_sample_table.restype = ci
    lib.nes_decode_pair_perturb.argtypes = \
        [ci] * 9 + [vp] * (1 + 9 + 9) + [vp] * 2 + [vp]
    lib.nes_decode_pair_perturb.restype = ci
    lib.nes_decode_pair_rng.argtypes = \
        [ci] * 8 + [vp] * (1 + 9) + [vp] * 3 + [vp] * 2 + [vp]
    lib.nes_decode_pair_rng.restype = ci
    lib.nes_pair_cluster_info.argtypes = [ci, ci, vp]
    lib.nes_pair_cluster_info.restype = ci
    lib.nes_member_cluster_info.argtypes = [ci, ci, vp]
    lib.nes_member_cluster_info.restype = ci
    i64 = ctypes.c_longlong
    lib.nes_pair_delta_dump.argtypes = [ci, i64] + [vp] * 3 + [vp]
    lib.nes_pair_delta_dump.restype = ci
    lib.nes_pair_grad_rng.argtypes = [ci, i64] + [vp] * 4 + [vp]
    lib.nes_pair_grad_rng.restype = ci
    lib.nes_philox_words.argtypes = [ctypes.c_uint, i64, vp, vp]
    lib.nes_philox_words.restype = ci
    lib.nes_gumbel_table.argtypes = [ctypes.c_uint, ci, ci, ci, ci, vp, vp]
    lib.nes_gumbel_table.restype = ci
    lib.nes_gumbel_counts.argtypes = [vp]
    lib.nes_gumbel_counts.restype = ci
    lib.nes_box_table.argtypes = [vp, vp]
    lib.nes_box_table.restype = ci
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_params(params: dict, M: int, F: int, dt, what="params"):
    """Shapes, dtypes, device and contiguity of a batched params dict:
    weights in ``dt``, biases f32 (DecodeLayout.prep keeps every bias f32,
    a delta's too), E = R in KERNEL_WIDTHS and F a multiple of 128, the
    shapes of ``DecodeLayout(pad=True)``. Returns (Vpad, the width)."""
    W = params["img_w"].shape[-1]
    _check(W == params["h2h_w"].shape[-2] and W in KERNEL_WIDTHS,
           f"{what}: E = {W}, R = {params['h2h_w'].shape[-2]}: the kernels "
           f"take E = R in {KERNEL_WIDTHS}; lay the model out padded to "
           "kernel_shape(E, R, F) (DecodeLayout(pad=True))")
    Vpad = params["logit_w"].shape[-1]
    expect = {"img_w": (M, F, W), "img_b": (M, 1, W),
              "i2h_w": (M, W, 5 * W), "i2h_b": (M, 1, 5 * W),
              "h2h_w": (M, W, 5 * W), "h2h_b": (M, 1, 5 * W),
              "logit_w": (M, W, Vpad), "logit_b": (M, 1, Vpad),
              "embed": (M, Vpad, W)}
    _check(Vpad % PAD_LANE == 0, f"{what}: padded vocab {Vpad} is not a "
           f"multiple of {PAD_LANE}")
    _check(F % FEAT_MULTIPLE == 0, f"{what}: feature width {F} is not a "
           f"multiple of {FEAT_MULTIPLE}; lay the model out padded to "
           "kernel_shape(E, R, F) (DecodeLayout(pad=True))")
    for k, shape in expect.items():
        t = params[k]
        _check(tuple(t.shape) == shape,
               f"{what}[{k}]: shape {tuple(t.shape)} != {shape} (the kernels "
               f"take E = R = {W})")
        want = torch.float32 if k in _BIASES else dt
        _check(t.dtype == want, f"{what}[{k}]: dtype {t.dtype} != {want}")
        _check(t.is_cuda, f"{what}[{k}] is not a CUDA tensor")
        _check(t.is_contiguous(), f"{what}[{k}] is not contiguous")
    return Vpad, W


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _check_variant(params: dict, greedy: bool, seeds, gumbel,
                   vocab_tile: int):
    """The JAX wrapper's checks of a decode_fused call (decode_pallas.py:
    637-647), as ValueError: vocab_tile is greedy-only, a multiple of 128
    dividing Vpad; sampling takes a seed stream or a table."""
    if vocab_tile:
        Vpad = params["logit_w"].shape[-1]
        _check(greedy, "vocab_tile is a greedy-decode variant")
        _check(vocab_tile > 0 and vocab_tile % PAD_LANE == 0
               and Vpad % vocab_tile == 0,
               f"vocab_tile={vocab_tile} must be a multiple of {PAD_LANE} "
               f"dividing the padded vocab {Vpad}")
    _check(greedy or (seeds is None) != (gumbel is None),
           "sampling (greedy=False) takes exactly one of seeds and gumbel")
    _check(not greedy or (seeds is None and gumbel is None),
           "seeds and gumbel are for sampling (greedy=False)")


def _launch_args(params: dict, feats: torch.Tensor, what: str,
                 max_rows: int | None = MAX_ROWS):
    """Checks of K1, K3 and K4's operands: (params, feats in dt, (M, B,
    F), Vpad, dtype code, stream, single member?, the library of their
    width). ``max_rows=None``: the row-block launch, any number of rows."""
    dt = params["img_w"].dtype
    _check(dt in _DTYPE_CODE, f"weight dtype {dt} is not f32 or bf16")
    params, feats, single = _batched(params, feats)
    M, B, F = feats.shape
    _check(B >= 1 and (max_rows is None or B <= max_rows),
           f"batch {B} outside 1..{max_rows}")
    Vpad, width = _check_params(params, M, F, dt, what=what)
    feats = feats.to(dt).contiguous()
    _check(feats.device == params["img_w"].device, "feats on another device")
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    return (params, feats, (M, B, F), Vpad, _DTYPE_CODE[dt], stream, single,
            _kernels(width))


def decode_fused(params: dict, feats: torch.Tensor, seq_length: int = 16,
                 need_logprobs: bool = True, *, greedy: bool = True,
                 seeds=None, gumbel=None, vocab_tile: int = 0, row0: int = 0,
                 min_steps: int = 0):
    """Decode of one member, or of a batch of members in one launch (params
    with a leading member axis M, feats (M, B, F)): K1, the greedy decode,
    one cluster of 2 CTAs per member; with ``vocab_tile`` K4
    (``decode_tiled``); with ``greedy=False`` K3 (``decode_sample``), which
    takes ``seeds`` (and ``row0``) or ``gumbel``. Returns (seq (…, B, T) int32, lp (…, B,
    T) f32), with a lane axis before B when sampling. CPU tensors run the
    plain twin; CUDA tensors launch the kernel. Tokens equal K2's on
    ``prep(base ± delta)`` bit for bit; lp sums exp over the columns in the
    halves' order, within 2e-5 of the plain twin at f32. A batch exits
    early once every row has finished and ``min_steps`` steps are written
    (``seq_length``: no early exit, the row blocks of a larger batch,
    ``join_row_blocks``)."""
    _check_variant(params, greedy, seeds, gumbel, vocab_tile)
    if not greedy:
        return decode_sample(params, feats, seq_length, need_logprobs,
                             seeds=seeds, gumbel=gumbel, row0=row0,
                             min_steps=min_steps)
    if vocab_tile:
        return decode_tiled(params, feats, vocab_tile, seq_length,
                            need_logprobs, min_steps=min_steps)
    if not feats.is_cuda:
        return decode_fused_plain(params, feats, seq_length, need_logprobs,
                                  min_steps=min_steps)
    params, feats, (M, B, F), Vpad, code, stream, single, lib = _launch_args(
        params, feats, "params")
    _check_aligned(params, "params")
    seq = torch.empty((M, B, seq_length), dtype=torch.int32,
                      device=feats.device)
    lp = torch.empty((M, B, seq_length), dtype=torch.float32,
                     device=feats.device)
    err = lib.nes_decode_fused(
        code, int(need_logprobs), M, B, F, Vpad, seq_length, min_steps,
        feats.data_ptr(), *(params[k].data_ptr() for k in PAIR_TENSORS),
        seq.data_ptr(), lp.data_ptr(), stream)
    _raise_on(err, "decode_fused")
    decode_fused.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_fused.launches = 0


def decode_tiled(params: dict, feats: torch.Tensor, vocab_tile: int,
                 seq_length: int = 16, need_logprobs: bool = True, *,
                 min_steps: int = 0):
    """K4: K1 with the logits reduced over vocab tiles of ``vocab_tile``
    columns (a multiple of 128 dividing Vpad; ``tpu.decode_vocab_tile``):
    the same tokens as K1, bit for bit, and lp summed in the tiled order.
    The member kernel of K1, folding the halves' row partials at the end of
    every vocab tile. Shapes as K1's."""
    _check_variant(params, True, None, None, vocab_tile)
    if not feats.is_cuda:
        return decode_tiled_plain(params, feats, vocab_tile, seq_length,
                                  need_logprobs, min_steps=min_steps)
    params, feats, (M, B, F), Vpad, code, stream, single, lib = _launch_args(
        params, feats, "params")
    _check_aligned(params, "params")
    seq = torch.empty((M, B, seq_length), dtype=torch.int32,
                      device=feats.device)
    lp = torch.empty((M, B, seq_length), dtype=torch.float32,
                     device=feats.device)
    err = lib.nes_decode_tiled(
        code, int(need_logprobs), M, B, F, Vpad, seq_length, min_steps,
        vocab_tile,
        feats.data_ptr(), *(params[k].data_ptr() for k in PAIR_TENSORS),
        seq.data_ptr(), lp.data_ptr(), stream)
    _raise_on(err, "decode_tiled")
    decode_tiled.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_tiled.launches = 0


def decode_rows(params: dict, feats: torch.Tensor, seq_length: int = 16,
                need_logprobs: bool = True, *, vocab_tile: int = 0):
    """K1 (K4 with ``vocab_tile``) over all N rows of feats (N, F) under one
    member's params, in one launch: ceil(N / 128) clusters (of 2 CTAs at E
    = R = 128, of 2 per block of ``cluster_rows`` past it), every
    one reading the member's weights (one member's tensor maps) and cluster
    b rows [128 b, 128 b + 128), the last block ragged. Returns (seq (N, T)
    int32, lp (N, T) f32), bit for bit those of one ``decode_fused`` (or
    ``decode_tiled``) launch per block of 128 rows. CPU tensors run the
    plain twin."""
    _check_variant(params, True, None, None, vocab_tile)
    if not feats.is_cuda:
        return decode_rows_plain(params, feats, seq_length, need_logprobs,
                                 vocab_tile=vocab_tile)
    _check(params["img_w"].dim() == 2 and feats.dim() == 2,
           "decode_rows takes one member's params and feats (N, F)")
    params, feats, (_, N, F), Vpad, code, stream, _, lib = _launch_args(
        params, feats, "params", max_rows=None)
    _check_aligned(params, "params")
    # the last block's outputs are written in full at E = R = 128; its rows
    # past N are padding, sliced off here
    block = min(N, MAX_ROWS)
    rows = -(-N // block) * block
    seq = torch.empty((rows, seq_length), dtype=torch.int32,
                      device=feats.device)
    lp = torch.empty((rows, seq_length), dtype=torch.float32,
                     device=feats.device)
    err = lib.nes_decode_rows(
        code, int(need_logprobs), N, F, Vpad, seq_length, vocab_tile,
        feats.data_ptr(), *(params[k].data_ptr() for k in PAIR_TENSORS),
        seq.data_ptr(), lp.data_ptr(), stream)
    _raise_on(err, "decode_rows")
    decode_rows.launches += 1
    return seq[:N], lp[:N]


decode_rows.launches = 0


def decode_sample(params: dict, feats: torch.Tensor, seq_length: int = 16,
                  need_logprobs: bool = True, *, seeds=None, gumbel=None,
                  row0: int = 0, min_steps: int = 0):
    """K3: L Gumbel-max sampled captions per member in one launch of the
    member kernel, one 2-CTA cluster per (member, lane). ``seeds``: (M, L)
    uint32 lane seeds (host ints or array), the Gumbel values drawn in the
    kernel for batch rows ``row0 .. row0 + B - 1`` (a batch above 128 rows
    is decoded in launches of 128 with their offsets, the stream of one
    launch over all rows); or ``gumbel``: an (M, L, T, B, Vpad) f32 table
    on the card (the host-table form). One member: seeds (L,), gumbel (L,
    T, B, Vpad). Returns (seq, lp) of shape (M, L, B, T), or (L, B, T); lp
    = logit[token] - lse."""
    _check_lanes(seeds, gumbel, row0)
    if not feats.is_cuda:
        return decode_sample_plain(params, feats, seq_length, need_logprobs,
                                   seeds=seeds, gumbel=gumbel, row0=row0,
                                   min_steps=min_steps)
    single, M, L, u32, g = _lanes(params, seeds, gumbel)
    params, feats, (M_, B, F), Vpad, code, stream, _, lib = _launch_args(
        params, feats, "params")
    _check(M_ == M, f"{M_} members, {M} of seeds or gumbel")
    _check_aligned(params, "params")
    dev = feats.device
    seq = torch.empty((M, L, B, seq_length), dtype=torch.int32, device=dev)
    lp = torch.empty((M, L, B, seq_length), dtype=torch.float32, device=dev)
    prm = (params[k].data_ptr() for k in PAIR_TENSORS)
    if u32 is not None:
        seeds_d = _seeds_on(u32.reshape(-1), dev)
        err = lib.nes_decode_sample(
            code, int(need_logprobs), M, L, B, F, Vpad, seq_length, min_steps,
            row0,
            feats.data_ptr(), *prm, seeds_d.data_ptr(), seq.data_ptr(),
            lp.data_ptr(), stream)
    else:
        _check(tuple(g.shape) == (M, L, seq_length, B, Vpad),
               f"gumbel: shape {tuple(g.shape)} != "
               f"{(M, L, seq_length, B, Vpad)}")
        _check(g.dtype == torch.float32 and g.device == dev
               and g.is_contiguous(),
               "gumbel: not a contiguous f32 tensor on the weights' card")
        err = lib.nes_decode_sample_table(
            code, int(need_logprobs), M, L, B, F, Vpad, seq_length, min_steps,
            feats.data_ptr(), *prm, g.data_ptr(), seq.data_ptr(),
            lp.data_ptr(), stream)
    _raise_on(err, "decode_sample")
    decode_sample.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_sample.launches = 0


def gumbel_table(seed: int, t: int, B: int, Vpad: int, device,
                 row0: int = 0) -> torch.Tensor:
    """(B, Vpad) f32: K3's Gumbel values of lane seed ``seed`` at step t for
    batch rows ``row0 ..``, from the kernels' generator on a CUDA device and
    from the plain one (ops/noise.py) on the CPU — the check that the two
    draw the same values."""
    device = torch.device(device)
    if device.type != "cuda":
        return gumbel_plain(torch.tensor(int(seed) & 0xFFFFFFFF), t, B, Vpad,
                            row0)
    out = torch.empty((B, Vpad), dtype=torch.float32, device=device)
    err = _kernels().nes_gumbel_table(
        int(seed) & 0xFFFFFFFF, t, row0, B, Vpad, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "gumbel_table")
    return out


def gumbel_counts() -> tuple[int, int]:
    """(values seen, values drawn by the two logf) of K3's launches since
    the last call, and reset: counted only by a build with
    ``member::GUMBEL_COUNT`` set (a sweep variant of
    scripts/torch_pair_tiles.py), else (0, 0)."""
    out = (ctypes.c_ulonglong * 2)()
    _raise_on(_kernels().nes_gumbel_counts(out), "gumbel_counts")
    return int(out[0]), int(out[1])


def decode_pair_perturb(base: dict, delta: dict, feats: torch.Tensor,
                        seq_length: int = 16, dtype=torch.float32,
                        need_logprobs: bool = False, min_steps: int = 0):
    """K2: both signs of antithetic pairs with the perturbation applied in
    the kernel. base: f32 dict (unbatched, shared by the pairs); delta: f32
    or bf16, one pair or a leading pair axis P; feats (B, F) or (P, B, F).
    ``dtype`` is the compute dtype of the perturbed weights. Returns (seq,
    lp) of shape (2, B, T) or (P, 2, B, T); index 0 is +delta. One launch,
    one cluster per pair: 4 CTAs at E = R = 128 (2 signs x 2 column
    halves), past 128 those 4 for each block of ``cluster_rows`` of
    the B rows (at 1024 a cluster per sign, 2 halves x 8 blocks); the signs (and blocks) share each base and delta tile,
    copied once from L2 into all of them. Tokens
    equal ``decode_fused(prep(base ± delta))`` bit for bit: the same sum,
    rounded once to the same dtype, feeds products in K1's order; lp sums
    exp over the columns in another order (two halves merged), within 2e-5
    of K1's."""
    if not feats.is_cuda:
        return decode_pair_perturb_plain(base, delta, feats, seq_length,
                                         dtype, need_logprobs, min_steps)
    _check(dtype in _DTYPE_CODE, f"compute dtype {dtype} is not f32 or bf16")
    ddt = delta["img_w"].dtype
    _check(ddt in _DTYPE_CODE, f"delta dtype {ddt} is not f32 or bf16")
    single = delta["img_w"].dim() == 2
    if single:
        delta = {k: v[None] for k, v in delta.items()}
    P = delta["img_w"].shape[0]
    feats = _pad_feats(feats, base["img_w"].shape[-2])
    if feats.dim() == 2:
        feats = feats[None].expand(P, *feats.shape)
    _, B, F = feats.shape
    _check(feats.shape[0] == P, f"feats lead {feats.shape[0]} != pairs {P}")
    _check(1 <= B <= MAX_ROWS, f"batch {B} outside 1..{MAX_ROWS}")
    Vpad, width = _check_params({k: v[None] for k, v in base.items()}, 1, F,
                                torch.float32, what="base")
    _check(_check_params(delta, P, F, ddt, what="delta") == (Vpad, width),
           "base and delta shapes differ")
    _check_aligned(base, "base")
    _check_aligned(delta, "delta")
    feats = feats.to(dtype).contiguous()
    _check(feats.device == base["img_w"].device, "feats on another device")
    seq = torch.empty((P, 2, B, seq_length), dtype=torch.int32,
                      device=feats.device)
    lp = torch.empty((P, 2, B, seq_length), dtype=torch.float32,
                     device=feats.device)
    err = _kernels(width).nes_decode_pair_perturb(
        _DTYPE_CODE[dtype], _DTYPE_CODE[ddt], int(need_logprobs), P, B, F,
        Vpad, seq_length, min_steps, feats.data_ptr(),
        *(base[k].data_ptr() for k in PAIR_TENSORS),
        *(delta[k].data_ptr() for k in PAIR_TENSORS),
        seq.data_ptr(), lp.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _raise_on(err, "decode_pair_perturb")
    decode_pair_perturb.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_pair_perturb.launches = 0


def _check_aligned(params: dict, what: str):
    """The cluster kernels copy weight tiles through TMA tensor maps and
    biases with bulk copies, which take 16-byte aligned addresses."""
    for k in PAIR_TENSORS:
        _check(params[k].data_ptr() % 16 == 0,
               f"{what}[{k}] is not 16-byte aligned")


def pair_cluster_info(dtype=torch.bfloat16, delta_dtype=torch.bfloat16,
                      width: int = 128) -> dict:
    """The pair kernel's launch shape on the current card at E = R =
    ``width`` for compute dtype ``dtype`` and delta dtype ``delta_dtype``
    (K5: f32), for a batch of 128 rows: CTAs per cluster (at 128 one
    cluster of 2 signs x 2 column halves per pair; at 256 and 512 one
    cluster per pair (at 1024 per sign of a pair) holding its ``row_blocks`` blocks of ``rows`` image
    rows, 2 signs x 2 halves each), threads per CTA, dynamic shared memory
    bytes, ring slots, k-rows per (gate) tile, the clusters the card holds
    at once (``cudaOccupancyMaxActiveClusters``) and the tiles in flight.
    ``rows`` is the early exit's granularity at every width."""
    out = (ctypes.c_int * 8)()
    err = _kernels(width).nes_pair_cluster_info(
        _DTYPE_CODE[dtype], _DTYPE_CODE[delta_dtype], out)
    _raise_on(err, "pair_cluster_info")
    return dict(zip(("cluster", "threads", "smem_bytes", "ring_slots",
                     "tile_rows", "max_active_clusters", "tiles_in_flight",
                     "row_blocks"), out),
                rows=cluster_rows(width))


def member_cluster_info(dtype=torch.bfloat16, sampled: bool = False,
                        width: int = 128) -> dict:
    """The member kernel's launch shape on the current card at E = R =
    ``width`` for weight dtype ``dtype``, greedy (K1, K4) or ``sampled``
    (K3, whose row partials carry two more fields), for a batch of 128
    rows: CTAs per cluster (one cluster per member or lane: at 128 its 2
    column halves, past 128 those 2 for each of its ``row_blocks``
    blocks of ``rows`` image rows), threads per CTA, dynamic shared memory
    bytes, ring slots, k-rows per (gate) tile, the clusters the card holds
    at once (``cudaOccupancyMaxActiveClusters``) and tiles in flight."""
    out = (ctypes.c_int * 8)()
    err = _kernels(width).nes_member_cluster_info(_DTYPE_CODE[dtype],
                                                  int(sampled), out)
    _raise_on(err, "member_cluster_info")
    return dict(zip(("cluster", "threads", "smem_bytes", "ring_slots",
                     "tile_rows", "max_active_clusters", "tiles_in_flight",
                     "row_blocks"), out), rows=cluster_rows(width))


def _seeds_on(u32: np.ndarray, device) -> torch.Tensor:
    """uint32 seeds as an int32 tensor of the same bits on ``device`` (the
    kernels read them as uint32)."""
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32)).to(
        device)


def _check_scale(scale: dict, like: dict) -> torch.Tensor:
    """A noise-scale dict of ``like``'s shapes, f32 on the card -> its flat
    decode-ordered vector."""
    for k in PAIR_TENSORS:
        _check(tuple(scale[k].shape) == tuple(like[k].shape),
               f"scale[{k}]: shape {tuple(scale[k].shape)} != "
               f"{tuple(like[k].shape)}")
        _check(scale[k].dtype == torch.float32,
               f"scale[{k}]: dtype {scale[k].dtype} != torch.float32")
        _check(scale[k].is_cuda, f"scale[{k}] is not a CUDA tensor")
    return _flat_scale(scale).contiguous()


def decode_pair_rng(base: dict, scale: dict, seeds, feats: torch.Tensor,
                    seq_length: int = 16, dtype=torch.float32,
                    need_logprobs: bool = False, min_steps: int = 0):
    """K5: both signs of antithetic pairs, each pair's f32 delta ``scale *
    N(0, 1)`` drawn on the card from its uint32 seed. base, scale: f32
    dicts (unbatched, shared by the pairs; scale's pad lanes 0); seeds: one
    host seed or P of them; feats (B, F) or (P, B, F). Returns (seq, lp) of
    shape (2, B, T) or (P, 2, B, T); index 0 is +delta. Two launches on the
    current stream, counted as one: K7's draw of every pair's delta, over
    the whole card, into a (P, dim) f32 scratch, then K2's pair kernel on
    it. So tokens and lp equal K2's fed ``pair_delta_dump(scale, seeds)``
    bit for bit. As in the JAX package, the delta is f32 whatever
    ``tpu.delta_dtype`` says."""
    if not feats.is_cuda:
        return decode_pair_rng_plain(base, scale, seeds, feats, seq_length,
                                     dtype, need_logprobs, min_steps)
    _check(dtype in _DTYPE_CODE, f"compute dtype {dtype} is not f32 or bf16")
    u32, single = _seeds_u32(seeds)
    P = u32.shape[0]
    feats = _pad_feats(feats, base["img_w"].shape[-2])
    if feats.dim() == 2:
        feats = feats[None].expand(P, *feats.shape)
    _, B, F = feats.shape
    _check(feats.shape[0] == P, f"feats lead {feats.shape[0]} != pairs {P}")
    _check(1 <= B <= MAX_ROWS, f"batch {B} outside 1..{MAX_ROWS}")
    Vpad, width = _check_params({k: v[None] for k, v in base.items()}, 1, F,
                                torch.float32, what="base")
    flat = _check_scale(scale, base)
    _check_aligned(base, "base")
    feats = feats.to(dtype).contiguous()
    dev = feats.device
    _check(dev == base["img_w"].device == flat.device,
           "feats, base and scale on different devices")
    seq = torch.empty((P, 2, B, seq_length), dtype=torch.int32, device=dev)
    lp = torch.empty((P, 2, B, seq_length), dtype=torch.float32, device=dev)
    # each pair's delta, drawn once over the whole card and then read by
    # the pair kernel (csrc/decode.cu, K5's note)
    scratch = torch.empty((P, flat.shape[0]), dtype=torch.float32,
                          device=dev)
    seeds_d = _seeds_on(u32, dev)
    err = _kernels(width).nes_decode_pair_rng(
        _DTYPE_CODE[dtype], int(need_logprobs), P, B, F, Vpad, seq_length,
        min_steps, feats.data_ptr(),
        *(base[k].data_ptr() for k in PAIR_TENSORS), flat.data_ptr(), seeds_d.data_ptr(), scratch.data_ptr(),
        seq.data_ptr(), lp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "decode_pair_rng")
    decode_pair_rng.launches += 1
    return (seq[0], lp[0]) if single else (seq, lp)


decode_pair_rng.launches = 0


def _check_flat(flat: torch.Tensor) -> torch.Tensor:
    _check(flat.dim() == 1 and flat.dtype == torch.float32,
           f"flat scale: {flat.dtype} of shape {tuple(flat.shape)}, not a "
           "1-D f32 vector")
    # the stream's counter j >> 1 is one 32-bit word, and the kernels index
    # element pairs in 32 bits
    _check(flat.shape[0] < 2**32, f"{flat.shape[0]} elements: the stream "
           "holds fewer than 2^32")
    return flat.contiguous()


def pair_delta_dump_flat(flat: torch.Tensor, seeds) -> torch.Tensor:
    """K7 on the flat decode-ordered f32 scale (dim,): the (P, dim) f32
    deltas of the P seeds, or (dim,) for a single seed, with no per-tensor
    copies — the launch ``pair_delta_dump`` wraps, and K7's time alone. A
    CPU tensor runs the plain version; a CUDA one launches the kernel,
    counted on ``pair_delta_dump.launches``."""
    u32, single = _seeds_u32(seeds)
    flat = _check_flat(flat)
    if not flat.is_cuda:
        out = _deltas_plain(flat, u32)
    else:
        P, dim = u32.shape[0], flat.shape[0]
        out = torch.empty((P, dim), dtype=torch.float32, device=flat.device)
        seeds_d = _seeds_on(u32, flat.device)
        err = _kernels().nes_pair_delta_dump(
            P, dim, flat.data_ptr(), seeds_d.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(flat.device).cuda_stream)
        _raise_on(err, "pair_delta_dump")
        pair_delta_dump.launches += 1
    return out[0] if single else out


def pair_delta_dump(scale: dict, seeds) -> dict:
    """K7: the f32 delta K5 and K6 realize for each seed, all seeds in one
    launch. scale: f32 dict (pad lanes 0); seeds: one host seed or P of
    them. Returns a dict shaped like ``scale``, with a leading P axis unless
    a single seed was given: ``pair_delta_dump_flat`` cut into the nine
    tensors."""
    if not scale["img_w"].is_cuda:
        return pair_delta_dump_plain(scale, seeds)
    return _as_dict(pair_delta_dump_flat(_check_scale(scale, scale), seeds),
                    scale)


pair_delta_dump.launches = 0


def pair_grad_rng_flat(flat: torch.Tensor, seeds, weights) -> torch.Tensor:
    """K6 on the flat decode-ordered f32 scale (dim,): the (dim,) f32
    gradient ``sum_i weights[i] * delta(seeds[i])``, summed over the pairs
    in order — the engine's gradient, with no per-tensor copies. A CPU
    tensor runs the plain version; a CUDA one launches the kernel, counted
    on ``pair_grad_rng.launches``."""
    u32, _ = _seeds_u32(seeds)
    flat = _check_flat(flat)
    w = _weights(weights, u32.shape[0], flat.device)
    if not flat.is_cuda:
        return _grad_plain(flat, u32, w)
    out = torch.empty_like(flat)
    seeds_d = _seeds_on(u32, flat.device)
    err = _kernels().nes_pair_grad_rng(
        u32.shape[0], flat.shape[0], flat.data_ptr(), seeds_d.data_ptr(),
        w.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream)
    _raise_on(err, "pair_grad_rng")
    pair_grad_rng.launches += 1
    return out


def pair_grad_rng(scale: dict, seeds, weights) -> dict:
    """K6: ``sum_i weights[i] * delta(seeds[i])`` with every delta drawn
    again from its seed, summed over the pairs in order (deterministic, no
    atomics). scale: f32 dict (pad lanes 0); seeds: F host seeds; weights:
    F f32 (pad lanes 0). Returns an f32 dict shaped like ``scale``."""
    if not scale["img_w"].is_cuda:
        return pair_grad_rng_plain(scale, seeds, weights)
    return _as_dict(pair_grad_rng_flat(_check_scale(scale, scale), seeds,
                                       weights), scale)


pair_grad_rng.launches = 0


def box_muller_table(device) -> torch.Tensor:
    """(3, 2, 2^23) f32: for every 23-bit value k, u = k 2^-23, the rows
    ``logf(1 - u)``, ``sqrtf(-2 logf(1 - u))`` and ``cosf(f32(2 pi) u)``;
    on a CUDA device by the library call (column 0) and by the narrowed
    form K5, K6 and K7 run (column 1) — the check that the two agree bit
    for bit over every input the stream can give; on the CPU both columns
    hold the plain version's (torch's) values."""
    device = torch.device(device)
    if device.type != "cuda":
        u = (torch.arange(1 << 23, dtype=torch.int32) | 0x3F800000).view(
            torch.float32) - 1.0
        lg = torch.log(1.0 - u)
        two_pi = torch.tensor(TWO_PI_F32, dtype=torch.float32)
        rows = torch.stack([lg, torch.sqrt(-2.0 * lg), torch.cos(two_pi * u)])
        return torch.stack([rows, rows], 1)
    out = torch.empty((3, 2, 1 << 23), dtype=torch.float32, device=device)
    err = _kernels().nes_box_table(
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "box_muller_table")
    return out


def philox_words(seed: int, n: int, device) -> torch.Tensor:
    """(n, 4) int64: the uint32 words of Philox4x32-10 counters 0..n-1
    under key (seed, 0), from the kernels' generator on a CUDA device and
    from the plain one (ops/noise.py) on the CPU — the check that the two
    draw the same bits."""
    device = torch.device(device)
    if device.type != "cuda":
        q = torch.arange(n, device=device)
        z = torch.zeros_like(q)
        return torch.stack(philox4x32_10([q, z, z, z], (int(seed), 0)), -1)
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    err = _kernels().nes_philox_words(
        int(seed) & 0xFFFFFFFF, n, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "philox_words")
    return out.to(torch.int64) & 0xFFFFFFFF


#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each printed as it ends (any failure exits non-zero):

1. the card's name and power limit; the kernels built with nvcc from
   nes_img_captioning_tpu_torch/csrc/ (ptxas registers and spills per
   kernel); the pair kernel's cluster shape, shared memory, ring slots and
   cudaOccupancyMaxActiveClusters at each weight and delta dtype, and the
   member kernel's (K1, K4) at each weight dtype: a chunk of 48 members
   (96 CTAs) must be resident;
2. K1 (decode_fused, one 2-CTA cluster per member) at full width on a
   chunk of 48 members, f32 (TF32 off) and bf16, logprobs on and off,
   against its plain PyTorch twin;
3. K2 (decode_pair_perturb) on 24 pairs with a bf16 delta: tokens equal K1
   on prep(base ± delta) bit for bit, lp within 2e-5 of K1's (the cluster's
   halves sum exp in another order), and held to its plain twin;
4. three whole NIC-NES generations at the bench settings (fc_caption,
   vocab 9487, 144 pairs, batch 128, bf16 weights and deltas, pop_chunk 24,
   Adam, sigma 0.01) on the in-memory synthetic fixture, through the pair
   kernel and through the per-member path, each after one untimed warm-up
   generation: packed vectors bitwise equal, fitnesses finite, theta
   changed, launch counts read around each path;
5. K1's and K2's times at these shapes beside their plain twins', a cuBLAS
   yardstick for their products, and their bound; K1 and K2 on the first
   15 vocab tiles (Vpad 1920) beside the full 75, which parts the cost per
   vocab tile from the fixed cost per step; one profiled generation;
6. K7 (pair_delta_dump) on 24 seeds: the card's Philox words (the split
   rounds the delta stream runs) equal the plain stream's; its deltas are
   bitwise the plain version's run on the card (torch's CUDA log, sqrt and
   cos), within 8 ulps of the plain version on the CPU, and the flat entry
   (pair_delta_dump_flat) gives the dict form's values;
6b. the Box-Muller functions: the narrowed logf, sqrtf and cosf that K5,
   K6 and K7 run are bitwise the library calls on all 2^23 inputs each
   (box_muller_table);
7. K5 (decode_pair_rng), f32 and bf16: tokens and lp bitwise equal to K2
   fed K7's dump, and held to the plain version;
8. K6 (pair_grad_rng) over a generation's 144 lanes: bitwise the ordered
   f32 sum of K7's dumps, and bitwise its plain version on the card;
9. three kernel-noise generations (tpu.kernel_noise) after a warm-up: K5
   and K6 launched, K1, K2 and K7 not; bitwise equal to the delta-operand
   generation fed K7's dumps; one profiled generation with no normal_
   kernel;
10. NESMaster on experiments/mscoco_nes.json cut to 144 pairs, batch 128,
    pop_chunk 24, bf16, 256 validation images, kernel noise on: 4
    iterations with validation and snapshots, then a resume from the
    snapshot for one more generation — the path a user runs; blocks of 2
    generations, so tpu.fused_validation "auto" validates on the card, one
    row-block launch of K1 per generation;
11. K5's, K6's and K7's times beside their plain versions', the delta-operand
    path doing the same work, and their bounds by bytes and by operations
    (NORMAL_INT_OPS and NORMAL_F32_OPS per normal); K7 alone (the flat entry, K5's draw) beside its
    dict wrapper, and one torch.randn of the same count as a rate reference
    (not the same stream); K5 beside its parts (K7's draw, K2 on the f32
    dump) and K1 again as the run's anchor;
12. K3 (decode_sample, the member kernel with a Gumbel policy) on the
    chunk's 48 members x 5 lanes, the Gumbel values drawn in the kernel
    from the lane seeds the engine draws, f32 (TF32 off) and bf16, against
    its plain version: tokens equal but at near-ties of logits + G, lp
    within 2e-5 at f32, no pad column sampled; the host-table form fed the
    plain stream's table gives the same tokens, and fed an all-zero table
    K1's tokens bit for bit; a 256-row batch through the task's row blocks
    (two launches, the second at row offset 128) against the plain version
    of all 256 rows;
13. K4 (decode_tiled, vocab tile 1920 = Vpad / 5) against K1: tokens bit for
    bit at f32 and bf16, lp within 2e-5 of its plain version;
14. three generations each of the sample, self_critical and sc_loss kinds
    (per-member path: K3, and K1 for the self-critical baselines) and of
    greedy_logprob (pair kernel K2 with logprobs), launch counts read
    around each; fitnesses finite, theta changed;
15. a greedy per-member generation with tpu.decode_vocab_tile 1920 (K4):
    packed vector and theta bitwise equal to the K1 generation;
16. NESMaster on experiments/mscoco_nes.json with fitness self_critical and
    decode_vocab_tile 1920 (144 pairs, batch 128, 256 validation images):
    3 iterations with validation on the card and a snapshot, K3 carrying
    the samples, K4 the baselines and K4's row-block launch the
    validation, then a resume for one more;
17. K3's and K4's times beside their plain versions', a library yardstick
    (cuBLAS products, plus torch's Gumbel-max for K3) and their bounds; K3
    at Vpad 1920 beside 9600 (its fixed cost per step and cost per vocab
    tile) and its launch shape; one self_critical generation under
    torch.profiler;
18. NESMaster on experiments/mscoco_nes.json at full width with its 5000
    validation images (val_batch_size 256, gens_per_dispatch 8; kernel
    noise, 144 pairs, batch 128, pop_chunk 24): 8 iterations with fused
    validation and 4 with host validation (and 4 and 4 with 256 validation
    images), ms per iteration of each, theta bitwise equal after 4 and the
    acc series within 1e-4, one row-block launch of K1 per validation;
    validate_device and podium_merge under
    torch.cuda.set_sync_debug_mode("error"); the row-block launch over the
    5000 rows (K1 and K4) bit for bit the 40 launches of one block each,
    and held to its plain twin on the same bf16 rows (tokens up to
    near-ties, lp), with its time against theirs, its bound, its plain twin
    and cuBLAS;
19. ESMaster on experiments/mscoco_es.json at full width (NIC-ES: 1000
    offspring in chunks of 16, 50 parents, 3 elites, 2 candidates, batch
    256, 5000 validation images, SM-PROPORTIONAL, bf16) from one tpu.seed
    on the plain, fused and blocked paths, 6 generations each (the block
    covers generations 3-6): fitness vectors, children and podium rows bit
    for bit across the paths, K1 launched ceil(1000 / 16) x 2 times per
    generation, the fused generation and the block under
    torch.cuda.set_sync_debug_mode("error"); a sweep whose best child,
    rebuilt from its seed and decoded alone, keeps its fitness bit for bit;
    the sweep at pop_chunk 48 beside 16; one fused generation under
    torch.profiler (idle share, K1's share); K1 at the ES launch shape (16
    members x 128 rows) against its plain twin, cuBLAS and its bound;
20. ESMaster on experiments/mscoco_es_smg_fast.json uncut but for depth
    (SM-G-SUM over the first 64 rows of each batch at split 400, bf16
    sensitivities; 1000 offspring, 50 parents) on the plain, fused and
    blocked paths, 5 generations each (the config's snapshot_freq: a block
    of 2, then a fused generation): fitness vectors, kept children and
    podium rows bit for bit, one sweep of the 50 parents per generation, K1
    126 times per generation, no host sync inside a fused generation or a
    block; the sensitivity matrix of one parent set twice, bit for bit, its
    time at split 400 and 100; one parent's f32 sensitivities against the
    CPU's (rtol 2e-4, atol 1e-6); bf16 against f32 (printed); one fused
    generation and one sweep under torch.profiler;
21. NESMaster as in 10 with SM-G-SUM (64 rows, underflow 0.01): blocks of 2
    with inline sensitivities bit for bit the single generations; on one
    generation's SM-G scale, K5 bitwise K2 fed K7's dump and K6 the ordered
    sum of K7's dumps.

Then one JSON line of kernel measurements, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. No phase catches a failure.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from scripts.bench_fixture import (
    BENCH,
    bench_task,
    generation_inputs,
    noise_engine,
)

PEAK_BF16 = 989e12      # H100 SXM dense tensor-core bf16, FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 outside the tensor cores, FLOP/s
# 32-bit integer operations per s: the f32 rate counts an FMA as 2 FLOP on
# 128 lanes per SM and clock; integer add, logical, shift and multiply(-add)
# run on 64 lanes per SM and clock (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), one operation each
PEAK_INT32 = PEAK_F32 / 4
HBM_BYTES_PER_S = 3.35e12
# a lower count of the operations one of K3's Gumbel values needs, each
# taken at the f32 rate: two logarithms (at least a special-function op
# and a multiply each), the uniform's multiply-add, the add to the logit and
# the compare (7), and a quarter of a Philox4x32-10 call (10 rounds of 2
# multiply-highs, 2 multiplies, 4 xors and 2 key adds: 25)
GUMBEL_OPS = 32
# a lower count of the operations one normal of the delta stream (K5's draw,
# K6, K7) needs, by type. Integer (at PEAK_INT32): half a Philox4x32-10 call
# with every word that depends on the seed alone or on the counter alone
# made once (the key schedule, rounds 1-2's products; round 2 keeps its 2
# xors, rounds 3-10 their 2 32x32->64 products and 2 three-input xors: 34),
# and the two words' top bits into floats (1 each): 19. f32 FLOP (at
# PEAK_F32): Box-Muller, 13: the two uniforms, 1 - u, the log, x -2, the
# sqrt, x 2 pi, the cos, r * c and x scale, each special function counted
# as 2; K6 adds the multiply and the add of its weighted sum (GRAD_SUM_OPS)
NORMAL_INT_OPS = 19
NORMAL_F32_OPS = 13
GRAD_SUM_OPS = 2


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(report: str) -> list:
    """(kernel, line) for each register and spill line of nvcc's ptxas
    report, the kernel named from its mangled entry: template arguments t =
    bf16, f = f32, 0 / 1 = false / true."""
    import re

    name, out = "?", []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d+([a-z_]+_kernel)(?:I(\w*?)E)?E", entry.group(1))
            name = m.group(1) if m else entry.group(1)
            args = m.group(2) if m else None
            # the member kernel's Gumbel policy: none (K1, K4), seed or
            # table (K3)
            policy = re.search(r"(No|Seed|Table)Gumbel$", args or "")
            if policy:
                args = re.match(r"[tf]*(?:Lb[01]E)*", args).group(0)
            if args and re.fullmatch(r"[tf]*(Lb[01]E)*(Lb[01])?", args):
                args = re.sub(r"Lb([01])E?", r"\1", args)
                words = [{"t": "bf16", "f": "f32"}.get(c, c) for c in args]
                if policy:
                    words.append({"No": "none", "Seed": "seed",
                                  "Table": "table"}[policy.group(1)])
                name += "<" + ",".join(words) + ">"
        elif "registers" in line or "spill" in line:
            out.append((name, line.strip()))
    return out


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up,
    between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_near_ties(seq_k, seq_p, gap_p, what: str, limit: float = 1e-2):
    """Rows whose tokens differ must first differ at a near-tie of the plain
    version (top-2 logit gap < limit). Returns the share of identical rows
    and the count of differing rows."""
    same = (seq_k == seq_p).all(-1)
    rows = (~same).nonzero().tolist()
    for idx in rows:
        t0 = int((seq_k[tuple(idx)] != seq_p[tuple(idx)]).nonzero()[0])
        gap = float(gap_p[tuple(idx)][t0])
        if gap >= limit:
            raise AssertionError(
                f"{what}: row {idx} first differs at step {t0} where the "
                f"plain top-2 gap is {gap:.3g} >= {limit}")
    return float(same.float().mean()), len(rows)


def executed_steps(seq, T: int):
    """Token steps each CTA ran before its early exit: up to and including
    the step on which its last row emitted 0."""
    import torch

    zero = seq == 0
    first0 = torch.where(zero.any(-1), zero.int().argmax(-1), T - 1)
    return (first0.max(-1).values + 1).clamp(max=T)


# K1, K2 and K3 also run on the first 15 vocab tiles (Vpad 1920) of the
# same weights, beside the full 75: a cluster runs until its rows finish, so
# a launch lasts the image step plus its longest member's, lane's or pair's
# steps; the difference per step and vocab tile separates the cost of a tile
# from the fixed cost of a step (embedding, gates, merges, barriers)
VOCAB_CUT = 1920


def narrow_vocab(d: dict, lead: int) -> dict:
    """Decode params cut to the first VOCAB_CUT vocab columns; ``lead``
    leading axes before the embedding's vocab axis."""
    out = dict(d)
    out["logit_w"] = d["logit_w"][..., :VOCAB_CUT].contiguous()
    out["logit_b"] = d["logit_b"][..., :VOCAB_CUT].contiguous()
    out["embed"] = d["embed"][(slice(None),) * lead
                              + (slice(0, VOCAB_CUT),)].contiguous()
    return out


def step_costs(ms: float, cut_ms: float, steps, Vpad: int) -> tuple:
    """(fixed us per step, us per step and 128-column vocab tile) from a
    launch's ms at Vpad and at VOCAB_CUT columns and the longest steps each
    ran (the image step folded into both)."""
    step_full, step_cut = ms / steps[0], cut_ms / steps[1]
    per_tile = (step_full - step_cut) / ((Vpad - VOCAB_CUT) // 128)
    return (step_cut - per_tile * (VOCAB_CUT // 128)) * 1e3, per_tile * 1e3


def log_step_costs(phase: str, name: str, ms: float, cut_ms: float, steps,
                   Vpad: int, costs: tuple, card: str):
    log(f"{phase} {name} at Vpad {VOCAB_CUT} ({VOCAB_CUT // 128} vocab "
        f"tiles): {cut_ms:.3f} ms per launch, longest {steps[1]} steps; at "
        f"Vpad {Vpad} ({Vpad // 128} tiles) {ms:.3f} ms, {steps[0]} steps: "
        f"per step and 128-column vocab tile {costs[1]:.3f} us, fixed per "
        f"step {costs[0]:.3f} us (the image step folded into both) ({card})")


def decode_flops(n_steps, B: int, F: int, Vpad: int) -> float:
    """Multiply-adds x 2 of one decode: the image product, the two gate
    products on every LSTM step, the logits on every token step."""
    W = 128
    n = float(n_steps.sum())
    members = n_steps.numel()
    return 2.0 * B * (members * (F * W + 2 * W * 5 * W)
                      + n * (2 * W * 5 * W + W * Vpad))


def profile_call(fn):
    """``fn()`` once under torch.profiler: (wall ms, card-busy ms, kernel
    rows (ms, count, name) by device time). Busy is the union of the
    kernels' intervals, so streams that overlap count once."""
    import torch

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' device time
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages() if evt.device_type == cuda),
                  reverse=True)
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events() if e.device_type == cuda):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return wall_ms, busy / 1e3, rows


def profile_generation(eng, theta, sens, seeds, batches):
    """One NES generation under torch.profiler (``profile_call``)."""
    state = eng.optimizer.init(eng.dim, theta.device)
    return profile_call(lambda: eng.generation(
        theta, state, sens, BENCH["sigma"], seeds, batches,
        BENCH["stepsize"], BENCH["l2coeff"]))


def sampling_phases(task, theta, members, feats2, seeds, batches, sens,
                    lib_ms: float, card: str) -> list:
    """Phases 12-17: K3 and K4 against their plain versions, generations of
    the sampling, self-critical and per-token kinds and of the tiled greedy
    decode, the self-critical master, and K3's and K4's times. Returns their
    rows of the kernels line."""
    import glob
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine, NESMaster
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.noise import gumbel_plain, lane_seeds
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = theta.device
    lay = task.decode_layout
    P, B, F = BENCH["pop_chunk"], BENCH["batch"], BENCH["pairs"]
    T, Vpad = task.model.options.seq_length, lay.Vpad
    Fd, V = task.model.options.fc_feat_size, task.data.vocab_size
    spi, M = task.seq_per_img, 2 * P
    # K1, K2, K3, K4, K5, K6, K7
    counters = (dc.decode_fused, dc.decode_pair_perturb, dc.decode_sample,
                dc.decode_tiled, dc.decode_pair_rng, dc.pair_grad_rng,
                dc.pair_delta_dump)

    def zero():
        torch.cuda.synchronize()
        for c in (*counters, dc.decode_rows):
            c.launches = 0

    def counts():
        torch.cuda.synchronize()
        return tuple(c.launches for c in counters)

    def kind_task(kind, **tpu):
        return bench_task(dev, kind, task.data, **tpu)

    # ---- [12] K3 against its plain version on one chunk -------------------
    # the lane seeds the engine draws for the chunk's pair-major members
    lanes = np.stack([lane_seeds(seeds[0][:P], np.full(P, s), spi)
                      for s in (1, -1)], 1).reshape(M, spi)
    k3 = {}
    for dt in (torch.float32, torch.bfloat16):
        params = lay.prep(members, dt)
        seq_k, lp_k = dc.decode_fused(params, feats2, T, True, greedy=False,
                                      seeds=lanes)
        seq_p, lp_p, gap_p = dc.decode_sample_plain(
            params, feats2, T, True, seeds=lanes, top2_gap=True)
        torch.cuda.synchronize()
        share, n_diff = check_near_ties(seq_k, seq_p, gap_p, f"K3 {dt}")
        if int(seq_k.max()) > V:
            raise AssertionError(f"K3 {dt}: a pad column was sampled")
        msg = ""
        if dt == torch.float32:
            same = (seq_k == seq_p).all(-1)
            k3["max_abs_err"] = float((lp_k - lp_p).abs()[same].max())
            if k3["max_abs_err"] > 2e-5:
                raise AssertionError(
                    f"K3 f32: lp error {k3['max_abs_err']:.3g} > 2e-5")
            msg = f"; max |lp - plain| {k3['max_abs_err']:.3g} on equal rows"
        log(f"[12] K3 decode_sample {dt}, {M} members x {spi} lanes: "
            f"{share:.4%} of rows equal to the plain version, {n_diff} "
            f"differ, each first at a near-tie of logits + G (top-2 gap < "
            f"1e-2){msg}; no pad column sampled")
    del seq_p, lp_p, gap_p
    # the host-table form fed the plain stream's table, on 4 members
    sub = 4
    params = lay.prep(members[:sub], torch.bfloat16)
    s64 = torch.as_tensor(lanes[:sub].astype(np.int64), device=dev)
    table = torch.stack([gumbel_plain(s64, t, B, Vpad) for t in range(T)],
                        2).contiguous()
    seq_tab, _ = dc.decode_fused(params, feats2[:sub], T, False, greedy=False,
                                 gumbel=table)
    seq_seed, _ = dc.decode_fused(params, feats2[:sub], T, False,
                                  greedy=False, seeds=lanes[:sub])
    del table
    if not torch.equal(seq_tab, seq_seed):
        raise AssertionError("K3: the host-table form fed the plain stream's "
                             "table differs from the in-kernel draw")
    g_card = dc.gumbel_table(int(lanes[0, 0]), 3, B, Vpad, dev)
    g_plain = gumbel_plain(s64[0, 0], 3, B, Vpad)
    g_err = float((g_card - g_plain).abs().max())
    if g_err > 2 * 1.91e-6:
        raise AssertionError(f"K3: Gumbel values {g_err:.3g} from the plain "
                             "stream")
    log(f"[12] K3 host-table form fed the plain stream's table: tokens equal "
        f"the in-kernel draw on {sub} x {spi} lanes; the kernel's Gumbel "
        f"values {float((g_card == g_plain).float().mean()):.4%} bitwise "
        f"the plain stream's, max difference {g_err:.3g}")
    # fed an all-zero table, every lane takes K1's argmax: key = logit + 0,
    # the same runs and merges, so tokens and lp are K1's bit for bit
    zeros = torch.zeros((sub, spi, T, B, Vpad), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        params = lay.prep(members[:sub], dt)
        seq_z, lp_z = dc.decode_fused(params, feats2[:sub], T, True,
                                      greedy=False, gumbel=zeros)
        seq_1, lp_1 = dc.decode_fused(params, feats2[:sub], T, True)
        for lane in range(spi):
            if not (torch.equal(seq_z[:, lane], seq_1)
                    and torch.equal(lp_z[:, lane], lp_1)):
                raise AssertionError(f"K3 {dt}: lane {lane} fed a zero table "
                                     "is not K1 bit for bit")
    del zeros
    log(f"[12] K3 host-table form fed an all-zero table: tokens and lp of "
        f"every lane bitwise K1's on {sub} members, f32 and bf16")
    # a 256-row batch through the task's row blocks: two launches, the
    # second drawing at row offset 128, against the plain version of all
    # 256 rows; lp compared at the steps a row is still running (a block's
    # early exit leaves its later steps 0, the unsplit decode does not)
    idx256 = torch.as_tensor(np.random.default_rng(12).integers(
        0, task.train_n, size=(sub, 2 * B)), device=dev)
    feats256 = task.train_fc[idx256]
    params = lay.prep(members[:sub], torch.float32)
    sc_task = kind_task("sc_loss")  # a kind that reads lp
    before = dc.decode_sample.launches
    seq_s, lp_s = sc_task._sample(params, feats256, lanes[:sub])
    torch.cuda.synchronize()
    n_launch = dc.decode_sample.launches - before
    seq_p, lp_p, gap_p = dc.decode_sample_plain(
        params, feats256, T, True, seeds=lanes[:sub], top2_gap=True)
    share, n_diff = check_near_ties(seq_s, seq_p, gap_p, "K3 at 256 rows")
    same = (seq_s == seq_p).all(-1)
    running = torch.cat([torch.ones_like(seq_p[..., :1], dtype=torch.bool),
                         seq_p[..., :-1] > 0], -1)
    err256 = float(((lp_s - lp_p).abs() * running)[same].max())
    if n_launch != 2 or err256 > 2e-5:
        raise AssertionError(f"K3 at 256 rows: {n_launch} launches (2 "
                             f"expected), lp error {err256:.3g} (limit 2e-5)")
    del seq_p, lp_p, gap_p
    log(f"[12] K3 f32 at 256 rows through the task's row blocks ({n_launch} "
        f"launches, the second at row offset 128), {sub} members x {spi} "
        f"lanes: {share:.4%} of rows equal to the plain version of all 256 "
        f"rows, {n_diff} differ, each first at a near-tie; max |lp - plain| "
        f"{err256:.3g} on equal rows")

    # ---- [13] K4 against K1 ------------------------------------------------
    tile = Vpad // 5  # 1920 at full width
    k4 = {}
    for dt in (torch.float32, torch.bfloat16):
        params = lay.prep(members, dt)
        seq4, lp4 = dc.decode_fused(params, feats2, T, True, vocab_tile=tile)
        seq1, lp1 = dc.decode_fused(params, feats2, T, True)
        if not torch.equal(seq4, seq1):
            raise AssertionError(f"K4 {dt}: tokens differ from K1")
        msg = ""
        if dt == torch.float32:
            _, lp_p = dc.decode_tiled_plain(params, feats2, tile, T, True)
            k4["max_abs_err"] = float((lp4 - lp_p).abs().max())
            if k4["max_abs_err"] > 2e-5:
                raise AssertionError(
                    f"K4 f32: lp error {k4['max_abs_err']:.3g} > 2e-5")
            msg = f"; max |lp - plain| {k4['max_abs_err']:.3g}"
        log(f"[13] K4 decode_tiled {dt}, vocab tile {tile} ({Vpad // tile} "
            f"tiles): tokens bitwise K1's; max |lp - K1 lp| "
            f"{float((lp4 - lp1).abs().max()):.3g}{msg}")

    # ---- [14] one generation of each further fitness kind ------------------
    def engine(t):
        return NESEngine(t, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                         pop_chunk=P, delta_dtype="bf16")

    def generation(eng, g=0):
        return eng.generation(theta, eng.optimizer.init(eng.dim, dev), sens,
                              BENCH["sigma"], seeds[g], batches[g],
                              BENCH["stepsize"], BENCH["l2coeff"])

    n_chunks = -(-F // P)
    gens = BENCH["gens"]
    kind_ms, engines = {}, {}
    for kind in ("sample", "self_critical", "sc_loss", "greedy_logprob"):
        eng = engines[kind] = engine(
            sc_task if kind == "sc_loss" else kind_task(kind))
        generation(eng)  # untimed warm-up
        zero()
        times, outs = [], []
        for g in range(gens):
            t0 = time.perf_counter()
            outs.append(generation(eng, g))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        c = counts()
        n = n_chunks * gens
        want = {"sample": (0, 0, n, 0, 0, 0, 0),
                "self_critical": (n, 0, n, 0, 0, 0, 0),
                "sc_loss": (n, 0, n, 0, 0, 0, 0),
                "greedy_logprob": (0, n, 0, 0, 0, 0, 0)}[kind]
        if c != want:
            raise AssertionError(f"{kind}: launches (K1..K7) {c} != {want}")
        for th, _, packed in outs:
            if not torch.isfinite(packed).all():
                raise AssertionError(f"{kind}: non-finite fitness")
            if torch.equal(th, theta):
                raise AssertionError(f"{kind}: theta did not change")
        kind_ms[kind] = np.median(times) * 1e3
        fits = engines[kind].unpack(outs[-1][2], F)[0]
        log(f"[14] {kind}: {gens} generations, ms each "
            f"{[round(t * 1e3, 3) for t in times]}, median "
            f"{kind_ms[kind]:.3f} ms; launches K1..K7 {c}; fitness mean "
            f"{fits.mean():.6f}, spread {np.ptp(fits):.6f}; theta changed "
            f"({card})")

    # ---- [15] the tiled greedy generation equals the K1 one -----------------
    eng_t = engine(kind_task("greedy", decode_vocab_tile=tile))
    eng_1 = NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                      pop_chunk=P, kernel_perturb=False, delta_dtype="bf16")
    if eng_t._kernel_perturb:
        raise AssertionError("decode_vocab_tile: the pair kernel is on")
    zero()
    th_t, _, packed_t = generation(eng_t)
    c_t = counts()
    zero()
    th_1, _, packed_1 = generation(eng_1)
    c_1 = counts()
    if c_t != (0, 0, 0, n_chunks, 0, 0, 0) or c_1 != (n_chunks, 0, 0, 0, 0,
                                                     0, 0):
        raise AssertionError(f"tiled / K1 generation launches {c_t} / {c_1}")
    if not (torch.equal(packed_t, packed_1) and torch.equal(th_t, th_1)):
        raise AssertionError("the K4 generation differs from the K1 one")
    log(f"[15] greedy per-member generation with decode_vocab_tile {tile}: "
        f"packed vector and theta bitwise equal to the K1 generation; "
        f"launches K4 {c_t[3]} / K1 {c_1[0]}")

    # ---- [16] NESMaster: self_critical with the tiled decode ----------------
    runs_dir = os.path.join("logs", f"chip_smoke_sc_{os.getpid()}")

    def experiment(name: str) -> dict:
        exp = load_experiment("experiments/mscoco_nes.json")
        exp["config"].update(batch_size=B, val_batch_size=256,
                             num_val_items=256, snapshot_freq=3)
        exp["policy_options"]["fitness"] = "self_critical"
        exp["policy_options"]["model_options"]["fc_feat_size"] = Fd
        exp["nb_offspring"] = F
        exp["tpu"].update(pop_chunk=P, precision="bf16", delta_dtype="bf16",
                          decode_vocab_tile=tile)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    zero()
    t0 = time.perf_counter()
    master = NESMaster(experiment("train"), device=dev, data=task.data)
    master.run_master(max_iterations=3)
    c_m = counts()
    t_master = time.perf_counter() - t0
    acc = master.stats.acc_stats()
    if master.it.iteration() != 3 or len(acc) != 3 or \
            not np.isfinite(master.stats.score_stats()[1]).all():
        raise AssertionError("self-critical NESMaster: 3 finite iterations "
                             "with validation expected")
    want_m = (0, 0, 3 * n_chunks, 3 * n_chunks, 0, 0, 0)
    if not master._val_fused or c_m != want_m or dc.decode_rows.launches != 3:
        raise AssertionError(f"self-critical master launches (K1..K7) {c_m} "
                             f"!= {want_m}, or row-block K4 "
                             f"{dc.decode_rows.launches} != 3")
    zinfo = glob.glob(os.path.join(runs_dir, "train", "snapshot",
                                   "z_info_*.json"))
    if len(zinfo) != 1 or not zinfo[0].endswith(
            f"_i3-{task.train_n // B}.json"):
        raise AssertionError(f"self-critical NESMaster snapshot: {zinfo}")
    log(f"[16] NESMaster (experiments/mscoco_nes.json, self_critical, "
        f"decode_vocab_tile {tile}, 144 pairs, batch 128, pop_chunk 24, "
        f"bf16): 3 iterations in {t_master:.1f} s; validation CIDEr "
        f"{[round(a, 4) for a in acc]}; mean fitness "
        f"{[round(m, 4) for m in master.stats.score_stats()[1]]}; ms per "
        f"iteration {[round(t * 1e3, 3) for t in master.stats.time_stats()]}"
        f"; launches K3 {c_m[2]} (samples), K4 {c_m[3]} (baselines), "
        f"row-block K4 3 (validation on the card), K1 K2 K5 K6 K7 0; "
        f"snapshot {os.path.basename(zinfo[0])}")
    exp2 = experiment("resume")
    exp2["from_infos"] = zinfo[0]
    resumed = NESMaster(exp2, device=dev, data=task.data)
    if not torch.equal(resumed.theta, master.theta) or \
            int(resumed.opt_state.t) != 3:
        raise AssertionError("self-critical resume: theta or optimizer step "
                             "not restored")
    resumed.run_master(max_iterations=3)
    if len(resumed.stats.acc_stats()) != 4 \
            or torch.equal(resumed.theta, master.theta):
        raise AssertionError("self-critical resume: one more generation "
                             "expected")
    log(f"[16] resumed from {os.path.basename(zinfo[0])}: one more "
        f"self-critical generation trained and validated (CIDEr "
        f"{resumed.stats.acc_stats()[-1]:.4f})")
    shutil.rmtree(runs_dir)

    # ---- [17] K3's and K4's times at the main path's shapes -----------------
    params16 = lay.prep(members, torch.bfloat16)
    k3_ms = time_ms(lambda: dc.decode_fused(params16, feats2, T, False,
                                            greedy=False, seeds=lanes))
    k3_plain = time_ms(lambda: dc.decode_sample_plain(
        params16, feats2, T, False, seeds=lanes), reps=2)
    k4_ms = time_ms(lambda: dc.decode_fused(params16, feats2, T, False,
                                            vocab_tile=tile))
    k4_plain = time_ms(lambda: dc.decode_tiled_plain(
        params16, feats2, tile, T, False), reps=3)

    def library_sample():
        # cuBLAS for the products of the M x spi lanes (bf16 in, f32 out;
        # the lanes share their member's weights) and torch ops for the
        # Gumbel-max: uniform draw, -log(-log(u)), add, argmax
        x0 = torch.bmm(feats2.to(torch.bfloat16), params16["img_w"])
        h = x0.to(torch.bfloat16).repeat(1, spi, 1)
        for step in range(T + 1):
            torch.bmm(h, params16["i2h_w"])
            torch.bmm(h, params16["h2h_w"])
            if step:
                logits = torch.bmm(h, params16["logit_w"]).float()
                u = torch.rand(logits.shape, device=dev)
                (logits - torch.log(-torch.log(u))).argmax(-1)

    lib3_ms = time_ms(library_sample)
    seq3, _ = dc.decode_fused(params16, feats2, T, False, greedy=False,
                              seeds=lanes)
    steps3 = executed_steps(seq3.reshape(M * spi, B, T), T)
    flops3 = decode_flops(steps3, B, Fd, Vpad)
    gumbels = float(steps3.sum()) * B * Vpad
    seq4, _ = dc.decode_fused(params16, feats2, T, False, vocab_tile=tile)
    flops4 = decode_flops(executed_steps(seq4, T), B, Fd, Vpad)
    w_bytes = sum(v.numel() * v.element_size() for v in params16.values())
    k3_bytes = w_bytes + feats2.numel() * 2 + lanes.size * 4 + seq3.numel() * 8
    k4_bytes = w_bytes + feats2.numel() * 2 + seq4.numel() * 8
    # K3 at Vpad 1920 beside 9600: its fixed cost per step and its cost per
    # vocab tile, over all the launch's waves of clusters
    params16_n = narrow_vocab(params16, 1)
    k3_cut_ms = time_ms(lambda: dc.decode_fused(
        params16_n, feats2, T, False, greedy=False, seeds=lanes))
    seq3_n, _ = dc.decode_fused(params16_n, feats2, T, False, greedy=False,
                                seeds=lanes)
    steps = [int(executed_steps(s.reshape(M * spi, B, T), T).max())
             for s in (seq3, seq3_n)]
    del params16_n, seq3_n
    k3_costs = step_costs(k3_ms, k3_cut_ms, steps, Vpad)
    log_step_costs("[17]", "K3", k3_ms, k3_cut_ms, steps, Vpad, k3_costs,
                   card)
    info3 = dc.member_cluster_info(torch.bfloat16, sampled=True)
    k3_ctas = info3["cluster"] * M * spi
    log(f"[17] K3's launch shape: {M * spi} clusters of {info3['cluster']} "
        f"CTAs ({k3_ctas} CTAs), {info3['smem_bytes']} B dynamic shared "
        f"memory, {info3['ring_slots']} ring slots, "
        f"cudaOccupancyMaxActiveClusters {info3['max_active_clusters']}: "
        f"{M * spi / info3['max_active_clusters']:.2f} waves ({card})")
    rows = []
    member_ctas = dc.member_cluster_info()["cluster"] * M
    for name, replaces, ms, plain, lib, nbytes, flops, ops, err, launches in (
        ("decode_sample", "nes_img_captioning_tpu/ops/decode_pallas.py:658",
         k3_ms, k3_plain, lib3_ms, k3_bytes, flops3, GUMBEL_OPS * gumbels,
         k3["max_abs_err"], c_m[2]),
        ("decode_tiled", "nes_img_captioning_tpu/ops/decode_pallas.py:658",
         k4_ms, k4_plain, lib_ms, k4_bytes, flops4, 0.0, k4["max_abs_err"],
         c_m[3]),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = max(flops / PEAK_BF16, ops / PEAK_F32)
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        rows.append({
            "name": name, "route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib})
        if name == "decode_tiled":
            rows[-1]["ctas_per_launch"] = member_ctas
        else:
            rows[-1]["ctas_per_launch"] = k3_ctas
            rows[-1]["us_fixed_per_step"], \
                rows[-1]["us_per_step_and_vocab_tile"] = k3_costs
        log(f"[17] {name}: {ms:.3f} ms per launch (plain {plain:.3f} ms, "
            f"library yardstick {lib:.3f} ms, bound {b_ms:.4f} ms by {b_by}; "
            f"{flops / 1e9:.1f} GFLOP on the tensor cores, {ops / 1e9:.1f} G "
            f"Gumbel operations, {nbytes / 1e6:.1f} MB) ({card})")
    log(f"[17] K3 draws {gumbels / 1e9:.3f} G Gumbel values per launch "
        f"({gumbels / (k3_ms * 1e-3):.4g} per s)")

    wall, busy, prof_rows = profile_generation(
        engines["self_critical"], theta, sens, seeds[0], batches[0])
    log(f"[17] one self_critical generation under torch.profiler: wall "
        f"{wall:.3f} ms, card busy {busy:.3f} ms ({busy / wall:.2%}; idle "
        f"{1 - busy / wall:.2%}) ({card})")
    for ms, count, key in prof_rows[:12]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")
    return rows


# [18]'s validation subset: experiments/mscoco_nes.json's num_val_items
VAL_ITEMS = 5000
# [18]'s bound on |lp - plain| of the bf16 row-block launch where tokens
# agree: the kernel and its twin round the same bf16 values and differ only
# in the order of their f32 sums; a wrong row block, weight or step moves a
# log-probability over 9488 tokens by far more
LP_BF16_TOL = 1e-2


def rows_flops(seq, F: int, V1: int) -> float:
    """Multiply-adds x 2 that one row-block decode of seq (N, T) needs:
    each block of 128 rows runs the image product, the image step's input
    gate product (its h is 0, so no h2h), both gate products of every token
    step and the logits over the V1 real vocab columns (not the padding),
    until its longest row ends; the rows are the block's real ones."""
    W, T = 128, seq.shape[-1]
    total = 0.0
    for lo in range(0, seq.shape[0], W):
        blk = seq[lo:lo + W]
        n = int(executed_steps(blk[None], T)[0])
        total += 2.0 * blk.shape[0] * (F * W + W * 5 * W
                                       + n * (2 * W * 5 * W + W * V1))
    return total


def val_fixture():
    """The in-memory fixture of phases 18 and 19: the bench's 2048 train
    images and VAL_ITEMS validation images (mscoco_nes.json's and
    mscoco_es.json's num_val_items)."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )

    t0 = time.time()
    data = CocoData.from_arrays(synthetic_coco_arrays(
        n_train=2048, n_val=VAL_ITEMS, n_test=8, vocab_size=9487,
        fc_feat_size=2048, cap_len=9, seed=0))
    log(f"[18] fixture with {VAL_ITEMS} val images in "
        f"{time.time() - t0:.1f} s")
    return data


def validation_phase(card: str, data) -> list:
    """Phase 18: NESMaster on experiments/mscoco_nes.json at full width with
    VAL_ITEMS validation images (val_batch_size 256, gens_per_dispatch 8,
    kernel noise, 144 pairs, batch 128, pop_chunk 24): 8 iterations with
    fused validation (validate_device, K1 over all row blocks in one
    launch, the device podium) and 4 with host validation (the same launch,
    the native scorer), theta bitwise equal after 4 and the acc series
    within 1e-4; 4 and 4 with 256 validation images; validate_device and
    podium_merge under torch.cuda.set_sync_debug_mode("error"); the
    row-block launch at VAL_ITEMS rows in bf16 against one launch per block
    of 128, K1 and K4, bit for bit, and against its plain twin on the same
    rows (near-ties, lp), with times, bound, plain and cuBLAS times.
    Returns its row of the kernels line."""
    import glob
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import podium_merge
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_val_{os.getpid()}")
    B, F, P = BENCH["batch"], BENCH["pairs"], BENCH["pop_chunk"]

    def experiment(name: str, fused: bool, n_val: int) -> dict:
        exp = load_experiment("experiments/mscoco_nes.json")
        if (exp["config"]["num_val_items"], exp["config"]["val_batch_size"],
                exp["tpu"]["gens_per_dispatch"]) != (VAL_ITEMS, 256, 8):
            raise AssertionError("mscoco_nes.json: validation settings "
                                 "changed")
        exp["config"].update(batch_size=B, snapshot_freq=4,
                             num_val_items=n_val)
        exp["nb_offspring"] = F
        exp["tpu"].update(pop_chunk=P, precision="bf16", delta_dtype="bf16",
                          kernel_noise=True, fused_validation=fused)
        exp["log_dir"] = os.path.join(runs_dir, f"{name}_{n_val}")
        return exp

    counters = (dc.decode_rows, dc.decode_fused, dc.decode_pair_rng,
                dc.pair_grad_rng)

    def counted(fn):
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        fn()
        torch.cuda.synchronize()
        return tuple(c.launches for c in counters)

    n_chunks = -(-F // P)

    def both_paths(n_val: int, fused_iters: int):
        """``fused_iters`` iterations with fused validation (blocks of 4)
        and 4 with host validation on ``n_val`` val images: launch counts,
        theta after 4 bitwise equal, acc series within 1e-4."""
        masters = {}
        for name, fused in (("fused", True), ("host", False)):
            m = NESMaster(experiment(name, fused, n_val), device=dev,
                          data=data)
            # the scorers are built before the timed iterations (the host
            # one builds the native library on its first use)
            m.task.val_scorer
            m.task.device_val_consts()
            masters[name] = m
        fused, host = masters["fused"], masters["host"]
        c_f = counted(lambda: fused.run_master(max_iterations=4))
        theta4 = fused.theta.clone()
        c_h = counted(lambda: host.run_master(max_iterations=4))
        runs = [("fused", c_f), ("host", c_h)]
        if fused_iters > 4:
            runs.append(("fused, iterations 5-8", counted(
                lambda: fused.run_master(max_iterations=fused_iters))))
        if not fused._val_fused or host._val_fused:
            raise AssertionError("[18] fused_validation did not resolve")
        for what, c in runs:
            if c != (4, 0, 4 * n_chunks, 4):
                raise AssertionError(f"[18] {what} launches (row-block K1, "
                                     f"K1, K5, K6) {c}")
        if not torch.equal(theta4, host.theta):
            raise AssertionError("[18] theta after 4 iterations differs "
                                 "between fused and host validation")
        acc_f, acc_h = fused.stats.acc_stats(), host.stats.acc_stats()
        if len(acc_f) != fused_iters or len(acc_h) != 4 or not np.allclose(
                acc_f[:4], acc_h, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"[18] acc series differ: {acc_f} / "
                                 f"{acc_h}")
        if not np.isfinite(fused.stats.score_stats()[1]).all():
            raise AssertionError("[18] non-finite fitness")
        if len(glob.glob(os.path.join(runs_dir, f"fused_{n_val}", "models",
                                      "best", "best_elite", "*.pth"))) != 1:
            raise AssertionError("[18] the device podium's slot file is "
                                 "missing")
        ms_f = [round(t * 1e3, 3) for t in fused.stats.time_stats()]
        ms_h = [round(t * 1e3, 3) for t in host.stats.time_stats()]
        log(f"[18] NESMaster (experiments/mscoco_nes.json, {n_val} val "
            f"images, val_batch_size 256, gens_per_dispatch 8, kernel_noise, "
            f"{F} pairs, batch {B}, pop_chunk {P}, bf16): fused validation "
            f"ms per iteration {ms_f} (blocks of 4); host validation {ms_h}; "
            f"row-block K1 launches {c_f[0]} in 4 iterations (one per "
            f"validation), K1 per block 0; theta bitwise equal after 4 "
            f"iterations; acc fused {[round(a, 6) for a in acc_f]}, host "
            f"{[round(a, 6) for a in acc_h]} ({card})")
        return fused, host, ms_f, ms_h, c_f

    both_paths(256, 4)
    fused, host, ms_f, ms_h, c_f = both_paths(VAL_ITEMS, 8)

    # validation alone: fused (device) and host, and no host sync
    task = fused.task
    vconsts = task.device_val_consts()
    theta = fused.theta
    val_ms = time_ms(lambda: task.validate_device(theta, vconsts))
    t0 = time.perf_counter()
    host_val = task.validate(theta)
    host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host.task.validate(theta)
    host_ms2 = (time.perf_counter() - t0) * 1e3
    e_rows = fused._elite_rows_dev()
    e_scores = torch.as_tensor(fused._elite_scores_f32(), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        val = task.validate_device(theta, vconsts)
        merged = podium_merge(e_rows, e_scores, theta[None], val.reshape(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if abs(float(val) - host_val) > 1e-4 * max(abs(host_val), 1e-2) or \
            merged[0].shape != e_rows.shape:
        raise AssertionError(f"[18] validate_device {float(val)} against "
                             f"host {host_val}")
    merge_ms = time_ms(lambda: podium_merge(e_rows, e_scores, theta[None],
                                            val.reshape(1)), reps=20)
    log(f"[18] validation of {VAL_ITEMS} images: validate_device "
        f"{val_ms:.3f} ms (device time), podium_merge {merge_ms:.3f} ms; "
        f"host validate (decode, copy, native CIDEr, predictions JSON) "
        f"{host_ms:.3f} / {host_ms2:.3f} ms (host clock); CIDEr device "
        f"{float(val):.6f}, host {host_val:.6f}; validate_device and "
        f"podium_merge ran under set_sync_debug_mode('error') ({card})")

    # the row-block launch against one launch per block of 128
    params = dc.prepare_decode_params(task.spec, theta, task.model.options,
                                      dtype=torch.bfloat16)
    feats = vconsts["feats"]
    T, Fd = task.model.options.seq_length, feats.shape[1]
    n_blocks = -(-VAL_ITEMS // 128)
    row = {}
    for tile in (0, 1920):
        for need_lp in (True, False):
            one = dc.decode_rows(params, feats, T, need_lp, vocab_tile=tile)
            per = [dc.decode_fused(params, feats[lo:lo + 128], T, need_lp,
                                   vocab_tile=tile)
                   for lo in range(0, VAL_ITEMS, 128)]
            if not (torch.equal(one[0], torch.cat([p[0] for p in per]))
                    and torch.equal(one[1], torch.cat([p[1] for p in per]))):
                raise AssertionError(f"[18] row-block launch (vocab_tile "
                                     f"{tile}, lp {need_lp}): not bitwise "
                                     "the per-block launches")
        one_ms = time_ms(lambda: dc.decode_rows(params, feats, T, False,
                                                vocab_tile=tile))
        per_ms = time_ms(lambda: [
            dc.decode_fused(params, feats[lo:lo + 128], T, False,
                            vocab_tile=tile)
            for lo in range(0, VAL_ITEMS, 128)], reps=2)
        row[tile] = (one_ms, per_ms)
        log(f"[18] {'K4 (vocab_tile 1920)' if tile else 'K1'} over "
            f"{VAL_ITEMS} rows: one launch of {n_blocks} clusters "
            f"{one_ms:.3f} ms, {n_blocks} launches of one cluster "
            f"{per_ms:.3f} ms ({per_ms / one_ms:.1f}x); tokens and lp bit "
            f"for bit ({card})")
    # the row-block launch against its plain twin on the main path's inputs
    # (VAL_ITEMS rows, bf16): the timed plain run's tokens are held to the
    # timed launch's, rows that differ only where the plain top-2 gap is a
    # near-tie; lp over the row blocks whose tokens all agree (a block's
    # early exit follows its rows)
    seq, _ = dc.decode_rows(params, feats, T, False)
    seq_l, lp_k = dc.decode_rows(params, feats, T, True)
    plain = {}
    plain_ms = time_ms(lambda: plain.update(out=dc.decode_rows_plain(
        params, feats, T, False)), reps=1)
    seq_p, lp_p, gap_p = dc.decode_rows_plain(params, feats, T, True,
                                              top2_gap=True)
    torch.cuda.synchronize()
    if not (torch.equal(seq, seq_l) and torch.equal(plain["out"][0], seq_p)):
        raise AssertionError("[18] row-block tokens depend on need_logprobs")
    share, n_diff = check_near_ties(
        seq, seq_p, gap_p, f"[18] decode_rows bf16 at {VAL_ITEMS} rows")
    same = (seq_l == seq_p).all(-1)
    block = torch.arange(VAL_ITEMS, device=dev) // 128
    keep = ~torch.isin(block, block[~same])
    if not bool(keep.any()):
        raise AssertionError("[18] decode_rows bf16: no row block agrees "
                             "with the plain twin")
    err = float((lp_k - lp_p)[keep].abs().max())
    if err > LP_BF16_TOL:
        raise AssertionError(f"[18] decode_rows bf16: lp error {err:.3g} > "
                             f"{LP_BF16_TOL}")
    params32 = dc.prepare_decode_params(task.spec, theta, task.model.options)
    seq32, lp32 = dc.decode_rows(params32, feats[:256].float(), T, True)
    seq_p32, lp_p32 = dc.decode_rows_plain(params32, feats[:256].float(), T,
                                           True)
    torch.cuda.synchronize()
    if not torch.equal(seq32, seq_p32):
        raise AssertionError("[18] f32 row-block launch: tokens differ from "
                             "the plain twin")
    err32 = float((lp32 - lp_p32).abs().max())
    if err32 > 2e-5:
        raise AssertionError(f"[18] f32 row-block launch: lp error "
                             f"{err32:.3g}")
    tiled_plain_ms = time_ms(lambda: dc.decode_rows_plain(
        params, feats, T, False, vocab_tile=1920), reps=1)

    def library():
        # cuBLAS for the decode's products (bf16 in, f32 out) and argmax
        # over all rows: image step, 17 x gate products, 16 x logits
        h = (feats @ params["img_w"]).to(torch.bfloat16)
        for step in range(T + 1):
            h @ params["i2h_w"]
            h @ params["h2h_w"]
            if step:
                (h @ params["logit_w"]).argmax(-1)

    lib_ms = time_ms(library)
    flops = rows_flops(seq, Fd, task.model.options.vocab_size + 1)
    nbytes = sum(v.numel() * v.element_size() for v in params.values()) \
        + feats.numel() * feats.element_size() + seq.numel() * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16
    b_ms = max(t_bytes, t_ops) * 1e3
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    ctas = dc.member_cluster_info()["cluster"] * n_blocks
    log(f"[18] decode_rows at {VAL_ITEMS} rows: {row[0][0]:.3f} ms, {ctas} "
        f"CTAs (plain twin {plain_ms:.3f} ms, cuBLAS products "
        f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: {flops / 1e9:.1f} "
        f"GFLOP, {nbytes / 1e6:.1f} MB, {b_ms / row[0][0]:.1%} of it); bf16 "
        f"against the plain twin: {share:.4%} of rows identical, {n_diff} "
        f"differ, each first at a near-tie (top-2 gap < 1e-2), max |lp - "
        f"plain| {err:.3g} over {int(keep.sum())} rows of agreeing blocks; "
        f"f32 on 256 rows: tokens equal, max |lp - plain| {err32:.3g}; K4's "
        f"(vocab_tile 1920) plain twin {tiled_plain_ms:.3f} ms ({card})")
    shutil.rmtree(runs_dir)
    return [{
        "name": "decode_rows", "route": "cuda",
        "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
        "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py:658",
        "launches": c_f[0], "max_abs_err": err, "ms": row[0][0],
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "rows": VAL_ITEMS, "ctas_per_launch": ctas,
        "f32_256_rows_max_abs_err": err32,
        "per_block_launches_ms": row[0][1], "tiled_1920_ms": row[1920][0],
        "tiled_1920_per_block_launches_ms": row[1920][1],
        "tiled_1920_plain_ms": tiled_plain_ms,
        "validate_device_ms": val_ms, "host_validate_ms": host_ms2,
        "fused_iteration_ms": ms_f, "host_iteration_ms": ms_h,
    }]


# [19]: generations per ES path; with snapshots every ES_ITERS iterations
# the blocked path runs generation 1 plain, 2 fused and 3-6 as one block
ES_ITERS = 6
# experiments/mscoco_es.json's settings that phase 19 runs (nb_offspring,
# population_size, num_elites, num_elite_cands, selection, batch_size,
# num_val_items, noise_stdev, safe_mutations, precision, pop_chunk,
# gens_per_dispatch)
ES_SETTINGS = (1000, 50, 3, 2, "uniform", 256, 5000, 0.005,
               "SM-PROPORTIONAL", "bf16", 16, 8)


ES_COUNTERS = ("decode_fused", "decode_rows", "decode_tiled", "decode_sample",
               "decode_pair_perturb", "decode_pair_rng")


def no_sync(fn, calls):
    """fn under set_sync_debug_mode("error"): a host sync raises. Each call
    appends fn's name to ``calls``."""
    import torch

    def run(*a, **k):
        calls.append(fn.__name__)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def drive_es(exp: dict, dev, data, iters: int):
    """An ESMaster of ``exp`` on ``data`` run for ``iters`` generations, its
    fused generations and blocks under ``no_sync``, with the launch counts
    of ES_COUNTERS (K1, row-block K1, K4, K3, K2, K5) set to 0 just before
    and read just after. Returns (master, fitness vectors, engine calls,
    block sizes, counts); the master's ``setup_s`` and ``run_s`` are its
    construction's and its run's seconds on the host clock."""
    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine, ESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    counters = [getattr(dc, name) for name in ES_COUNTERS]
    t0 = time.perf_counter()
    m = ESMaster(exp, device=dev, data=data)
    m.task.val_scorer  # the scorers are built before the timed run
    m.task.device_val_consts()
    m.setup_s = time.perf_counter() - t0
    eng, fits, calls, blocks = m.engine, [], [], []
    host_fitness, unpack_fused = m.task.host_fitness, eng.unpack_fused
    unpack_block = ESEngine.unpack_block

    def hf(art, idx):
        fits.append(host_fitness(art, idx))
        return fits[-1]

    def uf(packed, n, c):
        out = unpack_fused(packed, n, c)
        fits.append(out[0])
        return out

    def ub(packed, k, n, c, e):
        out = unpack_block(packed, k, n, c, e)
        fits.extend(out[0])
        blocks.append(k)
        return out

    m.task.host_fitness, eng.unpack_fused = hf, uf
    eng.fused_generation = no_sync(eng.fused_generation, calls)
    eng.fused_block = no_sync(eng.fused_block, calls)
    ESEngine.unpack_block = staticmethod(ub)
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        m.run_master(max_iterations=iters)
        torch.cuda.synchronize()
        m.run_s = time.perf_counter() - t0
        counts = [c.launches for c in counters]
    finally:
        ESEngine.unpack_block = staticmethod(unpack_block)
    return m, fits, calls, blocks, counts


def es_state(m):
    """(children rows on the host, podium [(score, row)]) of an ESMaster."""
    spec = m.task.spec
    if m.parents_mat is None:
        children = m._selected_dev[:m._n_selected]
    else:
        n_el = sum(p is not None for p in m._parent_paths)
        children = m.parents_mat[n_el:m._n_parents]
    podium = [(s, spec.load_pth(p)) for p, s in m.it.best_elites() if p]
    return children.cpu(), podium


def es_phase(card: str, data) -> list:
    """Phase 19: ESMaster on experiments/mscoco_es.json at full width (1000
    offspring in chunks of 16, 50 parents, 3 elites, 2 candidates, batch
    256, 5000 validation images, SM-PROPORTIONAL, bf16) from one tpu.seed
    on the plain, fused and blocked paths, ES_ITERS generations each:
    fitness vectors, children and podium rows bit for bit, candidate scores
    of the fused and blocked paths bit for bit (the plain path's, validated
    on the host, within 1e-4); K1 launched ceil(1000 / 16) x 2 times per
    generation; no host sync inside a fused generation or a block. Then a
    sweep whose best child, rebuilt by materialize and decoded alone, gets
    its sweep fitness bit for bit, and whose fused generation keeps the
    same children; the sweep at pop_chunk 48 beside 16; one fused
    generation under torch.profiler; K1 at the ES launch shape against its
    plain twin. Returns its row of the kernels line."""
    import copy
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.utils.config import (
        load_experiment,
        parse_tpu_config,
    )

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_es_{os.getpid()}")

    def experiment(name: str, **tpu) -> dict:
        exp = load_experiment("experiments/mscoco_es.json")
        cfg, mo = exp["config"], exp["policy_options"]["model_options"]
        got = (exp["nb_offspring"], exp["population_size"],
               exp["num_elites"], exp["num_elite_cands"], exp["selection"],
               cfg["batch_size"], cfg["num_val_items"], cfg["noise_stdev"],
               mo["safe_mutations"], exp["tpu"]["precision"],
               exp["tpu"]["pop_chunk"], exp["tpu"]["gens_per_dispatch"])
        if got != ES_SETTINGS:
            raise AssertionError(f"[19] mscoco_es.json changed: {got}")
        exp["config"]["snapshot_freq"] = ES_ITERS
        exp["tpu"].update(tpu)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    L, chunk, B = ES_SETTINGS[0], ES_SETTINGS[10], ES_SETTINGS[5]
    k1_per_gen = -(-L // chunk) * -(-B // 128)

    def drive(name: str, **tpu):
        m, fits, calls, _, counts = drive_es(
            experiment(name, **tpu), dev, data, ES_ITERS)
        rows_want = 2 * ES_ITERS + (2 if name != "plain" else 0)
        if counts != [ES_ITERS * k1_per_gen, rows_want, 0, 0, 0, 0]:
            raise AssertionError(f"[19] {name}: launches (K1, row-block K1, "
                                 f"K4, K3, K2, K5) {counts}")
        want_calls = {"plain": [], "fused": ["fused_generation"] * 5,
                      "blocked": ["fused_generation", "fused_block"]}[name]
        if calls != want_calls or len(fits) != ES_ITERS:
            raise AssertionError(f"[19] {name}: engine calls {calls}, "
                                 f"{len(fits)} fitness vectors")
        if not all(np.isfinite(f).all() for f in fits):
            raise AssertionError(f"[19] {name}: non-finite fitness")
        children, podium = es_state(m)
        ms = [round(t * 1e3, 3) for t in m.stats.time_stats()]
        log(f"[19] ESMaster {name} (experiments/mscoco_es.json: {L} "
            f"offspring, pop_chunk {chunk}, batch {B}, {ES_SETTINGS[6]} val "
            f"images, bf16; set-up {m.setup_s:.1f} s, run {m.run_s:.1f} s "
            f"with its snapshot): ms per generation {ms}; K1 launches "
            f"{counts[0]} "
            f"({k1_per_gen} per generation), row-block K1 {counts[1]}; "
            f"engine calls {calls} under set_sync_debug_mode('error') "
            f"({card})")
        return m, fits, children, podium, counts, ms

    runs = {name: drive(name, **tpu) for name, tpu in (
        ("plain", {"fused_es": False}), ("fused", {"gens_per_dispatch": 1}),
        ("blocked", {}))}
    pm, pfits, pchildren, ppodium, _, _ = runs["plain"]
    for name in ("fused", "blocked"):
        m, fits, children, podium, _, _ = runs[name]
        if not all(np.array_equal(a, b) for a, b in zip(pfits, fits)):
            raise AssertionError(f"[19] {name}: fitness vectors differ from "
                                 "the plain path's")
        if not torch.equal(children, pchildren) or len(podium) != len(
                ppodium) or not all(torch.equal(a[1], b[1])
                                    for a, b in zip(podium, ppodium)):
            raise AssertionError(f"[19] {name}: parents differ from the "
                                 "plain path's")
        if m.stats.to_dict()["norm_stats"] != pm.stats.to_dict()[
                "norm_stats"]:
            raise AssertionError(f"[19] {name}: mean|policy| differs")
        if not np.allclose(m.stats.acc_stats(), pm.stats.acc_stats(),
                           rtol=1e-4, atol=1e-6) or not np.allclose(
                [s for s, _ in podium], [s for s, _ in ppodium], rtol=1e-4,
                atol=1e-6):
            raise AssertionError(f"[19] {name}: candidate or podium scores "
                                 "beyond 1e-4 of the plain path's")
    fm, bm = runs["fused"][0], runs["blocked"][0]
    es_ms = {name: r[5] for name, r in runs.items()}
    launches = runs["blocked"][4][0]  # K1 in the blocked run, the default
    if fm.stats.acc_stats() != bm.stats.acc_stats() or [
            float(np.float32(s)) for s, _ in runs["fused"][3]] != [
            float(np.float32(s)) for s, _ in runs["blocked"][3]]:
        raise AssertionError("[19] fused and blocked candidate or podium "
                             "scores differ")
    log(f"[19] plain, fused and blocked paths: {ES_ITERS} fitness vectors "
        f"of {L}, {pchildren.shape[0]} children and {len(ppodium)} podium "
        f"rows bit for bit; fused and blocked candidate scores bit for bit, "
        f"plain (host validation) within "
        f"{max(abs(a - b) for a, b in zip(pm.stats.acc_stats(), fm.stats.acc_stats())):.3g}"
        f"; acc {[round(a, 6) for a in fm.stats.acc_stats()]} ({card})")
    del runs, pm, fm

    # a sweep and its best child rebuilt: the same bits, the same fitness
    m = bm
    eng, task = m.engine, m.task
    elites = m._device_elite_rows([p for p, _ in m.it.best_elites() if p])
    parents = torch.cat([elites, m._selected_dev])
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2**32, size=L, dtype=np.uint32)
    pidx = rng.integers(0, parents.shape[0], size=L).astype(np.int32)
    idx_row = rng.choice(task.train_n, size=B, replace=False)
    sigma = m.it.noise_stdev()
    consts, vconsts = task.device_consts(), task.device_val_consts()
    fit = eng.eval_generation(parents, sigma, seeds, pidx, idx_row)["fitness"]
    order = np.argsort(-fit.cpu().numpy(), kind="stable")
    best = eng.materialize(parents, sigma, seeds[order[:1]], pidx[order[:1]])
    refit = task.rollout(best, torch.as_tensor(idx_row, device=dev))[
        "fitness"]
    n_keep = ES_SETTINGS[1] - ES_SETTINGS[2]
    fit2, selected, _, _ = eng._gen_core(parents, sigma, seeds, pidx,
                                         idx_row, consts, vconsts, n_keep, 2)
    kept = eng.materialize(parents, sigma, seeds[order[:n_keep]],
                           pidx[order[:n_keep]])
    torch.cuda.synchronize()
    if not torch.equal(refit[0], fit[int(order[0])]):
        raise AssertionError(f"[19] rebuilt best child: fitness "
                             f"{float(refit[0])} != sweep "
                             f"{float(fit[int(order[0])])}")
    if not (torch.equal(fit2, fit) and torch.equal(selected, kept)):
        raise AssertionError("[19] the fused generation's kept children "
                             "are not materialize's rebuild")
    log(f"[19] sweep of {L} offspring: the best child rebuilt by "
        f"materialize and decoded alone scores {float(refit[0]):.6f}, its "
        f"sweep fitness bit for bit; the fused generation keeps materialize's "
        f"{n_keep} children bit for bit ({card})")

    # the sweep at pop_chunk 48 beside the config's 16 (A B B A)
    exp48 = copy.deepcopy(m.exp)
    exp48["tpu"]["pop_chunk"] = 48
    eng48 = ESEngine(task, m.mutation,
                     pop_chunk=parse_tpu_config(exp48).pop_chunk)
    sweep_ms, sweep_k1 = {chunk: [], 48: []}, {}
    for c, e in ((chunk, eng), (48, eng48), (48, eng48), (chunk, eng)):
        torch.cuda.synchronize()
        before = dc.decode_fused.launches
        t0 = time.perf_counter()
        f = e.eval_generation(parents, sigma, seeds, pidx, idx_row)[
            "fitness"]
        torch.cuda.synchronize()
        sweep_ms[c].append((time.perf_counter() - t0) * 1e3)
        sweep_k1[c] = dc.decode_fused.launches - before
        if not torch.equal(f, fit):
            raise AssertionError(f"[19] pop_chunk {c}: fitness differs")
    log(f"[19] the sweep of {L} offspring at pop_chunk {chunk}: "
        f"{np.mean(sweep_ms[chunk]):.3f} ms ({sweep_ms[chunk]}, "
        f"{sweep_k1[chunk]} K1 launches); at pop_chunk 48: "
        f"{np.mean(sweep_ms[48]):.3f} ms ({sweep_ms[48]}, {sweep_k1[48]} K1 "
        f"launches); fitness bit for bit (host clock, ending in "
        f"synchronize) ({card})")

    # one fused generation under the profiler
    policy = m.policy_theta
    wall_ms, busy, rows = profile_call(lambda: eng.unpack_fused(
        ESEngine.fused_generation(eng, elites, elites.shape[0],
                                  m._selected_dev, sigma, seeds, pidx,
                                  idx_row, policy, 2)[0], L, 2))
    k1_dev = sum(r[0] for r in rows if "member_kernel" in r[2])
    log(f"[19] one fused ES generation under torch.profiler: wall "
        f"{wall_ms:.3f} ms, card busy {busy:.3f} ms (idle "
        f"{1 - busy / wall_ms:.2%}); K1 (member_kernel, sweep and "
        f"validation) {k1_dev:.3f} ms, {k1_dev / busy:.2%} of the card's "
        f"busy time ({card})")
    for ms, count, key in rows[:12]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")

    # K1 at the ES launch shape: 16 members x 128 rows, bf16
    lay, T = task.decode_layout, task.model.options.seq_length
    kids = eng.materialize(parents, sigma, seeds[:chunk], pidx[:chunk])
    params = lay.prep(lay.to_dec(kids), torch.bfloat16)
    feats = task.train_fc[torch.as_tensor(idx_row[:128], device=dev)]
    feats = feats.expand(chunk, -1, -1).contiguous()
    del kids
    k1_ms = time_ms(lambda: dc.decode_fused(params, feats, T, False))
    plain_ms = time_ms(lambda: dc.decode_fused_plain(params, feats, T,
                                                     False), reps=1)
    seq, lp = dc.decode_fused(params, feats, T, True)
    seq_p, lp_p, gap_p = dc.decode_fused_plain(params, feats, T, True,
                                               top2_gap=True)
    torch.cuda.synchronize()
    share, n_diff = check_near_ties(seq, seq_p, gap_p,
                                    "[19] K1 bf16 at the ES shape")
    agree = (seq == seq_p).all(-1).all(-1)  # members decoded alike
    if not bool(agree.any()):
        raise AssertionError("[19] K1 bf16: no member agrees with the "
                             "plain twin")
    err = float((lp - lp_p)[agree].abs().max())
    if err > LP_BF16_TOL:
        raise AssertionError(f"[19] K1 bf16: lp error {err:.3g} > "
                             f"{LP_BF16_TOL}")

    def library():
        h = torch.bmm(feats.to(torch.bfloat16), params["img_w"]).to(
            torch.bfloat16)
        for step in range(T + 1):
            torch.bmm(h, params["i2h_w"])
            torch.bmm(h, params["h2h_w"])
            if step:
                torch.bmm(h, params["logit_w"]).argmax(-1)

    lib_ms = time_ms(library)
    # each member's 128 rows are one row block of rows_flops: the logits
    # over the V + 1 real columns, no h2h product at the image step
    Fd, V1 = feats.shape[-1], task.model.options.vocab_size + 1
    flops = sum(rows_flops(member_seq, Fd, V1) for member_seq in seq)
    nbytes = sum(v.numel() * v.element_size() for v in params.values()) \
        + feats.numel() * 2 + seq.numel() * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16
    b_ms = max(t_bytes, t_ops) * 1e3
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    ctas = dc.member_cluster_info()["cluster"] * chunk
    log(f"[19] K1 at the ES launch shape ({chunk} members x 128 rows, "
        f"{ctas} CTAs, bf16): {k1_ms:.3f} ms per launch (plain twin "
        f"{plain_ms:.3f} ms, cuBLAS products {lib_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}: {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB, {b_ms / k1_ms:.1%} of it); against the "
        f"plain twin {share:.4%} of rows identical, {n_diff} differ, each "
        f"first at a near-tie, max |lp - plain| {err:.3g} over "
        f"{int(agree.sum())} agreeing members; {launches} launches in the "
        f"blocked run ({card})")
    shutil.rmtree(runs_dir)
    return [{
        "name": "decode_fused_es_chunk16", "route": "cuda",
        "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
        "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py:658",
        "launches": launches, "max_abs_err": err, "ms": k1_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "ctas_per_launch": ctas,
        "k1_launches_per_generation": launches // ES_ITERS,
        "es_generation_ms": es_ms, "sweep_ms_pop_chunk16": float(
            np.mean(sweep_ms[chunk])),
        "sweep_ms_pop_chunk48": float(np.mean(sweep_ms[48])),
        "fused_generation_idle_share": 1 - busy / wall_ms,
        "k1_share_of_busy": k1_dev / busy,
    }]


# [20]: experiments/mscoco_es_smg_fast.json's settings that phase 20 runs
# (nb_offspring, population_size, num_elites, num_elite_cands, selection,
# batch_size, num_val_items, noise_stdev, safe_mutations,
# safe_mutation_underflow, precision, pop_chunk, gens_per_dispatch,
# snapshot_freq, sensitivity_batch, sensitivity_split,
# sensitivity_precision)
SMG_SETTINGS = (1000, 50, 3, 2, "uniform", 256, 5000, 0.005, "SM-G-SUM",
                0.01, "bf16", 16, 8, 5, 64, 400, "bfloat16")
# generations per path: the config's snapshot_freq, so the blocked path runs
# generation 1 plain, 2 fused, 3-4 as one block and 5 fused
SMG_ITERS = 5
# the bar of the f32 sensitivities on the card against the CPU's
SENS_RTOL, SENS_ATOL = 2e-4, 1e-6


def events_ms(fn):
    """(fn(), its device time in ms between CUDA events), one call."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def es_smg_phase(card: str, data, k1_row: dict) -> list:
    """Phase 20: ESMaster on experiments/mscoco_es_smg_fast.json, uncut but
    for depth (SMG_SETTINGS: 1000 offspring in chunks of 16, 50 parents,
    SM-G-SUM over the first 64 rows of each batch at split 400, bf16
    sensitivities and decode), from one tpu.seed on the plain, fused and
    blocked paths as phase 19 runs them (``drive_es``), SMG_ITERS
    generations each: fitness vectors, children and podium rows bit for
    bit, K1 launched ceil(1000 / 16) x 2 times per generation, one sweep of
    the 50 parents per generation after the first, no host sync inside a
    fused generation or a block. Then on one parent set: its sensitivity
    matrix twice, bit for bit, and the sweep's time (CUDA events) at split
    400 and once at the reference's 100; one parent's f32 sensitivities on
    the card against the CPU's (SENS_RTOL, SENS_ATOL); the bf16
    sensitivities' relative error against f32 (printed, not gated); one
    fused generation and one sweep under torch.profiler. Returns K1's row
    of the kernels line for this path, its times those of phase 19's
    ``k1_row`` (the same launch shape, in this run)."""
    import shutil
    import warnings

    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops import sensitivity as S
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_smg_{os.getpid()}")
    t_phase = time.perf_counter()

    def experiment(name: str, **tpu) -> dict:
        exp = load_experiment("experiments/mscoco_es_smg_fast.json")
        cfg, mo = exp["config"], exp["policy_options"]["model_options"]
        t = exp["tpu"]
        got = (exp["nb_offspring"], exp["population_size"],
               exp["num_elites"], exp["num_elite_cands"], exp["selection"],
               cfg["batch_size"], cfg["num_val_items"], cfg["noise_stdev"],
               mo["safe_mutations"], mo["safe_mutation_underflow"],
               t["precision"], t["pop_chunk"], t["gens_per_dispatch"],
               cfg["snapshot_freq"], t["sensitivity_batch"],
               t["sensitivity_split"], t["sensitivity_precision"])
        if got != SMG_SETTINGS:
            raise AssertionError(f"[20] mscoco_es_smg_fast.json changed: "
                                 f"{got}")
        exp["tpu"].update(tpu)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    L, P, B = SMG_SETTINGS[0], SMG_SETTINGS[1], SMG_SETTINGS[5]
    chunk = SMG_SETTINGS[11]
    k1_per_gen = -(-L // chunk) * -(-B // 128)
    sweep = ESEngine.sensitivities
    runs = {}
    for name, tpu in (("plain", {"fused_es": False}),
                      ("fused", {"gens_per_dispatch": 1}), ("blocked", {})):
        sweeps = []

        def counted(self, parents, sens_idx, seed0, sweeps=sweeps):
            sweeps.append((parents.shape[0], len(sens_idx)))
            return sweep(self, parents, sens_idx, seed0)

        ESEngine.sensitivities = counted
        try:
            m, fits, calls, blocks, counts = drive_es(
                experiment(name, **tpu), dev, data, SMG_ITERS)
        finally:
            ESEngine.sensitivities = sweep
        rows_want = 2 * SMG_ITERS + (2 if name != "plain" else 0)
        if counts != [SMG_ITERS * k1_per_gen, rows_want, 0, 0, 0, 0]:
            raise AssertionError(f"[20] {name}: launches (K1, row-block K1, "
                                 f"K4, K3, K2, K5) {counts}")
        want = {"plain": ([], []),
                "fused": (["fused_generation"] * (SMG_ITERS - 1), []),
                "blocked": (["fused_generation", "fused_block",
                             "fused_generation"], [2])}[name]
        if (calls, blocks) != want or len(fits) != SMG_ITERS:
            raise AssertionError(f"[20] {name}: engine calls {calls}, blocks "
                                 f"{blocks}, {len(fits)} fitness vectors")
        if sweeps != [(P, SMG_SETTINGS[14])] * (SMG_ITERS - 1):
            raise AssertionError(f"[20] {name}: sensitivity sweeps {sweeps}")
        if not all(np.isfinite(f).all() for f in fits):
            raise AssertionError(f"[20] {name}: non-finite fitness")
        children, podium = es_state(m)
        ms = [round(t * 1e3, 3) for t in m.stats.time_stats()]
        log(f"[20] ESMaster {name} (experiments/mscoco_es_smg_fast.json: {L} "
            f"offspring, pop_chunk {chunk}, batch {B}, SM-G-SUM over "
            f"{SMG_SETTINGS[14]} rows at split {SMG_SETTINGS[15]}, "
            f"{SMG_SETTINGS[16]} sensitivities, bf16 decode; set-up "
            f"{m.setup_s:.1f} s, run {m.run_s:.1f} s with its snapshot): ms "
            f"per "
            f"generation {ms}; K1 launches {counts[0]} ({k1_per_gen} per "
            f"generation), row-block K1 {counts[1]}; sweeps of {P} parents "
            f"{len(sweeps)}; engine calls {calls}, blocks of {blocks} "
            f"generations, under set_sync_debug_mode('error') ({card})")
        runs[name] = (m, fits, children, podium, counts, ms)

    pm, pfits, pchildren, ppodium, _, _ = runs["plain"]
    for name in ("fused", "blocked"):
        m, fits, children, podium, _, _ = runs[name]
        if not all(np.array_equal(a, b) for a, b in zip(pfits, fits)):
            raise AssertionError(f"[20] {name}: fitness vectors differ from "
                                 "the plain path's")
        if not torch.equal(children, pchildren) or len(podium) != len(
                ppodium) or not all(torch.equal(a[1], b[1])
                                    for a, b in zip(podium, ppodium)):
            raise AssertionError(f"[20] {name}: kept children or podium "
                                 "rows differ from the plain path's")
        if m.stats.to_dict()["norm_stats"] != pm.stats.to_dict()[
                "norm_stats"]:
            raise AssertionError(f"[20] {name}: mean|policy| differs")
        if not np.allclose(m.stats.acc_stats(), pm.stats.acc_stats(),
                           rtol=1e-4, atol=1e-6) or not np.allclose(
                [s for s, _ in podium], [s for s, _ in ppodium], rtol=1e-4,
                atol=1e-6):
            raise AssertionError(f"[20] {name}: candidate or podium scores "
                                 "beyond 1e-4 of the plain path's")
    fm, bm = runs["fused"][0], runs["blocked"][0]
    if fm.stats.acc_stats() != bm.stats.acc_stats():
        raise AssertionError("[20] fused and blocked candidate scores differ")
    es_ms = {name: r[5] for name, r in runs.items()}
    launches = runs["blocked"][4][0]
    log(f"[20] plain, fused and blocked paths: {SMG_ITERS} fitness vectors "
        f"of {L}, {pchildren.shape[0]} kept children and {len(ppodium)} "
        f"podium rows bit for bit; acc "
        f"{[round(a, 6) for a in fm.stats.acc_stats()]} ({card})")
    del runs, pm, fm

    # one parent set: the sweep twice, its time at split 400 and 100
    m = bm
    eng, task = m.engine, m.task
    elites = m._device_elite_rows([p for p, _ in m.it.best_elites() if p])
    parents = torch.cat([elites, m._selected_dev])
    rng = np.random.default_rng(2)
    seeds = rng.integers(0, 2**32, size=L, dtype=np.uint32)
    pidx = rng.integers(0, P, size=L).astype(np.int32)
    idx_row = rng.choice(task.train_n, size=B, replace=False)
    sens_idx = m._sens_batch_rows(idx_row)
    seed0 = int(seeds[0])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = eng.sensitivities(parents, sens_idx, seed0)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    again, sweep_ms = events_ms(
        lambda: eng.sensitivities(parents, sens_idx, seed0))
    sweep_mem = torch.cuda.max_memory_allocated() - base_mem
    if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("[20] the sensitivity matrix differs between "
                             "two sweeps of one parent set")
    # the same sweep one parent at a time (no outer vmap), for its time
    idx_d = torch.as_tensor(sens_idx, dtype=torch.long, device=dev)
    uf = eng._sens_underflow
    single, single_ms = events_ms(lambda: torch.stack([S.calc_sensitivity(
        task, th.clone(), idx_d, eng.mutation, uf, eng._sens_precision)
        for th in parents]))
    same_single = torch.equal(single.view(torch.int32),
                              first.view(torch.int32))
    del single
    split = task._sens_split
    task._sens_split = 100
    try:
        s100, sweep100_ms = events_ms(
            lambda: eng.sensitivities(parents, sens_idx, seed0))
        groups100 = task.sensitivity_groups
    finally:
        task._sens_split = split
    del s100
    log(f"[20] SM-G-SUM sweep of {P} parents over {len(sens_idx)} rows, "
        f"{eng._sens_precision} products, vmap groups of {S.SENS_GROUP}: "
        f"{sweep_ms:.3f} ms at split {split} "
        f"({task.sensitivity_groups} groups; {sweep_ms / P:.3f} ms per "
        f"parent; one parent at a time {single_ms:.3f} ms, "
        f"{'the same bits' if same_single else 'other bits'}; "
        f"{sweep_mem / 2**30:.2f} GiB peak above the "
        f"{P} x {eng.dim:,} result), {sweep100_ms:.3f} ms at the reference's "
        f"split 100 ({groups100} groups) (CUDA events); the {P} x "
        f"{eng.dim:,} matrix bit for bit the same on a second sweep; "
        f"{(first > 1).float().mean():.4%} of entries above the clamp; "
        f"warnings during the sweep: "
        f"{sorted({str(w.message)[:120] for w in caught}) or 'none'} "
        f"({card})")

    # one parent's f32 sensitivities on the card against the CPU's, and the
    # bf16 products' relative error against f32
    theta0 = parents[0].clone()
    raw32, raw16 = (S.sum_sens(task.sensitivity_forward, theta0, idx_d,
                               task.device_consts(), prec)
                    for prec in ("float32", "bfloat16"))
    card32, card16 = S.postprocess(raw32, uf), S.postprocess(raw16, uf)
    feats_cpu = task.train_fc[idx_d].cpu()

    def forward_cpu(th, idx, consts):
        return task.model.forward_for_sensitivity(th, feats_cpu[idx], 5,
                                                  split)

    t0 = time.perf_counter()
    cpu32 = S.postprocess(S.sum_sens(forward_cpu, theta0.cpu(),
                                     torch.arange(len(sens_idx)), None,
                                     "float32"), uf)
    cpu_s = time.perf_counter() - t0
    c32 = card32.cpu()
    err = (c32 - cpu32).abs()
    rel_cpu = float((err / cpu32).max())
    if not bool((err <= SENS_ATOL + SENS_RTOL * cpu32.abs()).all()):
        raise AssertionError(f"[20] f32 sensitivities on the card beyond "
                             f"rtol {SENS_RTOL} / atol {SENS_ATOL} of the "
                             f"CPU's (max relative error {rel_cpu:.3g})")
    rel16 = ((card16 - card32).abs() / card32).cpu()
    live = raw32 > 0
    raw_rel = ((raw16 - raw32).abs()[live] / raw32[live]).cpu()
    above = (card32 > 1).cpu()
    rel_above = rel16[above] if bool(above.any()) else torch.zeros(1)
    log(f"[20] one parent's f32 sensitivities (TF32 off) on the card against "
        f"the CPU's: max relative error {rel_cpu:.3g} (<= rtol {SENS_RTOL}, "
        f"atol {SENS_ATOL}; the CPU took {cpu_s:.1f} s); bf16 products "
        f"against f32 (not gated), relative error after the clamp: median "
        f"{float(rel16.median()):.3g}, max {float(rel16.max()):.3g}; on the "
        f"{int(above.sum())} entries above the clamp: median "
        f"{float(rel_above.median()):.3g}, max {float(rel_above.max()):.3g}; "
        f"before the clamp, over the {int(live.sum())} nonzero entries: "
        f"median {float(raw_rel.median()):.3g}, max "
        f"{float(raw_rel.max()):.3g} ({card})")

    # one fused generation and one sweep under the profiler
    policy = m.policy_theta
    wall_ms, busy, rows = profile_call(lambda: eng.unpack_fused(
        ESEngine.fused_generation(eng, elites, elites.shape[0],
                                  m._selected_dev, m.it.noise_stdev(), seeds,
                                  pidx, idx_row, policy, 2,
                                  sens_idx=sens_idx)[0], L, 2))
    wall_s, busy_s, rows_s = profile_call(
        lambda: eng.sensitivities(parents, sens_idx, seed0))
    log(f"[20] one fused SM-G ES generation under torch.profiler: wall "
        f"{wall_ms:.3f} ms, card busy {busy:.3f} ms (idle "
        f"{1 - busy / wall_ms:.2%}); the sweep alone: wall {wall_s:.3f} ms, "
        f"card busy {busy_s:.3f} ms (idle {1 - busy_s / wall_s:.2%}), "
        f"{busy_s / busy:.2%} of the generation's card-busy time ({card})")
    for ms_k, count, key in rows[:8]:
        log(f"    {ms_k:10.3f} ms  x{count:<5d} {key[:90]}")
    log("[20] the sweep's kernels:")
    for ms_k, count, key in rows_s[:10]:
        log(f"    {ms_k:10.3f} ms  x{count:<5d} {key[:90]}")
    shutil.rmtree(runs_dir)
    log(f"[20] phase: {time.perf_counter() - t_phase:.1f} s")
    row = {k: k1_row[k] for k in ("route", "source", "replaces",
                                   "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
    row.update({
        "name": "decode_fused_es_smg_chunk16", "launches": launches,
        "k1_launches_per_generation": launches // SMG_ITERS,
        "times_from": k1_row["name"], "es_generation_ms": es_ms,
        "sweep_ms_split400": sweep_ms, "sweep_ms_split100": sweep100_ms,
        "sweep_ms_split400_one_parent_at_a_time": single_ms,
        "sweep_peak_gib": sweep_mem / 2**30,
        "sens_f32_max_rel_err_vs_cpu": rel_cpu,
        "sens_bf16_rel_err_median": float(rel16.median()),
        "sens_bf16_rel_err_max": float(rel16.max()),
        "sens_bf16_raw_rel_err_median": float(raw_rel.median()),
        "sens_bf16_raw_rel_err_max": float(raw_rel.max()),
        "fused_generation_idle_share": 1 - busy / wall_ms,
        "sweep_share_of_busy": busy_s / busy,
    })
    return [row]


def nes_smg_phase(card: str, task, seeds, batches, rows_11: list) -> list:
    """Phase 21: NESMaster on phase 10's cut of experiments/mscoco_nes.json
    (144 pairs, batch 128, pop_chunk 24, bf16, 256 validation images,
    kernel noise) with SM-G-SUM over the first 64 rows of member 0's batch
    at underflow 0.01:
    4 iterations in blocks of 2 (inline sensitivities, validation on the
    card) against 4 single generations, theta bit for bit, K5 and K6
    launched and K1, K2 and K7 not. Then on one generation's SM-G scale
    sigma / sens: K5 bitwise K2 fed K7's dump, and K6 bitwise the ordered
    f32 sum of K7's dumps. Returns K5's and K6's rows of the kernels line
    for this path, their times those of phase 11's ``rows_11``."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import (
        NESEngine,
        NESMaster,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_nes_smg_{os.getpid()}")
    t_phase = time.perf_counter()
    P, B, F = BENCH["pop_chunk"], BENCH["batch"], BENCH["pairs"]
    lay, T = task.decode_layout, task.model.options.seq_length
    counters = (dc.decode_fused, dc.decode_pair_perturb, dc.decode_pair_rng,
                dc.pair_grad_rng, dc.pair_delta_dump, dc.decode_rows)

    def experiment(name: str, gens_per_dispatch: int) -> dict:
        exp = load_experiment("experiments/mscoco_nes.json")
        exp["config"].update(batch_size=B, val_batch_size=256,
                             num_val_items=256, snapshot_freq=4)
        mo = exp["policy_options"]["model_options"]
        # underflow 0.01, mscoco_es_smg_fast.json's: a scale that varies
        mo.update(safe_mutations="SM-G-SUM", safe_mutation_underflow=0.01,
                  fc_feat_size=task.model.options.fc_feat_size)
        exp["nb_offspring"] = F
        exp["tpu"].update(pop_chunk=P, precision="bf16", delta_dtype="bf16",
                          gens_per_dispatch=gens_per_dispatch,
                          kernel_noise=True, sensitivity_batch=64)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    sweep = NESEngine.sensitivity
    masters = {}
    for name, gpd in (("block", 2), ("single", 1)):
        sweeps = []

        def counted(self, theta, idx_row, seed0, sweeps=sweeps):
            sweeps.append(min(len(idx_row), self._sens_batch))
            return sweep(self, theta, idx_row, seed0)

        m = NESMaster(experiment(name, gpd), device=dev, data=task.data)
        m.task.device_val_consts()
        NESEngine.sensitivity = counted
        try:
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            m.run_master(max_iterations=4)
            torch.cuda.synchronize()
        finally:
            NESEngine.sensitivity = sweep
        counts = [c.launches for c in counters]
        n_chunks = -(-F // P)
        rows_want = 4 if gpd > 1 else 0  # fused validation's row blocks
        if counts[:5] != [0, 0, 4 * n_chunks, 4, 0] or \
                counts[5] < rows_want or not m.engine.inline_sens:
            raise AssertionError(f"[21] {name}: launches (K1, K2, K5, K6, "
                                 f"K7, row-block K1) {counts}")
        if sweeps != [min(B, 64)] * 4 or m._val_fused != (gpd > 1):
            raise AssertionError(f"[21] {name}: sweeps {sweeps}, fused "
                                 f"validation {m._val_fused}")
        if not np.isfinite(m.stats.score_stats()[1]).all():
            raise AssertionError(f"[21] {name}: non-finite fitness")
        masters[name] = (m, counts)
        log(f"[21] NESMaster {name} (experiments/mscoco_nes.json at {F} "
            f"pairs, batch {B}, pop_chunk {P}, bf16, kernel noise, SM-G-SUM "
            f"over {min(B, 64)} rows at split {m.task._sens_split}, underflow "
            f"0.01, gens_per_dispatch "
            f"{gpd}): ms per iteration "
            f"{[round(t * 1e3, 3) for t in m.stats.time_stats()]}; "
            f"launches (K1, K2, K5, K6, K7, row-block K1) {counts}; "
            f"{len(sweeps)} sweeps ({card})")
    mb, ms_ = masters["block"][0], masters["single"][0]
    if not torch.equal(mb.theta, ms_.theta):
        raise AssertionError("[21] the SM-G block's theta differs from "
                             "per-generation steps")
    log("[21] theta after 4 SM-G generations: blocks of 2 with inline "
        "sensitivities bit for bit the 4 single generations")

    # the gates on one generation's SM-G scale
    eng, theta = mb.engine, mb.theta
    sens, sens_ms = events_ms(
        lambda: eng.sensitivity(theta, batches[0][0], int(seeds[0][0])))
    scale_dec = lay.to_dec(eng._scale_vec(theta, sens, BENCH["sigma"]),
                           pad_scale=0.0)
    scale_params = lay.prep(scale_dec, torch.float32)
    base = mb.task.pair_base_params(lay.to_dec(theta))
    seeds24 = seeds[0][:P]
    feats = mb.task.train_fc[torch.as_tensor(batches[0][:P], device=dev)]
    dump = dc.pair_delta_dump(scale_params, seeds24)
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    for dt in (torch.float32, torch.bfloat16):
        seq5, lp5 = dc.decode_pair_rng(base, scale_params, seeds24, feats, T,
                                       dt, True)
        seq2, lp2 = dc.decode_pair_perturb(base, dump, feats, T, dt, True)
        if not (torch.equal(seq5, seq2) and torch.equal(bits(lp5),
                                                        bits(lp2))):
            raise AssertionError(f"[21] K5 {dt} on the SM-G scale: not "
                                 "bitwise K2 fed K7's dump")
    n_chunks = -(-F // P)
    seeds_all = np.concatenate([seeds[0], seeds[0][-1:].repeat(
        n_chunks * P - F)])
    w_all = torch.as_tensor(np.random.default_rng(3).uniform(
        -1, 1, size=n_chunks * P).astype(np.float32), device=dev)
    w_all[F:] = 0.0
    grad6 = lay.flat_dec(dc.pair_grad_rng(scale_params, seeds_all, w_all))
    dumps = dc.pair_delta_dump_flat(lay.flat_dec(scale_params), seeds_all)
    ordered = torch.zeros_like(grad6)
    for i in range(seeds_all.shape[0]):
        ordered = ordered + w_all[i] * dumps[i]
    del dumps
    if not torch.equal(bits(grad6), bits(ordered)):
        raise AssertionError("[21] K6 on the SM-G scale: not bitwise the "
                             "ordered sum of K7's dumps")
    flat = lay.flat_dec(scale_params)
    live = flat[flat > 0]
    if not bool(live.max() > live.min()):
        raise AssertionError("[21] the SM-G scale is uniform: every "
                             "sensitivity is at the clamp")
    log(f"[21] on one generation's SM-G scale (sigma / sens; its sweep of "
        f"one theta {sens_ms:.3f} ms by CUDA events; scale from "
        f"{float(live.min()):.4g} to {float(live.max()):.4g}, "
        f"{(sens > 1).float().mean():.2%} of entries above the clamp): K5 "
        f"f32 and bf16 tokens and lp bitwise K2 fed K7's dump; K6 over "
        f"{seeds_all.shape[0]} lanes bitwise the ordered f32 sum of K7's "
        f"dumps ({card})")
    shutil.rmtree(runs_dir)
    log(f"[21] phase: {time.perf_counter() - t_phase:.1f} s")
    counts = masters["block"][1]
    out = []
    for name, launches in (("decode_pair_rng", counts[2]),
                           ("pair_grad_rng", counts[3])):
        (src,) = [r for r in rows_11 if r["name"] == name]
        row = {k: src[k] for k in ("route", "source", "replaces", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")}
        row.update({"name": f"{name}_smg", "launches": launches,
                    "times_from": name, "sweep_ms_one_theta": sens_ms,
                    "nes_iteration_ms": {
                        k: [t * 1e3 for t in v[0].stats.time_stats()]
                        for k, v in masters.items()}})
        out.append(row)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    lib, report = dc.build_kernels()
    log(f"[1] kernels built in {time.time() - t0:.1f} s: {lib.name}")
    for name, line in ptxas_lines(report):
        log(f"    ptxas {name}: {line}")
    for wdt, ddt in ((torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32),
                     (torch.float32, torch.bfloat16),
                     (torch.float32, torch.float32)):
        info = dc.pair_cluster_info(wdt, ddt)
        if info["max_active_clusters"] < BENCH["pop_chunk"]:
            raise AssertionError(f"pair kernel {info}: a chunk of "
                                 f"{BENCH['pop_chunk']} pairs is not resident")
        log(f"[1] pair kernel (K2, K5), weights {wdt}, delta {ddt}: clusters "
            f"of {info['cluster']} CTAs x {info['threads']} threads, "
            f"{info['smem_bytes']} B dynamic shared memory, "
            f"{info['ring_slots']} ring slots of {info['tile_rows']} k-rows; "
            f"cudaOccupancyMaxActiveClusters {info['max_active_clusters']}; "
            f"{info['cluster'] * BENCH['pop_chunk']} CTAs per launch at "
            f"{BENCH['pop_chunk']} pairs, all resident")
    for wdt, sampled in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True), (torch.float32, True)):
        info = dc.member_cluster_info(wdt, sampled)
        if info["max_active_clusters"] < 2 * BENCH["pop_chunk"]:
            raise AssertionError(f"member kernel {info}: a chunk of "
                                 f"{2 * BENCH['pop_chunk']} members is not "
                                 "resident")
        # K3: one cluster per member and lane (5 lanes per image)
        clusters = 2 * BENCH["pop_chunk"] * (5 if sampled else 1)
        log(f"[1] member kernel ({'K3' if sampled else 'K1, K4'}), weights "
            f"{wdt}: clusters of "
            f"{info['cluster']} CTAs x {info['threads']} threads, "
            f"{info['smem_bytes']} B dynamic shared memory, "
            f"{info['ring_slots']} ring slots of {info['tile_rows']} k-rows, "
            f"{info['tiles_in_flight']} in flight; "
            f"cudaOccupancyMaxActiveClusters {info['max_active_clusters']}; "
            f"{info['cluster'] * clusters} CTAs per launch at "
            f"{2 * BENCH['pop_chunk']} members"
            + (f" x 5 lanes, {clusters / info['max_active_clusters']:.2f} "
               "waves" if sampled else ", all resident"))

    # ---- the fixture, the task and one generation's inputs -----------------
    t0 = time.time()
    task = bench_task(dev)
    lay = task.decode_layout
    log(f"[1] fixture + task in {time.time() - t0:.1f} s: "
        f"{task.spec.num_params:,} params, vocab {task.data.vocab_size}, "
        f"padded {lay.Vpad}, {task.train_n} train images")

    P, B, T = BENCH["pop_chunk"], BENCH["batch"], task.model.options.seq_length
    Fd, Vpad = task.model.options.fc_feat_size, lay.Vpad
    gen = torch.Generator(device=dev).manual_seed(0)
    theta = task.generate_theta(gen)
    base_vec = lay.to_dec(theta)
    scale = lay.to_dec(torch.full_like(theta, BENCH["sigma"]), pad_scale=0.0)
    deltas = torch.stack([
        (scale * torch.randn(lay.dim_dec, generator=gen, device=dev)
         ).to(torch.bfloat16) for _ in range(P)])
    members = torch.stack([base_vec + deltas, base_vec - deltas],
                          1).reshape(2 * P, -1)
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, task.train_n, size=(P, B)), device=dev)
    feats2 = task.train_fc[idx.repeat_interleave(2, 0)]   # (2P, B, F)

    # ---- [2] K1 against its plain twin ------------------------------------
    k1 = {}
    for dt in (torch.float32, torch.bfloat16):
        params = lay.prep(members, dt)
        for need_lp in (True, False):
            seq_k, lp_k = dc.decode_fused(params, feats2, T, need_lp)
            seq_p, lp_p, gap_p = dc.decode_fused_plain(
                params, feats2, T, need_lp, top2_gap=True)
            torch.cuda.synchronize()
            if dt == torch.float32:
                if not torch.equal(seq_k, seq_p):
                    raise AssertionError(f"K1 f32 lp={need_lp}: tokens differ")
                err = float((lp_k - lp_p).abs().max())
                if err > 2e-5:
                    raise AssertionError(f"K1 f32: lp error {err:.3g} > 2e-5")
                k1.setdefault("max_abs_err", err)
                log(f"[2] K1 f32 need_logprobs={need_lp}: tokens equal, "
                    f"max |lp - plain| {err:.3g}")
            else:
                share, n_diff = check_near_ties(seq_k, seq_p, gap_p, "K1 bf16")
                log(f"[2] K1 bf16 need_logprobs={need_lp}: {share:.4%} of "
                    f"rows identical, {n_diff} rows differ, each first at a "
                    f"near-tie (top-2 gap < 1e-2)")
    n_tok = int((seq_k > 0).sum())
    log(f"[2] tokens sample (member 0, row 0): {seq_k[0, 0].tolist()}; "
        f"{n_tok} nonzero tokens in the chunk")

    # ---- [3] K2: equal to K1 on prep(base ± delta), held to its twin -------
    base = lay.prep(base_vec, torch.float32)
    dparams = lay.prep(deltas, torch.bfloat16)
    feats = task.train_fc[idx]
    k2 = {}
    for dt in (torch.float32, torch.bfloat16):
        seq2, lp2 = dc.decode_pair_perturb(base, dparams, feats, T, dt, True)
        seq1, lp1 = dc.decode_fused(lay.prep(members, dt), feats2, T, True)
        # tokens bit for bit: every logit is K1's product in K1's order; lp
        # within 2e-5: the two column halves of a sign's cluster each sum
        # exp over their own columns and then merge, so the log-sum-exp
        # adds in another order than K1's
        lp_k1 = float((lp2.reshape(2 * P, B, T) - lp1).abs().max())
        if not torch.equal(seq2.reshape(2 * P, B, T), seq1) or lp_k1 > 2e-5:
            raise AssertionError(f"K2 {dt}: tokens not bitwise K1's on "
                                 f"prep(base ± delta), or lp {lp_k1:.3g} "
                                 "from K1's > 2e-5")
        seq_p, lp_p, gap_p = dc.decode_fused_plain(
            lay.prep(members, dt), feats2, T, True, top2_gap=True)
        if dt == torch.float32:
            if not torch.equal(seq2.reshape(2 * P, B, T), seq_p):
                raise AssertionError("K2 f32: tokens differ from the plain twin")
            err = float((lp2.reshape(2 * P, B, T) - lp_p).abs().max())
            if err > 2e-5:
                raise AssertionError(f"K2 f32: lp error {err:.3g} > 2e-5")
            k2["max_abs_err"] = err
            log(f"[3] K2 f32, bf16 delta: tokens bitwise K1's, max |lp - K1 "
                f"lp| {lp_k1:.3g}; tokens equal the plain twin, max |lp - "
                f"plain| {err:.3g}")
        else:
            share, n_diff = check_near_ties(seq2.reshape(2 * P, B, T), seq_p,
                                            gap_p, "K2 bf16")
            log(f"[3] K2 bf16, bf16 delta: tokens bitwise K1's, max |lp - "
                f"K1 lp| {lp_k1:.3g}; {share:.4%} of rows identical to the "
                f"plain twin, {n_diff} differ at near-ties")

    # ---- [4] whole generations through both eval paths ----------------------
    F = BENCH["pairs"]
    seeds, batches = generation_inputs(task, BENCH["gens"])
    sens = torch.ones_like(theta)
    runs = {}
    for path, kp in (("pair kernel", True), ("per-member", False)):
        eng = NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                        pop_chunk=P, kernel_perturb=kp, delta_dtype="bf16")
        th, state = theta.clone(), eng.optimizer.init(eng.dim, dev)
        # one untimed generation first: a path's first call also pays
        # one-time costs (lazy loading of torch's kernels, library handles)
        eng.generation(th, state, sens, BENCH["sigma"], seeds[0], batches[0],
                       BENCH["stepsize"], BENCH["l2coeff"])
        packs, times = [], []
        torch.cuda.synchronize()
        dc.decode_fused.launches = dc.decode_pair_perturb.launches = 0
        for g in range(BENCH["gens"]):
            t0 = time.perf_counter()
            th, state, packed = eng.generation(
                th, state, sens, BENCH["sigma"], seeds[g], batches[g],
                BENCH["stepsize"], BENCH["l2coeff"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            packs.append(packed)
        counts = (dc.decode_fused.launches, dc.decode_pair_perturb.launches)
        runs[path] = (th, torch.stack(packs), times, counts, eng)
        fits = eng.unpack(packs[-1], F)[0]
        log(f"[4] {path}: {BENCH['gens']} generations, ms each "
            f"{[round(t * 1e3, 3) for t in times]}, median "
            f"{np.median(times) * 1e3:.3f} ms; launches K1 {counts[0]}, "
            f"K2 {counts[1]}; last mean fitness {fits.mean():.6f} "
            f"({card})")
    (th_a, packs_a, _, counts_a, eng), (th_b, packs_b, _, counts_b, _) = \
        runs["pair kernel"][:5], runs["per-member"][:5]
    n_chunks = eng._plan(F)[0]
    want = n_chunks * BENCH["gens"]
    if counts_a != (0, want) or counts_b != (want, 0):
        raise AssertionError(f"launch counts {counts_a} / {counts_b}: "
                             f"expected K2 x{want} then K1 x{want}")
    if not torch.equal(packs_a, packs_b) or not torch.equal(th_a, th_b):
        raise AssertionError("pair-kernel and per-member generations differ")
    if not torch.isfinite(packs_a).all():
        raise AssertionError("non-finite fitness")
    if torch.equal(th_a, theta):
        raise AssertionError("theta did not change")
    log(f"[4] packed vectors and theta bitwise equal across the paths; "
        f"fitnesses finite; |theta' - theta| max "
        f"{float((th_a - theta).abs().max()):.3g}")

    # ---- [5] times at the main path's shapes --------------------------------
    params16 = lay.prep(members, torch.bfloat16)
    k1_ms = time_ms(lambda: dc.decode_fused(params16, feats2, T, False))
    k1_plain = time_ms(lambda: dc.decode_fused_plain(params16, feats2, T,
                                                     False), reps=3)
    k2_ms = time_ms(lambda: dc.decode_pair_perturb(
        base, dparams, feats, T, torch.bfloat16, False))
    k2_plain = time_ms(lambda: dc.decode_pair_perturb_plain(
        base, dparams, feats, T, torch.bfloat16, False), reps=3)
    # K1 and K2 at Vpad 1920 beside 9600 (K2: a pair runs until both signs'
    # rows finish)
    base_n, dparams_n = narrow_vocab(base, 0), narrow_vocab(dparams, 1)
    params16_n = narrow_vocab(params16, 1)
    per_step = {}
    for name, ms, run_full, run_cut, rows in (
            ("K1", k1_ms,
             lambda: dc.decode_fused(params16, feats2, T, False),
             lambda: dc.decode_fused(params16_n, feats2, T, False), B),
            ("K2", k2_ms,
             lambda: dc.decode_pair_perturb(base, dparams, feats, T,
                                            torch.bfloat16, False),
             lambda: dc.decode_pair_perturb(base_n, dparams_n, feats, T,
                                            torch.bfloat16, False), 2 * B)):
        cut_ms = time_ms(run_cut)
        steps = [int(executed_steps(fn()[0].reshape(-1, rows, T), T).max())
                 for fn in (run_full, run_cut)]
        per_step[name] = step_costs(ms, cut_ms, steps, Vpad)
        log_step_costs("[5]", name, ms, cut_ms, steps, Vpad, per_step[name],
                       card)
    del base_n, dparams_n, params16_n

    def library():
        # cuBLAS for the decode's products (bf16 in, f32 out) and argmax:
        # image step, 17 x gate products, 16 x logits + argmax
        x0 = torch.bmm(feats2.to(torch.bfloat16), params16["img_w"])
        h = x0.to(torch.bfloat16)
        for step in range(T + 1):
            torch.bmm(h, params16["i2h_w"])
            torch.bmm(h, params16["h2h_w"])
            if step:
                torch.bmm(h, params16["logit_w"]).argmax(-1)

    lib_ms = time_ms(library)
    seq16, _ = dc.decode_fused(params16, feats2, T, False)
    flops = decode_flops(executed_steps(seq16, T), B, Fd, Vpad)
    k1_bytes = sum(v.numel() * v.element_size() for v in params16.values()) \
        + feats2.numel() * 2 + seq16.numel() * 8
    k2_bytes = sum(v.numel() * v.element_size() for v in base.values()) \
        + sum(v.numel() * v.element_size() for v in dparams.values()) \
        + feats.numel() * 2 + seq16.numel() * 8
    # the member kernel's own floor: a chunk's weights do not fit L2, so
    # each member's gate weights cross from HBM on every LSTM step and its
    # logit_w on every token step (img_w once)
    nb = {k: v[0].numel() * v.element_size() for k, v in params16.items()}
    member_steps = executed_steps(seq16, T).double()
    k1_floor = float((nb["img_w"] + (member_steps + 1) * (nb["i2h_w"]
                      + nb["h2h_w"]) + member_steps * nb["logit_w"]).sum()
                     ) / HBM_BYTES_PER_S * 1e3

    def bound(nbytes):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                            else "operations")

    kernels = []
    pair_ctas = dc.pair_cluster_info()["cluster"] * P
    member_ctas = dc.member_cluster_info()["cluster"] * 2 * P
    for name, replaces, ms, plain, nbytes, err, launches, ctas in (
        ("decode_fused", "nes_img_captioning_tpu/ops/decode_pallas.py:658",
         k1_ms, k1_plain, k1_bytes, k1["max_abs_err"], counts_b[0],
         member_ctas),
        ("decode_pair_perturb",
         "nes_img_captioning_tpu/ops/decode_pallas.py:325",
         k2_ms, k2_plain, k2_bytes, k2["max_abs_err"], counts_a[1],
         pair_ctas),
    ):
        b_ms, b_by = bound(nbytes)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "ctas_per_launch": ctas,
        })
        if name == "decode_fused":
            kernels[-1]["us_fixed_per_step"], \
                kernels[-1]["us_per_step_and_vocab_tile"] = per_step["K1"]
            log(f"[5] decode_fused's design floor: the chunk's weights re-read "
                f"from HBM on every step, {k1_floor:.4f} ms ({card})")
        log(f"[5] {name}: {ms:.3f} ms per launch of {2 * P} rollouts, "
            f"{ctas} CTAs "
            f"(plain twin {plain:.3f} ms, cuBLAS products {lib_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}; {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB) ({card})")

    # where one pair-kernel generation spends the card's time
    eng = runs["pair kernel"][4]
    wall_ms, busy, rows = profile_generation(eng, theta, sens, seeds[0],
                                             batches[0])
    log(f"[5] one generation under torch.profiler: wall {wall_ms:.3f} ms, "
        f"card busy {busy:.3f} ms ({busy / wall_ms:.2%}; idle "
        f"{1 - busy / wall_ms:.2%}), kernel time summed over streams "
        f"{sum(r[0] for r in rows):.3f} ms ({card})")
    for ms, count, key in rows[:12]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")

    # ---- [6] K7: the card's noise stream against the plain one -------------
    seeds24 = seeds[0][:P]
    scale_params = lay.prep(scale, torch.float32)
    words = dc.philox_words(int(seeds24[0]), lay.dim_dec // 2 + 1, dev)
    if not torch.equal(words, dc.philox_words(int(seeds24[0]),
                                              lay.dim_dec // 2 + 1, "cpu")
                       .to(dev)):
        raise AssertionError("K7: the card's Philox words differ")
    if dc.philox_words(0, 1, dev)[0].tolist() != [
            0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]:
        raise AssertionError("K7: Philox known-answer vector differs")
    dump = dc.pair_delta_dump(scale_params, seeds24)
    dump_flat = torch.stack([lay.flat_dec({k: v[p] for k, v in dump.items()})
                             for p in range(P)])
    flat_scale = lay.flat_dec(scale_params)
    plain_flat = torch.stack([
        lay.flat_dec(dc.pair_delta_dump_plain(scale_params, int(sd)))
        for sd in seeds24])
    torch.cuda.synchronize()
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    k7_err = float((dump_flat - plain_flat).abs().max())
    # on the card the plain version runs torch's CUDA log, sqrt and cos,
    # which are the library calls the kernel's narrowed forms equal ([6b]):
    # bit for bit, the sign of every zero included
    if not torch.equal(bits(dump_flat), bits(plain_flat)):
        raise AssertionError(f"K7: not bitwise the plain version on the card "
                             f"(max |delta - plain| {k7_err:.3g})")
    if not torch.equal(bits(dc.pair_delta_dump_flat(flat_scale, seeds24)),
                       bits(dump_flat)):
        raise AssertionError("K7: the flat entry differs from the dict form")
    # the plain version on the CPU runs the CPU's log and cos, each within
    # 1-2 ulp of the exact result as the card's are; |n| < 6, where 8 ulps
    # are 8 * 4.77e-7
    cpu_flat = dc.pair_delta_dump_flat(flat_scale.cpu(), int(seeds24[0]))
    cpu_err = float((dump_flat[0].cpu() - cpu_flat).abs().max())
    k7_tol = 8 * 4.77e-7 * BENCH["sigma"]
    if cpu_err > k7_tol:
        raise AssertionError(f"K7: |delta - plain on the CPU| {cpu_err:.3g} "
                             f"> {k7_tol:.3g}")
    if (dump_flat[:, scale == 0] != 0).any():
        raise AssertionError("K7: a pad lane drew noise")
    cpu_same = float((dump_flat[0].cpu() == cpu_flat).float().mean())
    log(f"[6] K7 pair_delta_dump, {P} seeds x {lay.dim_dec:,}: Philox words "
        f"bitwise equal to the plain stream (known answer too); deltas "
        f"bitwise equal to the plain version on the card, and the flat entry "
        f"to the dict form; seed 0 against the plain version on the CPU: max "
        f"|delta - plain| {cpu_err:.3g} (<= {k7_tol:.3g}: 8 ulps), "
        f"{cpu_same:.4%} bitwise equal; pad lanes 0")

    # ---- [6b] the Box-Muller functions against the library -------------------
    table = dc.box_muller_table(dev)
    torch.cuda.synchronize()
    for r, name in enumerate(("logf(1 - u)", "sqrtf(-2 logf(1 - u))",
                              "cosf(f32(2 pi) u)")):
        differ = int((bits(table[r, 0]) != bits(table[r, 1])).sum())
        if differ:
            raise AssertionError(f"[6b] {name}: the narrowed form differs "
                                 f"from the library call at {differ} of the "
                                 f"2^23 inputs")
        log(f"[6b] {name}: the narrowed form equals the library call bit for "
            f"bit on all {table.shape[-1]:,} inputs")
    del table

    # ---- [7] K5: bitwise K2 fed K7's dump, held to its plain version --------
    k5 = {}
    for dt in (torch.float32, torch.bfloat16):
        seq5, lp5 = dc.decode_pair_rng(base, scale_params, seeds24, feats, T,
                                       dt, True)
        seq2, lp2 = dc.decode_pair_perturb(base, dump, feats, T, dt, True)
        if not (torch.equal(seq5, seq2) and torch.equal(lp5, lp2)):
            raise AssertionError(f"K5 {dt}: not bitwise equal to K2 fed "
                                 "K7's dump")
        pert = torch.stack([base_vec + plain_flat, base_vec - plain_flat],
                           1).reshape(2 * P, -1)
        seq_p, lp_p, gap_p = dc.decode_fused_plain(
            lay.prep(pert, dt), feats2, T, True, top2_gap=True)
        share, n_diff = check_near_ties(seq5.reshape(2 * P, B, T), seq_p,
                                        gap_p, f"K5 {dt}")
        if dt == torch.float32:
            ok = (seq5.reshape(2 * P, B, T) == seq_p).all(-1)
            k5["max_abs_err"] = float(
                (lp5.reshape(2 * P, B, T) - lp_p).abs()[ok].max())
        log(f"[7] K5 decode_pair_rng {dt}: tokens and lp bitwise equal to "
            f"K2 fed K7's dump; {share:.4%} of rows identical to the plain "
            f"version, {n_diff} differ at near-ties"
            + (f"; max |lp - plain| {k5['max_abs_err']:.3g} on identical "
               "rows" if dt == torch.float32 else ""))

    # ---- [8] K6: bitwise the ordered sum of K7's dumps ---------------------
    F = BENCH["pairs"]
    n_chunks = -(-F // P)
    seeds_all = np.concatenate([seeds[0], seeds[0][-1:].repeat(
        n_chunks * P - F)])
    w_all = torch.as_tensor(np.random.default_rng(1).uniform(
        -1, 1, size=n_chunks * P).astype(np.float32), device=dev)
    w_all[F:] = 0.0
    grad6 = lay.flat_dec(dc.pair_grad_rng(scale_params, seeds_all, w_all))
    dumps = dc.pair_delta_dump_flat(flat_scale, seeds_all)
    ordered = torch.zeros_like(grad6)
    for i in range(seeds_all.shape[0]):
        ordered = ordered + w_all[i] * dumps[i]
    del dumps
    if not torch.equal(bits(grad6), bits(ordered)):
        raise AssertionError("K6: not bitwise the ordered sum of K7's dumps")
    grad6_plain = lay.flat_dec(dc.pair_grad_rng_plain(scale_params,
                                                      seeds_all, w_all))
    torch.cuda.synchronize()
    k6_err = float((grad6 - grad6_plain).abs().max())
    if not torch.equal(bits(grad6), bits(grad6_plain)):
        raise AssertionError(f"K6: not bitwise the plain version on the card "
                             f"(max |grad - plain| {k6_err:.3g})")
    log(f"[8] K6 pair_grad_rng over {seeds_all.shape[0]} lanes: bitwise the "
        f"ordered f32 sum of K7's dumps and the plain version on the card")

    # ---- [9] the kernel-noise generation -----------------------------------
    eng_n = noise_engine(task)
    th, state = theta.clone(), eng_n.optimizer.init(eng_n.dim, dev)
    eng_n.generation(th, state, sens, BENCH["sigma"], seeds[0], batches[0],
                     BENCH["stepsize"], BENCH["l2coeff"])  # warm-up
    torch.cuda.synchronize()
    counters = (dc.decode_fused, dc.decode_pair_perturb, dc.decode_pair_rng,
                dc.pair_grad_rng, dc.pair_delta_dump)
    for c in counters:
        c.launches = 0
    times_n, packs_n = [], []
    for g in range(BENCH["gens"]):
        t0 = time.perf_counter()
        th, state, packed = eng_n.generation(
            th, state, sens, BENCH["sigma"], seeds[g], batches[g],
            BENCH["stepsize"], BENCH["l2coeff"])
        torch.cuda.synchronize()
        times_n.append(time.perf_counter() - t0)
        packs_n.append(packed)
    counts_n = tuple(c.launches for c in counters)
    want_n = (0, 0, n_chunks * BENCH["gens"], BENCH["gens"], 0)
    if counts_n != want_n:
        raise AssertionError(f"kernel-noise launches (K1, K2, K5, K6, K7) "
                             f"{counts_n} != {want_n}")
    if not torch.isfinite(torch.stack(packs_n)).all():
        raise AssertionError("kernel-noise generation: non-finite output")
    med_pair = np.median(runs["pair kernel"][2]) * 1e3
    log(f"[9] kernel-noise path: {BENCH['gens']} generations, ms each "
        f"{[round(t * 1e3, 3) for t in times_n]}, median "
        f"{np.median(times_n) * 1e3:.3f} ms (delta-operand pair-kernel path "
        f"in [4]: median {med_pair:.3f} ms); launches K5 {counts_n[2]}, "
        f"K6 {counts_n[3]}, K7 0, K1 0, K2 0 ({card})")
    # eval and gradient see the noise K7 dumps: the delta-operand path fed
    # the dumps gives the same generation bit for bit
    for c in counters:
        c.launches = 0
    eng_d = NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                      pop_chunk=P, kernel_perturb=True, delta_dtype="f32")
    eng_d.delta_of = lambda scale_dec, seed: lay.flat_dec(
        dc.pair_delta_dump(lay.prep(scale_dec, torch.float32), seed))
    outs = [e.generation(theta, e.optimizer.init(e.dim, dev), sens,
                         BENCH["sigma"], seeds[0], batches[0],
                         BENCH["stepsize"], BENCH["l2coeff"])
            for e in (eng_n, eng_d)]
    torch.cuda.synchronize()
    check_counts = tuple(c.launches for c in counters)
    if not (torch.equal(outs[0][2], outs[1][2])
            and torch.equal(outs[0][0], outs[1][0])):
        raise AssertionError("kernel-noise and delta-operand (K7 dumps) "
                             "generations differ")
    log(f"[9] kernel-noise generation bitwise equal to the delta-operand "
        f"generation fed K7's dumps (launches K1, K2, K5, K6, K7: "
        f"{check_counts})")
    wall_n, busy_n, rows_n = profile_generation(eng_n, theta, sens,
                                                seeds[0], batches[0])
    names = [key for _, _, key in rows_n]
    if any("normal" in key.lower() for key in names):
        raise AssertionError("kernel-noise generation ran a normal_ kernel")
    log(f"[9] one kernel-noise generation under torch.profiler: wall "
        f"{wall_n:.3f} ms, card busy {busy_n:.3f} ms ({busy_n / wall_n:.2%};"
        f" idle {1 - busy_n / wall_n:.2%}); no normal_ kernel ({card})")
    for ms, count, key in rows_n[:12]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")

    # ---- [10] NESMaster: train, validate, snapshot, resume -------------------
    import glob
    import shutil

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    data = task.data
    runs_dir = os.path.join("logs", f"chip_smoke_{os.getpid()}")

    def experiment(name: str) -> dict:
        exp = load_experiment("experiments/mscoco_nes.json")
        exp["config"].update(batch_size=B, val_batch_size=256,
                             num_val_items=256, snapshot_freq=2)
        exp["policy_options"]["model_options"]["fc_feat_size"] = Fd
        exp["nb_offspring"] = F
        exp["tpu"].update(pop_chunk=P, precision="bf16", delta_dtype="bf16",
                          gens_per_dispatch=2, kernel_noise=True)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    for c in (*counters, dc.decode_rows):
        c.launches = 0
    t0 = time.perf_counter()
    master = NESMaster(experiment("train"), device=dev, data=data)
    master.run_master(max_iterations=4)
    torch.cuda.synchronize()
    counts_m = tuple(c.launches for c in counters)
    rows_m = dc.decode_rows.launches
    t_master = time.perf_counter() - t0
    acc = master.stats.acc_stats()
    if master.it.iteration() != 4 or len(acc) != 4 or \
            not np.isfinite(master.stats.score_stats()[1]).all():
        raise AssertionError("NESMaster: 4 finite iterations with "
                             "validation expected")
    if not master._val_fused or counts_m != (0, 0, 4 * n_chunks, 4, 0) \
            or rows_m != 4:
        raise AssertionError(f"NESMaster launches (K1, K2, K5, K6, K7) "
                             f"{counts_m}, row-block K1 {rows_m}, fused "
                             f"validation {master._val_fused}")
    zinfo = glob.glob(os.path.join(runs_dir, "train", "snapshot",
                                   "z_info_*.json"))
    if len(zinfo) != 1 or not zinfo[0].endswith(
            f"_i4-{task.train_n // B}.json"):
        raise AssertionError(f"NESMaster snapshot: {zinfo}")
    log(f"[10] NESMaster (experiments/mscoco_nes.json at 144 pairs, batch "
        f"128, pop_chunk 24, bf16, kernel_noise): 4 iterations in "
        f"{t_master:.1f} s; validation CIDEr {[round(a, 4) for a in acc]}; "
        f"mean fitness {[round(m, 4) for m in master.stats.score_stats()[1]]}"
        f"; ms per iteration (generation + validation) "
        f"{[round(t * 1e3, 3) for t in master.stats.time_stats()]}"
        f"; fused validation, row-block K1 launches {rows_m} (one per "
        f"generation), K5 {counts_m[2]}, K6 {counts_m[3]}, K1 0, K2 0, K7 0; "
        f"snapshot {os.path.basename(zinfo[0])}")
    exp2 = experiment("resume")
    exp2["from_infos"] = zinfo[0]
    resumed = NESMaster(exp2, device=dev, data=data)
    if not torch.equal(resumed.theta, master.theta) or \
            int(resumed.opt_state.t) != 4 or \
            resumed._pending_loader_state is None:
        raise AssertionError("resume: theta, optimizer step or loader "
                             "state not restored")
    # as in the JAX package, a resumed run labels its first generation with
    # the snapshot's iteration (z_info counters are stored post-increment)
    resumed.run_master(max_iterations=4)
    if len(resumed.stats.acc_stats()) != 5 \
            or torch.equal(resumed.theta, master.theta):
        raise AssertionError("resume: one more generation expected")
    log(f"[10] resumed from {os.path.basename(zinfo[0])}: theta, Adam step "
        f"4 and the seed and batch streams restored; one more generation "
        f"trained and validated (CIDEr "
        f"{resumed.stats.acc_stats()[-1]:.4f})")
    shutil.rmtree(runs_dir)

    # ---- [11] K5-K7 times at the main path's shapes --------------------------
    k5_ms = time_ms(lambda: dc.decode_pair_rng(
        base, scale_params, seeds24, feats, T, torch.bfloat16, False))
    k5_plain = time_ms(lambda: dc.decode_pair_rng_plain(
        base, scale_params, seeds24, feats, T, torch.bfloat16, False), reps=2)
    # K5's two launches apart: K2 on K7's f32 dump (the decode K5 runs
    # after its draw), and K1 again as this run's anchor
    k2_dump_ms = time_ms(lambda: dc.decode_pair_perturb(
        base, dump, feats, T, torch.bfloat16, False))
    k1_again = time_ms(lambda: dc.decode_fused(params16, feats2, T, False))
    # K7 alone: the flat entry is the launch, and K5's draw is the same
    # launch on the same seeds; the dict wrapper adds the copies into the
    # nine tensors
    k7_ms = time_ms(lambda: dc.pair_delta_dump_flat(flat_scale, seeds24),
                    reps=20)
    k7_dict_ms = time_ms(lambda: dc.pair_delta_dump(scale_params, seeds24),
                         reps=20)
    # a rate reference only: torch's own normals (Philox4x32-10 and
    # Box-Muller too, but another stream and arithmetic), the same count
    randn_ms = time_ms(lambda: torch.randn((P, lay.dim_dec), device=dev),
                       reps=20)
    k7_plain = time_ms(lambda: dc.pair_delta_dump_plain(scale_params,
                                                        seeds24), reps=2)
    k6_ms = time_ms(lambda: dc.pair_grad_rng(scale_params, seeds_all, w_all),
                    reps=10)
    k6_plain = time_ms(lambda: dc.pair_grad_rng_plain(scale_params,
                                                      seeds_all, w_all),
                       reps=1)
    # the delta-operand path doing the same work: seeded torch.randn per
    # pair times the scale (K7), and that regeneration plus the ordered
    # weighted sum of the engine's gradient (K6)
    eng_f = NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                      pop_chunk=P, kernel_perturb=True, delta_dtype="f32")
    k7_delta = time_ms(lambda: eng_f._deltas(scale, seeds24), reps=3)
    w_l = w_all.reshape(n_chunks, P)
    seeds_l = seeds_all.reshape(n_chunks, P)

    def delta_grad():
        g = torch.zeros_like(scale)
        for c in range(n_chunks):
            g = eng_f._accumulate(g, w_l[c], eng_f._deltas(scale, seeds_l[c]))
        return g

    k6_delta = time_ms(delta_grad, reps=3)
    seq5, _ = dc.decode_pair_rng(base, scale_params, seeds24, feats, T,
                                 torch.bfloat16, False)
    flops5 = decode_flops(executed_steps(seq5.reshape(2 * P, B, T), T), B,
                          Fd, Vpad)
    f32_bytes = lay.dim_dec * 4
    k5_bytes = 2 * f32_bytes + feats.numel() * 2 + seq5.numel() * 8
    k7_bytes = f32_bytes + P * f32_bytes + P * 4
    k6_bytes = 2 * f32_bytes + seeds_all.shape[0] * 8
    # the bound: bytes read and written once, and the operations: K5's
    # products on the tensor cores, and per normal NORMAL_INT_OPS integer
    # and NORMAL_F32_OPS f32 operations (K6 also its weighted sum's
    # GRAD_SUM_OPS), each type at its own rate
    n5 = n7 = P * lay.dim_dec
    n6 = seeds_all.shape[0] * lay.dim_dec
    for name, replaces, ms, plain, nbytes, flops, f32_ops, normals, err, \
            launches, lib, dpath in (
        ("decode_pair_rng", "nes_img_captioning_tpu/ops/decode_pallas.py:488",
         k5_ms, k5_plain, k5_bytes, flops5, NORMAL_F32_OPS, n5,
         k5["max_abs_err"], counts_m[2], lib_ms, None),
        ("pair_grad_rng", "nes_img_captioning_tpu/ops/decode_pallas.py:587",
         k6_ms, k6_plain, k6_bytes, 0.0, NORMAL_F32_OPS + GRAD_SUM_OPS, n6,
         k6_err, counts_m[3], None, k6_delta),
        ("pair_delta_dump", "nes_img_captioning_tpu/ops/decode_pallas.py:533",
         k7_ms, k7_plain, k7_bytes, 0.0, NORMAL_F32_OPS, n7, k7_err,
         check_counts[4], None, k7_delta),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_int = NORMAL_INT_OPS * normals / PEAK_INT32
        t_f32 = f32_ops * normals / PEAK_F32
        t_ops = max(flops / PEAK_BF16, t_int, t_f32)
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "delta_path_ms": dpath,
            "normals_per_s": normals / (ms * 1e-3)})
        if name == "decode_pair_rng":
            kernels[-1]["ctas_per_launch"] = pair_ctas
        if name == "pair_delta_dump":
            kernels[-1]["dict_wrapper_ms"] = k7_dict_ms
            kernels[-1]["randn_ms_not_same_stream"] = randn_ms
        log(f"[11] {name}: {ms:.3f} ms per launch (plain {plain:.3f} ms, "
            + (f"cuBLAS products {lib:.3f} ms, " if lib is not None else
               f"delta-operand path {dpath:.3f} ms, ")
            + f"bound {b_ms:.4f} ms by {b_by}: bytes {t_bytes * 1e3:.4f}, "
            f"operations {t_ops * 1e3:.4f} ms (integer {t_int * 1e3:.4f}, "
            f"f32 {t_f32 * 1e3:.4f}), {b_ms / ms:.1%} of it; "
            f"{normals:,} normals, {normals / (ms * 1e-3):.4g} per s; "
            f"{nbytes / 1e6:.1f} MB) ({card})")
    log(f"[11] K7 alone (pair_delta_dump_flat, = K5's draw) {k7_ms:.3f} ms; "
        f"its dict wrapper pair_delta_dump {k7_dict_ms:.3f} ms (the copies "
        f"into nine tensors); reference only, not the same stream: one "
        f"torch.randn of the same {n7:,} normals {randn_ms:.3f} ms, "
        f"{n7 / (randn_ms * 1e-3):.4g} per s ({card})")

    log(f"[11] K5 {k5_ms:.3f} ms = its draw (K7 alone {k7_ms:.3f} ms) + the "
        f"pair decode on an f32 delta (K2 fed K7's dump {k2_dump_ms:.3f} ms; "
        f"on the bf16 delta in [5] {k2_ms:.3f} ms); {pair_ctas} CTAs per "
        f"decode launch; K1 anchor {k1_again:.3f} ms here, {k1_ms:.3f} ms in "
        f"[5] ({card})")
    kernels += sampling_phases(task, theta, members, feats2, seeds, batches,
                               sens, lib_ms, card)
    data = val_fixture()
    kernels += validation_phase(card, data)
    kernels += es_phase(card, data)
    kernels += es_smg_phase(card, data, kernels[-1])
    kernels += nes_smg_phase(card, task, seeds, batches, kernels)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
    sum of K7's dumps;
22. MnistTask at real MNIST's split sizes (synthetic 60000 / 10000, 5000
    val images), vbn off and on, with TF32 on in the process: 100 members
    x 64 images on the card within 1e-5 of the CPU (logits, fitness),
    validate_device equal to validate, a member's fitness the same bits in
    chunks of 100 and of 3 at other places;
23. experiments/mnist_nes.json through NESMaster (as it is; and with
    patience 0 in blocks of 4 with validation on the card, bit for bit the
    single generations) and experiments/mnist_es.json through ESMaster on
    the plain, fused and blocked paths with SM-G-SUM (bit for bit, no host
    sync inside a fused generation or a block, no decode kernel); ms per
    NES iteration and ES generation and the SM-G sweeps' ms. No kernel of
    the repo lies on this path: its products are cuDNN's convolutions and
    a cuBLAS batched product, so the kernels line below is that of the
    captioning paths;
24. experiments/mscoco_nes.json with tpu.device_cider false (host-scored),
    cut as in 10 (bf16): NESMaster 3 iterations greedy and 2
    self_critical, K1 launched once per chunk of 48 torch-order members
    (to_dec + prep; K3 and the K1 baselines for self_critical), host
    validation; one generation taken apart (eval sweep, token pull, host
    CIDEr-D and the share of rows _score_dedup scored, update) and under
    torch.profiler; the update with the carried deltas bitwise the one
    that draws them again; the sweep's first chunk K1's launch on
    prepare_decode_params' layout, held to its plain twin up to
    near-ties; host and device CIDEr-D within 1e-4 on the same tokens;
25. experiments/mscoco_es.json with tpu.device_cider false at its own size
    (1000 offspring, batch 256, 5000 val images): 2 generations on the
    plain path (the fused path resolves off), ms per generation and the
    host scoring's share;
26. the vbn, vbn_e and layer_n captioners on the eager decoder
    (mscoco_nes.json cut as in 10, f32): NESMaster 2 iterations each with
    device scoring (validation on the card), one vbn iteration scored on
    the host and one with SM-G-SUM over 64 rows, no decode kernel
    launched; one chunk of 48 vbn members on the card against the CPU
    (tokens equal but where a member first differs at a near-tie, lp
    within 1e-4 on the members that agree); one vbn generation under
    torch.profiler. These three phases add no kernel: K1, K3 and K4 run
    on their existing rows' launch shapes, and their counts are logged;
27. XENT pretraining at full width on [18]'s fixture (2048 train images,
    TF32 off): xent_loss and its gradient on the card against the CPU;
    pretrain_xent for 1500 steps (half the CLI's 3000; batch 64, lr 5e-4),
    ms per step, the train split's loss and the val CIDEr before and after
    (both must improve), one step under torch.profiler; the result saved
    with spec.save_pth and loaded by an NESMaster's from_single ([10]'s
    cut, 2 iterations): bit for bit the saved theta, validating at its
    CIDEr; the trained regime beside random init (rows that emit EOS, K1's
    executed steps, _score_dedup's share);
28. evaluate_checkpoints on the random-init and XENT checkpoints over the
    fixture's 5000 test images at f32 (one row-block launch of K1 each),
    that launch held to its plain twin (tokens but at near-ties; lp from
    an f64 replay within twice the twin's distance + 2e-5), its time
    beside its plain twin, cuBLAS and its bound, each language metric's
    seconds; test_score of the bf16 task equal to language_eval's CIDEr on
    its tokens;
29. in a process of its own, [10]'s NESMaster with tpu.profile for 3
    iterations: the trace of the block holding generation 2 under
    <log_dir>/profile/, read by utils/profile_summary, which lists K5, K6
    and the row-block K1 as often as the launch counters say, with no
    launch missing its kernel's record; its idle share;
30. dump_all_sensitivities (SM-G-SUM, split 400, f32) on the XENT theta
    over 4 batches of 64 rows: each file bit for bit calc_sensitivity's,
    and the share of entries above the clamp beside random init's;
31. experiments/mscoco_es.json and mscoco_es_smg_fast.json with
    tpu.es_decode_layout true (children built in decode order) on the
    plain, fused and blocked paths, 4 generations each: the paths bit for
    bit, the layout sweep bit for bit task.rollout of its children mapped
    back by from_dec, K1 126 times per generation and to_dec of an
    offspring chunk in generation 1 only; a fused generation's ms and copy
    kernels with the layout on and off; K1 on decode-ordered children
    against its plain twin;
32. [10]'s NESMaster and [31]'s mscoco_es.json runs as two ranks sharing
    the card over gloo (child processes, ``--rank-phase``), then NES as one
    rank over NCCL: the ranks in lockstep bit for bit, the artifacts in
    rank 0's directories only, NES generation 1's fitnesses bit for bit
    one process's and its theta Adam's step on the rank-order sum of the
    ranks' K6 partials (within the sum-order bound of one process's
    gradient), ES bit for bit [31]'s runs, the NCCL rank bit for bit one
    process; K6 over a rank's 72 lanes against its plain version;
33. experiments/mscoco_nes.json at its own settings, nothing cut but depth
    (2000 pairs, batch 64, pop_chunk 48, bf16 compute, f32 deltas, 5000
    val images, blocks of 8) on [35]'s files at the Karpathy split's size
    (82,783 train and 30,504 restval images, 5000 val, 5000 test; vocab
    9487, 2048-d features): the set-up's seconds and bytes (arrays,
    CocoData, the train matrix's upload, DeviceCider's builds, NESMaster)
    and the card's peak memory; NESMaster for 2 blocks of 8 on
    the delta-operand pair path (K2 42 times and the row-block K1 once per
    generation, no K5 or K6; fitnesses and theta finite; ms per
    generation); generation 1's first and padded last chunk: K2 on the f32
    deltas bitwise K1 on prep(base ± delta) and held to its plain twin; the
    same generation at pop_chunk 40 (no pad lane): fitnesses bit for bit,
    theta Adam's step on a gradient within the sum-order bound; one block
    with tpu.kernel_noise (K5 42 times and K6 once per generation), K5
    bitwise K2 fed K7's dump, K6 over 2016 lanes bitwise its plain version
    and the ordered sum of K7's dumps; one generation of each run under
    torch.profiler (idle share, normal_ kernels); K2, K5 and K6 timed at
    these shapes with their bounds, plain and library times and the pair
    kernel's occupancy;
34. the decode kernels at E = R = 256 and 512 (the widths of the JAX
    package's scripts/exp_model_scale.py), each width's library built from
    csrc/ after [1]'s, beside the phases: build time, ptxas registers and
    spills, both cluster kernels' launch shapes; K1, K2, K3, K4, K5, K6 and
    decode_rows against their plain twins and each other (K4, decode_rows and K2
    bitwise K1, K5 bitwise K2 fed K7's dump, K6 the ordered sum of K7's
    dumps, K3's seed stream bitwise K3 fed its table, K7 held to its plain
    version, its dumps and K6's gradient 0 at every pad); then
    scripts/torch_model_scale.py's generation through NESEngine (144 pairs,
    batch 128, pop_chunk 48, bf16): pair-kernel, per-member and
    kernel-noise paths bit for bit, a self_critical generation with
    decode_vocab_tile 1920 (K3, K4) and validate_device (decode_rows); each
    kernel's time (K1-K7), plain time, cuBLAS yardstick and bound, and one
    profiled generation per width;
35. the reference's on-disk format at the Karpathy split's size, run
    before [33]: [33]'s arrays written by write_synthetic_coco under logs/
    (123,287 per-image .npy files, cocotalk.json, cocotalk_label.h5 from
    the port's numpy HDF5 writer) and read back by CocoData bit for bit
    CocoData.from_arrays (labels, label indices, split indices, gts,
    features), then reloaded in a fresh process (the consolidated
    features memory-mapped, bit for bit by SHA-256); the seconds to write,
    of the label read, of the first load and of the reload, and the train
    matrix's upload in GB/s; then, as child processes at once on those
    files, ``python -m nes_img_captioning_tpu_torch.main master`` on
    experiments/mscoco_nes.json for one block of 8 (its z_info, .pth and
    optimizer.tar written) and scripts/torch_parity_run.py with [27]'s
    XENT .pth for 2 generations and the 5000 test images (both warm-start
    round trips exact, 2 finite validation values, finite CIDEr-D for the
    podium-best and current checkpoints); a child's non-zero exit fails;
36. experiments/mscoco_es.json and mscoco_es_smg_fast.json as they are but
    for depth on [35]'s CocoData (113,287 train images, DeviceCider over
    566,435 references, [33]'s, shared by both files' masters, 5000 val
    images): the plain, fused and blocked paths and the children in
    decode order, 4 generations each: launches (K1 126 per generation)
    and engine calls, no host sync inside a fused generation or a block,
    the three torch-order paths' fitness vectors, children, podium rows
    and mean|policy| bit for bit, device candidate scores within 1e-4 of
    the native scorer's, the decode-order path's generation 1 bit for bit
    theirs and its sweep bit for bit task.rollout of its children mapped
    back; ms per generation on each path, one fused generation per file
    under torch.profiler (idle share); K1 at the ES launch shape and the
    row-block launch over the 5000 val rows against their plain twins,
    cuBLAS and their bounds; the SM-G file's sweep at pop_chunk 16 and 48;
37. [34]'s checks and times (one untimed generation per path) for two
    captioners of widths no library is built for, zero-padded onto [34]'s
    libraries (no new build): (E, R, F) = (300, 512, 2048) at W = 512 and
    (256, 192, 960) at W = 256 with F padded to 1024, the cuBLAS yardstick
    and the bound on the true shapes; at the second also
    experiments/mscoco_es.json at its widths with the children in decode
    order (4 generations, the last two a block), its layout sweep bit for
    bit task.rollout of its children mapped back;
38. K-W3, the library of E = R = 1024 (built beside the run with [34]'s):
    its build time, ptxas registers and spills and both cluster kernels'
    launch shapes (a member's 128 rows one 16-CTA cluster, a pair's sign
    one), then [34]'s checks, generations and times at E = R = 1024, and
    [34]'s checks and times with one untimed generation per path at
    Up-Down's (1000, 1000, 2048) padded to it; then F9's gate at 128 and 1024: 256 rows with lp through
    the task's row blocks (launches with no exit of their own, joined)
    against the plain twin over the whole batch, K1, K3 and K2. A
    ``[time]`` line after each group of phases gives its wall seconds.

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


def lap(t0: float, phases: str) -> float:
    """Log the wall seconds since ``t0`` as the time of ``phases``; returns
    the time now (the smoke's budget, phase by phase)."""
    now = time.time()
    log(f"[time] {phases}: {now - t0:.1f} s")
    return now


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


def time_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    unless ``warm`` is false (a plain twin of seconds a call whose
    operators the caller has just run), between CUDA events."""
    import torch

    if warm:
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


def eager_top2_gaps(model, theta, feats, seq):
    """The greedy eager decode of one member (theta (dim,), feats (R, F)),
    replayed on its tokens ``seq`` (R, T): each step's gap between the two
    largest logprobs, (R, T), the near-tie measure of another decode of
    that member against this one."""
    import torch

    with torch.no_grad():
        p = model.spec.unravel(theta[None].float())
        R = feats.shape[0]
        h = c = torch.zeros((1, R, model.options.rnn_size),
                            device=feats.device)
        _, h, c = model.lstm_core(p, model._img_embed(p, feats[None].float()),
                                  h, c)
        it = torch.zeros((1, R), dtype=torch.long, device=feats.device)
        gaps = []
        for t in range(seq.shape[-1]):
            out, h, c = model.lstm_core(p, model._embed(p, it), h, c)
            top = model._logprobs(p, out).topk(2, dim=-1).values
            gaps.append(top[..., 0] - top[..., 1])
            it = seq[None, :, t].long()
    return torch.stack(gaps, -1)[0]


def check_member_near_ties(model, thetas, feats, seq_k, seq_p, what: str,
                           limit: float, max_members: int):
    """Members decode their rows together (their batch statistics are
    shared), so one flipped token moves every later step of its member.
    Each member whose tokens differ from the plain decode ``seq_p`` (M, R,
    T) must first differ at a near-tie of it (top-2 gap < limit, replayed
    by eager_top2_gaps on thetas/feats), and at most ``max_members`` may
    differ. Returns [(member, step, gap)] of the differing members and the
    mask of the members whose tokens all agree."""
    same = (seq_k == seq_p).all(-1).all(-1)
    found = []
    for mi in (~same).nonzero()[:, 0].tolist():
        diff = seq_k[mi] != seq_p[mi]
        t0 = int(diff.any(0).nonzero()[0])
        gap = eager_top2_gaps(model, thetas[mi], feats[mi], seq_p[mi])
        found.append((mi, t0, float(gap[diff[:, t0], t0].max())))
    log(f"{what}: {len(found)} of {len(same)} members differ; (member, "
        f"first differing step, plain top-2 gap there): {found}")
    if len(found) > max_members or any(g >= limit for *_, g in found):
        raise AssertionError(
            f"{what}: {len(found)} members differ (at most {max_members}), "
            f"largest top-2 gap at a first difference "
            f"{max((g for *_, g in found), default=0.0):.3g} (< {limit})")
    return found, same


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


def decode_flops(n_steps, B: int, F: int, V1: int, E: int = 128,
                 R: int = 128) -> float:
    """Multiply-adds x 2 that one decode needs: per cluster of B rows the
    image product, the image step's input gate product (its h is 0, so no
    h2h), both gate products of every token step and the logits over the
    V1 real vocab columns (not the padding); n_steps holds the token steps
    of each cluster."""
    n = float(n_steps.sum())
    clusters = n_steps.numel()
    return 2.0 * B * (clusters * (F * E + E * 5 * R)
                      + n * ((E + R) * 5 * R + R * V1))


def regime_bound(nbytes: float, flops: float = 0.0, normals: int = 0,
                 normal_f32_ops: int = 0, f32_ops: float = 0.0) -> tuple:
    """(bound ms, what bounds it, bytes ms, operations ms): bytes read and
    written once over HBM_BYTES_PER_S; the products on the tensor cores;
    per normal NORMAL_INT_OPS integer and ``normal_f32_ops`` f32 operations,
    and ``f32_ops`` f32 operations besides (K3's Gumbel values, an f32
    kernel's FMAs), each type at its own rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_BF16, NORMAL_INT_OPS * normals / PEAK_INT32,
                (normal_f32_ops * normals + f32_ops) / PEAK_F32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


def cublas_decode(feats, weights: dict, T: int, lanes: int = 1,
                  gumbel: bool = False):
    """The library yardstick of a decode: cuBLAS for its products in the
    weights' dtype (bf16 in; f32 with TF32 as the caller set it) and torch's
    argmax over every row: the image product, T + 1 x the two gate
    products, T x the logits; batched over a leading member axis where
    there is one. ``lanes``: copies of each member's rows (K3's sample
    lanes); ``gumbel``: the argmax of the logits plus torch's Gumbel values
    (K3). At E != R the input products read the image embedding (E wide)
    and the others a state of R cells."""
    import torch

    dt = weights["img_w"].dtype
    x = torch.matmul(feats.to(dt), weights["img_w"]).to(dt)
    if lanes > 1:
        x = x.repeat(1, lanes, 1)
    R = weights["h2h_w"].shape[-2]
    h = x if x.shape[-1] == R else x.new_zeros((*x.shape[:-1], R))
    for step in range(T + 1):
        torch.matmul(x, weights["i2h_w"])
        torch.matmul(h, weights["h2h_w"])
        if step:
            logits = torch.matmul(h, weights["logit_w"])
            if gumbel:
                u = torch.rand(logits.shape, device=logits.device)
                logits = logits.float() - torch.log(-torch.log(u))
            logits.argmax(-1)


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

    # the M x spi lanes share their member's weights
    lib3_ms = time_ms(lambda: cublas_decode(feats2, params16, T, spi, True))
    seq3, _ = dc.decode_fused(params16, feats2, T, False, greedy=False,
                              seeds=lanes)
    steps3 = executed_steps(seq3.reshape(M * spi, B, T), T)
    flops3 = decode_flops(steps3, B, Fd, V + 1)
    gumbels = float(steps3.sum()) * B * (V + 1)
    seq4, _ = dc.decode_fused(params16, feats2, T, False, vocab_tile=tile)
    flops4 = decode_flops(executed_steps(seq4, T), B, Fd, V + 1)
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
        b_ms, b_by = regime_bound(nbytes, flops, f32_ops=ops)[:2]
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


def rows_flops(seq, F: int, V1: int, E: int = 128, R: int = 128,
               block: int = 128) -> float:
    """decode_flops of a row-block decode of seq (N, T): each block of
    ``block`` rows (a cluster's) with its real rows, until its longest row
    ends."""
    T = seq.shape[-1]
    return sum(decode_flops(executed_steps(blk[None], T), blk.shape[0], F,
                            V1, E, R)
               for blk in (seq[lo:lo + block]
                           for lo in range(0, seq.shape[0], block)))


def val_fixture(phase: str = "[18]"):
    """The in-memory fixture of phases 18-30: the bench's 2048 train
    images, VAL_ITEMS validation images (mscoco_nes.json's and
    mscoco_es.json's num_val_items) and TEST_ITEMS test images ([28]). The
    generator draws the images in split order, after its token projection,
    so the test images leave the train and val arrays of [18]-[26] as they
    were with 8 test images: checked by their digest."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )

    t0 = time.time()
    kw = dict(n_train=2048, n_val=VAL_ITEMS, vocab_size=9487,
              fc_feat_size=2048, cap_len=9, seed=0)
    arrays = synthetic_coco_arrays(n_test=TEST_ITEMS, **kw)
    n = kw["n_train"] + VAL_ITEMS
    digest = fixture_digest(arrays, n)
    if digest != fixture_digest(synthetic_coco_arrays(n_test=8, **kw), n):
        raise AssertionError("[18] the test images moved the train and val "
                             "arrays")
    data = CocoData.from_arrays(arrays)
    log(f"{phase} fixture with {VAL_ITEMS} val and {TEST_ITEMS} test images "
        f"in {time.time() - t0:.1f} s; train and val arrays' SHA-256 "
        f"{digest[:16]} with 8 test images or {TEST_ITEMS}")
    return data


def rows_against_plain(phase: str, params, feats, T: int, V1: int) -> dict:
    """The row-block launch (``decode_rows``, bf16 ``params``) over
    ``feats`` held to its plain twin: the tokens the same whether it
    returns lp or not, and the twin's but where a row first differs at a
    near-tie; lp within LP_BF16_TOL over the row blocks whose tokens all
    agree. Returns the twin's time, cuBLAS products' time, the bound (the
    bytes read once, each block of 128 rows until its longest row ends),
    the CTAs of the launch and the comparison's figures."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    n = feats.shape[0]
    seq, _ = dc.decode_rows(params, feats, T, False)
    seq_l, lp_k = dc.decode_rows(params, feats, T, True)
    plain = {}
    plain_ms = time_ms(lambda: plain.update(out=dc.decode_rows_plain(
        params, feats, T, False)), reps=1)
    seq_p, lp_p, gap_p = dc.decode_rows_plain(params, feats, T, True,
                                              top2_gap=True)
    torch.cuda.synchronize()
    if not (torch.equal(seq, seq_l) and torch.equal(plain["out"][0], seq_p)):
        raise AssertionError(f"{phase} row-block tokens depend on "
                             "need_logprobs")
    share, n_diff = check_near_ties(seq, seq_p, gap_p,
                                    f"{phase} decode_rows bf16 at {n} rows")
    same = (seq_l == seq_p).all(-1)
    block = torch.arange(n, device=feats.device) // 128
    keep = ~torch.isin(block, block[~same])
    if not bool(keep.any()):
        raise AssertionError(f"{phase} decode_rows bf16: no row block agrees "
                             "with the plain twin")
    err = float((lp_k - lp_p)[keep].abs().max())
    if err > LP_BF16_TOL:
        raise AssertionError(f"{phase} decode_rows bf16: lp error {err:.3g} "
                             f"> {LP_BF16_TOL}")
    lib_ms = time_ms(lambda: cublas_decode(feats, params, T))
    flops = rows_flops(seq, feats.shape[1], V1)
    nbytes = sum(v.numel() * v.element_size() for v in params.values()) \
        + feats.numel() * feats.element_size() + seq.numel() * 8
    b_ms, b_by = regime_bound(nbytes, flops)[:2]
    return {"plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "share": share, "n_diff": n_diff,
            "kept_rows": int(keep.sum()),
            "ctas": dc.member_cluster_info()["cluster"] * -(-n // 128)}


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
    T = task.model.options.seq_length
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
    rp = rows_against_plain("[18]", params, feats, T,
                            task.model.options.vocab_size + 1)
    plain_ms, lib_ms, err = rp["plain_ms"], rp["library_ms"], \
        rp["max_abs_err"]
    flops, nbytes, b_ms, b_by, ctas = (rp[k] for k in (
        "flops", "bytes", "bound_ms", "bound_by", "ctas"))
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
    log(f"[18] decode_rows at {VAL_ITEMS} rows: {row[0][0]:.3f} ms, {ctas} "
        f"CTAs (plain twin {plain_ms:.3f} ms, cuBLAS products "
        f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: {flops / 1e9:.1f} "
        f"GFLOP, {nbytes / 1e6:.1f} MB, {b_ms / row[0][0]:.1%} of it); bf16 "
        f"against the plain twin: {rp['share']:.4%} of rows identical, "
        f"{rp['n_diff']} differ, each first at a near-tie (top-2 gap < "
        f"1e-2), max |lp - plain| {err:.3g} over {rp['kept_rows']} rows of "
        f"agreeing blocks; "
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


def drive_es(exp: dict, dev, data, iters: int, score_s=None):
    """An ESMaster of ``exp`` on ``data`` run for ``iters`` generations, its
    fused generations and blocks under ``no_sync``, with the launch counts
    of ES_COUNTERS (K1, row-block K1, K4, K3, K2, K5) set to 0 just before
    and read just after. Returns (master, fitness vectors, engine calls,
    block sizes, counts); the master's ``setup_s`` and ``run_s`` are its
    construction's and its run's seconds on the host clock. ``score_s``
    gathers the seconds of each ``host_fitness`` call."""
    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine, ESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    counters = [getattr(dc, name) for name in ES_COUNTERS]
    t0 = time.perf_counter()
    m = ESMaster(exp, device=dev, data=data)
    # the scorers (captioning: the host val scorer) are built before the
    # timed run
    getattr(m.task, "val_scorer", None)
    if m.task.fitness_on_device:
        m.task.device_val_consts()
    else:
        m.task.train_scorer
    m.setup_s = time.perf_counter() - t0
    eng, fits, calls, blocks = m.engine, [], [], []
    host_fitness, unpack_fused = m.task.host_fitness, eng.unpack_fused
    unpack_block = ESEngine.unpack_block

    def hf(art, idx):
        t0 = time.perf_counter()
        fits.append(host_fitness(art, idx))
        if score_s is not None:
            score_s.append(time.perf_counter() - t0)
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


def k1_es_chunk(phase: str, task, params: dict, idx_row) -> dict:
    """K1 at the ES launch shape: one chunk's members (params, bf16) on the
    first 128 rows of ``idx_row``, against its plain twin (tokens but at
    near-ties, lp within LP_BF16_TOL on the members decoded alike), its time
    beside the plain twin's, cuBLAS products' and the bound (the bytes read
    once, each member's 128 rows a row block of ``rows_flops``)."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    T = task.model.options.seq_length
    chunk = params["img_w"].shape[0]
    feats = task.train_fc[torch.as_tensor(np.asarray(idx_row[:128]),
                                          device=task.device)]
    feats = feats.expand(chunk, -1, -1).contiguous()
    k1_ms = time_ms(lambda: dc.decode_fused(params, feats, T, False))
    plain_ms = time_ms(lambda: dc.decode_fused_plain(params, feats, T,
                                                     False), reps=1)
    seq, lp = dc.decode_fused(params, feats, T, True)
    seq_p, lp_p, gap_p = dc.decode_fused_plain(params, feats, T, True,
                                               top2_gap=True)
    torch.cuda.synchronize()
    share, n_diff = check_near_ties(seq, seq_p, gap_p,
                                    f"{phase} K1 bf16 at the ES shape")
    agree = (seq == seq_p).all(-1).all(-1)  # members decoded alike
    if not bool(agree.any()):
        raise AssertionError(f"{phase} K1 bf16: no member agrees with the "
                             "plain twin")
    err = float((lp - lp_p)[agree].abs().max())
    if err > LP_BF16_TOL:
        raise AssertionError(f"{phase} K1 bf16: lp error {err:.3g} > "
                             f"{LP_BF16_TOL}")

    lib_ms = time_ms(lambda: cublas_decode(feats, params, T))
    # each member's 128 rows are one row block of rows_flops: the logits
    # over the V + 1 real columns, no h2h product at the image step
    Fd, V1 = feats.shape[-1], task.model.options.vocab_size + 1
    flops = sum(rows_flops(member_seq, Fd, V1) for member_seq in seq)
    nbytes = sum(v.numel() * v.element_size() for v in params.values()) \
        + feats.numel() * 2 + seq.numel() * 8
    b_ms, b_by = regime_bound(nbytes, flops)[:2]
    return {"ms": k1_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes, "share": share,
            "n_diff": n_diff, "agree": int(agree.sum()),
            "ctas": dc.member_cluster_info()["cluster"] * chunk}


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
        got = es_file_settings("mscoco_es", exp)
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
    lay = task.decode_layout
    kids = eng.materialize(parents, sigma, seeds[:chunk], pidx[:chunk])
    k1 = k1_es_chunk("[19]", task, lay.prep(lay.to_dec(kids),
                                            torch.bfloat16), idx_row)
    del kids
    k1_ms, plain_ms, lib_ms, err = (k1["ms"], k1["plain_ms"],
                                    k1["library_ms"], k1["max_abs_err"])
    b_ms, b_by, ctas = k1["bound_ms"], k1["bound_by"], k1["ctas"]
    log(f"[19] K1 at the ES launch shape ({chunk} members x 128 rows, "
        f"{ctas} CTAs, bf16): {k1_ms:.3f} ms per launch (plain twin "
        f"{plain_ms:.3f} ms, cuBLAS products {lib_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}: {k1['flops'] / 1e9:.1f} GFLOP, "
        f"{k1['bytes'] / 1e6:.1f} MB, {b_ms / k1_ms:.1%} of it); against "
        f"the plain twin {k1['share']:.4%} of rows identical, "
        f"{k1['n_diff']} differ, each first at a near-tie, max |lp - plain| "
        f"{err:.3g} over {k1['agree']} agreeing members; {launches} "
        f"launches in the blocked run ({card})")
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


def es_file_settings(cfg: str, exp: dict) -> tuple:
    """The settings of an ES file that ES_SETTINGS ([19]) or SMG_SETTINGS
    ([20]) pin, in their order."""
    c, mo, t = (exp["config"], exp["policy_options"]["model_options"],
                exp["tpu"])
    head = (exp["nb_offspring"], exp["population_size"], exp["num_elites"],
            exp["num_elite_cands"], exp["selection"], c["batch_size"],
            c["num_val_items"], c["noise_stdev"], mo["safe_mutations"])
    if cfg == "mscoco_es":
        return head + (t["precision"], t["pop_chunk"], t["gens_per_dispatch"])
    return head + (mo["safe_mutation_underflow"], t["precision"],
                   t["pop_chunk"], t["gens_per_dispatch"], c["snapshot_freq"],
                   t["sensitivity_batch"], t["sensitivity_split"],
                   t["sensitivity_precision"])


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
        got = es_file_settings("mscoco_es_smg_fast", exp)
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


# [22]/[23]: the data's (train, test) sizes, real MNIST's (5000 val images)
MNIST_SIZES = (60000, 10000)
# experiments/mnist_nes.json's and mnist_es.json's settings that [23] runs
# (nb_offspring, batch_size, vbn, safe_mutations, safe_mutation_underflow;
# ES: population_size, num_elites, num_elite_cands, snapshot_freq)
MNIST_NES_SETTINGS = (50, 64, True, "SM-G-SUM", 0.2)
MNIST_ES_SETTINGS = (50, 64, False, "SM-G-SUM", 0.2, 10, 3, 2, 5)
# [23]: iterations of each NES run (patience 0, gens_per_dispatch 4: blocks
# of 4, 1 (the snapshot's), 2 and 1); ES generations of each path (blocked:
# gen 1 plain, 2 fused, 3-4 a block, 5 (the schedule's and the snapshot's)
# and 6 fused)
MNIST_NES_ITERS, MNIST_ES_ITERS = 8, 6


def mnist_settings(exp: dict) -> tuple:
    cfg, popts = exp["config"], exp["policy_options"]
    mo = popts["model_options"]
    got = (exp["nb_offspring"], cfg["batch_size"], popts["vbn"],
           mo["safe_mutations"], mo["safe_mutation_underflow"])
    if exp["algorithm"] == "nic_es":
        got += (exp["population_size"], exp["num_elites"],
                exp["num_elite_cands"], cfg["snapshot_freq"])
    return got


def mnist_task_phase(card: str) -> dict:
    """Phase 22: MnistTask on the card at real MNIST's split sizes (the
    loader's synthetic set at 60000 / 10000, 5000 val images), vbn off and
    on, with the process's TF32 switches on so that only the task's own
    numerics keep its products f32: 100 members (mnist_nes.json's 50 pairs)
    on their own batches of 64, logits and fitnesses within 1e-5 of the
    same call on the CPU; validate_device equal to validate; a member's
    fitness the same bits in rollouts of 100 and of 3 members, at another
    place, on its own and on a shared batch. Returns the data."""
    import torch

    from nes_img_captioning_tpu_torch.data.mnist import load_mnist
    from nes_img_captioning_tpu_torch.tasks.classification import MnistTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    t_phase = time.perf_counter()
    data = load_mnist("data", synthetic_sizes=MNIST_SIZES, seed=0)
    log(f"[22] MNIST arrays ({len(data['train_y'])} train, "
        f"{len(data['val_y'])} val, {len(data['test_y'])} test) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    M, B = 2 * MNIST_NES_SETTINGS[0], MNIST_NES_SETTINGS[1]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for vbn in (False, True):
            exp = {"dataset": "mnist", "policy_options": {"vbn": vbn}}
            card_t, cpu_t = (MnistTask(exp, Config(batch_size=B),
                                       TpuConfig(seed=0), device=d,
                                       data=data)
                             for d in ("cuda", "cpu"))
            g = torch.Generator().manual_seed(22)
            thetas = torch.stack([cpu_t.spec.init_theta(g)
                                  for _ in range(M)])
            idx = torch.randint(0, MNIST_SIZES[0], (M, B), generator=g)
            th_d, idx_d = thetas.cuda(), idx.cuda()
            x = cpu_t.train_x[idx]
            x_d = x.cuda()
            card_t.rollout(th_d, idx_d)  # warm-up: cuDNN's first calls
            lc, l_ms = events_ms(lambda: card_t.logits(th_d, x_d))
            fc, f_ms = events_ms(lambda: card_t.rollout(th_d, idx_d))
            err_l = float((lc.cpu() - cpu_t.logits(thetas, x)).abs().max())
            err_f = float((fc["fitness"].cpu()
                           - cpu_t.rollout(thetas, idx)["fitness"]).abs().max())
            if not (err_l <= 1e-5 and err_f <= 1e-5):
                raise AssertionError(f"[22] vbn {vbn}: card against CPU: "
                                     f"logits {err_l:.3g}, fitness "
                                     f"{err_f:.3g} > 1e-5")
            vc = card_t.device_val_consts()
            card_t.validate_device(th_d[0], vc)
            val, v_ms = events_ms(lambda: card_t.validate_device(th_d[0], vc))
            host = card_t.validate(th_d[0])
            cpu_acc = cpu_t.validate(thetas[0])
            if float(val) != host:
                raise AssertionError(f"[22] vbn {vbn}: validate_device "
                                     f"{float(val)} != validate {host}")
            whole = fc["fitness"]
            shared = card_t.rollout(th_d, idx_d[0])["fitness"]
            for lo in (0, 37, 97):
                part = card_t.rollout(th_d[lo:lo + 3], idx_d[lo:lo + 3])
                part_s = card_t.rollout(th_d[lo:lo + 3], idx_d[0])
                if not (torch.equal(part["fitness"], whole[lo:lo + 3])
                        and torch.equal(part_s["fitness"],
                                        shared[lo:lo + 3])):
                    raise AssertionError(f"[22] vbn {vbn}: members {lo}.."
                                         f"{lo + 2} change bits with the "
                                         "chunk")
            log(f"[22] MnistTask vbn {vbn}, TF32 on in the process: {M} "
                f"members x {B} images on the card within {err_l:.3g} "
                f"(logits) and {err_f:.3g} (fitness) of the CPU; rollout "
                f"{f_ms:.3f} ms, logits alone {l_ms:.3f} ms by CUDA events; "
                f"validate_device over {vc['xb'].shape[0]} batches of "
                f"{vc['xb'].shape[1]} {v_ms:.3f} ms, = validate "
                f"({host:.4f}; CPU {cpu_acc:.4f}); 3 members in chunks of 3 "
                f"at 0, 37, 97 bitwise their rows among {M}, own and shared "
                f"batches ({card})")
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    log(f"[22] phase: {time.perf_counter() - t_phase:.1f} s")
    return data


def mnist_masters_phase(card: str, data):
    """Phase 23: experiments/mnist_nes.json and mnist_es.json at their own
    sizes on the card. NESMaster (50 pairs, batch 64, vbn, SM-G-SUM inline
    at underflow 0.2, Adam): the configuration as it is for
    MNIST_NES_ITERS iterations (patience 2: host validation per
    generation), and with patience 0 in blocks of 4 (fused validation)
    against single generations, theta and the accuracies bit for bit.
    ESMaster (50 offspring, 10 parents, 3 elites, 2 candidates, SM-G-SUM)
    on the plain, fused and blocked paths, MNIST_ES_ITERS generations each:
    fitness vectors, kept children and podium rows bit for bit, no host
    sync inside a fused generation or a block, no decode kernel launched.
    ms per NES iteration and ES generation, and the SM-G sweeps' ms."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivities,
        calc_sensitivity,
    )
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_mnist_{os.getpid()}")
    t_phase = time.perf_counter()

    def experiment(algo: str, name: str, config=None, **tpu) -> dict:
        exp = load_experiment(f"experiments/mnist_{algo}.json")
        want = MNIST_NES_SETTINGS if algo == "nes" else MNIST_ES_SETTINGS
        if mnist_settings(exp) != want:
            raise AssertionError(f"[23] mnist_{algo}.json changed: "
                                 f"{mnist_settings(exp)}")
        exp["config"].update(config or {})
        exp["tpu"].update(tpu)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    nes = {}
    for name, config, gpd in (("config", {}, 1),
                              ("block", {"patience": 0}, 4),
                              ("single", {"patience": 0}, 1)):
        t0 = time.perf_counter()
        m = NESMaster(experiment("nes", name, config,
                                 gens_per_dispatch=gpd),
                      device=dev, data=data)
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_master(max_iterations=MNIST_NES_ITERS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        fits = np.asarray(m.stats.score_stats()[1])
        if m._val_fused != (name == "block") or not np.isfinite(fits).all():
            raise AssertionError(f"[23] NES {name}: fused validation "
                                 f"{m._val_fused}, mean fitness {fits}")
        nes[name] = m
        log(f"[23] NESMaster {name} (experiments/mnist_nes.json: 50 pairs, "
            f"batch 64, vbn, SM-G-SUM inline, Adam, "
            f"{len(data['val_y'])} val images, gens_per_dispatch {gpd}, "
            f"patience {m.config.patience}; set-up {setup_s:.1f} s, run "
            f"{run_s:.1f} s): ms per iteration "
            f"{[round(t * 1e3, 3) for t in m.stats.time_stats()]}; mean "
            f"fitness {[round(float(f), 4) for f in fits]}; val accuracy "
            f"{[round(a, 4) for a in m.stats.acc_stats()]} ({card})")
    mb, ms_ = nes["block"], nes["single"]
    if not torch.equal(mb.theta, ms_.theta) or \
            mb.stats.acc_stats() != ms_.stats.acc_stats():
        raise AssertionError("[23] the NES block (fused validation) differs "
                             "from single generations (host validation)")
    log(f"[23] NES: {MNIST_NES_ITERS} generations in blocks of up to 4 with "
        "validation on the card bit for bit the single generations with "
        "host validation (theta, accuracies)")

    runs = {}
    for name, tpu in (("plain", {"fused_es": False}), ("fused", {}),
                      ("blocked", {"gens_per_dispatch": 4})):
        m, fits, calls, blocks, counts = drive_es(
            experiment("es", name, **tpu), dev, data, MNIST_ES_ITERS)
        want = {"plain": [], "fused": ["fused_generation"] * 5,
                "blocked": ["fused_generation", "fused_block",
                            "fused_generation", "fused_generation"]}[name]
        if calls != want or len(fits) != MNIST_ES_ITERS or any(counts):
            raise AssertionError(f"[23] ES {name}: engine calls {calls}, "
                                 f"blocks {blocks}, {len(fits)} fitness "
                                 f"vectors, decode launches {counts}")
        if not all(np.isfinite(f).all() for f in fits):
            raise AssertionError(f"[23] ES {name}: non-finite fitness")
        children, podium = es_state(m)
        runs[name] = (m, fits, children, podium)
        log(f"[23] ESMaster {name} (experiments/mnist_es.json: 50 "
            f"offspring, 10 parents, batch 64, SM-G-SUM; set-up "
            f"{m.setup_s:.1f} s, run {m.run_s:.1f} s): ms per generation "
            f"{[round(t * 1e3, 3) for t in m.stats.time_stats()]}; engine "
            f"calls {calls} under set_sync_debug_mode('error'); val "
            f"accuracy {[round(a, 4) for a in m.stats.acc_stats()]} ({card})")
    pm, pfits, pchildren, ppodium = runs["plain"]
    for name in ("fused", "blocked"):
        m, fits, children, podium = runs[name]
        if not all(np.array_equal(a, b) for a, b in zip(pfits, fits)) \
                or not torch.equal(children, pchildren) \
                or [s for s, _ in podium] != [s for s, _ in ppodium] \
                or not all(torch.equal(a[1], b[1])
                           for a, b in zip(podium, ppodium)):
            raise AssertionError(f"[23] ES {name}: fitness, children or "
                                 "podium differ from the plain path's")
    log(f"[23] ES plain, fused and blocked paths: {MNIST_ES_ITERS} fitness "
        f"vectors, {pchildren.shape[0]} kept children and {len(ppodium)} "
        "podium rows bit for bit")

    # the SM-G sweeps of the two configurations, by CUDA events
    task = runs["fused"][0].task
    parents = torch.cat([pchildren, pchildren[:3]]).to(dev)  # 10 parents
    idx = torch.arange(MNIST_ES_SETTINGS[1], device=dev)
    kind = MutationKind.SAFE_GRAD_SUM
    calc_sensitivities(task, parents, idx, kind, 0.2)
    _, es_sweep_ms = events_ms(
        lambda: calc_sensitivities(task, parents, idx, kind, 0.2))
    ntask, theta = mb.task, mb.theta
    calc_sensitivity(ntask, theta, idx, kind, 0.2)
    _, nes_sweep_ms = events_ms(
        lambda: calc_sensitivity(ntask, theta, idx, kind, 0.2))
    log(f"[23] SM-G-SUM sweeps over 64 rows: ES's 10 parents "
        f"{es_sweep_ms:.3f} ms, NES's one theta (vbn) {nes_sweep_ms:.3f} ms "
        f"by CUDA events ({card})")

    # one NES generation under the profiler: the card's idle share
    eng, F, B = ms_.engine, MNIST_NES_SETTINGS[0], MNIST_NES_SETTINGS[1]
    rng = np.random.default_rng(23)
    seeds = rng.integers(0, 2**32, size=F, dtype=np.uint32)
    batches = rng.integers(0, MNIST_SIZES[0], size=(F, B))
    state = eng.optimizer.init(eng.dim, dev)
    wall_ms, busy, rows = profile_call(lambda: eng.unpack(eng.generation(
        theta, state, None, 0.02, seeds, batches, 0.01, 0.001)[2], F))
    top = "; ".join(f"{name[:48]} {ms:.3f} (x{n})"
                    for ms, n, name in rows[:4])
    log(f"[23] one mnist_nes.json generation under torch.profiler: wall "
        f"{wall_ms:.3f} ms, card busy {busy:.3f} ms (idle "
        f"{1 - busy / wall_ms:.2%}); top kernels {top} ({card})")
    shutil.rmtree(runs_dir)
    log(f"[23] phase: {time.perf_counter() - t_phase:.1f} s")


# [24]-[26]: experiments/mscoco_nes.json cut as [10] is (BENCH's pairs,
# batch and pop_chunk, 256 validation images); iterations per run
HOST_NES_ITERS = {"greedy": 3, "self_critical": 2}
NORM_ITERS = 2
# [24]: |host_fitness - _device_fitness| on the same tokens
HOST_DEVICE_TOL = 1e-4
# [26]: |lp card - lp CPU| of the eager decoder (f32, TF32 off); a member
# whose tokens differ must first differ where the CPU's top-2 gap is below
# that same tolerance, and at most EAGER_MAX_FLIPPED of the 48 may differ
# (an H100 run saw 1 member, first differing at a gap of 9.5e-7, with lp
# within 2.9e-6 before it)
EAGER_LP_TOL = 1e-4
EAGER_TIE_GAP = EAGER_LP_TOL
EAGER_MAX_FLIPPED = 2
NORM_VARIANTS = (("vbn", {"vbn": True}, {}),
                 ("vbn_e", {}, {"vbn_e": True}),
                 ("layer_n", {}, {"layer_n": True}))
DECODE_COUNTERS = ("decode_fused", "decode_sample", "decode_tiled",
                   "decode_rows")


def nes_experiment(runs_dir: str, name: str, precision: str, popts=None,
                   mopts=None, **tpu) -> dict:
    """experiments/mscoco_nes.json cut as [10] is: BENCH's 144 pairs,
    batch 128 and pop_chunk 24, 256 validation images in one chunk;
    ``popts``, ``mopts`` and ``tpu`` override its policy options, model
    options and tpu knobs."""
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    exp = load_experiment("experiments/mscoco_nes.json")
    exp["config"].update(batch_size=BENCH["batch"], val_batch_size=256,
                         num_val_items=256, snapshot_freq=100)
    exp["policy_options"].update(popts or {})
    exp["policy_options"]["model_options"].update(
        safe_mutation_underflow=0.01, **(mopts or {}))
    exp["nb_offspring"] = BENCH["pairs"]
    exp["tpu"].update(pop_chunk=BENCH["pop_chunk"], precision=precision,
                      delta_dtype=precision, **tpu)
    exp["log_dir"] = os.path.join(runs_dir, name)
    return exp


def drive_nes(exp: dict, dev, data, iters: int):
    """An NESMaster of ``exp`` on ``data`` run for ``iters`` iterations,
    the decode kernels' launch counts (DECODE_COUNTERS: K1, K3, K4,
    row-block K1) set to 0 just before and read just after. The master's
    ``score_s`` lists the host scoring's seconds per call and ``run_s`` is
    its run's seconds on the host clock."""
    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    m = NESMaster(exp, device=dev, data=data)
    m.task.val_scorer  # the scorers are built before the timed run
    if not m.task.fitness_on_device:
        m.task.train_scorer
    m.score_s, host_fitness = [], m.task.host_fitness

    def hf(art, idx):
        t0 = time.perf_counter()
        out = host_fitness(art, idx)
        m.score_s.append(time.perf_counter() - t0)
        return out

    m.task.host_fitness = hf
    counters = [getattr(dc, name) for name in DECODE_COUNTERS]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    m.run_master(max_iterations=iters)
    torch.cuda.synchronize()
    m.run_s = time.perf_counter() - t0
    counts = [c.launches for c in counters]
    if m.it.iteration() != iters or \
            not np.isfinite(m.stats.score_stats()[1]).all() or \
            not np.isfinite(m.stats.acc_stats()).all():
        raise AssertionError(f"{exp['log_dir']}: {iters} finite iterations "
                             "expected")
    return m, counts


def host_nes_phase(card: str, dtask) -> None:
    """Phase 24: host-scored NIC-NES (experiments/mscoco_nes.json with
    tpu.device_cider false, cut as [10], bf16) through NESMaster: 3
    iterations greedy, 2 self_critical, K1 (and K3) launched once per chunk
    of 48 torch-order members laid out by to_dec + prep, host validation
    (one row-block launch each); then one generation taken apart: eval
    sweep (CUDA events), token pull, host scoring (the share of rows
    _score_dedup scored), update, and the card's idle share under
    torch.profiler; the sweep's first chunk is K1's launch
    on prepare_decode_params' layout, held to the plain twin up to
    near-ties; host_fitness equal to the device scorer's (``dtask``, the
    bench task on the same data) within HOST_DEVICE_TOL; the update with
    the carried deltas bitwise the one that draws them again."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_host_{os.getpid()}")
    F, P, B = BENCH["pairs"], BENCH["pop_chunk"], BENCH["batch"]
    n_chunks = -(-F // P)
    masters = {}
    for kind, iters in HOST_NES_ITERS.items():
        exp = nes_experiment(runs_dir, kind, "bf16", {"fitness": kind},
                             device_cider=False)
        m, counts = drive_nes(exp, dev, dtask.data, iters)
        task = m.task
        if task.fitness_on_device or not task._fused or \
                task.decode_layout is not None or m._val_fused:
            raise AssertionError(f"[24] {kind}: the task did not resolve to "
                                 "the kernels' decode scored on the host")
        k3 = n_chunks * iters if kind == "self_critical" else 0
        want = [n_chunks * iters, k3, 0, iters]
        if counts != want:
            raise AssertionError(f"[24] {kind}: launches (K1, K3, K4, "
                                 f"row-block K1) {counts} != {want}")
        masters[kind] = m
        times = m.stats.time_stats()
        log(f"[24] NESMaster host-scored {kind} (experiments/mscoco_nes.json"
            f", tpu.device_cider false: {F} pairs, batch {B}, pop_chunk {P},"
            f" bf16, 256 val images): {iters} iterations in {m.run_s:.1f} s, "
            f"ms per iteration {[round(t * 1e3, 3) for t in times]}, host "
            f"scoring ms {[round(t * 1e3, 3) for t in m.score_s]}; launches "
            f"K1 {counts[0]} (the chunk's {2 * P} members per launch), K3 "
            f"{counts[1]}, row-block K1 {counts[3]}; mean fitness "
            f"{[round(f, 4) for f in m.stats.score_stats()[1]]}, val CIDEr "
            f"{[round(a, 4) for a in m.stats.acc_stats()]} ({card})")

    # one greedy generation, taken apart
    m = masters["greedy"]
    eng, task = m.engine, m.task
    seeds, batches = generation_inputs(task, 1)
    theta, sens, sigma = m.theta, torch.ones_like(m.theta), BENCH["sigma"]
    step, l2 = BENCH["stepsize"], BENCH["l2coeff"]
    eng.eval_generation(theta, sens, sigma, seeds[0], batches[0])  # warm-up
    (art, deltas), eval_ms = events_ms(lambda: eng.eval_generation(
        theta, sens, sigma, seeds[0], batches[0]))
    if deltas is None or tuple(art["seq"].shape) != (F, 2, B, 16) or \
            art["seq"].dtype != torch.int16:
        raise AssertionError("[24] eval_generation: artifacts "
                             f"{tuple(art['seq'].shape)} {art['seq'].dtype},"
                             f" deltas carried {deltas is not None}")
    t0 = time.perf_counter()
    host = {k: v.cpu() for k, v in art.items()}
    pull_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fit = task.host_fitness(host, batches[0])
    score_ms = (time.perf_counter() - t0) * 1e3
    scored, rows = task.dedup_rows
    state = eng.optimizer.init(eng.dim, dev)
    (_, th_c, ratio_c), upd_ms = events_ms(lambda: eng.update(
        theta, state, sens, sigma, seeds[0], fit, step, l2, deltas=deltas))
    (_, th_r, ratio_r), regen_ms = events_ms(lambda: eng.update(
        theta, eng.optimizer.init(eng.dim, dev), sens, sigma, seeds[0], fit,
        step, l2))
    if not (torch.equal(th_c, th_r) and torch.equal(ratio_c, ratio_r)):
        raise AssertionError("[24] update with the carried deltas differs "
                             "from the update that draws them again")
    log(f"[24] one host-scored greedy generation: eval sweep (deltas + "
        f"{n_chunks} K1 launches) {eval_ms:.3f} ms (CUDA events), token pull "
        f"{pull_ms:.3f} ms ({host['seq'].numel() * 2 / 1e6:.2f} MB int16), "
        f"host scoring {score_ms:.3f} ms ({scored} of {rows} rows scored by "
        f"_score_dedup, {scored / rows:.2%}), update with carried deltas "
        f"{upd_ms:.3f} ms (drawing them again {regen_ms:.3f} ms; theta "
        f"bitwise equal); sum {eval_ms + pull_ms + score_ms + upd_ms:.3f} ms "
        f"({card})")

    def host_generation():
        a, d = eng.eval_generation(theta, sens, sigma, seeds[0], batches[0])
        f = task.host_fitness({k: v.cpu() for k, v in a.items()}, batches[0])
        return eng.update(theta, eng.optimizer.init(eng.dim, dev), sens,
                          sigma, seeds[0], f, step, l2, deltas=d)

    wall, busy, rows = profile_call(host_generation)
    log(f"[24] one host-scored greedy generation under torch.profiler: wall "
        f"{wall:.3f} ms, card busy {busy:.3f} ms ({busy / wall:.2%}; idle "
        f"{1 - busy / wall:.2%}) ({card})")
    for ms_, count, key in rows[:6]:
        log(f"    {ms_:10.3f} ms  x{count:<5d} {key[:90]}")

    # the sweep's first chunk: K1 on to_dec + prep, = prepare_decode_params
    lay, T = task._layout, task.model.options.seq_length
    d0 = deltas[0]
    members = torch.stack([theta + d0, theta - d0], 1).reshape(2 * P, -1)
    params = lay.prep(lay.to_dec(members), torch.bfloat16)
    for i in (0, 2 * P - 1):
        one = dc.prepare_decode_params(task.spec, members[i],
                                       task.model.options, torch.bfloat16)
        if not all(torch.equal(params[k][i], one[k]) for k in one):
            raise AssertionError(f"[24] member {i}: to_dec + prep differs "
                                 "from prepare_decode_params")
    idx2 = torch.as_tensor(batches[0][:P], device=dev).repeat_interleave(2, 0)
    feats2 = task.train_fc[idx2]
    seq_k, _ = dc.decode_fused(params, feats2, T, False)
    if not torch.equal(seq_k.to(torch.int16),
                       art["seq"][:P].reshape(2 * P, B, T)):
        raise AssertionError("[24] the sweep's first chunk is not K1's "
                             "launch on its members")
    seq_p, _, gap_p = dc.decode_fused_plain(params, feats2, T, False,
                                            top2_gap=True)
    share, n_diff = check_near_ties(seq_k, seq_p, gap_p, "[24] K1 bf16")
    # the same tokens through the device scorer
    dev_fit = dtask._device_fitness(
        art["seq"].reshape(2 * F, B, T),
        torch.as_tensor(batches[0], device=dev).repeat_interleave(2, 0),
        dtask._device_cider.dev).reshape(F, 2).cpu().numpy()
    err = float(np.abs(dev_fit - fit).max())
    if err > HOST_DEVICE_TOL:
        raise AssertionError(f"[24] host_fitness against _device_fitness: "
                             f"{err:.3g} > {HOST_DEVICE_TOL}")
    log(f"[24] the sweep's first chunk is K1's launch on to_dec + prep "
        f"(prepare_decode_params' tensors bit for bit); against the plain "
        f"twin {share:.4%} of rows identical, {n_diff} differ at near-ties; "
        f"host_fitness against the device scorer on the same tokens: max "
        f"|diff| {err:.3g} (<= {HOST_DEVICE_TOL})")
    shutil.rmtree(runs_dir)


def host_es_phase(card: str, data) -> None:
    """Phase 25: host-scored NIC-ES (experiments/mscoco_es.json with
    tpu.device_cider false, at its own size: 1000 offspring in chunks of
    16, batch 256, 5000 validation images, bf16): 2 plain generations, the
    fused path resolved off, K1 ceil(1000 / 16) x 2 times per generation;
    ms per generation and the host scoring's share."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_host_es_{os.getpid()}")
    exp = load_experiment("experiments/mscoco_es.json")
    exp["config"]["snapshot_freq"] = 100
    exp["tpu"]["device_cider"] = False
    exp["log_dir"] = runs_dir
    L, chunk, B = ES_SETTINGS[0], ES_SETTINGS[10], ES_SETTINGS[5]
    score_s = []
    m, fits, calls, _, counts = drive_es(exp, dev, data, 2, score_s)
    k1 = 2 * -(-L // chunk) * -(-B // 128)
    if m._fused_capable() or calls or counts != [k1, 4, 0, 0, 0, 0]:
        raise AssertionError(f"[25] fused {m._fused_capable()}, engine calls "
                             f"{calls}, launches (K1, row-block K1, K4, K3, "
                             f"K2, K5) {counts} != {[k1, 4, 0, 0, 0, 0]}")
    if len(fits) != 2 or not all(np.isfinite(f).all() for f in fits):
        raise AssertionError("[25] 2 finite fitness vectors expected")
    times = m.stats.time_stats()
    scored, rows = m.task.dedup_rows
    log(f"[25] ESMaster host-scored (experiments/mscoco_es.json, "
        f"tpu.device_cider false: {L} offspring in chunks of {chunk}, batch "
        f"{B}, 5000 val images, bf16): plain path only; ms per generation "
        f"{[round(t * 1e3, 3) for t in times]}, host scoring ms "
        f"{[round(t * 1e3, 3) for t in score_s]} ("
        f"{[round(s / t, 4) for s, t in zip(score_s, times)]} of each "
        f"generation; last: {scored} of {rows} rows scored by _score_dedup); "
        f"launches K1 {counts[0]}, row-block K1 {counts[1]}; best fitness "
        f"{[round(float(f.max()), 4) for f in fits]} ({card})")
    shutil.rmtree(runs_dir)


def norm_phase(card: str, data) -> None:
    """Phase 26: the vbn, vbn_e and layer_n captioners on the eager decoder
    (experiments/mscoco_nes.json cut as [10], f32): NESMaster with device
    scoring (the torch-order generation, validation on the card in blocks
    of 2) for NORM_ITERS iterations each, no decode kernel launched; one
    vbn iteration scored on the host; one chunk of 48 vbn members on the
    card against the CPU (tokens equal but where a member first differs at
    a near-tie, lp within EAGER_LP_TOL on the members that agree); one vbn
    iteration with SM-G-SUM over 64 rows; one vbn generation under
    torch.profiler."""
    import shutil

    import torch

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_norm_{os.getpid()}")
    runs = [(name, popts, mopts, {}, NORM_ITERS)
            for name, popts, mopts in NORM_VARIANTS]
    runs += [("vbn_host", {"vbn": True}, {}, {"device_cider": False}, 1),
             ("vbn_smg", {"vbn": True}, {"safe_mutations": "SM-G-SUM"},
              {"sensitivity_batch": 64}, 1)]
    masters = {}
    for name, popts, mopts, tpu, iters in runs:
        exp = nes_experiment(runs_dir, name, "f32", popts, mopts, **tpu)
        m, counts = drive_nes(exp, dev, data, iters)
        host = name == "vbn_host"
        if m.task._fused or m.task.fitness_on_device is host or any(counts):
            raise AssertionError(f"[26] {name}: fused {m.task._fused}, "
                                 f"device-scored {m.task.fitness_on_device},"
                                 f" decode launches {counts}")
        masters[name] = m
        log(f"[26] NESMaster {name} (experiments/mscoco_nes.json, "
            f"{BENCH['pairs']} pairs, batch {BENCH['batch']}, pop_chunk "
            f"{BENCH['pop_chunk']}, f32, eager decoder, "
            f"{'host' if host else 'device'} scoring"
            + (", SM-G-SUM over 64 rows" if name == "vbn_smg" else "")
            + f"; validation {'on the card' if m._val_fused else 'host'}):"
            f" {iters} iterations in {m.run_s:.1f} s, ms per iteration "
            f"{[round(t * 1e3, 3) for t in m.stats.time_stats()]}, mean "
            f"fitness {[round(f, 4) for f in m.stats.score_stats()[1]]}, val "
            f"CIDEr {[round(a, 4) for a in m.stats.acc_stats()]}; decode "
            f"kernels launched: none ({card})")

    # one chunk of vbn members: the card against the CPU
    m = masters["vbn"]
    task, P, B = m.task, BENCH["pop_chunk"], BENCH["batch"]
    seeds, batches = generation_inputs(task, 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    members = m.theta + 0.01 * torch.randn((2 * P, m.engine.dim),
                                           generator=gen, device=dev)
    feats = task.train_fc[torch.as_tensor(batches[0][:P], device=dev)
                          .repeat_interleave(2, 0)]
    (seq_c, lp_c), ms = events_ms(lambda: task.model.sample_members(
        members, feats))
    seq_h, lp_h = task.model.sample_members(members.cpu(), feats.cpu())
    seq_c, lp_c = seq_c.cpu(), lp_c.cpu()
    rows_same = (seq_c == seq_h).all(-1)
    found, member_same = check_member_near_ties(
        task.model, members.cpu(), feats.cpu(), seq_c, seq_h,
        "[26] vbn eager decode, card against CPU", EAGER_TIE_GAP,
        EAGER_MAX_FLIPPED)
    # lp on the members whose tokens all agree, and on each other member
    # up to its first difference
    err = float((lp_c - lp_h)[member_same].abs().max())
    for mi, t0, _ in found:
        if t0:
            err = max(err, float((lp_c[mi, :, :t0] - lp_h[mi, :, :t0])
                                 .abs().max()))
    if err > EAGER_LP_TOL:
        raise AssertionError(f"[26] vbn eager decode, card against CPU: lp "
                             f"error {err:.3g} > {EAGER_LP_TOL}")
    log(f"[26] vbn eager decode of {2 * P} members x {B} rows: card "
        f"{ms:.3f} ms (CUDA events); against the CPU "
        f"{float(rows_same.float().mean()):.4%} of rows and "
        f"{int(member_same.sum())} of {2 * P} members identical, each other "
        f"member first differing at a top-2 gap below {EAGER_TIE_GAP} (at "
        f"most {EAGER_MAX_FLIPPED} members); max |lp - CPU| {err:.3g} before "
        f"any difference (<= {EAGER_LP_TOL}) ({card})")
    wall, busy, rows = profile_call(lambda: m.engine.generation(
        m.theta, m.engine.optimizer.init(m.engine.dim, dev),
        torch.ones_like(m.theta), BENCH["sigma"], seeds[0], batches[0],
        BENCH["stepsize"], BENCH["l2coeff"]))
    log(f"[26] one vbn generation under torch.profiler: wall {wall:.3f} ms, "
        f"card busy {busy:.3f} ms ({busy / wall:.2%}; idle "
        f"{1 - busy / wall:.2%}) ({card})")
    for ms_, count, key in rows[:8]:
        log(f"    {ms_:10.3f} ms  x{count:<5d} {key[:90]}")
    shutil.rmtree(runs_dir)


# [27]: XENT pretraining at the CLI's lr 5e-4, batch 64 and seed 0 on the
# fixture's 2048 train images, for a sixth of the CLI's 3000 steps (the
# whole 3000 until [37] came, then 1500, then 1000 until [38]; cut to keep
# the smoke in its time limit on a slow host)
XENT_STEPS, XENT_LR, XENT_BATCH = 500, 5e-4, 64
# [27]: the card's loss within XENT_LOSS_RTOL of the CPU's, its gradient
# within XENT_GRAD_RTOL plus XENT_GRAD_ATOL x the CPU gradient's largest
# element (f32 sums in cuBLAS's order against the CPU's, TF32 off)
XENT_LOSS_RTOL, XENT_GRAD_RTOL, XENT_GRAD_ATOL = 1e-5, 1e-4, 1e-6
WARM_ITERS = 2
# [28]: the test split's images (the Karpathy test split's 5000)
TEST_ITEMS = 5000
# [28]: f32 rows may differ from the plain twin only where its top-2 logit
# gap is below this (the eager f32 decoder's bound, EAGER_TIE_GAP). lp over
# the row blocks whose tokens all agree: at XENT-trained weights the kernel
# and its plain twin, two f32 decodes that sum their products in other
# orders, drift apart by more than the f32 parity bar LP_F32_TOL (H100
# runs: 5.05e-5 over 5000 rows, where the kernel is 4.13e-5 from an f64
# replay of the same tokens and the twin 2.23e-5). So the kernel is held to
# the f64 replay: at most LP_F32_FACTOR times the twin's distance from it,
# plus LP_F32_TOL; a wrong block, weight or step moves lp by far more. The
# bar itself is the rule (ROADMAP, ground rules): at such weights the JAX
# package's own XLA f32 greedy decode is 2.35e-5 from an f64 replay of its
# tokens on the CPU (tests/f64_lp_replay.py: 1024 test rows, 3000 XENT
# steps at this fixture's shape), past 2e-5 as well; lp_drift_terms names
# the term that drifts
F32_TIE_GAP = 1e-4
LP_F32_TOL, LP_F32_FACTOR = 2e-5, 2.0
# [29]: NESMaster iterations with tpu.profile (blocks of 2: generations 1-2
# are traced, 3 is not)
PROFILE_ITERS, PROFILE_TRACED = 3, 2
# [30]: dump_all_sensitivities' batches of SENS_DUMP_BATCH rows over the
# first SENS_DUMP_ROWS train images, SM-G-SUM at split 400
SENS_DUMP_BATCH, SENS_DUMP_ROWS, SENS_DUMP_SPLIT = 64, 256, 400


def fixture_digest(arrays: dict, n_images: int) -> str:
    """SHA-256 of the first ``n_images`` images' arrays (features, labels,
    caption ranges, ids, split and file entries): the train and val part of
    a fixture drawn in split order."""
    import hashlib

    h = hashlib.sha256()
    n_rows = int(arrays["label_end_ix"][n_images - 1])
    for a in (arrays["feats"][:n_images], arrays["labels"][:n_rows],
              arrays["label_start_ix"][:n_images],
              arrays["label_end_ix"][:n_images], arrays["ids"][:n_images]):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps(arrays["info"]["images"][:n_images]).encode())
    h.update(json.dumps(arrays["info"]["ix_to_word"]).encode())
    return h.hexdigest()


def greedy_lp_f64(task, theta, feats, seq):
    """The greedy lp (N, T) of one flat theta on feats (N, F), replayed in
    f64 along the tokens ``seq`` (N, T): each step's largest logprob, the
    next step fed the row's token (0 after its EOS, as the kernels do)."""
    import torch

    model = task.model
    p = model.spec.unravel(theta.double())
    with torch.no_grad():
        h = c = torch.zeros((feats.shape[0], model.options.rnn_size),
                            dtype=torch.float64, device=feats.device)
        _, h, c = model.lstm_core(p, model._img_embed(p, feats.double()), h,
                                  c)
        it = torch.zeros(feats.shape[0], dtype=torch.long,
                         device=feats.device)
        lps = []
        for t in range(seq.shape[-1]):
            out, h, c = model.lstm_core(p, model._embed(p, it), h, c)
            lps.append(model._logprobs(p, out).max(-1).values)
            it = seq[:, t].long()
    return torch.stack(lps, -1)


def lp_drift_terms(task, theta, params, feats_row, seq_row, t: int) -> dict:
    """One row of an f32 greedy decode replayed op by op: |lp - lp64| at
    step t of each f32 term alone, the rest in f64 along the row's tokens
    seq_row (T,): the recurrence (the f32 LSTM's h, then an f64 head); the
    logit products on the f64 replay's h rounded to f32, in cuBLAS's order
    and as one chain over k in increasing order (the kernels' FMA order,
    emulated with addcmul), each followed by an f64 logsumexp; and an f32
    logsumexp of the f64 logits rounded to f32. Then the whole row in f32
    with every product in the kernels' order (``kernel_order``: x_t's chain
    from 0, + i2h_b, h's chain on, + h2h_b; the logits' chain, + logit_b;
    an f64 logsumexp), returned with its lp (``kernel_order_lp``) to set
    beside the kernel's. params: the f32 decode params the decode ran
    on."""
    import torch

    model = task.model
    dev = feats_row.device
    R = model.options.rnn_size

    def replay(dtype):
        p = model.spec.unravel(theta.to(dtype))
        h = c = torch.zeros((1, R), dtype=dtype, device=dev)
        _, h, c = model.lstm_core(
            p, model._img_embed(p, feats_row[None].to(dtype)), h, c)
        it = torch.zeros(1, dtype=torch.long, device=dev)
        for s in range(t + 1):
            out, h, c = model.lstm_core(p, model._embed(p, it), h, c)
            it = seq_row[s:s + 1].long()
        return out[0]

    def lp64(z):
        z = z.double()
        return z.max() - torch.logsumexp(z, 0)

    def chain(acc, x, w):
        # acc + x @ w as one f32 chain over k in increasing order
        for k in range(x.shape[0]):
            acc = torch.addcmul(acc, x[k:k + 1], w[k])
        return acc

    def kernel_order():
        g = {k: v[0] if v.dim() == 3 else v for k, v in params.items()}
        zero = torch.zeros(5 * R, device=dev)
        h = c = torch.zeros(R, device=dev)
        x = chain(torch.zeros(R, device=dev), feats_row.float(), g["img_w"]) \
            + g["img_b"][0]
        for s in range(t + 2):
            if s:
                x = g["embed"][int(seq_row[s - 2]) if s > 1 else 0]
            a = chain(chain(zero, x, g["i2h_w"]) + g["i2h_b"][0], h,
                      g["h2h_w"]) + g["h2h_b"][0]
            gate = torch.sigmoid(a[:3 * R])
            cand = torch.maximum(a[3 * R:4 * R], a[4 * R:])
            c = torch.addcmul(gate[:R] * cand, gate[R:2 * R], c)
            h = gate[2 * R:] * torch.tanh(c)
        z = chain(torch.zeros_like(g["logit_b"][0]), h, g["logit_w"]) \
            + g["logit_b"][0]
        return lp64(z)

    with torch.no_grad():
        w, b = params["logit_w"], params["logit_b"][0]
        h64, h32 = replay(torch.float64), replay(torch.float32)
        z64 = h64 @ w.double() + b.double()
        ref = lp64(z64)
        hf = h64.float()
        acc = chain(torch.zeros_like(b), hf, w)
        z32 = z64.float()
        lp_order = kernel_order()
        return {
            "recurrence": float((lp64(h32.double() @ w.double()
                                      + b.double()) - ref).abs()),
            "products_cublas": float((lp64(hf @ w + b) - ref).abs()),
            "products_k_chain": float((lp64(acc + b) - ref).abs()),
            "logsumexp_f32": float(((z32.max() - torch.logsumexp(z32, 0))
                                    .double() - lp64(z32)).abs()),
            "kernel_order": float((lp_order - ref).abs()),
            "kernel_order_lp": float(lp_order),
        }


def greedy_regime(task, theta, seeds, batches) -> dict:
    """One greedy generation's decode at theta (the bench's 144 pairs, bf16
    deltas of sigma 0.01 from the pairs' seeds, K1 per chunk of 48 members):
    the share of rows that emit EOS, K1's executed steps per member (mean
    and max) and the share of rows ``_score_dedup`` scores on the host."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    lay, T = task.decode_layout, task.model.options.seq_length
    P, B = BENCH["pop_chunk"], BENCH["batch"]
    base = lay.to_dec(theta)
    scale = lay.to_dec(torch.full_like(theta, BENCH["sigma"]), pad_scale=0.0)
    seqs, steps = [], []
    for lo in range(0, BENCH["pairs"], P):
        deltas = torch.stack([(scale * torch.randn(
            lay.dim_dec, device=theta.device, generator=torch.Generator(
                device=theta.device).manual_seed(int(s)))).to(torch.bfloat16)
            for s in seeds[lo:lo + P]])
        members = torch.stack([base + deltas, base - deltas], 1).reshape(
            2 * P, -1)
        idx = torch.as_tensor(batches[lo:lo + P], device=theta.device)
        seq, _ = dc.decode_fused(lay.prep(members, torch.bfloat16),
                                 task.train_fc[idx.repeat_interleave(2, 0)],
                                 T, False)
        seqs.append(seq)
        steps.append(executed_steps(seq, T))
    seq = torch.cat(seqs)                                  # (2F, B, T)
    steps = torch.cat(steps).float()
    img = np.repeat(np.asarray(batches), 2, axis=0).reshape(-1)
    task._score_dedup(seq.reshape(-1, T).cpu().numpy(), img)
    scored, rows = task.dedup_rows
    return {"eos_share": float((seq == 0).any(-1).float().mean()),
            "steps_mean": float(steps.mean()), "steps_max": int(steps.max()),
            "dedup_share": scored / rows}


def xent_phase(card: str, data) -> dict:
    """Phase 27: XENT pretraining at full width (vocab 9487, F = 2048, E =
    R = 128) on the fixture's 2048 train images, TF32 off: xent_loss and
    its gradient on the card against the CPU at the reference's init on
    one batch; pretrain_xent for XENT_STEPS steps (ms per step by CUDA
    events, the train split's loss and the val CIDEr of 256 images before
    and after: the loss falls, CIDEr rises), one step profiled;
    spec.save_pth, then an NESMaster of experiments/mscoco_nes.json cut as
    [10] (kernel noise, blocks of 2) with from_single at that file for
    WARM_ITERS iterations:
    its theta is the saved one bit for bit and validates at the pretrained
    CIDEr; the trained regime against random init (greedy_regime). Returns
    the thetas, their files and the task."""
    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.data.core import EpochSampler
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.pretrain import (
        pretrain_xent,
        xent_loss,
    )
    from nes_img_captioning_tpu_torch.tasks import make_task
    from nes_img_captioning_tpu_torch.utils.config import (
        parse_config,
        parse_tpu_config,
    )

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_xent_{os.getpid()}")
    exp = nes_experiment(runs_dir, "xent", "bf16")
    task = make_task(exp, parse_config(exp), parse_tpu_config(exp),
                     device=dev, data=data)
    caps = torch.as_tensor(np.stack([np.asarray(g[0], np.int32)
                                     for g in task.train_gts]), device=dev)
    theta0 = task.generate_theta(torch.Generator(device=dev).manual_seed(0))

    # the card's loss and gradient against the CPU's on one batch
    idx = torch.as_tensor(EpochSampler(task.train_n, seed=1).batch(
        XENT_BATCH), device=dev)
    grads = {}
    for where in ("cuda", "cpu"):
        th = theta0.to(where).clone().requires_grad_()
        loss = xent_loss(task.model, th, task.train_fc[idx].to(where),
                         caps[idx].to(where))
        loss.backward()
        grads[where] = (loss.item(), th.grad.cpu())
    (l_card, g_card), (l_cpu, g_cpu) = grads["cuda"], grads["cpu"]
    g_err = (g_card - g_cpu).abs()
    g_tol = XENT_GRAD_RTOL * g_cpu.abs() + XENT_GRAD_ATOL * float(
        g_cpu.abs().max())
    if abs(l_card - l_cpu) > XENT_LOSS_RTOL * abs(l_cpu) or \
            bool((g_err > g_tol).any()):
        raise AssertionError(
            f"[27] xent_loss card {l_card!r} against CPU {l_cpu!r}, or "
            f"{int((g_err > g_tol).sum())} gradient elements past rtol "
            f"{XENT_GRAD_RTOL} + {XENT_GRAD_ATOL} x max")
    log(f"[27] xent_loss on {XENT_BATCH} images at the reference's init: "
        f"card {l_card:.7f}, CPU {l_cpu:.7f} (|diff| "
        f"{abs(l_card - l_cpu):.3g}); gradient max |card - CPU| "
        f"{float(g_err.max()):.3g} of max |g| {float(g_cpu.abs().max()):.3g}"
        f", all within rtol {XENT_GRAD_RTOL} + {XENT_GRAD_ATOL} x max")

    def split_loss(theta):
        with torch.no_grad():
            return xent_loss(task.model, theta, task.train_fc, caps).item()

    loss0, cider0 = split_loss(theta0), task.validate(theta0)
    counters = (dc.decode_rows, dc.decode_fused, dc.decode_pair_rng,
                dc.pair_grad_rng)
    for c in counters:
        c.launches = 0
    theta1, train_ms = events_ms(lambda: pretrain_xent(
        task, steps=XENT_STEPS, lr=XENT_LR, batch_size=XENT_BATCH, seed=0,
        log_every=XENT_STEPS // 10, theta0=theta0))
    loss1, cider1 = split_loss(theta1), task.validate(theta1)
    rows_k1 = dc.decode_rows.launches
    if not (loss1 < loss0 and cider1 > cider0) or rows_k1 != 1:
        raise AssertionError(
            f"[27] XENT: train-split loss {loss0:.4f} -> {loss1:.4f}, val "
            f"CIDEr {cider0:.4f} -> {cider1:.4f} (both should improve); "
            f"row-block K1 launches {rows_k1} != 1")
    log(f"[27] pretrain_xent, {XENT_STEPS} steps of batch {XENT_BATCH} at "
        f"lr {XENT_LR}: {train_ms:.1f} ms, {train_ms / XENT_STEPS:.3f} ms per "
        f"step (CUDA events); train-split loss {loss0:.4f} -> {loss1:.4f}; "
        f"val CIDEr (256 images, bf16 row-block K1, one launch each) "
        f"{cider0:.4f} -> {cider1:.4f} ({card})")

    wall, busy, rows = profile_call(lambda: pretrain_xent(
        task, steps=1, lr=XENT_LR, batch_size=XENT_BATCH, log_every=0,
        theta0=theta1))
    log(f"[27] one XENT step under torch.profiler: wall {wall:.3f} ms, card "
        f"busy {busy:.3f} ms ({busy / wall:.2%}; idle {1 - busy / wall:.2%}),"
        f" {sum(r[1] for r in rows)} kernels ({card})")
    for ms_, count, key in rows[:5]:
        log(f"    {ms_:10.3f} ms  x{count:<5d} {key[:90]}")

    os.makedirs(runs_dir, exist_ok=True)
    paths = {"random": os.path.join(runs_dir, "random.pth"),
             "xent": os.path.join(runs_dir, "xent.pth")}
    task.spec.save_pth(theta0, paths["random"])
    task.spec.save_pth(theta1, paths["xent"])
    warm = nes_experiment(runs_dir, "warm", "bf16", kernel_noise=True,
                          gens_per_dispatch=2)
    warm["from_single"] = paths["xent"]
    m = NESMaster(warm, device=dev, data=data)
    if not torch.equal(m.theta.view(torch.int32),
                       theta1.view(torch.int32)):
        raise AssertionError("[27] from_single: the loaded theta is not the "
                             "saved one bit for bit")
    if m.task.validate(m.theta) != cider1:
        raise AssertionError("[27] from_single: the loaded theta does not "
                             "validate at the pretrained CIDEr")
    for c in counters:
        c.launches = 0
    m.run_master(max_iterations=WARM_ITERS)
    torch.cuda.synchronize()
    acc = m.stats.acc_stats()
    counts = [c.launches for c in counters]
    n_chunks = -(-BENCH["pairs"] // BENCH["pop_chunk"])
    if len(acc) != WARM_ITERS or not acc[0] > cider0 or counts != [
            WARM_ITERS, 0, n_chunks * WARM_ITERS, WARM_ITERS]:
        raise AssertionError(f"[27] warm start: val CIDEr {acc} (random "
                             f"init {cider0:.4f}); launches (row-block K1, "
                             f"K1, K5, K6) {counts}")
    log(f"[27] NESMaster from_single {os.path.basename(paths['xent'])} "
        f"(experiments/mscoco_nes.json cut as [10], kernel noise, blocks of "
        f"2): theta loaded bit for bit, validates at {cider1:.4f}; "
        f"{WARM_ITERS} iterations, val CIDEr {[round(a, 4) for a in acc]} "
        f"(random init {cider0:.4f}), mean fitness "
        f"{[round(f, 4) for f in m.stats.score_stats()[1]]}, ms per "
        f"iteration {[round(t * 1e3, 3) for t in m.stats.time_stats()]}; "
        f"launches row-block K1 {counts[0]}, K5 {counts[2]}, K6 {counts[3]}"
        f" ({card})")
    seeds, batches = generation_inputs(task, 1)
    for name, theta in (("random init", theta0), ("XENT", theta1)):
        r = greedy_regime(task, theta, seeds[0], batches[0])
        log(f"[27] trained regime, {name}: one greedy generation's "
            f"{2 * BENCH['pairs']} members x {BENCH['batch']} rows (bf16, K1 "
            f"per chunk of {2 * BENCH['pop_chunk']}): {r['eos_share']:.2%} "
            f"of rows emit EOS; K1's executed steps per member mean "
            f"{r['steps_mean']:.2f}, max {r['steps_max']} of 16; "
            f"_score_dedup scores {r['dedup_share']:.2%} of the rows")
    return {"task": task, "theta0": theta0, "theta1": theta1,
            "paths": paths, "runs_dir": runs_dir, "cider": (cider0, cider1)}


def test_eval_phase(card: str, data, xent: dict) -> list:
    """Phase 28: evaluate_checkpoints on the random-init and XENT
    checkpoints over the fixture's TEST_ITEMS test images at f32 (one
    row-block launch of K1 per checkpoint); that launch against
    decode_rows_plain on the XENT theta (tokens equal but at near-ties of
    the plain twin, F32_TIE_GAP; over agreeing row blocks lp within
    LP_F32_FACTOR x the twin's distance from an f64 replay + LP_F32_TOL)
    and its captions in the output; test_score on [27]'s bf16 task equal to
    language_eval's CIDEr step on the same tokens; the decode's time beside
    its plain twin, cuBLAS and its bound, and each metric's seconds."""
    import torch

    from nes_img_captioning_tpu_torch.eval_on_test import evaluate_checkpoints
    from nes_img_captioning_tpu_torch.fitness.lang_metrics import (
        corpus_bleu,
        rouge_l,
    )
    from nes_img_captioning_tpu_torch.fitness.meteor import meteor_corpus
    from nes_img_captioning_tpu_torch.fitness.scorer import IndexedCiderScorer
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    dev = torch.device("cuda")
    task, theta = xent["task"], xent["theta1"]
    T, Fd = task.model.options.seq_length, task.model.options.fc_feat_size
    feats = task.test_fc
    if feats.shape[0] != TEST_ITEMS:
        raise AssertionError(f"[28] {feats.shape[0]} test images")
    dc.decode_rows.launches = 0
    t0 = time.perf_counter()
    o = task.model.options
    out = evaluate_checkpoints(
        xent["paths"], {}, num=TEST_ITEMS, data=data, device=dev,
        input_encoding_size=o.input_encoding_size, rnn_size=o.rnn_size,
        fc_feat_size=o.fc_feat_size)
    eval_s = time.perf_counter() - t0
    launches = dc.decode_rows.launches
    if launches != len(xent["paths"]):
        raise AssertionError(f"[28] evaluate_checkpoints: {launches} "
                             "row-block launches, one per checkpoint "
                             "expected")
    params = dc.prepare_decode_params(task.spec, theta, task.model.options,
                                      dtype=torch.float32)
    seq_k, lp_k = dc.decode_rows(params, feats, T, True)
    seq_p, lp_p, gap_p = dc.decode_rows_plain(params, feats, T, True,
                                              top2_gap=True)
    torch.cuda.synchronize()
    share, n_diff = check_near_ties(seq_k, seq_p, gap_p,
                                    "[28] decode_rows f32", F32_TIE_GAP)
    same = (seq_k == seq_p).all(-1)
    block = torch.arange(TEST_ITEMS, device=dev) // 128
    keep = ~torch.isin(block, block[~same])
    err = float((lp_k - lp_p)[keep].abs().max())
    # both f32 decodes against an f64 replay of the same tokens
    lp64 = greedy_lp_f64(task, theta, feats, seq_k)
    steps = torch.cat([executed_steps(seq_k[None, lo:lo + 128], T)
                       for lo in range(0, TEST_ITEMS, 128)])
    alive = (torch.arange(T, device=dev) < steps[block][:, None]) \
        & keep[:, None]
    err_k = float((lp_k.double() - lp64).abs()[alive].max())
    err_p = float((lp_p.double() - lp64).abs()[alive].max())
    if err_k > LP_F32_FACTOR * err_p + LP_F32_TOL:
        raise AssertionError(
            f"[28] decode_rows f32: max |lp - f64 replay| {err_k:.3g}, the "
            f"plain twin's {err_p:.3g} (at most {LP_F32_FACTOR} x it + "
            f"{LP_F32_TOL}); max |lp - plain| {err:.3g}")
    # F6: the row and step where the kernel is farthest from the replay,
    # taken apart term by term
    dist = torch.where(alive, (lp_k.double() - lp64).abs(), -1.0)
    r_w, t_w = divmod(int(dist.argmax()), T)
    terms = lp_drift_terms(task, theta, params, feats[r_w], seq_k[r_w], t_w)
    order_lp = terms.pop("kernel_order_lp")
    order = terms.pop("kernel_order")
    log(f"[28] F6: row {r_w}, step {t_w}: kernel |lp - f64| "
        f"{float(dist[r_w, t_w]):.3g}, plain twin "
        f"{float((lp_p[r_w, t_w].double() - lp64[r_w, t_w]).abs()):.3g}; "
        f"each f32 term alone (the rest f64): "
        + ", ".join(f"{k} {v:.3g}" for k, v in terms.items())
        + f"; the largest: {max(terms, key=terms.get)}; the row in f32 with "
        f"every product in the kernels' order: |lp - f64| {order:.3g}, "
        f"|lp - kernel| {abs(order_lp - float(lp_k[r_w, t_w])):.3g} "
        f"({card})")
    if [p["caption"] for p in out["preds_per_model"]["xent"]] != \
            data.decode_sequence(seq_k.cpu().numpy()):
        raise AssertionError("[28] evaluate_checkpoints' captions are not "
                             "the row-block launch's tokens")
    stats = out["stats"]
    for name, s in stats.items():
        if not all(np.isfinite(s[k]) for k in (
                "Bleu_1", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR")):
            raise AssertionError(f"[28] {name}: non-finite metrics {s}")
        log(f"[28] {name} checkpoint on {TEST_ITEMS} test images (f32): "
            + ", ".join(f"{k} {s[k]:.4f}" for k in (
                "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr",
                "METEOR")))
    if not stats["xent"]["CIDEr"] > stats["random"]["CIDEr"]:
        raise AssertionError("[28] the XENT checkpoint's test CIDEr is not "
                             "above random init's")

    # test_score on the bf16 task: language_eval's CIDEr step on its tokens
    score = task.test_score(theta)
    seq16 = task._decode_split(theta, task.test_fc, -1)
    gts = data.split_gts("test")
    ref_wids = [data.word_id_rows(g) for g in gts]
    same_scorer = IndexedCiderScorer(ref_wids, variant="cider").score(
        data.word_id_rows(seq16), np.arange(TEST_ITEMS))[0]
    with open(os.path.join(xent["runs_dir"], "xent", "eval",
                           "eval_cache_test.json")) as f:
        n_preds = len(json.load(f))
    if score != same_scorer or n_preds != TEST_ITEMS:
        raise AssertionError(f"[28] test_score {score!r} against "
                             f"language_eval's CIDEr {same_scorer!r}, "
                             f"{n_preds} predictions written")
    log(f"[28] test_score (bf16 task, one row-block launch): {score:.6f}, "
        f"equal to language_eval's CIDEr on the same tokens; the f32 "
        f"evaluation's CIDEr {stats['xent']['CIDEr']:.6f}; "
        f"eval_cache_test.json holds {n_preds} captions")

    # times: the decode, and each metric on the XENT captions
    wids = data.word_id_rows(seq_k.cpu().numpy())
    secs = {}
    for name, fn in (
            ("BLEU", lambda: corpus_bleu(wids, ref_wids)),
            ("ROUGE-L", lambda: rouge_l(wids, ref_wids)),
            ("CIDEr", lambda: IndexedCiderScorer(
                ref_wids, variant="cider").score(wids,
                                                 np.arange(TEST_ITEMS))),
            ("METEOR", lambda: meteor_corpus(wids, ref_wids,
                                             data.word_stem_of))):
        t0 = time.perf_counter()
        fn()
        secs[name] = time.perf_counter() - t0
    k1_ms = time_ms(lambda: dc.decode_rows(params, feats, T, False))
    plain_ms = time_ms(lambda: dc.decode_rows_plain(params, feats, T, False),
                       reps=1)

    # f32 products, TF32 off
    lib_ms = time_ms(lambda: cublas_decode(feats, params, T))
    # the f32 kernel's products run on the FMA pipes, not the tensor cores
    flops = rows_flops(seq_k, Fd, task.model.options.vocab_size + 1)
    nbytes = sum(v.numel() * v.element_size() for v in params.values()) \
        + feats.numel() * 4 + seq_k.numel() * 8
    b_ms, b_by = regime_bound(nbytes, f32_ops=flops)[:2]
    n_blocks = -(-TEST_ITEMS // 128)
    log(f"[28] decode_rows f32 over {TEST_ITEMS} test rows: {k1_ms:.3f} ms, "
        f"{2 * n_blocks} CTAs (plain twin {plain_ms:.3f} ms, cuBLAS f32 "
        f"products {lib_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{flops / 1e9:.1f} GFLOP at the f32 rate, {nbytes / 1e6:.1f} MB, "
        f"{b_ms / k1_ms:.1%} of it); against the plain twin {share:.4%} of "
        f"rows identical, {n_diff} differ at near-ties (top-2 gap < "
        f"{F32_TIE_GAP}), max |lp - plain| {err:.3g} over {int(keep.sum())} "
        f"rows of agreeing blocks; max |lp - f64 replay| kernel {err_k:.3g}, "
        f"plain twin {err_p:.3g} ({card})")
    log(f"[28] evaluate_checkpoints, 2 checkpoints x {TEST_ITEMS} images: "
        f"{eval_s:.1f} s; on one checkpoint's captions (host, pure Python "
        f"but CIDEr's native scorer): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    return [{
        "name": "decode_rows_test_f32", "route": "cuda",
        "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
        "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py:658",
        "launches": launches, "max_abs_err": err, "ms": k1_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "rows": TEST_ITEMS,
        "ctas_per_launch": 2 * n_blocks, "metric_s": secs,
        "evaluate_checkpoints_s": eval_s,
    }]


def profile_phase() -> None:
    """Phase 29 in a process of its own (``chip_smoke.py --profile-phase``,
    ``profile_main``), as a run that profiles its generation 2 is: in this
    process, minutes and several profiler sessions in, the card's and the
    host's clocks in the trace drift apart (one H100 run: kernels starting
    up to 3.632 ms before their launch calls) and the records of the traced
    window's first 17 kernels were missing; in a fresh process 24 of 24
    such traces were complete."""
    import torch

    torch.cuda.empty_cache()  # this process's cached blocks, for the other
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--profile-phase"], capture_output=True, text=True,
                         timeout=600)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        raise AssertionError(f"[29] exited {out.returncode}: "
                             f"{out.stderr[-4000:]}")


def profile_main() -> int:
    """The process of phase 29: the fixture, then ``profile_run``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile_run(nvidia_smi(), val_fixture("[29]"))
    return 0


def profile_run(card: str, data) -> None:
    """Phase 29: NESMaster as in [10] (kernel noise, blocks of 2) with
    tpu.profile for PROFILE_ITERS iterations: the trace of the block that
    runs generation 2 lands under <log_dir>/profile/, and
    utils/profile_summary lists K5 (its draw and its pair decode), K6 and
    the row-block K1 with counts equal to the launch counters' share of the
    traced generations, every launch with its kernel's record; its idle
    share."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.utils import profile_summary

    dev = torch.device("cuda")
    runs_dir = os.path.join("logs", f"chip_smoke_profile_{os.getpid()}")
    exp = nes_experiment(runs_dir, "profile", "bf16", kernel_noise=True,
                         gens_per_dispatch=2, profile=True)
    counters = (dc.decode_pair_rng, dc.pair_grad_rng, dc.decode_rows,
                dc.decode_fused, dc.decode_pair_perturb)
    m = NESMaster(exp, device=dev, data=data)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    m.run_master(max_iterations=PROFILE_ITERS)
    torch.cuda.synchronize()
    counts = [c.launches for c in counters]
    trace = profile_summary.find_trace(exp["log_dir"])
    out = profile_summary.summarize(trace)

    def traced(word):
        return sum(n for name, _, n in out["rows"] if word in name)

    got = {"K5 decode (pair_kernel)": traced("pair_kernel"),
           "K5 draw (pair_delta_dump_kernel)":
               traced("pair_delta_dump_kernel"),
           "K6 (pair_grad_rng_kernel)": traced("pair_grad_rng_kernel"),
           "row-block K1 (member_kernel)": traced("member_kernel")}
    want = [c * PROFILE_TRACED // PROFILE_ITERS for c in counts[:3]]
    if counts[3:] != [0, 0] or min(counts[:3]) == 0 or list(
            got.values()) != [want[0], want[0], want[1], want[2]] or \
            out["unmatched_launches"]:
        raise AssertionError(
            f"[29] traced kernels {got}; launches over {PROFILE_ITERS} "
            f"iterations (K5, K6, row-block K1, K1, K2) {counts}; "
            f"launches without a kernel record {out['unmatched_launches']}; "
            f"the trace's rows "
            f"{[(n[:60], c) for n, _, c in out['rows'][:12]]}")
    log(f"[29] tpu.profile: {os.path.relpath(trace, runs_dir)}, generations "
        f"1-{PROFILE_TRACED} of {PROFILE_ITERS} traced; profile_summary: "
        + ", ".join(f"{k} x{v}" for k, v in got.items())
        + f" (launch counters over the run: K5 {counts[0]}, K6 {counts[1]}, "
        f"row-block K1 {counts[2]}), every launch with its kernel's record; "
        f"window {out['window_ms']:.3f} ms, card busy {out['busy_ms']:.3f} "
        f"ms, idle {out['idle']:.2%} ({card})")
    for name, ms, n in out["rows"][:6]:
        log(f"    {ms:10.3f} ms  x{n:<5d} {name[:90]}")
    shutil.rmtree(runs_dir)


def sens_dump_phase(card: str, data, xent: dict) -> None:
    """Phase 30: dump_all_sensitivities (SM-G-SUM, split SENS_DUMP_SPLIT,
    f32) on [27]'s XENT theta over the first SENS_DUMP_ROWS train images in
    batches of SENS_DUMP_BATCH: each file loads through
    load_sensitivity_file and equals calc_sensitivity on its batch's rows
    bit for bit; the share of entries above the clamp beside random
    init's."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivity,
        dump_all_sensitivities,
        load_sensitivity_file,
    )

    class FirstRows:
        """The task over its first ``n`` train images."""

        def __init__(self, task, n):
            self._task, self.train_n = task, n

        def __getattr__(self, name):
            return getattr(self._task, name)

    dev = torch.device("cuda")
    task = FirstRows(bench_task(dev, data=data, device_cider=False,
                                sensitivity_split=SENS_DUMP_SPLIT),
                     SENS_DUMP_ROWS)
    kind = MutationKind.SAFE_GRAD_SUM
    out_dir = os.path.join(xent["runs_dir"], "sens")
    paths, ms = events_ms(lambda: dump_all_sensitivities(
        task, xent["theta1"], SENS_DUMP_BATCH, out_dir, kind))
    order = np.random.default_rng(0).permutation(SENS_DUMP_ROWS)
    n_batches = SENS_DUMP_ROWS // SENS_DUMP_BATCH
    if len(paths) != n_batches:
        raise AssertionError(f"[30] {len(paths)} files")
    shares = []
    for i, path in enumerate(paths):
        idx = torch.as_tensor(order[i * SENS_DUMP_BATCH:
                                    (i + 1) * SENS_DUMP_BATCH], device=dev)
        want = calc_sensitivity(task, xent["theta1"], idx, kind, 0.01).cpu()
        got = torch.from_numpy(load_sensitivity_file(path))
        if not (os.path.basename(path).startswith(f"sens_t{i}_p0_") and
                torch.equal(got.view(torch.int32), want.view(torch.int32))):
            raise AssertionError(f"[30] {path}: not calc_sensitivity's "
                                 "row bit for bit")
        shares.append(float((got > 1).float().mean()))
    idx = torch.as_tensor(order[:SENS_DUMP_BATCH], device=dev)
    share0 = float((calc_sensitivity(task, xent["theta0"], idx, kind, 0.01)
                    > 1).float().mean())
    log(f"[30] dump_all_sensitivities (SM-G-SUM, split {SENS_DUMP_SPLIT}, "
        f"f32) on the XENT theta: {n_batches} files of "
        f"{task.spec.num_params:,} in {ms:.1f} ms (CUDA events, the file "
        f"writes included), each "
        f"calc_sensitivity's row bit for bit; entries above the 0.01 clamp "
        f"{[round(s, 4) for s in shares]} (random init, first batch: "
        f"{share0:.4f}) ({card})")
    shutil.rmtree(out_dir)


# [31]: ES generations per path with the decode layout: the blocked path runs
# generation 1 plain, 2 fused and 3-4 as one block (snapshot_freq 4)
LAYOUT_ITERS = 4
LAYOUT_CONFIGS = ("mscoco_es", "mscoco_es_smg_fast")
# [31]: (nb_offspring, pop_chunk, batch_size) of both ES files
LAYOUT_SHAPE = (1000, 16, 256)
# [32]: NES iterations of each process; a rank process's time limit (s),
# and its collectives' (each half of it)
M16_NES_ITERS = 3
RANK_TIMEOUT = 600
# the Statistics series that hold no clock or memory reading
LOCKSTEP_KEYS = ("score_stats", "acc_stats", "best_acc_so_far_stats",
                 "norm_stats", "noise_std_stats", "bs_stats", "score_stds",
                 "update_ratio_stats")


def layout_experiment(cfg: str, name: str, runs_dir: str, **tpu) -> dict:
    """experiments/{cfg}.json as it is, with tpu.es_decode_layout true,
    snapshots every LAYOUT_ITERS generations and ``tpu``'s knobs."""
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    exp = load_experiment(f"experiments/{cfg}.json")
    shape = (exp["nb_offspring"], exp["tpu"]["pop_chunk"],
             exp["config"]["batch_size"])
    if shape != LAYOUT_SHAPE:
        raise AssertionError(f"[31] {cfg}.json changed: {shape}")
    exp["config"]["snapshot_freq"] = LAYOUT_ITERS
    exp["tpu"].update(es_decode_layout=True, **tpu)
    exp["log_dir"] = os.path.join(runs_dir, cfg, name)
    return exp


LAYOUT_PATHS = (("plain", {"fused_es": False}),
                ("fused", {"gens_per_dispatch": 1}), ("blocked", {}))


def es_layout_phase(card: str, data):
    """Phase 31: NIC-ES children built in decode order (M13b) at full
    width. experiments/mscoco_es.json, then mscoco_es_smg_fast.json, with
    tpu.es_decode_layout true on the plain, fused and blocked paths,
    LAYOUT_ITERS generations each (``drive_es``): fitness vectors,
    children, podium rows and mean|policy| bit for bit across the paths;
    K1 launched ceil(1000 / 16) x 2 times per generation; ``to_dec`` lays
    out offspring chunks in generation 1 only (fresh inits, in torch
    order), never after it. Then on the blocked run's parents: the layout
    sweep's fitnesses bit for bit those of ``task.rollout`` fed the same
    children mapped back by ``from_dec``; ms of a fused generation with the
    layout on and off (A B B A, host clock ending in synchronize) and its
    copies under torch.profiler; K1 on decode-ordered children against its
    plain twin (mscoco_es.json). Returns (its row of the kernels line,
    mscoco_es.json's runs on the host, for phase 32)."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    runs_dir = os.path.join("logs", f"chip_smoke_layout_{os.getpid()}")
    L, chunk, B = LAYOUT_SHAPE
    k1_per_gen = -(-L // chunk) * -(-B // 128)
    to_dec, laid = DecodeLayout.to_dec, []

    def counted(self, flat, pad_scale=1.0):
        laid.append(flat.shape[0] if flat.dim() > 1 else 1)
        return to_dec(self, flat, pad_scale)

    rows, ref = [], None
    DecodeLayout.to_dec = counted
    try:
        for cfg in LAYOUT_CONFIGS:
            runs = {}
            for name, tpu in LAYOUT_PATHS:
                laid.clear()
                m, fits, calls, _, counts = drive_es(
                    layout_experiment(cfg, name, runs_dir, **tpu), dev, data,
                    LAYOUT_ITERS)
                if m.engine._layout is None:
                    raise AssertionError(f"[31] {cfg} {name}: no layout")
                want = [LAYOUT_ITERS * k1_per_gen,
                        2 * LAYOUT_ITERS + (2 if name != "plain" else 0),
                        0, 0, 0, 0]
                want_calls = {
                    "plain": [],
                    "fused": ["fused_generation"] * (LAYOUT_ITERS - 1),
                    "blocked": ["fused_generation", "fused_block"]}[name]
                chunks = laid.count(chunk)
                if counts != want or calls != want_calls \
                        or len(fits) != LAYOUT_ITERS \
                        or chunks != -(-L // chunk):
                    raise AssertionError(
                        f"[31] {cfg} {name}: launches (K1, row-block K1, K4, "
                        f"K3, K2, K5) {counts}, engine calls {calls}, "
                        f"{len(fits)} fitness vectors, {chunks} to_dec calls "
                        "of a chunk")
                if not all(np.isfinite(f).all() for f in fits):
                    raise AssertionError(f"[31] {cfg} {name}: non-finite "
                                         "fitness")
                children, podium = es_state(m)
                ms = [round(t * 1e3, 3) for t in m.stats.time_stats()]
                runs[name] = (m, fits, children, podium, counts, ms)
                log(f"[31] {cfg}.json {name}, tpu.es_decode_layout true: ms "
                    f"per generation {ms} (set-up {m.setup_s:.1f} s); K1 "
                    f"launches {counts[0]} ({k1_per_gen} per generation), "
                    f"row-block K1 {counts[1]}; to_dec {len(laid)} calls "
                    f"laying out {sum(laid)} rows, {chunks} of them an "
                    f"offspring chunk (generation 1's fresh inits), the "
                    f"rest parents, scale rows and candidates ({card})")
            pm, pfits, pchildren, ppodium, _, _ = runs["plain"]
            for name in ("fused", "blocked"):
                m, fits, children, podium, _, _ = runs[name]
                if not all(np.array_equal(a, b) for a, b in zip(pfits, fits)) \
                        or not torch.equal(children, pchildren) \
                        or len(podium) != len(ppodium) \
                        or not all(torch.equal(a[1], b[1])
                                   for a, b in zip(podium, ppodium)) \
                        or m.stats.to_dict()["norm_stats"] != \
                        pm.stats.to_dict()["norm_stats"]:
                    raise AssertionError(f"[31] {cfg} {name}: not bit for "
                                         "bit the plain path")
            log(f"[31] {cfg}.json with the layout: plain, fused and blocked "
                f"paths' {LAYOUT_ITERS} fitness vectors of {L}, "
                f"{pchildren.shape[0]} children, {len(ppodium)} podium rows "
                f"and mean|policy| bit for bit ({card})")
            if cfg == "mscoco_es":
                ref = {name: {"fits": list(r[1]), "children": r[2],
                              "podium": [row for _, row in r[3]],
                              "stats": {k: r[0].stats.to_dict()[k]
                                        for k in LOCKSTEP_KEYS},
                              "ms": r[5]} for name, r in runs.items()}
            rows += layout_checks(card, cfg, runs["blocked"][0],
                                  runs["blocked"][4][0])
            del runs, pm, m
            torch.cuda.empty_cache()
    finally:
        DecodeLayout.to_dec = to_dec
    shutil.rmtree(runs_dir)
    log(f"[31] phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, ref


def layout_checks(card: str, cfg: str, m, launches: int) -> list:
    """[31] on an ESMaster ``m`` with the layout after its run: the replay,
    the on/off times and profiles of a fused generation; for mscoco_es.json
    K1 on decode-ordered children (its row of the kernels line, with the
    blocked run's ``launches``)."""
    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    dev = torch.device("cuda")
    eng, task = m.engine, m.task
    lay = task.decode_layout
    L, chunk, B = LAYOUT_SHAPE
    elites = m._device_elite_rows([p for p, _ in m.it.best_elites() if p])
    n_parents = elites.shape[0] + m._selected_dev.shape[0]
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2**32, size=L, dtype=np.uint32)
    pidx = rng.integers(0, n_parents, size=L).astype(np.int32)
    idx_row = rng.choice(task.train_n, size=B, replace=False)
    sigma = m.it.noise_stdev()
    build = layout_replay(f"[31] {cfg}", m, seeds, pidx, idx_row)
    pidx_d = torch.as_tensor(pidx.astype(np.int64), device=dev)
    log(f"[31] {cfg}.json: the layout sweep's {L} fitnesses bit for bit "
        f"task.rollout's on the same children mapped back by from_dec "
        f"({card})")

    off = ESEngine(task, m.mutation, pop_chunk=chunk,
                   sens_underflow=m._underflow,
                   sens_precision=m.tpu_cfg.sensitivity_precision,
                   sens_probes=m.tpu_cfg.sensitivity_probes)
    if off._layout is not None:
        raise AssertionError("[31] the default engine took the layout")
    policy, sel = m.policy_theta, m._selected_dev
    n_cands = m.experiment.num_elite_cands()
    sens_idx = m._sens_batch_rows(idx_row)

    def generation(e):
        e.unpack_fused(e.fused_generation(
            elites, elites.shape[0], sel, sigma, seeds, pidx, idx_row,
            policy, n_cands, sens=m._sens_vector, sens_idx=sens_idx)[0],
            L, n_cands)

    def timed(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generation(e)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed(off)  # its first generation
    gen_ms = {"on": [], "off": []}
    for name, e in (("on", eng), ("off", off), ("off", off), ("on", eng)):
        gen_ms[name].append(timed(e))
    prof = {}
    for name, e in (("on", eng), ("off", off)):
        wall, busy, krows = profile_call(lambda: generation(e))
        cp = [r for r in krows if "copy" in r[2].lower()]
        prof[name] = (wall, busy, sum(r[0] for r in cp),
                      sum(r[1] for r in cp), krows)
    log(f"[31] {cfg}.json, one fused generation on the same parents, "
        f"seeds and batch: layout on {gen_ms['on']} ms, off {gen_ms['off']} "
        f"ms (A B B A; host clock ending in synchronize); under "
        f"torch.profiler on: wall {prof['on'][0]:.3f} ms, card busy "
        f"{prof['on'][1]:.3f} (idle {1 - prof['on'][1] / prof['on'][0]:.2%}),"
        f" copy kernels {prof['on'][2]:.3f} ms (x{prof['on'][3]}); off: wall "
        f"{prof['off'][0]:.3f}, busy {prof['off'][1]:.3f} (idle "
        f"{1 - prof['off'][1] / prof['off'][0]:.2%}), copy kernels "
        f"{prof['off'][2]:.3f} ms (x{prof['off'][3]}) ({card})")
    for name in ("on", "off"):
        for ms, count, key in prof[name][4][:8]:
            log(f"    {name:3s} {ms:10.3f} ms  x{count:<5d} {key[:84]}")
    if cfg != "mscoco_es":
        return []
    k1 = k1_es_chunk("[31]", task, lay.prep(build(seeds[:chunk],
                                                  pidx_d[:chunk]),
                                            torch.bfloat16), idx_row)
    log(f"[31] K1 on {chunk} decode-ordered children x 128 rows "
        f"({k1['ctas']} CTAs, bf16): {k1['ms']:.3f} ms per launch (plain "
        f"twin {k1['plain_ms']:.3f}, cuBLAS products {k1['library_ms']:.3f}, "
        f"bound {k1['bound_ms']:.4f} ms by {k1['bound_by']}, "
        f"{k1['bound_ms'] / k1['ms']:.1%} of it); {k1['share']:.4%} of rows "
        f"as the plain twin's, {k1['n_diff']} differ at near-ties, max "
        f"|lp - plain| {k1['max_abs_err']:.3g}; {launches} launches in the "
        f"blocked run ({card})")
    return [{
        "name": "decode_fused_es_layout_chunk16", "route": "cuda",
        "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
        "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py:658",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"], "ctas_per_launch": k1["ctas"],
        "fused_generation_ms_layout_on": gen_ms["on"],
        "fused_generation_ms_layout_off": gen_ms["off"],
        "copy_kernel_ms_layout_on": prof["on"][2],
        "copy_kernel_ms_layout_off": prof["off"][2],
    }]


def m16_nes(exp: dict, dev, data):
    """[32]'s NES work in one process (a rank, or one process with no
    group) on [10]'s cut of mscoco_nes.json: generation 1 from the
    master's initial theta on ``generation_inputs``' draws (its packed
    vector and theta after the Adam step), then M16_NES_ITERS iterations of
    the master. Returns (results on the host, the master)."""
    import copy

    import torch

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    m = NESMaster(copy.deepcopy(exp), device=dev, data=data)
    eng = m.engine
    seeds, batches = generation_inputs(m.task, 1)
    theta0 = m.theta.clone()
    th1, _, packed = eng.generation(
        theta0, eng.optimizer.init(eng.dim, dev), torch.ones_like(theta0),
        m.config.noise_stdev, seeds[0], batches[0], m.optimizer.stepsize,
        m.config.l2coeff or 0.0)
    counters = (dc.decode_pair_rng, dc.pair_grad_rng)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    m.run_master(max_iterations=M16_NES_ITERS)
    torch.cuda.synchronize()
    return {"theta0": theta0.cpu(), "packed1": packed.cpu(),
            "theta1": th1.cpu(), "theta": m.theta.cpu(),
            "stats": {k: m.stats.to_dict()[k] for k in LOCKSTEP_KEYS},
            "ms": [round(t * 1e3, 3) for t in m.stats.time_stats()],
            "run_s": time.perf_counter() - t0,
            "launches": [c.launches for c in counters],
            "log_dir": m.exp["log_dir"]}, m


def m16_es(exps: dict, dev, data) -> dict:
    """[32]'s ES runs in a rank: each path's experiment for LAYOUT_ITERS
    generations, with the fitness vectors as the master reads them
    (gathered), the children, podium rows and stats on the host."""
    import copy

    import torch

    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine, ESMaster
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    out = {}
    unpack_block = ESEngine.unpack_block
    for path, exp in exps.items():
        m = ESMaster(copy.deepcopy(exp), device=dev, data=data)
        eng, fits = m.engine, []
        hf, uf = eng.host_fitness, eng.unpack_fused

        def hf_spy(*a, hf=hf, fits=fits):
            fits.append(hf(*a))
            return fits[-1]

        def uf_spy(*a, uf=uf, fits=fits):
            res = uf(*a)
            fits.append(res[0])
            return res

        def ub_spy(*a, fits=fits):
            res = unpack_block(*a)
            fits.extend(res[0])
            return res

        eng.host_fitness, eng.unpack_fused = hf_spy, uf_spy
        ESEngine.unpack_block = staticmethod(ub_spy)
        torch.cuda.synchronize()
        dc.decode_fused.launches = 0
        try:
            m.run_master(max_iterations=LAYOUT_ITERS)
        finally:
            ESEngine.unpack_block = staticmethod(unpack_block)
        torch.cuda.synchronize()
        children, podium = es_state(m)
        out[path] = {"fits": fits, "children": children,
                     "podium": [row for _, row in podium],
                     "stats": {k: m.stats.to_dict()[k]
                               for k in LOCKSTEP_KEYS},
                     "ms": [round(t * 1e3, 3) for t in m.stats.time_stats()],
                     "k1": dc.decode_fused.launches,
                     "log_dir": m.exp["log_dir"]}
        del m
        torch.cuda.empty_cache()
    return out


def rank_main(argv: list) -> int:
    """A process of phase 32 (``chip_smoke.py --rank-phase DIR WORLD RANK
    PORT``): joins a group of WORLD ranks through ``init_multihost`` as
    ``main.py``'s local ranks do (the store that ``run_ranks`` holds at
    127.0.0.1:PORT, the card rank % device_count), builds the in-memory
    fixtures, runs ``m16_nes`` and, in a group of more than one,
    ``m16_es`` on DIR/inputs.json's experiments, and saves the results as
    DIR/rank_WORLD_RANK.pt."""
    import datetime

    import torch

    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )
    from nes_img_captioning_tpu_torch.parallel import make_mesh
    from nes_img_captioning_tpu_torch.parallel.multihost import (
        init_multihost,
        shutdown_multihost,
    )

    work, world, rank, port = argv[0], int(argv[1]), int(argv[2]), \
        int(argv[3])
    with open(os.path.join(work, "inputs.json")) as f:
        inputs = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(f"127.0.0.1:{port}", world, rank,
                   timeout=datetime.timedelta(seconds=RANK_TIMEOUT // 2),
                   launcher_store=True)
    mesh = make_mesh()
    tag = f"[32] rank {rank} of {world} ({mesh.backend}, {mesh.device})"
    out = {"backend": mesh.backend, "device": str(mesh.device)}
    try:
        t0 = time.perf_counter()
        nes_data = bench_task(mesh.device).data
        out["nes"], _ = m16_nes(inputs["nes"], mesh.device, nes_data)
        log(f"{tag}: NES {M16_NES_ITERS} iterations, ms "
            f"{out['nes']['ms']}, K5 and K6 launches "
            f"{out['nes']['launches']} ({time.perf_counter() - t0:.1f} s "
            "with the fixture)")
        if world > 1:
            t0 = time.perf_counter()
            es_data = CocoData.from_arrays(synthetic_coco_arrays(
                n_train=2048, n_val=VAL_ITEMS, n_test=8, vocab_size=9487,
                fc_feat_size=2048, cap_len=9, seed=0))
            out["es"] = m16_es(inputs["es"], mesh.device, es_data)
            log(f"{tag}: ES " + "; ".join(
                f"{p} ms {r['ms']}, K1 {r['k1']}"
                for p, r in out["es"].items())
                + f" ({time.perf_counter() - t0:.1f} s with the fixture)")
    finally:
        shutdown_multihost()
    torch.save(out, os.path.join(work, f"rank_{world}_{rank}.pt"))
    return 0


def run_ranks(work: str, world: int) -> list:
    """Start WORLD rank processes of phase 32 at once, wait for all within
    RANK_TIMEOUT (killing any left), echo their [32] lines, and return
    their results; a rank that fails fails the phase with its output's
    tail. This process holds their rendezvous (``hold_rendezvous``)."""
    import torch

    from nes_img_captioning_tpu_torch.parallel.multihost import (
        hold_rendezvous,
    )

    store = hold_rendezvous(world)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-phase", work,
         str(world), str(r), str(store.port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("[32]") or "collectives over" in line:
                log(line if line.startswith("[32]") else f"    {line}")
        if p.returncode != 0:
            raise AssertionError(f"[32] rank {r} of {world} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return [torch.load(os.path.join(work, f"rank_{world}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def primary_only(log_dir: str, replica_dir: str, what: str):
    """The run's directory holds one z_info whose files are all under it;
    the non-primary rank's scratch directory was a private one and is
    gone."""
    (path,) = [os.path.join(log_dir, "snapshot", f)
               for f in os.listdir(os.path.join(log_dir, "snapshot"))
               if f.startswith("z_info_")]
    with open(path) as f:
        text = f.read()
    infos = json.loads(text)
    files = [p for _, p in infos.get("parents", [])
             + infos.get("elites_to_evaluate", [])]
    files += [p for p, _ in infos["best_elites"] if p]
    if "current_model" in infos:
        files.append(infos["current_model"])
    if "nes_replica_logdir_" in text or "nes_replica_logdir_" not in \
            replica_dir or os.path.exists(replica_dir) or not files or \
            not all(p.startswith(log_dir) and os.path.isfile(p)
                    for p in files):
        raise AssertionError(f"[32] {what}: artifacts outside rank 0's "
                             f"directory ({path}, rank 1 in {replica_dir})")
    return len(files)


def m16_phase(card: str, task, es_ref: dict, kernels: list) -> list:
    """Phase 32: the population over ranks (M16) on the one card. [10]'s
    cut of mscoco_nes.json (kernel noise) for M16_NES_ITERS iterations and
    [31]'s mscoco_es.json with the layout on its three paths, as 2 ranks
    in child processes sharing cuda:0 over gloo (``init_multihost``'s rule)
    with the fixtures built in each; then NES alone as 1 rank over NCCL.
    Gates: the ranks' stat series and final theta bit for bit each other's;
    the artifacts in rank 0's directory only; NES generation 1 from the
    same theta: fitnesses bit for bit one process's, theta exactly Adam's
    step on the rank-order sum of the ranks' K6 partial gradients, which is
    within the sum-order bound 2 gamma_F sum |w_i||delta_i| of one
    process's K6 gradient (gamma_n = n u / (1 - n u), u = 2^-24, |delta_i|
    from K7's dumps); every ES trajectory bit for bit [31]'s one-process
    run; the NCCL rank bit for bit one process. Returns the kernels line's
    rows for K5 and K6 on a rank's half of the lanes."""
    import copy
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    work = os.path.abspath(os.path.join("logs",
                                        f"chip_smoke_m16_{os.getpid()}"))
    os.makedirs(work)
    nes_exp = nes_experiment(work, "nes", "bf16", gens_per_dispatch=2,
                             kernel_noise=True)
    nes_exp["config"]["snapshot_freq"] = 2
    es_exps = {name: layout_experiment("mscoco_es", name,
                                       os.path.join(work, "es"), **tpu)
               for name, tpu in LAYOUT_PATHS}
    with open(os.path.join(work, "inputs.json"), "w") as f:
        json.dump({"nes": nes_exp, "es": es_exps}, f)

    # one process, no group: the reference of NES generation 1
    ref_exp = copy.deepcopy(nes_exp)
    ref_exp["log_dir"] = os.path.join(work, "nes_one_process")
    ref, m = m16_nes(ref_exp, dev, task.data)
    eng, lay = m.engine, task.decode_layout
    theta0 = ref["theta0"].to(dev)
    log(f"[32] one process, no group: NES {M16_NES_ITERS} iterations, ms "
        f"{ref['ms']}, K5 and K6 launches {ref['launches']} ({card})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    two = run_ranks(work, 2)
    nccl = run_ranks(work, 1)[0]
    if [r["backend"] for r in two] != ["gloo", "gloo"] or \
            nccl["backend"] != "nccl":
        raise AssertionError(f"[32] backends {[r['backend'] for r in two]}"
                             f", {nccl['backend']}: expected gloo for two "
                             "ranks on one card, nccl for one")
    F = BENCH["pairs"]
    half = -(-F // 2)
    n_chunks_rank = -(-half // BENCH["pop_chunk"])

    # lockstep and the artifacts
    a, b = two[0]["nes"], two[1]["nes"]
    if a["stats"] != b["stats"] or not torch.equal(a["theta"], b["theta"]):
        raise AssertionError("[32] NES: the ranks' stat series or final "
                             "theta differ")
    if a["launches"] != [M16_NES_ITERS * n_chunks_rank, M16_NES_ITERS] \
            or a["launches"] != b["launches"]:
        raise AssertionError(f"[32] NES: K5 and K6 launches per rank "
                             f"{a['launches']}, {b['launches']}")
    n_files = primary_only(a["log_dir"], b["log_dir"], "NES")
    L, chunk, B = LAYOUT_SHAPE
    k1_want = LAYOUT_ITERS * -(-(-(-L // 2)) // chunk) * -(-B // 128)
    for path in es_ref:
        ra, rb = two[0]["es"][path], two[1]["es"][path]
        n_files += primary_only(ra["log_dir"], rb["log_dir"], f"ES {path}")
        want = es_ref[path]
        for r in (ra, rb):
            if not (all(np.array_equal(x, y) for x, y in
                        zip(r["fits"], want["fits"]))
                    and len(r["fits"]) == len(want["fits"])
                    and torch.equal(r["children"], want["children"])
                    and len(r["podium"]) == len(want["podium"])
                    and all(torch.equal(x, y) for x, y in
                            zip(r["podium"], want["podium"]))
                    and r["stats"] == want["stats"]):
                raise AssertionError(f"[32] ES {path}: a rank's trajectory "
                                     "is not [31]'s one-process run")
            if r["k1"] != k1_want:
                raise AssertionError(f"[32] ES {path}: K1 launches "
                                     f"{r['k1']} != {k1_want}")
    log(f"[32] two ranks over gloo on one card: NES stat series and final "
        f"theta bit for bit across the ranks; ES on the plain, fused and "
        f"blocked paths ({LAYOUT_ITERS} generations each) bit for bit [31]'s "
        f"one-process runs on both ranks (fitness vectors, children, "
        f"podium rows, stats); {n_files} artifacts, all in rank 0's "
        f"directories; rank 1's scratch directories removed ({card})")
    log(f"[32] ms per iteration on one card: NES one process {ref['ms']}, "
        f"2 ranks {a['ms']} (rank 0) {b['ms']} (rank 1), 1 rank over NCCL "
        f"{nccl['nes']['ms']}; ES one process ([31]) "
        + "; ".join(f"{p} {es_ref[p]['ms']}" for p in es_ref)
        + ", 2 ranks (rank 0) "
        + "; ".join(f"{p} {two[0]['es'][p]['ms']}" for p in es_ref)
        + f" ({card}; no claim: both ranks share the card and validate "
        "whole)")

    # NES generation 1: fitnesses bit for bit, theta within the bound
    packed1 = ref["packed1"]
    for who, r in (("rank 0", a), ("rank 1", b), ("NCCL", nccl["nes"])):
        if not torch.equal(r["packed1"][:2 * F], packed1[:2 * F]):
            raise AssertionError(f"[32] NES generation 1, {who}: fitnesses "
                                 "differ from one process's")
    if not (torch.equal(nccl["nes"]["packed1"], packed1)
            and torch.equal(nccl["nes"]["theta1"], ref["theta1"])):
        raise AssertionError("[32] the NCCL rank's generation 1 is not one "
                             "process's bit for bit")
    seeds, _ = generation_inputs(task, 1)
    seeds = seeds[0]
    scale_dec = lay.to_dec(eng._scale_vec(theta0, torch.ones_like(theta0),
                                          m.config.noise_stdev),
                           pad_scale=0.0)
    w = eng._pair_weights(packed1[:2 * F].reshape(F, 2).to(dev),
                          (1, F)).reshape(-1)
    g_one = dc.pair_grad_rng_flat(scale_dec, seeds, w)
    parts = [dc.pair_grad_rng_flat(scale_dec, seeds[lo:lo + half],
                                   w[lo:lo + half]) for lo in (0, half)]
    g_two = parts[0] + parts[1]
    absum = torch.zeros_like(scale_dec, dtype=torch.float64)
    P = BENCH["pop_chunk"]
    for lo in range(0, F, P):
        d = dc.pair_delta_dump_flat(scale_dec, seeds[lo:lo + P])
        absum += (w[lo:lo + P, None].abs() * d.abs()).double().sum(0)
    u = 2.0 ** -24
    gamma = F * u / (1 - F * u)
    bound = 2 * gamma * absum
    diff = (g_two - g_one).abs().double()

    def step(g):
        return eng._apply_grad(theta0, eng.optimizer.init(eng.dim, dev),
                               lay.from_dec(g), 2 * F, m.optimizer.stepsize,
                               m.config.l2coeff or 0.0)[1].cpu()

    torch.cuda.synchronize()
    if not torch.equal(step(g_one), ref["theta1"]):
        raise AssertionError("[32] one process's theta is not Adam's step "
                             "on its K6 gradient")
    if not all(torch.equal(step(g_two), r["theta1"]) for r in (a, b)):
        raise AssertionError("[32] a rank's theta is not Adam's step on the "
                             "rank-order sum of the K6 partials")
    if not bool((diff <= bound).all()):
        raise AssertionError(f"[32] the ranks' gradient is beyond the "
                             f"sum-order bound: max excess "
                             f"{float((diff - bound).max()):.3g}")
    dth = (a["theta1"] - ref["theta1"]).abs()
    log(f"[32] NES generation 1 from the same theta: fitnesses of {F} pairs "
        f"bit for bit one process's on both ranks and over NCCL; the ranks' "
        f"theta is Adam's step on the rank-order sum of their K6 partials "
        f"({half} lanes each), whose gradient is within 2 gamma_{F} "
        f"sum|w||delta| of one process's: {int((diff > 0).sum())} of "
        f"{diff.numel()} elements differ, max |diff| {float(diff.max()):.3g} "
        f"(at most {float((diff / bound.clamp_min(1e-300)).max()):.3g} of "
        f"its bound); theta: {int((dth > 0).sum())} elements differ, max "
        f"|diff| {float(dth.max()):.3g} (Adam step "
        f"{m.optimizer.stepsize}); the NCCL rank bit for bit ({card})")

    # K6 on a rank's half of the lanes, and K5's rank row
    scale_params = lay.prep(scale_dec, torch.float32)
    k6 = dc.pair_grad_rng_flat(scale_dec, seeds[:half], w[:half])
    k6_plain_out = lay.flat_dec(dc.pair_grad_rng_plain(
        scale_params, seeds[:half], w[:half]))
    torch.cuda.synchronize()
    k6_err = float((k6 - k6_plain_out).abs().max())
    if not torch.equal(k6, k6_plain_out):
        raise AssertionError(f"[32] K6 over {half} lanes: not bitwise its "
                             f"plain version (max {k6_err:.3g})")
    k6_ms = time_ms(lambda: dc.pair_grad_rng_flat(scale_dec, seeds[:half],
                                                  w[:half]), reps=10)
    k6_plain = time_ms(lambda: dc.pair_grad_rng_plain(
        scale_params, seeds[:half], w[:half]), reps=1)
    normals = half * lay.dim_dec
    k6_bound, k6_by = regime_bound(2 * lay.dim_dec * 4 + half * 8, 0.0,
                                   normals,
                                   NORMAL_F32_OPS + GRAD_SUM_OPS)[:2]
    (k5,) = [k for k in kernels if k["name"] == "decode_pair_rng"]
    log(f"[32] K6 over a rank's {half} lanes: {k6_ms:.3f} ms per launch "
        f"(plain {k6_plain:.3f} ms, bound {k6_bound:.4f} ms by {k6_by}, "
        f"{k6_bound / k6_ms:.1%} of it), bitwise its plain version; K5 at "
        f"the rank's launch shape ({P} pairs, as [11]) {k5['ms']:.3f} ms; "
        f"rank 0 launched K5 {a['launches'][0]} and K6 {a['launches'][1]} "
        f"times in its {M16_NES_ITERS} iterations ({card})")
    shutil.rmtree(work)
    log(f"[32] phase: {time.perf_counter() - t_phase:.1f} s")
    return [
        {**{k: k5[k] for k in ("route", "source", "replaces", "max_abs_err",
                               "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
         "name": "decode_pair_rng_rank_half", "launches": a["launches"][0],
         "pairs_per_rank": half, "launch_shape_as": "decode_pair_rng"},
        {"name": "pair_grad_rng_rank_half", "route": "cuda",
         "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
         "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py:587",
         "launches": a["launches"][1], "max_abs_err": k6_err, "ms": k6_ms,
         "plain_ms": k6_plain, "bound_ms": k6_bound,
         "bound_by": k6_by,
         "library_ms": None, "lanes": half,
         "theta_max_abs_diff_one_process": float(dth.max()),
         "grad_max_share_of_sum_order_bound": float(
             (diff / bound.clamp_min(1e-300)).max())},
    ]


# ---- [33] experiments/mscoco_nes.json at its own settings -------------------

# the Karpathy split's shape (reference: src/captioning/dataloader.py:56-98):
# 82,783 train images and 30,504 restval images, which join train, 5000
# val and 5000 test; cocotalk's vocabulary, 2048-d features, 9-token
# synthetic captions
REGIME_DATA = dict(train=82783, restval=30504, val=5000, test=5000,
                   vocab=9487, feat=2048, cap_len=9)
# mscoco_nes.json's settings as the file gives them, checked before each
# run: nb_offspring (pairs), batch_size, pop_chunk, precision, delta_dtype
# (resolved: the file leaves "_delta_dtype" commented out), kernel_noise,
# gens_per_dispatch, num_val_items, val_batch_size
REGIME_SETTINGS = (2000, 64, 48, "bf16", "f32", "auto", 8, 5000, 256)
REGIME_BLOCKS = 2          # dispatch blocks of the delta-operand run
REGIME_CHUNK_ALT = 40      # 2000 = 50 x 40: the same generation, no pad lane
REGIME_COUNTERS = ("decode_pair_perturb", "decode_rows", "decode_pair_rng",
                   "pair_grad_rng", "decode_fused", "pair_delta_dump")


def regime_arrays():
    """REGIME_DATA's arrays (``synthetic_coco_arrays`` layout) from seed 0:
    the restval images are a fixed draw among the train block's, so
    CocoData joins them to train in image order. The source of [35]'s files
    and of the CocoData that [33] and [36] run on. Returns (arrays,
    seconds)."""
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )

    d = REGIME_DATA
    n_train = d["train"] + d["restval"]
    t0 = time.perf_counter()
    arrays = synthetic_coco_arrays(
        n_train=n_train, n_val=d["val"], n_test=d["test"],
        vocab_size=d["vocab"], fc_feat_size=d["feat"], cap_len=d["cap_len"],
        seed=0)
    for i in np.random.default_rng(1).choice(n_train, size=d["restval"],
                                             replace=False):
        arrays["info"]["images"][int(i)]["split"] = "restval"
    t_arrays = time.perf_counter() - t0
    log(f"[35] arrays: {d['train']:,} train + {d['restval']:,} restval = "
        f"{n_train:,} train images, {d['val']} val, {d['test']} test; vocab "
        f"{d['vocab']}, {d['feat']}-d features "
        f"({arrays['feats'].nbytes / 1e9:.3f} GB f32), "
        f"{arrays['labels'].shape[0]:,} captions "
        f"({arrays['labels'].nbytes / 1e6:.1f} MB); {t_arrays:.1f} s")
    return arrays, t_arrays


# ---- [35] the reference's on-disk format at the Karpathy split's size -----

# [35]: the main master's generations (one block of mscoco_nes.json's 8),
# the runbook's generations, and each child process's time limit (s)
DISK_NES_ITERS = 8
DISK_PARITY_GENS = 2
CHILD_TIMEOUT = 600
LABEL_KEYS = ("labels", "label_start_ix", "label_end_ix")


def coco_digest(data) -> dict:
    """The split sizes and SHA-256 of the labels and features of a
    CocoData: [35]'s reload in a fresh process is held to them."""
    import hashlib

    fc = np.ascontiguousarray(data._fc)
    return {"splits": {k: len(v) for k, v in data.split_ix.items()},
            "labels": hashlib.sha256(data.labels.tobytes()).hexdigest(),
            "feats": hashlib.sha256(fc.view(np.uint8)).hexdigest()}


def reload_main(argv: list) -> int:
    """``chip_smoke.py --reload-phase COPTS_JSON``: [35]'s reload in a fresh
    process. CocoData of the files the caption options name (the
    consolidated features memory-mapped); prints its seconds, whether the
    features are a memory map, and ``coco_digest`` as one JSON line."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData

    with open(argv[0]) as f:
        copts = json.load(f)
    t0 = time.perf_counter()
    data = CocoData(copts)
    seconds = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds,
                      "mmap": isinstance(data._fc, np.memmap),
                      **coco_digest(data)}))
    return 0


def coco_equal(got, want, what: str):
    """Raise unless two CocoData hold the same labels, label indices, split
    indices, gts and features bit for bit."""
    splits = ("train", "val", "test")

    def same(a, b) -> bool:
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a.view(np.uint8), b.view(np.uint8))

    checks = {
        "labels": same(got.labels, want.labels),
        "label_start_ix": same(got.label_start_ix, want.label_start_ix),
        "label_end_ix": same(got.label_end_ix, want.label_end_ix),
        "split indices": got.split_ix == want.split_ix,
        "gts": all(len(g) == len(w) and all(same(a, b) for a, b in zip(g, w))
                   for g, w in ((got.split_gts(s), want.split_gts(s))
                                for s in splits)),
        "features": same(np.ascontiguousarray(got._fc),
                         np.ascontiguousarray(want._fc)),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{what}: {', '.join(bad)} differ")


def run_children(cmds: dict, work: str) -> dict:
    """Start each {name: argv} as a child process from the repository's root,
    its stdout and stderr into ``work/<name>.out`` and ``.err``, all at
    once; wait for all (CHILD_TIMEOUT each) and stop any still running.
    Raises unless every child exits 0. Returns {name: (stdout, seconds)}."""
    import subprocess

    procs, out = {}, {}
    try:
        for name, argv in cmds.items():
            files = [open(os.path.join(work, f"{name}.{k}"), "w")
                     for k in ("out", "err")]
            procs[name] = (subprocess.Popen(argv, stdout=files[0],
                                            stderr=files[1]), files,
                           time.perf_counter())
        deadline = time.perf_counter() + CHILD_TIMEOUT
        for name, (proc, files, t0) in procs.items():
            rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
            out[name] = (rc, time.perf_counter() - t0)
    finally:
        for proc, files, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in files:
                f.close()
    for name, (rc, seconds) in out.items():
        with open(os.path.join(work, f"{name}.out")) as f:
            stdout = f.read()
        if rc != 0:
            with open(os.path.join(work, f"{name}.err")) as f:
                err = f.read()[-4000:]
            raise AssertionError(f"[35] child {name} {cmds[name]} exited "
                                 f"{rc} after {seconds:.1f} s:\n{err}")
        out[name] = (stdout, seconds)
    return out


def disk_phase(card: str, arrays: dict, pth: str):
    """Phase 35: the reference's on-disk format at the Karpathy split's
    size, written and read by the port with numpy alone. REGIME_DATA's
    ``arrays`` go to a directory under logs/ through write_synthetic_coco
    (123,287 per-image .npy files, cocotalk.json, cocotalk_label.h5 from
    data/hdf5.write_datasets); CocoData reads them back (the first load
    consolidates the features into fc_fc.npy) bit for bit
    CocoData.from_arrays of the same arrays; a fresh process reloads them
    (the memory-mapped consolidation), bit for bit. Then the entry points a
    user starts, as child processes on those files at once:
    ``main master`` on experiments/mscoco_nes.json for DISK_NES_ITERS
    generations (its snapshot, .pth and optimizer.tar written), and
    scripts/torch_parity_run.py with the .pth ``pth`` for DISK_PARITY_GENS
    generations and the 5000 test images (both warm-start round trips
    exact, a finite validation series, finite CIDEr-D for both
    checkpoints). Seconds of each step and the upload's GB/s are logged.
    Returns (the CocoData read from the files, its first load's seconds);
    the directory is removed."""
    import glob
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.data.hdf5 import read_datasets
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        write_synthetic_coco,
    )
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    work = os.path.abspath(os.path.join("logs",
                                        f"chip_smoke_disk_{os.getpid()}"))
    fixture = os.path.join(work, "coco")
    os.makedirs(work)
    t0 = time.perf_counter()
    copts = write_synthetic_coco(fixture, arrays)
    t_write = time.perf_counter() - t0
    n_files = len(os.listdir(copts["input_fc_dir"]))
    fc_bytes = sum(e.stat().st_size
                   for e in os.scandir(copts["input_fc_dir"]))
    h5_bytes = os.path.getsize(copts["input_label_h5"])
    log(f"[35] wrote the fixture in {t_write:.1f} s: {n_files:,} per-image "
        f".npy files ({fc_bytes / 1e9:.3f} GB), cocotalk.json "
        f"({os.path.getsize(copts['input_json']) / 1e6:.1f} MB), "
        f"cocotalk_label.h5 ({h5_bytes / 1e6:.1f} MB, data/hdf5.py) "
        f"({card})")

    t0 = time.perf_counter()
    labels = read_datasets(copts["input_label_h5"], LABEL_KEYS)
    t_label = time.perf_counter() - t0
    for k in LABEL_KEYS:
        if not np.array_equal(labels[k], arrays[k]) or \
                labels[k].dtype != np.asarray(arrays[k]).dtype:
            raise AssertionError(f"[35] the label file's {k} is not the "
                                 "array written")
    del labels
    t0 = time.perf_counter()
    data = CocoData(copts)
    t_first = time.perf_counter() - t0
    fc_cache = copts["input_fc_dir"].rstrip("/") + "_fc.npy"
    if not os.path.isfile(fc_cache) or isinstance(data._fc, np.memmap):
        raise AssertionError("[35] the first load did not consolidate the "
                             "features")
    t0 = time.perf_counter()
    coco_equal(data, CocoData.from_arrays(arrays),
               "[35] CocoData of the files against from_arrays")
    t_check = time.perf_counter() - t0
    log(f"[35] CocoData from the files bit for bit CocoData.from_arrays: "
        f"labels, label indices, split indices, gts and features (checked "
        f"in {t_check:.1f} s); the label read {t_label:.3f} s, the first "
        f"load {t_first:.1f} s (consolidating into "
        f"{os.path.basename(fc_cache)}, "
        f"{os.path.getsize(fc_cache) / 1e9:.3f} GB) ({card})")

    copts_path = os.path.join(work, "caption_options.json")
    with open(copts_path, "w") as f:
        json.dump(copts, f)
    stdout, t_child = run_children({"reload": [
        sys.executable, os.path.abspath(__file__), "--reload-phase",
        copts_path]}, work)["reload"]
    reload = json.loads(stdout.strip().splitlines()[-1])
    want = coco_digest(data)
    if not reload["mmap"] or any(reload[k] != want[k] for k in want):
        raise AssertionError(f"[35] the reload in a fresh process: memory "
                             f"map {reload['mmap']}, digests "
                             f"{ {k: reload[k] == want[k] for k in want} }")
    train = data.split_feats("train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    up = torch.as_tensor(train, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    gb = train.nbytes / 1e9
    del up, train
    torch.cuda.empty_cache()
    log(f"[35] reload in a fresh process: CocoData {reload['seconds']:.3f} s "
        f"(the features memory-mapped from {os.path.basename(fc_cache)}; "
        f"the process {t_child:.1f} s), labels and features bit for bit by "
        f"SHA-256; the train matrix, {gb:.3f} GB f32, to the card in "
        f"{t_up:.3f} s ({gb / t_up:.2f} GB/s) ({card})")

    # the entry points a user starts, on these files
    exp = load_experiment("experiments/mscoco_nes.json")
    exp["caption_options"].update(copts)
    exp["log_dir"] = os.path.join(work, "master")
    exp_path = os.path.join(work, "mscoco_nes_fixture.json")
    with open(exp_path, "w") as f:
        json.dump(exp, f)
    parity_out = os.path.join(work, "parity")
    children = run_children({
        "master": [sys.executable, "-m", "nes_img_captioning_tpu_torch.main",
                   "master", "--exp_file", exp_path, "--max_iterations",
                   str(DISK_NES_ITERS)],
        "parity": [sys.executable, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scripts",
            "torch_parity_run.py"), "--data", fixture, "--pth",
            os.path.abspath(pth), "--generations", str(DISK_PARITY_GENS),
            "--test-num", str(REGIME_DATA["test"]), "--out", parity_out],
    }, work)
    run_dir = exp["log_dir"]
    zinfo = glob.glob(os.path.join(run_dir, "snapshot", "z_info_*.json"))
    files = {"snapshot": zinfo,
             "pth": glob.glob(os.path.join(run_dir, "models", "current",
                                           "0_current_params.pth")),
             "optimizer.tar": glob.glob(os.path.join(run_dir, "optimizer",
                                                     "optimizer.tar"))}
    n_train = REGIME_DATA["train"] + REGIME_DATA["restval"]
    want_iter = f"_i{DISK_NES_ITERS}-{n_train // exp['config']['batch_size']}"
    if not all(files.values()) or len(zinfo) != 1 or \
            not zinfo[0].endswith(want_iter + ".json"):
        raise AssertionError(f"[35] main master wrote {files}")
    with open(zinfo[0]) as f:
        stats = json.load(f)
    log(f"[35] python -m nes_img_captioning_tpu_torch.main master "
        f"--exp_file <mscoco_nes.json on the fixture> --max_iterations "
        f"{DISK_NES_ITERS}: exit 0 in {children['master'][1]:.1f} s, wrote "
        f"{os.path.basename(zinfo[0])}, 0_current_params.pth and "
        f"optimizer.tar; z_info keys {sorted(stats)[:8]} ({card})")
    summary = json.loads(children["parity"][0].strip().splitlines()[-1])
    ws = summary.get("warm_start") or {}
    series = summary.get("val_cider_series") or []
    tests = summary.get("test_stats") or {}
    if not (ws.get("vector_roundtrip_exact")
            and ws.get("tensor_roundtrip_exact")) \
            or len(series) != DISK_PARITY_GENS \
            or not np.isfinite(series).all() \
            or set(tests) != {"nicnes_best", "nicnes_current"} \
            or not all(np.isfinite(t["CIDEr"]) for t in tests.values()) \
            or not all(os.path.isfile(os.path.join(parity_out, n)) for n in
                       ("parity_summary.json", "test_output.json")):
        raise AssertionError(f"[35] the parity runbook: {summary}")
    log(f"[35] python3 scripts/torch_parity_run.py --data <fixture> --pth "
        f"<[27]'s XENT .pth> --generations {DISK_PARITY_GENS} --test-num "
        f"{REGIME_DATA['test']}: exit 0 in {children['parity'][1]:.1f} s "
        f"(beside the master); warm start bit-exact "
        f"({ws['num_params']:,} parameters); validation CIDEr {series}; "
        f"test CIDEr-D "
        f"{ {k: round(v['CIDEr'], 6) for k, v in tests.items()} } ({card})")
    shutil.rmtree(work)
    log(f"[35] phase: {time.perf_counter() - t_phase:.1f} s ({card})")
    return data, t_first


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (model name, or vendor,
    family and model where a virtual machine gives the name as unknown)
    and its core count: the set-up's clock is the host's."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name = " ".join(f"{k} {fields[k]}" for k in
                        ("vendor_id", "cpu family", "model", "cpu MHz")
                        if k in fields) or platform.machine()
    return f"{name}, {os.cpu_count()} cores"


def true_regime_phase(card: str, data, setup: dict) -> list:
    """Phase 33: experiments/mscoco_nes.json at its own settings (2000
    pairs, batch 64, pop_chunk 48, bf16 compute, f32 deltas, 5000 val
    images at val_batch_size 256, blocks of 8) on REGIME_DATA's 113,287
    train images, ``data`` the CocoData that [35] read from the files
    (``setup``: the arrays' and that read's seconds). Set-up seconds and
    bytes; NESMaster for REGIME_BLOCKS
    blocks on the delta-operand pair path (K2 42 times per generation, the
    row-block K1 once, no K5 or K6); generation 1's first and padded last
    chunk against K1 and the plain twin; the same generation at pop_chunk
    40; one block with tpu.kernel_noise (K5 42 times, K6 once per
    generation), K5 against K2 fed K7's dump and K6 over 2016 lanes
    against its plain version and the ordered sum of K7's dumps; one
    generation of each run under torch.profiler; the three kernels' rows at
    these shapes. Returns them, and the task's DeviceCider over the train
    references with its build's seconds ([36] scores with it)."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch import tasks
    from nes_img_captioning_tpu_torch.algorithms.nes import (
        NESEngine,
        NESMaster,
    )
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops import cider_device
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.utils.config import (
        load_experiment,
        parse_config,
        parse_tpu_config,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    runs_dir = os.path.join("logs", f"chip_smoke_regime_{os.getpid()}")

    def experiment(name: str, **tpu) -> dict:
        """mscoco_nes.json as it is but for where it writes and its
        snapshot cadence (one snapshot, at the end of the delta run)."""
        exp = load_experiment("experiments/mscoco_nes.json")
        cfg, tcfg = parse_config(exp), parse_tpu_config(exp)
        got = (exp["nb_offspring"], cfg.batch_size, tcfg.pop_chunk,
               tcfg.precision, tcfg.delta_dtype, tcfg.kernel_noise,
               tcfg.gens_per_dispatch, cfg.num_val_items, cfg.val_batch_size)
        if got != REGIME_SETTINGS:
            raise AssertionError(f"[33] mscoco_nes.json's settings {got} != "
                                 f"{REGIME_SETTINGS}")
        exp["config"]["snapshot_freq"] = REGIME_BLOCKS * tcfg.gens_per_dispatch
        exp["tpu"].update(tpu)
        exp["log_dir"] = os.path.join(runs_dir, name)
        return exp

    F, B, P = REGIME_SETTINGS[:3]
    gpd = REGIME_SETTINGS[6]
    n_chunks = -(-F // P)
    real_last = F - (n_chunks - 1) * P

    # the upload the task makes, alone: the train matrix to the card
    train = data.split_feats("train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    up = torch.as_tensor(train, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    gb = train.nbytes / 1e9
    log(f"[33] the train matrix {tuple(train.shape)} f32, {gb:.3f} GB, to "
        f"the card in {t_up:.3f} s ({gb / t_up:.2f} GB/s) ({card})")
    del up, train
    torch.cuda.empty_cache()

    # the master's set-up, the CIDEr-D tables' builds timed inside it
    built = []
    init = cider_device.DeviceCider.__init__

    def timed_init(self, gts_list, *a, **k):
        t = time.perf_counter()
        init(self, gts_list, *a, **k)
        built.append((len(gts_list), k.get("variant", "cider-d"),
                      time.perf_counter() - t))

    cider_device.DeviceCider.__init__ = timed_init
    try:
        t0 = time.perf_counter()
        master = NESMaster(experiment("delta"), device=dev, data=data)
        master.task.device_val_consts()
        torch.cuda.synchronize()
        t_master = time.perf_counter() - t0
    finally:
        cider_device.DeviceCider.__init__ = init
    eng, task = master.engine, master.task
    lay, T = task.decode_layout, task.model.options.seq_length
    Fd, Vpad = task.model.options.fc_feat_size, lay.Vpad
    refs = sum(g.shape[0] for g in task.train_gts)
    log(f"[33] NESMaster set-up {t_master:.1f} s: "
        + "; ".join(f"DeviceCider ({v}) over {n:,} images {s:.1f} s"
                    for n, v, s in built)
        + f" ({refs:,} train references; host CPU {host_cpu()})")
    resolved = {"fused_validation": master._val_fused_mode(),
                "kernel_perturb": eng._kernel_perturb,
                "kernel_noise": eng._kernel_noise,
                "device_cider": task._device_cider is not None,
                "delta_dtype": eng._delta_dtype}
    if resolved != {"fused_validation": True, "kernel_perturb": True,
                    "kernel_noise": False, "device_cider": True,
                    "delta_dtype": torch.float32}:
        raise AssertionError(f"[33] mscoco_nes.json resolved to {resolved}")
    log(f"[33] mscoco_nes.json resolves to {resolved}; {F} pairs in "
        f"{n_chunks} chunks of {P}, the last with {real_last} real pairs "
        f"and {n_chunks * P - F} pad lanes")

    # generation 1's operands, as the master hands them to the engine
    first = {}
    block = eng.generation_val_block

    def spy(theta, opt_state, sens, sigma, seeds, idx, *rest):
        if not first:
            first.update(theta=theta.clone(), sens=sens, sigma=sigma,
                         seeds=seeds[0].copy(), idx=idx[0].copy())
        return block(theta, opt_state, sens, sigma, seeds, idx, *rest)

    eng.generation_val_block = spy
    counters = tuple(getattr(dc, n) for n in REGIME_COUNTERS)

    def counted(fn) -> tuple:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (dict(zip(REGIME_COUNTERS, (c.launches for c in counters))),
                time.perf_counter() - t0)

    def want(**n) -> dict:
        return {k: n.get(k, 0) for k in REGIME_COUNTERS}

    # ---- the delta-operand run: REGIME_BLOCKS blocks of gpd generations ----
    gens = REGIME_BLOCKS * gpd
    c_d, t_d = counted(lambda: master.run_master(max_iterations=gens))
    if c_d != want(decode_pair_perturb=n_chunks * gens, decode_rows=gens):
        raise AssertionError(f"[33] delta-operand launches {c_d}")
    scores = np.asarray(master.stats.score_stats(), np.float64)
    if master.it.iteration() != gens or scores.shape[1] != gens or \
            not np.isfinite(scores).all() or \
            not bool(torch.isfinite(master.theta).all()):
        raise AssertionError("[33] the delta-operand run: iterations, "
                             "finite fitnesses and theta")
    ms_d = master.stats.time_stats()
    log(f"[33] NESMaster, delta operands: {gens} generations in {t_d:.1f} s "
        f"({REGIME_BLOCKS} blocks of {gpd}); ms per generation (time_stats, "
        f"a block split evenly) {[round(t * 1e3, 3) for t in ms_d]}; K2 "
        f"{c_d['decode_pair_perturb']} ({n_chunks} per generation), "
        f"row-block K1 {c_d['decode_rows']}, K5 0, K6 0; mean fitness "
        f"{[round(float(m), 4) for m in scores[1]]}; validation CIDEr "
        f"{[round(a, 4) for a in master.stats.acc_stats()]} ({card})")

    # ---- generation 1's chunks against K1 and the plain twin ----------------
    theta0, sens, sigma = first["theta"], first["sens"], first["sigma"]
    seeds1, idx1 = first["seeds"], first["idx"]
    stepsize, l2 = master.optimizer.stepsize, master.config.l2coeff or 0.0
    scale_dec = lay.to_dec(eng._scale_vec(theta0, sens, sigma),
                           pad_scale=0.0)
    base_vec = lay.to_dec(theta0)
    base = task.pair_base_params(base_vec)
    _, _, seeds_l, idx_l = eng._chunked(seeds1, idx1, dev)
    k2_err, keep = 0.0, {}
    for c, real in ((0, P), (n_chunks - 1, real_last)):
        deltas = eng._deltas(scale_dec, seeds_l[c])
        if deltas.dtype != torch.float32:
            raise AssertionError(f"[33] the delta is {deltas.dtype}")
        dparams = lay.prep(deltas, torch.float32)
        feats = task.train_fc[idx_l[c]]
        feats2 = feats.repeat_interleave(2, 0)
        members = torch.stack([base_vec + deltas, base_vec - deltas],
                              1).reshape(2 * P, -1)
        n = 2 * real
        for dt in (torch.float32, torch.bfloat16):
            seq2, lp2 = (x.reshape(2 * P, B, T)[:n] for x in
                         dc.decode_pair_perturb(base, dparams, feats, T, dt,
                                                True))
            mp = lay.prep(members, dt)
            seq1, lp1 = (x[:n] for x in dc.decode_fused(mp, feats2, T, True))
            lp_k1 = float((lp2 - lp1).abs().max())
            if not torch.equal(seq2, seq1) or lp_k1 > 2e-5:
                raise AssertionError(
                    f"[33] K2 {dt}, chunk {c}: tokens not bitwise K1's on "
                    f"prep(base ± delta), or lp {lp_k1:.3g} from K1's > 2e-5")
            seq_p, lp_p = (x.reshape(2 * P, B, T)[:n] for x in
                           dc.decode_pair_perturb_plain(base, dparams, feats,
                                                        T, dt, True))
            if dt == torch.float32:
                err = float((lp2 - lp_p).abs().max())
                if not torch.equal(seq2, seq_p) or err > 2e-5:
                    raise AssertionError(f"[33] K2 f32, chunk {c}: tokens "
                                         f"or lp ({err:.3g}) differ from the "
                                         "plain twin")
                k2_err = max(k2_err, err)
                how = (f"tokens equal the plain twin, max |lp - plain| "
                       f"{err:.3g}")
            else:
                gap = dc.decode_fused_plain(mp, feats2, T, True,
                                            top2_gap=True)[2][:n]
                share, n_diff = check_near_ties(seq2, seq_p, gap,
                                                f"[33] K2 bf16, chunk {c}")
                how = (f"{share:.4%} of rows identical to the plain twin, "
                       f"{n_diff} differ at near-ties")
            log(f"[33] K2 {dt}, f32 delta, chunk {c} ({real} real pairs x "
                f"{B} rows): tokens bitwise K1's on prep(base ± delta), max "
                f"|lp - K1 lp| {lp_k1:.3g}; {how}")
            del mp, seq1, lp1, seq_p, lp_p
        if c == 0:
            keep = {"dparams": dparams, "feats": feats, "feats2": feats2,
                    "members": members, "seq": seq2}
        del deltas, members

    # ---- the same generation at pop_chunk REGIME_CHUNK_ALT -----------------
    def one_generation(p: int):
        e = NESEngine(task, Adam(stepsize), MutationKind.DEFAULT, pop_chunk=p,
                      kernel_perturb=True, delta_dtype="f32")
        th, _, packed = e.generation(theta0, e.optimizer.init(e.dim, dev),
                                     sens, sigma, seeds1, idx1, stepsize, l2)
        return e, th, packed

    def gradient(e, packed, absum=None):
        """The engine's gradient of its generation (``_accumulate`` over its
        chunks); adds sum_i |w_i| |delta_i| into ``absum`` in f64."""
        nc, _, s_l, _ = e._chunked(seeds1, None, None)
        w = e._pair_weights(packed[:2 * F].reshape(F, 2), s_l.shape)
        g = torch.zeros_like(scale_dec)
        for c in range(nc):
            d = e._deltas(scale_dec, s_l[c])
            g = e._accumulate(g, w[c], d)
            if absum is not None:
                absum += (w[c][:, None].abs() * d.abs()).double().sum(0)
        return g

    runs = {p: one_generation(p) for p in (P, REGIME_CHUNK_ALT)}
    (e48, th48, pk48), (e40, th40, pk40) = runs[P], runs[REGIME_CHUNK_ALT]
    if e40._plan(F) != (F // REGIME_CHUNK_ALT, REGIME_CHUNK_ALT):
        raise AssertionError(f"[33] pop_chunk 40 plan {e40._plan(F)}")
    if not torch.equal(pk48[:2 * F], pk40[:2 * F]):
        raise AssertionError("[33] fitnesses differ between pop_chunk 48 "
                             "and 40")
    absum = torch.zeros_like(scale_dec, dtype=torch.float64)
    g48 = gradient(e48, pk48, absum)
    g40, t_gdelta = events_ms(lambda: gradient(e40, pk40))
    u = 2.0 ** -24
    bound = 2 * (F * u / (1 - F * u)) * absum
    gdiff = (g48 - g40).abs().double()

    def adam_step(g):
        return e48._apply_grad(theta0, e48.optimizer.init(e48.dim, dev),
                               lay.from_dec(g), 2 * F, stepsize, l2)[1]

    if not (torch.equal(adam_step(g48), th48)
            and torch.equal(adam_step(g40), th40)):
        raise AssertionError("[33] a generation's theta is not Adam's step "
                             "on its own gradient")
    if not bool((gdiff <= bound).all()):
        raise AssertionError(f"[33] pop_chunk 40 against 48: the gradient "
                             f"is beyond the sum-order bound by "
                             f"{float((gdiff - bound).max()):.3g}")
    dth = (th48 - th40).abs()
    log(f"[33] generation 1 at pop_chunk {P} ({n_chunks} chunks, "
        f"{n_chunks * P - F} pad lanes) and {REGIME_CHUNK_ALT} "
        f"({F // REGIME_CHUNK_ALT} chunks, none): fitnesses of {F} pairs bit "
        f"for bit; gradients differ in {int((gdiff > 0).sum())} of "
        f"{gdiff.numel():,} elements (max {float(gdiff.max()):.3g}, within "
        f"2 gamma_{F} sum|w||delta|); theta differs in "
        f"{int((dth > 0).sum())} elements (max {float(dth.max()):.3g}); "
        f"each theta is Adam's step on its gradient")
    del g40, absum, bound, gdiff, runs, e40, th40, pk40

    # ---- one block with tpu.kernel_noise (the same task) -----------------
    make_task = tasks.make_task
    # the same data and settings as the delta run's task: its scorer over
    # the 113,287 train images is built once
    tasks.make_task = lambda *a, **k: task
    try:
        master_n = NESMaster(experiment("kernel_noise", kernel_noise=True),
                             device=dev, data=data)
    finally:
        tasks.make_task = make_task
    if not master_n.engine._kernel_noise or master_n.task is not task:
        raise AssertionError("[33] tpu.kernel_noise did not resolve on")
    c_n, t_n = counted(lambda: master_n.run_master(max_iterations=gpd))
    if c_n != want(decode_pair_rng=n_chunks * gpd, pair_grad_rng=gpd,
                   decode_rows=gpd):
        raise AssertionError(f"[33] kernel-noise launches {c_n}")
    scores_n = np.asarray(master_n.stats.score_stats(), np.float64)
    if not np.isfinite(scores_n).all() or \
            not bool(torch.isfinite(master_n.theta).all()):
        raise AssertionError("[33] the kernel-noise run: non-finite output")
    ms_n = master_n.stats.time_stats()
    log(f"[33] NESMaster, tpu.kernel_noise: {gpd} generations in {t_n:.1f} "
        f"s (one block); ms per generation {[round(t * 1e3, 3) for t in ms_n]}"
        f"; K5 {c_n['decode_pair_rng']} ({n_chunks} per generation), K6 "
        f"{c_n['pair_grad_rng']} (one per generation over {n_chunks * P} "
        f"lanes), row-block K1 {c_n['decode_rows']}, K2 0 ({card})")

    # ---- K5 against K2 fed K7's dump; K6 over the generation's lanes ----
    scale_params = lay.prep(scale_dec, torch.float32)
    feats0, feats2 = keep["feats"], keep["feats2"]
    dump = dc.pair_delta_dump(scale_params, seeds_l[0])
    k5_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        seq5, lp5 = dc.decode_pair_rng(base, scale_params, seeds_l[0], feats0,
                                       T, dt, True)
        seq2, lp2 = dc.decode_pair_perturb(base, dump, feats0, T, dt, True)
        if not (torch.equal(seq5, seq2) and torch.equal(lp5, lp2)):
            raise AssertionError(f"[33] K5 {dt}: not bitwise K2 fed K7's "
                                 "dump")
        seq_p, lp_p = (x.reshape(2 * P, B, T) for x in
                       dc.decode_pair_rng_plain(base, scale_params,
                                                seeds_l[0], feats0, T, dt,
                                                True))
        dflat = dc.pair_delta_dump_flat(scale_dec, seeds_l[0])
        pert = torch.stack([base_vec + dflat, base_vec - dflat],
                           1).reshape(2 * P, -1)
        gap = dc.decode_fused_plain(lay.prep(pert, dt), feats2, T, True,
                                    top2_gap=True)[2]
        seq5 = seq5.reshape(2 * P, B, T)
        share, n_diff = check_near_ties(seq5, seq_p, gap, f"[33] K5 {dt}")
        if dt == torch.float32:
            ok = (seq5 == seq_p).all(-1)
            k5_err = float((lp5.reshape(2 * P, B, T) - lp_p).abs()[ok].max())
        log(f"[33] K5 {dt}, chunk 0 ({P} pairs x {B} rows): tokens and lp "
            f"bitwise K2's fed K7's dump; {share:.4%} of rows identical to "
            f"the plain version, {n_diff} differ at near-ties"
            + (f", max |lp - plain| {k5_err:.3g} on identical rows"
               if dt == torch.float32 else ""))
        del pert, gap, seq_p, lp_p, dflat
    del dump

    w_all = e48._pair_weights(pk48[:2 * F].reshape(F, 2),
                              seeds_l.shape).reshape(-1)
    seeds_all = seeds_l.reshape(-1)
    grad6 = dc.pair_grad_rng_flat(scale_dec, seeds_all, w_all)
    ordered = torch.zeros_like(grad6)
    for c in range(n_chunks):
        dumps = dc.pair_delta_dump_flat(scale_dec, seeds_l[c])
        for i in range(P):
            ordered = ordered + w_all[c * P + i] * dumps[i]
    del dumps
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    if not torch.equal(bits(grad6), bits(ordered)):
        raise AssertionError("[33] K6: not bitwise the ordered sum of K7's "
                             "dumps")
    grad6_plain, k6_plain = events_ms(lambda: lay.flat_dec(
        dc.pair_grad_rng_plain(scale_params, seeds_all, w_all)))
    k6_err = float((grad6 - grad6_plain).abs().max())
    if not torch.equal(bits(grad6), bits(grad6_plain)):
        raise AssertionError(f"[33] K6: not bitwise its plain version (max "
                             f"{k6_err:.3g})")
    log(f"[33] K6 over {seeds_all.shape[0]} lanes ({n_chunks * P - F} pads "
        f"weighted 0): bitwise the ordered f32 sum of K7's dumps and its "
        f"plain version on the card (the plain version {k6_plain:.1f} ms)")
    del ordered, grad6_plain

    # ---- one generation of each run under torch.profiler -------------------
    profiled = {}
    for name, e in (("delta operands", eng), ("kernel noise",
                                              master_n.engine)):
        wall, busy, rows = profile_call(lambda: e.generation(
            theta0, e.optimizer.init(e.dim, dev), sens, sigma, seeds1, idx1,
            stepsize, l2))
        normals = sum(n for _, n, key in rows if "normal" in key.lower())
        profiled[name] = (wall, busy, normals)
        log(f"[33] one {name} generation under torch.profiler: wall "
            f"{wall:.3f} ms, card busy {busy:.3f} ms (idle "
            f"{1 - busy / wall:.2%}); normal_ kernels {normals} (expected: "
            f"{2 * n_chunks * P if e is eng else 0}, the delta path drawing "
            f"each of its {n_chunks * P} lanes twice) ({card})")
        for ms, count, key in rows[:10]:
            log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")

    # ---- the three kernels at these shapes --------------------------------
    dparams0, members0 = keep["dparams"], keep["members"]
    info = dc.pair_cluster_info(torch.bfloat16, torch.float32)
    ctas, waves = info["cluster"] * P, P / info["max_active_clusters"]
    log(f"[33] the pair kernel at {P} pairs, f32 delta: {P} clusters of "
        f"{info['cluster']} CTAs ({ctas} CTAs, {info['smem_bytes']} B shared "
        f"memory each), cudaOccupancyMaxActiveClusters "
        f"{info['max_active_clusters']}: {waves:.2f} waves on the card's "
        f"SMs; {B} rows fill {B / 128:.0%} of each 128-row tile")
    k2_ms = time_ms(lambda: dc.decode_pair_perturb(
        base, dparams0, feats0, T, torch.bfloat16, False))
    _, k2_plain = events_ms(lambda: dc.decode_pair_perturb_plain(
        base, dparams0, feats0, T, torch.bfloat16, False))
    k5_ms = time_ms(lambda: dc.decode_pair_rng(
        base, scale_params, seeds_l[0], feats0, T, torch.bfloat16, False))
    _, k5_plain = events_ms(lambda: dc.decode_pair_rng_plain(
        base, scale_params, seeds_l[0], feats0, T, torch.bfloat16, False))
    k6_ms = time_ms(lambda: dc.pair_grad_rng_flat(scale_dec, seeds_all,
                                                  w_all))
    mp16 = lay.prep(members0, torch.bfloat16)

    # the chunk's 2P members
    lib_ms = time_ms(lambda: cublas_decode(feats2, mp16, T))
    del mp16
    steps2 = executed_steps(keep["seq"], T)
    flops = decode_flops(steps2, B, Fd, task.model.options.vocab_size + 1)
    nb = lambda d: sum(v.numel() * v.element_size()  # noqa: E731
                       for v in d.values())
    out_bytes = 2 * P * B * T * 8
    feat_bytes = P * B * Fd * 2
    # this design's floor: a pair runs until both signs' rows end and its
    # f32 delta tiles cross from HBM on every step (48 deltas, 556 MB, do
    # not fit the 50 MB L2): img_w once, the gates on every LSTM step, the
    # logits on every token step
    per = {k: v[0].numel() * 4 for k, v in dparams0.items()}
    pair_steps = steps2.reshape(P, 2).max(-1).values.double()
    floor_ms = float((per["img_w"] + (pair_steps + 1) * (per["i2h_w"]
                      + per["h2h_w"]) + pair_steps * per["logit_w"]).sum()
                     ) / HBM_BYTES_PER_S * 1e3
    n5 = P * lay.dim_dec
    n6 = seeds_all.shape[0] * lay.dim_dec
    shape = {"ctas_per_launch": ctas, "clusters": P,
             "max_active_clusters": info["max_active_clusters"],
             "waves": waves}
    rows = []
    for name, replaces, ms, plain, b, launches, err, lib, extra, note in (
        ("decode_pair_perturb_regime",
         "nes_img_captioning_tpu/ops/decode_pallas.py:325", k2_ms, k2_plain,
         regime_bound(nb(base) + nb(dparams0) + feat_bytes + out_bytes,
                      flops),
         c_d["decode_pair_perturb"], k2_err, lib_ms, shape,
         f"; this design's floor (f32 delta tiles re-read from HBM on every "
         f"step) {floor_ms:.4f} ms"),
        ("decode_pair_rng_regime",
         "nes_img_captioning_tpu/ops/decode_pallas.py:488", k5_ms, k5_plain,
         regime_bound(2 * nb(base) + feat_bytes + out_bytes + P * 4, flops,
                      n5, NORMAL_F32_OPS),
         c_n["decode_pair_rng"], k5_err, lib_ms, shape, ""),
        ("pair_grad_rng_regime",
         "nes_img_captioning_tpu/ops/decode_pallas.py:587", k6_ms, k6_plain,
         regime_bound(2 * lay.dim_dec * 4 + seeds_all.shape[0] * 8, 0.0, n6,
                      NORMAL_F32_OPS + GRAD_SUM_OPS),
         c_n["pair_grad_rng"], k6_err, None, {"delta_path_ms": t_gdelta},
         f"; the delta-operand gradient {t_gdelta:.3f} ms"),
    ):
        b_ms, b_by, t_bytes, t_ops = b
        rows.append({"name": name, "route": "cuda",
                     "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     **extra})
        log(f"[33] {name}: {ms:.3f} ms per launch (plain {plain:.3f} ms, "
            + (f"cuBLAS products {lib:.3f} ms" if lib is not None else
               "no library call")
            + f"; bound {b_ms:.4f} ms by {b_by}: bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f} ms, {b_ms / ms:.1%} of it){note}; "
            f"{launches} launches in its run ({card})")

    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    shutil.rmtree(runs_dir)
    train_cider = (task._device_cider,
                   next(t for _, v, t in built if v == "cider-d"))
    del master, master_n, eng, task, keep, base, scale_params, grad6
    torch.cuda.empty_cache()
    log(f"[33] set-up: arrays {setup['arrays_s']:.1f} s, CocoData from "
        f"[35]'s files {setup['data_s']:.2f} s, upload {t_up:.3f} s, NESMaster "
        f"{t_master:.1f} s; peak card memory {peak:.2f} GiB above what "
        f"earlier phases hold ({held / 2**30:.2f} GiB); phase: "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return rows, train_cider


# ---- [36] the ES files at the Karpathy split's size -------------------------

# [36]: generations per path; the paths (the plain, fused and blocked paths
# of [19], and the children in decode order of [31] on the blocked path)
# and the engine calls each makes in SPLIT_ES_ITERS generations
SPLIT_ES_ITERS = 4
SPLIT_ES_PATHS = (("plain", {"fused_es": False}, []),
                  ("fused", {"gens_per_dispatch": 1},
                   ["fused_generation"] * (SPLIT_ES_ITERS - 1)),
                  ("blocked", {}, ["fused_generation", "fused_block"]),
                  ("decode order", {"es_decode_layout": True},
                   ["fused_generation", "fused_block"]))
SPLIT_ES_FILES = (("mscoco_es", ES_SETTINGS), ("mscoco_es_smg_fast",
                                               SMG_SETTINGS))


def layout_replay(phase: str, m, seeds, pidx, idx_row):
    """The layout sweep of ESMaster ``m`` (tpu.es_decode_layout) on its
    parents (SM-G: their sensitivities on ``idx_row``'s rows): raises unless
    its fitnesses are bit for bit ``task.rollout``'s on the same children
    mapped back to torch order by ``from_dec``. Returns the engine's child
    builder (decode order) of that generation."""
    import torch

    eng, task = m.engine, m.task
    lay, chunk = task.decode_layout, eng.pop_chunk
    elites = m._device_elite_rows([p for p, _ in m.it.best_elites() if p])
    parents = torch.cat([elites, m._selected_dev])
    sigma = m.it.noise_stdev()
    sens = (eng.sensitivities(parents, m._sens_batch_rows(idx_row), seeds[0])
            if m.mutation.is_gradient else None)
    fit = eng.eval_generation(parents, sigma, seeds, pidx, idx_row,
                              sens=sens)["fitness"]
    build = eng._child_ctx(parents, sigma, sens)[0]
    pidx_d = torch.as_tensor(pidx.astype(np.int64), device=task.device)
    idx_d = torch.as_tensor(idx_row, device=task.device)
    replay = torch.cat([task.rollout(lay.from_dec(build(
        seeds[i:i + chunk], pidx_d[i:i + chunk])), idx_d)["fitness"]
        for i in range(0, len(seeds), chunk)])
    torch.cuda.synchronize()
    if not torch.equal(replay, fit):
        raise AssertionError(f"{phase}: the layout sweep differs from the "
                             "torch-order rollout of its children")
    return build


def es_split_phase(card: str, data, train_cider: tuple) -> list:
    """Phase 36: experiments/mscoco_es.json and mscoco_es_smg_fast.json, each
    as it is but for depth and log dir, on [35]'s CocoData: 113,287 train
    images (ES's batch drawn from the whole split), DeviceCider over their
    566,435 references, 5000 val images. Each file on the plain, fused and
    blocked paths and with the children in decode order (blocked),
    SPLIT_ES_ITERS generations each (``drive_es``): launch counts and
    engine calls; the first three paths' fitness vectors, children, podium
    rows and mean|policy| bit for bit, the device-scored candidates within
    1e-4 of the plain path's native scorer and bit for bit between the
    fused and blocked paths; the decode-order path's generation 1 (fresh
    inits) bit for bit theirs, and its sweep bit for bit task.rollout of
    its children mapped back. The masters of a file share one task, and
    both files one DeviceCider per reference set: over the train
    references ``train_cider``, [33]'s (its object and build seconds), over
    the val references built once. One
    fused generation of each file under torch.profiler (idle share); for
    mscoco_es.json K1 at the ES launch shape and the row-block launch over
    the 5000 val rows, against their plain twins; for _smg_fast the sweep
    (SM-G scale) at pop_chunk 16 and 48. Returns the two rows of the
    kernels line."""
    import copy
    import shutil

    import torch

    from nes_img_captioning_tpu_torch import tasks
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops import cider_device
    from nes_img_captioning_tpu_torch.utils.config import (
        load_experiment,
        parse_tpu_config,
    )

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    runs_dir = os.path.join("logs", f"chip_smoke_split_es_{os.getpid()}")
    cider_cls, make_task = cider_device.DeviceCider, tasks.make_task
    scorers, built, shared, current = {}, [], {}, {}
    n_train = data.split_len("train")
    scorers[(n_train, "cider-d", True)] = train_cider[0]

    def one_cider(gts_list, *a, **k):
        key = (len(gts_list), k.get("variant", "cider-d"),
               k.get("frozen_df") is None)
        if key not in scorers:
            t0 = time.perf_counter()
            scorers[key] = cider_cls(gts_list, *a, **k)
            torch.cuda.synchronize()
            built.append((key[0], key[1], time.perf_counter() - t0))
        return scorers[key]

    def one_task(exp, *a, **k):
        cfg = current["cfg"]
        if cfg not in shared:
            t0 = time.perf_counter()
            shared[cfg] = (make_task(exp, *a, **k), time.perf_counter() - t0)
        return shared[cfg][0]

    def experiment(cfg: str, settings: tuple, name: str, **tpu) -> dict:
        exp = load_experiment(f"experiments/{cfg}.json")
        got = es_file_settings(cfg, exp)
        if got != settings:
            raise AssertionError(f"[36] {cfg}.json changed: {got}")
        exp["tpu"].update(tpu)
        exp["log_dir"] = os.path.join(runs_dir, cfg, name.replace(" ", "_"))
        return exp

    L, chunk, B = LAYOUT_SHAPE
    k1_per_gen = -(-L // chunk) * -(-B // 128)
    n_refs = sum(g.shape[0] for g in data.split_gts("train"))
    rows, record = [], {}
    cider_device.DeviceCider, tasks.make_task = one_cider, one_task
    try:
        for cfg, settings in SPLIT_ES_FILES:
            current["cfg"] = cfg
            runs = {}
            for name, tpu, want_calls in SPLIT_ES_PATHS:
                m, fits, calls, _, counts = drive_es(
                    experiment(cfg, settings, name, **tpu), dev, data,
                    SPLIT_ES_ITERS)
                want = [SPLIT_ES_ITERS * k1_per_gen,
                        2 * SPLIT_ES_ITERS + (2 if name != "plain" else 0),
                        0, 0, 0, 0]
                if counts != want or calls != want_calls \
                        or len(fits) != SPLIT_ES_ITERS \
                        or not all(np.isfinite(f).all() for f in fits) \
                        or (m.engine._layout is not None) != (
                            name == "decode order"):
                    raise AssertionError(
                        f"[36] {cfg} {name}: launches (K1, row-block K1, K4, "
                        f"K3, K2, K5) {counts}, engine calls {calls}, "
                        f"{len(fits)} fitness vectors, layout "
                        f"{m.engine._layout is not None}")
                if m.task.train_n != data.split_len("train"):
                    raise AssertionError(f"[36] {cfg} {name}: the task has "
                                         f"{m.task.train_n} train images")
                children, podium = es_state(m)
                ms = [round(t * 1e3, 3) for t in m.stats.time_stats()]
                runs[name] = (m, fits, children, podium, counts, ms)
                log(f"[36] {cfg}.json {name} at {m.task.train_n:,} train "
                    f"images: ms per generation {ms} (set-up {m.setup_s:.1f} "
                    f"s, run {m.run_s:.1f} s with its snapshot); K1 launches "
                    f"{counts[0]} ({k1_per_gen} per generation), row-block "
                    f"K1 {counts[1]}; engine calls {calls} under "
                    f"set_sync_debug_mode('error') ({card})")
            pm, pfits, pchildren, ppodium, _, _ = runs["plain"]
            for name in ("fused", "blocked"):
                m, fits, children, podium, _, _ = runs[name]
                if not all(np.array_equal(a, b) for a, b in zip(pfits, fits)) \
                        or not torch.equal(children, pchildren) \
                        or len(podium) != len(ppodium) \
                        or not all(torch.equal(a[1], b[1])
                                   for a, b in zip(podium, ppodium)) \
                        or m.stats.to_dict()["norm_stats"] != \
                        pm.stats.to_dict()["norm_stats"]:
                    raise AssertionError(f"[36] {cfg} {name}: not bit for "
                                         "bit the plain path")
                if not np.allclose(m.stats.acc_stats(), pm.stats.acc_stats(),
                                   rtol=1e-4, atol=1e-6):
                    raise AssertionError(f"[36] {cfg} {name}: candidate "
                                         "scores beyond 1e-4 of the plain "
                                         "path's native scorer")
            fm, bm = runs["fused"][0], runs["blocked"][0]
            if fm.stats.acc_stats() != bm.stats.acc_stats():
                raise AssertionError(f"[36] {cfg}: fused and blocked "
                                     "candidate scores differ")
            dm, dfits = runs["decode order"][0], runs["decode order"][1]
            if not np.array_equal(dfits[0], pfits[0]):
                raise AssertionError(f"[36] {cfg}: the decode-order path's "
                                     "generation 1 (fresh inits) differs")
            acc_gap = max(abs(a - b) for a, b in zip(pm.stats.acc_stats(),
                                                     fm.stats.acc_stats()))
            log(f"[36] {cfg}.json: plain, fused and blocked paths' "
                f"{SPLIT_ES_ITERS} fitness vectors of {L}, "
                f"{pchildren.shape[0]} children, {len(ppodium)} podium rows "
                f"and mean|policy| bit for bit; DeviceCider's candidate "
                f"scores within {acc_gap:.3g} of the native scorer's, fused "
                f"and blocked bit for bit; acc "
                f"{[round(a, 6) for a in fm.stats.acc_stats()]}; decode "
                f"order: generation 1 bit for bit, acc "
                f"{[round(a, 6) for a in dm.stats.acc_stats()]} ({card})")

            # the decode-order sweep replayed in torch order; a fused
            # generation under the profiler
            task, eng = bm.task, bm.engine
            rng = np.random.default_rng(3)
            seeds = rng.integers(0, 2**32, size=L, dtype=np.uint32)
            pidx = rng.integers(0, settings[1], size=L).astype(np.int32)
            idx_row = rng.choice(task.train_n, size=B, replace=False)
            sens_idx = bm._sens_batch_rows(idx_row)
            elites = bm._device_elite_rows(
                [p for p, _ in bm.it.best_elites() if p])
            parents = torch.cat([elites, bm._selected_dev])
            sens = (eng.sensitivities(parents, sens_idx, seeds[0])
                    if bm.mutation.is_gradient else None)
            layout_replay(f"[36] {cfg}", dm, seeds, pidx, idx_row)
            sigma, policy = bm.it.noise_stdev(), bm.policy_theta
            wall, busy, prof = profile_call(lambda: eng.unpack_fused(
                ESEngine.fused_generation(
                    eng, elites, elites.shape[0], bm._selected_dev, sigma,
                    seeds, pidx, idx_row, policy, settings[3],
                    sens=bm._sens_vector, sens_idx=sens_idx)[0], L,
                settings[3]))
            k1_dev = sum(r[0] for r in prof if "member_kernel" in r[2])
            log(f"[36] {cfg}.json: the decode-order sweep of {L} offspring "
                f"bit for bit task.rollout of its children mapped back; one "
                f"fused generation under torch.profiler: wall {wall:.3f} ms, "
                f"card busy {busy:.3f} ms (idle {1 - busy / wall:.2%}); K1 "
                f"{k1_dev:.3f} ms, {k1_dev / busy:.2%} of busy ({card})")
            for ms_k, count, key in prof[:8]:
                log(f"    {ms_k:10.3f} ms  x{count:<5d} {key[:90]}")
            record[cfg] = {
                "ms": {name: r[5] for name, r in runs.items()},
                "setup_s": {name: round(r[0].setup_s, 3)
                            for name, r in runs.items()},
                "idle": 1 - busy / wall, "launches": runs["blocked"][4][0]}

            if cfg == "mscoco_es":
                rows += split_es_kernels(card, bm, parents, seeds, pidx,
                                         idx_row, record[cfg])
            else:
                # the sweep on the SM-G scale at the file's pop_chunk and 48
                exp48 = copy.deepcopy(bm.exp)
                exp48["tpu"]["pop_chunk"] = 48
                eng48 = ESEngine(task, bm.mutation,
                                 pop_chunk=parse_tpu_config(exp48).pop_chunk,
                                 sens_underflow=bm._underflow,
                                 sens_precision=bm.tpu_cfg
                                 .sensitivity_precision,
                                 sens_probes=bm.tpu_cfg.sensitivity_probes)
                sweep_ms, ref = {chunk: [], 48: []}, None
                for c, e in ((chunk, eng), (48, eng48), (48, eng48),
                             (chunk, eng)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    f = e.eval_generation(parents, sigma, seeds, pidx,
                                          idx_row, sens=sens)["fitness"]
                    torch.cuda.synchronize()
                    sweep_ms[c].append((time.perf_counter() - t0) * 1e3)
                    if ref is None:
                        ref = f
                    elif not torch.equal(f, ref):
                        raise AssertionError(f"[36] {cfg}: the sweep at "
                                             f"pop_chunk {c} differs")
                record[cfg]["sweep_ms"] = {c: float(np.mean(v))
                                           for c, v in sweep_ms.items()}
                log(f"[36] {cfg}.json: the sweep of {L} offspring on the "
                    f"SM-G scale at pop_chunk {chunk}: "
                    f"{np.mean(sweep_ms[chunk]):.3f} ms {sweep_ms[chunk]}; "
                    f"at 48: {np.mean(sweep_ms[48]):.3f} ms {sweep_ms[48]}; "
                    f"fitness bit for bit (host clock, ending in "
                    f"synchronize) ({card})")
                rows[0]["smg_fast"] = record[cfg]
            del runs, pm, fm, bm, dm, task, eng, parents, elites, sens
            torch.cuda.empty_cache()
    finally:
        cider_device.DeviceCider, tasks.make_task = cider_cls, make_task
    log(f"[36] set-up shared by the 8 masters: DeviceCider (cider-d) over "
        f"{n_train:,} images [33]'s (built there in {train_cider[1]:.1f} s); "
        + "; ".join(f"DeviceCider ({v}) over {n:,} images {t:.1f} s"
                    for n, v, t in built)
        + f" ({n_refs:,} train references); the task of each file "
        + ", ".join(f"{cfg} {t:.1f} s" for cfg, (_, t) in shared.items())
        + f" (with the DeviceCider builds in it); phase: "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    shutil.rmtree(runs_dir)
    for row in rows:
        row["cider_builds_s"] = [train_cider[1], *(t for _, _, t in built)]
    return rows


def split_es_kernels(card: str, m, parents, seeds, pidx, idx_row,
                     record: dict) -> list:
    """[36]'s kernel rows on mscoco_es.json's blocked ESMaster ``m`` at the
    split's size: K1 at the ES launch shape (16 children x 128 rows of the
    113,287-image split) and the row-block launch over the 5000 val rows
    at the policy's weights, each against its plain twin, with its time,
    cuBLAS yardstick and bound."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    task, eng = m.task, m.engine
    lay = task.decode_layout
    chunk = eng.pop_chunk
    kids = eng.materialize(parents, m.it.noise_stdev(), seeds[:chunk],
                           pidx[:chunk])
    k1 = k1_es_chunk("[36]", task, lay.prep(lay.to_dec(kids),
                                            torch.bfloat16), idx_row)
    del kids
    log(f"[36] K1 at the ES launch shape on the split ({chunk} children x "
        f"128 rows, {k1['ctas']} CTAs, bf16): {k1['ms']:.3f} ms per launch "
        f"(plain twin {k1['plain_ms']:.3f} ms, cuBLAS products "
        f"{k1['library_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms by "
        f"{k1['bound_by']}, {k1['bound_ms'] / k1['ms']:.1%} of it); "
        f"{k1['share']:.4%} of rows as the plain twin's, {k1['n_diff']} "
        f"differ at near-ties, max |lp - plain| {k1['max_abs_err']:.3g}; "
        f"{record['launches']} launches in the blocked run ({card})")

    params = dc.prepare_decode_params(task.spec, m.policy_theta,
                                      task.model.options,
                                      dtype=torch.bfloat16)
    feats = task.device_val_consts()["feats"]
    T = task.model.options.seq_length
    r_ms = time_ms(lambda: dc.decode_rows(params, feats, T, False))
    rp = rows_against_plain("[36]", params, feats, T,
                            task.model.options.vocab_size + 1)
    log(f"[36] decode_rows over the split's {feats.shape[0]} val rows at the "
        f"ES policy (bf16): {r_ms:.3f} ms, {rp['ctas']} CTAs (plain twin "
        f"{rp['plain_ms']:.3f} ms, cuBLAS products {rp['library_ms']:.3f} "
        f"ms, bound {rp['bound_ms']:.4f} ms by {rp['bound_by']}, "
        f"{rp['bound_ms'] / r_ms:.1%} of it); {rp['share']:.4%} of rows as "
        f"the plain twin's, {rp['n_diff']} differ at near-ties, max |lp - "
        f"plain| {rp['max_abs_err']:.3g} over {rp['kept_rows']} rows of "
        f"agreeing blocks ({card})")
    base = {"route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py:658"}
    return [
        {"name": "decode_fused_es_chunk16_split", **base,
         "launches": record["launches"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "ctas_per_launch": k1["ctas"],
         "train_images": task.train_n, "mscoco_es": record},
        {"name": "decode_rows_es_split", **base,
         "launches": 2 * SPLIT_ES_ITERS + 2,
         "max_abs_err": rp["max_abs_err"], "ms": r_ms,
         "plain_ms": rp["plain_ms"], "bound_ms": rp["bound_ms"],
         "bound_by": rp["bound_by"], "library_ms": rp["library_ms"],
         "rows": feats.shape[0], "ctas_per_launch": rp["ctas"]},
    ]


# [34]: the widths the kernels are built for besides 128 (E = R), in order;
# the JAX package's scripts/exp_model_scale.py runs its kernels at these
WIDE = (256, 512)
# [34], [37]: K1 and K4 on the chunk's first 24 pairs' members (48 x 128
# rows), K2 and K5 on a chunk of 48 pairs; K3 on the 48 members x 5 lanes,
# on the seed stream and fed its table (a 3.8 GB f32 table per lane);
# decode_rows over WIDE_ROWS rows; WIDE_GENS timed generations per path
# after a warm-up (2 until [37] came: 1 keeps the smoke in its time limit)
WIDE_MEMBERS, WIDE_LANES = 48, 5
WIDE_ROWS, WIDE_GENS = 5000, 1
# [34]: K4's vocab tile (Vpad / 5)
WIDE_TILE = 1920
# [34], [37], [38]: the plain twins, K3's table (all WIDE_LANES lanes) and
# K2's gates on the first TWIN_CHUNK members or pairs, decode_rows' twin on
# its first TWIN_ROWS rows (all 48 and all 5000 until [38] came: the chunk
# keeps the smoke in its time limit)
TWIN_CHUNK, TWIN_ROWS = 8, 1024
# [38]: the widest library (K-W3), and P3, Up-Down's captioner (Anderson et
# al. 2018, section 3.2.3: a 1000-wide word embedding and LSTM on 2048-d
# pooled features) zero-padded to it (one untimed generation per path: its
# kernels run at 1024's shapes)
W3 = 1024
P3 = ("P3", (1000, 1000, 2048))
# [38]: F9's gate, the batch of the task's row blocks, at these widths
F9_ROWS, F9_WIDTHS = 256, (128, 1024)


# [34]: the niceness of the wide builds, which start once [1]'s build of
# 128 is done (started beside it, the three held [1] for 116-122 s on the
# card machine's 8 cores), so that the phases they overlap keep the cores
# first; the wide libraries are needed only at [34]
WIDE_BUILD_NICE = 10


def start_wide_builds() -> dict:
    """The libraries of WIDE and then of W3 ([38]) built in threads beside
    the rest of the run at niceness WIDE_BUILD_NICE, two at a time (the
    three at once held [1]-[11] 17 s longer): {width: future of (library,
    ptxas report, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    def build(width):
        t0 = time.time()
        lib, report = dc.build_kernels(width, nice=WIDE_BUILD_NICE)
        return lib, report, time.time() - t0

    pool = ThreadPoolExecutor(len(WIDE))
    futures = {w: pool.submit(build, w) for w in WIDE + (W3,)}
    pool.shutdown(wait=False)
    return futures


def shape_case(tag: str, card: str, make_task, suffix: str, seed: int,
               dev, gens: int = WIDE_GENS) -> list:
    """[34]'s and [37]'s checks of one captioner on its kernel library.
    ``make_task(**tpu)`` builds its task in scripts/torch_model_scale.py's
    regime (on the card the decode layout pads a shape no library is built
    for to ``kernel_shape``); ``seed`` draws its theta, batches and seeds.
    K1 on 48 members x 128 rows, f32 (TF32 off) and bf16, logprobs on and
    off, against its plain twin (rows differ only at near-ties: f32 below
    F32_TIE_GAP, bf16 below 1e-2; f32 lp within LP_F32_TOL on the rows that
    agree); K4 at vocab tile 1920 bitwise K1; K3 on the seed stream bitwise
    K3 fed that stream's table, and the table form against its plain twin
    (f32 tokens, lp; bf16 at near-ties); decode_rows over 5000 rows bitwise
    K1 per block of 128; K2 on 48 pairs with bf16 and f32 deltas, bf16 and
    f32 compute, bitwise K1 on prep(base ± delta) in tokens and held to
    its plain twin; K5 bitwise K2 fed K7's dump, which is held to its
    plain version; K6 over the generation's
    144 lanes bitwise the ordered sum of K7's dumps; K7's dumps and K6's
    gradient exactly 0 at every pad, the gradient's from_dec the model's
    size. Then the generation through NESEngine (144 pairs, batch 128,
    pop_chunk 48, bf16, f32 deltas): the pair-kernel and per-member paths
    bit for bit, fitnesses finite, theta moved; the kernel-noise path bit
    for bit the delta-operand path fed K7's dumps; a self_critical
    generation with decode_vocab_tile 1920 (K3 and K4) and validate_device
    (decode_rows), each kernel's launches counted around its path; every
    kernel timed beside its plain twin, a cuBLAS yardstick at the model's
    own widths and its bound on the model's own operations; one profiled
    generation. The plain twins, K3's table (all WIDE_LANES lanes) and
    K2's gates are held on the first TWIN_CHUNK members or pairs (and
    decode_rows' twin on its first TWIN_ROWS rows), the kernel-to-kernel
    gates of K4, K5 and K6 on the whole chunk. ``gens`` timed generations
    per path after a warm-up, or with 0 one untimed generation per path
    (the same gates and launch counts). Returns the kernels line's rows,
    ``<kernel>_<suffix>``."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout
    from scripts.torch_model_scale import (
        SCALE,
        run_generations,
        scale_engine,
        scale_inputs,
    )

    rows_out = []
    # ---- the inputs: scripts/torch_model_scale.py's task and chunk
    task = make_task()
    lay, T = task.decode_layout, task.model.options.seq_length
    o = task.model.options
    # the model's own widths (E0, R0, Fd) and its unpadded layout, for the
    # library yardstick and the bounds; the kernels run at W
    E0, R0, Fd = o.input_encoding_size, o.rnn_size, o.fc_feat_size
    lay0 = DecodeLayout(task.spec, o)
    W = lay.sizes["R"]
    R = dc.cluster_rows(W)
    Vpad, V1 = lay.Vpad, task.data.vocab_size + 1
    pads = lay.to_dec(torch.ones(task.spec.num_params, device=dev),
                      pad_scale=0.0) == 0
    P, B, M = SCALE["pop_chunk"], SCALE["batch"], WIDE_MEMBERS
    gen = torch.Generator(device=dev).manual_seed(seed)
    theta = task.generate_theta(gen)
    base_vec = lay.to_dec(theta)
    scale_dec = lay.to_dec(torch.full_like(theta, SCALE["sigma"]),
                           pad_scale=0.0)
    d32 = torch.stack([scale_dec * torch.randn(
        lay.dim_dec, generator=gen, device=dev) for _ in range(P)])
    members = torch.stack([base_vec + d32[:M // 2],
                           base_vec - d32[:M // 2]], 1).reshape(M, -1)
    idx = torch.as_tensor(np.random.default_rng(seed).integers(
        0, task.train_n, size=(P, B)), device=dev)
    feats = task.train_fc[idx]                        # (P, B, F)
    feats2 = feats[:M // 2].repeat_interleave(2, 0)   # (M, B, F)
    params = {dt: lay.prep(members, dt)
              for dt in (torch.float32, torch.bfloat16)}
    # the plain twins' chunk
    tM, tP = min(TWIN_CHUNK, M), min(TWIN_CHUNK, P)
    tparams = {dt: {k: v[:tM] for k, v in prm.items()}
               for dt, prm in params.items()}
    log(f"{tag}: (E, R, F) = ({E0}, {R0}, {Fd}) laid out at W = {W}, "
        f"F_k = {lay.sizes['F']}: {task.spec.num_params:,} params, dim_dec "
        f"{lay.dim_dec:,} ({lay0.dim_dec:,} unpadded), {R} rows per CTA "
        f"({B // R} row blocks of one cluster per 128-row batch)")
    err = {}

    # ---- K1 against its plain twin
    for dt, prm in tparams.items():
        for need_lp in (True, False):
            seq_k, lp_k = dc.decode_fused(prm, feats2[:tM], T, need_lp)
            seq_p, lp_p, gap_p = dc.decode_fused_plain(
                prm, feats2[:tM], T, need_lp, top2_gap=True)
            torch.cuda.synchronize()
            if dt == torch.float32:
                share, n_diff = check_near_ties(
                    seq_k, seq_p, gap_p, f"{tag} K1 f32",
                    F32_TIE_GAP)
                same = (seq_k == seq_p).all(-1)
                e = float((lp_k - lp_p).abs()[same].max())
                if e > LP_F32_TOL:
                    raise AssertionError(
                        f"{tag} K1 f32 lp={need_lp}: lp {e:.3g} > "
                        f"{LP_F32_TOL}")
                err.setdefault("K1", e)
                log(f"{tag} K1 f32 need_logprobs={need_lp}: "
                    f"{n_diff} rows differ from the plain twin (each "
                    f"first at a top-2 gap < {F32_TIE_GAP}), max |lp - "
                    f"plain| {e:.3g}")
            else:
                share, n_diff = check_near_ties(
                    seq_k, seq_p, gap_p, f"{tag} K1 bf16")
                log(f"{tag} K1 bf16 need_logprobs={need_lp}: "
                    f"{share:.4%} of rows identical, {n_diff} differ at "
                    "near-ties")
    # ---- K4 bitwise K1
    for dt, prm in params.items():
        seq4, lp4 = dc.decode_fused(prm, feats2, T, True, vocab_tile=WIDE_TILE)
        seq1, _ = dc.decode_fused(prm, feats2, T, True)
        if not torch.equal(seq4, seq1):
            raise AssertionError(f"{tag} K4 {dt}: not K1's tokens")
        if dt == torch.float32:
            # as K1's: f32 rows may differ from the twin only at near-ties,
            # and lp is held to it on the rows that agree
            seq_p, lp_p, gap_p = dc.decode_tiled_plain(
                tparams[dt], feats2[:tM], WIDE_TILE, T, top2_gap=True)
            _, n_diff4 = check_near_ties(seq4[:tM], seq_p, gap_p,
                                         f"{tag} K4 f32", F32_TIE_GAP)
            same = (seq4[:tM] == seq_p).all(-1)
            err["K4"] = float((lp4[:tM] - lp_p).abs()[same].max())
            if err["K4"] > LP_F32_TOL:
                raise AssertionError(f"{tag} K4 f32 lp {err['K4']}")
    log(f"{tag} K4 at vocab tile {WIDE_TILE}: tokens bitwise K1's at f32 "
        f"and bf16; f32: {n_diff4} rows differ from the plain twin (each "
        f"first at a top-2 gap < {F32_TIE_GAP}), max |lp - plain| "
        f"{err['K4']:.3g}")
    # ---- K3 at the main path's shape (M members x WIDE_LANES lanes x B
    # rows, the launch timed below): the seed stream bitwise K3 fed that
    # stream's table, and the table form against its plain twin
    lanes = np.random.default_rng(seed).integers(
        0, 2**32, size=(M, WIDE_LANES), dtype=np.uint32)
    table = torch.empty((tM, WIDE_LANES, T, B, Vpad), device=dev)
    for m in range(tM):
        for ln in range(WIDE_LANES):
            for t in range(T):
                table[m, ln, t] = dc.gumbel_table(int(lanes[m, ln]), t,
                                                  B, Vpad, dev)
    for dt, prm in tparams.items():
        seq_s, lp_s = dc.decode_fused(prm, feats2[:tM], T, True,
                                      greedy=False, seeds=lanes[:tM])
        seq_t, lp_t = dc.decode_fused(prm, feats2[:tM], T, True,
                                      greedy=False, gumbel=table)
        seq_p, lp_p, gap_p = dc.decode_sample_plain(
            prm, feats2[:tM], T, True, gumbel=table, top2_gap=True)
        torch.cuda.synchronize()
        if not (torch.equal(seq_s, seq_t) and torch.equal(lp_s, lp_t)):
            raise AssertionError(f"{tag} K3 {dt}: the seed stream "
                                 "is not K3 fed its table")
        share, n_diff = check_near_ties(
            seq_t, seq_p, gap_p, f"{tag} K3 {dt}",
            F32_TIE_GAP if dt == torch.float32 else 1e-2)
        same = (seq_t == seq_p).all(-1)
        if dt == torch.float32:
            err["K3"] = float((lp_t - lp_p).abs()[same].max())
            if err["K3"] > LP_F32_TOL:
                raise AssertionError(f"{tag} K3 f32 lp {err['K3']}")
        log(f"{tag} K3 {dt}, {tM} members x {WIDE_LANES} lanes x {B} "
            f"rows: the seed stream bitwise K3 fed its table; the table "
            f"form {share:.4%} of rows identical to its plain twin, "
            f"{n_diff} at near-ties" + (
            f", max |lp - plain| {err['K3']:.3g}"
                if dt == torch.float32 else ""))
        del seq_p, lp_p, gap_p
    del table
    torch.cuda.empty_cache()
    # ---- decode_rows bitwise K1 per block of 128
    one = {k: v[0] for k, v in params[torch.bfloat16].items()}
    vfeats = torch.randn((WIDE_ROWS, Fd), generator=gen, device=dev)
    seq_r, lp_r = dc.decode_rows(one, vfeats, T, True)
    blocks = [dc.decode_fused(one, vfeats[lo:lo + 128], T, True)
              for lo in range(0, WIDE_ROWS, 128)]
    if not (torch.equal(seq_r, torch.cat([b[0] for b in blocks]))
            and torch.equal(lp_r, torch.cat([b[1] for b in blocks]))):
        raise AssertionError(f"{tag} decode_rows: not K1 per block")
    nr = TWIN_ROWS
    seq_rp, lp_rp, gap_rp = dc.decode_rows_plain(one, vfeats[:nr], T, True,
                                                 top2_gap=True)
    torch.cuda.synchronize()
    share, n_diff = check_near_ties(seq_r[:nr], seq_rp, gap_rp,
                                    f"{tag} decode_rows bf16")
    same = (seq_r[:nr] == seq_rp).all(-1)
    err["rows"] = float((lp_r[:nr] - lp_rp).abs()[same].max())
    if err["rows"] > LP_BF16_TOL:
        raise AssertionError(f"{tag} decode_rows lp {err['rows']}")
    log(f"{tag} decode_rows over {WIDE_ROWS} rows: bitwise "
        f"{len(blocks)} launches of K1 on 128 rows; of the first {nr}, "
        f"{share:.4%} of rows "
        f"identical to its plain twin, {n_diff} at near-ties, max |lp - "
        f"plain| {err['rows']:.3g}")
    # ---- K2 on 48 pairs: bitwise K1 on prep(base ± delta)
    base = lay.prep(base_vec, torch.float32)
    for ddt in (torch.bfloat16, torch.float32):
        dp = lay.prep(d32[:tP].to(ddt), ddt)
        for dt in (torch.bfloat16, torch.float32):
            seq2, lp2 = dc.decode_pair_perturb(base, dp, feats[:tP], T, dt,
                                               True)
            mem = torch.stack([base_vec + d32[:tP].to(ddt).float(),
                               base_vec - d32[:tP].to(ddt).float()],
                              1).reshape(2 * tP, -1)
            prm = lay.prep(mem, dt)
            f2 = feats[:tP].repeat_interleave(2, 0)
            seq1, lp1 = dc.decode_fused(prm, f2, T, True)
            lp_k1 = float((lp2.reshape(2 * tP, B, T) - lp1).abs().max())
            if not torch.equal(seq2.reshape(2 * tP, B, T), seq1) \
                    or lp_k1 > 2e-5:
                raise AssertionError(
                    f"{tag} K2 {dt}, delta {ddt}: not K1 on "
                    f"prep(base ± delta) (lp {lp_k1:.3g})")
            seq_p, lp_p, gap_p = dc.decode_fused_plain(
                prm, f2, T, True, top2_gap=True)
            share, n_diff = check_near_ties(
                seq1, seq_p, gap_p, f"{tag} K2 {dt}",
                F32_TIE_GAP if dt == torch.float32 else 1e-2)
            if dt == torch.float32:
                same = (seq1 == seq_p).all(-1)
                e = float((lp2.reshape(2 * tP, B, T)
                           - lp_p).abs()[same].max())
                if e > LP_F32_TOL:
                    raise AssertionError(f"{tag} K2 f32: lp "
                                         f"{e:.3g} > {LP_F32_TOL}")
                err.setdefault("K2", e)
            log(f"{tag} K2 {dt}, delta {ddt}, {tP} pairs: tokens "
                f"bitwise K1's on prep(base ± delta), max |lp - K1| "
                f"{lp_k1:.3g}; {share:.4%} of rows identical to the "
                f"plain twin, {n_diff} at near-ties")
            del prm, mem
        del dp
    # ---- K5 bitwise K2 fed K7's dump; K6 the ordered sum of the dumps
    scale = lay.prep(scale_dec, torch.float32)
    gseeds = np.random.default_rng(seed).integers(
        0, 2**32, size=SCALE["pairs"], dtype=np.uint32)
    dump = dc.pair_delta_dump(scale, gseeds[:P])
    seq5, lp5 = dc.decode_pair_rng(base, scale, gseeds[:P], feats, T,
                                   torch.bfloat16, True)
    seq2, lp2 = dc.decode_pair_perturb(base, dump, feats, T,
                                       torch.bfloat16, True)
    if not (torch.equal(seq5, seq2) and torch.equal(lp5, lp2)):
        raise AssertionError(f"{tag} K5: not K2 fed K7's dump")
    dump_p = dc.pair_delta_dump_plain(scale, gseeds[:tP])
    err["K7"] = max(float((dump[k][:tP] - dump_p[k]).abs().max())
                    for k in dump)
    del dump, dump_p
    w6 = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, size=SCALE["pairs"]).astype(np.float32), device=dev)
    g6 = dc.pair_grad_rng_flat(scale_dec, gseeds, w6)
    ordered = torch.zeros_like(scale_dec)
    for lo in range(0, SCALE["pairs"], P):
        d7 = dc.pair_delta_dump_flat(scale_dec, gseeds[lo:lo + P])
        if (d7[:, pads] != 0).any():
            raise AssertionError(f"{tag} K7: a pad drew a non-zero delta")
        for i in range(d7.shape[0]):
            ordered = ordered + w6[lo + i] * d7[i]
        del d7
    if not torch.equal(g6, ordered):
        raise AssertionError(f"{tag} K6: not the ordered sum of "
                             "K7's dumps")
    if (g6[pads] != 0).any() or lay.from_dec(g6).shape != (
            task.spec.num_params,):
        raise AssertionError(f"{tag} K6: a pad of the gradient is not 0, "
                             "or from_dec is not the model's size")
    log(f"{tag} K5 bitwise K2 fed K7's dump ({P} pairs); K6 over "
        f"{SCALE['pairs']} lanes of dim_dec {lay.dim_dec:,} bitwise the "
        f"ordered sum of K7's dumps; K7's dumps exactly 0 at all "
        f"{int(pads.sum()):,} pads, K6's gradient too, its from_dec "
        f"{task.spec.num_params:,} long")

    # ---- the main path: torch_model_scale's generation
    del tparams, params[torch.float32]
    torch.cuda.empty_cache()
    seeds, batches = scale_inputs(task, max(gens, 1) + 1)
    n_chunks = -(-SCALE["pairs"] // P)

    def generations(eng, s, b):
        """run_generations, or (gens 0) one untimed generation: (theta,
        packed vectors, ms each)."""
        if gens:
            return run_generations(eng, theta, s[:gens + 1], b[:gens + 1])
        th, _, packed = eng.generation(
            theta, eng.optimizer.init(eng.dim, dev), torch.ones_like(theta),
            SCALE["sigma"], s[0], b[0], SCALE["stepsize"], SCALE["l2coeff"])
        torch.cuda.synchronize()
        return th, packed[None], []
    counters = (dc.decode_fused, dc.decode_pair_perturb,
                dc.decode_pair_rng, dc.pair_grad_rng, dc.decode_sample,
                dc.decode_tiled, dc.decode_rows, dc.pair_delta_dump)
    runs, counts = {}, {}
    for path, kw in (("pair kernel", {}),
                     ("per-member", {"kernel_perturb": False}),
                     ("kernel noise", {"kernel_noise": True})):
        eng = scale_engine(task, **kw)
        for c in counters:
            c.launches = 0
        runs[path] = (eng,) + generations(eng, seeds, batches)
        counts[path] = tuple(c.launches for c in counters)
        th, packs, times = runs[path][1:]
        log(f"{tag} {path}: " + (
            f"{gens} generations after a warm-up, ms each "
            f"{[round(t, 3) for t in times]}, median {np.median(times):.3f}"
            if gens else "one generation (untimed)")
            + f"; launches (K1, K2, K5, K6) {counts[path][:4]} ({card})")
    want = n_chunks * (gens + 1)
    if counts["pair kernel"][:4] != (0, want, 0, 0) \
            or counts["per-member"][:4] != (want, 0, 0, 0) \
            or counts["kernel noise"][:4] != (0, 0, want, gens + 1):
        raise AssertionError(f"{tag} launch counts {counts}")
    (_, th_a, pk_a, t_a), (_, th_b, pk_b, _) = (runs["pair kernel"],
                                                runs["per-member"])
    if not (torch.equal(pk_a, pk_b) and torch.equal(th_a, th_b)):
        raise AssertionError(f"{tag}: pair-kernel and per-member "
                             "generations differ")
    if not torch.isfinite(pk_a).all() or torch.equal(th_a, theta) \
            or not torch.isfinite(runs["kernel noise"][2]).all():
        raise AssertionError(f"{tag}: non-finite fitness or theta "
                             "unchanged")
    eng_n = runs["kernel noise"][0]
    eng_d = scale_engine(task, kernel_perturb=True, delta_dtype="f32")
    eng_d.delta_of = lambda sd, seed: lay.flat_dec(
        dc.pair_delta_dump(lay.prep(sd, torch.float32), seed))
    sens = torch.ones_like(theta)
    dc.pair_delta_dump.launches = 0
    outs = [e.generation(theta, e.optimizer.init(e.dim, dev), sens,
                         SCALE["sigma"], seeds[0], batches[0],
                         SCALE["stepsize"], SCALE["l2coeff"])
            for e in (eng_n, eng_d)]
    k7_launches = dc.pair_delta_dump.launches
    if not (torch.equal(outs[0][2], outs[1][2])
            and torch.equal(outs[0][0], outs[1][0])):
        raise AssertionError(f"{tag}: kernel-noise and "
                             "delta-operand (K7 dumps) generations differ")
    log(f"{tag}: pair-kernel and per-member generations bit for "
        f"bit (packed vectors, theta); fitnesses finite, theta moved; "
        f"the kernel-noise generation bit for bit the delta-operand one "
        f"fed K7's dumps")
    eng = runs["pair kernel"][0]  # profiled below
    del runs, eng_n, eng_d, outs
    torch.cuda.empty_cache()
    # K3 and K4 on their path: a self_critical generation with
    # decode_vocab_tile 1920 (K3 samples, K4 baselines); decode_rows on
    # validate_device's
    sc_task = make_task(fitness="self_critical",
                        decode_vocab_tile=WIDE_TILE)
    sc_eng = scale_engine(sc_task)
    for c in counters:
        c.launches = 0
    _, sc_packs, sc_times = generations(sc_eng, seeds[:2], batches[:2])
    counts["self_critical"] = tuple(c.launches for c in counters)
    vconsts = task.device_val_consts()
    for c in counters:
        c.launches = 0
    val = float(task.validate_device(theta, vconsts))
    counts["validate"] = tuple(c.launches for c in counters)
    if not (counts["self_critical"][4] and counts["self_critical"][5]
            and counts["validate"][6] == 1) \
            or not torch.isfinite(sc_packs).all() or not np.isfinite(val):
        raise AssertionError(f"{tag} self_critical / validation: "
                             f"launches {counts}, fitness finite "
                             f"{bool(torch.isfinite(sc_packs).all())}, "
                             f"val {val}")
    log(f"{tag} self_critical with decode_vocab_tile {WIDE_TILE}: "
        f"{len(sc_times) + 1} generations, timed "
        f"{[round(t, 3) for t in sc_times]} ms, K3 "
        f"{counts['self_critical'][4]} and K4 {counts['self_critical'][5]}"
        f" launches; validate_device over {vconsts['feats'].shape[0]} val "
        f"images: one decode_rows launch, CIDEr {val:.6f} ({card})")
    del sc_task, sc_eng, vconsts

    # ---- times, yardsticks and bounds
    p16 = params[torch.bfloat16]
    dp32 = lay.prep(d32, torch.float32)
    k_ms = {
        "decode_fused": time_ms(lambda: dc.decode_fused(
            p16, feats2, T, False), reps=3),
        "decode_tiled": time_ms(lambda: dc.decode_fused(
            p16, feats2, T, False, vocab_tile=WIDE_TILE), reps=3),
        "decode_sample": time_ms(lambda: dc.decode_fused(
            p16, feats2, T, False, greedy=False, seeds=lanes), reps=2),
        "decode_rows": time_ms(lambda: dc.decode_rows(
            one, vfeats, T, False), reps=3),
        "decode_pair_perturb": time_ms(lambda: dc.decode_pair_perturb(
            base, dp32, feats, T, torch.bfloat16, False), reps=3),
        "decode_pair_rng": time_ms(lambda: dc.decode_pair_rng(
            base, scale, gseeds[:P], feats, T, torch.bfloat16, False),
            reps=3),
        "pair_grad_rng": time_ms(lambda: dc.pair_grad_rng_flat(
            scale_dec, gseeds, w6), reps=3),
        "pair_delta_dump": time_ms(lambda: dc.pair_delta_dump_flat(
            scale_dec, gseeds[:P]), reps=3),
    }
    # the plain twins one call each: the checks above ran their operators
    plain = {
        "decode_fused": time_ms(lambda: dc.decode_fused_plain(
            p16, feats2, T, False), reps=1, warm=False),
        "decode_tiled": time_ms(lambda: dc.decode_tiled_plain(
            p16, feats2, WIDE_TILE, T, False), reps=1, warm=False),
        "decode_sample": time_ms(lambda: dc.decode_sample_plain(
            p16, feats2, T, False, seeds=lanes), reps=1, warm=False),
        "decode_rows": time_ms(lambda: dc.decode_rows_plain(
            one, vfeats, T, False), reps=1, warm=False),
        "decode_pair_perturb": time_ms(
            lambda: dc.decode_pair_perturb_plain(
                base, dp32, feats, T, torch.bfloat16, False), reps=1,
            warm=False),
        "decode_pair_rng": time_ms(lambda: dc.decode_pair_rng_plain(
            base, scale, gseeds[:P], feats, T, torch.bfloat16, False),
            reps=1, warm=False),
        "pair_grad_rng": time_ms(lambda: dc.pair_grad_rng_plain(
            scale, gseeds, w6), reps=1, warm=False),
        "pair_delta_dump": time_ms(lambda: dc.pair_delta_dump_plain(
            scale, gseeds[:P]), reps=1, warm=False),
    }

    # the cuBLAS yardsticks (bf16) and the bounds at the model's own
    # widths (lay0, no width pads: the kernels' own tensors at a built
    # width), so a bound's share shows what the pads cost
    def own(vec_dec, dt, pad_scale=1.0):
        return lay0.prep(lay0.to_dec(lay.from_dec(vec_dec), pad_scale), dt)

    p16_0 = own(members, torch.bfloat16)
    one_0 = {k: v[0] for k, v in p16_0.items()}
    # the pair yardstick's 2P members: the M members twice over, as bf16
    pair16 = {k: torch.cat([v, v])[:2 * P] for k, v in p16_0.items()}
    base_0 = own(base_vec, torch.float32)
    dp32_0 = own(d32, torch.float32, 0.0)
    scale_0 = lay0.to_dec(lay.from_dec(scale_dec), 0.0)
    lib_ms = {
        "decode_fused": time_ms(lambda: cublas_decode(feats2, p16_0, T),
                                reps=3),
        "decode_sample": time_ms(lambda: cublas_decode(
            feats2, p16_0, T, WIDE_LANES, True), reps=2),
        "decode_rows": time_ms(lambda: cublas_decode(vfeats, one_0, T),
                               reps=3),
        "decode_pair_perturb": time_ms(lambda: cublas_decode(
            feats.repeat_interleave(2, 0), pair16, T), reps=3),
        "pair_grad_rng": None, "pair_delta_dump": None,
    }
    lib_ms["decode_tiled"] = lib_ms["decode_fused"]
    lib_ms["decode_pair_rng"] = lib_ms["decode_pair_perturb"]
    del pair16

    def batch_steps(seq):  # a batch of B rows shares one early exit
        return executed_steps(seq.reshape(-1, B, T), T)

    def nbytes(*ts):
        return float(sum(t.numel() * t.element_size() for t in ts))

    w16 = nbytes(*p16_0.values())
    seq1, _ = dc.decode_fused(p16, feats2, T, False)
    seq3, _ = dc.decode_fused(p16, feats2, T, False, greedy=False,
                              seeds=lanes)
    seq2, _ = dc.decode_pair_perturb(base, dp32, feats, T,
                                     torch.bfloat16, False)
    steps1 = batch_steps(seq1)
    steps3 = batch_steps(seq3)
    steps2 = batch_steps(seq2)
    f1 = decode_flops(steps1, B, Fd, V1, E0, R0)
    f3 = decode_flops(steps3, B, Fd, V1, E0, R0)
    f2 = decode_flops(steps2, B, Fd, V1, E0, R0)
    n6 = SCALE["pairs"] * lay0.dim_dec
    bounds = {
        "decode_fused": regime_bound(w16 + nbytes(feats2) / 2
                                     + seq1.numel() * 8, f1),
        "decode_tiled": regime_bound(w16 + nbytes(feats2) / 2
                                     + seq1.numel() * 8, f1),
        "decode_sample": regime_bound(
            w16 + nbytes(feats2) / 2 + lanes.size * 4
            + seq3.numel() * 8, f3,
            f32_ops=GUMBEL_OPS * float(steps3.sum()) * B * V1),
        "decode_rows": regime_bound(
            nbytes(*one_0.values()) + nbytes(vfeats) / 2
            + seq_r.numel() * 8,
            rows_flops(seq_r, Fd, V1, E0, R0)),
        "decode_pair_perturb": regime_bound(
            nbytes(*base_0.values()) + nbytes(*dp32_0.values())
            + nbytes(feats) / 2 + seq2.numel() * 8, f2),
        "decode_pair_rng": regime_bound(
            nbytes(*base_0.values()) + nbytes(scale_0)
            + nbytes(feats) / 2 + seq2.numel() * 8, f2),
        "pair_grad_rng": regime_bound(2 * nbytes(scale_0), 0.0, n6,
                                      NORMAL_F32_OPS + GRAD_SUM_OPS),
        "pair_delta_dump": regime_bound(
            (1 + P) * nbytes(scale_0) + P * 4, 0.0, P * lay0.dim_dec,
            NORMAL_F32_OPS),
    }
    launches = {
        "decode_fused": counts["per-member"][0],
        "decode_pair_perturb": counts["pair kernel"][1],
        "decode_pair_rng": counts["kernel noise"][2],
        "pair_grad_rng": counts["kernel noise"][3],
        "decode_sample": counts["self_critical"][4],
        "decode_tiled": counts["self_critical"][5],
        "decode_rows": counts["validate"][6],
        "pair_delta_dump": k7_launches,
    }
    replaces = {
        "decode_fused": ":658", "decode_tiled": ":658",
        "decode_sample": ":658", "decode_rows": ":658",
        "decode_pair_perturb": ":325", "decode_pair_rng": ":488",
        "pair_grad_rng": ":587", "pair_delta_dump": ":533"}
    errs = {"decode_fused": err["K1"], "decode_tiled": err["K4"],
            "decode_sample": err["K3"], "decode_rows": err["rows"],
            "decode_pair_perturb": err["K2"], "decode_pair_rng": 0.0,
            "pair_grad_rng": 0.0, "pair_delta_dump": err["K7"]}
    pinfo = dc.pair_cluster_info(torch.bfloat16, torch.float32, width=W)
    # 2 signs per cluster, or (at 1024) a cluster per sign
    signs = pinfo["cluster"] // (2 * pinfo["row_blocks"])
    n_cl = P * 2 // signs
    log(f"{tag} the pair kernel (K2, K5's decode) at {P} pairs x {B} rows, "
        f"f32 delta: {n_cl} clusters of {pinfo['cluster']} CTAs "
        f"({pinfo['row_blocks']} row blocks x {signs} sign"
        f"{'s' if signs > 1 else ''} x 2 halves), "
        f"cudaOccupancyMaxActiveClusters {pinfo['max_active_clusters']}: "
        f"{n_cl / pinfo['max_active_clusters']:.2f} waves; K2 "
        f"{k_ms['decode_pair_perturb']:.3f} ms, K5 "
        f"{k_ms['decode_pair_rng']:.3f} ms per launch ({card})")
    ctas = {"decode_pair_perturb": pinfo["cluster"] * n_cl,
            "decode_pair_rng": pinfo["cluster"] * n_cl}
    for name in k_ms:
        b_ms, b_by = bounds[name][:2]
        rows_out.append({
            "name": f"{name}_{suffix}", "width": W,
            "shape": [E0, R0, Fd], "route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": "nes_img_captioning_tpu/ops/decode_pallas.py"
            + replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": k_ms[name],
            "plain_ms": plain[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms[name],
            **({"ctas_per_launch": ctas[name]} if name in ctas else {})})
        lib_txt = ("none" if lib_ms[name] is None
                   else f"{lib_ms[name]:.3f} ms")
        log(f"{tag} {name}: {k_ms[name]:.3f} ms per launch (plain "
            f"{plain[name]:.3f} ms, cuBLAS yardstick {lib_txt}, bound "
            f"{b_ms:.4f} ms by {b_by}, {b_ms / k_ms[name]:.1%} of it); "
            f"{launches[name]} launches on its path ({card})")
    wall_ms, busy, prof = profile_call(lambda: eng.generation(
        theta, eng.optimizer.init(eng.dim, dev), torch.ones_like(theta),
        SCALE["sigma"], seeds[0], batches[0], SCALE["stepsize"],
        SCALE["l2coeff"]))
    log(f"{tag} one pair-kernel generation under torch.profiler: "
        f"wall {wall_ms:.3f} ms, card busy {busy:.3f} ms (idle "
        f"{1 - busy / wall_ms:.2%}) ({card})")
    for ms, count, key in prof[:8]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")
    del task, eng, params, p16, members, d32, dp32
    del p16_0, one_0, base_0, dp32_0
    torch.cuda.empty_cache()
    return rows_out


def library_report(phase: str, W: int, builds: dict) -> None:
    """The library of E = R = ``W`` from ``builds``: its build time, ptxas
    registers and spills, and both cluster kernels' launch shapes (rows per
    cluster, shared memory, ring slots, cudaOccupancyMaxActiveClusters),
    checked against cluster_rows(W)."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    lib, report, build_s = builds[W].result()
    log(f"{phase} E = R = {W}: {lib.name} built in {build_s:.1f} s (queued "
        f"after [1]'s build, two at a time; its own wall time)")
    for name, line in ptxas_lines(report):
        if "decode" in name or "_kernel<" in name:
            log(f"    ptxas {name}: {line}")
    R = dc.cluster_rows(W)
    for wdt, ddt in ((torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32),
                     (torch.float32, torch.bfloat16),
                     (torch.float32, torch.float32)):
        info = dc.pair_cluster_info(wdt, ddt, width=W)
        signs = 1 if info["cluster"] == 2 * info["row_blocks"] else 2
        if info["ring_slots"] < 2 or info["rows"] != R \
                or info["row_blocks"] != 128 // R \
                or info["cluster"] > 16 or (signs == 1 and W < 1024):
            raise AssertionError(f"{phase} pair kernel at {W}: {info}")
        log(f"{phase} W={W} pair kernel, weights {wdt}, delta {ddt}: "
            f"one cluster of {info['cluster']} CTAs per "
            f"{'pair' if signs == 2 else 'sign of a pair'} at 128 "
            f"rows ({info['row_blocks']} blocks of {info['rows']} rows x "
            f"{signs} sign{'s' if signs == 2 else ''} x 2 halves), "
            f"{info['smem_bytes']} B shared memory, "
            f"{info['ring_slots']} ring slots ({info['tile_rows']}-row "
            f"gate tiles, {info['tiles_in_flight']} in flight), "
            f"cudaOccupancyMaxActiveClusters "
            f"{info['max_active_clusters']}")
    for wdt, sampled in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True)):
        info = dc.member_cluster_info(wdt, sampled, width=W)
        if info["ring_slots"] < 2 or info["rows"] != R \
                or info["row_blocks"] != 128 // R \
                or info["cluster"] != 2 * (128 // R):
            raise AssertionError(f"{phase} member kernel at {W}: {info}")
        log(f"{phase} W={W} member kernel ({'K3' if sampled else 'K1, K4'}"
            f"), weights {wdt}: one cluster of {info['cluster']} CTAs "
            f"per member{' and lane' if sampled else ''} at 128 rows "
            f"({info['row_blocks']} blocks of {info['rows']} rows x 2 "
            f"halves), {info['smem_bytes']} B shared memory, "
            f"{info['ring_slots']} ring slots ({info['tile_rows']}-row "
            f"gate tiles, {info['tiles_in_flight']} in flight), "
            f"cudaOccupancyMaxActiveClusters "
            f"{info['max_active_clusters']}")


def widths_phase(card: str, data, builds: dict, dev=None) -> list:
    """Phase 34: the decode kernels at E = R = 256 and 512, each width's
    library built from csrc/ at its first use. Per width: its build time and
    ptxas registers and spills; both cluster kernels' launch shapes (rows
    per cluster, shared memory, ring slots, cudaOccupancyMaxActiveClusters);
    then ``shape_case``'s kernels, generations and times at E = R = W on
    2048-d features. Returns the kernels line's rows, one per kernel and
    width."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from scripts.torch_model_scale import scale_task

    t_phase = time.time()
    dev = torch.device("cuda") if dev is None else dev
    rows_out = []
    for W in WIDE:
        library_report("[34]", W, builds)
        rows_out += shape_case(
            f"[34] W={W}", card,
            lambda W=W, **kw: scale_task(W, dev, data, **kw), f"w{W}", W,
            dev)
    log(f"[34] the widths in {time.time() - t_phase:.1f} s ({card})")
    return rows_out


# [37]: captioners of widths no library is built for, laid out zero-padded
# at kernel_shape on [34]'s libraries: P1 a 300-d word embedding under a
# 512-cell LSTM on ResNet's 2048-d pooled features (E pads to 512); P2 a
# 192-cell LSTM on MobileNetV3-Large's 960-d pooled features (R pads per
# gate block to 256, F to 1024)
PADDED = (("P1", (300, 512, 2048)), ("P2", (256, 192, 960)))
# [37]: NIC-ES generations of P2 with decode-ordered children (generation 1
# fresh inits, generation 2 fused alone, then a block of two)
PADDED_ES_ITERS = 4


def padded_phase(card: str, data, builds: dict, dev=None) -> list:
    """Phase 37: K-W2, the captioners of PADDED on the libraries [34] built
    (no new build): per shape ``shape_case``'s gates, generations and times
    (the yardstick and the bounds at the model's own widths); P1 on
    ``data`` (2048-d), P2 on scripts/torch_model_scale.py's fixture at
    960-d. At P2 also NIC-ES with the children in decode order
    (experiments/mscoco_es.json at P2's widths, PADDED_ES_ITERS
    generations on the blocked path): K1's launches, finite fitnesses and
    the layout sweep bit for bit ``task.rollout`` of its children mapped
    back (``layout_replay``). Returns the kernels line's rows, one per
    kernel and shape."""
    import shutil

    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from scripts.torch_model_scale import scale_data, scale_task

    t_phase = time.time()
    dev = torch.device("cuda") if dev is None else dev
    rows_out = []
    for name, shape in PADDED:
        E, R, F = shape
        W, F_k = dc.kernel_shape(E, R, F)
        lib = builds[W].result()[0]
        shape_data = data if F == 2048 else scale_data(F)
        log(f"[37] {name} (E, R, F) = {shape}: laid out at W = {W}, F_k = "
            f"{F_k}, on {lib.name} ([34]'s library, no new build)")
        rows_out += shape_case(
            f"[37] {name}", card,
            lambda s=shape, d=shape_data, **kw: scale_task(s, dev, d, **kw),
            name.lower(), E + R + F, dev, gens=0)
        if name != "P2":
            continue
        runs_dir = os.path.join("logs", f"chip_smoke_padded_{os.getpid()}")
        exp = layout_experiment("mscoco_es", "padded", runs_dir)
        exp["policy_options"]["model_options"].update(
            input_encoding_size=E, rnn_size=R, fc_feat_size=F)
        m, fits, calls, _, counts = drive_es(exp, dev, shape_data,
                                             PADDED_ES_ITERS)
        L, chunk, B = LAYOUT_SHAPE
        k1_per_gen = -(-L // chunk) * -(-B // 128)
        lay = m.engine._layout
        if lay is None or lay.sizes["R"] != W \
                or counts[0] != PADDED_ES_ITERS * k1_per_gen \
                or calls != ["fused_generation", "fused_block"] \
                or not all(np.isfinite(f).all() for f in fits):
            raise AssertionError(
                f"[37] {name} NIC-ES: layout {lay and lay.sizes}, launches "
                f"(K1, row-block K1, K4, K3, K2, K5) {counts}, engine calls "
                f"{calls}, fitnesses finite "
                f"{[bool(np.isfinite(f).all()) for f in fits]}")
        rng = np.random.default_rng(3)
        seeds = rng.integers(0, 2**32, size=L, dtype=np.uint32)
        pidx = rng.integers(0, exp["population_size"], size=L).astype(
            np.int32)
        idx_row = rng.choice(m.task.train_n, size=B, replace=False)
        layout_replay(f"[37] {name}", m, seeds, pidx, idx_row)
        ms = [round(t * 1e3, 3) for t in m.stats.time_stats()]
        log(f"[37] {name} mscoco_es.json with tpu.es_decode_layout: "
            f"{PADDED_ES_ITERS} generations, ms each {ms} (engine calls "
            f"{calls}), K1 launches {counts[0]}; the layout sweep of {L} "
            f"offspring bit for bit task.rollout of its children mapped "
            f"back by from_dec ({card})")
        del m
        shutil.rmtree(runs_dir)
        torch.cuda.empty_cache()
    log(f"[37] the padded shapes in {time.time() - t_phase:.1f} s ({card})")
    return rows_out


def batch_exit_gate(card: str, data, W: int, dev) -> int:
    """F9 at E = R = ``W``: a batch of F9_ROWS rows with lp asked for, f32,
    through the task's row blocks of 128 (``CocoTask._by_rows``: launches
    with no exit of their own, ``join_row_blocks``) is the one-launch
    result, the plain twin's over the whole batch at once: K1
    (``_greedy``), K3 (``_sample``, 2 lanes) and K2 (the pair rollout's
    blocks), rows differing only at near-ties (F32_TIE_GAP) and lp within
    LP_F32_TOL at every position of the rows that agree. Rows 128.. share
    one blank (zero) image, theta is the init's times 3, and an EOS bias (from the plain twin: 9 in -4..12, then 9
    within 1 of the first that ends a row) ends that block before the
    other's last row, so its finished rows write their
    argmax lp while the batch decodes on (a block with its own exit would
    write 0 there). Returns the count of such positions over the three
    kernels (0 where no bias ends one block before the other: the
    whole-batch gate still holds)."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from scripts.torch_model_scale import scale_task

    t0 = time.time()
    B = F9_ROWS
    n_past = 0
    task = scale_task(W, dev, data, fitness="sc_loss")
    lay, T = task.decode_layout, task.model.options.seq_length
    gen = torch.Generator(device=dev).manual_seed(W + 9)
    theta = task.generate_theta(gen) * 3  # rows that differ by image
    sc = lay.to_dec(torch.full_like(theta, 0.01), pad_scale=0.0)
    members = torch.stack([lay.to_dec(theta), lay.to_dec(theta * 0.9)])
    delta = lay.prep(torch.stack([sc * torch.randn(
        lay.dim_dec, generator=gen, device=dev) for _ in range(2)]),
        torch.float32)
    idx = torch.as_tensor(np.random.default_rng(W).integers(
        0, task.train_n, size=(2, B)), device=dev)
    feats = task.train_fc[idx]
    feats[:, 128:] = 0.0  # the second block: one blank image
    seeds = np.array([[11, 12], [13, 14]], np.uint32)
    f32 = torch.float32

    for kernel in ("K1", "K3", "K2"):
        if kernel == "K2":
            params = lay.prep(members[0], f32)
            bias = params["logit_b"][0]

            def plain(p, gap=False):
                seq, lp = dc.decode_pair_perturb_plain(p, delta, feats, T,
                                                       f32, True)
                if not gap:
                    return seq, lp
                g = torch.stack([dc.decode_fused_plain(
                    dc._perturbed(p, {k: v[i] for k, v in delta.items()},
                                  s, f32), feats[i], T, True,
                    top2_gap=True)[2] for i in range(2)
                    for s in (1.0, -1.0)]).reshape(seq.shape)
                return seq, lp, g

            def run(p):
                return task._by_rows(lambda lo, hi, hold: dc.decode_pair_perturb(
                    p, delta, feats[:, lo:hi], T, f32, True, min_steps=hold),
                    B, 2, True)
        else:
            params = lay.prep(members, f32)
            bias = params["logit_b"][:, 0]
            if kernel == "K3":
                def plain(p, gap=False):
                    return dc.decode_sample_plain(p, feats, T, True,
                                                  seeds=seeds, top2_gap=gap)

                def run(p):
                    return task._sample(p, feats, seeds)
            else:
                def plain(p, gap=False):
                    return dc.decode_fused_plain(p, feats, T, True,
                                                 top2_gap=gap)

                def run(p):
                    return task._greedy(p, feats, need_logprobs=True)

        def block_gap(seq):  # how long the one-image block ends before
            a = executed_steps(seq[..., :128, :], T)
            b = executed_steps(seq[..., 128:, :], T)
            return int((a - b).max())

        # a coarse scan finds where rows begin to end, a fine one around it
        # the bias that ends the one-image block longest before the other
        best, start = None, None
        for lo, hi in ((-4.0, 12.0), (None, None)):
            if lo is None:
                lo, hi = (start - 1.0, start + 1.0) if start is not None \
                    else (-4.0, 12.0)
            for b0 in np.linspace(lo, hi, 9):
                bias[..., 0] = float(b0)
                seq_b = plain(params)[0]
                n = block_gap(seq_b)
                if start is None and bool((seq_b == 0).any()):
                    start = float(b0)
                if best is None or n > best[0]:
                    best = (n, float(b0))
        bias[..., 0] = best[1]
        launches = (dc.decode_fused.launches, dc.decode_sample.launches,
                    dc.decode_pair_perturb.launches)
        seq, lp = run(params)
        launches = tuple(a - b for a, b in zip(
            (dc.decode_fused.launches, dc.decode_sample.launches,
             dc.decode_pair_perturb.launches), launches))
        seq_p, lp_p, gap_p = plain(params, True)
        torch.cuda.synchronize()
        share, n_diff = check_near_ties(seq, seq_p, gap_p,
                                        f"[38] F9 W={W} {kernel}",
                                        F32_TIE_GAP)
        same = (seq == seq_p).all(-1)
        e = float((lp - lp_p).abs()[same].max())
        zero = seq == 0
        first = torch.where(zero.any(-1), zero.int().argmax(-1), T)
        t = torch.arange(T, device=dev)
        last = first.max(-1, keepdim=True).values
        past = (t > first[..., None]) & (t <= last[..., None])
        past_lo = past[..., 128:, :] & (
            t > first[..., 128:].max(-1, keepdim=True).values[..., None])
        if e > LP_F32_TOL or (best[0] > 0 and not (
                past_lo.any() and (lp[..., 128:, :][past_lo] < 0).any())) \
                or launches != {"K1": (2, 0, 0), "K3": (0, 2, 0),
                                "K2": (0, 0, 2)}[kernel]:
            raise AssertionError(
                f"[38] F9 W={W} {kernel}: lp {e:.3g}, positions past the "
                f"block's own exit {int(past_lo.sum())}, launches "
                f"{launches}")
        log(f"[38] F9 W={W} {kernel}: {B} rows in 2 launches with no exit "
            f"of their own, EOS bias {best[1]:.1f} (the one-image block "
            f"ends {best[0]} steps before the batch): {share:.2%} of rows "
            f"the plain twin's over the whole batch, {n_diff} at near-ties, "
            f"max |lp - plain| {e:.3g} at every step; "
            f"{int(past_lo.sum())} positions past that block's own exit "
            f"hold its rows' argmax lp ({card})")
        n_past += int(past_lo.sum())
    del task
    torch.cuda.empty_cache()
    log(f"[38] F9's gate at W={W} in {time.time() - t0:.1f} s")
    return n_past


def w1024_phase(card: str, data, builds: dict, dev=None) -> list:
    """Phase 38: K-W3, the decode kernels at E = R = W3 = 1024 on the
    library built beside the run ([34]'s builds): its build time, ptxas
    registers and spills and both cluster kernels' launch shapes
    (``library_report``); ``shape_case``'s gates, generations and times at
    E = R = 1024, and at P3 zero-padded to it with one untimed generation
    per path (its kernels run at 1024's shapes, its yardstick and bounds
    at its own); then F9's gate at F9_WIDTHS
    (``batch_exit_gate``), blocks that
    end at different steps at one width at least. Returns the kernels
    line's rows."""
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from scripts.torch_model_scale import scale_task

    t_phase = time.time()
    dev = torch.device("cuda") if dev is None else dev
    library_report("[38]", W3, builds)
    rows_out = shape_case(
        f"[38] W={W3}", card,
        lambda **kw: scale_task(W3, dev, data, **kw), f"w{W3}", W3, dev)
    name, shape = P3
    E, R, F = shape
    if dc.kernel_shape(E, R, F)[0] != W3:
        raise AssertionError(f"[38] {name} {shape}: not laid out at {W3}")
    rows_out += shape_case(
        f"[38] {name}", card,
        lambda **kw: scale_task(shape, dev, data, **kw), name.lower(),
        E + R + F, dev, gens=0)
    n_past = sum(batch_exit_gate(card, data, W, dev) for W in F9_WIDTHS)
    if not n_past:
        raise AssertionError("[38] F9: at no width did a block end before "
                             "another (no position past a block's own exit)")
    log(f"[38] the 1024 library in {time.time() - t_phase:.1f} s ({card})")
    return rows_out


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

    t_smoke = time.time()
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    lib, report = dc.build_kernels()
    # the libraries of E = R = 256 and 512 ([34]) build beside the phases
    # from here
    wide_builds = start_wide_builds()
    log(f"[1] kernels built in {time.time() - t0:.1f} s: {lib.name} (the "
        f"libraries of E = R = {', '.join(map(str, WIDE + (W3,)))} build "
        "from here on, beside the phases)")
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

    lib_ms = time_ms(lambda: cublas_decode(feats2, params16, T))
    seq16, _ = dc.decode_fused(params16, feats2, T, False)
    flops = decode_flops(executed_steps(seq16, T), B, Fd,
                         task.model.options.vocab_size + 1)
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
        b_ms, b_by = regime_bound(nbytes, flops)[:2]
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
                          Fd, task.model.options.vocab_size + 1)
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
    t_lap = lap(t_smoke, "[1]-[11]")
    kernels += sampling_phases(task, theta, members, feats2, seeds, batches,
                               sens, lib_ms, card)
    t_lap = lap(t_lap, "[12]-[17]")
    data = val_fixture()
    kernels += validation_phase(card, data)
    t_lap = lap(t_lap, "[18]")
    kernels += es_phase(card, data)
    t_lap = lap(t_lap, "[19]")
    kernels += es_smg_phase(card, data, kernels[-1])
    kernels += nes_smg_phase(card, task, seeds, batches, kernels)
    mnist_masters_phase(card, mnist_task_phase(card))
    t_lap = lap(t_lap, "[20]-[23]")
    host_nes_phase(card, task)
    host_es_phase(card, data)
    norm_phase(card, task.data)
    t_lap = lap(t_lap, "[24]-[26]")
    xent = xent_phase(card, data)
    kernels += test_eval_phase(card, data, xent)
    profile_phase()
    sens_dump_phase(card, data, xent)
    t_lap = lap(t_lap, "[27]-[30]")
    layout_rows, es_ref = es_layout_phase(card, data)
    kernels += layout_rows
    kernels += m16_phase(card, task, es_ref, kernels)
    t_lap = lap(t_lap, "[31]-[32]")
    # [35] writes and reads the split-size files that [33] and [36] run on
    arrays, t_arrays = regime_arrays()
    split_data, t_read = disk_phase(card, arrays, xent["paths"]["xent"])
    del arrays
    shutil.rmtree(xent["runs_dir"])
    t_lap = lap(t_lap, "[35]")
    rows, train_cider = true_regime_phase(
        card, split_data, {"arrays_s": t_arrays, "data_s": t_read})
    kernels += rows
    t_lap = lap(t_lap, "[33]")
    kernels += es_split_phase(card, split_data, train_cider)
    del train_cider
    del split_data
    t_lap = lap(t_lap, "[36]")
    kernels += widths_phase(card, task.data, wide_builds)
    t_lap = lap(t_lap, "[34]")
    kernels += padded_phase(card, task.data, wide_builds)
    t_lap = lap(t_lap, "[37]")
    kernels += w1024_phase(card, task.data, wide_builds)
    lap(t_lap, "[38]")
    log(f"[end] phases [1]-[38] in {time.time() - t_smoke:.1f} s with the "
        f"kernels' build ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-phase"]:
        sys.exit(profile_main())
    if sys.argv[1:2] == ["--rank-phase"]:
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--reload-phase"]:
        sys.exit(reload_main(sys.argv[2:]))
    sys.exit(main())

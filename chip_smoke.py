#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each printed as it ends (any failure exits non-zero):

1. the card's name and power limit; the kernels built with nvcc from
   nes_img_captioning_tpu_torch/csrc/ (ptxas register report);
2. K1 (decode_fused) at full width on a chunk of 48 members, f32 (TF32
   off) and bf16, logprobs on and off, against its plain PyTorch twin;
3. K2 (decode_pair_perturb) on 24 pairs with a bf16 delta: tokens equal K1
   on prep(base ± delta) bit for bit, and held to its plain twin;
4. three whole NIC-NES generations at the bench settings (fc_caption,
   vocab 9487, 144 pairs, batch 128, bf16 weights and deltas, pop_chunk 24,
   Adam, sigma 0.01) on the in-memory synthetic fixture, through the pair
   kernel and through the per-member path, each after one untimed warm-up
   generation: packed vectors bitwise equal, fitnesses finite, theta
   changed, launch counts read around each path;
5. K1's and K2's times at these shapes beside their plain twins', a cuBLAS
   yardstick for their products, and their bound; one profiled generation;
6. K7 (pair_delta_dump) on 24 seeds: the card's Philox words equal the
   plain stream's, and its deltas the plain version's within 8 ulps;
7. K5 (decode_pair_rng), f32 and bf16: tokens and lp bitwise equal to K2
   fed K7's dump, and held to the plain version;
8. K6 (pair_grad_rng) over a generation's 144 lanes: bitwise the ordered
   f32 sum of K7's dumps, and within 1e-6 of its plain version;
9. three kernel-noise generations (tpu.kernel_noise) after a warm-up: K5
   and K6 launched, K1, K2 and K7 not; bitwise equal to the delta-operand
   generation fed K7's dumps; one profiled generation with no normal_
   kernel;
10. NESMaster on experiments/mscoco_nes.json cut to 144 pairs, batch 128,
    pop_chunk 24, bf16, 256 validation images, kernel noise on: 4
    iterations with validation and snapshots, then a resume from the
    snapshot for one more generation — the path a user runs;
11. K5's, K6's and K7's times beside their plain versions', the delta-operand
    path doing the same work, and their bounds.

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

PEAK_BF16 = 989e12      # H100 SXM dense tensor-core bf16, FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12
BENCH = dict(pairs=144, batch=128, pop_chunk=24, sigma=0.01, stepsize=0.001,
             l2coeff=1e-7, gens=3)


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


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


def decode_flops(n_steps, B: int, F: int, Vpad: int) -> float:
    """Multiply-adds x 2 of one decode: the image product, the two gate
    products on every LSTM step, the logits on every token step."""
    W = 128
    n = float(n_steps.sum())
    members = n_steps.numel()
    return 2.0 * B * (members * (F * W + 2 * W * 5 * W)
                      + n * (2 * W * 5 * W + W * Vpad))


def profile_generation(eng, theta, sens, seeds, batches):
    """One generation under torch.profiler: (wall ms, card-busy ms, kernel
    rows (ms, count, name) by device time). Busy is the union of the
    kernels' intervals, so streams that overlap count once."""
    import torch

    state = eng.optimizer.init(eng.dim, theta.device)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.generation(theta, state, sens, BENCH["sigma"], seeds, batches,
                       BENCH["stepsize"], BENCH["l2coeff"])
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.data.core import EpochSampler
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    lib, report = dc.build_kernels()
    log(f"[1] kernels built in {time.time() - t0:.1f} s: {lib.name}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    # ---- the fixture, the task and one generation's inputs -----------------
    t0 = time.time()
    arrays = synthetic_coco_arrays(n_train=2048, n_val=256, n_test=256,
                                   vocab_size=9487, fc_feat_size=2048,
                                   cap_len=9, seed=0)
    exp = {"dataset": "mscoco", "policy_options": {
        "fitness": "greedy", "vbn": False, "model_options": {
            "input_encoding_size": 128, "rnn_size": 128,
            "fc_feat_size": 2048}}}
    task = CocoTask(exp, Config(batch_size=BENCH["batch"]),
                    TpuConfig(seed=0, precision="bf16", delta_dtype="bf16"),
                    device=dev, data=CocoData.from_arrays(arrays))
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
        if not (torch.equal(seq2.reshape(2 * P, B, T), seq1)
                and torch.equal(lp2.reshape(2 * P, B, T), lp1)):
            raise AssertionError(f"K2 {dt}: not bitwise equal to K1 on "
                                 "prep(base ± delta)")
        seq_p, lp_p, gap_p = dc.decode_fused_plain(
            lay.prep(members, dt), feats2, T, True, top2_gap=True)
        if dt == torch.float32:
            if not torch.equal(seq2.reshape(2 * P, B, T), seq_p):
                raise AssertionError("K2 f32: tokens differ from the plain twin")
            err = float((lp2.reshape(2 * P, B, T) - lp_p).abs().max())
            if err > 2e-5:
                raise AssertionError(f"K2 f32: lp error {err:.3g} > 2e-5")
            k2["max_abs_err"] = err
            log(f"[3] K2 f32, bf16 delta: bitwise equal to K1; tokens equal "
                f"the plain twin, max |lp - plain| {err:.3g}")
        else:
            share, n_diff = check_near_ties(seq2.reshape(2 * P, B, T), seq_p,
                                            gap_p, "K2 bf16")
            log(f"[3] K2 bf16, bf16 delta: bitwise equal to K1; {share:.4%} "
                f"of rows identical to the plain twin, {n_diff} differ at "
                f"near-ties")

    # ---- [4] whole generations through both eval paths ----------------------
    F = BENCH["pairs"]
    rng = np.random.default_rng(0)
    sampler = EpochSampler(task.train_n, seed=0)
    seeds = rng.integers(0, 2**32, size=(BENCH["gens"], F), dtype=np.uint32)
    batches = np.stack([sampler.member_batches(F, B)
                        for _ in range(BENCH["gens"])])
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

    def bound(nbytes):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                            else "operations")

    kernels = []
    for name, replaces, ms, plain, nbytes, err, launches in (
        ("decode_fused", "nes_img_captioning_tpu/ops/decode_pallas.py:658",
         k1_ms, k1_plain, k1_bytes, k1["max_abs_err"], counts_b[0]),
        ("decode_pair_perturb",
         "nes_img_captioning_tpu/ops/decode_pallas.py:325",
         k2_ms, k2_plain, k2_bytes, k2["max_abs_err"], counts_a[1]),
    ):
        b_ms, b_by = bound(nbytes)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
        log(f"[5] {name}: {ms:.3f} ms per launch of {2 * P} rollouts "
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
    plain_flat = torch.stack([
        lay.flat_dec(dc.pair_delta_dump_plain(scale_params, int(sd)))
        for sd in seeds24])
    torch.cuda.synchronize()
    k7_err = float((dump_flat - plain_flat).abs().max())
    # logf and cosf are within 1-2 ulp of the exact result, on the card and
    # in torch's kernels alike; |n| < 6, where 8 ulps are 8 * 4.77e-7
    k7_tol = 8 * 4.77e-7 * BENCH["sigma"]
    if k7_err > k7_tol:
        raise AssertionError(f"K7: |delta - plain| {k7_err:.3g} > {k7_tol:.3g}")
    if (dump_flat[:, scale == 0] != 0).any():
        raise AssertionError("K7: a pad lane drew noise")
    same = float((dump_flat == plain_flat).float().mean())
    log(f"[6] K7 pair_delta_dump, {P} seeds x {lay.dim_dec:,}: Philox words "
        f"bitwise equal to the plain stream (known answer too); "
        f"max |delta - plain| {k7_err:.3g} (<= {k7_tol:.3g}: 8 ulps), "
        f"{same:.4%} bitwise equal; pad lanes 0")

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
    dumps = dc.pair_delta_dump(scale_params, seeds_all)
    ordered = torch.zeros_like(grad6)
    for i in range(seeds_all.shape[0]):
        ordered = ordered + w_all[i] * lay.flat_dec(
            {k: v[i] for k, v in dumps.items()})
    del dumps
    if not torch.equal(grad6, ordered):
        raise AssertionError("K6: not bitwise the ordered sum of K7's dumps")
    grad6_plain = lay.flat_dec(dc.pair_grad_rng_plain(scale_params,
                                                      seeds_all, w_all))
    torch.cuda.synchronize()
    k6_err = float((grad6 - grad6_plain).abs().max())
    if k6_err > 1e-6:
        raise AssertionError(f"K6: |grad - plain| {k6_err:.3g} > 1e-6")
    log(f"[8] K6 pair_grad_rng over {seeds_all.shape[0]} lanes: bitwise the "
        f"ordered f32 sum of K7's dumps; max |grad - plain| {k6_err:.3g}")

    # ---- [9] the kernel-noise generation -----------------------------------
    eng_n = NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                      pop_chunk=P, kernel_perturb=True, kernel_noise=True,
                      delta_dtype="bf16")
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

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    master = NESMaster(experiment("train"), device=dev, data=data)
    master.run_master(max_iterations=4)
    torch.cuda.synchronize()
    counts_m = tuple(c.launches for c in counters)
    t_master = time.perf_counter() - t0
    acc = master.stats.acc_stats()
    if master.it.iteration() != 4 or len(acc) != 4 or \
            not np.isfinite(master.stats.score_stats()[1]).all():
        raise AssertionError("NESMaster: 4 finite iterations with "
                             "validation expected")
    if counts_m[2] != 4 * n_chunks or counts_m[3] != 4 or counts_m[0] < 4 \
            or counts_m[1] or counts_m[4]:
        raise AssertionError(f"NESMaster launches (K1, K2, K5, K6, K7) "
                             f"{counts_m}")
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
        f"; launches K1 {counts_m[0]}, K5 {counts_m[2]}, K6 {counts_m[3]}, "
        f"K2 0, K7 0; snapshot {os.path.basename(zinfo[0])}")
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
    k7_ms = time_ms(lambda: dc.pair_delta_dump(scale_params, seeds24))
    k7_plain = time_ms(lambda: dc.pair_delta_dump_plain(scale_params,
                                                        seeds24), reps=2)
    k6_ms = time_ms(lambda: dc.pair_grad_rng(scale_params, seeds_all, w_all))
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
    for name, replaces, ms, plain, nbytes, flops, err, launches, lib, dpath, \
            normals in (
        ("decode_pair_rng", "nes_img_captioning_tpu/ops/decode_pallas.py:488",
         k5_ms, k5_plain, k5_bytes, flops5, k5["max_abs_err"], counts_m[2], lib_ms,
         None, 2 * P * lay.dim_dec),
        ("pair_grad_rng", "nes_img_captioning_tpu/ops/decode_pallas.py:587",
         k6_ms, k6_plain, k6_bytes, 0.0, k6_err, counts_m[3], None, k6_delta,
         seeds_all.shape[0] * lay.dim_dec),
        ("pair_delta_dump", "nes_img_captioning_tpu/ops/decode_pallas.py:533",
         k7_ms, k7_plain, k7_bytes, 0.0, k7_err, check_counts[4], None,
         k7_delta, P * lay.dim_dec),
    ):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nes_img_captioning_tpu_torch/csrc/decode.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "delta_path_ms": dpath,
            "normals_per_s": normals / (ms * 1e-3)})
        log(f"[11] {name}: {ms:.3f} ms per launch (plain {plain:.3f} ms, "
            + (f"cuBLAS products {lib:.3f} ms, " if lib is not None else
               f"delta-operand path {dpath:.3f} ms, ")
            + f"bound {b_ms:.4f} ms by {b_by}; {normals:,} normals, "
            f"{normals / (ms * 1e-3):.4g} per s; {nbytes / 1e6:.1f} MB) "
            f"({card})")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

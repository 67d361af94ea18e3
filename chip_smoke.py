#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each printed as it ends (any failure exits non-zero):

1. the card's name and power limit; the decode kernels built with nvcc
   from nes_img_captioning_tpu_torch/csrc/ (ptxas register report);
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
5. each kernel's time at these shapes beside its plain twin's, a cuBLAS
   yardstick for its products, and its bound.

Then one JSON line of kernel measurements, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. No phase catches a failure.
"""

from __future__ import annotations

import json
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
    state = eng.optimizer.init(eng.dim, dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.generation(theta, state, sens, BENCH["sigma"], seeds[0],
                       batches[0], BENCH["stepsize"], BENCH["l2coeff"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' device time
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages() if evt.device_type == cuda),
                  reverse=True)
    # busy = the union of the kernels' intervals (streams overlap)
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events() if e.device_type == cuda):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy /= 1e3
    log(f"[5] one generation under torch.profiler: wall {wall_ms:.3f} ms, "
        f"card busy {busy:.3f} ms ({busy / wall_ms:.2%}; idle "
        f"{1 - busy / wall_ms:.2%}), kernel time summed over streams "
        f"{sum(r[0] for r in rows):.3f} ms ({card})")
    for ms, count, key in rows[:12]:
        log(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

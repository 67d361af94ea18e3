#!/usr/bin/env python3
"""Time the seven decode kernels of two checkouts of the port on one card,
interleaved, to compare them within one run.

    python3 scripts/torch_kernel_ab.py [--width 128|256|512] [--ptxas DIR]
        ROOT_A ROOT_B

Each ROOT holds a ``nes_img_captioning_tpu_torch`` package (for example this
checkout and an unpacked ``git archive`` of its parent). Both are built at
once (``nvcc`` into each package's ``_build/``), then timed in processes of
their own in the order A, B, B, A. Shapes are the bench's: 24 pairs (48
members), K3 with 5 lanes per member, batch 128, vocab 9487 (Vpad 9600),
2048-d features, bf16 weights, T = 16, K6 over 144 pairs, inputs made from
seed 0. One JSON line per run: ms per launch between CUDA events of K1
(``decode_fused``), K2 (``decode_pair_perturb``, bf16 delta), K3
(``decode_sample``), K4 (``decode_tiled`` at vocab tile 1920), K5
(``decode_pair_rng``), K6 (``pair_grad_rng``) and K7 (``pair_delta_dump``,
its dict wrapper, which both roots have); the device time per launch, under
``torch.profiler``, of K7's kernel alone (``k7_kernel``) and of K5's two
launches (``k5_draw``, the same kernel, and ``k5_decode``); the median
host time of 9 kernel-noise generations (``gen_noise``: ``NESEngine`` with
``tpu.kernel_noise`` at the bench settings, 144 pairs, on the synthetic
fixture, after a warm-up; each ends in ``torch.cuda.synchronize()``); a
SHA-256 of K1's, K2's and K5's tokens and lp (bf16, logprobs on), K6's
gradient and K7's dump; and the card's name and power limit. Then one line
of each time's mean per root and B's change against A in percent. Neither
the decode nor the delta stream may move: the run exits non-zero when a
digest differs between the runs.

``--width 256`` or ``512`` (default 128, the run above) builds and times
that width's library in both roots at ``chip_smoke.py`` [34]'s shapes: E = R
= width, 48 pairs x 128 rows, vocab 9487, 2048-d features, bf16 compute, T
= 16; on the first 24 pairs' 48 members the member kernel's K1, K3 (5
lanes per member, seeded), K4 (vocab tile 1920) and K1 over 5000 rows of
one member (``k1_rows``, ``decode_rows``, validation's launch); K2 with an
f32 delta (as [34] times it) and with a bf16 delta, and K5, with K5's
draw and decode under ``torch.profiler``; and the row records both
kernels' launch shapes (``member_cluster_info``, ``pair_cluster_info``).
The digests are SHA-256 of each kernel's tokens and, apart, of its lp
through each row's EOS (the step on which it first emits 0), logprobs on:
past a row's EOS a batch's rows now share one early exit, where a root
from before the wide member kernel wrote 0 once the row's block of 64 or
32 rows had finished (`ROADMAP.md` §3, F8), so lp there may differ
between such roots; through EOS it may not. The run exits non-zero when
any digest differs.

``--ptxas DIR`` writes each root's ptxas report of the width's build into
``DIR/ptxas_<root directory name>_w<width>.txt`` (registers and spills of
every kernel, to compare the two builds).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

KERNELS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7")
PROFILED = ("k7_kernel", "k5_draw", "k5_decode", "gen_noise")
# --width 256 / 512
WIDE_TIMED = ("k1", "k3", "k4", "k1_rows", "k2", "k2_bf16_delta", "k5",
              "k5_draw", "k5_decode")


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def digest_to_eos(seq, lp) -> dict:
    """SHA-256 of the tokens and, apart, of lp through each row's EOS (lp
    after it set to 0)."""
    import torch

    ended = torch.cumsum((seq == 0).int(), -1)
    read = (ended == 0) | ((ended == 1) & (seq == 0))
    return {"tokens": sha256(seq), "lp_to_eos": sha256(lp * read)}


def noise_generation_ms(reps: int = 9) -> float:
    """Median ms of a kernel-noise generation (K5, K6) at the bench
    settings on the synthetic fixture (``scripts/bench_fixture.py``, as
    ``chip_smoke.py`` [9] runs it), after one warm-up."""
    import time

    import torch
    from bench_fixture import (
        BENCH,
        bench_task,
        generation_inputs,
        noise_engine,
    )

    task = bench_task(torch.device("cuda"))
    theta = task.generate_theta(
        torch.Generator(device="cuda").manual_seed(0))
    eng = noise_engine(task)
    seeds, batches = generation_inputs(task, reps + 1)
    sens = torch.ones_like(theta)
    state = eng.optimizer.init(eng.dim, theta.device)
    times = []
    for g in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        theta, state, _ = eng.generation(
            theta, state, sens, BENCH["sigma"], seeds[g], batches[g],
            BENCH["stepsize"], BENCH["l2coeff"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def profiled_ms(fn, reps: int) -> dict:
    """Device ms per call of fn's kernels by name, under torch.profiler:
    the delta draw (pair_delta_dump_kernel) and the pair decode
    (pair_kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"draw": 0.0, "decode": 0.0}
    for evt in prof.key_averages():
        for part, key in (("draw", "pair_delta_dump_kernel"),
                          ("decode", "pair_kernel")):
            if key in evt.key:
                out[part] += evt.self_device_time_total / 1e3 / reps
    return out


def wide_worker(width: int):
    """One timing run at E = R = ``width`` (the module docstring's shapes)
    in the package first on ``sys.path``: one JSON line."""
    import torch

    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCModelOptions,
        build_spec,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout

    P, B, T, M = 48, 128, 16, 48
    opts = FCModelOptions(vocab_size=9487, fc_feat_size=2048,
                          input_encoding_size=width, rnn_size=width)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator(device="cuda").manual_seed(0)
    theta = lay.spec.init_theta(g)
    base_vec = lay.to_dec(theta)
    scale_vec = lay.to_dec(torch.full_like(theta, 0.01), pad_scale=0.0)
    d32 = torch.stack([scale_vec * torch.randn(
        lay.dim_dec, generator=g, device="cuda") for _ in range(P)])
    members = torch.stack([base_vec + d32[:M // 2],
                           base_vec - d32[:M // 2]], 1).reshape(M, -1)
    feats = torch.randn((P, B, 2048), generator=g, device="cuda")
    feats2 = feats[:M // 2].repeat_interleave(2, 0)
    base = lay.prep(base_vec, torch.float32)
    scale = lay.prep(scale_vec, torch.float32)
    dp32 = lay.prep(d32, torch.float32)
    dp16 = lay.prep(d32.to(torch.bfloat16), torch.bfloat16)
    params = lay.prep(members, torch.bfloat16)
    one = {k: v[0] for k, v in params.items()}
    vfeats = torch.randn((5000, 2048), generator=g, device="cuda")
    del d32, members
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**32, size=P, dtype=np.uint32)
    lanes = rng.integers(0, 2**32, size=(M, 5), dtype=np.uint32)
    runs = {
        "k1": lambda lp=False: dc.decode_fused(params, feats2, T, lp),
        "k3": lambda lp=False: dc.decode_fused(params, feats2, T, lp,
                                               greedy=False, seeds=lanes),
        "k4": lambda lp=False: dc.decode_fused(params, feats2, T, lp,
                                               vocab_tile=1920),
        "k1_rows": lambda lp=False: dc.decode_rows(one, vfeats, T, lp),
        "k2": lambda lp=False: dc.decode_pair_perturb(
            base, dp32, feats, T, torch.bfloat16, lp),
        "k2_bf16_delta": lambda lp=False: dc.decode_pair_perturb(
            base, dp16, feats, T, torch.bfloat16, lp),
        "k5": lambda lp=False: dc.decode_pair_rng(
            base, scale, seeds, feats, T, torch.bfloat16, lp),
    }
    row = {"width": width}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            fn()
        b.record()
        torch.cuda.synchronize()
        row[f"{name}_ms"] = a.elapsed_time(b) / 5
    k5 = profiled_ms(runs["k5"], 3)
    row["k5_draw_ms"], row["k5_decode_ms"] = k5["draw"], k5["decode"]
    row["digest"] = {name: digest_to_eos(*fn(True))
                     for name, fn in runs.items()}
    row["member_cluster_info"] = dc.member_cluster_info(
        torch.bfloat16, width=width)
    row["pair_cluster_info"] = dc.pair_cluster_info(
        torch.bfloat16, torch.float32, width=width)
    return row


def worker(root: str, build: bool, width: int = 128, ptxas: str = ""):
    sys.path.insert(0, root)
    import torch

    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCModelOptions,
        build_spec,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout
    from nes_img_captioning_tpu_torch.ops.noise import lane_seeds

    if build:
        _, report = dc.build_kernels(width)
        if ptxas:
            Path(ptxas).mkdir(parents=True, exist_ok=True)
            name = Path(root).resolve().name or "root"
            (Path(ptxas) / f"ptxas_{name}_w{width}.txt").write_text(report)
        return
    if width != 128:
        row = {"root": root, **wide_worker(width)}
        row["card"] = card()
        print(json.dumps(row), flush=True)
        return
    P, B, T, F = 24, 128, 16, 144
    opts = FCModelOptions(vocab_size=9487, fc_feat_size=2048)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator(device="cuda").manual_seed(0)
    theta = lay.spec.init_theta(g)
    base_vec = lay.to_dec(theta)
    scale_vec = lay.to_dec(torch.full_like(theta, 0.01), pad_scale=0.0)
    d16 = torch.stack([(scale_vec * torch.randn(
        lay.dim_dec, generator=g, device="cuda")).to(torch.bfloat16)
        for _ in range(P)])
    members = torch.stack([base_vec + d16, base_vec - d16], 1).reshape(2 * P, -1)
    feats = torch.randn((P, B, 2048), generator=g, device="cuda")
    feats2 = feats.repeat_interleave(2, 0)
    base = lay.prep(base_vec, torch.float32)
    scale = lay.prep(scale_vec, torch.float32)
    dp16 = lay.prep(d16, torch.bfloat16)
    params = lay.prep(members, torch.bfloat16)
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**32, size=F, dtype=np.uint32)
    weights = torch.as_tensor(rng.uniform(-1, 1, size=F).astype(np.float32),
                              device="cuda")
    lanes = lane_seeds(np.repeat(seeds[:P], 2), np.tile([1, -1], P), 5)
    runs = {
        "k1": lambda: dc.decode_fused(params, feats2, T, False),
        "k2": lambda: dc.decode_pair_perturb(base, dp16, feats, T,
                                             torch.bfloat16, False),
        "k3": lambda: dc.decode_fused(params, feats2, T, False, greedy=False,
                                      seeds=lanes),
        "k4": lambda: dc.decode_fused(params, feats2, T, False,
                                      vocab_tile=1920),
        "k5": lambda: dc.decode_pair_rng(base, scale, seeds[:P], feats, T,
                                         torch.bfloat16, False),
        "k6": lambda: dc.pair_grad_rng(scale, seeds, weights),
        "k7": lambda: dc.pair_delta_dump(scale, seeds[:P]),
    }
    row = {"root": root}
    for name in KERNELS:
        fn = runs[name]
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            fn()
        b.record()
        torch.cuda.synchronize()
        row[f"{name}_ms"] = a.elapsed_time(b) / 10
    row["k7_kernel_ms"] = profiled_ms(runs["k7"], 20)["draw"]
    k5 = profiled_ms(runs["k5"], 5)
    row["k5_draw_ms"], row["k5_decode_ms"] = k5["draw"], k5["decode"]
    seq1, lp1 = dc.decode_fused(params, feats2, T, True)
    seq2, lp2 = dc.decode_pair_perturb(base, dp16, feats, T, torch.bfloat16,
                                       True)
    seq5, lp5 = dc.decode_pair_rng(base, scale, seeds[:P], feats, T,
                                   torch.bfloat16, True)
    g6, d7 = runs["k6"](), runs["k7"]()
    row["gen_noise_ms"] = noise_generation_ms()
    row["digest"] = {
        "k1": sha256(seq1, lp1),
        "k2": sha256(seq2, lp2),
        "k5": sha256(seq5, lp5),
        "k6": sha256(*(g6[k] for k in dc.PAIR_TENSORS)),
        "k7": sha256(*(d7[k] for k in dc.PAIR_TENSORS))}
    row["card"] = card()
    print(json.dumps(row), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def main():
    args = sys.argv[1:]
    opts = {"--width": "128", "--ptxas": ""}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1]
            del args[i:i + 2]
    width = int(opts["--width"])
    if args[0] == "--worker":
        worker(args[1], "--build" in args, width, opts["--ptxas"])
        return
    a, b = args[:2]
    wide = ["--width", str(width)]
    builds = [subprocess.Popen([sys.executable, __file__, "--worker", r,
                                "--build", *wide, "--ptxas", opts["--ptxas"]])
              for r in (a, b)]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    rows = []
    for r in (a, b, b, a):
        # a worker whose kernel stalls is killed, not waited for
        out = subprocess.run([sys.executable, __file__, "--worker", r, *wide],
                             check=True, capture_output=True, text=True,
                             timeout=600)
        print(out.stdout, end="", flush=True)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
    names = KERNELS + PROFILED if width == 128 else WIDE_TIMED
    mean = {r: {k: np.mean([x[f"{k}_ms"] for x in rows if x["root"] == r])
                for k in names} for r in (a, b)}
    same = all(x["digest"] == rows[0]["digest"] for x in rows)
    print(json.dumps({"mean_ms": mean, "b_vs_a_percent": {
        k: 100.0 * (mean[b][k] / mean[a][k] - 1.0) for k in names},
        "digests_equal": same}))
    if not same:
        raise SystemExit("a kernel's digests differ between the roots: "
                         "the decode or the delta stream moved")


if __name__ == "__main__":
    main()

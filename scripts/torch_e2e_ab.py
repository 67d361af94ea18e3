#!/usr/bin/env python3
"""Time the port's end-to-end paths for two checkouts on one card,
interleaved, to compare them within one run.

    python3 scripts/torch_e2e_ab.py ROOT_A ROOT_B [ROUNDS]

Each ROOT holds a ``nes_img_captioning_tpu_torch`` package and its
``experiments/`` and ``scripts/`` (for example this checkout and an
unpacked ``git archive`` of its parent). Both are built at once (``nvcc``
into each package's ``_build/``), then timed in processes of their own in
the order A, B, B, A, and B, A, A, B in a second round (ROUNDS, default 2).
Each process prints one JSON line, every time on the host clock ending in
``torch.cuda.synchronize()``:

- ``nes_pair``, ``nes_member``, ``nes_noise``: ms of 3 NIC-NES
  generations after a warm-up at the bench settings
  (``scripts/bench_fixture.py``: 144 pairs, batch 128, bf16, ``pop_chunk``
  24) on the pair kernel, the per-member path and kernel noise;
- ``es_fused``, ``es_blocked``: ms per generation of ``ESMaster`` on
  ``experiments/mscoco_es.json`` at full width (5000 val images on the
  synthetic fixture), generations 3-6 of 6 (``time_stats``; the blocked
  path's block of 4 split evenly), as ``chip_smoke.py`` [19] runs them;

and the card's name and power limit. Then one line with each metric's
median per root, B's change against A in percent, and in how many of the
A/B pairs (neighbouring runs) B was the slower.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

METRICS = ("nes_pair", "nes_member", "nes_noise", "es_fused", "es_blocked")


def worker(root: str, build_only: bool):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    if not dc.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"{dc.__file__} is not under {root}")
    dc.build_kernels()
    if build_only:
        return
    from bench_fixture import BENCH, bench_task, generation_inputs
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.utils.config import load_experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    task = bench_task(dev)
    seeds, batches = generation_inputs(task, 4)
    theta = task.generate_theta(torch.Generator(device=dev).manual_seed(0))
    sens = torch.ones_like(theta)
    row = {"root": root}
    for name, kw in (("nes_pair", {"kernel_perturb": True}),
                     ("nes_member", {"kernel_perturb": False}),
                     ("nes_noise", {"kernel_perturb": True,
                                    "kernel_noise": True})):
        eng = NESEngine(task, Adam(BENCH["stepsize"]), MutationKind.DEFAULT,
                        pop_chunk=BENCH["pop_chunk"], delta_dtype="bf16",
                        **kw)
        state = eng.optimizer.init(eng.dim, dev)
        ms = []
        for g in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generation(theta, state, sens, BENCH["sigma"], seeds[g],
                           batches[g], BENCH["stepsize"], BENCH["l2coeff"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        row[name] = ms[1:]
    data = CocoData.from_arrays(synthetic_coco_arrays(
        n_train=2048, n_val=5000, n_test=8, vocab_size=9487,
        fc_feat_size=2048, cap_len=9, seed=0))
    for name, tpu in (("es_fused", {"gens_per_dispatch": 1}),
                      ("es_blocked", {})):
        exp = load_experiment(os.path.join(root, "experiments",
                                           "mscoco_es.json"))
        exp["config"]["snapshot_freq"] = 6
        exp["tpu"].update(tpu)
        exp["log_dir"] = tempfile.mkdtemp(prefix=f"e2e_ab_{name}_")
        m = ESMaster(exp, device=dev, data=data)
        m.run_master(max_iterations=6)
        torch.cuda.synchronize()
        row[name] = [t * 1e3 for t in m.stats.time_stats()][2:]
    row["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(row), flush=True)


def run(root: str, *flags: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(root),
                                                   "scripts"))
    return subprocess.run([sys.executable, __file__, "--worker", root,
                           *flags], env=env, check=True, capture_output=True,
                          text=True)


def main():
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], "--build" in sys.argv)
        return
    a, b = sys.argv[1:3]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    builds = [subprocess.Popen(
        [sys.executable, __file__, "--worker", r, "--build"],
        env=dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(r),
                                                     "scripts")))
        for r in (a, b)]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    order = []
    for k in range(rounds):
        order += [a, b, b, a] if k % 2 == 0 else [b, a, a, b]
    rows = []
    for r in order:
        out = run(r)
        print(out.stdout, end="", flush=True)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
    median = {r: {k: float(np.median(np.concatenate(
        [x[k] for x in rows if x["root"] == r]))) for k in METRICS}
        for r in (a, b)}
    pairs = [(rows[i], rows[i + 1]) for i in range(0, len(rows), 2)]
    b_slower = {k: sum(
        bool(np.median(y[k] if y["root"] == b else x[k])
             > np.median(x[k] if y["root"] == b else y[k]))
        for x, y in pairs) for k in METRICS}
    print(json.dumps({"median_ms": median, "b_vs_a_percent": {
        k: 100.0 * (median[b][k] / median[a][k] - 1.0) for k in METRICS},
        "b_slower_in_pairs": b_slower, "pairs": len(pairs)}))


if __name__ == "__main__":
    main()

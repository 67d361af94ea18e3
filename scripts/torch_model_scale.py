#!/usr/bin/env python3
"""The port's NES generation at the captioner widths of the JAX package's
``scripts/exp_model_scale.py``, on one CUDA card.

    python3 scripts/torch_model_scale.py [--widths 128,256,512] [--gens 6]

Same regime as that script: fc_caption with input_encoding_size = rnn_size
= 128, 256 and 512, vocab 9487, 2048-d features, pop 288 (144 antithetic
pairs), batch 128, ``pop_chunk`` 48, bf16 compute, f32 deltas, greedy
fitness on the on-device CIDEr-D, fused decode with the decode layout (the
pair kernel K2 decodes each chunk of 48 pairs), Adam at 0.001, sigma 0.01.
Data: the in-memory synthetic fixture (2048 train, 256 val and 256 test
images with 9-token captions, made from seed 0); ``tpu.rng_impl`` is left
unset (the port's streams are its own). The widths' kernel libraries
build at once at the start (``ops/decode_cuda.build_kernels``).

Prints one JSON line per width: parameters, ``dim_dec``, the kernels'
launches per generation, ms per generation (host clock ending in
``torch.cuda.synchronize()``, median of ``--gens`` after one warm-up), and
the card's name and power limit. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# exp_model_scale.py's regime (pop 288 = 144 pairs)
SCALE = dict(pairs=144, batch=128, pop_chunk=48, sigma=0.01, stepsize=0.001,
             l2coeff=1e-7)
WIDTHS = (128, 256, 512)


def scale_data(fc_feat_size: int = 2048):
    """The synthetic fixture of the bench and of exp_model_scale.py (its
    features ``fc_feat_size`` wide)."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )

    return CocoData.from_arrays(synthetic_coco_arrays(
        n_train=2048, n_val=256, n_test=256, vocab_size=9487,
        fc_feat_size=fc_feat_size, cap_len=9, seed=0))


def scale_task(width, device, data, fitness: str = "greedy", **tpu):
    """The ``CocoTask`` at E = R = ``width`` (2048-d features), or at the
    (E, R, F) tuple ``width``, in the regime above; ``tpu`` overrides
    ``TpuConfig`` fields. On the card the decode layout pads a shape no
    library is built for to ``decode_cuda.kernel_shape``."""
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    E, R, F = (width, width, 2048) if isinstance(width, int) else width
    exp = {"dataset": "mscoco", "policy_options": {
        "fitness": fitness, "vbn": False, "model_options": {
            "input_encoding_size": E, "rnn_size": R, "fc_feat_size": F}}}
    return CocoTask(exp, Config(batch_size=SCALE["batch"]),
                    TpuConfig(seed=0, precision="bf16", **tpu),
                    device=device, data=data)


def scale_engine(task, **kw):
    """NESEngine of the regime: the pair kernel on delta operands unless
    ``kw`` says otherwise (``kernel_perturb=False``: one member per K1
    launch row; ``kernel_noise=True``: K5 and K6)."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    return NESEngine(task, Adam(SCALE["stepsize"]), MutationKind.DEFAULT,
                     pop_chunk=SCALE["pop_chunk"], **kw)


def scale_inputs(task, gens: int):
    """(seeds (gens, pairs) uint32, batches (gens, pairs, batch)) from seed
    0."""
    from nes_img_captioning_tpu_torch.data.core import EpochSampler

    F, B = SCALE["pairs"], SCALE["batch"]
    rng = np.random.default_rng(0)
    sampler = EpochSampler(task.train_n, seed=0)
    seeds = rng.integers(0, 2**32, size=(gens, F), dtype=np.uint32)
    batches = np.stack([sampler.member_batches(F, B) for _ in range(gens)])
    return seeds, batches


def run_generations(eng, theta, seeds, batches):
    """One warm-up generation, then one per row of seeds[1:]: (theta,
    packed vectors (gens, 2F + 2), host ms of each)."""
    import torch

    sens = torch.ones_like(theta)
    state = eng.optimizer.init(eng.dim, theta.device)
    args = (SCALE["stepsize"], SCALE["l2coeff"])
    eng.generation(theta, state, sens, SCALE["sigma"], seeds[0], batches[0],
                   *args)
    torch.cuda.synchronize()
    packs, times = [], []
    for g in range(1, len(seeds)):
        t0 = time.perf_counter()
        theta, state, packed = eng.generation(
            theta, state, sens, SCALE["sigma"], seeds[g], batches[g], *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        packs.append(packed)
    return theta, torch.stack(packs), times


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--gens", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_model_scale: no CUDA device", file=sys.stderr)
        return 2
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc

    widths = [int(w) for w in args.widths.split(",")]
    dev = torch.device("cuda")
    t0 = time.time()
    with ThreadPoolExecutor(len(widths)) as pool:  # all nvcc runs at once
        list(pool.map(dc.build_kernels, widths))
    build_s = time.time() - t0
    data = scale_data()
    for width in widths:
        task = scale_task(width, dev, data)
        eng = scale_engine(task)
        seeds, batches = scale_inputs(task, args.gens + 1)
        theta = task.generate_theta(
            torch.Generator(device=dev).manual_seed(0))
        counters = (dc.decode_fused, dc.decode_pair_perturb)
        for c in counters:
            c.launches = 0
        th, packs, times = run_generations(eng, theta, seeds, batches)
        fits = eng.unpack(packs, SCALE["pairs"])[0]
        if not np.isfinite(fits).all() or torch.equal(th, theta):
            raise SystemExit(f"width {width}: non-finite fitness or theta "
                             "unchanged")
        print(json.dumps({
            "width": width, "params": int(task.spec.num_params),
            "dim_dec": int(task.decode_layout.dim_dec),
            "fused": bool(task._fused),
            "launches_per_generation": {
                "decode_fused": counters[0].launches / (args.gens + 1),
                "decode_pair_perturb": counters[1].launches
                / (args.gens + 1)},
            "ms_per_generation": float(np.median(times)), "ms_each": times,
            "builds_s": build_s, "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

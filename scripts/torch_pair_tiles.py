#!/usr/bin/env python3
"""Time the port's pair kernel at other ring shapes, on one CUDA card.

    python3 scripts/torch_pair_tiles.py [NAME=VALUE[,NAME=VALUE...] ...]

The pair kernel (K2 ``decode_pair_perturb``, and K5's decode) streams its
weights through a ring of KT-row tiles, as many slots as fit in shared
memory up to MAXNS, with up to AHEAD_MAX tiles in flight (``pair::KT``,
``pair::MAXNS``, ``pair::AHEAD_MAX`` in
``nes_img_captioning_tpu_torch/csrc/decode.cu``). Each variant named on the
command line (for example ``KT=32,MAXNS=6``) is the package copied into
``nes_img_captioning_tpu_torch/_build/variants/``, with those constants
rewritten, built there (all builds at once) and timed in a process of its
own beside the package as committed. Shapes are the bench's: 24 pairs,
batch 128, vocab 9487 (Vpad 9600), 2048-d features, bf16 weights, T = 16,
the inputs made from seed 0. One JSON line per build: K1 (the anchor), K2
with a bf16 delta and K2 with an f32 delta (K5's decode), ms per launch
between CUDA events; K2 on the first 15 vocab tiles, and the cost per step
and vocab tile and the fixed cost per step that the two K2 times give; the
ring's slot count and the card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "nes_img_captioning_tpu_torch"


def variant_dir(spec: str) -> Path:
    """The package with the pair:: constants of ``spec`` rewritten."""
    values = dict(kv.split("=") for kv in spec.split(","))
    out = ROOT / PKG / "_build" / "variants" / "_".join(
        f"{k}{v}" for k, v in values.items())
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / PKG, out / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = out / PKG / "csrc" / "decode.cu"
    text = src.read_text()
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"pair::{name} not found in {src}")
    src.write_text(text)
    return out


def worker(root: str):
    """Build (if needed) and time the package under ``root``."""
    sys.path.insert(0, root)
    import torch

    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCModelOptions,
        build_spec,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout

    if "--build" in sys.argv:
        dc.build_kernels()
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    P, B, T = 24, 128, 16
    opts = FCModelOptions(vocab_size=9487, fc_feat_size=2048)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator(device="cuda").manual_seed(0)
    theta = lay.spec.init_theta(g)
    base_vec = lay.to_dec(theta)
    scale = lay.to_dec(torch.full_like(theta, 0.01), pad_scale=0.0)
    d32 = torch.stack([scale * torch.randn(lay.dim_dec, generator=g,
                                           device="cuda") for _ in range(P)])
    members = torch.stack([base_vec + d32, base_vec - d32], 1).reshape(2 * P, -1)
    feats = torch.randn((P, B, 2048), generator=g, device="cuda")
    base = lay.prep(base_vec, torch.float32)
    dp16 = lay.prep(d32.to(torch.bfloat16), torch.bfloat16)
    dp32 = lay.prep(d32, torch.float32)
    params = lay.prep(members, torch.bfloat16)
    feats2 = feats.repeat_interleave(2, 0)

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    row = {"root": root, **dc.pair_cluster_info(torch.bfloat16,
                                                 torch.bfloat16)}
    row["ring_slots_f32_delta"] = dc.pair_cluster_info(
        torch.bfloat16, torch.float32)["ring_slots"]
    row["k1_ms"] = time_ms(lambda: dc.decode_fused(params, feats2, T, False))
    row["k2_bf16_delta_ms"] = time_ms(lambda: dc.decode_pair_perturb(
        base, dp16, feats, T, torch.bfloat16, False))
    row["k2_f32_delta_ms"] = time_ms(lambda: dc.decode_pair_perturb(
        base, dp32, feats, T, torch.bfloat16, False))
    # the same weights cut to the first 15 vocab tiles (Vpad 1920): the
    # difference per step parts the cost of a vocab tile from the fixed
    # cost of a step (a launch lasts its longest pair's steps)
    cut = 1920

    def narrow(d, lead):
        out = dict(d)
        out["logit_w"] = d["logit_w"][..., :cut].contiguous()
        out["logit_b"] = d["logit_b"][..., :cut].contiguous()
        out["embed"] = d["embed"][(slice(None),) * lead
                                  + (slice(0, cut),)].contiguous()
        return out

    base_n, dp16_n = narrow(base, 0), narrow(dp16, 1)
    row["k2_bf16_delta_vpad1920_ms"] = time_ms(lambda: dc.decode_pair_perturb(
        base_n, dp16_n, feats, T, torch.bfloat16, False))
    steps = []
    for b, d in ((base, dp16), (base_n, dp16_n)):
        seq, _ = dc.decode_pair_perturb(b, d, feats, T, torch.bfloat16, False)
        zero = (seq == 0).reshape(P, 2 * B, T)
        first = torch.where(zero.any(-1), zero.int().argmax(-1), T - 1)
        steps.append(int((first.max(-1).values + 1).clamp(max=T).max()))
    row["longest_pair_steps"] = steps
    step_full = row["k2_bf16_delta_ms"] / steps[0]
    step_cut = row["k2_bf16_delta_vpad1920_ms"] / steps[1]
    per_tile = (step_full - step_cut) / (lay.Vpad // 128 - cut // 128)
    row["us_per_step_and_vocab_tile"] = per_tile * 1e3
    row["us_fixed_per_step"] = (step_cut - per_tile * (cut // 128)) * 1e3
    row["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(row), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return
    roots = [str(ROOT)]
    for arg in sys.argv[1:]:
        roots.append(str(variant_dir(arg)))
    builds = [subprocess.Popen([sys.executable, __file__, "--worker", r,
                                "--build"]) for r in roots]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    for r in roots:
        subprocess.run([sys.executable, __file__, "--worker", r], check=True)


if __name__ == "__main__":
    main()

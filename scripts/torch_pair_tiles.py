#!/usr/bin/env python3
"""Time the port's cluster decode kernels at other ring shapes, on one CUDA
card.

    python3 scripts/torch_pair_tiles.py [NAME=VALUE[,NAME=VALUE...] ...]

The pair kernel (K2 ``decode_pair_perturb``, and K5's decode) and the member
kernel (K1 ``decode_fused``, K3 ``decode_sample``, K4 ``decode_tiled``)
stream their weights
through rings of KT-row tiles in shared memory, as many slots as fit up to
MAXNS, with up to AHEAD_MAX tiles in flight (``pair::`` and ``member::``
constants in ``nes_img_captioning_tpu_torch/csrc/decode.cu``). A bare NAME
is a ``pair::`` constant, ``NS.NAME`` one of namespace NS (``member``, or
the wide kernels' ``wmember`` and ``wpair``; ``wmember.AT_128=1`` builds
the wide member kernel into the W = 128 library, ``wpair.AT_128=1`` the
wide pair kernel). Each variant
named on the command line (for example ``KT=32,MAXNS=6`` or
``member.KT=64,member.AHEAD_MAX=2``; ``member.GUMBEL_SKIP=0`` draws every
Gumbel value of K3, ``member.GUMBEL_COUNT=1`` counts the values K3 draws)
is the package copied into
``nes_img_captioning_tpu_torch/_build/variants/``, with those constants
rewritten, built there (all builds at once) and timed in a process of its
own beside the package as committed. No constant moves a sum, so every
build's K1, K4 and K2 tokens, and K3's tokens and lp, must equal the
committed build's bit for bit (which ``chip_smoke.py`` holds to the plain
twin and to each other): a variant that differs is printed with
``"invalid"`` naming the outputs that differ, and is not timed. Shapes are
the bench's: 24 pairs (48 members), K3 with 5 lanes per member, batch 128,
vocab 9487 (Vpad 9600), 2048-d features, bf16 weights, T = 16, the inputs
made from seed 0. One JSON line per build, ms per launch between CUDA
events: K1, K4 at vocab tile 1920, K2 with a bf16 delta and K2 with an f32
delta (K5's decode), K3; K1, K2 and K3 on the first 15 vocab tiles (Vpad
1920), and the cost per step and vocab tile and the fixed cost per step
that each pair of times gives; K3's Gumbel values per second, and with
``member.GUMBEL_COUNT=1`` the share of them that took the two logf; the
kernels' ring shapes and the card.

``--width 256`` or ``512`` times that width's library at ``chip_smoke.py``
[34]'s shapes (48 pairs x 128 rows, bf16, 2048-d features, vocab 9487):
K2 with an f32 and a bf16 delta; K1, K3 (5 lanes per member) and K4 at
vocab tiles 1920 and 128 on the first 24 pairs' 48 members; K1 and K2 also
on the first 15 vocab tiles, for the fixed cost per step and the cost per
step and vocab tile; and K4's split cluster barrier per vocab tile, from
(K4 - K1) / (steps x vocab tiles per step) at each tile. The tokens of
every kernel timed (K3: and its lp) are held to the committed build's.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PKG = "nes_img_captioning_tpu_torch"
WORKER_TIMEOUT_S = 600


def rewrite(text: str, values: dict) -> str:
    """decode.cu's text with each named constant set: ``NAME`` in
    ``namespace pair``, ``member.NAME`` in ``namespace member``; each must
    be defined there exactly once."""
    for key, value in values.items():
        ns, name = key.split(".") if "." in key else ("pair", key)
        start = text.index(f"namespace {ns} {{")
        end = text.index(f"}}  // namespace {ns}", start)
        body, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};",
                          text[start:end])
        if n != 1:
            raise ValueError(f"{ns}::{name} is not defined once in decode.cu")
        text = text[:start] + body + text[end:]
    return text


def variant_dir(spec: str) -> Path:
    """The package with the constants of ``spec`` rewritten."""
    values = dict(kv.split("=") for kv in spec.split(","))
    out = ROOT / PKG / "_build" / "variants" / "_".join(
        f"{k.replace('.', '-')}{v}" for k, v in values.items())
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / PKG, out / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = out / PKG / "csrc" / "decode.cu"
    src.write_text(rewrite(src.read_text(), values))
    return out


def wide_worker(root: str, width: int):
    """Time K1, K2, K3 and K4 of the package under ``root`` at E = R =
    ``width`` (``--width``, the module docstring's shapes): K2 with an f32
    delta (as [34] times it) and a bf16 delta, at Vpad 9600 and cut to its
    first 15 vocab tiles; K1 likewise; K3 and K4 at vocab tiles 1920 and
    128; tokens held to the committed build's."""
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
    scale = lay.to_dec(torch.full_like(theta, 0.01), pad_scale=0.0)
    d32 = torch.stack([scale * torch.randn(lay.dim_dec, generator=g,
                                           device="cuda") for _ in range(P)])
    feats = torch.randn((P, B, 2048), generator=g, device="cuda")
    base = lay.prep(base_vec, torch.float32)
    deltas = {"f32": lay.prep(d32, torch.float32),
              "bf16": lay.prep(d32.to(torch.bfloat16), torch.bfloat16)}
    members = torch.stack([base_vec + d32[:M // 2],
                           base_vec - d32[:M // 2]], 1).reshape(M, -1)
    params = lay.prep(members, torch.bfloat16)
    feats2 = feats[:M // 2].repeat_interleave(2, 0)
    lanes = np.random.default_rng(0).integers(0, 2**32, size=(M, 5),
                                              dtype=np.uint32)
    del d32, members
    cut = 1920

    def narrow(d, lead):
        out = dict(d)
        out["logit_w"] = d["logit_w"][..., :cut].contiguous()
        out["logit_b"] = d["logit_b"][..., :cut].contiguous()
        out["embed"] = d["embed"][(slice(None),) * lead
                                  + (slice(0, cut),)].contiguous()
        return out

    def k2(b, d):
        return dc.decode_pair_perturb(b, d, feats, T, torch.bfloat16, False)

    def k1(p, tile=0):
        return dc.decode_fused(p, feats2, T, False, vocab_tile=tile)

    def k3(need_lp=False):
        return dc.decode_fused(params, feats2, T, need_lp, greedy=False,
                               seeds=lanes)

    row = {"root": root, "width": width,
           "member": dc.member_cluster_info(torch.bfloat16, width=width),
           "member_sampled": dc.member_cluster_info(torch.bfloat16, True,
                                                    width=width),
           "pair": dc.pair_cluster_info(torch.bfloat16, torch.float32,
                                        width=width)}
    tokens = {f"k2_{k}_delta": k2(base, d)[0] for k, d in deltas.items()}
    tokens["k1"] = k1(params)[0]
    tokens["k4_tile1920"] = k1(params, 1920)[0]
    tokens["k4_tile128"] = k1(params, 128)[0]
    tokens["k3"], tokens["k3_lp"] = k3(True)
    ref_path = ROOT / PKG / "_build" / "variants" / f"reference_w{width}.pt"
    if Path(root) == ROOT:
        ref_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in tokens.items()}, ref_path)
    ref = torch.load(ref_path)
    bad = [k for k, v in tokens.items() if not torch.equal(v.cpu(), ref[k])]
    bad += [k for k in ("k4_tile1920", "k4_tile128")
            if not torch.equal(tokens[k], tokens["k1"])]
    if bad:
        row["invalid"] = bad
        print(json.dumps(row), flush=True)
        return
    base_n, params_n = narrow(base, 0), narrow(params, 1)
    timed = [(f"k2_{k}_delta", lambda d=d: k2(base, d),
              lambda d=d, dn=narrow(d, 1): k2(base_n, dn), 2 * B)
             for k, d in deltas.items()]
    timed.append(("k1", lambda: k1(params), lambda: k1(params_n), B))
    for name, full_fn, cut_fn, rows in timed:
        full_ms, cut_ms = time_ms(full_fn), time_ms(cut_fn)
        steps = [int(executed(fn()[0], rows, T).max())
                 for fn in (full_fn, cut_fn)]
        per_tile = (full_ms / steps[0] - cut_ms / steps[1]) / (
            lay.Vpad // 128 - cut // 128)
        row[f"{name}_ms"] = full_ms
        row[f"{name}_vpad{cut}_ms"] = cut_ms
        row[f"{name}_longest_steps"] = steps
        row[f"{name}_us_per_step_and_vocab_tile"] = per_tile * 1e3
        row[f"{name}_us_fixed_per_step"] = (
            cut_ms / steps[1] - per_tile * (cut // 128)) * 1e3
    row["k3_ms"] = time_ms(k3)
    # K4's fold: one split cluster barrier and merge per vocab tile
    steps1 = row["k1_longest_steps"][0]
    for tile in (1920, 128):
        ms = time_ms(lambda: k1(params, tile))
        row[f"k4_tile{tile}_ms"] = ms
        row[f"k4_tile{tile}_us_per_fold"] = (ms - row["k1_ms"]) * 1e3 / (
            steps1 * (lay.Vpad // tile))
        row[f"k4_tile{tile}_us_per_step"] = (ms - row["k1_ms"]) * 1e3 / steps1
    row["card"] = card()
    print(json.dumps(row), flush=True)


def time_ms(fn, reps=5):
    """ms per call of fn between CUDA events, after one warm-up call."""
    import torch

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


def executed(seq, rows, T):
    """Token steps each cluster (of ``rows`` rows) ran: up to the step on
    which its last row emitted 0."""
    import torch

    zero = (seq == 0).reshape(-1, rows, T)
    first = torch.where(zero.any(-1), zero.int().argmax(-1), T - 1)
    return (first.max(-1).values + 1).clamp(max=T)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def worker(root: str, width: int = 128):
    """Build (if needed) and time the package under ``root``."""
    sys.path.insert(0, root)
    import torch

    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCModelOptions,
        build_spec,
    )
    from nes_img_captioning_tpu_torch.ops import decode_cuda as dc
    from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout
    from nes_img_captioning_tpu_torch.ops.noise import lane_seeds

    if "--build" in sys.argv:
        dc.build_kernels(width)
        return
    if width != 128:
        wide_worker(root, width)
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
    # K3's lanes: 5 per member, the lane seeds the engine draws
    lanes = lane_seeds(np.repeat(np.arange(P, dtype=np.uint32) + 7, 2),
                       np.tile([1, -1], P), 5)

    def k1(p):
        return dc.decode_fused(p, feats2, T, False)

    def k2(b, d):
        return dc.decode_pair_perturb(b, d, feats, T, torch.bfloat16, False)

    def k3(p, need_lp=False):
        return dc.decode_fused(p, feats2, T, need_lp, greedy=False,
                               seeds=lanes)

    row = {"root": root,
           "member": dc.member_cluster_info(torch.bfloat16),
           "member_sampled": dc.member_cluster_info(torch.bfloat16, True),
           "pair": dc.pair_cluster_info(torch.bfloat16, torch.bfloat16)}
    row["pair"]["ring_slots_f32_delta"] = dc.pair_cluster_info(
        torch.bfloat16, torch.float32)["ring_slots"]
    # the tokens of every kernel timed, held to the committed build's
    tokens = {
        "k1": k1(params)[0],
        "k4": dc.decode_fused(params, feats2, T, False, vocab_tile=1920)[0],
        "k2_bf16_delta": k2(base, dp16)[0],
        "k2_f32_delta": k2(base, dp32)[0],
    }
    dc.gumbel_counts()  # reset
    tokens["k3"], tokens["k3_lp"] = k3(params, True)
    seen, drawn = dc.gumbel_counts()  # nonzero with member.GUMBEL_COUNT=1
    if seen:
        row["k3_logf_share"] = drawn / seen
        row["k3_values_seen"] = seen
    ref_path = ROOT / PKG / "_build" / "variants" / "reference_tokens.pt"
    if Path(root) == ROOT:
        ref_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in tokens.items()}, ref_path)
    ref = torch.load(ref_path)
    bad = [k for k, v in tokens.items() if not torch.equal(v.cpu(), ref[k])]
    if not torch.equal(tokens["k4"], tokens["k1"]):
        bad.append("k4 against k1")
    if bad:
        row["invalid"] = bad
        print(json.dumps(row), flush=True)
        return
    row["k1_ms"] = time_ms(lambda: k1(params))
    row["k4_tile1920_ms"] = time_ms(lambda: dc.decode_fused(
        params, feats2, T, False, vocab_tile=1920))
    row["k2_bf16_delta_ms"] = time_ms(lambda: k2(base, dp16))
    row["k2_f32_delta_ms"] = time_ms(lambda: k2(base, dp32))
    row["k3_ms"] = time_ms(lambda: k3(params))
    # the same weights cut to the first 15 vocab tiles (Vpad 1920): the
    # difference per step parts the cost of a vocab tile from the fixed
    # cost of a step (a launch lasts its longest member's or pair's steps)
    cut = 1920

    def narrow(d, lead):
        out = dict(d)
        out["logit_w"] = d["logit_w"][..., :cut].contiguous()
        out["logit_b"] = d["logit_b"][..., :cut].contiguous()
        out["embed"] = d["embed"][(slice(None),) * lead
                                  + (slice(0, cut),)].contiguous()
        return out

    base_n, dp16_n, params_n = narrow(base, 0), narrow(dp16, 1), \
        narrow(params, 1)
    for name, full, cut_fn, full_fn, rows in (
            ("k1", "k1_ms", lambda: k1(params_n), lambda: k1(params), B),
            ("k2", "k2_bf16_delta_ms", lambda: k2(base_n, dp16_n),
             lambda: k2(base, dp16), 2 * B),
            ("k3", "k3_ms", lambda: k3(params_n), lambda: k3(params), B)):
        row[f"{name}_vpad{cut}_ms"] = time_ms(cut_fn)
        steps = [int(executed(fn()[0], rows, T).max())
                 for fn in (full_fn, cut_fn)]
        row[f"{name}_longest_steps"] = steps
        step_full = row[full] / steps[0]
        step_cut = row[f"{name}_vpad{cut}_ms"] / steps[1]
        per_tile = (step_full - step_cut) / (lay.Vpad // 128 - cut // 128)
        row[f"{name}_us_per_step_and_vocab_tile"] = per_tile * 1e3
        row[f"{name}_us_fixed_per_step"] = (
            step_cut - per_tile * (cut // 128)) * 1e3
    # K3's draw: one Gumbel value per row, column and executed step
    row["k3_gumbels_per_s"] = float(executed(tokens["k3"], B, T).sum()) * B \
        * lay.Vpad / (row["k3_ms"] * 1e-3)
    row["card"] = card()
    print(json.dumps(row), flush=True)


def main():
    args = sys.argv[1:]
    width = 128
    if "--width" in args:
        i = args.index("--width")
        width = int(args[i + 1])
        del args[i:i + 2]
    if len(args) > 1 and args[0] == "--worker":
        worker(args[1], width)
        return
    roots = [str(ROOT)]
    for arg in args:
        roots.append(str(variant_dir(arg)))
    wide = ["--width", str(width)]
    builds = [subprocess.Popen([sys.executable, __file__, "--worker", r,
                                "--build", *wide]) for r in roots]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    for r in roots:
        # a worker whose kernel stalls is killed, not waited for
        subprocess.run([sys.executable, __file__, "--worker", r, *wide],
                       check=True, timeout=WORKER_TIMEOUT_S)


if __name__ == "__main__":
    main()

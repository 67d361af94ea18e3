#!/usr/bin/env python3
"""Count the instructions each normal of the delta stream issues in K6
(``pair_grad_rng_kernel``) and K7 (``pair_delta_dump_kernel``, also K5's
draw), by class, from the SASS of the built kernels.

    python3 scripts/torch_noise_sass.py [--out DIR] [ROOT ...]

Each ROOT holds a ``nes_img_captioning_tpu_torch`` package (default: this
checkout); its kernels are built with ``nvcc`` (``build_kernels``) and
disassembled with ``cuobjdump -sass``, so this runs on a machine with the
CUDA toolkit. In each noise kernel the hot loop is the innermost loop that
holds the most ``MUFU.RSQ`` (one per normal in both forms: the library's
``sqrtf`` and the narrowed one start with it); a region that a forward
branch skips and that calls a subroutine or touches local memory (the
library's slow paths: Payne-Hanek, the ``sqrtf`` slow call) is left out, as
the stream's inputs never run it. One JSON line per kernel instantiation:
its instructions per normal, in total and by class (integer multiply; LOP3
and shifts; integer add and compare; f32 FFMA/FMUL/FADD; other f32 (select,
compare, min/max); MUFU; conversions; branches; loads and stores; uniform
datapath; moves; the rest), the loop's normals per iteration and the
instructions left out. The SASS of each kernel goes to
``DIR/sass_<root name>_<kernel>.txt`` (default DIR: this checkout's
``nes_img_captioning_tpu_torch/_build/sass``).
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

CLASSES = {
    "int_multiply": ("IMAD", "IMAD.WIDE", "IMAD.HI"),
    "lop3_shift": ("LOP3", "SHF", "PRMT"),
    "int_add_compare": ("IADD3", "VIADD", "ISETP", "LEA", "IMAD.X",
                        "IMAD.IADD", "SEL", "IMNMX", "PLOP3"),
    "f32_arith": ("FFMA", "FMUL", "FADD"),
    "f32_other": ("FSEL", "FSETP", "FMNMX", "HFMA2"),
    "mufu": ("MUFU",),
    "convert": ("I2F", "F2I", "I2FP", "F2F", "F2FP"),
    "branch": ("BSSY", "BSYNC", "BRA", "CALL", "RET", "EXIT", "WARPSYNC",
               "BAR"),
    "load_store": ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "LD",
                   "ST"),
    "move": ("MOV", "IMAD.MOV", "IMAD.U32", "IMAD.SHL", "CS2R", "S2R"),
}
LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"\s*([^;]*);")


def parse(text: str) -> list:
    """(address, predicate, opcode, operands) of each instruction."""
    out = []
    for line in text.splitlines():
        m = LINE.match(line)
        if m:
            out.append((int(m.group(1), 16), m.group(2) or "", m.group(3),
                        m.group(4)))
    return out


def op_class(op: str) -> str:
    parts = op.split(".")
    if parts[0].startswith("U") or parts[0] in ("R2UR", "S2UR"):
        return "uniform"
    two = ".".join(parts[:2])
    for key in (two, parts[0]):
        for name, ops in CLASSES.items():
            if key in ops:
                return name
    return "other"


def branch_target(operands: str):
    m = re.search(r"0x([0-9a-f]+)", operands)
    return int(m.group(1), 16) if m else None


def hot_loop(ins: list) -> tuple:
    """(counts by opcode of the hot loop's body without its slow paths,
    normals per iteration, instructions left out)."""
    loops = []
    for addr, _, op, operands in ins:
        tgt = branch_target(operands) if op == "BRA" else None
        if tgt is not None and tgt < addr:
            loops.append((tgt, addr))

    def rsq(lo, hi):
        return sum(1 for a, _, op, _ in ins
                   if lo <= a <= hi and op.startswith("MUFU.RSQ"))

    inner = [(lo, hi) for lo, hi in loops if rsq(lo, hi) and not any(
        (l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi and rsq(l2, h2)
        for l2, h2 in loops)]
    lo, hi = max(inner, key=lambda lh: rsq(*lh))
    body = [x for x in ins if lo <= x[0] <= hi]
    skip = set()
    for addr, pred, op, operands in body:
        tgt = branch_target(operands) if op == "BRA" else None
        if pred and tgt is not None and tgt > addr:
            region = [x for x in body if addr < x[0] < tgt]
            if any(x[2].split(".")[0] in ("CALL", "STL", "LDL")
                   for x in region):
                skip.update(x[0] for x in region)
    kept = [x for x in body if x[0] not in skip]
    counts = collections.Counter(x[2] for x in kept)
    normals = sum(n for op, n in counts.items() if op.startswith("MUFU.RSQ"))
    return counts, normals, len(body) - len(kept)


def main():
    args = sys.argv[1:]
    here = Path(__file__).resolve().parent.parent
    out_dir = here / "nes_img_captioning_tpu_torch" / "_build" / "sass"
    if args[:1] == ["--out"]:
        out_dir, args = Path(args[1]), args[2:]
    roots = args or [str(here)]
    out_dir.mkdir(parents=True, exist_ok=True)
    for root in roots:
        out = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
             " from nes_img_captioning_tpu_torch.ops import decode_cuda as dc;"
             " print(dc.build_kernels()[0])", root],
            check=True, capture_output=True, text=True).stdout.split()[-1]
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", out],
                              check=True, capture_output=True, text=True).stdout
        tag = Path(root).resolve().name
        for func in re.split(r"\n\s*Function : ", sass):
            name = func.split("\n")[0].strip()
            kernel = next((k for k in ("pair_grad_rng_kernel",
                                       "pair_delta_dump_kernel")
                           if k in name), None)
            if kernel is None:
                continue
            inst = re.search(r"_kernelILb([01])E", name)
            label = kernel + (f"<{inst.group(1)}>" if inst else "")
            fname = re.sub(r"[^A-Za-z0-9_]+", "_", f"{tag}_{label}").strip("_")
            (out_dir / f"sass_{fname}.txt").write_text(func)
            counts, normals, left_out = hot_loop(parse(func))
            by_class = collections.Counter()
            for op, n in counts.items():
                by_class[op_class(op)] += n
            print(json.dumps({
                "root": root, "kernel": label,
                "normals_per_iteration": normals,
                "per_normal": round(sum(counts.values()) / normals, 2),
                "by_class_per_normal": {k: round(v / normals, 2)
                                        for k, v in sorted(by_class.items())},
                "loop_instructions": sum(counts.values()),
                "slow_path_left_out": left_out,
                "opcodes": dict(counts.most_common())}), flush=True)


if __name__ == "__main__":
    main()

"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout that holds ``nes_img_captioning_tpu_torch``
beside this folder, on a machine with the cards the cell asks for; exits
non-zero, with no result, without them. The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` the ``breakdown``, and last ``checks``: each compared
number with its limit); the checks are also the last lines of standard
error. The decode kernels build on the first run of a width, into the
package's ``_build/``, and are found there by every later run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch

    from portbench.harness.bench import (ROOT, forbidden_modules,
                                         load_cell, run_cell)

    chips = int(load_cell(args.workload)["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", ROOT)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules {bad} are loaded; no run may load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    card = power_limit()
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"],
                        "nvidia_smi": card}
    print(f"portbench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr)
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from, several seeds in one process.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        --side program|control|half|token [--quant fp8]

``program``: the program's set-up and generations 1-3 through its own
``run_master`` (no window), then the reference, per seed: the lower
readings. ``control``: the reference computed in the precision below the
configuration's (``--quant``, fp8 by default) put in the program's place,
its own three steps judged by the reference at the configuration's
precision as a run's are: the upper readings. ``half``, ``token``: the
reference at the configuration's precision with that fault planted
(``NESReference``'s ``fault``), put in the program's place and judged the
same way: the readings of the faults a training cell's limits are held
against. (A step that returns its state unchanged reads 1 by the change's
measure and needs no run.) One JSON line per seed on standard output. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, side: str, device, quant: str = "fp8",
             root=None) -> dict:
    """The compared numbers of one seed on one side, and the per-generation
    gaps they are the largest of (the cell's algorithm module's
    ``readings``)."""
    from portbench.harness.bench import (ROOT, algorithm, load_cell,
                                         make_arrays)

    cell = load_cell(name, root or ROOT)
    arrays = make_arrays(cell, seed, device)
    return algorithm(cell, root or ROOT).readings(cell, seed, side, device,
                                                  arrays, quant)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", required=True,
                    help="program, control, half or token")
    ap.add_argument("--quant", default="fp8")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("portbench: readings are taken on the card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        nums = readings(args.workload, int(s), args.side,
                        torch.device("cuda"), args.quant)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "quant": args.quant if args.side == "control"
                          else None, "seed": int(s), **nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

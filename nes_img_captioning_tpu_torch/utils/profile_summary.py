"""Summarize a ``tpu.profile`` trace: device time per kernel and the card's
idle share of the traced window.

The masters write ``<log_dir>/profile/trace_<pid>.pt.trace.json``, a Chrome
trace of torch.profiler (``algorithms/master_base._profile_hook``). This
tool finds the newest trace under a run directory (or takes a trace file),
sums the duration of the device's events (kernels, copies and memsets) by
name with their count, and reports the union of those events' intervals
against the traced window, the span of every timed event in the trace, as
the card's busy and idle shares. It also counts the kernel launches whose
kernel has no record in the trace (matched by their correlation ids): the
device time of a trace with such launches is incomplete. A trace taken on
the CPU has no device events, and its device time is reported as not
measured. (The JAX package reads its ``jax.profiler`` traces with
``scripts/profile_summary.py``.)

Usage:
    python -m nes_img_captioning_tpu_torch.utils.profile_summary \\
        <log_dir | trace.json> [-n 25]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from collections import defaultdict

__all__ = ["DEVICE_CATS", "find_trace", "summarize", "main"]

# the categories of torch.profiler's device events (Kineto's names)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    """``path`` if it is a file, else the newest ``*.trace.json`` or
    ``*.trace.json.gz`` below it."""
    if os.path.isfile(path):
        return path
    patterns = ("*.trace.json", "*.trace.json.gz")
    found = [p for pattern in patterns
             for p in glob.glob(os.path.join(path, "**", pattern),
                                recursive=True)]
    if not found:
        raise FileNotFoundError(f"no trace {patterns} under {path}")
    return max(found, key=os.path.getmtime)


def _events(trace: str) -> list:
    opener = gzip.open if trace.endswith(".gz") else open
    with opener(trace, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def summarize(trace: str) -> dict:
    """{"rows": [(name, ms, count)] by device time, "busy_ms" (the union of
    the device events' intervals), "window_ms" (first to last timed event
    of any kind), "idle": 1 - busy / window, or None without device
    events, "n_events", "unmatched_launches": kernel launch calls whose
    kernel has no record}."""
    events = _events(trace)
    per_name: dict = defaultdict(lambda: [0.0, 0])
    spans, kernels = [], set()
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            row = per_name[e["name"]]
            row[0] += e["dur"] / 1e3
            row[1] += 1
            spans.append((float(e["ts"]), float(e["ts"]) + e["dur"]))
            if e.get("cat") == "kernel":
                kernels.add(e.get("args", {}).get("correlation"))
    unmatched = sum(
        1 for e in events if e.get("cat") == "cuda_runtime"
        and "LaunchKernel" in e["name"]
        and e.get("args", {}).get("correlation") not in kernels)
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    window = (max(float(e["ts"]) + e["dur"] for e in events)
              - min(float(e["ts"]) for e in events)) if events else 0.0
    rows = sorted(((name, ms, n) for name, (ms, n) in per_name.items()),
                  key=lambda r: -r[1])
    return {"rows": rows, "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "idle": (1.0 - busy / window) if spans and window else None,
            "n_events": len(events), "unmatched_launches": unmatched}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("path", help="a run's log_dir, its profile/ "
                        "directory, or a trace file")
    parser.add_argument("-n", type=int, default=25,
                        help="kernel rows to print")
    args = parser.parse_args(argv)
    trace = find_trace(args.path)
    out = summarize(trace)
    print(f"trace {trace}: {out['n_events']} timed events over "
          f"{out['window_ms']:.3f} ms")
    if out["idle"] is None:
        print("no device events in the trace (a CPU run): device time not "
              "measured")
        return out
    print(f"device busy {out['busy_ms']:.3f} ms, idle {out['idle']:.2%} of "
          "the traced window")
    if out["unmatched_launches"]:
        print(f"{out['unmatched_launches']} kernel launches have no kernel "
              "record: the device time above is incomplete")
    print(f"{'ms':>12}  {'count':>6}  name")
    for name, ms, n in out["rows"][:args.n]:
        print(f"{ms:12.3f}  {n:6d}  {name[:120]}")
    return out


if __name__ == "__main__":
    main()

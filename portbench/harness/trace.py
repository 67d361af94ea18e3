"""A traced stretch of a run: torch.profiler over a call, reduced from the
profiler's raw records.

The device's busy time is the union of its operations' intervals, so
operations of streams that overlap count once. Rows by operation name and
the idle gaps come from the same raw records; the profiler's event tree
(``key_averages``, ``events``), which costs seconds of host time for each
traced generation, is never built. An idle gap is named after the
innermost of the harness's own ``record_function`` spans that was open at
its middle.
"""

from __future__ import annotations

import time

import torch

__all__ = ["union_s", "trace_call", "SPAN_PREFIX"]

# the harness's own spans carry this prefix, so their host records are
# told apart from the program's operators
SPAN_PREFIX = "portbench."


def union_s(spans) -> float:
    """Seconds covered by the (start_ns, end_ns) intervals, overlaps once."""
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e9


def _gaps(spans):
    """The idle (start_ns, end_ns) intervals between the union's pieces."""
    out, end = [], None
    for lo, hi in sorted(spans):
        if end is not None and lo > end:
            out.append((end, lo))
        end = hi if end is None else max(end, hi)
    return out


def trace_call(fn, top: int = 10) -> dict:
    """``fn()`` once under torch.profiler, the card synchronised before and
    after. Returns ``window_s`` (the traced call's host time), ``busy_s``,
    ``ops`` ({name: [seconds, count]} of the device's operations),
    ``device_ops`` (the ``top`` longest by name) and ``idle_gaps`` (the
    ``top`` longest, each named by the harness span open at its middle)."""
    from torch.autograd.profiler_util import _rewrite_name

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    skip = {"[memory]", "[OutOfMemory]"}
    spans, ops, marks = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # a span's host record names the gaps; its copy on the device's
            # timeline is an annotation, not an operation
            if e.device_type() != cuda:
                marks.append((e.start_ns(), e.end_ns(),
                              name[len(SPAN_PREFIX):]))
            continue
        if e.device_type() != cuda:
            continue
        if name in skip or getattr(e, "is_hidden_event", lambda: False)():
            continue
        spans.append((e.start_ns(), e.end_ns()))
        key = _rewrite_name(name, with_wildcard=True)
        s, n = ops.get(key, (0.0, 0))
        ops[key] = [s + (e.end_ns() - e.start_ns()) / 1e9, n + 1]
    busy_s = union_s(spans)
    gaps = []
    for lo, hi in _gaps(spans):
        mid = (lo + hi) // 2
        open_ = [m for m in marks if m[0] <= mid <= m[1]]
        # the innermost open span: the one that started last
        name = max(open_)[2] if open_ else "outside the harness spans"
        gaps.append(((hi - lo) / 1e9, name))
    gaps.sort(reverse=True)
    device_ops = sorted(([k, v[0]] for k, v in ops.items()),
                        key=lambda kv: -kv[1])[:top]
    return {"window_s": window_s, "busy_s": busy_s, "ops": ops,
            "device_ops": device_ops,
            "idle_gaps": [[f"idle in {n}", s] for s, n in gaps[:top]]}

"""Offline run-analysis helpers (port of
``nes_img_captioning_tpu/utils/analysis.py``): curve extraction,
resampling, merging.

Equivalents of the reference's thesis-plot utilities
(reference: src/algorithm/tools/utils.py:69-105,176-307), reworked to be
robust (the reference's log parser counts fixed line offsets; ours matches
stat names) while keeping the same outputs: CIDEr/samples/time curves from
z_info checkpoints, multi-run merging, common-raster resampling, and the
tournament-selection pressure calculator.
"""

from __future__ import annotations

import json
import re

import numpy as np

__all__ = [
    "extract_stat_from_log",
    "cst_from_infos",
    "combine_diff_lengths",
    "combine_diff_lengths_pad",
    "rasterize",
    "sample_at",
    "readable_bytes",
    "tournament_counts",
    "plot_score_vs",
]


def extract_stat_from_log(filename: str, stat: str = "RewStd") -> list[float]:
    """Pull one stat's per-iteration series out of a master log file
    (reference extract_stds_from_log, utils.py:69-92 — which hard-codes line
    offsets; we match on the stat name instead)."""
    pat = re.compile(r"\|\s*%s:?\s*\|\s*([^\s|]+)\s*\|" % re.escape(stat))
    out = []
    with open(filename) as f:
        for line in f:
            m = pat.search(line)
            if m:
                try:
                    out.append(float(m.group(1)))
                except ValueError:
                    pass
    return out


def cst_from_infos(infos) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(best-so-far score, cumulative samples, cumulative time) curves from a
    z_info checkpoint dict or path (reference utils.py:221-228)."""
    if isinstance(infos, str):
        with open(infos) as f:
            infos = json.load(f)
    if "best_acc_so_far_stats" in infos and infos["best_acc_so_far_stats"]:
        ciders = np.asarray(infos["best_acc_so_far_stats"])
    else:
        ciders = np.maximum.accumulate(np.asarray(infos["acc_stats"]))
    samples = np.cumsum(infos["bs_stats"])
    times = np.cumsum(infos["time_stats"])
    return ciders, samples, times


def combine_diff_lengths(*arrays) -> np.ndarray:
    """Mean over runs of different lengths; tail averages only the runs that
    are still alive (reference utils.py:231-241)."""
    arrays = [np.asarray(a, dtype=float) for a in arrays]
    length = max(len(a) for a in arrays)
    out = np.zeros(length)
    for i in range(length):
        vals = [a[i] for a in arrays if len(a) > i]
        out[i] = float(np.mean(vals))
    return out


def combine_diff_lengths_pad(*arrays) -> np.ndarray:
    """Mean over runs, shorter runs padded with their last value
    (reference utils.py:244-253)."""
    arrays = [np.asarray(a, dtype=float) for a in arrays]
    length = max(len(a) for a in arrays)
    padded = [
        np.concatenate([a, np.full(length - len(a), a[-1])]) for a in arrays
    ]
    return np.mean(padded, axis=0)


def sample_at(raster, axis, values) -> np.ndarray:
    """Resample (axis, values) at the raster points by midpoint
    interpolation (reference utils.py:256-272)."""
    axis = np.asarray(axis, dtype=float)
    values = np.asarray(values, dtype=float)
    out = []
    for pt in raster:
        if pt > axis[-1]:
            break
        k = int(np.searchsorted(axis, pt, side="left"))
        lower = k if (k < len(axis) and axis[k] == pt) else max(k - 1, 0)
        upper = min(k, len(axis) - 1)
        out.append((values[lower] + values[upper]) / 2.0)
    return np.asarray(out)


def rasterize(*coords):
    """Put several (x, y) curves on a common raster so they can be averaged
    (reference utils.py:275-290). coords: [[(x, y), ...], ...]"""
    axes = [np.asarray([a for (a, _) in arr], dtype=float) for arr in coords]
    values = [np.asarray([v for (_, v) in arr], dtype=float) for arr in coords]
    minim = int(min(a[0] for a in axes))
    maxim = int(max(a[-1] for a in axes))
    step = max(int(min(a[1] - a[0] for a in axes)), 1)
    raster = np.arange(minim, maxim, step)
    rasterized = [sample_at(raster, ax, v) for ax, v in zip(axes, values)]
    return [raster[: len(r)] for r in rasterized], rasterized


def readable_bytes(num, suffix="B") -> str:
    for unit in ["", "K", "M", "G", "T", "P", "E", "Z"]:
        if abs(num) < 1024.0:
            return "%3.1f%s%s" % (num, unit, suffix)
        num /= 1024.0
    return "%.1f%s%s" % (num, "Yi", suffix)


def tournament_counts(pop: int, t: int, offspring: int, trials: int = 1,
                      seed: int = 0) -> np.ndarray:
    """Expected per-parent selection counts under tournament selection —
    the selection-pressure calculator (reference utils.py:293-307)."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((trials, pop))
    for i in range(trials):
        winners = [
            rng.choice(pop, size=min(t, pop), replace=False).min()
            for _ in range(offspring)
        ]
        for w in winners:
            counts[i, w] += 1
    return counts.mean(axis=0)


def plot_score_vs(curves: dict, xlabel: str, out_path: str, hline_max=True):
    """Score-vs-time/samples comparison plot (reference
    plot_ciders_vs_something_nicely, utils.py:205-218)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.close()
    best = None
    for label, (x, y) in curves.items():
        plt.plot(x, y, label=label)
        m = float(np.max(y))
        best = m if best is None else max(best, m)
    if hline_max and best is not None:
        plt.axhline(best, linestyle="dashed", color="green", lw=0.5)
    plt.legend(loc="lower right")
    plt.xlabel(xlabel)
    plt.ylabel("CIDEr")
    plt.savefig(out_path)
    plt.close()

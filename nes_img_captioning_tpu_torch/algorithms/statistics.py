"""Per-generation metric series with the reference's exact checkpoint
schema, stat-table labels, and plot filenames (those three are public
surface — z_info JSONs, log parsers, and plot consumers interoperate).
Bodies are original: one declarative registry drives the checkpoint
round-trip, recording, and plotting.

Reference counterpart: src/algorithm/tools/statistics.py (schema only).
Port of ``nes_img_captioning_tpu/algorithms/statistics.py``; the memory
series read /proc instead of psutil, which the machines with a card may
lack.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from ..utils.logger import log

__all__ = ["Statistics"]

# registry: attribute -> (z_info key, plot filename stem, plot title)
_SERIES = {
    "time_stats": ("time_stats", "time", "Time per gen"),
    "acc_stats": ("acc_stats", "acc", "Elite score"),
    "best_acc_so_far_stats": (
        "best_acc_so_far_stats", "best_acc", "Best elite score"),
    "norm_stats": ("norm_stats", "norm", "Norm of params"),
    "std_stats": ("noise_std_stats", "noise_std", "Noise stdev"),
    "bs_stats": ("bs_stats", "batch_size", "Batch size"),
    "score_stds": ("score_stds", "reward_std", "Score stdev"),
    "update_ratio_stats": (
        "update_ratio_stats", "update_ratio", "Update ratio"),
}


def _memory_usage() -> tuple[int, float]:
    """(this process's resident bytes, the host's used memory in percent,
    as psutil's virtual_memory().percent counts it) from /proc."""
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0])
    total, avail = info["MemTotal"], info["MemAvailable"]
    return rss, round(100.0 * (total - avail) / total, 1)


class Statistics:
    def __init__(self):
        for attr in _SERIES:
            setattr(self, "_" + attr, [])
        self._score_stats = [[], [], []]       # [min, mean, max] per gen
        self._mem_stats = [[], [], []]         # [master RSS, virtmem %, worker RSS]

        self._step_tstart = 0.0
        self._time_elapsed = 0.0

    # ---- checkpoint round-trip ------------------------------------------------

    def to_dict(self) -> dict:
        out = {key: getattr(self, "_" + attr)
               for attr, (key, _, _) in _SERIES.items()}
        out["score_stats"] = self._score_stats
        out["mem_stats"] = self._mem_stats
        out["time_elapsed"] = self._time_elapsed
        return out

    def init_from_infos(self, infos: dict):
        for attr, (key, _, _) in _SERIES.items():
            if key in infos:
                setattr(self, "_" + attr, infos[key])
        self._score_stats = infos.get("score_stats", self._score_stats)
        self._mem_stats = infos.get("mem_stats", self._mem_stats)
        self._time_elapsed = infos.get("time_elapsed", self._time_elapsed)

    # ---- recording --------------------------------------------------------------

    def record_score_stats(self, scores: np.ndarray):
        scores = np.asarray(scores)
        for series, value in zip(
            self._score_stats, (scores.min(), scores.mean(), scores.max())
        ):
            series.append(float(value))
        self._score_stds.append(float(scores.std()))

    def record_acc_stats(self, value):
        self._acc_stats.append(float(value))

    def record_best_acc_stats(self, value):
        self._best_acc_so_far_stats.append(float(value))

    def record_norm_stats(self, param_vector):
        # mean |theta| — what the reference schema calls the param "norm"
        v = np.asarray(param_vector)
        self._norm_stats.append(float(np.abs(v).mean()))

    def record_std_stats(self, value):
        self._std_stats.append(float(value))

    def record_bs_stats(self, value):
        self._bs_stats.append(int(value))

    def record_update_ratio(self, value):
        self._update_ratio_stats.append(float(value))

    def update_mem_stats(self):
        rss, used_percent = _memory_usage()
        self._mem_stats[0].append(rss)
        self._mem_stats[1].append(used_percent)
        # no worker fleet exists in the SPMD design; the worker slot mirrors
        # the single process so reference tooling can still parse the triple
        self._mem_stats[2].append(rss)

    def set_step_tstart(self):
        self._step_tstart = time.time()

    def record_step_time_stats(self, dt: float | None = None):
        """Append this iteration's wall time (measured from set_step_tstart
        unless an explicit dt is given — block dispatches split their wall
        time evenly over the generations they contain)."""
        if dt is None:
            dt = time.time() - self._step_tstart
        self._time_elapsed += dt
        self._time_stats.append(dt)

    # ---- output -------------------------------------------------------------------

    def log_stats(self):
        """Stat table for this generation (label set = reference surface)."""
        logging.info("---------------- STATS ----------------")
        rows = [
            ("RewMax", self._score_stats[2]),
            ("RewMean", self._score_stats[1]),
            ("RewMin", self._score_stats[0]),
            ("RewStd", self._score_stds),
            ("EliteAcc", self._acc_stats),
            ("BestEliteAcc", self._best_acc_so_far_stats),
            ("NormMean", self._norm_stats),
            ("UpdateRatio", self._update_ratio_stats),
        ]
        for label, series in rows:
            if series:
                log(label, series[-1])
        # the recorded per-generation dt, not wall time since tstart —
        # chained-block generations share one tstart but record block_dt/b
        log("TimeElapsedThisIter",
            self._time_stats[-1] if self._time_stats
            else time.time() - self._step_tstart)
        log("TimeElapsed", self._time_elapsed)
        if self._mem_stats[1]:
            log("MemUsage", self._mem_stats[1][-1])

    def plot_stats(self, log_dir: str):
        """One PDF per series (reference filenames), plus the banded
        training-score plot as loss_plot.pdf."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        def save_line_plot(filename_stem, title, *curves, band=None):
            fig, ax = plt.subplots()
            if band is not None:
                lo, hi = band
                ax.fill_between(np.arange(len(lo)), lo, hi,
                                facecolor="blue", alpha=0.3)
            for curve in curves:
                ax.plot(np.arange(len(curve)), curve, color="blue")
            ax.set_title(title)
            fig.savefig(f"{log_dir}/{filename_stem}_plot.pdf", format="pdf")
            plt.close(fig)

        if self._score_stats[1]:
            save_line_plot(
                "loss", "Training score", self._score_stats[1],
                band=(self._score_stats[0], self._score_stats[2]),
            )
        for attr, (_, stem, title) in _SERIES.items():
            series = getattr(self, "_" + attr)
            if attr == "update_ratio_stats" and not series:
                continue  # NES-only series; skip the empty plot for ES
            save_line_plot(stem, title, series)
        for slot, (stem, title) in enumerate([
            ("master_mem", "Master mem usage"),
            ("virtmem", "Virt mem usage"),
            ("worker_mem", "Worker mem usage"),
        ]):
            save_line_plot(stem, title, self._mem_stats[slot])

    # ---- accessors --------------------------------------------------------------

    def score_stats(self):
        return self._score_stats

    def acc_stats(self):
        return self._acc_stats

    def time_stats(self):
        return self._time_stats

    def bs_stats(self):
        return self._bs_stats

"""One run of one cell: the program's own training loop, timed, traced and
checked against the plain reference.

A cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``: the
experiment file it starts from in ``experiments/``, the overrides of that
experiment's settings and the data's sizes), its chips and the limits of
the numbers that decide ``correct``. The experiment's ``algorithm`` names
the module ``algorithms/<algorithm>.py`` that runs the program's master
and judges it (its docstring gives the run's steps); per-layer metrics are
the readers ``metrics/<metric>.py`` named in ``BENCHMARK.json``. Nothing
here lists a cell, a configuration, an algorithm or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from . import data as bench_data

__all__ = ["ROOT", "load_cell", "algorithm", "make_arrays", "run_cell",
           "FORBIDDEN", "forbidden_modules", "process_start_s"]

ROOT = Path(__file__).resolve().parents[1]
# top-level module names no run may load (the JAX package's name is a
# prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "nes_img_captioning_tpu")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's workload, its configuration, its traffic and the
    experiment the traffic resolves to."""
    wl = _json(root / "workloads" / f"{name}.json")
    cfg = _json(root / "configs" / f"{wl['config']}.json")
    tr = _json(root / "traffic" / f"{wl['traffic']}.json")
    exp = _json(root / "experiments" / tr["experiment"])
    exp = {k: v for k, v in exp.items() if not k.startswith("_")}
    exp["config"] = {k: v for k, v in exp["config"].items()
                     if not k.startswith("_")}
    exp["tpu"] = {k: v for k, v in exp["tpu"].items()
                  if not k.startswith("_")}
    for key, val in tr.get("overrides", {}).items():
        node = exp
        *head, last = key.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = val
    exp["policy_options"]["model_options"].update(cfg["model_options"])
    return {"name": name, "workload": wl, "config": cfg, "traffic": tr,
            "exp": exp}


def benchmark_metrics(cell: str, kind: str, root: Path = ROOT) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics of the
    BENCHMARK.json beside ``root`` that ``cell`` reports."""
    bench = _json(root.parent / "BENCHMARK.json")
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _module(root: Path, folder: str, name: str):
    """The module ``<root>/<folder>/<name>.py``, found by its name."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        root / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(name: str, root: Path):
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from the
    run's record, or None where the run has nothing for it to read."""
    return _module(root, "metrics", name).read


def algorithm(cell: dict, root: Path = ROOT):
    """The module ``algorithms/<algorithm>.py`` of the cell's experiment:
    ``program_run``, ``judge_run`` and ``readings``."""
    return _module(root, "algorithms", cell["exp"]["algorithm"])


def make_arrays(cell: dict, seed: int, device) -> dict:
    """The cell's data from the seed (``data.make_arrays``)."""
    cfg = cell["config"]
    return bench_data.make_arrays(
        cell["traffic"]["data"], int(cfg["vocab_size"]),
        int(cfg["model_options"]["fc_feat_size"]), int(cfg["seq_length"]),
        seed, device)


def process_start_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT) -> dict:
    """One run of cell ``name``: the contract's result dict, and under
    ``checks`` each compared number with its limit."""
    device = torch.device(device)
    stages = {"imports": process_start_s()}
    cell = load_cell(name, root)
    alg = algorithm(cell, root)
    arrays = make_arrays(cell, seed, device)
    stages["data"] = process_start_s()
    out = alg.program_run(cell, seed, seconds, trace, device, arrays,
                          stages=stages)
    t0 = time.perf_counter()
    nums, fields = alg.judge_run(out, cell, seed, arrays, device)
    print(f"portbench: reference {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    limits = cell["workload"]["limits"]
    checks = {k: [v, float(limits[k])] for k, v in nums.items()}
    failed = sum(v > lim for v, lim in checks.values())
    run = {"setup_s": out["setup_s"], "spans": out["spans"],
           "window_s": out.get("window_s"), "gens": out["gens_window"],
           "trace": out.get("trace"), "counters": out.get("counters", {}),
           **fields}
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in benchmark_metrics(name, kind, root):
        val = _reader(m["name"], root)(run)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    result = {"correct": failed == 0, "attempted": out["gens_window"],
              "failed": int(failed), "metrics": metrics}
    tr = out.get("trace") if trace else None
    if tr:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["device"] = {}
    if "memory_peak_bytes" in out:
        result["device"]["memory_peak_bytes"] = out["memory_peak_bytes"]
    if tr:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
    result["checks"] = checks
    return result

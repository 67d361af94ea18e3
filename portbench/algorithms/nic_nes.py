"""NIC-NES (``"algorithm": "nic_nes"``): the program's ``NESMaster`` run,
timed and traced, and its first generations judged by the plain reference.

The harness finds this module by the experiment's ``algorithm``
(``algorithms/<algorithm>.py``) and calls four functions:

* ``program_run(cell, seed, seconds, trace, device, arrays)``: the set-up,
  the window and the traced cycle (the harness's steps 1-3), returning the
  record the harness and the metrics read (``setup_s``, ``spans``,
  ``window_s``, ``gens_window``, ``counters``, ``trace``,
  ``captions_per_gen``, ``memory_peak_bytes``) and what ``judge_run``
  needs;
* ``judge_run(out, cell, seed, arrays, device)``: the compared numbers and
  the record's fields the reference's tokens give (the model FLOPs per
  generation and the decode's launch shape);
* ``readings(cell, seed, side, device, arrays, quant)``: the numbers of one
  seed on one side (``program``, ``control``, a planted fault), for
  ``readings.py``.

The run, in order:

1. set-up: the master the program's entry builds (``NESMaster``, as
   ``main.py master`` does, on an in-memory ``CocoData`` of the harness's
   arrays), then generations 1 .. ``warm`` through the master's own
   ``run_master``: 1, then 2, then 3, then to the first end of a cycle (a
   snapshot iteration) and on by whole cycles until that part has lasted
   ``WARM_S`` (or ``--seconds``, if less); the last cycle's per-generation
   time sizes the window. Generations 1-3 are the ones the reference
   follows: their fitnesses and validation scores, and the optimizer's
   state before and after each, are kept;
2. the window: one call of ``run_master`` over whole cycles, from the end
   of a cycle to the end of one, lasting at least ``--seconds``, ended by
   ``torch.cuda.synchronize()``;
3. with ``--trace 1``, one more cycle under torch.profiler;
4. the program freed, the reference (``reference/nes.py``) follows
   generations 1-3 from the same inputs and seed, each step from the run's
   own state before it, and the numbers are compared.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.harness import data as bench_data
from portbench.harness import flops
from portbench.harness.bench import process_start_s
from portbench.harness.trace import SPAN_PREFIX, trace_call

__all__ = ["program_run", "judge_run", "readings", "CHECKED_GENS",
           "WARM_S"]

CHECKED_GENS = 3
# host seconds the warm-up runs past the checked generations, at least
WARM_S = 6.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counters() -> dict:
    from nes_img_captioning_tpu_torch.ops import decode_cuda

    return {k: v.launches for k, v in vars(decode_cuda).items()
            if k.startswith("decode") and hasattr(v, "launches")}


class _Timed:
    """Adds the host seconds of every call of ``cls.__init__`` to ``acc``
    while in effect."""

    def __init__(self, cls, acc: dict, key: str):
        self.cls, self.acc, self.key = cls, acc, key

    def __enter__(self):
        orig = self.orig = self.cls.__init__
        acc, key = self.acc, self.key

        def timed(obj, *a, **kw):
            t0 = time.perf_counter()
            orig(obj, *a, **kw)
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0

        self.cls.__init__ = timed
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.orig


def _spans(master, nes_mod):
    """The traced cycle's harness spans around the program's calls:
    ``loop`` (``run_master``), ``batch draws`` (a generation's batches
    drawn on the host), ``block`` (a block's device work enqueued),
    ``read-back`` (its rows pulled), ``snapshot``; undone by the returned
    function."""
    rf = torch.profiler.record_function
    eng = master.engine
    saved = [(eng, "generation_val_block", "block"),
             (eng, "unpack_val", "read-back"),
             (master, "_draw_batches", "batch draws"),
             (master, "run_master", "loop")]
    snap = nes_mod.save_snapshot

    def wrap(fn, name):
        def inner(*a, **kw):
            with rf(SPAN_PREFIX + name):
                return fn(*a, **kw)
        return inner

    for obj, attr, name in saved:
        setattr(obj, attr, wrap(getattr(obj, attr), name))
    nes_mod.save_snapshot = wrap(snap, "snapshot")

    def undo():
        for obj, attr, _ in saved:
            delattr(obj, attr)
        nes_mod.save_snapshot = snap
    return undo


def program_run(cell: dict, seed: int, seconds: float, trace: bool, device,
                arrays: dict, window: bool = True,
                stages: dict | None = None) -> dict:
    """Steps 1-3 of the module's run. Returns the program's outputs for the
    comparison (on the host) and the run's timings, counters and trace.
    ``window=False`` stops after the set-up (the readings' program side)."""
    from nes_img_captioning_tpu_torch.algorithms import nes as nes_mod
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.ops import cider_device

    exp = json.loads(json.dumps(cell["exp"]))
    exp["tpu"]["seed"] = int(seed)
    log_dir = tempfile.mkdtemp(prefix="portbench_logs_")
    exp["log_dir"] = log_dir
    spans = {}
    stages = {} if stages is None else stages
    out = {"spans": spans}
    try:
        with _Timed(cider_device.DeviceCider, spans, "cider_s"):
            master = NESMaster(exp, device=str(device),
                               data=CocoData.from_arrays(arrays))
            stages["master"] = process_start_s()
            theta0 = master.theta.detach().clone()
            rows = []
            gvb = master.engine.generation_val_block

            def keep(*a, **kw):
                res = gvb(*a, **kw)
                rows.append(res[3])
                return res

            master.engine.generation_val_block = keep
            states = [(theta0, torch.zeros_like(theta0),
                       torch.zeros_like(theta0))]
            for k in range(1, CHECKED_GENS + 1):
                master.run_master(max_iterations=k)
                st = master.opt_state
                states.append(tuple(x.detach().clone() for x in
                                    (master.theta, st.m, st.v)))
                stages[f"generation {k}"] = process_start_s()
            del master.engine.generation_val_block
            cycle = int(exp["config"].get("snapshot_freq")
                        or exp["tpu"].get("gens_per_dispatch") or 1)
            warm = cycle * math.ceil((CHECKED_GENS + 1) / cycle)
            _sync(device)
            t0 = time.perf_counter()
            master.run_master(max_iterations=warm)
            _sync(device)
            spent = time.perf_counter() - t0
            t_gen = spent / (warm - CHECKED_GENS)
            # whole cycles more until the warm-up has lasted WARM_S (or the
            # window's length, if shorter), so that the window starts on a
            # loop that has run a while; the last cycle's time per
            # generation sizes the window
            while spent < min(WARM_S, seconds):
                t0 = time.perf_counter()
                warm += cycle
                master.run_master(max_iterations=warm)
                _sync(device)
                t_gen = (time.perf_counter() - t0) / cycle
                spent += t_gen * cycle
        out["setup_s"] = process_start_s()
        F = max(int(exp["nb_offspring"]), 1)
        out["rows"] = torch.cat(rows)[:CHECKED_GENS].cpu()
        out["F"] = F
        out["states"] = [tuple(x.cpu() for x in st) for st in states]
        out["gens_window"] = 0
        if window:
            n = max(1, math.ceil(seconds / (cycle * t_gen)))
            end = warm + n * cycle
            c0 = _launch_counters()
            _sync(device)
            t0 = time.perf_counter()
            master.run_master(max_iterations=end)
            _sync(device)
            out["window_s"] = time.perf_counter() - t0
            c1 = _launch_counters()
            out["counters"] = {k: c1[k] - c0[k] for k in c1}
            out["gens_window"] = end - warm
            print("portbench: set-up stages (s since the process started): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()),
                  file=sys.stderr)
            print(f"portbench: set-up {out['setup_s']:.2f} s (DeviceCider "
                  f"{spans.get('cider_s', 0.0):.2f} s), {t_gen * 1e3:.1f} "
                  f"ms per warm generation; window {end - warm} "
                  f"generations in {out['window_s']:.3f} s",
                  file=sys.stderr)
            if trace:
                undo = _spans(master, nes_mod)
                try:
                    out["trace"] = trace_call(lambda: master.run_master(
                        max_iterations=end + cycle))
                finally:
                    undo()
                out["trace"]["gens"] = cycle
        out["captions_per_gen"] = 2 * F * master.it.batch_size()
        if device.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        del master
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def program_outputs(out: dict) -> dict:
    """The program's numbers that the reference judges: per checked
    generation its (F, 2) fitnesses and validation score, and its state
    (theta, Adam's m and v) before step 1 and after each step."""
    F = out["F"]
    rows = out["rows"].numpy()
    off = 2 * F
    return {"fitness": [torch.as_tensor(r[:off].reshape(F, 2)) for r in rows],
            "val": [float(r[off + 2]) for r in rows],
            "states": out["states"]}


def reference_run(cell: dict, seed: int, arrays: dict, device,
                  quant: str = "bf16", follow: list | None = None,
                  fault: str | None = None) -> dict:
    """The reference's generations 1-3 from the same inputs and seed. With
    ``follow`` (a run's states before each step), step k starts from
    ``follow[k - 1]``; without it, from the reference's own. ``quant`` and
    ``fault``: ``NESReference``'s, for the control and the faults. Returns
    its own initial theta, per step its fitnesses, validation score and
    gradient, and its states (``states[0]`` its initial one)."""
    from portbench.reference.nes import NESReference

    exp = json.loads(json.dumps(cell["exp"]))
    exp["tpu"]["seed"] = int(seed)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = NESReference(exp, arrays, bench_data.split_rows(arrays),
                           device, quant=quant, fault=fault)
        states = [tuple(x.cpu() for x in (ref.theta, ref.m_adam,
                                           ref.v_adam))]
        gens = [ref.generation(follow[k] if follow else None)
                for k in range(CHECKED_GENS)]
        states += [g["state"] for g in gens]
        return {"model": ref.m, "gens": gens, "states": states,
                "fitness": [g["fitness"] for g in gens],
                "val": [g["val"] for g in gens],
                "grad": [g["grad"] for g in gens]}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _leaf_gaps(model, a: torch.Tensor, b: torch.Tensor, keep=None):
    """(worst leaf's |norm(a) - norm(b)|, worst leaf's norm(a - b)), each
    over the larger of the leaf's norm(b) and the median leaf's; ``keep``
    names the leaves compared (all by default)."""
    names = [n for n, _ in model.leaves if keep is None or n in keep]
    nb = {n: float(model.leaf(b, n).double().norm()) for n in names}
    med = float(np.median(list(nb.values())))
    gap = diff = 0.0
    for n in names:
        la, lb = model.leaf(a, n).double(), model.leaf(b, n).double()
        den = max(nb[n], med, 1e-300)
        gap = max(gap, abs(float(la.norm()) - nb[n]) / den)
        diff = max(diff, float((la - lb).norm()) / den)
    return gap, diff


def generation_gaps(prog: dict, ref: dict) -> list:
    """Per checked generation: the relative L2 gap of the (F, 2)
    fitnesses, the relative gap of their mean and the absolute gap of the
    validation score."""
    out = []
    for fp, fr, vp, vr in zip(prog["fitness"], ref["fitness"], prog["val"],
                              ref["val"]):
        fp, fr = fp.double(), fr.double()
        out.append({
            "fitness_gap": float((fp - fr).norm())
            / max(float(fr.norm()), 1e-12),
            "loss_gap": abs(float(fp.mean() - fr.mean()))
            / max(abs(float(fr.mean())), 1e-12),
            "val_gap": abs(vp - vr)})
    return out


def compare(prog: dict, ref: dict, own_start: torch.Tensor,
            beta1: float = 0.9) -> dict:
    """The numbers that decide ``correct``, of a run ``prog`` and the
    reference ``ref`` that followed its states step by step. The start: the
    run's initial theta against the reference's own (``own_start``; exact).
    Per step (each the largest over the checked steps): the fitnesses
    (relative L2 gap of the (F, 2) vectors), their mean (the step's loss),
    the validation score (absolute gap), and the gradient as Adam got it
    ((m_k - beta1 m_k-1) / (1 - beta1) of the run's states) by the worst
    leaf. The change of theta over the three steps, the run's against the
    sum of the reference's steps, by the worst leaf, leaving out leaves
    whose reference gradient is under a thousandth of the median leaf's
    (rounding alone moves them under Adam)."""
    m = ref["model"]
    gaps = generation_gaps(prog, ref)
    fit, loss, val = (max(g[k] for g in gaps)
                      for k in ("fitness_gap", "loss_gap", "val_gap"))
    st = prog["states"]
    g_gap = g_diff = 0.0
    moved = set()
    for k, g_ref in enumerate(ref["grad"], start=1):
        g_prog = (st[k][1] - beta1 * st[k - 1][1]) / (1 - beta1)
        a, b = _leaf_gaps(m, g_prog, g_ref)
        g_gap, g_diff = max(g_gap, a), max(g_diff, b)
        gn = {n: float(m.leaf(g_ref, n).double().norm())
              for n, _ in m.leaves}
        med = float(np.median(list(gn.values())))
        moved |= {n for n, v in gn.items() if v >= 1e-3 * med}
    ref_change = sum(ref["states"][k][0] - st[k - 1][0]
                     for k in range(1, len(ref["grad"]) + 1))
    c_gap, c_diff = _leaf_gaps(m, st[-1][0] - st[0][0], ref_change, moved)
    return {"init_gap": float((st[0][0] - own_start).abs().max()),
            "fitness_gap": fit, "loss_gap": loss, "val_gap": val,
            "grad_norm_gap": g_gap, "grad_gap": g_diff,
            "change_norm_gap": c_gap, "change_gap": c_diff}


def judge(prog: dict, cell: dict, seed: int, arrays: dict, device) -> tuple:
    """(the compared numbers, the per-generation gaps, the reference's
    run) of the outputs ``prog`` of a run of ``cell`` on ``arrays``: the
    reference follows the run's states step by step, from the same inputs
    and seed."""
    ref = reference_run(cell, seed, arrays, device, follow=prog["states"])
    nums = compare(prog, ref, ref["states"][0][0])
    return nums, generation_gaps(prog, ref), ref


def _model_flops(cell: dict, ref: dict, captions_per_gen: int) -> dict:
    """Per generation: the rollouts' and the validation's forward FLOPs
    (``flops.decode_flops``), with the executed steps of the reference's
    checked generations, and the pair kernel's launch shape."""
    m = ref["model"]
    mo = cell["exp"]["policy_options"]["model_options"]
    E, R, F = (int(mo["input_encoding_size"]), int(mo["rnn_size"]),
               int(mo["fc_feat_size"]))
    bs = int(cell["exp"]["config"]["batch_size"])
    steps = torch.stack([g["steps"].double() for g in ref["gens"]])
    roll = flops.decode_flops(steps, bs, F, m.V1, E, R) / len(ref["gens"])
    val = sum(flops.rows_flops(g["val_seq"], F, m.V1, E, R)
              for g in ref["gens"]) / len(ref["gens"])
    return {"flops_per_gen": roll + val, "E": E, "R": R, "F": F, "B": bs,
            "V1": m.V1, "T": int(ref["gens"][0]["val_seq"].shape[-1]),
            "dim_dec": m.dim_dec, "steps": float(steps.mean()),
            "pop_chunk": int(cell["exp"]["tpu"].get("pop_chunk") or 0),
            "captions_per_gen": captions_per_gen}


def judge_run(out: dict, cell: dict, seed: int, arrays: dict, device
              ) -> tuple:
    """(the compared numbers, the record's fields from the reference's
    tokens) of a run's ``out``."""
    nums, _, ref = judge(program_outputs(out), cell, seed, arrays, device)
    return nums, _model_flops(cell, ref, out["captions_per_gen"])


def readings(cell: dict, seed: int, side: str, device, arrays: dict,
             quant: str = "fp8") -> dict:
    """The compared numbers of one seed on one side, and the per-generation
    gaps they are the largest of. ``program``: the program's set-up and
    generations 1-3 (no window); ``control``: the reference at ``quant``;
    ``half``, ``token``: the reference with that fault planted; each put in
    the program's place and judged as a run is."""
    if side == "program":
        prog = program_outputs(program_run(cell, seed, 0.0, False, device,
                                           arrays, window=False))
    elif side == "control":
        prog = reference_run(cell, seed, arrays, device, quant=quant)
    else:
        prog = reference_run(cell, seed, arrays, device, fault=side)
    nums, by_gen, _ = judge(prog, cell, seed, arrays, device)
    return {**nums, "by_generation": by_gen}

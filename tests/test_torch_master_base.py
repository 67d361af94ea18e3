"""The cadence that the port's NES and ES masters share (``MasterBase``):
for every iteration the block sizes equal the JAX masters' own, with
snapshots, a schedule, host validation every k generations, fused
validation, and the ES path's state gates."""

import numpy as np
import pytest

from test_torch_es import coco, es_exp, jax_master, torch_master  # noqa: F401
from test_torch_master import _exp, coco_files  # noqa: F401
from torch_pin import one_intra_op_thread  # noqa: F401

# (config, tpu) cadences: snapshots every 5 with a schedule from 7 every 6;
# snapshots every 4 with host validation every 3; no events at all
CADENCES = {
    "snapshot_schedule": ({"snapshot_freq": 5, "schedule_start": 7,
                           "schedule_limit": 6}, {"gens_per_dispatch": 8}),
    "snapshot_val_freq": ({"snapshot_freq": 4},
                          {"gens_per_dispatch": 8, "val_freq": 3}),
    "free": ({"snapshot_freq": 0}, {"gens_per_dispatch": 4}),
}


def _set(exp, cadence):
    config, tpu = CADENCES[cadence]
    exp["config"].update(patience=0, **config)
    exp["tpu"].update(tpu)
    return exp


def _budgets(jm, tm, jax_budget):
    """(JAX's, the port's) block sizes over iterations 0-29, a few
    generations left in the epoch and with and without an iteration
    limit."""
    got, want = [], []
    for i in range(30):
        jm.it._iteration = tm.it._iteration = i
        for gens_left in (1, 3, 8, 100):
            for limit in (None, 26):
                if limit and i >= limit:
                    continue
                want.append(jax_budget(gens_left, limit))
                got.append(tm._block_budget(gens_left, limit))
    return want, got


@pytest.mark.parametrize("val_fused", [False, True])
@pytest.mark.parametrize("cadence", sorted(CADENCES))
def test_nes_block_budget_matches_jax(coco_files, tmp_path, cadence,
                                      val_fused):
    from nes_img_captioning_tpu.algorithms.nes import NESMaster as JMaster
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    exp = _set(_exp(coco_files, tmp_path / "j"), cadence)
    jm = JMaster(exp)
    tm = NESMaster(dict(exp, log_dir=str(tmp_path / "t")), device="cpu")
    jm._val_fused = tm._val_fused = val_fused
    want, got = _budgets(jm, tm, lambda g, lim: jm._block_budget(True, g,
                                                                 lim))
    assert got == want
    # host validation every generation keeps each generation alone
    chains = val_fused or CADENCES[cadence][1].get("val_freq", 1) > 1
    assert (max(got) > 1) == chains


@pytest.mark.parametrize("state", ["steady", "podium_filling",
                                   "no_pending_cands"])
@pytest.mark.parametrize("cadence", sorted(CADENCES))
def test_es_block_budget_matches_jax(coco, tmp_path, cadence, state):
    exp = _set(es_exp(coco, tmp_path / "j"), cadence)
    jm = jax_master(exp)
    exp["log_dir"] = str(tmp_path / "t")
    tm = torch_master(exp)
    slot = tmp_path / "slot.pth"
    slot.write_bytes(b"")
    n_filled = exp["num_elites"] - (state == "podium_filling")
    podium = [(str(slot), 1.0)] * n_filled + \
        [(None, -np.inf)] * (exp["num_elites"] - n_filled)
    for m in (jm, tm):
        # the fused steady state: selected children and pending candidates
        # on the card, from an earlier fused step
        m._selected_dev = m._cands_dev = np.zeros(1)
        m._cand_scores_pending = (None if state == "no_pending_cands"
                                  else np.zeros(1))
        m.it.best_elites = lambda: podium
    want, got = _budgets(jm, tm, jm._block_budget)
    assert got == want
    assert (max(got) > 1) == (state == "steady")

"""Port parity for NIC-ES selection under tied fitness: the port's ESMaster
against the JAX package's over 6 generations on the plain, fused and
blocked paths, with uniform and tournament selection. The toy size, the
seams that hand the port JAX's realized noise and inits, and the masters
are those of ``test_torch_es.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_es import (  # noqa: F401
    CALLS,
    PATHS,
    coco,
    es_exp,
    final_state,
    jax_master,
    jax_randomness,
    record,
    torch_master,
)

from torch_pin import one_intra_op_thread  # noqa: F401


def fake_scores(jtask, ttask):
    """Fitness and validation as functions of one weight each, with three
    and two distinct values: many ties, computed identically by both
    packages on equal weights."""
    jtask.rollout = lambda th, idx, key=None, consts=None: {
        "fitness": jnp.floor(th[7] * 300.0) % 3.0}
    jtask.validate = lambda th: float(jnp.floor(th[11] * 300.0) % 2.0)
    jtask.validate_device = lambda th, vc: jnp.floor(th[11] * 300.0) % 2.0
    ttask.rollout = lambda th, idx, consts=None, lanes=None: {
        "fitness": torch.floor(th[:, 7] * 300.0) % 3.0}
    ttask.validate = lambda th: float(torch.floor(th[11] * 300.0) % 2.0)
    ttask.validate_device = lambda th, vc: torch.floor(th[11] * 300.0) % 2.0


@pytest.mark.parametrize("path,selection", [
    ("plain", "uniform"), ("plain", "tournament"),
    ("fused", "tournament"), ("blocked", "uniform")])
def test_selection_and_streams_match_jax_with_ties(coco, tmp_path,
                                                   monkeypatch, path,
                                                   selection):
    """Plain mutations and tied fitness: for the same tpu.seed the port's
    per-generation seeds, parent indices and batches equal JAX's; handed
    JAX's noise, its children equal JAX's within 1e-6 (XLA's compiled
    sweep rounds the children an ulp apart), and with the same fitness
    vectors (ties everywhere) it keeps the same children, publishes the
    same candidates, assembles the same parents and podium, over 6
    generations (blocked: 1 plain, 1 fused, a block of 4)."""
    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    runs = {}
    exp = es_exp(coco, tmp_path / "jax", mutation="", **PATHS[path])
    exp["selection"], exp["tournament_size"] = selection, 3
    jm = jax_master(exp)
    exp["log_dir"] = str(tmp_path / "torch")
    jax_randomness(monkeypatch, jm)
    tm = torch_master(exp)
    fake_scores(jm.task, tm.task)
    for name, m, cls in (("jax", jm, JEngine), ("torch", tm, ESEngine)):
        log = record(m, cls, monkeypatch)
        m.run_master(max_iterations=6)
        runs[name] = (log, final_state(m), m.stats.to_dict())

    (jl, (jc, jp, jn), js), (tl, (tc, tp, tn), ts) = runs["jax"], \
        runs["torch"]
    assert len(jl["streams"]) == len(tl["streams"]) == 6
    assert jl["calls"] == tl["calls"] == CALLS[path]
    for g, (a, b) in enumerate(zip(jl["streams"], tl["streams"])):
        for x, y, what in zip(a, b, ("seeds", "pidx", "idx_row")):
            np.testing.assert_array_equal(y, x, err_msg=f"{what}, gen {g}")
    for g, (a, b) in enumerate(zip(jl["fitness"], tl["fitness"])):
        np.testing.assert_array_equal(b, a, err_msg=f"fitness, gen {g}")
    assert len(set(np.concatenate(tl["fitness"]).tolist())) <= 3  # ties
    assert jn == tn
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    assert [s for s, _ in tp] == [s for s, _ in jp]
    for (_, a), (_, b) in zip(jp, tp):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    for key in ("acc_stats", "best_acc_so_far_stats", "bs_stats"):
        assert ts[key] == js[key], key
    np.testing.assert_allclose(ts["norm_stats"], js["norm_stats"],
                               rtol=1e-6)

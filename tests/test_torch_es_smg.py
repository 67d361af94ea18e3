"""Port parity for NIC-ES with the sensitivity-scaled safe mutations
(SM-G-SUM, SM-G-ABS, SM-VECTOR): the port's ESMaster against the JAX
package's, and the port's three paths against each other, on the CPU at
the toy size of ``test_torch_es.py``, from
``experiments/mscoco_es_smg_fast.json``.

As there, the port is handed JAX's realized noise and generation-0 inits
(``ESEngine.normal_of``, ``fresh_of``), and for the probe estimator JAX's
Rademacher matrix (``ESEngine.probes_of``). The sensitivities run at f32
over the first 4 rows of each batch, in 4 vocab groups (split 8).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_es import (  # noqa: F401
    CALLS,
    PATHS,
    REPO,
    coco,
    final_state,
    jax_master,
    jax_randomness,
    record,
    torch_master,
)


def smg_exp(copts, log_dir, mutation="SM-G-SUM", **tpu):
    """experiments/mscoco_es_smg_fast.json cut to toy size: the widths and
    populations of test_torch_es.es_exp (8 offspring, 5 parents, 2 elites,
    2 candidates, batch 8, 10 validation images, sigma 0.05), underflow
    0.01, sensitivity_batch 4, sensitivity_split 8, f32."""
    with open(os.path.join(REPO, "experiments",
                           "mscoco_es_smg_fast.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=8, val_batch_size=4, num_val_items=10,
                         noise_stdev=0.05, snapshot_freq=6)
    exp["policy_options"]["model_options"].update(
        safe_mutations=mutation, input_encoding_size=16, rnn_size=16,
        fc_feat_size=24)
    exp.update(nb_offspring=8, population_size=5, num_elites=2,
               num_elite_cands=2, caption_options=dict(copts),
               log_dir=str(log_dir))
    exp["tpu"] = {"seed": 5, "precision": "f32", "pop_chunk": 3,
                  "sensitivity_batch": 4, "sensitivity_split": 8, **tpu}
    return exp


def jax_probes(monkeypatch, jax_ref):
    """Hand the port's ESEngine JAX's probe matrix of each generation."""
    from nes_img_captioning_tpu.ops.sensitivity import probe_key_from_seed
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    mk = jax_ref.engine._mk_key

    def probes_of(self, seed0, probes, groups):
        return np.asarray(jax.random.rademacher(
            probe_key_from_seed(mk, np.uint32(seed0)), (probes, groups),
            jnp.float32))

    monkeypatch.setattr(ESEngine, "probes_of", probes_of)


def _run_pair(exp, tmp_path, monkeypatch, iters):
    """The JAX and the port's ESMaster on one experiment, the port handed
    JAX's randomness: (log, final state, stats) of each."""
    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    jm = jax_master(exp)
    exp = dict(exp, log_dir=str(tmp_path / "torch"))
    jax_randomness(monkeypatch, jm)
    jax_probes(monkeypatch, jm)
    tm = torch_master(exp)
    runs = {}
    for name, m, cls in (("jax", jm, JEngine), ("torch", tm, ESEngine)):
        log = record(m, cls, monkeypatch)
        m.run_master(max_iterations=iters)
        runs[name] = (log, final_state(m), m.stats.to_dict())
    return runs["jax"], runs["torch"]


def _assert_same_trajectory(jax_run, torch_run, n_gens):
    """The same streams (so the same selected parents and batches), the
    fitness vectors within 1e-5, the children and podium within 1e-5."""
    (jl, (jc, jp, jn), js), (tl, (tc, tp, tn), ts) = jax_run, torch_run
    assert jl["calls"] == tl["calls"] and len(tl["streams"]) == n_gens
    for a, b in zip(jl["streams"], tl["streams"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    for a, b in zip(jl["fitness"], tl["fitness"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        # the same order, so truncation selection keeps the same children
        np.testing.assert_array_equal(np.argsort(-b, kind="stable"),
                                      np.argsort(-a, kind="stable"))
    assert np.ptp(np.concatenate(tl["fitness"])) > 0
    assert jn == tn
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    for (sa, ra), (sb, rb) in zip(jp, tp):
        np.testing.assert_allclose(sb, sa, rtol=1e-4)
        np.testing.assert_allclose(rb, ra, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts["acc_stats"], js["acc_stats"], rtol=1e-4)


@pytest.mark.parametrize("mutation,probes,path", [
    ("SM-G-SUM", 0, "plain"), ("SM-G-SUM", 0, "fused"),
    ("SM-G-ABS", 0, "plain"), ("SM-G-SUM", 3, "fused")],
    ids=["sum-plain", "sum-fused", "abs-plain", "probes-fused"])
def test_smg_trajectory_matches_jax(coco, tmp_path, monkeypatch, mutation,
                                    probes, path):
    """3 generations of SM-G NIC-ES (greedy CIDEr-D on the device) on the
    plain path (the master's _update_sensitivities) and the fused path (the
    sensitivities inside the generation), against JAX's: the same streams
    and selections, fitness within 1e-5."""
    tpu = dict(PATHS[path])
    if probes:
        tpu["sensitivity_probes"] = probes
    exp = smg_exp(coco, tmp_path / "jax", mutation, **tpu)
    jax_run, torch_run = _run_pair(exp, tmp_path, monkeypatch, 3)
    _assert_same_trajectory(jax_run, torch_run, 3)
    assert torch_run[0]["calls"] == CALLS[path][:3]


@pytest.mark.parametrize("mutation,probes", [
    ("SM-G-SUM", 0), ("SM-G-SUM", 2), ("SM-G-ABS", 0)],
    ids=["sum", "probes", "abs"])
def test_smg_port_paths_bitwise_equal(coco, tmp_path, monkeypatch,
                                      mutation, probes):
    """The port's plain, fused and blocked paths from one tpu.seed, 6
    generations of SM-G (blocked: 1 plain, 1 fused, a block of 4): the
    sensitivities of a parent row are the same bits on every path, so the
    fitness vectors, children, podium rows and mean|policy| are too."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    runs = {}
    for path, tpu in PATHS.items():
        extra = {"sensitivity_probes": probes} if probes else {}
        m = torch_master(smg_exp(coco, tmp_path / path, mutation, **tpu,
                                 **extra))
        sweeps = []
        sens = m.engine.sensitivities

        def spy(parents, sens_idx, seed0, sens=sens, sweeps=sweeps):
            sweeps.append(parents.shape[0])
            return sens(parents, sens_idx, seed0)

        m.engine.sensitivities = spy
        log = record(m, ESEngine, monkeypatch)
        m.run_master(max_iterations=6)
        assert log["calls"] == CALLS[path]
        assert sweeps == [5] * 5  # generations 2-6 sweep the 5 parents
        runs[path] = (log, final_state(m), m.stats.to_dict())
    plain = runs["plain"]
    assert np.ptp(np.concatenate(plain[0]["fitness"])) > 0
    for path in ("fused", "blocked"):
        log, (c, pod, n), st = runs[path]
        for a, b in zip(plain[0]["fitness"], log["fitness"]):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, plain[1][0])
        assert n == plain[1][2] and len(pod) == len(plain[1][1])
        for (_, ra), (_, rb) in zip(plain[1][1], pod):
            np.testing.assert_array_equal(rb, ra)
        assert st["norm_stats"] == plain[2]["norm_stats"]


def test_sm_vector_matches_jax(coco, tmp_path, monkeypatch):
    """SM-VECTOR: both masters load one .npy vector, clamp it at the
    underflow and divide it by its min, and divide every child's noise by
    it; 3 generations (plain, then fused) against JAX's."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster

    exp = smg_exp(coco, tmp_path / "jax", "SM-VECTOR")
    dim = torch_master(smg_exp(coco, tmp_path / "dim", "")).engine.dim
    vec = np.random.default_rng(2).uniform(0.0, 0.05, dim)
    path = str(tmp_path / "sens.npy")
    np.save(path, vec.astype(np.float32))
    exp["policy_options"]["model_options"]["safe_mutation_vector"] = path
    jax_run, torch_run = _run_pair(exp, tmp_path, monkeypatch, 3)
    _assert_same_trajectory(jax_run, torch_run, 3)
    tm_vec = ESMaster(dict(exp, log_dir=str(tmp_path / "v")),
                      device="cpu")._sens_vector.numpy()
    want = np.maximum(vec.astype(np.float32), 0.01)
    np.testing.assert_array_equal(tm_vec, want / want.min())

"""The port's NIC-NES and NIC-ES on MNIST against the JAX package's, on the
CPU at toy size: experiments/mnist_nes.json and mnist_es.json (vbn on for
NES, SM-G-SUM for both) cut to synthetic sizes (256, 128), batch 16, 4
pairs or 8 offspring of 5 parents.

torch cannot draw JAX's noise, so the port is handed JAX's realized
randomness through its seams: ``NESEngine.normal_of`` and
``ESEngine.normal_of`` (a seed's N(0, 1) in torch order, from the JAX key of
the seed) and ``ESEngine.fresh_of`` (generation 0's inits); the NES master
starts from JAX's init. The NES comparisons step with SGD (momentum 0.9,
stepsize 10, so theta moves by about 1e-2): Adam's first step divides by
|globalg| + epsilon, which sets the step of every element whose gradient
nearly cancels, while SGD's step is linear in the gradient.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_es import final_state, jax_randomness, record
from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS, OFFSPRING, B, SGD_STEP, SIGMA, L2 = 4, 8, 16, 10.0, 0.02, 0.001


def mnist_exp(algo: str, log_dir, **tpu) -> dict:
    """experiments/mnist_{nes,es}.json cut to toy size; NES steps with
    SGD."""
    with open(os.path.join(REPO, "experiments", f"mnist_{algo}.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=B, val_batch_size=16, snapshot_freq=5)
    exp["synthetic_sizes"] = [256, 128]
    if algo == "nes":
        exp["nb_offspring"] = PAIRS
        exp["optimizer_options"] = {"type": "sgd",
                                    "args": {"stepsize": SGD_STEP}}
    else:
        exp.update(nb_offspring=OFFSPRING, population_size=5, num_elites=2,
                   num_elite_cands=2)
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, **tpu}
    exp["log_dir"] = str(log_dir)
    return exp


def _copy(exp):
    return json.loads(json.dumps(exp))


def _jax_normal(jeng, dim):
    return lambda seed: torch.from_numpy(np.asarray(jax.random.normal(
        jeng._mk_key(jnp.uint32(seed)), (dim,), jnp.float32)).copy())


# ---- NIC-NES -------------------------------------------------------------------


@pytest.mark.parametrize("mutation", ["", "SM-G-SUM"])
def test_nes_generation_matches_jax(tmp_path, mutation):
    """One torch-order generation (vbn, 4 pairs in chunks of 3, SGD) of
    the port's NESEngine against the JAX engine's, on JAX's normals; SM-G-
    SUM computes its sensitivity inline from theta over member 0's batch in
    both: fitnesses within 1e-5, theta within 1e-6, ratio and mean|theta|
    within 1e-5 relative."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JEngine
    from nes_img_captioning_tpu.algorithms.optimizers import SGD as JSGD
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu.tasks.classification import MnistTask as JT
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import SGD
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.classification import MnistTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = mnist_exp("nes", tmp_path)
    jtask = JT(exp, JConfig(batch_size=B), jp(exp))
    task = MnistTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                     device="cpu")
    jeng = JEngine(jtask, JSGD(SGD_STEP), JKind(mutation), pop_chunk=3,
                   sens_underflow=0.2)
    eng = NESEngine(task, SGD(SGD_STEP), MutationKind(mutation), pop_chunk=3,
                    sens_underflow=0.2)
    assert jeng.inline_sens == eng.inline_sens == bool(mutation)
    eng.normal_of = _jax_normal(jeng, eng.dim)
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 2**32, size=PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 256, size=(PAIRS, B)).astype(np.int32)
    theta = np.asarray(jtask.generate_theta(jax.random.PRNGKey(2)))
    jth, _, jpacked = jeng.generation(
        jnp.asarray(theta), jeng.optimizer.init(jeng.dim),
        jnp.ones(jeng.dim), SIGMA, seeds, idx, SGD_STEP, L2)
    th, _, packed = eng.generation(
        torch.from_numpy(theta.copy()), eng.optimizer.init(eng.dim, "cpu"),
        torch.ones(eng.dim), SIGMA, seeds, idx, SGD_STEP, L2)
    jfits, jratio, jnorm = jeng.unpack(jpacked, PAIRS)
    fits, ratio, norm = eng.unpack(packed, PAIRS)
    np.testing.assert_allclose(fits, jfits, rtol=0, atol=1e-5)
    assert np.ptp(fits) > 1e-3
    moved = np.abs(np.asarray(jth) - theta).max()
    assert 1e-3 < moved < 0.1
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=0, atol=1e-6)
    np.testing.assert_allclose([ratio, norm], [jratio, jnorm], rtol=1e-5)


def _spy_unpack(monkeypatch, engine_cls, log):
    unpack = engine_cls.unpack

    def spy(packed, F):
        out = unpack(packed, F)
        log.extend(np.asarray(out[0]).reshape(-1, F, 2).copy())
        return out

    monkeypatch.setattr(engine_cls, "unpack", staticmethod(spy))


def test_nes_master_matches_jax(tmp_path, monkeypatch):
    """mnist_nes.json (vbn, SM-G-SUM inline, patience 2) through both
    masters from one tpu.seed, the port handed JAX's init and normals, 3
    iterations with SGD: the per-generation fitnesses within 1e-5, theta
    within 1e-6, the validation accuracies equal."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JEngine
    from nes_img_captioning_tpu.algorithms.nes import NESMaster as JMaster
    from nes_img_captioning_tpu_torch.algorithms.nes import (
        NESEngine,
        NESMaster,
    )

    exp = mnist_exp("nes", tmp_path / "jax")
    jm = JMaster(_copy(exp))
    exp["log_dir"] = str(tmp_path / "torch")
    tm = NESMaster(_copy(exp), device="cpu")
    init = np.asarray(jm.theta).copy()
    tm.theta = torch.from_numpy(init.copy())
    tm._write_current_model()
    monkeypatch.setattr(NESEngine, "normal_of",
                        lambda self, s: _jax_normal(jm.engine, self.dim)(s))
    logs = {}
    for name, m, cls in (("jax", jm, JEngine), ("torch", tm, NESEngine)):
        logs[name] = []
        _spy_unpack(monkeypatch, cls, logs[name])
        m.run_master(max_iterations=3)
    assert len(logs["jax"]) == len(logs["torch"]) == 3
    for a, b in zip(logs["jax"], logs["torch"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert np.ptp(np.concatenate(logs["torch"])) > 1e-3
    assert np.abs(tm.theta.numpy() - init).max() > 1e-3
    np.testing.assert_allclose(tm.theta.numpy(), np.asarray(jm.theta),
                               rtol=0, atol=1e-6)
    assert tm.stats.to_dict()["acc_stats"] == jm.stats.to_dict()["acc_stats"]


def test_nes_block_and_fused_validation_bitwise_single(tmp_path):
    """The port's own paths from one tpu.seed, 4 iterations with patience
    0: blocks of 2 generations with validation on the device against
    single generations with host validation give theta, the fitness
    series and the accuracies bit for bit; the run leaves z_info, the
    current model and the podium's files."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    runs = {}
    for name, gpd in (("block", 2), ("single", 1)):
        exp = mnist_exp("nes", tmp_path / name, gens_per_dispatch=gpd)
        exp["config"]["patience"] = 0
        m = NESMaster(exp, device="cpu")
        m.run_master(max_iterations=4)
        assert m._val_fused == (gpd > 1)
        runs[name] = (m.theta, m.stats.to_dict())
    (tb, sb), (ts, ss) = runs["block"], runs["single"]
    assert torch.equal(tb, ts)
    for key in ("score_stats", "acc_stats", "norm_stats"):
        assert sb[key] == ss[key], key
    (zinfo,) = glob.glob(str(tmp_path / "block" / "snapshot" / "z_info_*"))
    with open(zinfo) as f:
        infos = json.load(f)
    assert infos["iter"] == 4 and os.path.isfile(infos["current_model"])
    assert all(os.path.isfile(p) for p, _ in infos["best_elites"] if p)


# ---- NIC-ES ----------------------------------------------------------------------


ES_PATHS = {"plain": {"fused_es": False}, "fused": {},
            "blocked": {"gens_per_dispatch": 4}}


def _es_master(exp):
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster

    return ESMaster(_copy(exp), device="cpu")


def test_es_trajectory_matches_jax(tmp_path, monkeypatch):
    """mnist_es.json (SM-G-SUM, underflow 0.2) on the blocked path, 6
    generations of both masters from one tpu.seed, the port handed JAX's
    noise and inits: the same seeds, parents and batches, fitness vectors
    within 1e-5, the kept children and the podium's rows within 1e-6."""
    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu.algorithms.es import ESMaster as JMaster
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    exp = mnist_exp("es", tmp_path / "jax", **ES_PATHS["blocked"])
    jm = JMaster(_copy(exp))
    exp["log_dir"] = str(tmp_path / "torch")
    jax_randomness(monkeypatch, jm)
    tm = _es_master(exp)
    runs = {}
    for name, m, cls in (("jax", jm, JEngine), ("torch", tm, ESEngine)):
        log = record(m, cls, monkeypatch)
        m.run_master(max_iterations=6)
        runs[name] = (log, final_state(m))
    (jl, (jc, jp, jn)), (tl, (tc, tp, tn)) = runs["jax"], runs["torch"]
    assert jl["calls"] == tl["calls"] and "fused_block" in tl["calls"]
    assert len(tl["fitness"]) == 6
    for a, b in zip(jl["streams"], tl["streams"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    for a, b in zip(jl["fitness"], tl["fitness"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert np.ptp(np.concatenate(tl["fitness"])) > 1e-3
    assert jn == tn
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    assert len(tp) == len(jp)
    for (sa, ra), (sb, rb) in zip(jp, tp):
        assert sb == sa
        np.testing.assert_allclose(rb, ra, rtol=0, atol=1e-6)


def test_es_paths_bitwise_equal(tmp_path, monkeypatch):
    """The port's plain, fused and blocked paths on mnist_es.json (SM-G-
    SUM) from one tpu.seed, 6 generations: fitness vectors, kept children,
    podium rows and scores bit for bit, and the accuracies equal."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    runs = {}
    for path, tpu in ES_PATHS.items():
        m = _es_master(mnist_exp("es", tmp_path / path, **tpu))
        log = record(m, ESEngine, monkeypatch)
        m.run_master(max_iterations=6)
        # a later run's blocks also reach this log's wrapper: copy it now
        assert len(log["fitness"]) == 6
        runs[path] = (dict(log, fitness=list(log["fitness"])),
                      final_state(m), m.stats.to_dict())
    assert "fused_block" in runs["blocked"][0]["calls"]
    assert "fused_generation" in runs["fused"][0]["calls"]
    plain = runs["plain"]
    for path in ("fused", "blocked"):
        log, (c, pod, n), st = runs[path]
        for a, b in zip(plain[0]["fitness"], log["fitness"]):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, plain[1][0])
        assert n == plain[1][2]
        assert [s for s, _ in pod] == [s for s, _ in plain[1][1]]
        for (_, ra), (_, rb) in zip(plain[1][1], pod):
            np.testing.assert_array_equal(rb, ra)
        assert st["acc_stats"] == plain[2]["acc_stats"]


@pytest.mark.parametrize("algo", ["nes", "es"])
def test_cli_trains_mnist(tmp_path, algo):
    """``python -m nes_img_captioning_tpu_torch.main master --device cpu
    --exp_file`` on the cut mnist_nes.json / mnist_es.json trains 3
    iterations and leaves z_info with its model files."""
    exp = mnist_exp(algo, tmp_path / "run")
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    out = subprocess.run(
        [sys.executable, "-m", "nes_img_captioning_tpu_torch.main", "master",
         "--exp_file", str(path), "--max_iterations", "3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"RUNNING NIC-{algo.upper()}" in out.stderr
    (zinfo,) = glob.glob(str(tmp_path / "run" / "snapshot" / "z_info_*"))
    with open(zinfo) as f:
        infos = json.load(f)
    assert infos["iter"] == 3 and len(infos["acc_stats"]) == 3
    assert all(0.0 <= a <= 1.0 for a in infos["acc_stats"])
    models = ([infos["current_model"]] if algo == "nes" else
              [p for _, p in infos["parents"]])
    assert models and all(os.path.isfile(p) for p in models)

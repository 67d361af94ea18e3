"""Port parity for NIC-ES: the port's ESEngine and ESMaster against the JAX
package's, on the CPU at toy size (vocab 30, E = R = 16, 24-d features,
8 offspring, 5 parents, 2 elites, 2 candidates).

torch cannot reproduce JAX's noise streams, so the port is handed JAX's
realized randomness through its seams: ``ESEngine.normal_of`` (a child's
N(0, 1) noise, from the JAX key of its seed) and ``ESEngine.fresh_of``
(generation 0's random init). The JAX side decodes with XLA (its fused
kernel is TPU-only); the port with its kernels' plain twins, both at f32.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L_OFF, POP, ELITES, CANDS, B = 8, 5, 2, 2, 8


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_es")
    return make_synthetic_coco(str(d), n_train=48, n_val=11, n_test=8,
                               vocab_size=30, fc_feat_size=24)


def es_exp(copts, log_dir, mutation="SM-PROPORTIONAL", **tpu):
    """experiments/mscoco_es.json cut to toy size (widths above, batch 8,
    10 validation images, sigma 0.05, snapshots every 6 iterations)."""
    with open(os.path.join(REPO, "experiments", "mscoco_es.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=B, val_batch_size=4, num_val_items=10,
                         noise_stdev=0.05, snapshot_freq=6)
    exp["policy_options"]["model_options"].update(
        safe_mutations=mutation, input_encoding_size=16, rnn_size=16,
        fc_feat_size=24)
    exp.update(nb_offspring=L_OFF, population_size=POP, num_elites=ELITES,
               num_elite_cands=CANDS, caption_options=dict(copts),
               log_dir=str(log_dir))
    exp["tpu"] = {"seed": 5, "precision": "f32", "pop_chunk": 3, **tpu}
    return exp


def jax_master(exp):
    from nes_img_captioning_tpu.algorithms.es import ESMaster

    return ESMaster(json.loads(json.dumps(exp)))


def torch_master(exp):
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster

    return ESMaster(json.loads(json.dumps(exp)), device="cpu")


def jax_randomness(monkeypatch, jax_ref):
    """Hand the port's ESEngine (every instance, for the test) the JAX
    master's realized noise and generation-0 inits for each seed."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    jeng = jax_ref.engine

    def normal_of(self, seed):
        key = jeng._mk_key(jnp.uint32(seed))
        return torch.from_numpy(np.asarray(jax.random.normal(
            key, (self.dim,), jnp.float32)).copy())

    def fresh_of(self, seed):
        th = jeng.task.spec.init_theta(jeng._mk_key(jnp.uint32(seed)))
        return torch.from_numpy(np.asarray(th).copy())

    monkeypatch.setattr(ESEngine, "normal_of", normal_of)
    monkeypatch.setattr(ESEngine, "fresh_of", fresh_of)


def record(master, engine_cls, monkeypatch):
    """Per generation: (seeds, pidx, idx_row) as the master hands them to
    its engine, and the fitness vector it reads back."""
    log = {"streams": [], "fitness": [], "calls": []}
    eng, task = master.engine, master.task

    def spy(name):
        fn = getattr(eng, name)
        sig = inspect.signature(fn)

        def wrapped(*a, **k):
            arg = sig.bind(*a, **k).arguments
            log["calls"].append(name)
            if name == "fused_block":
                for s, p, i in zip(arg["seeds"], arg["pidx"],
                                   arg["idx_rows"]):
                    log["streams"].append((s.copy(), p.copy(), i.copy()))
            else:
                log["streams"].append((np.asarray(arg["seeds"]).copy(),
                                       np.asarray(arg["pidx"]).copy(),
                                       np.asarray(arg["idx_row"]).copy()))
            return fn(*a, **k)

        setattr(eng, name, wrapped)

    for name in ("eval_generation", "fused_generation", "fused_block"):
        spy(name)
    host_fitness = task.host_fitness

    def hf(art, idx):
        out = host_fitness(art, idx)
        log["fitness"].append(np.asarray(out, np.float32).copy())
        return out

    task.host_fitness = hf
    unpack_fused = eng.unpack_fused

    def uf(packed, L, C):
        out = unpack_fused(packed, L, C)
        log["fitness"].append(np.asarray(out[0]).copy())
        return out

    eng.unpack_fused = uf
    unpack_block = engine_cls.unpack_block

    def ub(packed, K, L, C, E):
        out = unpack_block(packed, K, L, C, E)
        log["fitness"].extend(np.asarray(r).copy() for r in out[0])
        return out

    monkeypatch.setattr(engine_cls, "unpack_block", staticmethod(ub))
    return log


def final_state(master):
    """(children rows, podium [(score, row)], parent count)."""
    spec = master.task.spec
    if master.parents_mat is None:
        children = np.asarray(master._selected_dev)[:master._n_selected]
    else:
        n_el = sum(p is not None for p in master._parent_paths)
        children = np.asarray(master.parents_mat)[n_el:master._n_parents]
    podium = [(s, np.asarray(spec.load_pth(p))) for p, s in
              master.it.best_elites() if p]
    return children, podium, master._n_parents


PATHS = {"plain": {"fused_es": False}, "fused": {},
         "blocked": {"gens_per_dispatch": 4}}
# the engine calls of 6 generations on each path: generation 1 is always
# plain (fresh inits), the blocked path's block waits for a full podium
CALLS = {"plain": ["eval_generation"] * 6,
         "fused": ["eval_generation"] + ["fused_generation"] * 5,
         "blocked": ["eval_generation", "fused_generation", "fused_block"]}


def test_trajectory_matches_jax(coco, tmp_path, monkeypatch):
    """mscoco_es.json's settings (SM-PROPORTIONAL, greedy CIDEr-D scored on
    the device), 6 generations on JAX's plain, fused and blocked paths (a
    block of 4) against the port's, handed JAX's noise: the same streams,
    fitness vectors within 1e-5, candidate and podium scores within 1e-4,
    children and podium rows within 1e-5."""
    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    exp = es_exp(coco, tmp_path / "jax", gens_per_dispatch=4)
    jm = jax_master(exp)
    exp["log_dir"] = str(tmp_path / "torch")
    jax_randomness(monkeypatch, jm)
    tm = torch_master(exp)
    runs = {}
    for name, m, cls in (("jax", jm, JEngine), ("torch", tm, ESEngine)):
        log = record(m, cls, monkeypatch)
        m.run_master(max_iterations=6)
        runs[name] = (log, final_state(m), m.stats.to_dict())
    (jl, (jc, jp, jn), js), (tl, (tc, tp, tn), ts) = runs["jax"], \
        runs["torch"]
    assert len(tl["streams"]) == 6
    assert jl["calls"] == tl["calls"] == CALLS["blocked"]
    for a, b in zip(jl["streams"], tl["streams"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    for a, b in zip(jl["fitness"], tl["fitness"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert np.ptp(np.concatenate(tl["fitness"])) > 0
    assert jn == tn
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    for (sa, ra), (sb, rb) in zip(jp, tp):
        np.testing.assert_allclose(sb, sa, rtol=1e-4)
        np.testing.assert_allclose(rb, ra, rtol=0, atol=1e-5)
    for key in ("acc_stats", "best_acc_so_far_stats", "norm_stats"):
        np.testing.assert_allclose(ts[key], js[key], rtol=1e-4, err_msg=key)


def test_port_paths_bitwise_equal(coco, tmp_path, monkeypatch):
    """The port's plain, fused and blocked paths from one tpu.seed, 6
    generations: fitness vectors, mean|policy|, children and podium rows
    bit for bit; the fused and blocked candidate scores (validated on the
    device) bit for bit, the plain path's (host validation, the native
    scorer) within 1e-5 of them."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine

    runs = {}
    for path, tpu in PATHS.items():
        m = torch_master(es_exp(coco, tmp_path / path, **tpu))
        log = record(m, ESEngine, monkeypatch)
        m.run_master(max_iterations=6)
        assert log["calls"] == CALLS[path]
        runs[path] = (log, final_state(m), m.stats.to_dict())
    plain = runs["plain"]
    for path in ("fused", "blocked"):
        log, (c, pod, n), st = runs[path]
        for a, b in zip(plain[0]["fitness"], log["fitness"]):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, plain[1][0])
        assert n == plain[1][2]
        for (_, ra), (_, rb) in zip(plain[1][1], pod):
            np.testing.assert_array_equal(rb, ra)
        assert st["norm_stats"] == plain[2]["norm_stats"]
        np.testing.assert_allclose(st["acc_stats"], plain[2]["acc_stats"],
                                   rtol=1e-5)
    assert runs["fused"][2]["acc_stats"] == runs["blocked"][2]["acc_stats"]
    np.testing.assert_array_equal(
        np.asarray(runs["fused"][2]["best_acc_so_far_stats"], np.float32),
        np.asarray(runs["blocked"][2]["best_acc_so_far_stats"], np.float32))


def _tasks(copts, fitness):
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = {"dataset": "mscoco", "caption_options": dict(copts),
           "policy_options": {"fitness": fitness, "model_options": {
               "input_encoding_size": 16, "rnn_size": 16,
               "fc_feat_size": 24}},
           "tpu": {"seed": 0, "precision": "f32"}}
    return (JTask(exp, JConfig(batch_size=B), jp(exp)),
            CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                     device="cpu"))


@pytest.mark.parametrize("fitness", ["greedy", "greedy_logprob"])
def test_sweep_matches_jax_on_its_children(coco, fitness):
    """JAX's ESEngine sweeps 7 offspring of 3 parents (SM-PROPORTIONAL,
    chunks of 3); the port's rollout of JAX's realized children (its
    materialize) gives the same greedy tokens and fitnesses within 1e-5,
    and the port's own engine, handed JAX's noise, builds those children
    within 1e-6 and sweeps them to the same fitnesses."""
    from nes_img_captioning_tpu.algorithms.es import ESEngine as JEngine
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops.decode_cuda import decode_fused
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    jtask, ttask = _tasks(coco, fitness)
    jeng = JEngine(jtask, JKind.SAFE_PROPORTIONAL, pop_chunk=3)
    rng = np.random.default_rng(4)
    parents = (rng.standard_normal((3, jeng.dim)) * 0.3).astype(np.float32)
    parents[:, ::5] = 0.0  # SM-PROPORTIONAL's zero replacement
    seeds = rng.integers(0, 2**32, size=7, dtype=np.uint32)
    pidx = rng.integers(0, 3, size=7).astype(np.int32)
    idx_row = rng.integers(0, 48, size=B).astype(np.int32)
    sens = jnp.ones((1, jeng.dim), jnp.float32)
    art = jeng.eval_generation(jnp.asarray(parents), sens, 0.05, seeds, pidx,
                               idx_row)
    jfit = jtask.host_fitness(art, idx_row)
    children = np.asarray(jeng.materialize(jnp.asarray(parents), sens, 0.05,
                                           seeds, pidx))
    assert np.ptp(jfit) > 0

    kids = torch.from_numpy(children.copy())
    tfit = ttask.rollout(kids, idx_row)["fitness"].numpy()
    np.testing.assert_allclose(tfit, jfit, rtol=0, atol=1e-5)
    feats = jtask.train_fc[jnp.asarray(idx_row)]
    lay = ttask.decode_layout
    seq_t, _ = decode_fused(lay.prep(lay.to_dec(kids), torch.float32),
                            ttask.train_fc[torch.as_tensor(idx_row)]
                            .expand(7, -1, -1))
    for i in range(7):
        seq_j, _ = jtask._greedy(jnp.asarray(children[i]), feats)
        np.testing.assert_array_equal(seq_t[i].numpy(), np.asarray(seq_j))

    eng = ESEngine(ttask, MutationKind.SAFE_PROPORTIONAL, pop_chunk=3)
    eng.normal_of = lambda s: torch.from_numpy(np.asarray(jax.random.normal(
        jeng._mk_key(jnp.uint32(s)), (eng.dim,), jnp.float32)).copy())
    mine = eng.materialize(torch.from_numpy(parents), 0.05, seeds, pidx)
    np.testing.assert_allclose(mine.numpy(), children, rtol=0, atol=1e-6)
    swept = eng.eval_generation(torch.from_numpy(parents), 0.05, seeds, pidx,
                                idx_row)["fitness"].numpy()
    np.testing.assert_allclose(swept, jfit, rtol=0, atol=1e-5)


def _port_engine(copts, pop_chunk, fitness="greedy"):
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    _, ttask = _tasks(copts, fitness)
    return ESEngine(ttask, MutationKind.SAFE_PROPORTIONAL,
                    pop_chunk=pop_chunk)


def _population(dim, n_par=3, n_off=8, seed=6):
    rng = np.random.default_rng(seed)
    parents = torch.from_numpy(
        (rng.standard_normal((n_par, dim)) * 0.3).astype(np.float32))
    parents[:, ::7] = 0.0
    seeds = rng.integers(0, 2**32, size=n_off, dtype=np.uint32)
    pidx = rng.integers(0, n_par, size=n_off).astype(np.int32)
    idx_row = rng.integers(0, 48, size=B).astype(np.int32)
    return parents, seeds, pidx, idx_row


def test_children_and_fitness_do_not_depend_on_the_chunk(coco):
    """One child builder serves the sweep and materialize: each child is
    ``parent + shape_noise(sigma * N(0, 1), parent)`` bit for bit whichever
    children are built beside it; the sweep's fitness vector is the same
    bits for chunks of 1, 3 and 8 (a member's fitness does not depend on
    its place in its launch), and a duplicated child in another chunk gets
    the same fitness bits."""
    from nes_img_captioning_tpu_torch.ops.mutation import (
        normal_from_seed,
        shape_noise,
    )

    eng = _port_engine(coco, 3)
    parents, seeds, pidx, idx_row = _population(eng.dim)
    seeds[5], pidx[5] = seeds[1], pidx[1]  # one child twice, chunks apart
    whole = eng.materialize(parents, 0.05, seeds, pidx)
    for i in range(len(seeds)):
        p = parents[int(pidx[i])]
        want = p + shape_noise(0.05 * normal_from_seed(int(seeds[i]),
                                                       eng.dim, "cpu"),
                               p, proportional=True)
        assert torch.equal(whole[i], want)
    some = eng.materialize(parents, 0.05, seeds[[6, 2]], pidx[[6, 2]])
    assert torch.equal(some, whole[[6, 2]])
    fits = []
    for chunk in (1, 3, 8):
        eng.pop_chunk = chunk
        fits.append(eng.eval_generation(parents, 0.05, seeds, pidx,
                                        idx_row)["fitness"])
    assert torch.equal(fits[0], fits[1]) and torch.equal(fits[0], fits[2])
    assert fits[0][1] == fits[0][5]
    alone = eng.task.rollout(whole[[5]], idx_row)["fitness"]
    assert torch.equal(alone[0], fits[0][5])


@pytest.mark.parametrize("pop_chunk,n_keep", [(1, 3), (3, 1), (3, 7),
                                              (8, 3)])
def test_kept_children_are_the_stable_order(coco, pop_chunk, n_keep):
    """The fused generation keeps its winners from the sweep: with tied
    fitness (three values), its selected rows are materialize's rebuild of
    ``argsort(-fitness, stable)[:n_keep]``, bit for bit, its candidates
    their prefix, for any chunk size."""
    eng = _port_engine(coco, pop_chunk)
    eng.task.rollout = lambda th, idx, consts=None, lanes=None: {
        "fitness": torch.floor(th[:, 7] * 300.0) % 3.0}
    eng.task.validate_device = lambda th, vc: th.abs().mean()
    parents, seeds, pidx, idx_row = _population(eng.dim, n_off=8)
    fitness, selected, cands, cscores = eng._gen_core(
        parents, 0.05, seeds, pidx, idx_row, None, None, n_keep, 2)
    f = fitness.numpy()
    assert len(set(f.tolist())) < len(f)  # ties
    order = np.argsort(-f, kind="stable")[:n_keep]
    assert torch.equal(selected, eng.materialize(parents, 0.05, seeds[order],
                                                 pidx[order]))
    assert torch.equal(cands, selected[:2])
    assert torch.equal(cscores, torch.stack([c.abs().mean() for c in cands]))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rollout_layout_equals_stacked_prepare_decode_params(coco, dt):
    """The torch-order rollout lays children out with the exact to_dec, a
    chunk at once: the kernels' operands equal prepare_decode_params of
    each child tensor for tensor, so the tokens are the same."""
    from nes_img_captioning_tpu_torch.ops.decode_cuda import (
        decode_fused,
        prepare_decode_params,
    )

    eng = _port_engine(coco, 3)
    task, lay = eng.task, eng.task.decode_layout
    parents, seeds, pidx, idx_row = _population(eng.dim)
    kids = eng.materialize(parents, 0.05, seeds, pidx)
    batched = lay.prep(lay.to_dec(kids), dt)
    each = [prepare_decode_params(task.spec, k, task.model.options, dtype=dt)
            for k in kids]
    for name, t in batched.items():
        assert torch.equal(t, torch.stack([e[name] for e in each])), name
    for i, k in enumerate(kids):
        assert torch.equal(lay.to_dec(kids)[i], lay.to_dec(k))
    feats = task.train_fc[torch.as_tensor(idx_row)]
    seq_b, _ = decode_fused(batched, feats.expand(len(kids), -1, -1))
    for i, e in enumerate(each):
        assert torch.equal(seq_b[i], decode_fused(e, feats)[0])

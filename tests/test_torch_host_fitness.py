"""Port parity for host-scored fitness and the eager decoder's generations:
``CocoTask.host_fitness`` and ``_score_dedup``, NESEngine's
``eval_generation`` / ``update`` and the torch-order generation, a plain
NIC-ES sweep scored on the host, and the gates of ``tpu.fused_decode`` and
``tpu.device_cider``, against the JAX package on the CPU at toy size (vocab
30, E = R = 16, 32-d features, 3 pairs, batch 4), f32.

torch cannot reproduce JAX's noise, so the port is handed JAX's realized
deltas (``NESEngine.delta_of``, ``ESEngine.normal_of``) and, for the
sampling kinds, the Gumbel values JAX's ``jax.random.categorical`` adds at
each step (``NESEngine.gumbel_of``). The JAX side decodes with XLA (its
fused kernel is TPU-only). Fitnesses within 1e-5, theta within 1e-6 after
an SGD step (Adam's first step is ill-conditioned at this size, ROADMAP
§3).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from test_torch_es import es_exp, jax_master, jax_randomness, torch_master

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_PAIRS, B, SIGMA, STEP, L2 = 3, 4, 0.05, 0.5, 1e-7
KINDS = ["greedy", "sample", "self_critical", "sc_loss", "greedy_logprob",
         "greedy_expprob", "greedy_linprob", "greedy_avgprob"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_host")
    return make_synthetic_coco(str(d), n_train=16, n_val=6, n_test=4,
                               vocab_size=30, fc_feat_size=32, cap_len=6,
                               seed=0)


def _exp(copts, fitness="greedy", popts=None, mopts=None, **tpu):
    return {"dataset": "mscoco", "caption_options": dict(copts),
            "policy_options": {"fitness": fitness, **(popts or {}),
                               "model_options": {
                                   "input_encoding_size": 16, "rnn_size": 16,
                                   "fc_feat_size": 32, **(mopts or {})}},
            "tpu": {"seed": 0, "precision": "f32", **tpu}}


def _tasks(exp):
    """(JAX CocoTask, the port's CocoTask on the CPU) of one experiment."""
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    return (JTask(exp, JConfig(batch_size=B), jp(exp)),
            CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                     device="cpu"))


def _artifacts(task, lead, rows, rng):
    """Token artifacts with leading axes ``lead``: captions drawn from a
    small pool (so rows repeat, as they do across nearby thetas), each
    ending in EOS 0 at a random place; logprobs in (-3, 0)."""
    V, T = task.data.vocab_size, task.model.options.seq_length
    pool = rng.integers(1, V + 1, size=(7, T))
    pool[np.arange(7), rng.integers(2, T, size=7)] = 0
    pool = np.where(np.cumsum(pool == 0, axis=1) > 0, 0, pool)
    R = rows * (1 if task.fitness_kind in
                ("greedy", "greedy_logprob", "greedy_expprob",
                 "greedy_linprob", "greedy_avgprob") else task.seq_per_img)
    art = {"seq": pool[rng.integers(0, 7, size=(*lead, R))].astype(np.int16)}
    if task.fitness_kind in ("self_critical", "sc_loss"):
        art["greedy_seq"] = pool[rng.integers(0, 7, size=(*lead, rows))
                                 ].astype(np.int16)
    if task.need_logprobs:
        art["logprob"] = -3 * rng.random((*lead, R, T)).astype(np.float32)
    return art


@pytest.mark.parametrize("layout", ["nes_pairs", "es_batch"])
@pytest.mark.parametrize("kind", KINDS)
def test_host_fitness_matches_jax(coco, kind, layout):
    """Every fitness kind scores the same token artifacts as the JAX
    package: NES's (F, 2) members with idx (F, B), member m on row m // 2,
    and NIC-ES's (L,) members sharing one (B,) batch; within 1e-5."""
    jtask, ttask = _tasks(_exp(coco, kind, device_cider=False))
    assert not ttask.fitness_on_device and not jtask.fitness_on_device
    rng = np.random.default_rng(KINDS.index(kind))
    if layout == "nes_pairs":
        lead, idx = (F_PAIRS, 2), rng.integers(0, 16, size=(F_PAIRS, B))
    else:
        lead, idx = (5,), rng.integers(0, 16, size=B)
    art = _artifacts(ttask, lead, B, rng)
    want = np.asarray(jtask.host_fitness(
        {k: jnp.asarray(v) for k, v in art.items()}, idx))
    got = ttask.host_fitness({k: torch.from_numpy(v) for k, v in art.items()},
                             idx)
    assert got.shape == want.shape == lead and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.ptp(got) > 0


@pytest.mark.parametrize("repeats", [True, False], ids=["dedup", "distinct"])
def test_score_dedup_equals_scoring_every_row(coco, repeats):
    """``_score_dedup`` gives each row the score of scoring every row, bit
    for bit: with repeated rows through the indirection (fewer rows
    scored), with distinct ones without it."""
    _, ttask = _tasks(_exp(coco, "greedy", device_cider=False))
    rng = np.random.default_rng(3)
    T = ttask.model.options.seq_length
    cands = rng.integers(0, 31, size=(40, T))
    img = rng.integers(0, 16, size=40)
    if repeats:  # 6 captions of one image
        cands, img = cands[rng.integers(0, 6, size=40)], np.full(40, 3)
    got = ttask._score_dedup(cands, img)
    want = ttask.train_scorer.score(cands, img)[1]
    assert np.array_equal(got, want)
    scored, rows = ttask.dedup_rows
    assert rows == 40 and (scored < 0.9 * rows) is repeats


def _jax_gumbel(jeng, seed, sign, T, B, spi, Vpad, V1):
    """The Gumbel values JAX's eager decoder adds at each step for member
    (seed, sign): ``fold_in(key(seed), 1 or 2)`` split into T step keys
    (nes.py:206-214, fc_caption.py:196-210), laid out as K3's host table
    (spi, T, B, Vpad) (image-major rows b * spi + i; pad columns 0)."""
    key = jax.random.fold_in(jeng._mk_key(jnp.uint32(seed)),
                             1 if sign > 0 else 2)
    g = np.stack([np.asarray(jax.random.gumbel(k, (B * spi, V1)))
                  for k in jax.random.split(key, T)])
    g = g.reshape(T, B, spi, V1).transpose(2, 0, 1, 3)
    return np.pad(g, ((0, 0),) * 3 + ((0, Vpad - V1),))


NES_CASES = {
    # host scoring on the kernels' (plain twins') decode
    "host_greedy": ("greedy", {}, {}, {"device_cider": False}),
    "host_self_critical": ("self_critical", {}, {}, {"device_cider": False}),
    # the eager decoder: host-scored and device-scored (torch order)
    "eager_vbn_host": ("greedy", {"vbn": True}, {}, {"device_cider": False}),
    "eager_vbn": ("greedy", {"vbn": True}, {}, {}),
    "eager_layer_n_sample": ("sample", {}, {"layer_n": True}, {}),
}


@pytest.mark.parametrize("case", list(NES_CASES))
def test_nes_generation_matches_jax(coco, case):
    """One NES generation handed JAX's deltas (and Gumbel values): the
    host-scored split (eval_generation, host_fitness, update with the
    carried deltas) or the device-scored torch-order generation, against
    JAX's eval_generation, host_fitness and update: fitnesses within 1e-5,
    theta after the SGD step within 1e-6."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JEngine
    from nes_img_captioning_tpu.algorithms.optimizers import SGD as JSGD
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import SGD
    from nes_img_captioning_tpu_torch.ops.decode_cuda import pad_vocab
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    kind, popts, mopts, tpu = NES_CASES[case]
    jtask, ttask = _tasks(_exp(coco, kind, popts, mopts, **tpu))
    assert ttask._fused is (case.startswith("host")) and not jtask._fused
    assert ttask.fitness_on_device is jtask.fitness_on_device
    jeng = JEngine(jtask, JSGD(STEP), JKind.DEFAULT, pop_chunk=2)
    rng = np.random.default_rng(len(case))
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 16, size=(F_PAIRS, B)).astype(np.int32)
    theta = np.asarray(jtask.generate_theta(jax.random.PRNGKey(6)))
    sens = jnp.ones((jeng.dim,), jnp.float32)
    art, deltas = jeng.eval_generation(jnp.asarray(theta), sens, SIGMA,
                                       seeds, idx)
    want_fit = np.asarray(jtask.host_fitness(art, idx))
    _, want_theta, _ = jeng.update(
        jnp.asarray(theta), jeng.optimizer.init(jeng.dim), sens, SIGMA,
        seeds, want_fit, STEP, L2, deltas=deltas)

    eng = NESEngine(ttask, SGD(STEP), MutationKind.DEFAULT, pop_chunk=2)
    by_seed = dict(zip(seeds.tolist(), torch.from_numpy(np.asarray(
        deltas).reshape(-1, jeng.dim)[:F_PAIRS].copy())))
    eng.delta_of = lambda scale, seed: by_seed[int(seed)]
    T, spi = ttask.model.options.seq_length, ttask.seq_per_img
    V1 = ttask.data.vocab_size + 1
    eng.gumbel_of = lambda ss, sign: torch.from_numpy(np.stack([
        _jax_gumbel(jeng, s, sign, T, B, spi, pad_vocab(V1), V1)
        for s in ss]).astype(np.float32))
    th = torch.from_numpy(theta.copy())
    state = eng.optimizer.init(eng.dim, "cpu")
    if ttask.fitness_on_device:
        th_new, _, packed = eng.generation(th, state, torch.ones_like(th),
                                           SIGMA, seeds, idx, STEP, L2)
        fit = eng.unpack(packed, F_PAIRS)[0]
    else:
        art_t, carried = eng.eval_generation(th, torch.ones_like(th), SIGMA,
                                             seeds, idx)
        assert art_t["seq"].shape[:2] == (F_PAIRS, 2)
        assert art_t["seq"].dtype == torch.int16
        fit = ttask.host_fitness(art_t, idx)
        _, th_new, _ = eng.update(th, state, torch.ones_like(th), SIGMA,
                                  seeds, fit, STEP, L2, deltas=carried)
    np.testing.assert_allclose(fit, want_fit, rtol=0, atol=1e-5)
    assert np.ptp(fit) > 0
    np.testing.assert_allclose(th_new.numpy(), np.asarray(want_theta),
                               rtol=0, atol=1e-6)
    assert not torch.equal(th_new, th)


@pytest.mark.parametrize("pop_chunk", [2, 0])
def test_carried_and_regenerated_updates_bitwise_equal(coco, pop_chunk):
    """update(deltas=carried) and update() drawing the deltas again from
    the seeds sum the same terms in the same order: the same theta and
    ratio, bit for bit; past DELTA_BYTES_LIMIT nothing is carried."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    _, ttask = _tasks(_exp(coco, "greedy", device_cider=False))
    eng = NESEngine(ttask, Adam(0.01), MutationKind.DEFAULT,
                    pop_chunk=pop_chunk)
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 16, size=(F_PAIRS, B))
    th = ttask.generate_theta(torch.Generator().manual_seed(2))
    sens = torch.ones_like(th)
    art, carried = eng.eval_generation(th, sens, SIGMA, seeds, idx)
    n_chunks, chunk = eng._plan(F_PAIRS)
    assert carried.shape == (n_chunks, chunk, eng.dim)
    fit = ttask.host_fitness(art, idx)
    outs = [eng.update(th, eng.optimizer.init(eng.dim, "cpu"), sens, SIGMA,
                       seeds, fit, 0.01, L2, deltas=d)
            for d in (carried, None)]
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])
    assert not torch.equal(outs[0][1], th)
    eng.DELTA_BYTES_LIMIT = 0
    assert eng.eval_generation(th, sens, SIGMA, seeds, idx)[1] is None


def test_es_plain_generation_host_scored_matches_jax(coco, tmp_path,
                                                     monkeypatch):
    """A NIC-ES sweep of 8 children of 5 parents scored on the host,
    handed JAX's noise: the same tokens as JAX's sweep and its host
    fitnesses within 1e-5; the fused path resolves off."""
    exp = es_exp(coco, tmp_path / "jax", mutation="", device_cider=False)
    exp["policy_options"]["model_options"]["fc_feat_size"] = 32
    jm = jax_master(exp)
    exp["log_dir"] = str(tmp_path / "torch")
    jax_randomness(monkeypatch, jm)
    tm = torch_master(exp)
    assert not tm.task.fitness_on_device and not tm._fused_capable()
    rng = np.random.default_rng(2)
    parents = np.stack([2.0 * np.asarray(jm.task.generate_theta(
        jax.random.PRNGKey(i))) for i in range(5)])
    seeds = rng.integers(0, 2**32, size=8, dtype=np.uint32)
    pidx = rng.integers(0, 5, size=8).astype(np.int32)
    idx_row = rng.choice(jm.task.train_n, size=8, replace=False)
    jart = jm.engine.eval_generation(
        jnp.asarray(parents), jnp.ones((1, jm.engine.dim)), 0.05, seeds,
        pidx, idx_row)
    want = np.asarray(jm.task.host_fitness(jart, idx_row))
    art = tm.engine.eval_generation(torch.from_numpy(parents), 0.05, seeds,
                                    pidx, idx_row)
    assert art["seq"].shape[0] == 8
    np.testing.assert_array_equal(art["seq"].numpy(),
                                  np.asarray(jart["seq"]))
    got = tm.task.host_fitness(art, idx_row)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.ptp(got) > 0


@pytest.mark.parametrize("algo", ["nes", "es"])
def test_cli_trains_host_scored(coco, tmp_path, algo):
    """``main.py master --device cpu`` trains experiments/mscoco_nes.json
    and mscoco_es.json with ``tpu.device_cider: false`` (cut to toy size)
    for 3 iterations, each validated, and leaves a snapshot."""
    with open(os.path.join(REPO, "experiments", f"mscoco_{algo}.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=B, val_batch_size=4, num_val_items=6,
                         snapshot_freq=3)
    exp["policy_options"]["model_options"].update(
        input_encoding_size=16, rnn_size=16, fc_feat_size=32,
        safe_mutation_underflow=0.01)
    exp.update(nb_offspring=4 if algo == "nes" else 8, caption_options=coco,
               log_dir=str(tmp_path / "run"))
    if algo == "es":
        exp.update(population_size=4, num_elites=1, num_elite_cands=2)
    exp["tpu"].update(pop_chunk=3, precision="f32", device_cider=False)
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    out = subprocess.run(
        [sys.executable, "-m", "nes_img_captioning_tpu_torch.main", "master",
         "--exp_file", str(path), "--max_iterations", "3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import glob

    (zinfo,) = glob.glob(str(tmp_path / "run" / "snapshot" / "z_info_*"))
    with open(zinfo) as f:
        infos = json.load(f)
    assert infos["iter"] == 3 and len(infos["acc_stats"]) == 3
    assert np.isfinite(infos["score_stats"][1]).all()


GATES = {
    # (model options, tpu, card?) -> (fused, device-scored, layout?); fused
    # None: "auto" and true raise
    "norm_auto": ({"vbn_e": True}, {}, False, (False, True, False)),
    "host_auto": ({}, {"device_cider": False}, False, (True, False, False)),
    "fused_off": ({}, {"fused_decode": False}, False, (False, True, False)),
    "plain_auto": ({}, {}, False, (True, True, True)),
    "card_e16_auto": ({}, {}, True, (True, True, True)),
}


@pytest.mark.parametrize("case", list(GATES))
def test_gates_resolve_as_jax(coco, case, monkeypatch):
    """``tpu.fused_decode`` and ``tpu.device_cider`` resolve as the JAX
    package's on what both can run: "auto" decodes a norm variant eagerly
    (JAX: not fused) and scores on the device; the decode layout exists
    only when fused and device-scored. On the card a no-norm model of a
    width no library is built for (E = 16 here) takes the kernels under
    "auto" and true, zero-padded to E = R = 128, as JAX runs its kernels at
    any width, and so does one of 513 cells (padded to 1024); above 1024
    it is refused; false decodes it eagerly."""
    from nes_img_captioning_tpu_torch.tasks.captioning import resolve_fused

    mopts, tpu, card, (fused, on_dev, layout) = GATES[case]
    jtask, ttask = _tasks(_exp(coco, "greedy", mopts=mopts, **tpu))
    if card:
        monkeypatch.setattr(ttask, "device", torch.device("cuda"))
        for want in ("auto", True):
            assert ttask._resolve_fused(want) is fused
        assert ttask._resolve_fused(False) is False
        wide = dataclasses.replace(ttask.model.options, rnn_size=513)
        assert resolve_fused(wide, "auto", torch.device("cuda")) is True
        for cells in (1025, 2048):
            wide = dataclasses.replace(ttask.model.options, rnn_size=cells)
            with pytest.raises(ValueError, match="E and R up to 1024"):
                resolve_fused(wide, "auto", torch.device("cuda"))
        return
    assert ttask._fused is fused
    assert ttask.fitness_on_device is on_dev is jtask.fitness_on_device
    assert (ttask.decode_layout is not None) is layout
    if mopts:
        assert jtask._fused is False
        assert jtask.model.spec.names == ttask.spec.names


def test_explicit_true_refusals(coco, tmp_path):
    """Explicit true where the port cannot honour it raises, where the JAX
    package goes on quietly: ``fused_decode: true`` with a norm variant
    (JAX's fused path would drop the norm leaves and decode another
    model), and ``device_cider: true`` at vocab 16384 (V + 1 past the
    device scorer's 14-bit tokens; "auto" scores on the host, as JAX
    does, and the eager decode runs there)."""
    with pytest.raises(ValueError, match="no-norm"):
        _tasks(_exp(coco, "greedy", {"vbn": True}, fused_decode=True))
    big = make_synthetic_coco(str(tmp_path / "big"), n_train=8, n_val=4,
                              n_test=2, vocab_size=16384, fc_feat_size=32,
                              cap_len=4, seed=1)
    exp = _exp(big, "greedy", mopts={"input_encoding_size": 8,
                                     "rnn_size": 8}, fused_decode=False)
    jtask, ttask = _tasks(exp)
    assert not ttask.fitness_on_device and not jtask.fitness_on_device
    assert ttask.decode_layout is None
    theta = np.asarray(jtask.generate_theta(jax.random.PRNGKey(0)))
    art = ttask.rollout(torch.from_numpy(theta.copy())[None],
                        np.arange(4))
    assert set(art) == {"seq"} and art["seq"].dtype == torch.int16
    assert ttask.host_fitness(art, np.arange(4)).shape == (1,)
    exp["tpu"]["device_cider"] = True
    with pytest.raises(ValueError, match="device_cider=true"):
        _tasks(exp)

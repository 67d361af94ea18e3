"""Port parity for the sampled, self-critical and per-token fitness kinds and
the vocab-tiled decode: the plain versions of K3 (Gumbel-max sampling
decode) and K4 (vocab-tiled greedy decode), the sampling stream,
``CocoTask.rollout_dec`` for all eight kinds, whole generations and the
command line, at toy size (vocab 40, E = R = 16, 24-d features, B = 4).

torch cannot reproduce JAX's sampling streams (``fold_in``/``bits`` keys,
``jax.random.gumbel`` tables in interpret mode), so the tests compute JAX's
lane seeds and Gumbel tables with JAX, as ``CocoTask._sample_decode_kwargs``
does (``captioning.py:241-256``), and hand them to the port's K3 through its
host-table form; the JAX Pallas kernels run in interpret mode.
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

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu.models.fc_caption import (
    FCCaptionModel as JaxFCModel,
    FCModelOptions as JaxOptions,
)
from nes_img_captioning_tpu.ops import decode_pallas as jdp
from nes_img_captioning_tpu_torch.models.fc_caption import (
    FCModelOptions,
    build_spec,
)
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.noise import gumbel_plain, lane_seeds

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("greedy", "sample", "self_critical", "sc_loss", "greedy_logprob",
         "greedy_expprob", "greedy_linprob", "greedy_avgprob")
# as tests/test_torch_kernel_noise.py: theta is compared within 1e-6 only
# where every element's -grad/2F + l2*theta is at least GLOBALG_MIN
F_PAIRS, B, SIGMA, STEP, L2 = 4, 4, 0.05, 0.01, 1e-7
GLOBALG_MIN = 3e-6


def _setup(vocab, feat, enc, seed=3):
    jm = JaxFCModel(JaxOptions(vocab_size=vocab, fc_feat_size=feat,
                               input_encoding_size=enc, rnn_size=enc))
    theta = np.array(jm.spec.init_theta(jax.random.PRNGKey(seed)))
    topts = FCModelOptions(vocab_size=vocab, fc_feat_size=feat,
                           input_encoding_size=enc, rnn_size=enc)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options)
    tp = tdc.prepare_decode_params(build_spec(topts), torch.from_numpy(theta),
                                   topts)
    return jp, tp


# ---- the sampling stream ---------------------------------------------------


def test_gumbel_stream_statistics():
    """2^20 draws: mean within 0.01 of Euler's constant, variance within
    0.02 of pi^2/6; Gumbel-max over a fixed 5-way softmax picks each class
    at its probability (chi-square, 4 degrees of freedom, below its 99.9%
    point 18.47); lane seeds differ across members, signs and lanes."""
    g = gumbel_plain(torch.arange(4) + 1000, 2, 256, 1024).double()
    assert g.numel() == 1 << 20
    assert abs(float(g.mean()) - 0.5772156649) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.02
    p = np.array([0.4, 0.25, 0.2, 0.1, 0.05])
    draws = gumbel_plain(torch.arange(64) + 7, 0, 4096, 8)[..., :5]
    pick = (torch.log(torch.from_numpy(p)).float() + draws).argmax(-1)
    n = pick.numel()
    obs = np.bincount(pick.reshape(-1).numpy(), minlength=5)
    assert float(((obs - n * p) ** 2 / (n * p)).sum()) < 18.47
    seeds = np.array([5, 6, 0xFFFFFFFF], np.uint32)
    lanes = np.concatenate([lane_seeds(seeds, np.full(3, s), 5)
                            for s in (1, -1)])
    assert lanes.shape == (6, 5) and lanes.dtype == np.uint32
    assert len(np.unique(lanes)) == lanes.size
    assert np.array_equal(lane_seeds(seeds[1:], [1, 1], 5), lanes[1:3])


# ---- K3 and K4, plain, against the Pallas kernels in interpret mode ---------


@pytest.mark.parametrize("need_lp", [True, False])
def test_plain_k3_matches_jax_host_table(need_lp):
    """decode_fused(greedy=False, gumbel=g) on CPU tensors (plain K3)
    against JAX decode_fused(greedy=False, host_rng=True, gumbel=g,
    interpret=True), f32: tokens equal, lp within 2e-5; the lanes of a batch
    of members equal the members decoded one lane at a time; no launch is
    counted."""
    jp, tp = _setup(40, 24, 16)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(B, 24)).astype(np.float32)
    tables = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3),
                                          (2, 16, B, 128)))
    before = tdc.decode_sample.launches
    seq_t, lp_t = tdc.decode_fused(
        {k: torch.stack([v, v]) for k, v in tp.items()},
        torch.from_numpy(feats), need_logprobs=need_lp, greedy=False,
        gumbel=torch.from_numpy(np.stack([tables, tables[::-1].copy()])))
    assert tdc.decode_sample.launches == before
    assert seq_t.shape == (2, 2, B, 16)
    for lane in range(2):
        seq_j, lp_j = jdp.decode_fused(
            jp, jnp.asarray(feats), greedy=False, host_rng=True,
            gumbel=jnp.asarray(tables[lane]), interpret=True,
            need_logprobs=need_lp)
        np.testing.assert_array_equal(seq_t[0, lane].numpy(),
                                      np.asarray(seq_j))
        np.testing.assert_allclose(lp_t[0, lane].numpy(), np.asarray(lp_j),
                                   atol=2e-5)
        assert torch.equal(seq_t[1, 1 - lane], seq_t[0, lane])
    greedy, _ = tdc.decode_fused(tp, torch.from_numpy(feats))
    assert not torch.equal(seq_t[0, 0], greedy)  # it samples
    if not need_lp:
        assert not lp_t.any()
    with pytest.raises(ValueError, match="exactly one"):
        tdc.decode_fused(tp, torch.from_numpy(feats), greedy=False)


def test_plain_k3_seeded_stream_and_pads():
    """The seed form draws the stream of ops/noise.py: equal to the table
    form fed gumbel_plain's values; a member's lanes differ; huge noise
    never picks a pad column."""
    _, tp = _setup(40, 24, 16)
    feats = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 24)).astype(np.float32))
    seeds = np.array([9, 0xFFFFFFFF, 3], np.uint32)
    seq_s, lp_s = tdc.decode_fused(tp, feats, greedy=False, seeds=seeds)
    table = torch.stack([torch.stack([gumbel_plain(torch.tensor(int(s)), t,
                                                   B, 128)
                                      for t in range(16)]) for s in seeds])
    seq_g, lp_g = tdc.decode_fused(tp, feats, greedy=False, gumbel=table)
    assert torch.equal(seq_s, seq_g) and torch.equal(lp_s, lp_g)
    assert not torch.equal(seq_s[0], seq_s[1])
    seq_h, _ = tdc.decode_fused(tp, feats, greedy=False, gumbel=table * 50)
    assert int(seq_h.max()) <= 40


@pytest.mark.parametrize("tile", [128, 256])
def test_plain_k4_matches_jax(tile):
    """decode_fused(vocab_tile=...) on CPU tensors (plain K4), vocab 700
    (Vpad 768, 6 or 3 tiles), f32, against JAX decode_fused(vocab_tile=...,
    interpret=True): tokens equal, and equal to K1's; lp within 2e-5. An
    invalid tile raises ValueError."""
    jp, tp = _setup(700, 32, 16, seed=4)
    feats = np.random.default_rng(5).normal(size=(B, 32)).astype(np.float32)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), interpret=True,
                                   vocab_tile=tile)
    before = tdc.decode_tiled.launches
    seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats),
                                   vocab_tile=tile)
    assert tdc.decode_tiled.launches == before
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=2e-5)
    seq_1, lp_1 = tdc.decode_fused(tp, torch.from_numpy(feats))
    assert torch.equal(seq_t, seq_1)
    np.testing.assert_allclose(lp_t.numpy(), lp_1.numpy(), atol=2e-5)
    for bad, kw in ((512, {}), (64, {}), (tile, {"greedy": False,
                                                 "seeds": [1]})):
        with pytest.raises(ValueError, match="vocab_tile"):
            tdc.decode_fused(tp, torch.from_numpy(feats), vocab_tile=bad,
                             **kw)


# ---- the task and the engine -----------------------------------------------


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_sampling")
    return make_synthetic_coco(str(d), n_train=12, n_val=4, n_test=4,
                               vocab_size=40, fc_feat_size=24, cap_len=6,
                               seed=0)


def _exp(copts, kind, **tpu):
    return {
        "dataset": "mscoco",
        "caption_options": copts,
        "policy_options": {"fitness": kind, "model_options": {
            "input_encoding_size": 16, "rnn_size": 16, "fc_feat_size": 24,
        }},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32", **tpu},
    }


def _jax_task(copts, kind, **tpu):
    from nes_img_captioning_tpu.tasks.captioning import CocoTask
    from nes_img_captioning_tpu.utils.config import Config, parse_tpu_config

    exp = _exp(copts, kind, **tpu)
    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp))
    task._fused_interpret = True
    return task


def _port_task(copts, kind, **tpu):
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = _exp(copts, kind, **tpu)
    return CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu")


def _jax_tables(jtask, key, rows):
    """JAX's Gumbel tables of the seq_per_img lanes of member key ``key``:
    the lane seeds of rollout_dec (captioning.py:441-443) and the tables of
    _sample_decode_kwargs in interpret mode. (spi, T, rows, Vpad)."""
    seeds = jax.vmap(lambda i: jax.random.bits(jax.random.fold_in(key, i)))(
        jnp.arange(jtask.seq_per_img))
    return np.stack([np.asarray(jtask._sample_decode_kwargs(s, rows)["gumbel"])
                     for s in seeds])


def test_pair_kernel_gate_and_vocab_tile_knob(coco):
    """The pair kernel serves only greedy kinds and the untiled decode, as
    in the JAX package (captioning.py:321-334); decode_vocab_tile is read
    and validated when the task is built."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    for kind, tile, want in (("sample", 0, False), ("greedy", 128, False),
                             ("self_critical", 0, False),
                             ("greedy_logprob", 0, True)):
        task = _port_task(coco, kind, decode_vocab_tile=tile)
        assert task.supports_pair_perturb is want, (kind, tile)
        assert task.supports_kernel_noise is want
        eng = NESEngine(task, Adam(STEP), MutationKind.DEFAULT,
                        kernel_noise=True)
        assert eng._kernel_perturb is want and eng._kernel_noise is want
        assert task.need_logprobs is (kind == "greedy_logprob")
    for bad in (64, 256):
        with pytest.raises(ValueError, match="decode_vocab_tile"):
            _port_task(coco, "greedy", decode_vocab_tile=bad)
    with pytest.raises(ValueError, match="unknown fitness"):
        _port_task(coco, "beam")


# batches and seeds (by their numpy seed) that keep the step well-conditioned
@pytest.mark.parametrize("kind,data_seed", [("sample", 9),
                                            ("self_critical", 26),
                                            ("greedy_logprob", 9)])
def test_generation_matches_jax(coco, kind, data_seed):
    """One whole generation of the port's NESEngine against the JAX
    engine's eval_generation + update(deltas=...), fed JAX's deltas (the
    delta_of patch) and JAX's Gumbel tables (the gumbel_of patch):
    fitnesses within 1e-5; theta within 1e-6 where the step is
    well-conditioned (GLOBALG_MIN), ratio and mean|theta| within 1e-6
    relative. The sampling kinds run the per-member path (K3), greedy_logprob
    the pair kernel with logprobs (K2)."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JaxEngine
    from nes_img_captioning_tpu.algorithms.optimizers import Adam as JaxAdam
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JaxKind
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    jtask = _jax_task(coco, kind)
    jeng = JaxEngine(jtask, JaxAdam(STEP), JaxKind.DEFAULT, pop_chunk=2)
    rng = np.random.default_rng(data_seed)
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 12, size=(F_PAIRS, B)).astype(np.int32)
    theta = jtask.generate_theta(jax.random.PRNGKey(6))
    sens = jnp.ones((jeng.dim,), jnp.float32)
    art, deltas = jeng.eval_generation(theta, sens, SIGMA, seeds, idx)
    jfits = jtask.host_fitness(art, idx)
    deltas = np.asarray(deltas).reshape(-1, jeng.dim)[:F_PAIRS]
    _, theta_new, jratio = jeng.update(
        theta, jeng.optimizer.init(jeng.dim), sens, SIGMA, seeds, jfits,
        STEP, L2, deltas=jnp.asarray(deltas[None]))

    ttask = _port_task(coco, kind)
    eng = NESEngine(ttask, Adam(STEP), MutationKind.DEFAULT, pop_chunk=2)
    assert eng._kernel_perturb is (kind == "greedy_logprob")
    lay = ttask.decode_layout
    by_seed = {int(s): lay.to_dec(torch.from_numpy(d.copy()), pad_scale=0.0)
               for s, d in zip(seeds, deltas)}
    eng.delta_of = lambda scale_dec, seed: by_seed[int(seed)]

    def gumbel_of(seeds_c, sign):
        keys = [jax.random.fold_in(jeng._mk_key(np.uint32(s)),
                                   1 if sign > 0 else 2) for s in seeds_c]
        return torch.from_numpy(np.stack([_jax_tables(jtask, k, B)
                                          for k in keys]))

    eng.gumbel_of = gumbel_of
    th0 = torch.from_numpy(np.asarray(theta).copy())
    th, _, packed = eng.generation(th0, eng.optimizer.init(eng.dim, "cpu"),
                                   torch.ones_like(th0), SIGMA, seeds, idx,
                                   STEP, L2)
    fits, ratio, norm = eng.unpack(packed, F_PAIRS)
    np.testing.assert_allclose(fits, np.asarray(jfits), atol=1e-5)
    assert np.ptp(fits) > 0
    w = np.asarray(jeng._pair_weights(jnp.asarray(jfits), (1, F_PAIRS)))[0]
    globalg = -(w @ deltas) / (2 * F_PAIRS) + L2 * np.asarray(theta)
    assert np.abs(globalg).min() >= GLOBALG_MIN
    np.testing.assert_allclose(th.numpy(), np.asarray(theta_new), atol=1e-6)
    np.testing.assert_allclose(ratio, float(jratio), rtol=1e-6)
    np.testing.assert_allclose(norm, float(jnp.abs(theta_new).mean()),
                               rtol=1e-6)


def test_sampling_generation_draws_its_own_stream(coco):
    """Without the patch the engine draws each member's lane seeds from
    ops/noise.py: the same seeds give the same generation, other seeds
    another."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    task = _port_task(coco, "self_critical")
    eng = NESEngine(task, Adam(STEP), MutationKind.DEFAULT, pop_chunk=3)
    theta = task.generate_theta(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 12, size=(F_PAIRS, B))

    def run(s):
        return eng.generation(theta, eng.optimizer.init(eng.dim, "cpu"),
                              torch.ones_like(theta), SIGMA, s, idx, STEP,
                              L2)[2]

    a, b, c = run(seeds), run(seeds), run(seeds + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    assert eng.gumbel_of(seeds[:2], -1).shape == (2, task.seq_per_img)


def test_cli_master_self_critical_tiled(coco, tmp_path):
    """``python -m nes_img_captioning_tpu_torch.main master --device cpu``
    trains 2 iterations of a toy self_critical experiment with
    decode_vocab_tile set (K3 samples, K4 baselines and validation)."""
    with open(os.path.join(REPO, "experiments", "mscoco_nes.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=B, val_batch_size=4, num_val_items=4,
                         snapshot_freq=2)
    exp["policy_options"]["fitness"] = "self_critical"
    exp["policy_options"]["model_options"].update(
        input_encoding_size=16, rnn_size=16, fc_feat_size=24)
    exp["nb_offspring"] = F_PAIRS
    exp["caption_options"] = coco
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, "precision": "f32",
                  "decode_vocab_tile": 128}
    exp["log_dir"] = str(tmp_path / "run")
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    out = subprocess.run(
        [sys.executable, "-m", "nes_img_captioning_tpu_torch.main", "master",
         "--exp_file", str(path), "--max_iterations", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    (zinfo,) = glob.glob(str(tmp_path / "run" / "snapshot" / "z_info_*.json"))
    with open(zinfo) as f:
        infos = json.load(f)
    assert infos["iter"] == 2 and len(infos["acc_stats"]) == 2
    assert np.isfinite(np.asarray(infos["score_stats"][1], float)).all()

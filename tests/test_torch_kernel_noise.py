"""Port parity for the in-kernel noise path (tpu.kernel_noise): the plain
versions of K5 (decode_pair_rng), K6 (pair_grad_rng) and K7
(pair_delta_dump) and a whole kernel-noise generation, at toy size.

The JAX kernels K5-K7 draw their noise from the TPU's hardware PRNG, which
has no CPU lowering (``decode_pallas.py:371-374``), and the port's Philox
stream is its own. So the delta the port realizes (plain K7) is handed to
the JAX functions that take a delta operand: ``decode_pair_perturb`` in
interpret mode, ``jnp.einsum`` and ``NESEngine.update(deltas=...)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.noise import (
    TWO_PI_F32,
    philox4x32_10,
    unit_normal_plain,
)

from torch_pin import one_intra_op_thread  # noqa: F401

# l2coeff as in tests/test_torch_generation.py: at 1e-3 the Adam step of a
# toy element is ill-conditioned where -grad/2F cancels l2*theta, and two
# f32 gradient sums in different orders then differ by more than 1e-6. The
# same holds where the gradient itself nearly cancels: Adam's first step
# is then set by its epsilon (1e-8), and an f32 rounding difference of
# 1e-8 in the sum moves theta by more than 1e-6. The batches and seeds
# below are chosen so that every element's -grad/2F + l2*theta is at least
# GLOBALG_MIN, which the generation test checks before comparing theta.
F_PAIRS, B, SIGMA, STEP, L2 = 4, 4, 0.05, 0.01, 1e-7
GLOBALG_MIN = 3e-6


@pytest.mark.parametrize("ctr,key,want", [
    (0, 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (0xFFFFFFFF, 0xFFFFFFFF,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
], ids=["zeros", "ones"])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10 (every counter
    and key word set to ``ctr`` / ``key``)."""
    c = torch.full((1,), ctr, dtype=torch.int64)
    got = philox4x32_10([c, c, c, c], (key, key))
    assert tuple(int(w) for w in got) == want
    assert np.float32(TWO_PI_F32).view(np.uint32) == 0x40C90FDB


@pytest.fixture(scope="module")
def toy():
    """The JAX task and engine at toy size (vocab 40, E = R = 16, 24-d
    features, 12 train images; fused decode in interpret mode, f32) and the
    port's task on the same data, with one shared theta, seeds and
    batches."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine
    from nes_img_captioning_tpu.algorithms.optimizers import Adam
    from nes_img_captioning_tpu.ops.mutation import MutationKind
    from nes_img_captioning_tpu.tasks.captioning import CocoTask
    from nes_img_captioning_tpu.utils.config import Config, parse_tpu_config
    import tempfile

    from nes_img_captioning_tpu_torch.tasks.captioning import (
        CocoTask as TorchTask,
    )
    from nes_img_captioning_tpu_torch.utils.config import (
        Config as TorchConfig,
        parse_tpu_config as torch_tpu_config,
    )

    d = tempfile.mkdtemp(prefix="kernel_noise_")
    copts = make_synthetic_coco(d, n_train=12, n_val=4, n_test=4,
                                vocab_size=40, fc_feat_size=24, cap_len=6,
                                seed=0)
    exp = {
        "dataset": "mscoco",
        "caption_options": copts,
        "policy_options": {"fitness": "greedy", "model_options": {
            "input_encoding_size": 16, "rnn_size": 16, "fc_feat_size": 24,
        }},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"},
    }
    jtask = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp))
    jtask._fused_interpret = True
    jeng = NESEngine(jtask, Adam(STEP), MutationKind.DEFAULT, pop_chunk=2)
    ttask = TorchTask(exp, TorchConfig(batch_size=B), torch_tpu_config(exp),
                      device="cpu")
    rng = np.random.default_rng(19)
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 12, size=(F_PAIRS, B)).astype(np.int32)
    theta = np.asarray(jtask.generate_theta(jax.random.PRNGKey(6)))
    lay = ttask.decode_layout
    th = torch.from_numpy(theta.copy())
    scale_dec = lay.to_dec(torch.full_like(th, SIGMA), pad_scale=0.0)
    return {"exp": exp, "jtask": jtask, "jeng": jeng, "ttask": ttask,
            "lay": lay, "seeds": seeds, "idx": idx, "theta": theta,
            "scale": lay.prep(scale_dec, torch.float32),
            "base": lay.prep(lay.to_dec(th), torch.float32)}


def test_delta_stream_pads_and_seeds(toy):
    """Pad lanes draw exactly 0; a seed's delta is the same on every call
    and for every batch of seeds it is dumped with; seeds differ."""
    lay, scale, seeds = toy["lay"], toy["scale"], toy["seeds"]
    dump = tdc.pair_delta_dump(scale, seeds)
    flat = lay.flat_dec(dump_at(dump, 0))
    pads = lay.flat_dec(scale) == 0
    assert pads.any() and (flat[pads] == 0).all()
    assert (flat[~pads] != 0).all()
    assert not dump["logit_b"][:, 0, lay.V1:].any()
    again = tdc.pair_delta_dump(scale, seeds[::-1].copy())
    for k in tdc.PAIR_TENSORS:
        assert torch.equal(again[k].flip(0), dump[k])
        assert torch.equal(tdc.pair_delta_dump(scale, int(seeds[1]))[k],
                           dump[k][1])
    assert not torch.equal(lay.flat_dec(dump_at(dump, 0)),
                           lay.flat_dec(dump_at(dump, 1)))


def dump_at(dump: dict, p: int) -> dict:
    return {k: v[p] for k, v in dump.items()}


def test_flat_entries_plain_equal_dict_forms(toy):
    """On CPU tensors the flat entries run the plain versions: K7's (P, dim)
    dump equals pair_delta_dump_plain of each seed, flattened, and a single
    seed gives its row; K6's gradient equals pair_grad_rng_plain,
    flattened; F = 0 gives zeros; anything but a 1-D f32 scale is refused."""
    lay, scale, seeds = toy["lay"], toy["scale"], toy["seeds"]
    flat = lay.flat_dec(scale)
    got = tdc.pair_delta_dump_flat(flat, seeds)
    assert got.shape == (F_PAIRS, lay.dim_dec)
    for p, s in enumerate(seeds):
        assert torch.equal(got[p], lay.flat_dec(
            tdc.pair_delta_dump_plain(scale, int(s))))
    assert torch.equal(tdc.pair_delta_dump_flat(flat, int(seeds[2])), got[2])
    w = torch.tensor([0.5, -1.25, 0.0, 2.0])
    assert torch.equal(tdc.pair_grad_rng_flat(flat, seeds, w), lay.flat_dec(
        tdc.pair_grad_rng_plain(scale, seeds, w)))
    assert not tdc.pair_grad_rng_flat(flat, [], []).any()
    with pytest.raises(ValueError, match="1-D f32"):
        tdc.pair_delta_dump_flat(flat.double(), seeds)
    with pytest.raises(ValueError, match="weights"):
        tdc.pair_grad_rng_flat(flat, seeds, w[:3])


def test_box_muller_table_is_the_stream():
    """box_muller_table's rows, indexed by a word's top 23 bits, rebuild
    the plain stream's normals: n = sqrt-row[b1 >> 9] * cos-row[b2 >> 9]
    for the words of the first 4096 counters of a seed; its log row is
    log(1 - u) (0 at u = 0, the radius -0 there)."""
    table = tdc.box_muller_table("cpu")
    assert table.shape == (3, 2, 1 << 23)
    assert torch.equal(table[:, 0], table[:, 1])
    assert table[0, 0, 0] == 0 and str(float(table[1, 0, 0])) == "-0.0"
    q = torch.arange(4096)
    z = torch.zeros_like(q)
    words = philox4x32_10([q, z, z, z], (12345, 0))
    n = torch.stack([table[1, 0, words[0] >> 9] * table[2, 0, words[1] >> 9],
                     table[1, 0, words[2] >> 9] * table[2, 0, words[3] >> 9]],
                    -1).reshape(-1)
    assert torch.equal(n, unit_normal_plain(12345, torch.arange(8192)))


def test_unit_normal_moments():
    """2^17 draws of one seed, and the same count over 64 seeds: mean 0,
    variance 1, skewness 0, kurtosis 3, within five standard errors."""
    n = 1 << 17
    one = unit_normal_plain(7, torch.arange(n)).double()
    many = torch.cat([unit_normal_plain(s, torch.arange(n // 64))
                      for s in range(1000, 1064)]).double()
    for x in (one, many):
        m = x.mean()
        v = ((x - m) ** 2).mean()
        z = (x - m) / v.sqrt()
        assert abs(float(m)) < 5 / n ** 0.5
        assert abs(float(v) - 1) < 5 * (2 / n) ** 0.5
        assert abs(float((z ** 3).mean())) < 5 * (6 / n) ** 0.5
        assert abs(float((z ** 4).mean()) - 3) < 5 * (24 / n) ** 0.5


@pytest.mark.parametrize("need_lp", [True, False])
def test_plain_k5_matches_jax_pair_kernel(toy, need_lp):
    """decode_pair_rng on CPU tensors (plain K5), f32, against JAX
    decode_pair_perturb(interpret=True) fed plain K7's delta: tokens equal,
    lp within 2e-5 (the f32 sums run in another order)."""
    from nes_img_captioning_tpu.ops import decode_pallas as jdp

    scale, base, seeds = toy["scale"], toy["base"], toy["seeds"]
    feats = toy["ttask"].train_fc[torch.from_numpy(toy["idx"]).long()]
    seq_t, lp_t = tdc.decode_pair_rng(base, scale, seeds, feats,
                                      need_logprobs=need_lp)
    assert seq_t.shape == (F_PAIRS, 2, B, 16)
    dump = tdc.pair_delta_dump(scale, seeds)
    for p in range(F_PAIRS):
        seq_j, lp_j = jdp.decode_pair_perturb(
            {k: jnp.asarray(v.numpy()) for k, v in base.items()},
            {k: jnp.asarray(v[p].numpy()) for k, v in dump.items()},
            jnp.asarray(feats[p].numpy()), interpret=True,
            need_logprobs=need_lp)
        np.testing.assert_array_equal(seq_t[p].numpy(), np.asarray(seq_j))
        np.testing.assert_allclose(lp_t[p].numpy(), np.asarray(lp_j),
                                   atol=2e-5)
    assert (seq_t[:, 0] != seq_t[:, 1]).any()  # the signs genuinely differ


def test_plain_k6_matches_einsum(toy):
    """pair_grad_rng on CPU tensors (plain K6) against JAX jnp.einsum of
    the same weights and plain K7's deltas, within 1e-6 (the f32 sums run
    in another order)."""
    lay, scale, seeds = toy["lay"], toy["scale"], toy["seeds"]
    w = np.random.default_rng(2).normal(size=F_PAIRS).astype(np.float32)
    got = lay.flat_dec(tdc.pair_grad_rng(scale, seeds, torch.from_numpy(w)))
    dump = tdc.pair_delta_dump(scale, seeds)
    deltas = np.stack([lay.flat_dec(dump_at(dump, p)).numpy()
                       for p in range(F_PAIRS)])
    want = jnp.einsum("f,fd->d", jnp.asarray(w), jnp.asarray(deltas),
                      preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # and bitwise the ordered f32 sum of the dumps
    ordered = torch.zeros(lay.dim_dec)
    for p in range(F_PAIRS):
        ordered = ordered + torch.tensor(w[p]) * torch.from_numpy(deltas[p])
    assert torch.equal(got, ordered)


def _port_engine(toy, kernel_noise):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    return NESEngine(toy["ttask"], Adam(STEP), MutationKind.DEFAULT,
                     pop_chunk=3, kernel_perturb=True,
                     kernel_noise=kernel_noise, delta_dtype="f32")


def _generation(toy, eng):
    theta = torch.from_numpy(toy["theta"].copy())
    return eng.generation(theta, eng.optimizer.init(eng.dim, "cpu"),
                          torch.ones_like(theta), SIGMA, toy["seeds"],
                          toy["idx"], STEP, L2)


def test_kernel_noise_generation_matches_jax(toy):
    """The port's kernel-noise generation (plain K5 and K6) against the JAX
    engine fed the same realized deltas: JAX rollout_pair_dec (interpret
    mode) for the fitnesses, then update(deltas=...). Fitnesses within
    1e-5 (CIDEr-D sums in another order), theta within 1e-6 abs, ratio
    and mean|theta| within 1e-6 relative."""
    eng = _port_engine(toy, True)
    assert eng._kernel_noise
    before = tdc.pair_grad_rng.launches
    th, _, packed = _generation(toy, eng)
    assert tdc.pair_grad_rng.launches == before  # CPU: the plain version
    fits, ratio, norm = eng.unpack(packed, F_PAIRS)

    jtask, jeng, lay = toy["jtask"], toy["jeng"], toy["lay"]
    dump = tdc.pair_delta_dump(toy["scale"], toy["seeds"])
    deltas_dec = [lay.flat_dec(dump_at(dump, p)) for p in range(F_PAIRS)]
    jl = jtask.decode_layout
    theta = jnp.asarray(toy["theta"])
    base = jtask.pair_base_params(jl.to_dec(theta))
    consts = jtask.device_consts()
    jfits = np.stack([np.asarray(jtask.rollout_pair_dec(
        base, jnp.asarray(d.numpy()), jnp.asarray(toy["idx"][p]),
        consts=consts)) for p, d in enumerate(deltas_dec)])
    np.testing.assert_allclose(fits, jfits, atol=1e-5)
    assert np.ptp(fits) > 0
    deltas = np.stack([lay.from_dec(d).numpy() for d in deltas_dec])
    w = np.asarray(jeng._pair_weights(jnp.asarray(jfits), (1, F_PAIRS)))[0]
    globalg = -(w @ deltas) / (2 * F_PAIRS) + L2 * toy["theta"]
    assert np.abs(globalg).min() >= GLOBALG_MIN
    _, theta_new, jratio = jeng.update(
        theta, jeng.optimizer.init(jeng.dim), jnp.ones_like(theta), SIGMA,
        toy["seeds"], jnp.asarray(jfits), STEP, L2,
        deltas=jnp.asarray(deltas[None]))
    np.testing.assert_allclose(th.numpy(), np.asarray(theta_new), atol=1e-6)
    np.testing.assert_allclose(ratio, float(jratio), rtol=1e-6)
    np.testing.assert_allclose(norm, float(jnp.abs(theta_new).mean()),
                               rtol=1e-6)


def test_kernel_noise_and_delta_paths_bitwise_equal(toy):
    """The kernel-noise path and the delta-operand pair-kernel path, the
    latter fed plain K7's f32 deltas: equal packed vectors and theta, bit
    for bit (same tokens; both gradients sum w_i * delta_i in pair order).
    "auto" resolves the knob off, as in the JAX package."""
    assert not _port_engine(toy, "auto")._kernel_noise
    th_n, _, packed_n = _generation(toy, _port_engine(toy, True))
    eng = _port_engine(toy, False)
    lay = toy["lay"]
    eng.delta_of = lambda scale_dec, seed: lay.flat_dec(
        tdc.pair_delta_dump(lay.prep(scale_dec, torch.float32), seed))
    th_d, _, packed_d = _generation(toy, eng)
    assert torch.equal(packed_n, packed_d)
    assert torch.equal(th_n, th_d)

"""Port parity: decode layout helpers and the plain twins of the decode
kernels K1 (decode_fused) and K2 (decode_pair_perturb) against the JAX
package's Pallas kernels, run in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.models.fc_caption import (
    FCCaptionModel as JaxFCModel,
    FCModelOptions as JaxOptions,
)
from nes_img_captioning_tpu.ops import decode_pallas as jdp
from nes_img_captioning_tpu.ops.decode_layout import DecodeLayout as JaxLayout
from nes_img_captioning_tpu_torch.models.fc_caption import (
    FCModelOptions,
    build_spec,
)
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout

from torch_pin import one_intra_op_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    """JAX or torch array -> numpy (bf16 widened to f32, exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.array(x)  # a writable copy
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _setup(vocab, feat, enc, seed=3):
    jm = JaxFCModel(JaxOptions(vocab_size=vocab, fc_feat_size=feat,
                               input_encoding_size=enc, rnn_size=enc))
    theta = np.array(jm.spec.init_theta(jax.random.PRNGKey(seed)))
    topts = FCModelOptions(vocab_size=vocab, fc_feat_size=feat,
                           input_encoding_size=enc, rnn_size=enc)
    return jm, theta, build_spec(topts), topts


def _assert_params_equal(tp, jp):
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prepare_decode_params_matches_jax(dt):
    jm, theta, spec, topts = _setup(50, 32, 16)
    jdt, tdt = DTYPES[dt]
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options,
                                   dtype=jdt)
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts,
                                   dtype=tdt)
    _assert_params_equal(tp, jp)
    assert tp["logit_b"][0, 51:].eq(tdc.NEG).all()
    assert tdc.pad_vocab(9488) == 9600 and tdc.pad_vocab(1) == 128


def test_decode_layout_matches_jax():
    """to_dec (both pad scales), from_dec, flat_dec and prep: exact."""
    jm, theta, spec, topts = _setup(50, 32, 16)
    jl, tl = JaxLayout(jm.spec, jm.options), DecodeLayout(spec, topts)
    assert tl.dim_dec == jl.dim_dec
    th_t = torch.from_numpy(theta)
    for pad_scale in (1.0, 0.0):
        np.testing.assert_array_equal(
            _np(tl.to_dec(th_t, pad_scale)),
            _np(jl.to_dec(jnp.asarray(theta), pad_scale)))
    vec = np.random.default_rng(0).normal(size=tl.dim_dec).astype(np.float32)
    np.testing.assert_array_equal(_np(tl.from_dec(torch.from_numpy(vec))),
                                  _np(jl.from_dec(jnp.asarray(vec))))
    for dt in ("f32", "bf16"):
        jdt, tdt = DTYPES[dt]
        jp = jl.prep(jnp.asarray(vec), jdt)
        tp = tl.prep(torch.from_numpy(vec), tdt)
        _assert_params_equal(tp, jp)
        np.testing.assert_array_equal(_np(tl.flat_dec(tp)),
                                      _np(jl.flat_dec(jp)))
    # prep takes leading member axes
    two = torch.from_numpy(np.stack([vec, 2 * vec]))
    assert torch.equal(tl.prep(two, torch.float32)["embed"][1],
                       tl.prep(two[1], torch.float32)["embed"])
    # the decode layout of theta preps to prepare_decode_params(theta)
    _assert_params_equal(tl.prep(tl.to_dec(th_t), torch.float32),
                         tdc.prepare_decode_params(spec, th_t, topts))


@pytest.mark.parametrize("need_lp", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("vocab,feat,enc", [(50, 32, 16), (130, 64, 32)])
def test_plain_k1_matches_pallas_interpret(vocab, feat, enc, dt, need_lp):
    """decode_fused on CPU tensors (the plain twin) against JAX
    decode_fused(interpret=True): f32 tokens equal and lp within 2e-5; bf16
    tokens equal on these seeds (lp within 1e-3: f32-level differences in h
    can move its bf16 rounding by one ulp)."""
    jm, theta, spec, topts = _setup(vocab, feat, enc)
    jdt, tdt = DTYPES[dt]
    feats = np.random.default_rng(1).normal(size=(8, feat)).astype(np.float32)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options,
                                   dtype=jdt)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), interpret=True,
                                   need_logprobs=need_lp)
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts,
                                   dtype=tdt)
    seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats),
                                   need_logprobs=need_lp)
    assert seq_t.shape == (8, 16) and seq_t.dtype == torch.int32
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j),
                               atol=2e-5 if dt == "f32" else 1e-3)
    if not need_lp:
        assert not lp_t.any()


def test_plain_k1_early_stop_and_batch_of_members():
    """EOS-boosted member: rows stop, later steps stay 0, as in JAX. A batch
    of members in one call equals the members decoded one by one, bit for
    bit at one intra-op thread, because MKL's multi-threaded batched
    product over M members is not batch-invariant
    (``test_torch_threads.py`` holds the 4-thread case)."""
    jm, theta, spec, topts = _setup(40, 16, 8, seed=5)
    boosted = theta.copy()
    boosted[jm.spec.offset("logit.bias")] += 8.0
    feats = np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32)
    seq_j, lp_j = jdp.greedy_decode_fused(
        jdp.prepare_decode_params(jm.spec, jnp.asarray(boosted), jm.options),
        jnp.asarray(feats), interpret=True)
    members = [tdc.prepare_decode_params(spec, torch.from_numpy(t), topts)
               for t in (boosted, theta)]
    batched = {k: torch.stack([m[k] for m in members]) for k in members[0]}
    seq_b, lp_b = tdc.decode_fused(batched, torch.from_numpy(feats))
    np.testing.assert_array_equal(seq_b[0].numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_b[0].numpy(), np.asarray(lp_j), atol=2e-5)
    assert (seq_b[0].numpy()[:, 1:] == 0).all()
    for i, m in enumerate(members):
        s, l = tdc.decode_fused(m, torch.from_numpy(feats))
        assert torch.equal(s, seq_b[i]) and torch.equal(l, lp_b[i])


def test_plain_k1_padded_vocab_never_selected():
    jm, theta, spec, topts = _setup(40, 16, 8, seed=7)
    feats = torch.from_numpy(
        np.random.default_rng(3).normal(size=(6, 16)).astype(np.float32))
    params = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts)
    seq, _ = tdc.decode_fused(params, feats)
    assert int(seq.max()) <= 40


def _pair_inputs(jm, theta, ddt_j, scale=0.05, seed=9):
    lay = JaxLayout(jm.spec, jm.options)
    base_vec = lay.to_dec(jnp.asarray(theta))
    sc = lay.to_dec(jnp.full((jm.spec.num_params,), scale, jnp.float32),
                    pad_scale=0.0)
    delta = (sc * jax.random.normal(jax.random.PRNGKey(seed), (lay.dim_dec,),
                                    jnp.float32)).astype(ddt_j)
    return lay, base_vec, delta


@pytest.mark.parametrize("ddt", ["f32", "bf16"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_k2_matches_pallas_interpret(dt, ddt):
    """decode_pair_perturb's plain twin against JAX decode_pair_perturb
    (interpret): tokens equal, lp within 2e-5 (f32) / 1e-3 (bf16); and
    token-equal to the port's own K1 on prep(base ± delta)."""
    jm, theta, spec, topts = _setup(50, 32, 16)
    jdt, tdt = DTYPES[dt]
    jddt, tddt = DTYPES[ddt]
    lay, base_vec, delta = _pair_inputs(jm, theta, jddt)
    feats = np.random.default_rng(1).normal(size=(8, 32)).astype(np.float32)
    seq_j, lp_j = jdp.decode_pair_perturb(
        lay.prep(base_vec, jnp.float32), lay.prep(delta, delta.dtype),
        jnp.asarray(feats), dtype=jdt, interpret=True, need_logprobs=True)

    tl = DecodeLayout(spec, topts)
    base_t = torch.from_numpy(_np(base_vec))
    delta_t = torch.from_numpy(_np(delta)).to(tddt)
    feats_t = torch.from_numpy(feats)
    seq_t, lp_t = tdc.decode_pair_perturb(
        tl.prep(base_t, torch.float32), tl.prep(delta_t, tddt), feats_t,
        dtype=tdt, need_logprobs=True)
    assert seq_t.shape == (2, 8, 16)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j),
                               atol=2e-5 if dt == "f32" else 1e-3)
    assert not torch.equal(seq_t[0], seq_t[1])
    for s, sign in ((0, 1.0), (1, -1.0)):
        member = base_t + sign * delta_t.float()
        seq1, lp1 = tdc.decode_fused(tl.prep(member, tdt), feats_t)
        assert torch.equal(seq_t[s], seq1)
        assert torch.equal(lp_t[s], lp1)


def test_plain_k2_batch_of_pairs_and_pad_lanes():
    """A (P, ...) delta batch equals the pairs one by one (bit for bit at
    one intra-op thread, because MKL's multi-threaded batched product over
    P pairs is not batch-invariant; ``test_torch_threads.py`` holds the
    4-thread case); huge noise that is zero on pad lanes never selects a
    pad token."""
    jm, theta, spec, topts = _setup(50, 16, 8, seed=0)
    tl = DecodeLayout(spec, topts)
    base = tl.prep(tl.to_dec(torch.from_numpy(theta)), torch.float32)
    sc = tl.to_dec(torch.full((spec.num_params,), 1.0), pad_scale=0.0)
    g = torch.Generator().manual_seed(4)
    deltas = torch.stack([sc * torch.randn(tl.dim_dec, generator=g)
                          for _ in range(3)])
    feats = torch.randn((3, 4, 16), generator=g)
    seq, lp = tdc.decode_pair_perturb(base, tl.prep(deltas, torch.float32),
                                      feats, need_logprobs=True)
    assert seq.shape == (3, 2, 4, 16)
    assert int(seq.max()) <= 50
    for p in range(3):
        s1, l1 = tdc.decode_pair_perturb(
            base, tl.prep(deltas[p], torch.float32), feats[p],
            need_logprobs=True)
        assert torch.equal(seq[p], s1) and torch.equal(lp[p], l1)


def test_wrappers_dispatch_on_the_tensor_device():
    """CPU tensors take the plain twin and count no launch."""
    jm, theta, spec, topts = _setup(40, 16, 8)
    params = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts)
    before = tdc.decode_fused.launches, tdc.decode_pair_perturb.launches
    tdc.decode_fused(params, torch.zeros((2, 16)))
    assert (tdc.decode_fused.launches,
            tdc.decode_pair_perturb.launches) == before


def test_plain_k1_top2_gap_and_chip_smoke_checks():
    """The plain twin's top-2 logit gaps (what chip_smoke.py holds a bf16
    kernel's differing rows to), and the smoke script's near-tie and
    executed-step helpers."""
    import chip_smoke

    jm, theta, spec, topts = _setup(40, 16, 8, seed=5)
    boosted = theta.copy()
    boosted[jm.spec.offset("logit.bias")] += 8.0
    members = [tdc.prepare_decode_params(spec, torch.from_numpy(t), topts)
               for t in (boosted, theta)]
    params = {k: torch.stack([m[k] for m in members]) for k in members[0]}
    feats = torch.from_numpy(
        np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32))
    seq, lp, gap = tdc.decode_fused_plain(params, feats, top2_gap=True)
    seq2, lp2 = tdc.decode_fused_plain(params, feats)
    assert torch.equal(seq, seq2) and torch.equal(lp, lp2)
    assert gap.shape == seq.shape and (gap >= 0).all() and gap[1].gt(0).all()
    steps = chip_smoke.executed_steps(seq, 16)
    assert steps.tolist()[1] == 16 and 1 <= steps.tolist()[0] < 16
    assert not gap[0, :, int(steps[0]):].any()  # skipped steps stay 0

    other = seq.clone()
    other[1, 2, 5:] += 1  # a row that first differs at step 5
    share, n_diff = chip_smoke.check_near_ties(other, seq, gap, "test",
                                               limit=float("inf"))
    assert n_diff == 1 and share == 7 / 8
    with pytest.raises(AssertionError, match="step 5"):
        chip_smoke.check_near_ties(other, seq, gap, "test", limit=0.0)

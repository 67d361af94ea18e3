"""The port's CUDA kernels against their plain twins, on the card.

The file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX, without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Here, without a card, every test skips. ``chip_smoke.py`` holds the kernels
to their twins at full width; these tests cover a small vocab, a short
feature width and a partial batch.
"""

import pytest
import torch

from nes_img_captioning_tpu_torch.models.fc_caption import (
    FCModelOptions,
    build_spec,
)
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout


@pytest.fixture
def small_members():
    """Two members and a delta at E = R = 128 (the kernels' fixed width),
    vocab 300 (padded to 384), 256-d features, 32 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts = FCModelOptions(vocab_size=300, fc_feat_size=256)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator(device="cuda").manual_seed(0)
    theta = lay.spec.init_theta(g) * 3
    feats = torch.randn((2, 32, 256), generator=g, device="cuda")
    members = torch.stack([lay.to_dec(theta), lay.to_dec(theta * 0.5)])
    sc = lay.to_dec(torch.full_like(theta, 0.05), pad_scale=0.0)
    delta = (sc * torch.randn(lay.dim_dec, generator=g, device="cuda")
             ).to(torch.bfloat16)
    return lay, members, feats, delta


@pytest.mark.cuda
@pytest.mark.parametrize("need_lp", [True, False])
def test_k1_f32_matches_plain_twin(small_members, need_lp):
    """f32 weights, TF32 off: tokens equal, lp within 2e-5 (sums in another
    order)."""
    lay, members, feats, _ = small_members
    params = lay.prep(members, torch.float32)
    before = tdc.decode_fused.launches
    seq_k, lp_k = tdc.decode_fused(params, feats, need_logprobs=need_lp)
    seq_p, lp_p = tdc.decode_fused_plain(params, feats,
                                         need_logprobs=need_lp)
    torch.cuda.synchronize()
    assert tdc.decode_fused.launches == before + 1
    assert torch.equal(seq_k, seq_p)
    assert float((lp_k - lp_p).abs().max()) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k2_bitwise_equals_k1_on_perturbed_members(small_members, dt):
    """K2 with a bf16 delta: tokens and lp equal K1's on prep(base ± delta)
    bit for bit."""
    lay, members, feats, delta = small_members
    base = lay.prep(members[0], torch.float32)
    seq2, lp2 = tdc.decode_pair_perturb(
        base, lay.prep(delta, torch.bfloat16), feats[0], dtype=dt,
        need_logprobs=True)
    for s, sign in ((0, 1.0), (1, -1.0)):
        seq1, lp1 = tdc.decode_fused(
            lay.prep(members[0] + sign * delta.float(), dt), feats[0])
        assert torch.equal(seq2[s], seq1) and torch.equal(lp2[s], lp1)


@pytest.mark.cuda
def test_philox_words_match_plain_stream(small_members):
    """The kernels' Philox draws the plain version's words bit for bit,
    known-answer vector included."""
    words = tdc.philox_words(0x12345678, 4096, "cuda")
    assert torch.equal(words.cpu(), tdc.philox_words(0x12345678, 4096, "cpu"))
    assert tdc.philox_words(0, 1, "cuda")[0].tolist() == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.cuda
def test_k7_k5_k6_share_one_noise_stream(small_members):
    """K7's deltas lie within 8 ulps of the plain version's (logf and cosf
    may round differently from torch's), exactly 0 on pad lanes; K5 with
    f32 and bf16 weights is bitwise K2 fed K7's dump; K6 is bitwise the
    ordered f32 sum of the dumps."""
    lay, members, feats, _ = small_members
    theta_dec = members[0]
    sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05, device="cuda"),
                    pad_scale=0.0)
    scale = lay.prep(sc, torch.float32)
    seeds = [3, 0xFFFFFFFF, 12345]
    before = tdc.pair_delta_dump.launches
    dump = tdc.pair_delta_dump(scale, seeds)
    assert tdc.pair_delta_dump.launches == before + 1
    flat = torch.stack([lay.flat_dec({k: v[p] for k, v in dump.items()})
                        for p in range(3)])
    plain = torch.stack([lay.flat_dec(tdc.pair_delta_dump_plain(scale, s))
                         for s in seeds])
    torch.cuda.synchronize()
    assert float((flat - plain).abs().max()) <= 8 * 4.77e-7 * 0.05
    assert (flat[:, sc == 0] == 0).all()
    base = lay.prep(theta_dec, torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        seq5, lp5 = tdc.decode_pair_rng(base, scale, seeds, feats[0], dtype=dt,
                                        need_logprobs=True)
        seq2, lp2 = tdc.decode_pair_perturb(base, dump, feats[0], dtype=dt,
                                            need_logprobs=True)
        assert torch.equal(seq5, seq2) and torch.equal(lp5, lp2)
    w = torch.tensor([0.5, -0.25, 0.125], device="cuda")
    grad = lay.flat_dec(tdc.pair_grad_rng(scale, seeds, w))
    ordered = torch.zeros_like(grad)
    for p in range(3):
        ordered = ordered + w[p] * flat[p]
    assert torch.equal(grad, ordered)

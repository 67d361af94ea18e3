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

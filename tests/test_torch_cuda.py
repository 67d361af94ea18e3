"""The port's CUDA kernels against their plain twins, on the card.

The file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX, without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Here, without a card, every test skips. ``chip_smoke.py`` holds the kernels
to their twins at full width; these tests cover a small vocab, a short
feature width, partial batches and the cluster kernels' edges.
"""

import contextlib

import numpy as np
import pytest
import torch

from nes_img_captioning_tpu_torch.models.fc_caption import (
    FCModelOptions,
    build_spec,
)
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout
from nes_img_captioning_tpu_torch.ops.noise import philox_normal_plain

from torch_pin import one_intra_op_thread  # noqa: F401


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
    """K2 with a bf16 delta: tokens equal K1's on prep(base ± delta) bit for
    bit, lp within 2e-5. Each output comes from K1's products in K1's order,
    so the logits and the token are K1's; but the two halves of a sign's
    cluster each sum exp over their own columns and then merge, so lp's
    log-sum-exp adds in another order than K1's."""
    lay, members, feats, delta = small_members
    base = lay.prep(members[0], torch.float32)
    seq2, lp2 = tdc.decode_pair_perturb(
        base, lay.prep(delta, torch.bfloat16), feats[0], dtype=dt,
        need_logprobs=True)
    for s, sign in ((0, 1.0), (1, -1.0)):
        seq1, lp1 = tdc.decode_fused(
            lay.prep(members[0] + sign * delta.float(), dt), feats[0])
        assert torch.equal(seq2[s], seq1)
        assert float((lp2[s] - lp1).abs().max()) < 2e-5


def _pair_inputs(lay, members, delta, P):
    """base (f32 dict) and a bf16 delta dict with a leading pair axis P:
    pair p's delta is delta * (p + 1)."""
    base = lay.prep(members[0], torch.float32)
    d = lay.prep(torch.stack([delta.float() * (p + 1) for p in range(P)]),
                 torch.float32)
    return base, d


def _held_to_k1(base, d, feats, dt, seq2, lp2):
    """Every (pair, sign) of K2's output: tokens bitwise K1's on prep(base ±
    delta), lp within 2e-5 (the merge order of the halves' sums)."""
    for p in range(seq2.shape[0]):
        for s, sign in ((0, 1.0), (1, -1.0)):
            params = tdc._perturbed(base, {k: v[p] for k, v in d.items()},
                                    sign, dt)
            seq1, lp1 = tdc.decode_fused(params, feats[p])
            assert torch.equal(seq2[p, s], seq1), (p, s)
            assert float((lp2[p, s] - lp1).abs().max()) < 2e-5, (p, s)


def _edge_inputs(width, vocab=300):
    """The cluster kernels' edge cases' inputs at E = R = ``width``: at 128
    ``small_members``' (vocab 300, 256-d features, 32 rows, seed 0); at 256,
    512 and 1024 100 rows (2, 4 or 7 row blocks of 64, 32 or 16, the last
    ragged), the same vocab and feature width; ``vocab`` another
    vocabulary. Returns (layout, members, feats, delta)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts = FCModelOptions(vocab_size=vocab, fc_feat_size=256,
                          input_encoding_size=width, rnn_size=width)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator(device="cuda").manual_seed(0 if width == 128
                                                   else width)
    theta = lay.spec.init_theta(g) * 3
    feats = torch.randn((2, 32 if width == 128 else 100, 256), generator=g,
                        device="cuda")
    members = torch.stack([lay.to_dec(theta), lay.to_dec(theta * 0.5)])
    sc = lay.to_dec(torch.full_like(theta, 0.05), pad_scale=0.0)
    delta = (sc * torch.randn(lay.dim_dec, generator=g, device="cuda")
             ).to(torch.bfloat16)
    return lay, members, feats, delta


def _held_to_plain(base, d, feats, dt, seq2):
    """K2's tokens against its plain twin's: equal at f32 up to E = R = 512;
    at 1024 (f32 FMA chains of 1024 k-rows against torch's blocked sums) an
    f32 row may differ only where the twin's top two logits lie within
    1e-4 (chip_smoke.py's F32_TIE_GAP); at bf16 only where they lie within
    1e-3."""
    wide = base["h2h_w"].shape[-2] > 512
    for p in range(seq2.shape[0]):
        for s, sign in ((0, 1.0), (1, -1.0)):
            params = tdc._perturbed(base, {k: v[p] for k, v in d.items()},
                                    sign, dt)
            seq_p, _, gap_p = tdc.decode_fused_plain(params, feats[p],
                                                     top2_gap=True)
            torch.cuda.synchronize()
            if dt == torch.float32 and wide:
                _first_diffs_at_near_ties(seq2[p, s], seq_p, gap_p, 1e-4)
            elif dt == torch.float32:
                assert torch.equal(seq2[p, s], seq_p), (p, s)
            else:
                _first_diffs_at_near_ties(seq2[p, s], seq_p, gap_p)


def _block_finish(seq, rows):
    """The step after which each block of ``rows`` rows has no unfinished
    row (its last row's finish step), per (pair, sign)."""
    steps = _finish_steps(seq)
    return torch.stack([steps[..., lo:lo + rows].max(-1).values
                        for lo in range(0, seq.shape[-2], rows)], -1)


# (width, case, delta dtype): K5 draws its own f32 delta
_PAIR_EDGES = [(w, c, d) for w in (128, 256, 512, 1024)
               for c in ("tie_across_halves", "signs_finish_apart")
               for d in ("bf16", "f32")] + [
    (w, "k5_odd_pairs", "f32") for w in (128, 256, 512, 1024)] + [
    (w, c, d) for w in (256, 512, 1024)
    for c in ("blocks_finish_apart", "below_one_block")
    for d in ("bf16", "f32")]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("width,case,delta", _PAIR_EDGES,
                         ids=[f"w{w}-{c}-delta_{d}" for w, c, d in _PAIR_EDGES])
def test_pair_cluster_edges(width, case, delta, dt):
    """The pair kernel's cluster at the fixture's Vpad 384 (3 vocab tiles,
    an odd count): at 128 one cluster of 2 signs x 2 column halves per
    pair over 32 rows; at 256 and 512 one cluster per pair of 2 signs x 2
    halves x 2 or 4 row blocks over 100 rows (the last block ragged), at
    1024 one per sign of 2 halves x 7 blocks, a sign's blocks sharing its
    exit. Every (pair, sign) is held to K1 on
    prep(base ± delta) (tokens bit for bit, lp within 2e-5) and to the
    plain twin's tokens. tie_across_halves: two columns with the same
    weights and the row's largest bias, one in each half (70 in half 1 of
    tile 0, 130 in half 0 of tile 1): every token is the smaller index;
    signs_finish_apart: an EOS bias of +-50 in the delta ends pair 0's +
    sign (pair 1's - sign) at step 0 while the other sign decodes all 16
    steps, so the finished CTAs serve their peers' tiles to the end;
    k5_odd_pairs: K5 on 3 seeds, bitwise K2 fed K7's dump, with one launch
    counted; blocks_finish_apart: the first block's rows share one image
    and an EOS bias (from the plain twin) ends that block before another
    block's last row, which decodes on: the ended block writes token 0
    and its rows' argmax lp (< 0) until its sign's last row ends, K1's lp
    (the batch's one exit); below_one_block: 5 rows, one block (a cluster
    of 4, or at 1024 of 2 per sign)."""
    ddt = {"bf16": torch.bfloat16, "f32": torch.float32}[delta]
    lay, members, feats, delta = _edge_inputs(width)
    rows = tdc.cluster_rows(width)
    P = 3 if case == "k5_odd_pairs" else 2
    fe = torch.cat([feats, feats[:1]])[:P]
    if case == "below_one_block":
        fe = fe[:, :5].contiguous()
    elif case == "blocks_finish_apart":
        fe = fe.clone()
        fe[:, :rows] = fe[:, :1]
    base, d = _pair_inputs(lay, members, delta, P)
    if case != "k5_odd_pairs":
        d = {k: v.to(torch.float32 if k.endswith("_b") else ddt)
             for k, v in d.items()}
    if case == "tie_across_halves":
        lo, hi = 70, 130
        base["logit_w"][:, hi] = base["logit_w"][:, lo]
        d["logit_w"][:, :, hi] = d["logit_w"][:, :, lo]
        base["logit_b"][0, [lo, hi]] = 100.0
        d["logit_b"][:, 0, [lo, hi]] = 0.0
    elif case == "signs_finish_apart":
        d["logit_b"][:, 0, 0] = torch.tensor([50.0, -50.0], device="cuda")
        base["logit_b"][0, 0] = 0.0
    elif case == "blocks_finish_apart":
        # the EOS bias at which pair 0's + sign has its first block end
        # earliest before the latest other block
        best = None
        for b0 in np.linspace(-4.0, 12.0, 33):
            base["logit_b"][0, 0] = float(b0)
            seq_p = tdc.decode_pair_perturb_plain(base, d, fe, dtype=dt)[0]
            ends = _block_finish(seq_p[0, 0], rows)
            gap = int(ends[1:].max() - ends[0])
            if best is None or gap > best[0]:
                best = (gap, float(b0))
        base["logit_b"][0, 0] = best[1]
    if case == "k5_odd_pairs":
        sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05,
                                   device="cuda"), pad_scale=0.0)
        scale = lay.prep(sc, torch.float32)
        seeds = [7, 0xFFFFFFFF, 123456789]
        before = (tdc.decode_pair_rng.launches, tdc.pair_delta_dump.launches)
        seq5, lp5 = tdc.decode_pair_rng(base, scale, seeds, fe, dtype=dt,
                                        need_logprobs=True)
        assert (tdc.decode_pair_rng.launches,
                tdc.pair_delta_dump.launches) == (before[0] + 1, before[1])
        dump = tdc.pair_delta_dump(scale, seeds)
        seq2, lp2 = tdc.decode_pair_perturb(base, dump, fe, dtype=dt,
                                            need_logprobs=True)
        assert torch.equal(seq5, seq2) and torch.equal(lp5, lp2)
        assert seq5.shape == (3, 2, fe.shape[1], 16)
        _held_to_k1(base, dump, fe, dt, seq2, lp2)
        _held_to_plain(base, dump, fe, dt, seq2)
        return
    seq2, lp2 = tdc.decode_pair_perturb(base, d, fe, dtype=dt,
                                        need_logprobs=True)
    _held_to_k1(base, d, fe, dt, seq2, lp2)
    _held_to_plain(base, d, fe, dt, seq2)
    if case == "tie_across_halves":
        assert (seq2 == lo).all()
    elif case == "signs_finish_apart":
        for p, early in ((0, 0), (1, 1)):
            assert (seq2[p, early] == 0).all()
            assert (lp2[p, early, :, 1:] == 0).all()
            assert (seq2[p, 1 - early] > 0).all()
    elif case == "blocks_finish_apart":
        # somewhere a block has stopped while another one decodes on: its
        # rows emit 0 and write their argmax lp until the sign's last row
        # ends, 0 after it
        ends = _block_finish(seq2, rows)
        assert ((ends[..., 1:].max(-1).values - ends[..., 0]) > 0).any(), \
            ends
        for p in range(P):
            for s in range(2):
                e0, last = int(ends[p, s, 0]), int(ends[p, s].max())
                assert (seq2[p, s, :rows, e0 + 1:] == 0).all()
                assert (lp2[p, s, :rows, e0 + 1:last + 1] <= 0).all()
                assert (lp2[p, s, :, last + 1:] == 0).all()
    elif case == "below_one_block":
        assert seq2.shape == (P, 2, 5, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32)],
                         ids=["bf16-bf16", "bf16-f32", "f32-bf16", "f32-f32"])
def test_pair_cluster_holds_a_chunk(dtypes, width):
    """The pair kernel's launch shape at every width and compute and delta
    dtype. At 128 a chunk of 24 pairs (96 CTAs, clusters of 2 signs x 2
    column halves) is resident at once and the bf16 main path keeps 2 ring
    slots. At 256 and 512 a pair's 128 rows are one cluster of 2 signs x 2
    halves x 2 or 4 row blocks (8 or 16 CTAs, the latter a non-portable
    size); the card holds at least 14 or 6 of them at once (15 and 7 on
    an H100 80GB HBM3), and every dtype keeps 2 ring slots at least. At
    1024 each sign of a pair is a cluster of 2 halves x 8 row blocks (16
    CTAs, two clusters per pair), of which the card holds at least 6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    info = tdc.pair_cluster_info(*dtypes, width=width)
    assert info["threads"] == 512 and info["smem_bytes"] <= 232448
    if width == 128:
        assert info["cluster"] == 4 and info["row_blocks"] == 1
        assert info["max_active_clusters"] >= 24, info
        if dtypes[0] == torch.bfloat16:
            assert info["ring_slots"] >= 2, info
        return
    nb = 128 // tdc.cluster_rows(width)
    signs = 1 if width == 1024 else 2
    assert info["row_blocks"] == nb and info["cluster"] == 2 * signs * nb, \
        info
    assert info["max_active_clusters"] >= (14 if width == 256 else 6), info
    assert info["ring_slots"] >= 2 and info["tiles_in_flight"] >= 1, info


def _member_held_to_plain(params, feats, kernel, dt, tile=128):
    """K1 (or K4 at ``tile``) on ``params``: f32 tokens equal the plain
    twin's, lp within 2e-5; bf16 rows differ only where the plain top two
    logits lie within 1e-3; K4's tokens are K1's bit for bit. Returns the
    kernel's (seq, lp)."""
    vocab_tile = tile if kernel == "K4" else 0
    before = (tdc.decode_fused.launches, tdc.decode_tiled.launches)
    seq, lp = tdc.decode_fused(params, feats, vocab_tile=vocab_tile)
    assert (tdc.decode_fused.launches - before[0],
            tdc.decode_tiled.launches - before[1]) == (
        (1, 0) if kernel == "K1" else (0, 1))
    seq_p, lp_p, gap_p = tdc.decode_fused_plain(
        params, feats, vocab_tile=vocab_tile, top2_gap=True)
    torch.cuda.synchronize()
    if dt == torch.float32:
        assert torch.equal(seq, seq_p)
        assert float((lp - lp_p).abs().max()) < 2e-5
    else:
        _first_diffs_at_near_ties(seq, seq_p, gap_p)
    if kernel == "K4":
        assert torch.equal(seq, tdc.decode_fused(params, feats)[0])
    return seq, lp


def _finish_steps(seq):
    """The step on which each row first emits 0 (T when it never does)."""
    zero = seq == 0
    return torch.where(zero.any(-1), zero.int().argmax(-1), seq.shape[-1])


def _eos_bias(params, run, score):
    """Set the EOS bias at which ``score`` of the rows' finish steps (from
    the plain twin's tokens ``run(params)``) is largest."""
    best = None
    for b0 in np.linspace(-4.0, 12.0, 33):
        params["logit_b"][:, 0, 0] = float(b0)
        n = score(_finish_steps(run(params)))
        if best is None or n > best[0]:
            best = (n, float(b0))
    params["logit_b"][:, 0, 0] = best[1]


def _past_eos(seq, steps):
    """Positions after a row's first 0 up to its batch's (the last axis but
    one) last row's: the steps a finished row still writes."""
    t = torch.arange(seq.shape[-1], device=seq.device)
    last = steps.max(-1, keepdim=True).values
    return (t > steps[..., None]) & (t <= last[..., None])


# (width, case): the member kernel's edges at every width; past 128 over
# 100 rows (2, 4 or 7 row blocks, the last ragged)
_MEMBER_EDGES = [(w, c) for w in (128, 256, 512, 1024)
                 for c in ("tie_across_halves", "padding_rows",
                           "single_member", "rows_finish_apart",
                           "exit_at_step_0", "vocab_tile_1920")] + [
    (w, "blocks_finish_apart") for w in (256, 512, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("width,case", _MEMBER_EDGES,
                         ids=[f"w{w}-{c}" for w, c in _MEMBER_EDGES])
def test_member_cluster_edges(width, case, kernel, dt):
    """The member kernel's cluster (2 column halves per member; at 256 and
    512 those 2 for each row block) at Vpad 384 (3 vocab tiles: K4 at tile
    128 folds each), held to the plain twin (f32 tokens equal and lp within
    2e-5 at every position; bf16 rows differ only at near-ties; K4's tokens
    K1's): tie_across_halves: two columns with the same weights and the
    row's largest bias, one in each half and each vocab tile (70 in half 1
    of tile 0, 130 in half 0 of tile 1): every token is the smaller index;
    padding_rows: 5 rows, the rest padding (below one block at 256 and
    512); single_member: one unbatched member (validation's shape) gives
    the batched call's rows bit for bit; rows_finish_apart: an EOS bias
    under which the rows end at different steps, some never: a finished
    row writes token 0 and the twin's lp while another row decodes, and lp
    0 once the member's last row has finished; exit_at_step_0: every row
    emits EOS at step 0, so the cluster leaves after one step with the
    outputs 0 after it; vocab_tile_1920: vocab 3839 (Vpad 3840), K4 at
    tile 1920 (2 vocab tiles); blocks_finish_apart: the first block's rows
    share one image and an EOS bias ends that block before another block's
    last row: the ended block's rows write the twin's lp on."""
    tile = 1920 if case == "vocab_tile_1920" else 128
    lay, members, feats, _ = _edge_inputs(
        width, vocab=3839 if case == "vocab_tile_1920" else 300)
    params = lay.prep(members, dt)
    rows = tdc.cluster_rows(width)
    if case == "tie_across_halves":
        lo, hi = 70, 130
        params["logit_w"][:, :, hi] = params["logit_w"][:, :, lo]
        params["logit_b"][:, 0, [lo, hi]] = 100.0
        seq, _ = _member_held_to_plain(params, feats, kernel, dt)
        assert (seq == lo).all()
    elif case == "padding_rows":
        seq, _ = _member_held_to_plain(params, feats[:, :5].contiguous(),
                                       kernel, dt)
        assert seq.shape == (2, 5, 16)
    elif case == "single_member":
        one = {k: v[1] for k, v in params.items()}
        seq1, lp1 = _member_held_to_plain(one, feats[1], kernel, dt)
        seq, lp = tdc.decode_fused(params, feats,
                                   vocab_tile=128 if kernel == "K4" else 0)
        assert seq1.shape == (feats.shape[1], 16)
        assert torch.equal(seq1, seq[1]) and torch.equal(lp1, lp[1])
    elif case in ("rows_finish_apart", "blocks_finish_apart"):
        if case == "rows_finish_apart":  # the most distinct finish steps
            def score(st):
                return len(torch.unique(st))
        else:  # the first block ends longest before another block's row
            feats = feats.clone()
            feats[:, :rows] = feats[:, :1]

            def score(st):
                return int((st[:, rows:].max(-1).values
                            - st[:, :rows].max(-1).values).max())
        _eos_bias(params, lambda p: tdc.decode_fused_plain(p, feats)[0],
                  score)
        seq, lp = _member_held_to_plain(params, feats, kernel, dt)
        steps = _finish_steps(seq)
        if case == "rows_finish_apart":
            assert len(torch.unique(steps)) >= 3, steps
        else:  # the first block ends before another block's last row
            assert (steps[:, :rows].max(-1).values
                    < steps[:, rows:].max(-1).values).any(), steps
        # a finished row emits 0 and writes its argmax lp while another
        # row decodes; its lp is 0 once the member's last row has finished
        past = _past_eos(seq, steps)
        assert (seq[past] == 0).all() and (lp[past] <= 0).all()
        for m in range(2):
            last = int(steps[m].max())
            if last < 15:
                assert (lp[m, :, last + 1:] == 0).all()
    elif case == "vocab_tile_1920":
        seq, _ = _member_held_to_plain(params, feats, kernel, dt, tile)
        assert lay.Vpad == 3840
    else:
        params["logit_b"][:, 0, 0] = 1e4
        seq, lp = _member_held_to_plain(params, feats, kernel, dt)
        assert (seq == 0).all() and (lp[..., 1:] == 0).all()


@pytest.fixture
def wide_vocab():
    """Two members at vocab 1279 (padded to 1280: 10 tiles of 128 columns,
    Vpad / 5 = 256), 256-d features, all 128 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = FCModelOptions(vocab_size=1279, fc_feat_size=256)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator(device="cuda").manual_seed(1)
    theta = lay.spec.init_theta(g) * 3
    feats = torch.randn((2, 128, 256), generator=g, device="cuda")
    return lay, torch.stack([lay.to_dec(theta), lay.to_dec(theta * 0.7)]), \
        feats


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", [128, 256], ids=["tile128", "vpad_over_5"])
def test_k4_vocab_tiles_on_a_wider_vocab(wide_vocab, tile, dt):
    """K4 at tile 128 (10 vocab tiles, one split cluster barrier each) and
    at Vpad / 5 (5 tiles of 2 x 128 columns): tokens K1's bit for bit; at
    f32 tokens equal the plain twin's, lp within 2e-5."""
    lay, members, feats = wide_vocab
    _member_held_to_plain(lay.prep(members, dt), feats, "K4", dt, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_member_cluster_holds_a_chunk(small_members, dt, width):
    """At 128 a chunk of 48 members (96 CTAs) is resident at once: the card
    holds at least 48 clusters of the member kernel at both weight dtypes.
    At 256, 512 and 1024 a member's 128 rows are one cluster of 2 halves x
    2, 4 or 8 row blocks (4 or 8 CTAs, portable sizes, or 16, a
    non-portable one), of which the card holds at least 24, 12 or 6 at
    once. The bf16 main path keeps 4 ring slots and several tiles in
    flight, the f32 path 2 slots at least."""
    info = tdc.member_cluster_info(dt, width=width)
    nb = 128 // tdc.cluster_rows(width)
    assert info["row_blocks"] == nb and info["cluster"] == 2 * nb, info
    assert info["threads"] == 512 and info["smem_bytes"] <= 232448
    assert info["max_active_clusters"] >= {128: 48, 256: 24, 512: 12,
                                           1024: 6}[width], info
    assert info["tiles_in_flight"] >= 1 and info["ring_slots"] >= 2, info
    if dt == torch.bfloat16:
        assert info["ring_slots"] >= 4 and info["tiles_in_flight"] >= 2, info


@pytest.mark.cuda
def test_philox_words_match_plain_stream(small_members):
    """The kernels' Philox draws the plain version's words bit for bit,
    known-answer vector included."""
    words = tdc.philox_words(0x12345678, 4096, "cuda")
    assert torch.equal(words.cpu(), tdc.philox_words(0x12345678, 4096, "cpu"))
    assert tdc.philox_words(0, 1, "cuda")[0].tolist() == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def _first_diffs_at_near_ties(seq_k, seq_p, gap_p, limit=1e-3):
    """Rows whose tokens differ first differ where the plain version's top
    two (of logits + G) lie within ``limit``; returns the differing rows."""
    rows = (~(seq_k == seq_p).all(-1)).nonzero().tolist()
    for idx in rows:
        t0 = int((seq_k[tuple(idx)] != seq_p[tuple(idx)]).nonzero()[0])
        assert float(gap_p[tuple(idx)][t0]) < limit, (idx, t0)
    return len(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_matches_plain_twin(small_members, dt):
    """K3, 3 lanes per member, Gumbel values drawn in the kernel: tokens
    equal the plain version's but at near-ties of logits + G, lp within
    2e-5 at f32 on equal rows; the host-table form fed the plain stream's
    table gives the kernel's tokens; the kernel's draw is the plain one's
    within 2 ulps; pad columns are never sampled."""
    lay, members, feats, _ = small_members
    params = lay.prep(members, dt)
    seeds = np.array([[1, 2, 0xFFFFFFFF], [7, 8, 9]], np.uint32)
    before = tdc.decode_sample.launches
    seq_k, lp_k = tdc.decode_fused(params, feats, greedy=False, seeds=seeds)
    assert tdc.decode_sample.launches == before + 1
    assert seq_k.shape == (2, 3, 32, 16)
    seq_p, lp_p, gap_p = tdc.decode_sample_plain(params, feats, seeds=seeds,
                                                 top2_gap=True)
    torch.cuda.synchronize()
    n_diff = _first_diffs_at_near_ties(seq_k, seq_p, gap_p)
    assert n_diff <= 2
    same = (seq_k == seq_p).all(-1)
    if dt == torch.float32:
        assert float((lp_k - lp_p).abs()[same].max()) < 2e-5
    assert int(seq_k.max()) <= 300 and (seq_k[0, 0] != seq_k[0, 1]).any()
    B, Vpad = 32, lay.Vpad
    table = torch.stack([torch.stack([
        torch.stack([tdc.gumbel_table(int(s), t, B, Vpad, "cpu")
                     for t in range(16)]) for s in row]) for row in seeds])
    seq_t, _ = tdc.decode_fused(params, feats, greedy=False,
                                gumbel=table.cuda())
    assert (seq_t == seq_k).all(-1).float().mean() > 0.99
    g_card = tdc.gumbel_table(12345, 3, B, Vpad, "cuda").cpu()
    g_cpu = tdc.gumbel_table(12345, 3, B, Vpad, "cpu")
    assert float((g_card - g_cpu).abs().max()) <= 2 * 1.91e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k4_tokens_equal_k1(small_members, dt):
    """K4 over 3 vocab tiles of 128: tokens equal K1's bit for bit; at f32
    lp within 2e-5 of K4's plain version."""
    lay, members, feats, _ = small_members
    params = lay.prep(members, dt)
    before = tdc.decode_tiled.launches, tdc.decode_fused.launches
    seq4, lp4 = tdc.decode_fused(params, feats, vocab_tile=128)
    seq1, _ = tdc.decode_fused(params, feats)
    torch.cuda.synchronize()
    assert (tdc.decode_tiled.launches, tdc.decode_fused.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(seq4, seq1)
    if dt == torch.float32:
        _, lp_p = tdc.decode_tiled_plain(params, feats, 128)
        assert float((lp4 - lp_p).abs().max()) < 2e-5
    with pytest.raises(ValueError, match="vocab_tile"):
        tdc.decode_fused(params, feats, vocab_tile=256)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
def test_k7_k5_k6_share_one_noise_stream(small_members):
    """K7's deltas are bitwise the plain version's on the card (torch's
    CUDA log, sqrt and cos are the library calls the kernel's narrowed
    forms equal), within 8 ulps of the plain version on the CPU, exactly 0
    on pad lanes; K5 with f32 and bf16 weights is bitwise K2 fed K7's dump;
    K6 is bitwise the ordered f32 sum of the dumps."""
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
    assert torch.equal(_bits(flat), _bits(plain))
    cpu = tdc.pair_delta_dump_flat(sc.cpu(), seeds[0])
    assert float((flat[0].cpu() - cpu).abs().max()) <= 8 * 4.77e-7 * 0.05
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


@pytest.mark.cuda
def test_box_muller_narrowed_equals_library(small_members):
    """The logf, sqrtf and cosf that K5, K6 and K7 run, narrowed to the
    stream's inputs, equal the library calls bit for bit on all 2^23 inputs
    each (csrc/decode.cu, box_table_kernel)."""
    table = tdc.box_muller_table("cuda")
    torch.cuda.synchronize()
    assert table.shape == (3, 2, 1 << 23)
    for r in range(3):
        assert torch.equal(_bits(table[r, 0]), _bits(table[r, 1])), r
    # the table is the stream's: u = 0 gives log 0, a radius of -0, cos 1
    assert _bits(table[1, 0, :1]).item() == -0x80000000
    assert table[2, 0, 0].item() == 1.0


def _toy_scale(dim: int) -> torch.Tensor:
    """A flat f32 noise scale of ``dim`` elements on the card: the toy
    layout's (vocab 40, E = R = 16, 24-d features; pad lanes 0) cut or
    tiled to ``dim``."""
    opts = FCModelOptions(vocab_size=40, input_encoding_size=16, rnn_size=16,
                          fc_feat_size=24)
    lay = DecodeLayout(build_spec(opts), opts)
    g = torch.Generator().manual_seed(dim)
    sc = lay.to_dec(torch.rand(lay.spec.num_params, generator=g) + 0.01,
                    pad_scale=0.0)
    return sc.repeat(dim // sc.numel() + 1)[:dim].cuda()


# dims: the toy layout's 7344 (quads, the last block of threads partly
# idle), odd and 2 mod 4 (the scalar path), 1 and 5 (less than a quad)
@pytest.mark.cuda
@pytest.mark.parametrize("dim", [7344, 7343, 7342, 1, 5])
def test_k7_bitwise_plain_on_card(small_members, dim):
    """K7 (the flat entry) on a flat scale of any length, and on a scale
    that is not 16-byte aligned: bitwise the plain version run on the
    card, and the dict form's values."""
    sc = _toy_scale(dim + 1)
    seeds = [7, 0xFFFFFFFF, 0x9E3779B9]
    plain = torch.stack([philox_normal_plain(
        s, torch.arange(dim, device="cuda"), sc[:dim]) for s in seeds])
    for flat in (sc[:dim], sc[1:]):  # aligned, and 4 bytes past it
        want = plain if flat.data_ptr() == sc.data_ptr() else torch.stack([
            philox_normal_plain(s, torch.arange(dim, device="cuda"),
                                    flat) for s in seeds])
        got = tdc.pair_delta_dump_flat(flat, seeds)
        torch.cuda.synchronize()
        assert got.shape == (3, dim)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(tdc.pair_delta_dump_flat(flat, seeds[1]), got[1])


@pytest.mark.cuda
def test_k7_flat_entry_equals_dict_form(small_members):
    """pair_delta_dump is pair_delta_dump_flat cut into the nine tensors:
    the same values, one launch each."""
    lay, _, _, _ = small_members
    sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.01, device="cuda"),
                    pad_scale=0.0)
    scale = lay.prep(sc, torch.float32)
    seeds = np.array([1, 2, 3, 4, 5], np.uint32)
    before = tdc.pair_delta_dump.launches
    flat = tdc.pair_delta_dump_flat(sc, seeds)
    dump = tdc.pair_delta_dump(scale, seeds)
    assert tdc.pair_delta_dump.launches == before + 2
    for p in range(5):
        assert torch.equal(_bits(lay.flat_dec({k: v[p] for k, v in
                                               dump.items()})), _bits(flat[p]))


# F: 1, 3 and 5 seeds (the four-seed unroll's remainder), a generation's
# 144, and 600 (beyond the 512 seeds a block stages at once)
@pytest.mark.cuda
@pytest.mark.parametrize("F,dim", [(1, 0), (3, 0), (5, 0), (144, 0),
                                   (5, 7344), (3, 7343), (600, 1026)],
                         ids=["F1", "F3", "F5", "F144", "toy_tail",
                              "odd_dim", "F600"])
def test_k6_bitwise_ordered_sum_of_k7(small_members, F, dim):
    """K6 is bitwise the ordered f32 sum of K7's dumps, sum_i f32(w_i *
    delta_i) added in seed order, on the small layout (dim 0 here) and on
    the toy layout's flat scale, its odd tail included."""
    lay, _, _, _ = small_members
    if dim:
        sc = _toy_scale(dim)
    else:
        sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05,
                                   device="cuda"), pad_scale=0.0)
    rng = np.random.default_rng(F)
    seeds = rng.integers(0, 2**32, size=F, dtype=np.uint32)
    w = torch.as_tensor(rng.uniform(-1, 1, F).astype(np.float32),
                        device="cuda")
    before = tdc.pair_grad_rng.launches
    grad = tdc.pair_grad_rng_flat(sc, seeds, w)
    assert tdc.pair_grad_rng.launches == before + 1
    dumps = tdc.pair_delta_dump_flat(sc, seeds)
    ordered = torch.zeros_like(sc)
    for i in range(F):
        ordered = ordered + w[i] * dumps[i]
    torch.cuda.synchronize()
    assert torch.equal(_bits(grad), _bits(ordered))
    if not dim:
        scale = lay.prep(sc, torch.float32)
        assert torch.equal(lay.flat_dec(tdc.pair_grad_rng(scale, seeds, w)),
                           grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_member_cluster_shape(small_members, dt):
    """K3 runs on the member kernel: its layout (5-field row partials, one
    partial buffer) keeps K1's ring slots and residency; K1's layout is
    unchanged (227,712 B at bf16)."""
    greedy = tdc.member_cluster_info(dt)
    info = tdc.member_cluster_info(dt, sampled=True)
    assert info["cluster"] == 2 and info["threads"] == 512
    assert info["smem_bytes"] <= 232448
    assert info["ring_slots"] == greedy["ring_slots"], (info, greedy)
    assert info["max_active_clusters"] >= 48, info
    if dt == torch.bfloat16:
        assert greedy["smem_bytes"] == 227712 and info["ring_slots"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_zero_table_is_k1(small_members, dt):
    """The host-table form fed an all-zero table takes K1's argmax: every
    lane's tokens and lp are K1's bit for bit (key = logit + 0 = logit, the
    same runs and merges)."""
    lay, members, feats, _ = small_members
    params = lay.prep(members, dt)
    zeros = torch.zeros((2, 3, 16, 32, lay.Vpad), device="cuda")
    seq3, lp3 = tdc.decode_fused(params, feats, greedy=False, gumbel=zeros)
    seq1, lp1 = tdc.decode_fused(params, feats)
    torch.cuda.synchronize()
    for lane in range(3):
        assert torch.equal(seq3[:, lane], seq1), lane
        assert torch.equal(lp3[:, lane], lp1), lane


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["single_member", "rows_finish_apart",
                                  "exit_at_step_0"])
def test_k3_member_edges(case, dt, width):
    """K3 on the member kernel, 3 lanes per member (past 128 over 100
    rows, 2, 4 or 7 row blocks per lane's cluster), against its plain
    twin (tokens equal but at near-ties of logits + G, lp within 2e-5 at
    f32 on equal rows): single_member: one unbatched member gives the
    batched call's lanes bit for bit; rows_finish_apart: an EOS bias under
    which the rows end at different steps and the lanes' last rows too: a
    finished row writes token 0 and lp while its lane decodes, and the
    lane's lp is 0 after its last row ends; exit_at_step_0: every row
    emits EOS at step 0."""
    lay, members, feats, _ = _edge_inputs(width)
    params = lay.prep(members, dt)
    seeds = np.array([[5, 6, 0xFFFFFFFF], [7, 8, 9]], np.uint32)
    if case == "rows_finish_apart":
        def score(st):  # 3 distinct steps, then lanes that end apart
            n, end = len(torch.unique(st)), st.max(-1).values
            return min(n, 3), int((end != end[:, :1]).any()), n
        _eos_bias(params, lambda p: tdc.decode_sample_plain(
            p, feats, seeds=seeds)[0], score)
    elif case == "exit_at_step_0":
        params["logit_b"][:, 0, 0] = 1e4
    seq, lp = tdc.decode_fused(params, feats, greedy=False, seeds=seeds)
    seq_p, lp_p, gap_p = tdc.decode_sample_plain(params, feats, seeds=seeds,
                                                 top2_gap=True)
    torch.cuda.synchronize()
    assert _first_diffs_at_near_ties(seq, seq_p, gap_p) <= 2
    same = (seq == seq_p).all(-1)
    if dt == torch.float32:
        assert float((lp - lp_p).abs()[same].max()) < 2e-5
    if case == "single_member":
        one = {k: v[1] for k, v in params.items()}
        seq1, lp1 = tdc.decode_fused(one, feats[1], greedy=False,
                                     seeds=seeds[1])
        assert seq1.shape == (3, feats.shape[1], 16)
        assert torch.equal(seq1, seq[1]) and torch.equal(lp1, lp[1])
    elif case == "rows_finish_apart":
        steps = _finish_steps(seq)
        assert len(torch.unique(steps)) >= 3, steps
        lane_end = steps.max(-1).values
        assert (lane_end != lane_end[:, :1]).any(), lane_end
        past = _past_eos(seq, steps)
        assert (seq[past] == 0).all() and (lp[past] <= 0).all()
        for m in range(2):
            for lane in range(3):
                last = int(steps[m, lane].max())
                if last < 15:
                    assert (lp[m, lane, :, last + 1:] == 0).all()
    else:
        assert (seq == 0).all() and (lp[..., 1:] == 0).all()


@pytest.fixture
def card_task():
    """A CocoTask factory on the card at E = R = 128, vocab 300, 256-d
    features, f32 weights, over an in-memory synthetic split of 64
    images; ``popts``, ``mopts`` and ``tpu`` add policy options, model
    options and TpuConfig fields."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    data = CocoData.from_arrays(synthetic_coco_arrays(
        n_train=64, n_val=8, n_test=8, vocab_size=300, fc_feat_size=256,
        cap_len=9, seed=0))

    def make(kind, precision="f32", popts=None, mopts=None, **tpu):
        exp = {"dataset": "mscoco", "policy_options": {
            "fitness": kind, "vbn": False, **(popts or {}),
            "model_options": {
                "input_encoding_size": 128, "rnn_size": 128,
                "fc_feat_size": 256, **(mopts or {})}}}
        return CocoTask(exp, Config(batch_size=256),
                        TpuConfig(seed=0, precision=precision, **tpu),
                        device="cuda", data=data)
    make.data = data
    return make


def _card_members(task, n):
    lay = task.decode_layout
    g = torch.Generator(device="cuda").manual_seed(3)
    theta = lay.spec.init_theta(g) * 3
    return lay, torch.stack([lay.to_dec(theta * (1 - 0.25 * i))
                             for i in range(n)]), g


@pytest.mark.cuda
def test_k3_256_rows_through_the_task(card_task):
    """sc_loss at B = 256: the task decodes K3 in two launches of 128 rows
    (the second at row offset 128), which draw the plain twin's stream of
    one 256-row batch: tokens equal but at near-ties, lp within 2e-5 on
    equal rows at every step the criterion reads; the card's Gumbel values
    at row offset 128 are the plain stream's within 2 ulps."""
    task = card_task("sc_loss")
    lay, members, g = _card_members(task, 2)
    params = lay.prep(members, torch.float32)
    idx = torch.randint(0, 64, (2, 256), generator=g, device="cuda")
    feats = task.train_fc[idx]
    seeds = np.array([[11, 12, 13, 14, 15], [16, 17, 18, 19, 20]], np.uint32)
    before = tdc.decode_sample.launches
    seq, lp = task._sample(params, feats, seeds)
    assert tdc.decode_sample.launches == before + 2
    assert seq.shape == (2, 5, 256, 16)
    seq_p, lp_p, gap_p = tdc.decode_sample_plain(params, feats, seeds=seeds,
                                                 top2_gap=True)
    torch.cuda.synchronize()
    assert _first_diffs_at_near_ties(seq, seq_p, gap_p) <= 4
    same = (seq == seq_p).all(-1)
    read = torch.cat([torch.ones_like(seq_p[..., :1], dtype=torch.bool),
                      seq_p[..., :-1] > 0], -1)
    assert float(((lp - lp_p).abs() * read)[same].max()) < 2e-5
    fits = task.rollout_dec(members, idx, lanes=seeds)
    assert fits.shape == (2,) and torch.isfinite(fits).all()
    g_card = tdc.gumbel_table(12345, 3, 32, lay.Vpad, "cuda", row0=128)
    g_cpu = tdc.gumbel_table(12345, 3, 32, lay.Vpad, "cpu", row0=128)
    assert float((g_card.cpu() - g_cpu).abs().max()) <= 2 * 1.91e-6


@pytest.mark.cuda
def test_k2_k5_take_256_rows_through_the_task(card_task):
    """The pair kernels at B = 256 through the task: two launches of 128
    rows each; the fitnesses equal those of the plain pair decode over all
    256 rows (K2's plain twin fed the delta; for K5, fed K7's dump of the
    seeds, the delta K5 draws), f32 tokens being the plain twin's."""
    task = card_task("greedy")
    lay, members, g = _card_members(task, 1)
    base = task.pair_base_params(members[0])
    sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05, device="cuda"),
                    pad_scale=0.0)
    delta = torch.stack([sc * torch.randn(lay.dim_dec, generator=g,
                                          device="cuda") for _ in range(2)])
    idx = torch.randint(0, 64, (2, 256), generator=g, device="cuda")
    feats = task.train_fc[idx]
    consts = task.device_consts()
    before = tdc.decode_pair_perturb.launches
    fits2 = task.rollout_pair_dec(base, delta, idx)
    assert tdc.decode_pair_perturb.launches == before + 2
    seq2, lp2 = tdc.decode_pair_perturb_plain(
        base, lay.prep(delta, torch.float32), feats)
    want2 = task._pair_fitness(seq2, lp2, idx, consts)
    assert torch.equal(fits2, want2)
    scale = lay.prep(sc, torch.float32)
    seeds = [21, 22]
    before = tdc.decode_pair_rng.launches
    fits5 = task.rollout_pair_rng(base, scale, seeds, idx)
    assert tdc.decode_pair_rng.launches == before + 2
    seq5, lp5 = tdc.decode_pair_perturb_plain(
        base, tdc.pair_delta_dump(scale, seeds), feats)
    want5 = task._pair_fitness(seq5, lp5, idx, consts)
    assert torch.equal(fits5, want5)
    assert fits2.shape == fits5.shape == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 1024])
@pytest.mark.parametrize("kernel", ["K1", "K4", "K3", "K2"])
def test_batch_above_128_rows_shares_one_exit(card_task, kernel, width):
    """A batch of 256 rows with lp asked for (greedy_logprob; K3: sc_loss),
    f32, through the task's row blocks of 128 (``CocoTask._by_rows``, two
    launches with no exit of their own, joined by ``join_row_blocks``)
    gives the one-launch result, the plain twin's over all 256 rows at
    once: tokens equal (K3: but at near-ties of logits + G) and lp within
    2e-5 at every position. Rows 128-255 share one image, and an EOS bias
    (from the plain twin) ends that block before the other's last row, so
    a finished row writes its argmax lp (< 0) there while the batch decodes
    on, and 0 after the batch's last row ends."""
    kind = "sc_loss" if kernel == "K3" else "greedy_logprob"
    task = card_task(kind, mopts={"input_encoding_size": width,
                                  "rnn_size": width},
                     decode_vocab_tile=128 if kernel == "K4" else 0)
    lay, members, g = _card_members(task, 2)
    idx = torch.randint(0, 64, (2, 256), generator=g, device="cuda")
    idx[:, 128:] = idx[:, 128:129]
    feats = task.train_fc[idx]
    seeds = np.array([[11, 12, 13, 14, 15], [16, 17, 18, 19, 20]], np.uint32)
    if kernel == "K2":
        base = task.pair_base_params(members[0])
        sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05,
                                   device="cuda"), pad_scale=0.0)
        delta = lay.prep(torch.stack([sc * torch.randn(
            lay.dim_dec, generator=g, device="cuda") for _ in range(2)]),
            torch.float32)

        def plain(b):
            return tdc.decode_pair_perturb_plain(b, delta, feats,
                                                 need_logprobs=True)

        def run(b):
            return task._by_rows(lambda lo, hi, hold: tdc.decode_pair_perturb(
                b, delta, feats[:, lo:hi], need_logprobs=True,
                min_steps=hold), 256, 2, True)
        params, bias = base, base["logit_b"][0]
    else:
        params = lay.prep(members, torch.float32)
        if kernel == "K3":
            def plain(p):
                return tdc.decode_sample_plain(p, feats, seeds=seeds)

            def run(p):
                return task._sample(p, feats, seeds)
        else:
            def plain(p):
                return tdc.decode_fused_plain(
                    p, feats, vocab_tile=128 if kernel == "K4" else 0)

            def run(p):
                return task._greedy(p, feats, need_logprobs=True)
        bias = params["logit_b"][..., 0, :]

    def gap(seq):  # how long the block of one image ends before the other
        steps = _finish_steps(seq)
        ends = torch.stack([steps[..., :128].max(-1).values,
                            steps[..., 128:].max(-1).values], -1)
        return int((ends[..., 0] - ends[..., 1]).max()) \
            if int(ends.max()) < 15 else -1

    best = None
    for b0 in np.linspace(-4.0, 12.0, 33):
        bias[..., 0] = float(b0)
        n = gap(plain(params)[0])
        if best is None or n > best[0]:
            best = (n, float(b0))
    bias[..., 0] = best[1]
    assert best[0] > 0, best
    seq, lp = run(params)
    seq_p, lp_p = plain(params)[:2]
    torch.cuda.synchronize()
    if kernel == "K3":
        _, _, gap_p = tdc.decode_sample_plain(params, feats, seeds=seeds,
                                              top2_gap=True)
        assert _first_diffs_at_near_ties(seq, seq_p, gap_p) <= 4
        same = (seq == seq_p).all(-1)
        assert float((lp - lp_p).abs()[same].max()) < 2e-5
    else:
        assert torch.equal(seq, seq_p)
        assert float((lp - lp_p).abs().max()) < 2e-5
    steps = _finish_steps(seq)
    past = _past_eos(seq, steps)
    assert past[..., 128:, :].any(), steps
    assert (seq[past] == 0).all() and (lp[past] <= 0).all()
    assert (lp[past] < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("vocab_tile", [0, 128], ids=["K1", "K4"])
def test_decode_rows_bitwise_per_block_launches(vocab_tile, dt, width):
    """The row-block launch (validation's decode) in one launch, at 128
    over N = 300 rows (blocks of 128, 128 and 44), past it over 5000 (39
    blocks of 128 and one of 8; each a cluster of 2 halves x 2, 4 or 8 row
    blocks, the last one's later CTAs all padding): tokens and lp
    bit for bit those of one decode_fused (decode_tiled) launch per block
    of 128; f32 tokens equal the plain twin, lp within 2e-5."""
    lay, members, _, _ = _edge_inputs(width)
    params = lay.prep(members[0], dt)
    g = torch.Generator(device="cuda").manual_seed(5)
    N = 300 if width == 128 else 5000
    feats = torch.randn((N, 256), generator=g, device="cuda")
    before = tdc.decode_rows.launches
    seq, lp = tdc.decode_rows(params, feats, need_logprobs=True,
                              vocab_tile=vocab_tile)
    assert tdc.decode_rows.launches == before + 1
    blocks = [tdc.decode_fused(params, feats[lo:lo + 128],
                               vocab_tile=vocab_tile)
              for lo in range(0, N, 128)]
    torch.cuda.synchronize()
    assert seq.shape == lp.shape == (N, 16)
    assert torch.equal(seq, torch.cat([b[0] for b in blocks]))
    assert torch.equal(lp, torch.cat([b[1] for b in blocks]))
    if dt == torch.float32:
        seq_p, lp_p = tdc.decode_rows_plain(params, feats,
                                            vocab_tile=vocab_tile)
        assert torch.equal(seq, seq_p)
        assert float((lp - lp_p).abs().max()) < 2e-5


@pytest.mark.cuda
def test_validate_device_on_the_card_makes_no_sync(card_task):
    """validate_device on the card equals the host validate within rtol
    2e-5, atol 2e-6; it and podium_merge run under
    torch.cuda.set_sync_debug_mode("error"), so neither syncs the host."""
    from nes_img_captioning_tpu_torch.algorithms.es import podium_merge

    task = card_task("greedy")
    g = torch.Generator(device="cuda").manual_seed(4)
    theta = task.spec.init_theta(g) * 3
    vconsts = task.device_val_consts()
    host = task.validate(theta)
    e_rows = torch.zeros((2, theta.numel()), device="cuda")
    e_scores = torch.tensor([0.5, -float("inf")], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        val = task.validate_device(theta, vconsts)
        rows, scores = podium_merge(e_rows, e_scores, theta[None],
                                    val.reshape(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert val.is_cuda and val.dim() == 0
    np.testing.assert_allclose(float(val), host, rtol=2e-5, atol=2e-6)
    k = 0 if float(val) > 0.5 else 1
    assert torch.equal(rows[k], theta)


# the bound on |lp - plain| of bf16 decodes whose tokens agree (as
# chip_smoke.LP_BF16_TOL): kernel and twin round the same bf16 values and
# differ only in the order of their f32 sums
LP_BF16_TOL = 1e-2


def _es_parents(task, n=3):
    g = torch.Generator(device="cuda").manual_seed(5)
    theta = task.spec.init_theta(g) * 3
    return torch.stack([theta * (1 - 0.2 * i) for i in range(n)]), g


@pytest.mark.cuda
def test_es_rollout_of_16_children_at_256_rows(card_task):
    """The ES sweep's launch shape: 16 bf16 children in torch order at
    B = 256, laid out by to_dec and decoded by K1 in two launches of 128
    rows; tokens equal the plain twin's over all 256 rows but where the
    first difference is a near-tie (top-2 gap < 1e-2), lp within 1e-2 on
    the members whose tokens all agree; the fitnesses are those of the
    plain decode's tokens."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    task = card_task("greedy", precision="bf16")
    eng = ESEngine(task, MutationKind.SAFE_PROPORTIONAL, pop_chunk=16)
    parents, g = _es_parents(task)
    seeds = np.arange(100, 116, dtype=np.uint32)
    pidx = np.arange(16) % 3
    kids = eng.materialize(parents, 0.005, seeds, pidx)
    idx_row = torch.randint(0, 64, (256,), generator=g, device="cuda")
    lay = task.decode_layout
    params = lay.prep(lay.to_dec(kids), torch.bfloat16)
    feats = task.train_fc[idx_row].expand(16, -1, -1)
    before = tdc.decode_fused.launches
    fits = task.rollout(kids, idx_row)["fitness"]
    seq, lp = task._greedy(params, feats, True)
    assert tdc.decode_fused.launches == before + 4
    seq_p, lp_p, gap_p = tdc.decode_fused_plain(params, feats,
                                                need_logprobs=True,
                                                top2_gap=True)
    torch.cuda.synchronize()
    assert _first_diffs_at_near_ties(seq, seq_p, gap_p, limit=1e-2) <= 16
    agree = (seq == seq_p).all(-1).all(-1)
    assert bool(agree.any())
    assert float((lp - lp_p)[agree].abs().max()) < LP_BF16_TOL
    want = task._device_fitness(seq_p, idx_row.expand(16, -1),
                                task.device_consts()["cider"])
    assert torch.equal(fits[agree], want[agree])


def _es_master(card_task, tmp_path, mutation="SM-PROPORTIONAL", **tpu):
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster

    exp = {"algorithm": "nic_es", "dataset": "mscoco",
           "config": {"noise_stdev": 0.005, "batch_size": 16,
                      "num_val_items": 8, "snapshot_freq": 0,
                      "patience": 0},
           "policy_options": {"net": "fc_caption", "fitness": "greedy",
                              "vbn": False, "model_options": {
                                  "safe_mutations": mutation,
                                  "safe_mutation_underflow": 0.01,
                                  "input_encoding_size": 128,
                                  "rnn_size": 128, "fc_feat_size": 256}},
           "nb_offspring": 20, "population_size": 6, "num_elites": 2,
           "num_elite_cands": 2, "selection": "uniform",
           "log_dir": str(tmp_path),
           "tpu": {"seed": 0, "precision": "bf16", "pop_chunk": 4, **tpu}}
    return ESMaster(exp, device="cuda", data=card_task.data)


@pytest.mark.cuda
def test_es_fused_block_makes_no_sync(card_task, tmp_path):
    """gens_per_dispatch 2 over 4 generations (plain, fused, a block of
    2): the fused generation and the block run under
    torch.cuda.set_sync_debug_mode("error"), so neither syncs the host
    before its one pull."""
    m = _es_master(card_task, tmp_path, gens_per_dispatch=2)
    calls = []
    for name in ("fused_generation", "fused_block"):
        fn = getattr(m.engine, name)

        def run(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        setattr(m.engine, name, run)
    m.run_master(max_iterations=4)
    assert calls == ["fused_generation", "fused_block"]
    assert np.isfinite(m.stats.to_dict()["score_stats"]).all()


@pytest.mark.cuda
def test_es_sweep_fitness_equals_rebuilt_child(card_task, tmp_path):
    """Sweep, then materialize the best child and decode it alone on the
    sweep's batch: its fitness is its sweep fitness bit for bit; chunks of
    4 and 16 give the same fitness vector; the fused generation keeps
    materialize's children."""
    m = _es_master(card_task, tmp_path)
    eng, task = m.engine, m.task
    parents, g = _es_parents(task, 6)
    rng = np.random.default_rng(2)
    seeds = rng.integers(0, 2**32, size=20, dtype=np.uint32)
    pidx = rng.integers(0, 6, size=20)
    idx_row = rng.integers(0, 64, size=16)
    fit = eng.eval_generation(parents, 0.005, seeds, pidx, idx_row)["fitness"]
    order = np.argsort(-fit.cpu().numpy(), kind="stable")
    best = eng.materialize(parents, 0.005, seeds[order[:1]],
                           pidx[order[:1]])
    alone = task.rollout(best, torch.as_tensor(idx_row, device="cuda"))
    assert torch.equal(alone["fitness"][0], fit[int(order[0])])
    eng.pop_chunk = 16
    assert torch.equal(eng.eval_generation(parents, 0.005, seeds, pidx,
                                           idx_row)["fitness"], fit)
    fit2, selected, _, _ = eng._gen_core(
        parents, 0.005, seeds, pidx, idx_row, task.device_consts(),
        task.device_val_consts(), 4, 2)
    assert torch.equal(fit2, fit)
    assert torch.equal(selected, eng.materialize(parents, 0.005,
                                                 seeds[order[:4]],
                                                 pidx[order[:4]]))


def _sens_inputs(task, n_parents):
    """(parents (n, dim) on the card, 12 batch rows) for the sweeps."""
    g = torch.Generator(device="cuda").manual_seed(5)
    parents = torch.stack([task.spec.init_theta(g) * 3
                           for _ in range(n_parents)])
    rows = np.random.default_rng(4).choice(64, size=12, replace=False)
    return parents, rows


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sensitivity_rows_bitwise_repeatable(card_task, precision):
    """The SM-G-SUM sweep on the card: the (P, dim) matrix of 3 parents is
    the same bits on a second sweep, and each row is that parent's sweep
    alone (P = 1) bit for bit, so a row does not depend on P."""
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivities,
    )

    task = card_task("greedy")
    parents, rows = _sens_inputs(task, 3)
    idx = torch.as_tensor(rows, device="cuda")
    kind = MutationKind.SAFE_GRAD_SUM
    first = calc_sensitivities(task, parents, idx, kind, 0.01, precision)
    again = calc_sensitivities(task, parents, idx, kind, 0.01, precision)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    for i in range(3):
        alone = calc_sensitivities(task, parents[i:i + 1], idx, kind, 0.01,
                                   precision)
        assert torch.equal(alone[0].view(torch.int32),
                           first[i].view(torch.int32))
    assert torch.isfinite(first).all() and (first > 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["SM-G-SUM", "SM-G-ABS"])
def test_sensitivity_f32_card_matches_cpu(card_task, kind):
    """The f32 sensitivities (TF32 off) of one parent on the card against
    the same function on the CPU: within rtol 2e-4, atol 1e-6."""
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivity,
    )

    task = card_task("greedy")
    parents, rows = _sens_inputs(task, 1)
    idx = torch.as_tensor(rows[:4], device="cuda")
    card = calc_sensitivity(task, parents[0], idx, MutationKind(kind), 0.01)

    class CpuTask:
        numerics = staticmethod(contextlib.nullcontext)

        def sensitivity_forward(self, th, i, consts):
            return task.sensitivity_forward(th, i, consts)

        def device_consts(self):
            return {"train_fc": task.train_fc.cpu()}

    cpu = calc_sensitivity(CpuTask(), parents[0].cpu(), idx.cpu(),
                           MutationKind(kind), 0.01)
    torch.testing.assert_close(card.cpu(), cpu, rtol=2e-4, atol=1e-6)
    assert (cpu > 1).float().mean() > 0.01


@pytest.mark.cuda
def test_es_smg_fused_block_makes_no_sync(card_task, tmp_path):
    """SM-G-SUM NIC-ES, gens_per_dispatch 2 over 4 generations (plain,
    fused, a block of 2): the sensitivity sweeps inside the fused
    generation and the block run under set_sync_debug_mode("error"), and
    the plain path (its sweep by the master) ends on the same children
    bit for bit."""
    runs = {}
    for path, tpu in (("blocked", {"gens_per_dispatch": 2}),
                      ("plain", {"fused_es": False})):
        m = _es_master(card_task, tmp_path / path, "SM-G-SUM",
                       sensitivity_batch=8, sensitivity_split=64, **tpu)
        calls = []
        for name in ("fused_generation", "fused_block"):
            fn = getattr(m.engine, name)

            def run(*a, _fn=fn, _name=name, **k):
                calls.append(_name)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return _fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")

            setattr(m.engine, name, run)
        m.run_master(max_iterations=4)
        assert calls == (["fused_generation", "fused_block"]
                         if path == "blocked" else [])
        assert np.isfinite(m.stats.to_dict()["score_stats"]).all()
        if m.parents_mat is None:
            runs[path] = m._selected_dev[:m._n_selected]
        else:
            n_el = sum(p is not None for p in m._parent_paths)
            runs[path] = m.parents_mat[n_el:m._n_parents]
    assert torch.equal(runs["blocked"], runs["plain"])


@pytest.fixture
def mnist_tasks():
    """make(vbn, device): MnistTask on synthetic sizes (256, 128), batch 16;
    the process's TF32 switches left on (their default for cuDNN), so the
    task's own numerics must turn TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nes_img_captioning_tpu_torch.data.mnist import load_mnist
    from nes_img_captioning_tpu_torch.tasks.classification import MnistTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    data = load_mnist("/nonexistent", synthetic_sizes=(256, 128), seed=0)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    def make(vbn, device="cuda"):
        exp = {"dataset": "mnist", "policy_options": {"vbn": vbn}}
        return MnistTask(exp, Config(batch_size=16), TpuConfig(seed=0),
                         device=device, data=data)
    yield make
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


def _mnist_members(task, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    thetas = torch.stack([task.spec.init_theta(g) * 2 for _ in range(n)])
    idx = torch.randint(0, 256, (n, 16), generator=g)
    return thetas, idx


@pytest.mark.cuda
@pytest.mark.parametrize("vbn", [False, True], ids=["plain", "vbn"])
def test_mnist_rollout_card_matches_cpu(mnist_tasks, vbn):
    """30 members (two groups of MEMBER_GROUP) on the card against the
    CPU, with TF32 on in the process: logits and fitnesses within 1e-5,
    validate_device equal to validate and to the CPU's accuracy."""
    card, cpu = mnist_tasks(vbn), mnist_tasks(vbn, "cpu")
    thetas, idx = _mnist_members(cpu, 30)
    x = cpu.train_x[idx]
    lc = card.logits(thetas.cuda(), x.cuda()).cpu()
    torch.testing.assert_close(lc, cpu.logits(thetas, x), rtol=0, atol=1e-5)
    fc = card.rollout(thetas.cuda(), idx.cuda())["fitness"].cpu()
    torch.testing.assert_close(fc, cpu.rollout(thetas, idx)["fitness"],
                               rtol=0, atol=1e-5)
    dev = card.validate_device(thetas[0].cuda(), card.device_val_consts())
    assert float(dev) == card.validate(thetas[0].cuda()) == \
        cpu.validate(thetas[0])


@pytest.mark.cuda
def test_mnist_member_bits_do_not_depend_on_chunk(mnist_tasks):
    """A member's fitness on the card has the same bits in rollouts of 3,
    30 and 60 members, at places 0, 2, 27 and 52, on its own batch and on
    a shared one."""
    task = mnist_tasks(True)
    thetas, idx = _mnist_members(task, 60, seed=1)
    thetas, idx = thetas.cuda(), idx.cuda()
    for rows in (idx, idx[0]):
        whole = task.rollout(thetas, rows)["fitness"]
        for lo, n in ((0, 3), (2, 3), (25, 30), (27, 30), (50, 3)):
            part = task.rollout(thetas[lo:lo + n],
                                rows if rows.dim() == 1 else rows[lo:lo + n])
            assert torch.equal(part["fitness"], whole[lo:lo + n]), (lo, n)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_mnist_sensitivity_rows_bitwise_repeatable(mnist_tasks, precision):
    """SM-G-SUM through the MNIST forward (vbn) on the card: the rows of 3
    parents are the same bits on a second sweep and each is that parent's
    sweep alone; f32 rows within rtol 2e-4 of the CPU's."""
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivities,
    )

    task, cpu = mnist_tasks(True), mnist_tasks(True, "cpu")
    thetas, _ = _mnist_members(task, 3, seed=2)
    idx = torch.arange(12)
    kind = MutationKind.SAFE_GRAD_SUM
    first = calc_sensitivities(task, thetas.cuda(), idx.cuda(), kind, 0.2,
                               precision)
    again = calc_sensitivities(task, thetas.cuda(), idx.cuda(), kind, 0.2,
                               precision)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    for i in range(3):
        alone = calc_sensitivities(task, thetas[i:i + 1].cuda(), idx.cuda(),
                                   kind, 0.2, precision)
        assert torch.equal(alone[0].view(torch.int32),
                           first[i].view(torch.int32))
    assert torch.isfinite(first).all() and (first > 1).any()
    if precision == "float32":
        want = calc_sensitivities(cpu, thetas, idx, kind, 0.2)
        torch.testing.assert_close(first.cpu(), want, rtol=2e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k1_on_torch_order_members_both_layouts(card_task, dtype):
    """K1 on torch-order members laid out by prepare_decode_params, one
    member at a time, equals K1 on to_dec + prep of the same members, bit
    for bit; a host-scored task's rollout returns those tokens (int16)."""
    task = card_task("greedy", device_cider=False)
    assert task._fused and task.decode_layout is None
    assert not task.fitness_on_device
    lay, opts = task._layout, task.model.options
    g = torch.Generator(device="cuda").manual_seed(7)
    thetas = torch.stack([task.spec.init_theta(g) * (2 + i)
                          for i in range(3)])
    idx = torch.randint(0, 64, (3, 40), generator=g, device="cuda")
    feats = task.train_fc[idx]
    by_layout = lay.prep(lay.to_dec(thetas), dtype)
    per_member = [tdc.prepare_decode_params(task.spec, th, opts, dtype)
                  for th in thetas]
    stacked = {k: torch.stack([p[k] for p in per_member])
               for k in per_member[0]}
    seq_a, lp_a = tdc.decode_fused(by_layout, feats, 16, True)
    seq_b, lp_b = tdc.decode_fused(stacked, feats, 16, True)
    assert torch.equal(seq_a, seq_b) and torch.equal(lp_a, lp_b)
    if dtype == torch.float32:
        art = task.rollout(thetas, idx)
        assert art["seq"].dtype == torch.int16
        assert torch.equal(art["seq"].int(), seq_a)


NORM_FLAGS = {"vbn": ({"vbn": True}, {}),
              "vbn_e_affine": ({}, {"vbn_e": True, "vbn_affine": True}),
              "layer_n": ({}, {"layer_n": True})}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(NORM_FLAGS))
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_eager_decoder_card_matches_cpu(card_task, variant, greedy):
    """The eager decoder of the norm variants (f32, TF32 off) on the card
    against the same members on the CPU: tokens equal, lp within 1e-4."""
    popts, mopts = NORM_FLAGS[variant]
    task = card_task("greedy", popts=popts, mopts=mopts)
    assert not task._fused and task.decode_layout is None
    g = torch.Generator(device="cuda").manual_seed(8)
    thetas = torch.stack([task.spec.init_theta(g) for _ in range(4)])
    feats = task.train_fc[torch.randint(0, 64, (4, 48), generator=g,
                                        device="cuda")]
    gumbel = None if greedy else -torch.log(-torch.log(torch.rand(
        (4, 16, 48, 301), generator=g, device="cuda") * 0.999 + 5e-4))
    seq, lp = task.model.sample_members(thetas, feats, greedy, gumbel)
    seq_h, lp_h = task.model.sample_members(
        thetas.cpu(), feats.cpu(), greedy,
        None if greedy else gumbel.cpu())
    assert torch.equal(seq.cpu(), seq_h)
    assert float((lp.cpu() - lp_h).abs().max()) < 1e-4
    assert len(torch.unique(seq_h)) > 2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_vbn_sensitivity_rows_bitwise_repeatable(card_task, precision):
    """test_sensitivity_rows_bitwise_repeatable for the vbn captioner: its
    batch statistics are over one parent's rows, so each row of a sweep of
    3 parents is that parent's sweep alone bit for bit, and a second sweep
    repeats the matrix."""
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivities,
    )

    task = card_task("greedy", popts={"vbn": True})
    parents, rows = _sens_inputs(task, 3)
    idx = torch.as_tensor(rows, device="cuda")
    kind = MutationKind.SAFE_GRAD_SUM
    first = calc_sensitivities(task, parents, idx, kind, 0.01, precision)
    again = calc_sensitivities(task, parents, idx, kind, 0.01, precision)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    for i in range(3):
        alone = calc_sensitivities(task, parents[i:i + 1], idx, kind, 0.01,
                                   precision)
        assert torch.equal(alone[0].view(torch.int32),
                           first[i].view(torch.int32))
    assert torch.isfinite(first).all() and (first > 1).any()


@pytest.mark.cuda
def test_test_split_f32_row_block_matches_plain_twin(card_task, tmp_path):
    """The test split of 300 rows (blocks of 128, 128 and 44) at f32:
    ``test_score`` and ``evaluate_checkpoints`` each decode it in one
    row-block launch of K1, whose tokens equal the plain twin's (lp within
    2e-5), and evaluate_checkpoints' captions are those tokens."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )
    from nes_img_captioning_tpu_torch.eval_on_test import evaluate_checkpoints
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    data = CocoData.from_arrays(synthetic_coco_arrays(
        n_train=16, n_val=8, n_test=300, vocab_size=300, fc_feat_size=256,
        cap_len=9, seed=1))
    exp = {"dataset": "mscoco", "policy_options": {
        "fitness": "greedy", "vbn": False, "model_options": {
            "input_encoding_size": 128, "rnn_size": 128,
            "fc_feat_size": 256}}}
    task = CocoTask(exp, Config(batch_size=8), TpuConfig(seed=0),
                    device="cuda", data=data)
    g = torch.Generator(device="cuda").manual_seed(6)
    theta = task.spec.init_theta(g) * 3
    params = tdc.prepare_decode_params(task.spec, theta, task.model.options,
                                       dtype=torch.float32)
    seq_k, lp_k = tdc.decode_rows(params, task.test_fc, need_logprobs=True)
    seq_p, lp_p = tdc.decode_rows_plain(params, task.test_fc)
    torch.cuda.synchronize()
    assert torch.equal(seq_k, seq_p)
    assert float((lp_k - lp_p).abs().max()) < 2e-5
    before = tdc.decode_rows.launches
    score = task.test_score(theta)
    path = str(tmp_path / "m.pth")
    task.spec.save_pth(theta, path)
    out = evaluate_checkpoints({"m": path}, {}, num=300, fc_feat_size=256,
                               data=data, device="cuda")
    assert tdc.decode_rows.launches == before + 2
    assert [p["caption"] for p in out["preds_per_model"]["m"]] == \
        data.decode_sequence(seq_p.cpu().numpy())
    assert np.isfinite(score)
    assert out["stats"]["m"]["CIDEr"] == pytest.approx(score, abs=1e-9)


@pytest.mark.cuda
def test_xent_gradient_card_matches_cpu(card_task):
    """xent_loss and its autograd gradient on 32 train images, TF32 off:
    the card's within rtol 1e-5 of the CPU's loss and rtol 1e-4 plus 1e-6
    of the largest element of its gradient (f32 sums in cuBLAS's order)."""
    from nes_img_captioning_tpu_torch.pretrain import xent_loss

    task = card_task("greedy")
    g = torch.Generator(device="cuda").manual_seed(2)
    theta0 = task.spec.init_theta(g)
    caps = torch.as_tensor(np.stack([np.asarray(c[0], np.int32)
                                     for c in task.train_gts[:32]]))
    out = {}
    for dev in ("cuda", "cpu"):
        theta = theta0.to(dev).clone().requires_grad_()
        loss = xent_loss(task.model, theta, task.train_fc[:32].to(dev),
                         caps.to(dev))
        loss.backward()
        out[dev] = (loss.item(), theta.grad.cpu())
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    np.testing.assert_allclose(g_card.numpy(), g_cpu.numpy(), rtol=1e-4,
                               atol=1e-6 * float(g_cpu.abs().max()))


@pytest.mark.cuda
def test_profile_summary_finds_a_cuda_kernel(small_members, tmp_path):
    """A torch.profiler trace of one row-block launch, exported as the
    masters export ``tpu.profile``'s: profile_summary lists the member
    kernel once with its device time, and an idle share in [0, 1)."""
    from nes_img_captioning_tpu_torch.utils import profile_summary

    lay, members, _, _ = small_members
    params = lay.prep(members[0], torch.float32)
    feats = torch.randn((300, 256), device="cuda")
    tdc.decode_rows(params, feats)  # build and load outside the trace
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tdc.decode_rows(params, feats)
        torch.cuda.synchronize()
    path = tmp_path / "profile" / "trace_1.pt.trace.json"
    path.parent.mkdir()
    prof.export_chrome_trace(str(path))
    out = profile_summary.summarize(profile_summary.find_trace(
        str(tmp_path)))
    rows = [r for r in out["rows"] if "member_kernel" in r[0]]
    assert len(rows) == 1 and rows[0][2] == 1 and rows[0][1] > 0
    assert 0.0 <= out["idle"] < 1.0


# ---- the kernels at E = R = 256 and 512 (one library per width), and
# captioners zero-padded to them (DecodeLayout(pad=True), kernel_shape) ----


@pytest.fixture(params=[(256, 256, 256), (512, 512, 256), (300, 512, 2048),
                        (256, 192, 960), (1024, 1024, 256),
                        (1000, 1000, 2048)],
                ids=["w256", "w512", "P1", "P2", "w1024", "P3"])
def wide_members(request):
    """Two members and a delta at E = R = 256, 512 or 1024, or at (E, R,
    F) = (300, 512, 2048), (256, 192, 960) and (1000, 1000, 2048) laid out
    padded to W = 512, 256 and 1024 (P2's features to 1024), vocab 300
    (padded to 384), 100 rows: 2, 4 or 7 row blocks of 64, 32 or 16 rows
    per member, the last ragged. Returns (W, layout, members, feats at the
    model's F, delta)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    E, R, F = request.param
    opts = FCModelOptions(vocab_size=300, fc_feat_size=F,
                          input_encoding_size=E, rnn_size=R)
    lay = DecodeLayout(build_spec(opts), opts, pad=True)
    width = lay.sizes["R"]
    g = torch.Generator(device="cuda").manual_seed(E + R + F)
    theta = lay.spec.init_theta(g) * 3
    feats = torch.randn((2, 100, F), generator=g, device="cuda")
    members = torch.stack([lay.to_dec(theta), lay.to_dec(theta * 0.5)])
    sc = lay.to_dec(torch.full_like(theta, 0.05), pad_scale=0.0)
    delta = (sc * torch.randn(lay.dim_dec, generator=g, device="cuda")
             ).to(torch.bfloat16)
    return width, lay, members, feats, delta


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [100, 37], ids=["rows100", "rows37"])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_wide_member_kernel_matches_plain_twin(wide_members, kernel, rows,
                                               dt):
    """K1 (K4 at vocab tile 128) at E = R = 256 and 512 (and P1, P2 padded
    to them) over 100 rows
    (row blocks of 64 or 32, the last ragged) and a partial batch of 37:
    f32 tokens equal the plain twin's, lp within 2e-5; bf16 rows differ
    only at near-ties; K4's tokens are K1's bit for bit; the launch shape
    reports the width's rows per cluster and at least 2 ring slots."""
    width, lay, members, feats, _ = wide_members
    params = lay.prep(members, dt)
    _member_held_to_plain(params, feats[:, :rows].contiguous(), kernel, dt)
    info = tdc.member_cluster_info(dt, width=width)
    assert info["rows"] == 128 * 128 // width and info["ring_slots"] >= 2
    assert info["smem_bytes"] <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ddt", [torch.float32, torch.bfloat16],
                         ids=["delta_f32", "delta_bf16"])
def test_wide_k2_pad_lanes_and_k5(wide_members, ddt, dt):
    """K2 at E = R = 256 and 512 (and P1, P2 padded to them) on 3 pairs
    whose last repeats the second (the engine's pad lane): every (pair,
    sign) bitwise K1 on prep(base ± delta) in tokens, lp within 2e-5; the
    pad pair's outputs equal the pair it repeats bit for bit; K5 is bitwise
    K2 fed K7's dump, which is exactly 0 at every pad of the layout."""
    width, lay, members, feats, delta = wide_members
    base = lay.prep(members[0], torch.float32)
    d = lay.prep(torch.stack([delta.float(), 2 * delta.float(),
                              2 * delta.float()]), torch.float32)
    d = {k: v.to(ddt) if k not in tdc._BIASES else v for k, v in d.items()}
    f3 = torch.stack([feats[0], feats[1], feats[1]])
    seq2, lp2 = tdc.decode_pair_perturb(base, d, f3, dtype=dt,
                                        need_logprobs=True)
    _held_to_k1(base, d, f3, dt, seq2, lp2)
    assert torch.equal(seq2[2], seq2[1]) and torch.equal(lp2[2], lp2[1])
    info = tdc.pair_cluster_info(dt, ddt, width=width)
    assert info["rows"] == 128 * 128 // width and info["ring_slots"] >= 2
    sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05, device="cuda"),
                    pad_scale=0.0)
    scale = lay.prep(sc, torch.float32)
    dump = tdc.pair_delta_dump(scale, [3, 4])
    seq5, lp5 = tdc.decode_pair_rng(base, scale, [3, 4], feats, dtype=dt,
                                    need_logprobs=True)
    seq_d, lp_d = tdc.decode_pair_perturb(base, dump, feats, dtype=dt,
                                          need_logprobs=True)
    assert torch.equal(seq5, seq_d) and torch.equal(lp5, lp_d)
    pads = lay.to_dec(torch.ones(lay.spec.num_params, device="cuda"),
                      pad_scale=0.0) == 0
    for i in range(2):
        flat = lay.flat_dec({k: v[i] for k, v in dump.items()})
        assert (flat[pads] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_k3_and_row_blocks(wide_members, dt):
    """K3 at E = R = 256 and 512 (and P1, P2 padded to them), 2 lanes per
    member over 100 rows: the
    host-table form bitwise its plain twin's tokens (f32: lp within 2e-5),
    the seeded form bitwise the host-table form fed the stream's table
    (each cluster draws at its rows' absolute index); decode_rows over 150
    rows bitwise decode_fused per block of 128."""
    width, lay, members, feats, _ = wide_members
    params = lay.prep(members, dt)
    B, Vpad, T = feats.shape[1], lay.Vpad, 16
    seeds = np.array([[1, 0xFFFFFFFF], [7, 8]], np.uint32)
    table = torch.stack([torch.stack([
        torch.stack([tdc.gumbel_table(int(s), t, B, Vpad, "cuda")
                     for t in range(T)]) for s in row]) for row in seeds])
    seq_t, lp_t = tdc.decode_fused(params, feats, greedy=False, gumbel=table)
    seq_s, lp_s = tdc.decode_fused(params, feats, greedy=False, seeds=seeds)
    seq_p, lp_p, gap_p = tdc.decode_sample_plain(params, feats, gumbel=table,
                                                 top2_gap=True)
    torch.cuda.synchronize()
    assert torch.equal(seq_s, seq_t) and torch.equal(lp_s, lp_t)
    if dt == torch.float32:
        assert torch.equal(seq_t, seq_p)
        assert float((lp_t - lp_p).abs().max()) < 2e-5
    else:
        _first_diffs_at_near_ties(seq_t, seq_p, gap_p)
    one = lay.prep(members[0], dt)
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = torch.randn((150, feats.shape[-1]), generator=g, device="cuda")
    seq, lp = tdc.decode_rows(one, rows, need_logprobs=True)
    blocks = [tdc.decode_fused(one, rows[lo:lo + 128]) for lo in (0, 128)]
    torch.cuda.synchronize()
    assert torch.equal(seq, torch.cat([b[0] for b in blocks]))
    assert torch.equal(lp, torch.cat([b[1] for b in blocks]))

"""The decode kernels' plain twins at E = R = 256 and 512 (the widths of the
JAX package's scripts/exp_model_scale.py) and 1024 against the JAX
package's Pallas kernels in interpret mode, and the checks that send a
captioner of these widths to the kernels on the card: toy vocabularies,
256-d features (128 at 1024), a few rows. The kernels themselves are held
to these twins on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
[34], [38])."""

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

WIDTHS = [256, 512]
FEAT, T = 256, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.array(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _setup(width, vocab=50, seed=3, feat=FEAT):
    jm = JaxFCModel(JaxOptions(vocab_size=vocab, fc_feat_size=feat,
                               input_encoding_size=width, rnn_size=width))
    theta = np.array(jm.spec.init_theta(jax.random.PRNGKey(seed)))
    topts = FCModelOptions(vocab_size=vocab, fc_feat_size=feat,
                           input_encoding_size=width, rnn_size=width)
    return jm, theta, build_spec(topts), topts


def _feats(rows=8, seed=1, feat=FEAT):
    return np.random.default_rng(seed).normal(size=(rows, feat)).astype(
        np.float32)


@pytest.mark.parametrize("width", WIDTHS)
def test_prepare_params_and_layout_match_jax(width):
    """prepare_decode_params and the decode layout (to_dec, from_dec, prep)
    equal the JAX package's at the width, bit for bit."""
    jm, theta, spec, topts = _setup(width)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options)
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    jl, tl = JaxLayout(jm.spec, jm.options), DecodeLayout(spec, topts)
    assert tl.dim_dec == jl.dim_dec
    th = torch.from_numpy(theta)
    np.testing.assert_array_equal(_np(tl.to_dec(th, 0.0)),
                                  _np(jl.to_dec(jnp.asarray(theta), 0.0)))
    vec = np.random.default_rng(0).normal(size=tl.dim_dec).astype(np.float32)
    np.testing.assert_array_equal(_np(tl.from_dec(torch.from_numpy(vec))),
                                  _np(jl.from_dec(jnp.asarray(vec))))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jq, tq = jl.prep(jnp.asarray(vec), jdt), tl.prep(
            torch.from_numpy(vec), tdt)
        for k in jq:
            np.testing.assert_array_equal(_np(tq[k]), _np(jq[k]), err_msg=k)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_k1_twin_matches_pallas(width, dt):
    """K1's plain twin against JAX decode_fused (interpret): tokens equal;
    lp within 2e-5 at f32 (1e-3 at bf16, where an f32-level difference in
    h can move its bf16 rounding)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jm, theta, spec, topts = _setup(width)
    feats = _feats()
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options,
                                   dtype=jdt)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), interpret=True)
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts,
                                   dtype=tdt)
    seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats))
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j),
                               atol=2e-5 if dt == "f32" else 1e-3)
    assert (seq_t > 0).any()


@pytest.mark.parametrize("width", WIDTHS)
def test_k2_twin_matches_pallas_on_the_same_deltas(width):
    """K2's plain twin against JAX decode_pair_perturb (interpret) on the
    same realized f32 delta: tokens equal, lp within 2e-5; each sign
    token-equal to K1's twin on prep(base ± delta)."""
    jm, theta, spec, topts = _setup(width)
    jl = JaxLayout(jm.spec, jm.options)
    base_vec = jl.to_dec(jnp.asarray(theta))
    sc = jl.to_dec(jnp.full((jm.spec.num_params,), 0.05, jnp.float32),
                   pad_scale=0.0)
    delta = sc * jax.random.normal(jax.random.PRNGKey(9), (jl.dim_dec,),
                                   jnp.float32)
    feats = _feats()
    seq_j, lp_j = jdp.decode_pair_perturb(
        jl.prep(base_vec, jnp.float32), jl.prep(delta, jnp.float32),
        jnp.asarray(feats), dtype=jnp.float32, interpret=True,
        need_logprobs=True)
    tl = DecodeLayout(spec, topts)
    base_t = torch.from_numpy(_np(base_vec))
    delta_t = torch.from_numpy(_np(delta))
    seq_t, lp_t = tdc.decode_pair_perturb(
        tl.prep(base_t, torch.float32), tl.prep(delta_t, torch.float32),
        torch.from_numpy(feats), need_logprobs=True)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=2e-5)
    for s, sign in ((0, 1.0), (1, -1.0)):
        seq1, _ = tdc.decode_fused(
            tl.prep(base_t + sign * delta_t, torch.float32),
            torch.from_numpy(feats))
        assert torch.equal(seq_t[s], seq1)


@pytest.mark.parametrize("width", WIDTHS)
def test_k3_twin_matches_pallas_on_a_host_table(width):
    """K3's plain twin (the host-table form) against JAX decode_fused(greedy
    =False, host_rng=True) on the same numpy Gumbel table: tokens equal, lp
    within 2e-5."""
    jm, theta, spec, topts = _setup(width)
    feats = _feats(6)
    Vpad = tdc.pad_vocab(51)
    g = np.random.default_rng(4).gumbel(size=(T, 6, Vpad)).astype(np.float32)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), greedy=False,
                                   interpret=True, host_rng=True,
                                   gumbel=jnp.asarray(g))
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts)
    seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats), greedy=False,
                                   gumbel=torch.from_numpy(g)[None])
    np.testing.assert_array_equal(seq_t[0].numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t[0].numpy(), np.asarray(lp_j), atol=2e-5)


@pytest.mark.parametrize("width", WIDTHS)
def test_k4_twin_matches_pallas_at_a_vocab_tile(width):
    """K4's plain twin at vocab 130 (Vpad 256, two tiles of 128) against
    JAX decode_fused(vocab_tile=128): tokens equal and K1's, lp within
    2e-5."""
    jm, theta, spec, topts = _setup(width, vocab=130)
    feats = _feats()
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), interpret=True,
                                   vocab_tile=128)
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts)
    seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats),
                                   vocab_tile=128)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=2e-5)
    assert torch.equal(seq_t, tdc.decode_fused(tp, torch.from_numpy(feats))[0])


def _finish_steps(seq):
    """The step on which each row first emits 0 (T when it never does)."""
    zero = seq == 0
    return torch.where(zero.any(-1), zero.int().argmax(-1), seq.shape[-1])


@pytest.mark.parametrize("width", WIDTHS)
def test_twin_exits_per_cluster_of_rows(width):
    """At these widths too every row of a batch shares one early exit (the
    JAX kernel's; the kernels' cluster holds all of the batch's blocks of
    cluster_rows(width) rows). Over 100 rows whose blocks end at different
    steps, a row that has ended writes token 0 and its argmax lp (< 0)
    while another row decodes, and every output after the batch's last
    row has ended is 0; decode_rows over the same rows (one block of 128)
    gives the same outputs. A batch whose rows all end at step 0 leaves
    steps 1 and later at 0."""
    jm, theta, spec, topts = _setup(width, seed=5)
    rows = tdc.cluster_rows(width)
    feats = torch.from_numpy(_feats(100, seed=2))
    feats[rows:] *= 0.0  # the other blocks: the same rows, zero features
    eos = jm.spec.offset("logit.bias")

    def params(boost):
        boosted = theta.copy()
        boosted[eos] += boost
        return tdc.prepare_decode_params(spec, torch.from_numpy(boosted),
                                         topts)

    def decode(boost):
        tp = params(boost)
        return tp, tdc.decode_fused(tp, feats)

    # the EOS bias at which the other blocks (their rows end together) end
    # longest before the first block, whose last row still ends in time:
    # the 13 boosts as 13 members of one decode of the first block and one
    # row of the others (each member its own batch, its own exit)
    boosts = np.linspace(0.0, 0.3, 13)
    scan = [params(float(b)) for b in boosts]
    seq_s, _ = tdc.decode_fused(
        {k: torch.stack([p[k] for p in scan]) for k in scan[0]},
        feats[:rows + 1].expand(len(boosts), -1, -1))
    best = None
    for boost, steps in zip(boosts, _finish_steps(seq_s)):
        gap = int(steps[:rows].max() - steps[rows:].max())
        if steps.max() < T - 1 and (best is None or gap > best[0]):
            best = (gap, float(boost))
    assert best[0] > 0, best
    tp, (seq, lp) = decode(best[1])
    steps = _finish_steps(seq)
    last = int(steps.max())
    t = torch.arange(T)
    past = (t[None] > steps[:, None]) & (t[None] <= last)
    assert past[rows:].any(-1).all()  # a block ended while another decodes
    assert (seq[past] == 0).all() and (lp[past] < 0).all()
    assert (seq[:, last + 1:] == 0).all() and (lp[:, last + 1:] == 0).all()
    seq_r, lp_r = tdc.decode_rows(tp, feats)
    assert torch.equal(seq_r, seq) and torch.equal(lp_r, lp)
    _, (seq, lp) = decode(8.0)  # EOS: every row ends at step 0
    assert (seq == 0).all() and (lp[:, 1:] == 0).all() and (lp[:, 0] < 0).all()


@pytest.mark.parametrize("width,rows", [(256, 80), (512, 48)])
def test_twin_past_one_cluster_matches_pallas(width, rows):
    """A batch of more rows than one block of cluster_rows(width) holds (2
    blocks here), f32: K1's and K3's (host-table) plain twins against
    JAX's kernels in interpret mode, whose batch shares one early exit, as
    the port's does. Tokens equal everywhere and lp within 2e-5 at every
    position, also past each row's EOS, where a finished row writes its
    argmax lp while another row decodes on; this batch has such
    positions (its rows end apart)."""
    jm, theta, spec, topts = _setup(width, seed=7)
    boosted = theta.copy()
    boosted[jm.spec.offset("logit.bias")] += 0.05  # EOS: rows end apart
    feats = _feats(rows, seed=6)
    Vpad = tdc.pad_vocab(51)
    g = np.random.default_rng(5).gumbel(size=(T, rows, Vpad)).astype(
        np.float32)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(boosted), jm.options)
    tp = tdc.prepare_decode_params(spec, torch.from_numpy(boosted), topts)
    outs = {
        "K1": (jdp.decode_fused(jp, jnp.asarray(feats), interpret=True),
               tdc.decode_fused(tp, torch.from_numpy(feats))),
        "K3": (jdp.decode_fused(jp, jnp.asarray(feats), greedy=False,
                                interpret=True, host_rng=True,
                                gumbel=jnp.asarray(g)),
               [o[0] for o in tdc.decode_fused(
                   tp, torch.from_numpy(feats), greedy=False,
                   gumbel=torch.from_numpy(g)[None])])}
    past_eos = 0
    for name, ((seq_j, lp_j), (seq_t, lp_t)) in outs.items():
        seq_j, lp_j = np.asarray(seq_j), np.asarray(lp_j)
        seq_t, lp_t = seq_t.numpy(), lp_t.numpy()
        np.testing.assert_array_equal(seq_t, seq_j, err_msg=name)
        np.testing.assert_allclose(lp_t, lp_j, atol=2e-5, err_msg=name)
        ended = np.cumsum(seq_t == 0, axis=1)
        after = (ended > 1) | ((ended == 1) & (seq_t != 0))  # past EOS
        past_eos += int((after & (lp_j != 0)).sum())
    assert past_eos > 0


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_w1024_twins_match_pallas(kernel):
    """E = R = 1024, the widest library (vocab 60, 128-d features, T = 6),
    f32, over B = 48 rows: three blocks of cluster_rows(1024) = 16, the
    last one's features zeroed and the EOS bias raised by 0.05, so that
    block ends at step 0 while the others decode on. K1's and K2's plain
    twins (K2 on JAX's realized delta) against JAX's decode_fused and
    decode_pair_perturb in interpret mode, whose batch (each sign's) shares
    one early exit, as the kernels' cluster does: tokens equal and lp
    within 2e-5 at every position, also past a row's EOS, where a finished
    row writes its argmax lp while the batch decodes on (such positions
    exist here)."""
    W, F, T6, B = 1024, 128, 6, 48
    jm, theta, spec, topts = _setup(W, vocab=60, seed=7, feat=F)
    assert tdc.cluster_rows(W) == 16
    boosted = theta.copy()
    boosted[jm.spec.offset("logit.bias")] += 0.05
    feats = _feats(B, seed=6, feat=F)
    feats[32:] = 0.0
    if kernel == "K1":
        jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(boosted),
                                       jm.options)
        seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), T6,
                                       interpret=True)
        tp = tdc.prepare_decode_params(spec, torch.from_numpy(boosted),
                                       topts)
        seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats), T6)
    else:
        jl = JaxLayout(jm.spec, jm.options)
        base_vec = jl.to_dec(jnp.asarray(boosted))
        sc = jl.to_dec(jnp.full((jm.spec.num_params,), 0.01, jnp.float32),
                       pad_scale=0.0)
        delta = sc * jax.random.normal(jax.random.PRNGKey(9), (jl.dim_dec,),
                                       jnp.float32)
        seq_j, lp_j = jdp.decode_pair_perturb(
            jl.prep(base_vec, jnp.float32), jl.prep(delta, jnp.float32),
            jnp.asarray(feats), T6, dtype=jnp.float32, interpret=True,
            need_logprobs=True)
        tl = DecodeLayout(spec, topts)
        seq_t, lp_t = tdc.decode_pair_perturb(
            tl.prep(torch.from_numpy(_np(base_vec)), torch.float32),
            tl.prep(torch.from_numpy(_np(delta)), torch.float32),
            torch.from_numpy(feats), T6, need_logprobs=True)
    seq_j, lp_j = np.asarray(seq_j), np.asarray(lp_j)
    np.testing.assert_array_equal(seq_t.numpy(), seq_j)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, atol=2e-5)
    steps = _finish_steps(seq_t)
    t = torch.arange(T6)
    past = (t > steps[..., None]) & (t <= steps.max(-1, keepdim=True)
                                     .values[..., None])
    assert past.any() and (np.abs(lp_j[past.numpy()]) > 0).any()


def test_cluster_rows_and_param_checks():
    """cluster_rows and _check_params take the built widths (E = R in 128,
    256, 512, 1024, any feature width that is a multiple of 128) and refuse
    unpadded shapes with a message that names them and kernel_shape; past
    the width check a CPU tensor is refused for not being on the card."""
    assert [tdc.cluster_rows(w) for w in tdc.KERNEL_WIDTHS] == [128, 64, 32,
                                                                16]
    with pytest.raises(ValueError, match="E = R in"):
        tdc.cluster_rows(192)

    def params(E, R, F=256, V=256):
        return {"img_w": torch.zeros(1, F, E), "img_b": torch.zeros(1, 1, E),
                "i2h_w": torch.zeros(1, E, 5 * R),
                "i2h_b": torch.zeros(1, 1, 5 * R),
                "h2h_w": torch.zeros(1, R, 5 * R),
                "h2h_b": torch.zeros(1, 1, 5 * R),
                "logit_w": torch.zeros(1, R, V),
                "logit_b": torch.zeros(1, 1, V),
                "embed": torch.zeros(1, V, E)}

    for w in tdc.KERNEL_WIDTHS:
        with pytest.raises(ValueError, match="is not a CUDA tensor"):
            tdc._check_params(params(w, w), 1, 256, torch.float32)
        with pytest.raises(ValueError, match="is not a CUDA tensor"):
            tdc._check_params(params(w, w, F=384), 1, 384, torch.float32)
    for E, R, F in ((192, 192, 256), (256, 128, 256), (16, 16, 256)):
        with pytest.raises(ValueError, match=r"E = R in \(128, 256, 512, "
                           r"1024\); "
                           r"lay the model out padded to kernel_shape"):
            tdc._check_params(params(E, R, F), 1, F, torch.float32)
    with pytest.raises(ValueError, match="multiple of 128; lay the model "
                       "out padded to kernel_shape"):
        tdc._check_params(params(256, 256, F=200), 1, 200, torch.float32)


@pytest.mark.parametrize("widths,ok", [
    ((256, 256, 256), True), ((512, 512, 2048), True),
    ((192, 192, 256), True), ((256, 128, 256), True),
    ((256, 256, 200), True), ((1024, 1024, 2048), True),
    ((300, 513, 2048), True), ((1025, 1025, 2048), False),
    ((300, 2048, 2048), False)],
    ids=["E256", "E512", "E192", "E_ne_R", "F200", "W1024", "R513", "E1025",
         "R2048"])
def test_resolve_fused_on_the_card(widths, ok):
    """On a CUDA device a no-norm captioner of E, R <= 1024 and any feature
    width goes to the kernels (laid out at kernel_shape; 513-1024 at the
    1024 library); a wider one raises under "auto" and true with a message
    that names 1024; false decodes eagerly."""
    from nes_img_captioning_tpu_torch.tasks.captioning import resolve_fused

    E, R, F = widths
    o = FCModelOptions(vocab_size=50, input_encoding_size=E, rnn_size=R,
                       fc_feat_size=F)
    card = torch.device("cuda")
    for want in ("auto", True):
        if ok:
            assert resolve_fused(o, want, card) is True
        else:
            with pytest.raises(ValueError, match="E and R up to 1024.*"
                               "fused_decode: false"):
                resolve_fused(o, want, card)
    assert resolve_fused(o, False, card) is False
    assert resolve_fused(o, "auto", torch.device("cpu")) is True


@pytest.mark.parametrize("width", WIDTHS)
def test_generation_matches_jax_on_the_same_deltas(width, tmp_path):
    """One NIC-NES generation at the width with SGD: the port's pair-kernel
    path (the plain twins) against the JAX package's (interpret mode), on
    the same theta, batches and realized deltas: fitnesses within 1e-5,
    theta within 1e-6."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JNES
    from nes_img_captioning_tpu.algorithms.optimizers import SGD as JSGD
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JMK
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import SGD
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    F, B, sigma, step, l2 = 2, 4, 0.05, 0.01, 1e-7
    copts = make_synthetic_coco(str(tmp_path), n_train=8, n_val=4, n_test=4,
                                vocab_size=40, fc_feat_size=FEAT, cap_len=6,
                                seed=0)
    exp = {"dataset": "mscoco", "caption_options": copts,
           "policy_options": {"fitness": "greedy", "model_options": {
               "input_encoding_size": width, "rnn_size": width,
               "fc_feat_size": FEAT}},
           "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"}}
    jtask = JTask(exp, JConfig(batch_size=B), jp(exp))
    jtask._fused_interpret = True
    jeng = JNES(jtask, JSGD(step, 0.9), JMK.DEFAULT, pop_chunk=2)
    rng = np.random.default_rng(8)
    seeds = rng.integers(0, 2**32, size=F, dtype=np.uint32)
    idx = rng.integers(0, 8, size=(F, B)).astype(np.int32)
    theta = jtask.generate_theta(jax.random.PRNGKey(6))
    sens = jnp.ones((jeng.dim,), jnp.float32)
    art, deltas = jeng.eval_generation(theta, sens, sigma, seeds, idx)
    fits_j = np.asarray(jtask.host_fitness(art, idx))
    _, theta_j, _ = jeng.update(theta, jeng.optimizer.init(jeng.dim), sens,
                                sigma, seeds, jnp.asarray(fits_j), step, l2,
                                deltas=deltas)
    deltas = np.asarray(deltas).reshape(-1, jeng.dim)[:F]

    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu")
    eng = NESEngine(task, SGD(step, 0.9), MutationKind.DEFAULT, pop_chunk=2,
                    kernel_perturb=True)
    lay = task.decode_layout
    by_seed = {int(s): lay.to_dec(torch.from_numpy(d.copy()), pad_scale=0.0)
               for s, d in zip(seeds, deltas)}
    eng.delta_of = lambda scale_dec, seed: by_seed[int(seed)]
    th0 = torch.from_numpy(np.asarray(theta).copy())
    th, _, packed = eng.generation(
        th0, eng.optimizer.init(eng.dim, "cpu"), torch.ones_like(th0),
        sigma, seeds, idx, step, l2)
    fits = eng.unpack(packed, F)[0]
    np.testing.assert_allclose(fits, fits_j, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(theta_j), atol=1e-6)
    assert not torch.equal(th, th0)

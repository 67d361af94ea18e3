"""Batches above the kernels' 128 rows: the port's task decodes them in row
blocks of at most 128, one launch each, and K3's blocks draw the Gumbel
stream of one launch over all rows (its row offset ``row0``). On the CPU
the wrappers run their plain twins, which take any batch: the split
rollouts must equal the unsplit plain decode of all rows, and with lp the
JAX package's one launch over all rows (the batch's one early exit). Toy
size (vocab 40, E = R = 16, 24-d features; vocab 50, E = R = 128, 256-d
features against JAX), B = 256."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu.ops import decode_pallas as jdp
from nes_img_captioning_tpu.ops.decode_layout import DecodeLayout as JaxLayout
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.noise import gumbel_plain

from torch_pin import one_intra_op_thread  # noqa: F401

B, T = 256, 16


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_rows")
    return make_synthetic_coco(str(d), n_train=12, n_val=4, n_test=4,
                               vocab_size=40, fc_feat_size=24, cap_len=6,
                               seed=0)


def _exp(copts, kind, enc=16, feat=24):
    return {
        "dataset": "mscoco",
        "caption_options": copts,
        "policy_options": {"fitness": kind, "vbn": False, "model_options": {
            "input_encoding_size": enc, "rnn_size": enc,
            "fc_feat_size": feat}},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"},
    }


def _task(copts, kind, device="cpu", pad=None, **widths):
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = _exp(copts, kind, **widths)
    return CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device=device, pad=pad)


def _members(task, n=2):
    lay = task.decode_layout
    theta = task.generate_theta(torch.Generator().manual_seed(4)) * 3
    return torch.stack([lay.to_dec(theta * (1 - 0.25 * i)) for i in range(n)])


@pytest.fixture
def launches(monkeypatch):
    """The rows of every decode call the task makes, by wrapper."""
    seen = []
    # the position of each wrapper's feats argument
    for name, at in (("decode_fused", 1), ("decode_pair_perturb", 2),
                     ("decode_pair_rng", 3)):
        orig = getattr(tdc, name)

        def wrapped(*a, _orig=orig, _name=name, _at=at, **kw):
            seen.append((_name, a[_at].shape[-2]))
            return _orig(*a, **kw)

        monkeypatch.setattr(tdc, name, wrapped)
    return seen


def test_gumbel_row_offset_draws_the_full_batch():
    """gumbel_plain(row0=r) is rows r.. of the table of the whole batch, and
    the plain K3 over rows [128, 256) at row0 128 samples the tokens that
    the unsplit 256-row decode samples there."""
    seeds = torch.tensor([[3, 0xFFFFFFFF], [7, 11]])
    full = gumbel_plain(seeds, 5, B, 128)
    for row0, rows in ((0, 128), (128, 128), (200, 56)):
        assert torch.equal(gumbel_plain(seeds, 5, rows, 128, row0),
                           full[..., row0:row0 + rows, :])
    _, tp = _setup_params()
    feats = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 24)).astype(np.float32))
    lanes = np.array([9, 10, 0xFFFFFFFE], np.uint32)
    seq_all, _ = tdc.decode_fused(tp, feats, greedy=False, seeds=lanes)
    seq_hi, _ = tdc.decode_fused(tp, feats[128:], greedy=False, seeds=lanes,
                                 row0=128)
    assert torch.equal(seq_hi, seq_all[:, 128:])
    with pytest.raises(ValueError, match="row0"):
        tdc.decode_fused(tp, feats, greedy=False, row0=128,
                         gumbel=torch.zeros((3, T, B, 128)))


def _setup_params():
    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCModelOptions,
        build_spec,
    )

    opts = FCModelOptions(vocab_size=40, fc_feat_size=24,
                          input_encoding_size=16, rnn_size=16)
    spec = build_spec(opts)
    theta = spec.init_theta(torch.Generator().manual_seed(1)) * 3
    return spec, tdc.prepare_decode_params(spec, theta, opts)


@pytest.mark.parametrize("kind", ["greedy", "greedy_logprob",
                                  "self_critical"])
def test_rollout_dec_256_rows_equals_the_unsplit_plain_decode(coco, kind,
                                                              launches):
    """rollout_dec at B = 256 decodes in two blocks of 128 rows per decode
    (self_critical: K3 from a host Gumbel table sliced by row, and its K1
    baselines); its fitnesses equal those of the plain decode of all 256
    rows at once."""
    task = _task(coco, kind)
    vec = _members(task)
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, 12, size=(2, B)))
    Vpad = task.decode_layout.Vpad
    lanes = None
    if kind == "self_critical":
        lanes = torch.from_numpy(np.random.default_rng(4).gumbel(
            size=(2, task.seq_per_img, T, B, Vpad)).astype(np.float32))
    fits = task.rollout_dec(vec, idx, lanes=lanes)
    n_decodes = 2 if kind == "self_critical" else 1
    assert launches == [("decode_fused", 128)] * (2 * n_decodes)

    params = task.decode_layout.prep(vec, torch.float32)
    feats = task.device_consts()["train_fc"][idx]
    base = None
    if kind == "self_critical":
        seq, lp = tdc.decode_sample_plain(params, feats, T, False,
                                          gumbel=lanes)
        seq = seq.transpose(1, 2).reshape(2, -1, T)
        lp = lp.transpose(1, 2).reshape(2, -1, T)
        base = tdc.decode_fused_plain(params, feats, T, False)[0]
    else:
        seq, lp = tdc.decode_fused_plain(params, feats, T,
                                         task.need_logprobs)
    want = task._device_fitness(seq, idx, lp=lp, base_seq=base)
    assert torch.equal(fits, want)
    assert torch.isfinite(fits).all() and float(fits.max() - fits.min()) > 0


@pytest.mark.parametrize("kind", ["greedy", "greedy_logprob"])
def test_pair_rollouts_256_rows_equal_the_unsplit_plain_decode(coco, kind,
                                                               launches,
                                                               monkeypatch):
    """rollout_pair_dec (K2) and rollout_pair_rng (K5) at B = 256: two
    launches of 128 rows each; tokens, lp (greedy_logprob) and fitnesses
    equal the plain pair decode of all 256 rows at once (K5's: fed K7's
    delta of the same seeds), whose sign shares one early exit over the
    batch. Image 0's features are zeroed and rows 128-255 take it, and the
    EOS bias is raised by 1.25, so in every (pair, sign) the second block
    ends before the first and before T: with an exit of its own it would
    write lp 0 where the one launch writes the argmax lp. Tokens and lp
    bitwise (the same plain decode on the same rows)."""
    task = _task(coco, kind)
    lay = task.decode_layout
    theta = task.generate_theta(torch.Generator().manual_seed(4)) * 3
    theta[lay.spec.offset("logit.bias")] += 1.25
    base = task.pair_base_params(lay.to_dec(theta))
    sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05), pad_scale=0.0)
    g = torch.Generator().manual_seed(5)
    delta = torch.stack([sc * torch.randn(lay.dim_dec, generator=g)
                         for _ in range(2)])
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        1, 12, size=(2, B)))
    idx[:, 128:] = 0
    consts = dict(task.device_consts())
    consts["train_fc"] = consts["train_fc"].clone()
    consts["train_fc"][0] = 0.0
    feats = consts["train_fc"][idx]
    seen = []
    fitness = task._pair_fitness
    monkeypatch.setattr(task, "_pair_fitness",
                        lambda seq, lp, *a: seen.append((seq, lp))
                        or fitness(seq, lp, *a))
    need_lp = task.need_logprobs
    assert need_lp == (kind == "greedy_logprob")
    scale = lay.prep(sc, torch.float32)
    for name, fits, d in (
            ("K2", task.rollout_pair_dec(base, delta, idx, consts),
             lay.prep(delta, torch.float32)),
            ("K5", task.rollout_pair_rng(base, scale, [21, 22], idx, consts),
             tdc.pair_delta_dump_plain(scale, [21, 22]))):
        seq, lp = tdc.decode_pair_perturb_plain(base, d, feats,
                                                need_logprobs=need_lp)
        zero = seq == 0
        steps = torch.where(zero.any(-1), zero.int().argmax(-1), T)
        assert (steps[..., 128:].amax(-1) < steps[..., :128].amax(-1)).all()
        assert (steps.amax(-1) < T).all(), name
        got_seq, got_lp = seen.pop(0)
        assert torch.equal(got_seq, seq), name
        if need_lp:
            assert torch.equal(got_lp, lp), name
        assert torch.equal(fits, fitness(seq, lp, idx, consts)), name
        assert fits.shape == (2, 2)
    assert launches == [("decode_pair_perturb", 128)] * 2 \
        + [("decode_pair_rng", 128)] * 2


@pytest.mark.parametrize("widths", [{"enc": 16}, {"enc": 256},
                                    {"enc": 128, "feat": 24},
                                    {"enc": 600}, {"enc": 1025}],
                         ids=["E16", "E256", "F24", "E600", "E1025"])
def test_task_on_the_card_takes_only_the_kernels_widths(coco, monkeypatch,
                                                       widths):
    """A task for the card lays its model out at the kernels' widths
    (``kernel_shape``: E = R padded to 128, 256, 512 or 1024, the features
    to a multiple of 128; E256 has 24-d features), which the CPU lays out
    only when asked (``pad=True``), and is refused when it is built, with a
    clear message that names 1024, above the widest library; on the CPU
    the plain twins take any width, unpadded by default."""
    from nes_img_captioning_tpu_torch.tasks import captioning

    enc, feat = widths["enc"], widths.get("feat", 24)
    task = _task(coco, "greedy", **widths)
    own = task.decode_layout
    assert (own.sizes["E"], own.sizes["F"]) == (enc, feat)
    if enc <= 1024:
        lay = _task(coco, "greedy", pad=True, **widths).decode_layout
        W = {16: 128, 128: 128, 256: 256, 600: 1024}[enc]
        assert (lay.sizes["E"], lay.sizes["R"], lay.sizes["F"]) == (W, W,
                                                                    128)
        assert tdc.kernel_shape(enc, enc, feat) == (W, 128)
        assert captioning.resolve_fused(task.model.options, "auto",
                                        torch.device("cuda")) is True
        return
    monkeypatch.setattr(captioning, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="E and R up to 1024"):
        _task(coco, "greedy", device="cuda", **widths)


@pytest.fixture(scope="module")
def coco256(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_rows256")
    return make_synthetic_coco(str(d), n_train=12, n_val=4, n_test=4,
                               vocab_size=50, fc_feat_size=256, cap_len=6,
                               seed=0)


@pytest.mark.parametrize("kernel", ["K1", "K4", "K3", "K2"])
def test_256_rows_with_lp_are_jaxs_one_launch(coco256, kernel):
    """A batch of 256 rows with lp asked for, E = R = 128, f32, vocab 50,
    256-d features: the task's row blocks of 128 (``_greedy`` for K1 and
    K4 at vocab tile 128, ``_sample`` for K3 on JAX's Gumbel table, the
    pair rollout's blocks for K2 on JAX's realized delta) against JAX's
    kernels in interpret mode over all 256 rows in one launch, whose batch
    (each sign's) shares one early exit. Rows 128-255 have zero features
    and the EOS bias is raised (the boost from 13 in 0..0.3, K3's noise
    0..8, at which that block ends longest before the batch's last row), so
    a finished row of that block writes its argmax lp where a block with
    its own exit would write 0: tokens equal and lp within 2e-5 at every
    position."""
    kind = {"K3": "sc_loss", "K2": "greedy_logprob"}.get(kernel,
                                                          "greedy_logprob")
    exp = _exp(coco256, kind, enc=128, feat=256)
    if kernel == "K4":
        exp["tpu"]["decode_vocab_tile"] = 128
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu")
    assert task.need_logprobs
    lay = task.decode_layout
    jopts = _jax_opts(task.model.options)
    jlay = JaxLayout(_jax_spec(jopts), jopts)
    theta = task.generate_theta(torch.Generator().manual_seed(11))
    feats = torch.from_numpy(np.random.default_rng(12).normal(
        size=(B, 256)).astype(np.float32))
    feats[128:] = 0.0
    eos = lay.spec.offset("logit.bias")
    Vpad = lay.Vpad
    table = np.random.default_rng(13).gumbel(size=(T, B, Vpad)).astype(
        np.float32)
    sc = jlay.to_dec(jnp.full((jlay.spec.num_params,), 0.01, jnp.float32),
                     pad_scale=0.0)
    delta = sc * jax.random.normal(jax.random.PRNGKey(14), (jlay.dim_dec,),
                                   jnp.float32)

    def jax_run(th):
        vec = jlay.to_dec(jnp.asarray(th.numpy()))
        if kernel == "K2":
            return jdp.decode_pair_perturb(
                jlay.prep(vec, jnp.float32), jlay.prep(delta, jnp.float32),
                jnp.asarray(feats.numpy()), dtype=jnp.float32,
                interpret=True, need_logprobs=True)
        jp = jlay.prep(vec, jnp.float32)
        if kernel == "K3":
            return jdp.decode_fused(jp, jnp.asarray(feats.numpy()),
                                    greedy=False, interpret=True,
                                    host_rng=True, gumbel=jnp.asarray(table))
        return jdp.decode_fused(jp, jnp.asarray(feats.numpy()),
                                interpret=True,
                                vocab_tile=128 if kernel == "K4" else 0)

    def port_run(th):
        vec = lay.to_dec(th)
        if kernel == "K2":
            base = task.pair_base_params(vec)
            d = lay.prep(torch.from_numpy(np.asarray(delta))[None],
                         torch.float32)
            seq, lp = task._by_rows(lambda lo, hi, hold: tdc.decode_pair_perturb(
                base, d, feats[None, lo:hi], need_logprobs=True,
                min_steps=hold), B, 2, True)
            return seq[0], lp[0]
        params = lay.prep(vec[None], torch.float32)
        if kernel == "K3":
            seq, lp = task._sample(params, feats[None],
                                   torch.from_numpy(table)[None, None])
            return seq[0, 0], lp[0, 0]
        seq, lp = task._greedy(params, feats[None], need_logprobs=True)
        return seq[0], lp[0]

    def steps_of(seq):
        zero = seq == 0
        return torch.where(zero.any(-1), zero.int().argmax(-1), T)

    def port_scan(ths):
        """The port's tokens for each theta: K1, K4 and K3 with the thetas
        as the members of one call (each member its own batch and exit);
        K2 scans with K1 on the base theta (the delta is small), its own
        decode held to JAX below."""
        n = len(ths)
        params = lay.prep(torch.stack([lay.to_dec(th) for th in ths]),
                          torch.float32)
        fe = feats[None].expand(n, -1, -1)
        if kernel == "K3":
            return list(task._sample(params, fe, torch.from_numpy(table)[
                None, None].expand(n, -1, -1, -1, -1))[0][:, 0])
        return list(task._greedy(params, fe, need_logprobs=True)[0])

    # the boost at which the zero block ends longest before the batch (the
    # port's tokens, held to JAX's below)
    ths = []
    for boost in np.linspace(0.0, 8.0 if kernel == "K3" else 0.3, 13):
        ths.append(theta.clone())
        ths[-1][eos] += float(boost)
    best = None
    for th, seq in zip(ths, port_scan(ths)):
        st = steps_of(seq)
        gap = int(st[..., :128].max() - st[..., 128:].max())
        if st.max() < T and (best is None or gap > best[0]):
            best = (gap, th)
    assert best is not None and best[0] > 0, best and best[0]
    seq_j, lp_j = (np.asarray(x) for x in jax_run(best[1]))
    seq_t, lp_t = port_run(best[1])
    np.testing.assert_array_equal(seq_t.numpy(), seq_j)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, atol=2e-5)
    st = steps_of(seq_t)
    t = torch.arange(T)
    own_exit = t > st[..., 128:].max(-1, keepdim=True).values[..., None]
    past = (t > st[..., 128:, None]) & own_exit & (
        t <= st.max(-1, keepdim=True).values[..., None])
    # where a block with its own exit would have written 0
    assert past.any() and (lp_t[..., 128:, :][past] < 0).all()


def _jax_opts(o):
    """The JAX package's options of the port's no-norm model options."""
    from nes_img_captioning_tpu.models.fc_caption import FCModelOptions as JO

    return JO(vocab_size=o.vocab_size, fc_feat_size=o.fc_feat_size,
              input_encoding_size=o.input_encoding_size,
              rnn_size=o.rnn_size)


def _jax_spec(jopts):
    from nes_img_captioning_tpu.models.fc_caption import FCCaptionModel

    return FCCaptionModel(jopts).spec

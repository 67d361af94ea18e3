"""A captioner of widths no kernel library is built for, laid out as the
card lays it out: E and R zero-padded to the next built width, the 5R gate
axis per gate block, the features to a multiple of 128
(``decode_cuda.kernel_shape``, ``DecodeLayout(pad=True)``), forced here on
the CPU with ``pad=True``. The plain twins on the padded params are held to
the JAX package's Pallas kernels in interpret mode at the model's true
shape, and the padded layout's noise, gradient and checkpoints to the pads'
rule: every pad exactly 0, and nothing of them outside the layout. Toy
vocabularies, a few rows; the kernels themselves are held to these twins on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` [37])."""

import json
import os

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (E, R, F): E != R both ways and a ragged feature width, all laid out at
# (W, F_k) = (128, 128)
SHAPES = [(16, 24, 20), (24, 16, 20)]
IDS = ["E16_R24", "E24_R16"]
T = 16


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.array(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _setup(shape, vocab=50, seed=3, gain=3.0):
    """(JAX model, theta (numpy, torch order), the port's spec, options):
    JAX's init scaled by ``gain`` so that the toy decodes run past a few
    steps."""
    E, R, F = shape
    jm = JaxFCModel(JaxOptions(vocab_size=vocab, fc_feat_size=F,
                               input_encoding_size=E, rnn_size=R))
    theta = gain * np.array(jm.spec.init_theta(jax.random.PRNGKey(seed)))
    topts = FCModelOptions(vocab_size=vocab, fc_feat_size=F,
                           input_encoding_size=E, rnn_size=R)
    return jm, theta.astype(np.float32), build_spec(topts), topts


def _feats(F, rows=8, seed=1):
    return np.random.default_rng(seed).normal(size=(rows, F)).astype(
        np.float32)


def _padded(spec, topts, theta, dtype=torch.float32):
    return tdc.prepare_decode_params(spec, torch.from_numpy(theta), topts,
                                     dtype=dtype, pad=True)


def _real(name, t, E, R, F):
    """A padded decode tensor (numpy, no leading axis) -> (its block at the
    model's true shape, the tensor with that block zeroed: its pads)."""
    pads = t.copy()
    if name in ("i2h_w", "h2h_w", "i2h_b", "h2h_b"):
        rows = {"i2h_w": E, "h2h_w": R}.get(name, 1)
        gates = pads.reshape(t.shape[0], 5, -1)
        real = t.reshape(t.shape[0], 5, -1)[:rows, :, :R].reshape(rows,
                                                                  5 * R)
        gates[:rows, :, :R] = 0
        return real, pads
    rows, cols = {"img_w": (F, E), "img_b": (1, E), "logit_w": (R, None),
                  "logit_b": (1, None), "embed": (None, E)}[name]
    real = t[:rows, :cols].copy()
    pads[:rows, :cols] = 0
    return real, pads


def test_kernel_shape():
    """The kernels' shape of a captioner: E and R to the smallest built
    width at least both, F up to a multiple of 128 (513-1024 to the 1024
    library: P3, Up-Down's 1000-wide LSTM); above 1024 a refusal that
    names 1024 and the eager decoder."""
    ks = tdc.kernel_shape
    assert ks(16, 24, 20) == ks(24, 16, 20) == (128, 128)
    assert ks(300, 512, 2048) == (512, 2048)
    assert ks(256, 192, 960) == (256, 1024)
    assert ks(128, 128, 2048) == (128, 2048)
    assert ks(129, 64, 129) == (256, 256)
    assert ks(1000, 1000, 2048) == (1024, 2048)
    assert ks(513, 16, 2048) == ks(16, 1024, 2048) == (1024, 2048)
    for E, R in ((1025, 16), (16, 2048)):
        with pytest.raises(ValueError, match="up to 1024.*fused_decode: "
                           "false"):
            ks(E, R, 2048)


@pytest.mark.parametrize("width", [128, 256, 512])
def test_padding_is_empty_at_the_built_widths(width):
    """At E = R = 128, 256 and 512 with F = 2048 the padded layout is the
    unpadded one, which is JAX's: the same dim_dec (at vocab 9487) and,
    at a toy vocabulary and 256-d features, the same to_dec bit for bit."""
    opts = FCModelOptions(vocab_size=9487, fc_feat_size=2048,
                          input_encoding_size=width, rnn_size=width)
    spec = build_spec(opts)
    jm = JaxFCModel(JaxOptions(vocab_size=9487, fc_feat_size=2048,
                               input_encoding_size=width, rnn_size=width))
    dims = {DecodeLayout(spec, opts, pad=p).dim_dec for p in (False, True)}
    assert dims == {JaxLayout(jm.spec, jm.options).dim_dec}
    jm, theta, spec, topts = _setup((width, width, 256))
    th = torch.from_numpy(theta)
    assert torch.equal(DecodeLayout(spec, topts, pad=True).to_dec(th),
                       DecodeLayout(spec, topts).to_dec(th))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_layout_round_trip_and_pads(shape):
    """to_dec / from_dec round trip exactly; theta's width pads hold 0 and
    its vocab pads NEG (the logit bias) or 0; a noise scale's pads
    (pad_scale 0) are all 0; the layout holds dim real entries."""
    E, R, F = shape
    jm, theta, spec, topts = _setup(shape)
    lay = DecodeLayout(spec, topts, pad=True)
    assert (lay.sizes["E"], lay.sizes["R"], lay.sizes["F"]) == (128, 128,
                                                                128)
    th = torch.from_numpy(theta)
    dec = lay.to_dec(th)
    assert dec.shape == (lay.dim_dec,)
    assert torch.equal(lay.from_dec(dec), th)
    real = lay.to_dec(torch.ones_like(th), pad_scale=0.0)
    assert set(real.unique().tolist()) == {0.0, 1.0}
    assert int(real.sum()) == spec.num_params
    pads = real == 0
    vocab_pads = lay.to_dec(torch.zeros_like(th)) != 0   # NEG at logit_b's
    assert int(vocab_pads.sum()) == lay.Vpad - lay.V1
    assert (dec[vocab_pads] == tdc.NEG).all()
    assert (dec[pads & ~vocab_pads] == 0).all()
    rows = torch.stack([th, 2 * th])
    assert torch.equal(lay.from_dec(lay.to_dec(rows)), rows)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gate_blocks_are_padded_per_gate(shape):
    """Gate g's cell j sits at column g * W + j of i2h_w, h2h_w and both
    gate biases, where the kernels read gate g: a single non-zero weight
    placed in torch order is found there, and nowhere else."""
    E, R, F = shape
    _, _, spec, topts = _setup(shape)
    lay = DecodeLayout(spec, topts, pad=True)
    W = lay.sizes["R"]
    for g in range(5):
        j, k = R - 1 - g, min(g + 2, E - 1)
        for leaf, name, row in (("core.i2h.weight", "i2h_w", k),
                                ("core.h2h.weight", "h2h_w", min(k, R - 1)),
                                ("core.i2h.bias", "i2h_b", None),
                                ("core.h2h.bias", "h2h_b", None)):
            th = torch.zeros(spec.num_params)
            off = spec.offset(leaf)
            # torch order: weight (5R, in) row-major, bias (5R,)
            at = off + (g * R + j) * (E if name == "i2h_w" else R) + row \
                if row is not None else off + g * R + j
            th[at] = 7.0
            p = lay.prep(lay.to_dec(th, pad_scale=0.0), torch.float32)[name]
            hit = (p != 0).nonzero().tolist()
            assert hit == [[0 if row is None else row, g * W + j]], (name, g)
            assert torch.equal(lay.from_dec(lay.to_dec(th)), th)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_padded_params_are_jax_params_with_zero_pads(shape):
    """prepare_decode_params(pad=True) equals prep(to_dec(theta)) tensor for
    tensor, and each tensor's block at the true shape is JAX's
    prepare_decode_params at that shape, bit for bit (bf16 and f32), with
    every other entry 0."""
    E, R, F = shape
    jm, theta, spec, topts = _setup(shape)
    lay = DecodeLayout(spec, topts, pad=True)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        tp = _padded(spec, topts, theta, tdt)
        via = lay.prep(lay.to_dec(torch.from_numpy(theta)), tdt)
        jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta),
                                       jm.options, dtype=jdt)
        assert list(tp) == list(jp)
        for k in jp:
            assert torch.equal(tp[k], via[k]) and tp[k].dtype == via[k].dtype
            real, pads = _real(k, _np(tp[k]), E, R, F)
            np.testing.assert_array_equal(real, _np(jp[k]), err_msg=k)
            assert not pads.any(), k


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k1_and_k4_twins_match_pallas(shape):
    """K1's plain twin on the padded f32 params and the zero-padded feats
    against JAX decode_fused (interpret) at the true shape: tokens equal,
    lp within 2e-5; K4 at vocab 130 (two tiles of 128) the same against
    JAX's tiled call, its tokens K1's."""
    E, R, F = shape
    feats = _feats(F)
    for vocab, tile in ((50, 0), (130, 128)):
        jm, theta, spec, topts = _setup(shape, vocab=vocab)
        jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta),
                                       jm.options)
        seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats),
                                       interpret=True, vocab_tile=tile)
        tp = _padded(spec, topts, theta)
        seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats),
                                       vocab_tile=tile)
        np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
        np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=2e-5)
        assert (seq_t > 0).sum() > 8
        if tile:
            assert torch.equal(
                seq_t, tdc.decode_fused(tp, torch.from_numpy(feats))[0])


def test_p3_padded_twin_matches_pallas():
    """P3, Up-Down's widths at a toy size: (E, R, F) = (1000, 1000, 128),
    vocab 60, laid out at kernel_shape's (1024, 128). The padded f32
    params' block at the true shape is JAX's prepare_decode_params bit for
    bit and every pad is 0; K1's plain twin on them, T = 6 over 24 rows,
    against JAX decode_fused (interpret) at the true shape: tokens equal,
    lp within 2e-5."""
    shape = (E, R, F) = (1000, 1000, 128)
    jm, theta, spec, topts = _setup(shape, vocab=60, gain=1.0)
    assert tdc.kernel_shape(E, R, F) == (1024, 128)
    tp = _padded(spec, topts, theta)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options)
    assert tp["h2h_w"].shape == (1024, 5 * 1024)
    for k in jp:
        real, pads = _real(k, _np(tp[k]), E, R, F)
        np.testing.assert_array_equal(real, _np(jp[k]), err_msg=k)
        assert not pads.any(), k
    feats = _feats(F, rows=24, seed=2)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), 6,
                                   interpret=True)
    seq_t, lp_t = tdc.decode_fused(tp, torch.from_numpy(feats), 6)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=2e-5)
    assert (seq_t > 0).any()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k3_twin_matches_pallas_on_a_host_table(shape):
    """K3's plain twin (the host-table form) on the padded params against
    JAX decode_fused(greedy=False, host_rng=True) at the true shape on the
    same numpy Gumbel table: tokens equal, lp within 2e-5."""
    E, R, F = shape
    jm, theta, spec, topts = _setup(shape)
    feats = _feats(F, 6)
    Vpad = tdc.pad_vocab(51)
    g = np.random.default_rng(4).gumbel(size=(T, 6, Vpad)).astype(np.float32)
    jp = jdp.prepare_decode_params(jm.spec, jnp.asarray(theta), jm.options)
    seq_j, lp_j = jdp.decode_fused(jp, jnp.asarray(feats), greedy=False,
                                   interpret=True, host_rng=True,
                                   gumbel=jnp.asarray(g))
    seq_t, lp_t = tdc.decode_fused(_padded(spec, topts, theta),
                                   torch.from_numpy(feats), greedy=False,
                                   gumbel=torch.from_numpy(g)[None])
    np.testing.assert_array_equal(seq_t[0].numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp_t[0].numpy(), np.asarray(lp_j), atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k2_twin_matches_pallas_on_jax_deltas(shape):
    """K2's plain twin on the padded layout against JAX
    decode_pair_perturb (interpret) at the true shape, on JAX's realized
    f32 delta laid into the padded layout (pads 0): tokens equal, lp
    within 2e-5; each sign token-equal to K1's twin on prep(base ±
    delta)."""
    E, R, F = shape
    jm, theta, spec, topts = _setup(shape)
    jl = JaxLayout(jm.spec, jm.options)
    sc = jl.to_dec(jnp.full((jm.spec.num_params,), 0.05, jnp.float32),
                   pad_scale=0.0)
    delta = sc * jax.random.normal(jax.random.PRNGKey(9), (jl.dim_dec,),
                                   jnp.float32)
    feats = _feats(F)
    seq_j, lp_j = jdp.decode_pair_perturb(
        jl.prep(jl.to_dec(jnp.asarray(theta)), jnp.float32),
        jl.prep(delta, jnp.float32), jnp.asarray(feats), dtype=jnp.float32,
        interpret=True, need_logprobs=True)
    tl = DecodeLayout(spec, topts, pad=True)
    base_t = tl.to_dec(torch.from_numpy(theta))
    delta_t = tl.to_dec(torch.from_numpy(_np(jl.from_dec(delta))),
                        pad_scale=0.0)
    pads = tl.to_dec(torch.ones(spec.num_params), pad_scale=0.0) == 0
    assert (delta_t[pads] == 0).all()
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


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_noise_twins_keep_the_pads_at_zero(shape):
    """K7's twin draws exactly 0 at every pad of the padded scale; K5's twin
    is K2's fed that dump; K6's twin's gradient is 0 at every pad and maps
    back, by from_dec, to the model's true size, the weighted sum of the
    dumps mapped back."""
    E, R, F = shape
    _, theta, spec, topts = _setup(shape)
    lay = DecodeLayout(spec, topts, pad=True)
    flat = lay.to_dec(torch.full((spec.num_params,), 0.02), pad_scale=0.0)
    pads = lay.to_dec(torch.ones(spec.num_params), pad_scale=0.0) == 0
    scale = lay.prep(flat, torch.float32)
    seeds = [11, 12, 13]
    dump = tdc.pair_delta_dump(scale, seeds)
    dump_flat = torch.stack([lay.flat_dec({k: v[i] for k, v in dump.items()})
                             for i in range(len(seeds))])
    assert (dump_flat[:, pads] == 0).all()
    assert (dump_flat[:, ~pads] != 0).float().mean() > 0.99
    base = lay.prep(lay.to_dec(torch.from_numpy(theta)), torch.float32)
    feats = torch.from_numpy(_feats(F, 4))
    got = tdc.decode_pair_rng(base, scale, seeds, feats, T, need_logprobs=True)
    want = tdc.decode_pair_perturb(base, dump, feats, T, need_logprobs=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    w = [0.5, -1.0, 0.25]
    grad = tdc.pair_grad_rng_flat(flat, seeds, w)
    assert grad.shape == (lay.dim_dec,) and (grad[pads] == 0).all()
    back = lay.from_dec(grad)
    assert back.shape == (spec.num_params,)
    want = sum(wi * lay.from_dec(d) for wi, d in zip(w, dump_flat))
    torch.testing.assert_close(back, want, atol=1e-7, rtol=1e-6)


def _coco(tmp_path, F):
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

    return make_synthetic_coco(str(tmp_path), n_train=8, n_val=4, n_test=4,
                               vocab_size=40, fc_feat_size=F, cap_len=6,
                               seed=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_generation_matches_jax_on_the_same_deltas(shape, tmp_path):
    """One NIC-NES generation with SGD on the padded layout: the port's
    pair-kernel path (the plain twins) against the JAX package's at the
    true shape (interpret mode), on the same theta, batches and realized
    deltas: fitnesses within 1e-5, theta within 1e-6."""
    from nes_img_captioning_tpu.algorithms.nes import NESEngine as JNES
    from nes_img_captioning_tpu.algorithms.optimizers import SGD as JSGD
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

    E, R, Fd = shape
    F, B, sigma, step, l2 = 2, 4, 0.05, 0.01, 1e-7
    exp = {"dataset": "mscoco", "caption_options": _coco(tmp_path, Fd),
           "policy_options": {"fitness": "greedy", "model_options": {
               "input_encoding_size": E, "rnn_size": R,
               "fc_feat_size": Fd}},
           "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"}}
    jtask = JTask(exp, JConfig(batch_size=B), jp(exp))
    jtask._fused_interpret = True
    jeng = JNES(jtask, JSGD(step, 0.9), JMK.DEFAULT, pop_chunk=2)
    rng = np.random.default_rng(8)
    seeds = rng.integers(0, 2**32, size=F, dtype=np.uint32)
    idx = rng.integers(0, 8, size=(F, B)).astype(np.int32)
    theta = 3.0 * jtask.generate_theta(jax.random.PRNGKey(6))
    sens = jnp.ones((jeng.dim,), jnp.float32)
    art, deltas = jeng.eval_generation(theta, sens, sigma, seeds, idx)
    fits_j = np.asarray(jtask.host_fitness(art, idx))
    _, theta_j, _ = jeng.update(theta, jeng.optimizer.init(jeng.dim), sens,
                                sigma, seeds, jnp.asarray(fits_j), step, l2,
                                deltas=deltas)
    deltas = np.asarray(deltas).reshape(-1, jeng.dim)[:F]

    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu", pad=True)
    lay = task.decode_layout
    assert (lay.sizes["E"], lay.sizes["F"]) == (128, 128)
    eng = NESEngine(task, SGD(step, 0.9), MutationKind.DEFAULT, pop_chunk=2,
                    kernel_perturb=True)
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
    assert th.shape == th0.shape and not torch.equal(th, th0)


def test_padded_run_checkpoints_load_in_jax(tmp_path, monkeypatch):
    """A NIC-NES master whose task lays the model out padded (kernel noise:
    K5's and K6's twins over the padded layout) writes a .pth and an
    optimizer.tar at the model's true shape: JAX's load_pth reads every
    leaf at its (E, R, F) shape, bit for bit the master's theta, and JAX's
    Adam reads moments of the true size."""
    from nes_img_captioning_tpu.algorithms.optimizers import Adam as JaxAdam
    from nes_img_captioning_tpu_torch import tasks
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask

    E, R, Fd = SHAPES[0]
    with open(os.path.join(REPO, "experiments", "mscoco_nes.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=4, val_batch_size=4, num_val_items=4,
                         snapshot_freq=2)
    exp["policy_options"]["model_options"].update(
        input_encoding_size=E, rnn_size=R, fc_feat_size=Fd)
    exp["nb_offspring"] = 4
    exp["caption_options"] = _coco(tmp_path / "coco", Fd)
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, "precision": "f32",
                  "kernel_noise": True}
    exp["log_dir"] = str(tmp_path / "run")
    monkeypatch.setattr(tasks, "make_task", lambda *a, **k: CocoTask(
        *a, pad=True, **k))
    m = NESMaster(exp, device="cpu")
    assert m.task.decode_layout.sizes["R"] == 128
    m.run_master(max_iterations=2)
    (zinfo,) = [os.path.join(root, f) for root, _, files in
                os.walk(tmp_path / "run") for f in files
                if f.startswith("z_info_")]
    with open(zinfo) as f:
        infos = json.load(f)
    jm = JaxFCModel(JaxOptions(vocab_size=40, fc_feat_size=Fd,
                               input_encoding_size=E, rnn_size=R))
    theta = np.asarray(jm.spec.load_pth(infos["current_model"]))
    np.testing.assert_array_equal(theta, m.theta.numpy())
    sd = torch.load(infos["current_model"], map_location="cpu")
    assert tuple(sd["core.i2h.weight"].shape) == (5 * R, E)
    assert tuple(sd["img_embed.weight"].shape) == (E, Fd)
    st = JaxAdam(0.1).load_from_file(infos["optimizer_state"])
    assert np.asarray(st.m).shape == (jm.spec.num_params,)
    assert int(st.t) == 2

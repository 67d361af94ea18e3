"""Batches above the kernels' 128 rows: the port's task decodes them in row
blocks of at most 128, one launch each, and K3's blocks draw the Gumbel
stream of one launch over all rows (its row offset ``row0``). On the CPU
the wrappers run their plain twins, which take any batch: the split
rollouts must equal the unsplit plain decode of all rows. Toy size (vocab
40, E = R = 16, 24-d features), B = 256."""

import numpy as np
import pytest
import torch

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops.noise import gumbel_plain

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


def test_pair_rollouts_256_rows_equal_the_unsplit_plain_decode(coco,
                                                               launches):
    """rollout_pair_dec (K2) and rollout_pair_rng (K5) at B = 256: two
    launches of 128 rows each; fitnesses equal the plain pair decode of all
    256 rows (K5's: fed K7's delta of the same seeds)."""
    task = _task(coco, "greedy")
    lay = task.decode_layout
    base_vec = _members(task, 1)[0]
    base = task.pair_base_params(base_vec)
    sc = lay.to_dec(torch.full((lay.spec.num_params,), 0.05), pad_scale=0.0)
    g = torch.Generator().manual_seed(5)
    delta = torch.stack([sc * torch.randn(lay.dim_dec, generator=g)
                         for _ in range(2)])
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 12, size=(2, B)))
    feats = task.device_consts()["train_fc"][idx]
    fits2 = task.rollout_pair_dec(base, delta, idx)
    seq2, lp2 = tdc.decode_pair_perturb_plain(
        base, lay.prep(delta, torch.float32), feats)
    assert torch.equal(fits2, task._pair_fitness(seq2, lp2, idx, {}))
    scale = lay.prep(sc, torch.float32)
    fits5 = task.rollout_pair_rng(base, scale, [21, 22], idx)
    seq5, lp5 = tdc.decode_pair_perturb_plain(
        base, tdc.pair_delta_dump_plain(scale, [21, 22]), feats)
    assert torch.equal(fits5, task._pair_fitness(seq5, lp5, idx, {}))
    assert launches == [("decode_pair_perturb", 128)] * 2 \
        + [("decode_pair_rng", 128)] * 2
    assert fits2.shape == fits5.shape == (2, 2)


@pytest.mark.parametrize("widths", [{"enc": 16}, {"enc": 256},
                                    {"enc": 128, "feat": 24},
                                    {"enc": 600}],
                         ids=["E16", "E256", "F24", "E600"])
def test_task_on_the_card_takes_only_the_kernels_widths(coco, monkeypatch,
                                                       widths):
    """A task for the card lays its model out at the kernels' widths
    (``kernel_shape``: E = R padded to 128, 256 or 512, the features to a
    multiple of 128; E256 has 24-d features), which the CPU lays out only
    when asked (``pad=True``), and is refused when it is built, with a
    clear message that names 512, above the widest library; on the CPU
    the plain twins take any width, unpadded by default."""
    from nes_img_captioning_tpu_torch.tasks import captioning

    enc, feat = widths["enc"], widths.get("feat", 24)
    task = _task(coco, "greedy", **widths)
    own = task.decode_layout
    assert (own.sizes["E"], own.sizes["F"]) == (enc, feat)
    if enc <= 512:
        lay = _task(coco, "greedy", pad=True, **widths).decode_layout
        W = {16: 128, 128: 128, 256: 256}[enc]
        assert (lay.sizes["E"], lay.sizes["R"], lay.sizes["F"]) == (W, W,
                                                                    128)
        assert tdc.kernel_shape(enc, enc, feat) == (W, 128)
        assert captioning.resolve_fused(task.model.options, "auto",
                                        torch.device("cuda")) is True
        return
    monkeypatch.setattr(captioning, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="E and R up to 512"):
        _task(coco, "greedy", device="cuda", **widths)

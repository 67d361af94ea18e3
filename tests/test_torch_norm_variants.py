"""Port parity for the FC captioner's norm variants (vbn, vbn_e, layer_n and
their affine forms) and the eager decoder, against the JAX package on the
CPU at toy size (vocab 30, E = R = 8, 32-d features), f32: the spec and
.pth interop, ``sample_members`` greedy and sampled (handed the Gumbel
values JAX's ``jax.random.categorical`` adds), the eager validation with a
ragged tail, and the SM-G sensitivities through the norms.

Tolerances: tokens equal; logprobs within 2e-5 without norms (the bar of
tests/test_torch_params.py) and 1e-4 with them (the normalized
pre-activations add a division by a batch standard deviation each step);
sensitivities within rtol 2e-4, atol 1e-6 (tests/test_sensitivity_oracle.py).
"""

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
from nes_img_captioning_tpu_torch.models.fc_caption import (
    FCCaptionModel,
    FCModelOptions,
    build_spec,
)

from torch_pin import one_intra_op_thread  # noqa: F401

DIMS = dict(vocab_size=30, input_encoding_size=8, rnn_size=8,
            fc_feat_size=32)
VARIANTS = {
    "none": {},
    "vbn": {"vbn": True},
    "vbn_affine": {"vbn": True, "vbn_affine": True},
    "vbn_e": {"vbn_e": True},
    "vbn_e_affine": {"vbn_e": True, "vbn_affine": True},
    "layer_n": {"layer_n": True},
    "layer_n_affine": {"layer_n": True, "layer_n_affine": True},
}
NORMS = [v for v in VARIANTS if v != "none"]


def _models(variant):
    return (JaxFCModel(JaxOptions(**DIMS, **VARIANTS[variant])),
            FCModelOptions(**DIMS, **VARIANTS[variant]))


def _theta(jm, seed=1):
    """A JAX init with noise that moves the affine leaves off 1 and 0, so
    that they matter."""
    theta = np.asarray(jm.spec.init_theta(jax.random.PRNGKey(seed))).copy()
    theta += 0.1 * np.random.default_rng(seed).normal(
        size=theta.shape).astype(np.float32)
    return theta


def _tol(variant):
    return 2e-5 if variant == "none" else 1e-4


@pytest.mark.parametrize("variant", NORMS)
def test_spec_state_dict_and_pth_match_jax(variant, tmp_path):
    """Leaf names, shapes, init kinds, offsets and num_params are the JAX
    spec's; the module's state_dict keys follow them; a .pth written by
    either package loads bit for bit in the other."""
    jm, opts = _models(variant)
    ts = build_spec(opts)
    assert ts.names == jm.spec.names
    assert [l.shape for l in ts.leaves] == [l.shape for l in jm.spec.leaves]
    assert [l.init for l in ts.leaves] == [l.init for l in jm.spec.leaves]
    assert [ts.offset(n) for n in ts.names] == \
        [jm.spec.offset(n) for n in jm.spec.names]
    assert ts.num_params == jm.num_params
    m = FCCaptionModel(opts, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert list(m.state_dict()) == list(ts.names)
    assert m.num_params == ts.num_params
    theta = _theta(jm)
    jm.spec.save_pth(theta, str(tmp_path / "jax.pth"))
    got = ts.load_pth(str(tmp_path / "jax.pth"))
    np.testing.assert_array_equal(got.numpy(), theta)
    ts.save_pth(got, str(tmp_path / "torch.pth"))
    np.testing.assert_array_equal(jm.spec.load_pth(str(tmp_path /
                                                       "torch.pth")), theta)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eager_greedy_matches_jax(variant):
    """``sample`` (one member, greedy) against JAX FCCaptionModel.sample:
    tokens equal, logprobs within 2e-5 (1e-4 with norms). At 8 intra-op
    threads vbn_affine's row 2 flips at step 8, a near-tie (top-2 gap
    7.4e-6 on one thread, 1.2e-6 on 8), and its batch statistics carry the flip to other rows
    (ROADMAP.md §3, vbn numerics); the module runs on one thread."""
    jm, opts = _models(variant)
    theta = _theta(jm)
    feats = np.random.default_rng(2).normal(size=(6, 32)).astype(np.float32)
    seq_j, lp_j = jm.sample(jnp.asarray(theta), jnp.asarray(feats),
                            greedy=True)
    tm = FCCaptionModel(opts, theta=torch.from_numpy(theta), device="cpu")
    seq, lp = tm.sample(torch.from_numpy(feats))
    assert seq.dtype == torch.int32 and seq.shape == (6, 16)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=0,
                               atol=_tol(variant))
    assert len(np.unique(seq.numpy())) > 1


def _jax_gumbel_table(key, T, R, V1):
    """(1, T, R, V1): the values ``jax.random.categorical`` adds to the
    logprobs at each step of FCCaptionModel.sample, from its step keys
    ``split(key, T)``."""
    return np.stack([np.asarray(jax.random.gumbel(k, (R, V1)))
                     for k in jax.random.split(key, T)])[None]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eager_sampled_matches_jax_given_its_gumbel(variant):
    """Sampling: handed the Gumbel values of JAX's step keys,
    ``sample_members(greedy=False)`` draws JAX's tokens; logprobs within
    2e-5 (1e-4 with norms)."""
    jm, opts = _models(variant)
    theta = _theta(jm, 3)
    feats = np.random.default_rng(4).normal(size=(10, 32)).astype(np.float32)
    key = jax.random.key(7)
    seq_j, lp_j = jm.sample(jnp.asarray(theta), jnp.asarray(feats),
                            greedy=False, key=key)
    g = _jax_gumbel_table(key, 16, 10, 31)
    tm = FCCaptionModel(opts, device="meta")
    seq, lp = tm.sample_members(torch.from_numpy(theta)[None],
                                torch.from_numpy(feats)[None], greedy=False,
                                gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(seq[0].numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(lp[0].numpy(), np.asarray(lp_j), rtol=0,
                               atol=_tol(variant))
    greedy = jm.sample(jnp.asarray(theta), jnp.asarray(feats), greedy=True)[0]
    assert not np.array_equal(np.asarray(seq_j), np.asarray(greedy))


@pytest.mark.parametrize("variant", ["none", "vbn", "vbn_e_affine",
                                     "layer_n"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_sample_members_bitwise_single_member_calls(variant, greedy):
    """M = 4 members decoded together equal 4 calls of one member each,
    bit for bit: each member's products and batch statistics are its
    own. Bitwise at one intra-op thread only, because MKL's multi-threaded
    ``baddbmm`` over M members is not batch-invariant
    (``test_torch_threads.py`` holds the 4-thread case)."""
    jm, opts = _models(variant)
    thetas = torch.from_numpy(np.stack([_theta(jm, s) for s in range(4)]))
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(size=(4, 6, 32)).astype(np.float32))
    g = torch.from_numpy(rng.gumbel(size=(4, 16, 6, 31)).astype(np.float32))
    tm = FCCaptionModel(opts, device="meta")
    seq, lp = tm.sample_members(thetas, feats, greedy, g)
    assert seq.shape == lp.shape == (4, 6, 16)
    for m in range(4):
        s1, l1 = tm.sample_members(thetas[m:m + 1], feats[m:m + 1], greedy,
                                   g[m:m + 1])
        assert torch.equal(s1[0], seq[m]) and torch.equal(l1[0], lp[m])


def test_chip_smoke_member_near_tie_check():
    """chip_smoke.py's check of one eager decode against another: the
    greedy decode replayed on its own tokens gives each step's top-2 gap,
    and a member whose tokens differ passes only where its first
    difference lies under the gap limit and the count of such members
    under the cap."""
    import chip_smoke

    jm, opts = _models("vbn")
    thetas = torch.from_numpy(np.stack([_theta(jm, s) for s in range(3)]))
    feats = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, 5, 32)).astype(np.float32))
    tm = FCCaptionModel(opts, device="meta")
    seq, _ = tm.sample_members(thetas, feats)
    gaps = torch.stack([chip_smoke.eager_top2_gaps(tm, thetas[m], feats[m],
                                                   seq[m]) for m in range(3)])
    assert gaps.shape == seq.shape and (gaps >= 0).all() and (gaps > 0).any()
    other = seq.clone()
    other[1, 2, 4:] += 1  # member 1 first differs at step 4, on row 2
    found, same = chip_smoke.check_member_near_ties(
        tm, thetas, feats, other, seq, "test", float("inf"), 1)
    assert found == [(1, 4, float(gaps[1, 2, 4]))]
    assert same.tolist() == [True, False, True]
    with pytest.raises(AssertionError, match="at most 0"):
        chip_smoke.check_member_near_ties(tm, thetas, feats, other, seq,
                                          "test", float("inf"), 0)
    with pytest.raises(AssertionError, match="1 members differ"):
        chip_smoke.check_member_near_ties(tm, thetas, feats, other, seq,
                                          "test", float(gaps[1, 2, 4]), 1)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_norms")
    return make_synthetic_coco(str(d), n_train=24, n_val=11, n_test=4,
                               vocab_size=30, fc_feat_size=32, cap_len=6,
                               seed=0)


def _tasks(copts, variant, **config):
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    flags = dict(VARIANTS[variant])
    vbn = flags.pop("vbn", False)
    exp = {"dataset": "mscoco", "caption_options": dict(copts),
           "policy_options": {"fitness": "greedy", "vbn": vbn,
                              "model_options": {
                                  "input_encoding_size": 8, "rnn_size": 8,
                                  "fc_feat_size": 32, **flags}},
           "tpu": {"seed": 0, "precision": "f32"}}
    return (JTask(exp, JConfig(**config), jp(exp)),
            CocoTask(exp, Config(**config), parse_tpu_config(exp),
                     device="cpu"))


@pytest.mark.parametrize("variant", ["vbn", "vbn_e_affine", "layer_n"])
def test_eager_validation_matches_jax(coco, variant):
    """Validation on the eager decoder: 11 val images in chunks of 4, the
    last holding 3 images and a zero row that the vbn statistics see; the
    tokens equal JAX's ``_decode_split``, ``validate`` equals JAX's, and
    ``validate_device`` equals ``validate``."""
    jtask, ttask = _tasks(coco, variant, batch_size=4, val_batch_size=4)
    assert not ttask._fused and ttask.decode_layout is None
    theta = _theta(jtask.model, 9)
    want = jtask._decode_split(jnp.asarray(theta), jtask.val_fc, -1, 4)
    th = torch.from_numpy(theta)
    got = ttask._decode_split(th, ttask.val_fc, -1)
    assert got.shape == (11, 16)
    np.testing.assert_array_equal(got, want)
    v = ttask.validate(th)
    assert v == pytest.approx(jtask.validate(jnp.asarray(theta)), abs=1e-6)
    vd = ttask.validate_device(th, ttask.device_val_consts())
    assert float(vd) == pytest.approx(v, abs=1e-5)
    if variant == "vbn":
        # the pad row is part of the statistics: without it the tail
        # decodes otherwise
        alone = ttask.model.sample_members(th[None], ttask.val_fc[None, 8:])
        assert not torch.equal(alone[0][0], torch.from_numpy(got[8:]))


@pytest.mark.parametrize("variant", ["vbn", "vbn_e_affine",
                                     "layer_n_affine"])
@pytest.mark.parametrize("kind", ["SM-G-SUM", "SM-G-ABS"])
def test_norm_sensitivities_match_jax(coco, variant, kind):
    """SM-G through the norms: the post-processed sensitivities of
    ``calc_sensitivity`` on the port's ``sensitivity_forward`` within rtol
    2e-4, atol 1e-6 of JAX's."""
    from nes_img_captioning_tpu.ops import sensitivity as jsens
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu_torch.ops import sensitivity as tsens
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

    jtask, ttask = _tasks(coco, variant, batch_size=8)
    theta = _theta(jtask.model, 4)
    idx = np.random.default_rng(0).choice(24, size=6, replace=False)
    want = np.asarray(jsens.calc_sensitivity(
        jtask, jnp.asarray(theta), jnp.asarray(idx.astype(np.int32)),
        JKind(kind), 0.01))
    got = tsens.calc_sensitivity(
        ttask, torch.from_numpy(theta), torch.as_tensor(idx),
        MutationKind(kind), 0.01).numpy()
    assert np.isfinite(got).all() and (want > 1.0).mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_vbn_sensitivity_rows_per_parent(coco):
    """vbn's statistics in the SM-G sweep are over one parent's rows, never
    across the parents of a ``vmap`` group: the (3, dim) rows of a sweep
    are each parent's sweep alone, bit for bit, and a second sweep repeats
    them."""
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        calc_sensitivities,
    )

    jtask, ttask = _tasks(coco, "vbn", batch_size=8)
    parents = torch.stack([torch.from_numpy(_theta(jtask.model, s))
                           for s in range(3)])
    idx = torch.as_tensor(np.random.default_rng(1).choice(24, size=6,
                                                          replace=False))
    kind = MutationKind.SAFE_GRAD_SUM
    first = calc_sensitivities(ttask, parents, idx, kind, 0.01)
    assert torch.equal(first, calc_sensitivities(ttask, parents, idx, kind,
                                                 0.01))
    for i in range(3):
        alone = calc_sensitivities(ttask, parents[i:i + 1], idx, kind, 0.01)
        assert torch.equal(alone[0], first[i])
    assert (first > 1).any() and not torch.equal(first[0], first[1])

"""Port parity for the SM-G sensitivities: ``ops/sensitivity.py`` and the
captioning ``sensitivity_forward`` of the port against the JAX package's,
on the CPU at toy size (vocab 30, so V + 1 = 31; E = R = 16; 24-d
features), f32.

The estimator's Rademacher matrix is the port's own stream
(``probe_matrix``); to compare the estimators, JAX's matrix for the same
key is handed to the port as its operand. Tolerances are those of
``tests/test_sensitivity_oracle.py``: rtol 2e-4, atol 1e-6.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu.ops import sensitivity as jsens
from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
from nes_img_captioning_tpu_torch.ops import sensitivity as tsens
from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

from torch_pin import one_intra_op_thread  # noqa: F401

RTOL, ATOL, UNDERFLOW = 2e-4, 1e-6, 0.01
B_SENS = 6


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_sens")
    return make_synthetic_coco(str(d), n_train=24, n_val=4, n_test=4,
                               vocab_size=30, fc_feat_size=24)


def _tasks(copts, split):
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = {"dataset": "mscoco", "caption_options": dict(copts),
           "policy_options": {"fitness": "greedy", "model_options": {
               "input_encoding_size": 16, "rnn_size": 16,
               "fc_feat_size": 24}},
           "tpu": {"seed": 0, "precision": "f32",
                   "sensitivity_split": split}}
    return (JTask(exp, JConfig(batch_size=8), jp(exp)),
            CocoTask(exp, Config(batch_size=8), parse_tpu_config(exp),
                     device="cpu"))


def _theta(jtask, seed=3):
    """A JAX init scaled up, so that a fair share of the sensitivities
    clears the underflow clamp."""
    return 2.0 * np.asarray(jtask.generate_theta(jax.random.PRNGKey(seed)))


def _idx(n=B_SENS, seed=0):
    return np.random.default_rng(seed).choice(24, size=n, replace=False
                                              ).astype(np.int32)


@pytest.mark.parametrize("split", [4, 31, 100])
def test_forward_for_sensitivity_matches_jax(coco, split):
    """The grouped logprobs (B, K) of 5 greedy steps equal JAX's within
    1e-5, with K = (V+1) // split + 1: split 31 divides V + 1 = 31 and
    gets the reference's whole extra zero group."""
    jtask, ttask = _tasks(coco, split)
    th, idx = _theta(jtask), _idx()
    want = np.asarray(jtask.sensitivity_forward(jnp.asarray(th),
                                                jnp.asarray(idx)))
    got = ttask.sensitivity_forward(torch.from_numpy(th.copy()),
                                    torch.as_tensor(idx, dtype=torch.long))
    assert got.shape == want.shape == (B_SENS, ttask.sensitivity_groups)
    assert ttask.sensitivity_groups == 31 // split + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if split == 31:
        assert (got[:, -1] == 0).all()  # the quirk's zero group


@pytest.mark.parametrize("kind,split", [
    ("SM-G-SUM", 4), ("SM-G-SUM", 31), ("SM-G-ABS", 4), ("SM-G-ABS", 31)])
def test_sm_g_matches_jax(coco, kind, split):
    """SM-G-SUM and SM-G-ABS, post-processed, against JAX's
    calc_sensitivity; many entries clear the clamp, and the zero group of
    split 31 adds no NaN."""
    jtask, ttask = _tasks(coco, split)
    th, idx = _theta(jtask), _idx()
    want = np.asarray(jsens.calc_sensitivity(
        jtask, jnp.asarray(th), jnp.asarray(idx), JKind(kind), UNDERFLOW))
    got = tsens.calc_sensitivity(
        ttask, torch.from_numpy(th.copy()),
        torch.as_tensor(idx, dtype=torch.long), MutationKind(kind),
        UNDERFLOW).numpy()
    assert np.isfinite(got).all() and got.min() >= 1.0
    assert (want > 1.0).mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("probes", [1, 7])
def test_probe_estimator_matches_jax_given_its_matrix(coco, probes):
    """The probe estimator fed the Rademacher matrix JAX draws from
    ``probe_key_from_seed`` equals JAX's estimate; the port's own matrix
    is another draw of the same law, fixed by the seed."""
    jtask, ttask = _tasks(coco, 4)
    th, idx = _theta(jtask), _idx()
    key = jsens.probe_key_from_seed(jax.random.key, np.uint32(77))
    K = ttask.sensitivity_groups
    v = np.asarray(jax.random.rademacher(key, (probes, K), jnp.float32))
    want = np.asarray(jsens.calc_sensitivity(
        jtask, jnp.asarray(th), jnp.asarray(idx), JKind.SAFE_GRAD_SUM,
        UNDERFLOW, probes=probes, probe_key=key))
    got = tsens.calc_sensitivity(
        ttask, torch.from_numpy(th.copy()),
        torch.as_tensor(idx, dtype=torch.long), MutationKind.SAFE_GRAD_SUM,
        UNDERFLOW, probes=torch.from_numpy(v.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    mine = tsens.probe_matrix(77, probes, K)
    assert mine.shape == (probes, K) and mine.dtype == torch.float32
    assert set(mine.unique().tolist()) <= {-1.0, 1.0}
    assert torch.equal(mine, tsens.probe_matrix(77, probes, K))
    assert not torch.equal(tsens.probe_matrix(78, 16, K),
                           tsens.probe_matrix(77, 16, K))


def test_calc_sensitivities_rows_do_not_depend_on_p(coco):
    """Every row of calc_sensitivities (parents in vmap groups of
    SENS_GROUP) is the bits of its parent swept alone, whatever the parent
    count (1, 3, 7: one group, and two with a padded last one) and the
    row's place, and within 1e-6 of calc_sensitivity, which runs no outer
    vmap: at one intra-op thread, because MKL's multi-threaded batched
    products under the vmap are not batch-invariant (up to 2.5e-6 apart at
    2 and 8 threads; ``test_torch_threads.py`` holds the 4-thread case)."""
    jtask, ttask = _tasks(coco, 4)
    idx = torch.as_tensor(_idx(), dtype=torch.long)
    kind = MutationKind.SAFE_GRAD_SUM
    thetas = torch.from_numpy(np.stack([_theta(jtask, s) for s in
                                        range(1, 8)]).astype(np.float32))
    assert tsens.SENS_GROUP < 7
    rows = tsens.calc_sensitivities(ttask, thetas, idx, kind, UNDERFLOW)
    three = tsens.calc_sensitivities(ttask, thetas[[6, 2, 0]], idx, kind,
                                     UNDERFLOW)
    for i in range(7):
        alone = tsens.calc_sensitivities(ttask, thetas[i:i + 1], idx, kind,
                                         UNDERFLOW)
        assert torch.equal(rows[i], alone[0]), i
        single = tsens.calc_sensitivity(ttask, thetas[i], idx, kind,
                                        UNDERFLOW)
        torch.testing.assert_close(rows[i], single, rtol=1e-6, atol=0)
    for j, i in enumerate((6, 2, 0)):
        assert torch.equal(three[j], rows[i])
    assert not torch.equal(rows[0], rows[1])


def test_small_helpers_equal_jax(caplog):
    """postprocess, subsample_batch_rows, sm_vector_normalize,
    resolve_probes (SM-G-ABS drops the probes with one warning) and
    PROBE_FOLD are the JAX package's."""
    rng = np.random.default_rng(0)
    raw = np.abs(rng.standard_normal(50)).astype(np.float32) * 0.05
    raw[:3] = 0.0
    np.testing.assert_array_equal(
        tsens.postprocess(torch.from_numpy(raw), 0.02).numpy(),
        np.asarray(jsens.postprocess(jnp.asarray(raw), 0.02)))
    row = rng.integers(0, 100, size=9)
    for k in (0, 4, 9, 20):
        got = tsens.subsample_batch_rows(row, k)
        want = jsens.subsample_batch_rows(row, k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(tsens.sm_vector_normalize(raw, 0.01),
                                  jsens.sm_vector_normalize(raw, 0.01))
    assert tsens.PROBE_FOLD == jsens.PROBE_FOLD
    for kind in ("SM-G-SUM", "SM-G-ABS", ""):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            got = tsens.resolve_probes(MutationKind(kind), 5)
            warned = len(caplog.records)
        assert got == jsens.resolve_probes(JKind(kind), 5)
        assert warned == (kind == "SM-G-ABS")


@pytest.mark.parametrize("suffix", [".npy", ".pt"])
def test_sm_vector_files_load(tmp_path, suffix):
    """An SM-VECTOR file, .npy or a saved torch tensor, loads to the array
    the JAX package loads."""
    from nes_img_captioning_tpu.algorithms.nes import _load_sensitivity_file

    vec = np.random.default_rng(1).random(37).astype(np.float32)
    path = str(tmp_path / f"sens{suffix}")
    if suffix == ".npy":
        np.save(path, vec)
    else:
        torch.save(torch.from_numpy(vec.copy()), path)
    got = tsens.load_sensitivity_file(path)
    np.testing.assert_array_equal(got, vec)
    np.testing.assert_array_equal(got, _load_sensitivity_file(path))


@pytest.mark.parametrize("tpu", [
    {"sensitivity_precision": "bf16", "sensitivity_batch": 64,
     "sensitivity_split": 400, "sensitivity_probes": 3},
    {"sensitivity_precision": "float32"}, {}])
def test_sensitivity_knobs_parse_as_jax(tpu):
    """tpu.sensitivity_* parse to the JAX package's values (the precision's
    aliases too); a bad precision and negative probes are refused by
    both."""
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.utils.config import parse_tpu_config

    exp = {"tpu": dict(tpu)}
    got, want = parse_tpu_config(exp), jp(exp)
    for knob in ("sensitivity_precision", "sensitivity_batch",
                 "sensitivity_split", "sensitivity_probes"):
        assert getattr(got, knob) == getattr(want, knob), knob
    for bad in ({"sensitivity_precision": "fp16"},
                {"sensitivity_probes": -1}):
        for parse in (parse_tpu_config, jp):
            with pytest.raises(ValueError):
                parse({"tpu": bad})

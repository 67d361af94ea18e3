"""Port parity: on-device CIDEr-D (torch) against the JAX DeviceCider and
the host oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nes_img_captioning_tpu.fitness.ciderd import CiderScorer as JaxOracle
from nes_img_captioning_tpu.ops.cider_device import DeviceCider as JaxCider
from nes_img_captioning_tpu_torch.fitness.ciderd import CiderScorer
from nes_img_captioning_tpu_torch.ops import cider_device as tcd

from torch_pin import one_intra_op_thread  # noqa: F401


def _make_gts(rng, n_img=24, vocab=40, T=16):
    gts = []
    for _ in range(n_img):
        m = int(rng.integers(3, 7))  # variable ref counts
        rows = np.zeros((m, T), np.int32)
        for r in range(m):
            L = int(rng.integers(3, T))
            rows[r, :L] = rng.integers(1, vocab, size=L)
            if L > 6:  # repeated tokens: tf > 1
                rows[r, 3:5] = rows[r, 1:3]
        gts.append(rows)
    return gts


def _make_cands(rng, gts, n_cand=64, vocab=40, T=16):
    cands = np.zeros((n_cand, T), np.int32)
    img_ids = rng.integers(0, len(gts), size=n_cand).astype(np.int32)
    for i in range(n_cand):
        if i % 2 == 0:  # corrupted reference copy
            src = gts[img_ids[i]][int(rng.integers(0, len(gts[img_ids[i]])))]
            cands[i] = src
            cands[i, int(rng.integers(0, T))] = int(rng.integers(1, vocab))
        else:  # random caption, mostly unseen n-grams
            L = int(rng.integers(1, T + 1))
            cands[i, :L] = rng.integers(0, vocab, size=L)
    cands[0, :] = np.maximum(cands[0, :], 1)  # no EOS anywhere
    cands[1, 0] = 0  # EOS at position 0
    return cands, img_ids


def test_hash_matches_uint32_numpy():
    """The int64-split hash equals the numpy uint32 hash on the whole int32
    range, sentinels (-1, -3) and keys whose hash has the top bit set."""
    rng = np.random.default_rng(0)
    lo = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    hi = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    lo[:4] = [-1, -3, 0, 2**31 - 1]
    hi[:4] = [-1, -3, 0, -2**31]
    want = tcd._hash_np(lo, hi).astype(np.int64)
    got = tcd._hash_torch(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 2**31).sum() > 1000  # top bit set on about half


@pytest.mark.parametrize("variant", ["cider-d", "cider"])
def test_score_rows_matches_jax_and_oracle(variant):
    """score_rows within 1e-5 of JAX DeviceCider.score_rows and of the host
    oracle; the stored idf keys include hashes with the top bit set."""
    rng = np.random.default_rng(7)
    gts = _make_gts(rng)
    cands, img_ids = _make_cands(rng, gts)

    _, want = JaxOracle(variant=variant).fit_df(gts).score(
        cands, [gts[i] for i in img_ids])
    jax_scores = np.asarray(JaxCider(gts, variant=variant).score_rows(
        jnp.asarray(cands), jnp.asarray(img_ids)))
    dev = tcd.DeviceCider(gts, variant=variant, device="cpu")
    got = dev.score_rows(torch.from_numpy(cands),
                         torch.from_numpy(img_ids)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jax_scores, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    table = dev.dev["table"].numpy().reshape(-1, dev.BUCKET, 3)
    used = table[table[..., 0] != 0]
    hashes = tcd._hash_np(used[:, 0], used[:, 1]).astype(np.int64)
    assert (hashes >= 2**31).any() and (hashes < 2**31).any()


def test_frozen_df_matches_jax():
    """A user-supplied (frozen) DF table with float counts: same scores as
    the JAX scorer given the same table."""
    rng = np.random.default_rng(3)
    gts = _make_gts(rng, n_img=12)
    cands, img_ids = _make_cands(rng, gts, n_cand=16)
    fitted = CiderScorer().fit_df(gts)
    frozen = ([{g: float(c) + 0.5 for g, c in d.items()} for d in fitted.df],
              fitted.ref_len + 1.0)
    jax_scores = np.asarray(JaxCider(gts, frozen_df=frozen).score_rows(
        jnp.asarray(cands), jnp.asarray(img_ids)))
    got = tcd.DeviceCider(gts, frozen_df=frozen, device="cpu").score_rows(
        torch.from_numpy(cands), torch.from_numpy(img_ids)).numpy()
    np.testing.assert_allclose(got, jax_scores, atol=1e-5, rtol=1e-5)

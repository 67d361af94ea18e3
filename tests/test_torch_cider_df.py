"""``caption_options.cider_df`` in the port's CocoTask: the frozen
coco-train-idxs DF table (the reference's ``CiderD(df='coco-train-idxs')``)
reaches the on-device CIDEr-D, as in the JAX package's
``tests/test_cider_frozen_df.py::test_task_threads_cider_df``; toy size
(vocab 60, E = R = 16, 24-d features, B = 4)."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu_torch.fitness.ciderd import (
    CiderScorer,
    load_df_pickle,
)

from torch_pin import one_intra_op_thread  # noqa: F401

B = 4


def _exp(copts, kind="greedy"):
    return {
        "dataset": "mscoco",
        "caption_options": copts,
        "policy_options": {"fitness": kind, "vbn": False, "model_options": {
            "input_encoding_size": 16, "rnn_size": 16, "fc_feat_size": 24}},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"},
    }


def _port_task(copts, kind="greedy"):
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = _exp(copts, kind)
    return CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu")


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """A synthetic split and a frozen table fitted on another corpus (the
    first 9 train images' references) with its own ref_len, pickled in the
    reference's format: one flat dict keyed by tuples of id strings."""
    d = tmp_path_factory.mktemp("cider_df")
    copts = make_synthetic_coco(str(d / "data"), n_train=24, n_val=6,
                                n_test=6, vocab_size=60, fc_feat_size=24,
                                cap_len=6, seed=0)
    gts = _port_task(copts).train_gts
    fitted = CiderScorer(variant="cider-d").fit_df(gts[:9])
    ref_len = float(np.log(40504.0))
    blob = {"document_frequency": {
        tuple(str(t) for t in g): float(c)
        for order in fitted.df for g, c in order.items()},
        "ref_len": ref_len}
    path = str(d / "coco-train-idxs.p")
    with open(path, "wb") as f:
        pickle.dump(blob, f, protocol=2)
    return copts, path


def _cands(rng, gts, n=16, vocab=60, T=16):
    """Corrupted reference copies and random captions, with their images."""
    img = rng.integers(0, len(gts), size=n)
    cands = np.zeros((n, T), np.int32)
    for i, k in enumerate(img):
        if i % 2 == 0:
            cands[i] = gts[k][int(rng.integers(0, len(gts[k])))]
            cands[i, int(rng.integers(0, 6))] = int(rng.integers(1, vocab))
        else:
            L = int(rng.integers(1, T))
            cands[i, :L] = rng.integers(1, vocab, size=L)
    return cands, img


def test_port_task_scores_with_the_frozen_table(frozen):
    """The port's task built with cider_df carries the pickle's ref_len, and
    its device scorer agrees with the frozen-table oracle
    (CiderScorer.set_df) within 2e-5; without cider_df it scores with the
    fitted table (ref_len log 24), and the scores differ."""
    copts, path = frozen
    table = load_df_pickle(path)
    task = _port_task(dict(copts, cider_df=path))
    assert task._device_cider.ref_len == pytest.approx(table[1])
    cands, img = _cands(np.random.default_rng(1), task.train_gts)
    oracle = CiderScorer(variant="cider-d").set_df(*table)
    _, want = oracle.score(cands, [task.train_gts[i] for i in img])
    got = task._device_cider.score_rows(torch.from_numpy(cands),
                                        torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    fitted = _port_task(copts)._device_cider
    assert fitted.ref_len == pytest.approx(np.log(24.0))
    other = fitted.score_rows(torch.from_numpy(cands),
                              torch.from_numpy(img)).numpy()
    assert not np.allclose(got, other, atol=1e-3)


@pytest.mark.parametrize("kind", ["greedy", "self_critical"])
def test_fitness_matches_jax_with_the_frozen_table(frozen, kind):
    """rollout_dec of two members on the port's task and on the JAX task,
    both built with the same cider_df (JAX's Pallas decode in interpret
    mode; the sampling kind fed JAX's Gumbel tables): fitnesses within
    1e-5."""
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JaxTask
    from nes_img_captioning_tpu.utils.config import Config, parse_tpu_config

    copts, path = frozen
    exp = _exp(dict(copts, cider_df=path), kind)
    jtask = JaxTask(exp, Config(batch_size=B), parse_tpu_config(exp))
    jtask._fused_interpret = True
    ttask = _port_task(dict(copts, cider_df=path), kind)
    theta = np.asarray(jtask.generate_theta(jax.random.PRNGKey(6)))
    members = [theta, theta * 1.5]
    idx = np.random.default_rng(7).integers(0, 24, size=(2, B)).astype(
        np.int32)
    keys = [jax.random.key(11), jax.random.key(12)]
    consts = jtask.device_consts()
    jfits = [float(jtask.rollout_dec(
        jtask.decode_layout.to_dec(jnp.asarray(m)), jnp.asarray(i), key=k,
        consts=consts)["fitness"]) for m, i, k in zip(members, idx, keys)]
    lanes = None
    if kind == "self_critical":
        def tables(key):
            seeds = jax.vmap(lambda i: jax.random.bits(
                jax.random.fold_in(key, i)))(jnp.arange(jtask.seq_per_img))
            return np.stack([np.asarray(
                jtask._sample_decode_kwargs(s, B)["gumbel"]) for s in seeds])

        lanes = torch.from_numpy(np.stack([tables(k) for k in keys]))
    vec = torch.stack([ttask.decode_layout.to_dec(torch.from_numpy(m.copy()))
                       for m in members])
    tfits = ttask.rollout_dec(vec, torch.from_numpy(idx), lanes=lanes)
    np.testing.assert_allclose(tfits.numpy(), jfits, atol=1e-5)
    assert np.isfinite(jfits).all() and np.ptp(jfits) > 0

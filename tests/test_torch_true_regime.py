"""The port at experiments/mscoco_nes.json's own proportions on the Karpathy
split, held to the JAX package on the CPU.

* The batch stream: ``EpochSampler.member_batches(2000, 64)`` over the
  split's 113,287 train images, where one generation's 128,000 rows pass
  the split (rows are drawn without replacement within a member only), bit
  for bit JAX's over 3 generations, and again after the stream is saved as
  the z_loader_state sidecar (JSON) and restored mid-stream. numpy only, so
  at full size.
* ``CocoData`` on the same on-disk fixture (per-image .npy features, the
  label file) with restval images: the splits, the ground truths and the
  features, ``train_only`` both ways, and ``_load_fc``'s consolidated cache
  and its memory-mapped reload, at toy size.
* ``DeviceCider``'s tables, built by array operations, bit for bit the
  JAX package's (built by its Python loops and ``CiderScorer.fit_df``) on
  corpora with many n-grams of df >= 2, buckets holding several keys first
  seen in one image, rows of other widths and an image without
  references, and on a frozen DF table.
* One ``NESEngine.generation`` in the file's proportions at toy widths:
  pairs not a multiple of ``pop_chunk`` (7 pairs in chunks of 3, two pad
  lanes), pairs x batch above the train split (28 rows of 12 images), f32
  deltas, against JAX's ``eval_generation`` / ``update(deltas=)`` handed
  JAX's realized deltas. Fitnesses within 1e-5 and theta within 1e-6 (the
  existing port-against-JAX bars, tests/test_torch_generation.py), stepped
  with SGD as tests/test_torch_nes_smg.py steps (ROADMAP §3, the
  conditioning note: Adam's first step is set by its epsilon where a toy
  gradient nearly cancels, SGD's is linear in the gradient).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

from torch_pin import one_intra_op_thread  # noqa: F401

# the Karpathy split's train images (train + restval) and the file's
# nb_offspring and batch_size
SPLIT_TRAIN, PAIRS, BATCH = 113287, 2000, 64
# the toy fixture: 8 train images and 4 restval among them, 4 val, 4 test
N_TRAIN, RESTVAL, N_VAL, N_TEST = 12, (1, 4, 6, 10), 4, 4
F_PAIRS, CHUNK, B, SIGMA, L2 = 7, 3, 4, 0.05, 1e-7
# SGD's first step is -SGD_STEP * 0.1 * globalg (tests/test_torch_nes_smg.py)
SGD_STEP = 10.0


# ---- the batch stream at the split's size -----------------------------------


def test_member_batches_match_jax_past_the_split_and_across_a_resume():
    """2000 members x 64 rows from 113,287 images: each generation draws
    more rows than the split holds, each member's rows distinct; 3
    generations bit for bit JAX's, then the stream saved as the sidecar's
    JSON and restored (by each package's ``from_state_dict`` and by the
    masters' ``build_sampler``) continues bit for bit for 2 more."""
    from nes_img_captioning_tpu.data.core import EpochSampler as JSampler
    from nes_img_captioning_tpu_torch.data.core import (
        EpochSampler,
        build_sampler,
    )

    assert PAIRS * BATCH > SPLIT_TRAIN
    port, ref = EpochSampler(SPLIT_TRAIN, seed=7), JSampler(SPLIT_TRAIN,
                                                            seed=7)
    for _ in range(3):
        a, b = port.member_batches(PAIRS, BATCH), ref.member_batches(PAIRS,
                                                                    BATCH)
        assert a.shape == (PAIRS, BATCH) and a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < SPLIT_TRAIN
        srt = np.sort(a, axis=1)
        assert (srt[:, 1:] != srt[:, :-1]).all()
    state = json.loads(json.dumps(port.state_dict()))
    assert state == json.loads(json.dumps(ref.state_dict()))
    resumed = [EpochSampler.from_state_dict(state),
               JSampler.from_state_dict(state),
               build_sampler(SPLIT_TRAIN, np.random.default_rng(0), state)]
    for _ in range(2):
        want = ref.member_batches(PAIRS, BATCH)
        np.testing.assert_array_equal(port.member_batches(PAIRS, BATCH), want)
        for s in resumed:
            np.testing.assert_array_equal(s.member_batches(PAIRS, BATCH),
                                          want)


# ---- CocoData with restval --------------------------------------------------


@pytest.fixture(scope="module")
def coco_files(tmp_path_factory):
    """The on-disk fixture (JAX's writer): the restval images are marked in
    cocotalk.json among the train block's."""
    root = tmp_path_factory.mktemp("regime_coco")
    copts = make_synthetic_coco(str(root / "d"), n_train=N_TRAIN,
                                n_val=N_VAL, n_test=N_TEST, vocab_size=40,
                                fc_feat_size=24, cap_len=6, seed=3)
    with open(copts["input_json"]) as f:
        info = json.load(f)
    for i in RESTVAL:
        info["images"][i]["split"] = "restval"
    with open(copts["input_json"], "w") as f:
        json.dump(info, f)
    return root / "d"


def _copy(src, dst) -> dict:
    """A copy of the fixture at ``dst`` (its own consolidation cache);
    returns its caption_options."""
    shutil.copytree(src, dst)
    return {"input_json": str(dst / "cocotalk.json"),
            "input_label_h5": str(dst / "cocotalk_label.h5"),
            "input_fc_dir": str(dst / "fc")}


@pytest.mark.parametrize("train_only", [0, 1])
def test_coco_data_with_restval_equals_jax(coco_files, tmp_path, train_only):
    """restval joins train unless train_only: the same split sizes, image
    order, ground truths and features as JAX's CocoData."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JData
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData

    port = CocoData(_copy(coco_files, tmp_path / "port"), train_only)
    ref = JData(_copy(coco_files, tmp_path / "jax"), train_only)
    n_rest = len(RESTVAL)
    want = {"train": N_TRAIN - n_rest * train_only, "val": N_VAL,
            "test": N_TEST}
    for split, n in want.items():
        assert port.split_len(split) == ref.split_len(split) == n
        assert port.split_ix[split] == ref.split_ix[split]
        assert port.split_image_ids(split) == ref.split_image_ids(split)
        np.testing.assert_array_equal(port.split_feats(split),
                                      ref.split_feats(split))
        for a, b in zip(port.split_gts(split), ref.split_gts(split),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    assert (set(RESTVAL) <= set(port.split_ix["train"])) == (not train_only)


def test_load_fc_cache_and_mmap_reload_equal_jax(coco_files, tmp_path):
    """The per-image .npy files consolidate into the same cache files as
    JAX's; a second load memory-maps the cache (the port's own, and JAX's);
    a cache of another image set is rebuilt, not trusted."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JData
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData

    port_opts = _copy(coco_files, tmp_path / "port")
    jax_opts = _copy(coco_files, tmp_path / "jax")
    cold, ref = CocoData(port_opts), JData(jax_opts)
    assert not isinstance(cold._fc, np.memmap)
    for suffix in ("_fc.npy", "_ids.npy"):
        a, b = (np.load(o["input_fc_dir"] + suffix)
                for o in (port_opts, jax_opts))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for opts in (port_opts, jax_opts):
        warm = CocoData(opts)
        assert isinstance(warm._fc, np.memmap)
        np.testing.assert_array_equal(np.asarray(warm._fc), ref._fc)
        np.testing.assert_array_equal(warm.split_feats("train"),
                                      ref.split_feats("train"))
    ids_path = port_opts["input_fc_dir"] + "_ids.npy"
    np.save(ids_path, np.load(ids_path)[::-1].copy())
    stale = CocoData(port_opts)
    assert not isinstance(stale._fc, np.memmap)
    np.testing.assert_array_equal(stale._fc, ref._fc)


# ---- DeviceCider's tables ---------------------------------------------------


def _corpus(seed: int, n_img: int, vocab: int, T: int = 16) -> list:
    """Per image 1-6 reference rows of 0-16 tokens from a small vocabulary:
    most n-grams recur across images."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_img):
        rows = np.zeros((int(rng.integers(1, 7)), T), np.int32)
        for r in rows:
            n = int(rng.integers(0, T + 1))
            r[:n] = rng.integers(1, vocab, size=n)
        out.append(rows)
    return out


@pytest.mark.parametrize("case", ["fitted", "fitted_cider", "ragged",
                                  "frozen"])
def test_device_cider_tables_equal_jax(case, monkeypatch):
    """Every table (bucket rows, packed reference windows, norms, lengths,
    masks, counts), ref_len and the bucket mask bit for bit JAX's; the
    fitted corpora put several stored keys first seen in one image into one
    bucket, whose slot order comes from that image's n-gram set."""
    from nes_img_captioning_tpu.ops.cider_device import DeviceCider as JCider
    from nes_img_captioning_tpu_torch.fitness.ciderd import CiderScorer
    from nes_img_captioning_tpu_torch.ops import cider_device as tcd

    gts, kw = _corpus(3, 2000, 30), {}
    if case == "fitted_cider":
        kw["variant"] = "cider"
    elif case == "ragged":
        gts = _corpus(1, 300, 10)
        gts += [np.zeros((0, 16), np.int32), np.array([[3, 0, 0]], np.int32),
                np.arange(1, 10, dtype=np.int32)[None]]
    elif case == "frozen":
        gts = _corpus(5, 100, 8)
        fitted = CiderScorer().fit_df(gts)
        kw["frozen_df"] = ([{g: float(c) + 0.5 for g, c in d.items()}
                            for d in fitted.df], fitted.ref_len + 1.0)
    set_ranks, ranks = tcd._set_ranks, []

    def spy(refs, n):
        ranks.append(n)
        return set_ranks(refs, n)

    monkeypatch.setattr(tcd, "_set_ranks", spy)
    port, ref = tcd.DeviceCider(gts, device="cpu", **kw), JCider(gts, **kw)
    assert port.ref_len == ref.ref_len
    assert port._bucket_mask == ref._bucket_mask
    assert set(port.dev) == set(ref.dev)
    for k, v in ref.dev.items():
        a, b = port.dev[k].numpy(), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=k)
    table = port.dev["table"].numpy().reshape(-1, port.BUCKET, 3)
    assert int((table[..., 0] != 0).sum()) > len(gts) // 2
    if case != "frozen":
        assert ranks  # ties between keys first seen in one image


# ---- one generation in the file's proportions -------------------------------


@pytest.fixture(scope="module")
def jax_generation(coco_files, tmp_path_factory):
    """JAX's generation at f32 (its pair path in interpret mode) on the
    restval fixture: 7 pairs in chunks of 3 on 4-row batches drawn by the
    epoch sampler; its realized deltas, fitnesses and SGD step."""
    import jax.numpy as jnp

    from nes_img_captioning_tpu.algorithms.nes import NESEngine
    from nes_img_captioning_tpu.algorithms.optimizers import SGD
    from nes_img_captioning_tpu.ops.mutation import MutationKind
    from nes_img_captioning_tpu.tasks.captioning import CocoTask
    from nes_img_captioning_tpu.utils.config import Config, parse_tpu_config
    from nes_img_captioning_tpu_torch.data.core import EpochSampler

    copts = _copy(coco_files, tmp_path_factory.mktemp("gen") / "d")
    exp = {"dataset": "mscoco", "caption_options": copts,
           "policy_options": {"fitness": "greedy", "model_options": {
               "input_encoding_size": 16, "rnn_size": 16,
               "fc_feat_size": 24}},
           "tpu": {"seed": 0, "fused_decode": True, "precision": "f32",
                   "pop_chunk": CHUNK}}
    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp))
    task._fused_interpret = True
    assert task.train_n == N_TRAIN and F_PAIRS * B > N_TRAIN
    assert F_PAIRS % CHUNK
    eng = NESEngine(task, SGD(SGD_STEP), MutationKind.DEFAULT,
                    pop_chunk=CHUNK)
    seeds = np.random.default_rng(8).integers(0, 2**32, size=F_PAIRS,
                                              dtype=np.uint32)
    idx = EpochSampler(N_TRAIN, seed=4).member_batches(F_PAIRS, B)
    theta = task.generate_theta(jax.random.PRNGKey(6))
    sens = jnp.ones((eng.dim,), jnp.float32)
    art, deltas = eng.eval_generation(theta, sens, SIGMA, seeds, idx)
    fitnesses = task.host_fitness(art, idx)
    _, theta_new, _ = eng.update(
        theta, eng.optimizer.init(eng.dim), sens, SIGMA, seeds, fitnesses,
        SGD_STEP, L2, deltas=deltas)
    deltas = np.asarray(deltas)
    assert deltas.shape[:2] == (-(-F_PAIRS // CHUNK), CHUNK)
    return {"exp": exp, "seeds": seeds, "idx": idx,
            "theta": np.asarray(theta),
            "deltas": deltas.reshape(-1, eng.dim)[:F_PAIRS],
            "fitnesses": np.asarray(fitnesses),
            "theta_new": np.asarray(theta_new)}


@pytest.mark.parametrize("kernel_perturb", [True, False],
                         ids=["pair_kernel", "per_member"])
def test_padded_generation_past_the_split_matches_jax(jax_generation,
                                                      kernel_perturb):
    """The port's generation, handed JAX's deltas (f32, decode order), on
    the same theta, seeds and batches: 3 chunks of 3 pairs, the last with
    2 pad lanes weighted 0; fitnesses within 1e-5 of JAX's, theta after
    the SGD step within 1e-6."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import SGD
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    ref = jax_generation
    task = CocoTask(ref["exp"], Config(batch_size=B),
                    parse_tpu_config(ref["exp"]), device="cpu")
    eng = NESEngine(task, SGD(SGD_STEP), MutationKind.DEFAULT,
                    pop_chunk=CHUNK, kernel_perturb=kernel_perturb,
                    delta_dtype="f32")
    assert eng._kernel_perturb is kernel_perturb
    assert eng._plan(F_PAIRS) == (3, CHUNK)
    lay = task.decode_layout
    by_seed = {int(s): lay.to_dec(torch.from_numpy(d.copy()), pad_scale=0.0)
               for s, d in zip(ref["seeds"], ref["deltas"])}
    eng.delta_of = lambda scale_dec, seed: by_seed[int(seed)]
    theta = torch.from_numpy(ref["theta"].copy())
    th, _, packed = eng.generation(
        theta, eng.optimizer.init(eng.dim, "cpu"), torch.ones_like(theta),
        SIGMA, ref["seeds"], ref["idx"], SGD_STEP, L2)
    fits = eng.unpack(packed, F_PAIRS)[0]
    np.testing.assert_allclose(fits, ref["fitnesses"], rtol=0, atol=1e-5)
    assert np.ptp(fits) > 0
    np.testing.assert_allclose(th.numpy(), ref["theta_new"], rtol=0,
                               atol=1e-6)
    assert not np.array_equal(th.numpy(), ref["theta"])

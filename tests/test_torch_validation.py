"""Validation on the card's path, on the CPU at toy size (vocab 40,
E = R = 16, 24-d features): ``CocoTask.validate_device`` against the JAX
package's and the host ``validate``; the row-block decode against one decode
per block; ``es.podium_merge`` against the JAX package's and a host
``Podium``; and ``NESMaster`` with ``tpu.fused_validation`` against the
port's and the JAX package's host-validated masters."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """12 train and 11 val images: num_val_items 10 at val_batch_size 4
    leaves the JAX package a ragged last chunk."""
    d = tmp_path_factory.mktemp("coco_val")
    return make_synthetic_coco(str(d), n_train=12, n_val=11, n_test=4,
                               vocab_size=40, fc_feat_size=24, cap_len=6,
                               seed=0)


def _task_exp(copts):
    return {"dataset": "mscoco", "caption_options": dict(copts),
            "policy_options": {"fitness": "greedy", "vbn": False,
                               "model_options": {"input_encoding_size": 16,
                                                 "rnn_size": 16,
                                                 "fc_feat_size": 24}}}


def _tasks(copts):
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JaxTask
    from nes_img_captioning_tpu.utils.config import Config as JaxConfig
    from nes_img_captioning_tpu.utils.config import TpuConfig as JaxTpu
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    cfg = dict(batch_size=8, val_batch_size=4, num_val_items=10)
    exp = _task_exp(copts)
    return (CocoTask(exp, Config(**cfg), TpuConfig(seed=0), device="cpu"),
            JaxTask(exp, JaxConfig(**cfg), JaxTpu(seed=0)))


@pytest.mark.parametrize("seed", [0, 3])
def test_validate_device_matches_jax_and_host(coco, seed):
    """validate_device (the row-block decode, the word-id gather, the
    device's word-level CIDEr) equals the JAX package's validate_device
    (jitted on the CPU) and the port's host validate (native scorer) within
    rtol 2e-5, atol 2e-6 (f32 scores against f32 and f64 ones), over 10 of
    the 11 val images; it returns a 0-d f32 tensor."""
    task, jtask = _tasks(coco)
    jtheta = jtask.generate_theta(jax.random.PRNGKey(seed))
    theta = torch.from_numpy(np.asarray(jtheta).copy())
    vconsts = task.device_val_consts()
    assert vconsts is task.device_val_consts()  # built once
    assert vconsts["feats"].shape == (10, 24)
    dev = task.validate_device(theta, vconsts)
    assert dev.dim() == 0 and dev.dtype == torch.float32
    want = float(jax.jit(jtask.validate_device)(
        jtheta, jtask.device_val_consts()))
    host = task.validate(theta)
    assert host > 0
    np.testing.assert_allclose(float(dev), want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(dev), host, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(host, jtask.validate(jtheta), rtol=1e-6)


@pytest.mark.parametrize("vocab_tile", [0, 128], ids=["K1", "K4"])
def test_decode_rows_equals_one_decode_per_block(coco, vocab_tile):
    """decode_rows over 300 rows (blocks of 128, 128 and 44) gives the
    tokens and lp of one decode_fused per block of 128 rows bit for bit,
    and the tokens of one decode of all 300 rows at once (rows are
    independent; only lp of finished rows depends on its block's exit)."""
    from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc

    task, _ = _tasks(coco)
    g = torch.Generator().manual_seed(1)
    theta = task.spec.init_theta(g) * 3
    params = tdc.prepare_decode_params(task.spec, theta, task.model.options)
    feats = torch.randn((300, 24), generator=g)
    before = tdc.decode_rows.launches
    seq, lp = tdc.decode_rows(params, feats, 16, True, vocab_tile=vocab_tile)
    assert tdc.decode_rows.launches == before  # the CPU runs the plain twin
    blocks = [tdc.decode_fused(params, feats[lo:lo + 128], 16, True,
                               vocab_tile=vocab_tile)
              for lo in (0, 128, 256)]
    assert torch.equal(seq, torch.cat([b[0] for b in blocks]))
    assert torch.equal(lp, torch.cat([b[1] for b in blocks]))
    whole = tdc.decode_fused_plain(params, feats, 16, True,
                                   vocab_tile=vocab_tile)
    assert torch.equal(seq, whole[0])
    assert seq.shape == lp.shape == (300, 16) and (seq > 0).any()
    # the plain twin's top-2 gaps are those of the per-block decodes
    seq_g, lp_g, gap = tdc.decode_rows_plain(params, feats, 16, True,
                                             vocab_tile=vocab_tile,
                                             top2_gap=True)
    gaps = [tdc.decode_fused_plain(params, feats[lo:lo + 128], 16, True,
                                   vocab_tile=vocab_tile, top2_gap=True)[2]
            for lo in (0, 128, 256)]
    assert torch.equal(seq_g, seq) and torch.equal(lp_g, lp)
    assert torch.equal(gap, torch.cat(gaps)) and (gap > 0).any()
    # the task's host decode takes the same launch over the val subset
    got = task._decode_split(theta, task.val_fc, 10)
    np.testing.assert_array_equal(
        got, tdc.decode_fused_plain(params, task.val_fc[:10], 16,
                                    False)[0].numpy())


def test_decode_params_own_their_storage(coco):
    """prepare_decode_params (the validation's params) copies every tensor
    out of theta: a bias left a view would sit at theta's offset, which the
    kernels' 16-byte bulk copies refuse whenever the vocab + 1 is not a
    multiple of 4 (vocab 40 here)."""
    from nes_img_captioning_tpu_torch.ops.decode_cuda import (
        prepare_decode_params,
    )

    task, _ = _tasks(coco)
    theta = task.spec.init_theta(torch.Generator().manual_seed(0))
    base = theta.untyped_storage().data_ptr()
    for dt in (torch.float32, torch.bfloat16):
        params = prepare_decode_params(task.spec, theta, task.model.options,
                                       dtype=dt)
        for k, v in params.items():
            assert v.untyped_storage().data_ptr() != base, k
            assert v.is_contiguous() and v.storage_offset() == 0, k


def test_podium_merge_matches_jax_and_podium(tmp_path):
    """podium_merge against the JAX package's and a host Podium seeded with
    the incumbents, on the tie-heavy trials of tests/test_fused_es.py: a
    candidate tying an incumbent never displaces it, equal-scored
    candidates enter in their order, the rows are selected exactly."""
    from nes_img_captioning_tpu.algorithms.es import podium_merge as jmerge
    from nes_img_captioning_tpu_torch.algorithms.es import podium_merge
    from nes_img_captioning_tpu_torch.algorithms.podium import Podium

    rng = np.random.default_rng(7)
    E, C, D = 3, 4, 6
    value_set = np.asarray([0.125, 0.25, 0.25, 0.5, 1.0], np.float32)
    for trial in range(25):
        e_scores = np.sort(rng.choice(value_set, E))[::-1].astype(np.float32)
        c_scores = rng.choice(value_set, C).astype(np.float32)
        if trial % 5 == 0:
            e_scores[-1] = -np.inf  # an unfilled slot
        e_rows = rng.normal(size=(E, D)).astype(np.float32)
        c_rows = rng.normal(size=(C, D)).astype(np.float32)
        rows, scores = podium_merge(*map(torch.from_numpy, (
            e_rows, e_scores, c_rows, c_scores)))
        j_rows, j_scores = jax.jit(jmerge)(*map(jnp.asarray, (
            e_rows, e_scores, c_rows, c_scores)))
        np.testing.assert_array_equal(scores.numpy(), np.asarray(j_scores))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))

        d = tmp_path / f"t{trial}"
        pod = Podium(0, str(d), num_elites=E)
        seed = []
        for i in range(E):
            if np.isfinite(e_scores[i]):
                p = str(d / f"inc{i}.npy")
                np.save(p, e_rows[i])
                seed.append((p, float(e_scores[i])))
        pod.init_from_infos({"best_elites": seed})
        cands = []
        for i in range(C):
            p = str(d / f"cand{i}.npy")
            np.save(p, c_rows[i])
            cands.append((p, float(c_scores[i])))
        pod.record_elites(cands)
        want = [(p, s) for p, s in pod.best_elites() if p]
        np.testing.assert_array_equal(
            scores.numpy()[:len(want)],
            np.asarray([s for _, s in want], np.float32),
            err_msg=f"trial {trial}: {e_scores} + {c_scores}")
        for rank, (path, _) in enumerate(want):
            np.testing.assert_array_equal(rows.numpy()[rank], np.load(path))


def _master_exp(copts, log_dir, theta_path, **tpu):
    """experiments/mscoco_nes.json cut to toy size: 4 pairs, batch 4, 10
    of 11 val images at val_batch_size 4, 2 elites, a snapshot every 2
    iterations, blocks of 2, f32; the run starts from ``theta_path``."""
    with open(os.path.join(REPO, "experiments", "mscoco_nes.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=4, val_batch_size=4, num_val_items=10,
                         snapshot_freq=2)
    exp["policy_options"]["model_options"].update(
        input_encoding_size=16, rnn_size=16, fc_feat_size=24)
    exp["nb_offspring"] = 4
    exp["num_elites"] = 2
    exp["caption_options"] = dict(copts)
    exp["from_single"] = str(theta_path)
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, "precision": "f32",
                  "gens_per_dispatch": 2, **tpu}
    exp["log_dir"] = str(log_dir)
    return exp


def _slots(master):
    """The podium's (score, theta) per filled slot, read from its files."""
    out = []
    for path, score in master.it.best_elites():
        if path:
            th = master.task.spec.load_pth(path)
            out.append((score, np.asarray(th, np.float32)))
    return out


def test_fused_master_matches_host_and_jax(coco, tmp_path):
    """4 iterations of the port's NESMaster with fused validation (blocks
    of 2), of its host-validated master and of the JAX package's, all from
    one theta, the JAX master's deltas handed to the port (delta_of): the
    fused theta is bitwise the port's host path's and within 1e-6 of
    JAX's (the tolerance of tests/test_torch_generation.py); the acc
    series within rtol 1e-4 of both; the podium's scores within rtol 1e-4
    and its slot files' theta equal to the host path's."""
    from nes_img_captioning_tpu.algorithms.nes import NESMaster as JaxMaster
    from nes_img_captioning_tpu.ops.mutation import gaussian_noise
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    task, jtask = _tasks(coco)
    theta_path = tmp_path / "theta.pth"
    task.spec.save_pth(torch.from_numpy(np.asarray(
        jtask.generate_theta(jax.random.PRNGKey(2))).copy()), str(theta_path))
    jmaster = JaxMaster(_master_exp(coco, tmp_path / "jax", theta_path,
                                    fused_validation=False))
    jmaster.run_master(max_iterations=4)

    def jax_delta(master):
        lay, jeng = master.task.decode_layout, jmaster.engine

        def delta_of(scale_dec, seed):
            d = gaussian_noise(jeng._mk_key(np.uint32(seed)), jeng.dim,
                               np.float32(0.01))
            return lay.to_dec(torch.from_numpy(np.asarray(d).copy()),
                              pad_scale=0.0)
        return delta_of

    runs = {}
    for name, fused in (("fused", True), ("host", False)):
        m = NESMaster(_master_exp(coco, tmp_path / name, theta_path,
                                  fused_validation=fused), device="cpu")
        m.engine.delta_of = jax_delta(m)
        m.run_master(max_iterations=4)
        assert m._val_fused is fused
        runs[name] = m
    fused, host = runs["fused"], runs["host"]
    assert fused.it.iteration() == host.it.iteration() == 4
    assert torch.equal(fused.theta, host.theta)
    np.testing.assert_allclose(fused.theta.numpy(), np.asarray(jmaster.theta),
                               atol=1e-6)
    assert not torch.equal(fused.theta,
                           fused.task.spec.load_pth(str(theta_path)))
    acc = fused.stats.acc_stats()
    assert len(acc) == 4 and np.ptp(acc) > 0
    np.testing.assert_allclose(acc, host.stats.acc_stats(), rtol=1e-4)
    np.testing.assert_allclose(acc, jmaster.stats.acc_stats(), rtol=1e-4)
    best = fused.stats.to_dict()["best_acc_so_far_stats"]
    assert len(best) == 4
    np.testing.assert_allclose(best,
                               host.stats.to_dict()["best_acc_so_far_stats"],
                               rtol=1e-4)
    for m in (host, jmaster):
        np.testing.assert_allclose(fused.stats.score_stats()[1],
                                   m.stats.score_stats()[1], rtol=1e-4)
    slots_f, slots_h = _slots(fused), _slots(host)
    assert len(slots_f) == len(slots_h) == 2
    for (s_f, th_f), (s_h, th_h), (_, s_j) in zip(
            slots_f, slots_h, jmaster.it.best_elites()):
        np.testing.assert_allclose(s_f, s_h, rtol=1e-4)
        np.testing.assert_allclose(s_f, s_j, rtol=1e-4)
        np.testing.assert_array_equal(th_f, th_h)
    # the last snapshot (iteration 4) names the slot files written from
    # the device podium, with the adopted scores
    assert fused._podium_dirty is False
    (zinfo,) = glob.glob(os.path.join(str(tmp_path / "fused"), "snapshot",
                                      "z_info_*.json"))
    with open(zinfo) as f:
        infos = json.load(f)
    assert [tuple(e) for e in infos["best_elites"]] == \
        [tuple(e) for e in fused.it.best_elites()]


@pytest.mark.parametrize("case,tpu,config,want", [
    ("auto_blocks", {}, {}, True),
    ("auto_per_generation", {"gens_per_dispatch": 1}, {}, False),
    ("true_per_generation", {"gens_per_dispatch": 1,
                             "fused_validation": True}, {}, True),
    ("false", {"fused_validation": False}, {}, False),
    ("true_val_freq_2", {"fused_validation": True, "val_freq": 2}, {},
     False),
    ("auto_patience", {}, {"patience": 3}, False),
])
def test_fused_validation_resolves_as_jax(coco, tmp_path, case, tpu, config,
                                          want):
    """tpu.fused_validation resolves as in the JAX package:
    experiments/mscoco_nes.json's "auto" with gens_per_dispatch 8 turns it
    on; true needs a capable run (val_freq 1, patience 0) and stays off
    otherwise."""
    from nes_img_captioning_tpu.algorithms.nes import NESMaster as JaxMaster
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    def exp(name):
        with open(os.path.join(REPO, "experiments", "mscoco_nes.json")) as f:
            e = json.load(f)
        e["config"].update(batch_size=4, val_batch_size=4, num_val_items=4,
                           **config)
        e["policy_options"]["model_options"].update(
            input_encoding_size=16, rnn_size=16, fc_feat_size=24)
        e["nb_offspring"] = 4
        e["caption_options"] = dict(coco)
        e["tpu"].update(tpu)
        e["log_dir"] = str(tmp_path / name)
        return e

    port = NESMaster(exp("port"), device="cpu")
    assert port.tpu_cfg.gens_per_dispatch == tpu.get("gens_per_dispatch", 8)
    assert port._val_fused_mode() is want
    # "auto" that cannot turn on builds no device val consts
    if case == "auto_per_generation":
        assert port.task._val_dev_cache is None
    assert JaxMaster(exp("jax"))._val_fused_mode() is want

"""The port's NIC-NES master end to end on the CPU, at toy size: the CLI,
snapshots that cross-load with the JAX package, resume, and the host
bookkeeping (Iteration, Statistics, Podium) against the JAX modules."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def coco_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_master")
    return make_synthetic_coco(str(d), n_train=12, n_val=4, n_test=4,
                               vocab_size=40, fc_feat_size=24, cap_len=6,
                               seed=0)


def _exp(copts, log_dir, **tpu):
    """experiments/mscoco_nes.json cut to toy size (vocab 40, E = R = 16,
    4 pairs, batch 4, 4 validation images)."""
    with open(os.path.join(REPO, "experiments", "mscoco_nes.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=4, val_batch_size=4, num_val_items=4,
                         snapshot_freq=2)
    exp["policy_options"]["model_options"].update(
        input_encoding_size=16, rnn_size=16, fc_feat_size=24)
    exp["nb_offspring"] = 4
    exp["caption_options"] = copts
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, "precision": "f32", **tpu}
    exp["log_dir"] = str(log_dir)
    return exp


def _zinfo(log_dir) -> str:
    (path,) = glob.glob(os.path.join(str(log_dir), "snapshot",
                                      "z_info_*.json"))
    return path


def test_cli_master_writes_a_snapshot(coco_files, tmp_path):
    """``python -m nes_img_captioning_tpu_torch.main master --device cpu``
    trains 3 iterations, with kernel noise, and leaves z_info, the current
    model's .pth, optimizer.tar and the validation predictions."""
    exp = _exp(coco_files, tmp_path / "run", kernel_noise=True)
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    out = subprocess.run(
        [sys.executable, "-m", "nes_img_captioning_tpu_torch.main", "master",
         "--exp_file", str(path), "--max_iterations", "3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(_zinfo(tmp_path / "run")) as f:
        infos = json.load(f)
    assert infos["iter"] == 3 and len(infos["acc_stats"]) == 3
    assert os.path.isfile(infos["current_model"])
    assert os.path.isfile(infos["optimizer_state"])
    assert infos["optimizer_state"].endswith("optimizer.tar")
    with open(tmp_path / "run" / "eval" / "eval_cache_val.json") as f:
        preds = json.load(f)
    assert len(preds) == 4 and {"image_id", "caption"} <= set(preds[0])
    assert "RUNNING NIC-NES" in out.stderr


def _jax_master(exp):
    from nes_img_captioning_tpu.algorithms.nes import NESMaster

    return NESMaster(exp)


def _torch_master(exp):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    return NESMaster(exp, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshots_cross_load(coco_files, tmp_path, writer):
    """A snapshot written by either package loads in the other: the same
    z_info keys, and theta and the Adam state read back bit for bit."""
    from nes_img_captioning_tpu.algorithms.optimizers import Adam as JaxAdam
    from nes_img_captioning_tpu_torch.algorithms.optimizers import Adam

    make = {"jax": _jax_master, "torch": _torch_master}
    reader = "torch" if writer == "jax" else "jax"
    first = make[writer](_exp(coco_files, tmp_path / "a"))
    first.run_master(max_iterations=2)
    zinfo = _zinfo(tmp_path / "a")
    exp2 = _exp(coco_files, tmp_path / "b")
    exp2["from_infos"] = zinfo
    second = make[reader](exp2)
    theta1 = np.asarray(first.theta)
    np.testing.assert_array_equal(np.asarray(second.theta), theta1)
    assert second.it.iteration() == 1  # stored post-increment, minus one
    assert len(second.stats.score_stats()[1]) == 2
    with open(zinfo) as f:
        infos = json.load(f)
    # both packages read the optimizer file the same, bit for bit
    jst = JaxAdam(0.1).load_from_file(infos["optimizer_state"])
    tst = Adam(0.1).load_from_file(infos["optimizer_state"], "cpu")
    assert int(jst.t) == int(tst.t) == 2
    for a, b in ((jst.m, tst.m), (jst.v, tst.v)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(second.opt_state.v),
                                  tst.v.numpy())
    # and z_info has the same keys whichever package wrote it
    second.run_master(max_iterations=2)
    with open(_zinfo(tmp_path / "b")) as f:
        assert set(json.load(f)) == set(infos)


def test_resume_continues_the_run(coco_files, tmp_path):
    """4 iterations give the same theta, bit for bit, as 2 iterations and
    2 more resumed from the snapshot: the sidecar restores the batch and
    the seed streams. (The resumed run labels its first generation with
    the snapshot's iteration, as the JAX package does.)"""
    whole = _torch_master(_exp(coco_files, tmp_path / "whole",
                               kernel_noise=True))
    whole.run_master(max_iterations=4)
    half = _torch_master(_exp(coco_files, tmp_path / "half",
                              kernel_noise=True))
    half.run_master(max_iterations=2)
    exp = _exp(coco_files, tmp_path / "resumed", kernel_noise=True)
    exp["from_infos"] = _zinfo(tmp_path / "half")
    resumed = _torch_master(exp)
    resumed.run_master(max_iterations=3)
    assert len(resumed.stats.score_stats()[1]) == 4
    assert torch.equal(resumed.theta, whole.theta)
    assert not torch.equal(half.theta, whole.theta)
    assert int(resumed.opt_state.t) == int(whole.opt_state.t) == 4


def _drive_bookkeeping(pkg, log_dir):
    """The same fitness and eval sequence through a package's Iteration,
    Statistics and Podium: the schedule anneals at iterations 2, 4 and 6,
    and patience at iteration 5 (two evals that tie the podium)."""
    import importlib

    it_mod = importlib.import_module(f"{pkg}.algorithms.iteration")
    st_mod = importlib.import_module(f"{pkg}.algorithms.statistics")
    cfg_mod = importlib.import_module(f"{pkg}.utils.config")
    config = cfg_mod.Config(noise_stdev=0.02, batch_size=8, patience=1,
                            stdev_divisor=2, bs_multiplier=2,
                            schedule_start=0, schedule_limit=2)
    exp = {"nb_offspring": 4, "num_elites": 2, "log_dir": str(log_dir)}
    it, stats = it_mod.Iteration(config, exp), st_mod.Statistics()
    rng = np.random.default_rng(5)
    cand = os.path.join(str(log_dir), "cand.pth")
    for g, score in enumerate([0.5, 0.7, 0.6, 0.6, 0.6, 0.9]):
        it.incr_iteration()
        with open(cand, "w") as f:
            f.write(f"theta {g}")
        it.record_eval_result(0, cand, score)
        it.process_evaluated_elites()
        stats.record_update_ratio(0.01 * (g + 1))
        stats.record_score_stats(rng.normal(size=8).astype(np.float32))
        stats.record_bs_stats(it.batch_size())
        stats.record_step_time_stats(dt=0.25 * g)
        stats.record_norm_stats(np.full(6, 0.1 * g, np.float32))
        stats.record_acc_stats(score)
        stats.record_best_acc_stats(it.best_elites()[0][1])
        stats.record_std_stats(it.noise_stdev())
    return it, stats


def test_bookkeeping_matches_jax(tmp_path):
    """Iteration, Statistics and Podium: the same to_dict() (paths taken
    relative to each run's log dir; the memory series are the host's) and
    the same podium files for the same sequence, annealing included."""
    it_j, st_j = _drive_bookkeeping("nes_img_captioning_tpu", tmp_path / "j")
    it_t, st_t = _drive_bookkeeping("nes_img_captioning_tpu_torch",
                                    tmp_path / "t")

    def rel(d, root):
        return json.loads(json.dumps(d).replace(str(root), "<log>"))

    assert rel(it_t.to_dict(), tmp_path / "t") == \
        rel(it_j.to_dict(), tmp_path / "j")
    assert it_t.noise_stdev() == 0.02 / 16  # three schedule steps and
    assert it_t.batch_size() == 128         # one patience step
    dj, dt = st_j.to_dict(), st_t.to_dict()
    assert set(dj) == set(dt)
    for key in dj:
        if key != "mem_stats":
            assert dt[key] == dj[key], key
    for (pj, sj), (pt, s_t) in zip(it_j.best_elites(), it_t.best_elites()):
        assert sj == s_t
        with open(pj) as fj, open(pt) as ft:
            assert fj.read() == ft.read()
    st_t.update_mem_stats()
    rss, used = st_t.to_dict()["mem_stats"][0][-1], \
        st_t.to_dict()["mem_stats"][1][-1]
    assert rss > 0 and 0 < used <= 100


def test_resume_seed_streams(coco_files, tmp_path):
    """After a from_infos resume the JAX master's seed stream starts afresh
    from tpu.seed, so it draws generation 1's seeds again (the fault
    ROADMAP.md section 3 records); the port's sidecar restores the stream
    where the snapshot left it."""
    fresh = np.random.default_rng(0).bit_generator.state
    for make in (_jax_master, _torch_master):
        first = make(_exp(coco_files, tmp_path / make.__name__ / "a"))
        first.run_master(max_iterations=2)
        exp = _exp(coco_files, tmp_path / make.__name__ / "b")
        exp["from_infos"] = _zinfo(tmp_path / make.__name__ / "a")
        state = make(exp)._rng.bit_generator.state
        if make is _jax_master:
            assert state == fresh
        else:
            assert state == first._rng.bit_generator.state != fresh

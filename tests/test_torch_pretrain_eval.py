"""The offline tools of the port against the JAX package's, on the CPU at
the JAX tests' toy size (32 train, 8 val and 8 test images, vocab 20,
widths 16): the XENT loss, its gradient and a pretraining run; the
reference batch API; the test split (``test_score``, ``eval_on_test`` and
its CLI); the SM-VECTOR sensitivity dump; the analysis helpers; and
``tpu.profile`` with ``utils/profile_summary``."""

import glob
import json
import logging
import os
import re

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
    d = tmp_path_factory.mktemp("coco_offline")
    return make_synthetic_coco(str(d), n_train=32, n_val=8, n_test=8,
                               vocab_size=20, fc_feat_size=16)


def _exp(copts, log_dir=None, popts=None, **tpu):
    exp = {"dataset": "mscoco", "caption_options": dict(copts),
           "policy_options": {"fitness": "greedy", "vbn": False,
                              "model_options": {"input_encoding_size": 16,
                                                "rnn_size": 16,
                                                "fc_feat_size": 16},
                              **(popts or {})},
           "tpu": {"seed": 0, **tpu}}
    if log_dir is not None:
        exp["log_dir"] = str(log_dir)
    return exp


def _tasks(exp):
    from nes_img_captioning_tpu.tasks.captioning import CocoTask as JTask
    from nes_img_captioning_tpu.utils.config import Config as JConfig
    from nes_img_captioning_tpu.utils.config import parse_tpu_config as jp
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    cfg = dict(batch_size=8, val_batch_size=8, num_val_items=8)
    return (JTask(exp, JConfig(**cfg), jp(exp)),
            CocoTask(exp, Config(**cfg), parse_tpu_config(exp),
                     device="cpu"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def _captions(task) -> np.ndarray:
    return np.stack([np.asarray(g[0], np.int32) for g in task.train_gts])


# ---- XENT --------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "vbn"])
def test_xent_loss_and_gradient_equal_jax(coco, variant):
    """xent_loss and its autograd gradient on the whole train split equal
    JAX's value_and_grad: the loss within rtol 1e-6, every gradient element
    within rtol 1e-5 plus atol 1e-7 (f32 sums in another order). vbn: every
    row's first input is <bos>, so its i2h features are equal in every row
    and normalize to their rounding residue (ROADMAP's vbn numerics note);
    there the gradient is held within 1e-4 of its largest element, the
    bound the repo's vbn lp parity uses."""
    from nes_img_captioning_tpu.pretrain import xent_loss as jxent
    from nes_img_captioning_tpu_torch.pretrain import xent_loss

    jtask, task = _tasks(_exp(coco, popts={"vbn": variant == "vbn"}))
    theta0 = jtask.generate_theta(jax.random.PRNGKey(1))
    caps = _captions(task)
    want, jgrad = jax.value_and_grad(lambda th: jxent(
        jtask.model, th, jtask.train_fc, jnp.asarray(caps)))(theta0)
    theta = _t(theta0).requires_grad_()
    loss = xent_loss(task.model, theta, task.train_fc, torch.as_tensor(caps))
    loss.backward()
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    atol = 1e-4 * np.abs(jgrad).max() if variant == "vbn" else 1e-7
    np.testing.assert_allclose(theta.grad.numpy(), jgrad, rtol=1e-5,
                               atol=atol)


def _logged_losses(caplog) -> list:
    out = [float(m.group(1)) for r in caplog.records
           if (m := re.search(r"xent step \d+: loss ([\d.]+)",
                              r.getMessage()))]
    caplog.clear()
    return out


def test_pretrain_tracks_jax(coco, caplog):
    """pretrain_xent from JAX's theta0 over JAX's batches (the same
    EpochSampler stream): the logged loss curve of 20 Adam steps is JAX's
    within one unit of its 4th logged decimal (both sides round there; the
    curves drift by about 1e-7), and theta stays within 1e-5 of JAX's
    on every element (2e-3 of one step of lr 5e-3); the elements past
    1e-6, where a near-cancelling gradient leaves Adam's step to the
    rounding of its sums, are counted and stay under 0.1%."""
    from nes_img_captioning_tpu.pretrain import pretrain_xent as jpretrain
    from nes_img_captioning_tpu_torch.pretrain import pretrain_xent

    jtask, task = _tasks(_exp(coco))
    theta0 = jtask.generate_theta(jax.random.PRNGKey(0))
    caplog.set_level(logging.INFO)
    want = np.asarray(jpretrain(jtask, steps=20, lr=5e-3, batch_size=16,
                                log_every=1))
    want_losses = _logged_losses(caplog)
    got = pretrain_xent(task, steps=20, lr=5e-3, batch_size=16, log_every=1,
                        theta0=_t(theta0)).numpy()
    got_losses = _logged_losses(caplog)
    assert len(got_losses) == len(want_losses) == 20
    np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=1.1e-4)
    assert got_losses[-1] < got_losses[0]
    diff = np.abs(got - want)
    assert diff.max() < 1e-5
    assert (diff > 1e-6).sum() <= diff.size // 1000
    assert np.abs(want - np.asarray(theta0)).max() > 0.05  # it trained


def test_pretrain_reduces_loss_and_lifts_cider(coco):
    """The JAX package's own check (tests/test_pretrain_and_batcher.py) on
    the port: 150 steps at lr 5e-3 bring the teacher-forcing loss under
    0.7x its start, and validation CIDEr above the start's."""
    from nes_img_captioning_tpu_torch.pretrain import pretrain_xent, xent_loss

    _, task = _tasks(_exp(coco))
    theta0 = task.generate_theta(torch.Generator().manual_seed(0))
    caps = torch.as_tensor(_captions(task))
    loss0 = float(xent_loss(task.model, theta0, task.train_fc, caps))
    theta = pretrain_xent(task, steps=150, lr=5e-3, batch_size=16,
                          log_every=0, theta0=theta0)
    loss1 = float(xent_loss(task.model, theta, task.train_fc, caps))
    assert loss1 < loss0 * 0.7
    assert task.validate(theta) > task.validate(theta0)


def test_pretrain_cli_writes_a_checkpoint_jax_reads(coco, tmp_path):
    """``pretrain.run`` on the CPU saves a reference-format .pth (the JAX
    package loads it to the same theta) and logs its val CIDEr."""
    from nes_img_captioning_tpu.models.fc_caption import (
        FCCaptionModel as JModel,
        FCModelOptions as JOptions,
    )
    from nes_img_captioning_tpu_torch.pretrain import run

    exp = _exp(coco)
    exp["config"] = {"batch_size": 8, "val_batch_size": 8,
                     "num_val_items": 8}
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    out = run(["--exp_file", str(path), "--steps", "5", "--batch_size", "8",
               "--out", str(tmp_path / "pre" / "xent.pth"), "--device",
               "cpu"])
    from nes_img_captioning_tpu_torch.models.params import theta_to_numpy
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import Config, TpuConfig

    task = CocoTask(exp, Config(), TpuConfig(), device="cpu")
    theta = theta_to_numpy(task.spec.load_pth(out))
    jmodel = JModel(JOptions(vocab_size=20, input_encoding_size=16,
                             rnn_size=16, fc_feat_size=16))
    np.testing.assert_array_equal(np.asarray(jmodel.spec.load_pth(out)),
                                  theta)


# ---- the reference batch API -----------------------------------------------------


@pytest.mark.parametrize("split,seed", [("train", 3), ("val", 0)])
def test_coco_batcher_equals_jax(coco, split, seed):
    """CocoBatcher's batches (features, labels, gts, bounds, infos) across
    an epoch wrap equal the JAX package's, array for array."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JData
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData

    jb = JData(coco).batcher(split, 6, seed=seed)
    tb = CocoData(coco).batcher(split, 6, seed=seed)
    assert len(tb) == len(jb)
    wrapped = False
    for _ in range(7):
        got, want = next(tb), next(jb)
        assert set(got) == set(want)
        for k in ("fc_feats", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        assert len(got["gts"]) == len(want["gts"])
        for a, b in zip(got["gts"], want["gts"]):
            np.testing.assert_array_equal(a, b)
        assert got["bounds"] == want["bounds"]
        assert got["infos"] == want["infos"]
        wrapped |= got["bounds"]["wrapped"]
    assert wrapped
    tb.reset_iterator()
    jb.reset_iterator()
    np.testing.assert_array_equal(next(tb)["labels"], next(jb)["labels"])


def test_from_arrays_keeps_the_meteor_options():
    """CocoData.from_arrays takes caption_options, so the METEOR tables of
    in-memory data follow them; without them the stages stay off."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
    )

    arrays = synthetic_coco_arrays(n_train=4, n_val=2, n_test=2,
                                   vocab_size=12)
    assert CocoData.from_arrays(arrays).meteor_params() is None
    data = CocoData.from_arrays(arrays, opts={"meteor_params": "1.5"})
    assert data.opts == {"meteor_params": "1.5"}
    assert data.meteor_params().alpha == 0.85
    assert data.split_len("test") == 2


# ---- the test split ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2])
def test_test_score_equals_jax(coco, tmp_path, seed):
    """CocoTask.test_score (the row-block decode's plain twin at f32, the
    native scorer) equals JAX's, and both write the same
    eval_cache_test.json."""
    jtask, task = _tasks(_exp(coco, log_dir=tmp_path / "torch"))
    jtask_log, _ = _tasks(_exp(coco, log_dir=tmp_path / "jax"))
    theta0 = jtask.generate_theta(jax.random.PRNGKey(seed))
    assert task.test_fc.shape == (8, 16) and len(task.test_gts) == 8
    got = task.test_score(_t(theta0))
    want = jtask_log.test_score(theta0)
    assert got == pytest.approx(want, rel=0, abs=1e-9)
    preds = [json.load(open(tmp_path / side / "eval" /
                            "eval_cache_test.json"))
             for side in ("torch", "jax")]
    assert preds[0] == preds[1] and len(preds[0]) == 8


def test_base_task_has_no_test_split():
    from nes_img_captioning_tpu_torch.tasks.base import Task

    class Bare(Task):
        train_n = 0

    with pytest.raises(NotImplementedError):
        Bare().test_score(None)


def _checkpoints(tmp_path, widths=8, fc=32):
    """Two .pth files of JAX-initialized thetas (keys 0 and 1)."""
    from nes_img_captioning_tpu.models.fc_caption import (
        FCCaptionModel,
        FCModelOptions,
    )

    model = FCCaptionModel(FCModelOptions(
        vocab_size=20, fc_feat_size=fc, input_encoding_size=widths,
        rnn_size=widths))
    paths = {}
    for name, key in (("nicnes", 0), ("nices", 1)):
        paths[name] = str(tmp_path / f"{name}.pth")
        model.spec.save_pth(np.asarray(model.spec.init_theta(
            jax.random.PRNGKey(key))), paths[name])
    return paths


@pytest.mark.parametrize("eager", [False, True], ids=["rows", "eager"])
def test_evaluate_checkpoints_equals_jax(tmp_path, eager):
    """evaluate_checkpoints on the same two .pth files gives JAX's
    captions and stats: BLEU, ROUGE-L and METEOR the same floats, CIDEr
    within 1e-9; on the row-block decode (the kernel's plain twin at f32)
    and on the eager decoder, in chunks of 3. With ``num`` under the
    split's size the port scores the first ``num`` images (the JAX
    package's decode there reads whole chunks past ``num`` and hands its
    scorer more rows than images: ROADMAP §3)."""
    from nes_img_captioning_tpu.eval_on_test import (
        evaluate_checkpoints as jeval,
    )
    from nes_img_captioning_tpu_torch.eval_on_test import evaluate_checkpoints

    copts = make_synthetic_coco(str(tmp_path / "d"), n_train=16, n_val=8,
                                n_test=8, vocab_size=20, fc_feat_size=32)
    models = _checkpoints(tmp_path)
    kw = dict(num=8, batch_size=3, input_encoding_size=8, rnn_size=8,
              fc_feat_size=32)
    want = jeval(models, copts, **kw)
    got = evaluate_checkpoints(models, copts, device="cpu", eager=eager, **kw)
    first = evaluate_checkpoints(models, copts, device="cpu", eager=eager,
                                 **dict(kw, num=5))
    for name in models:
        assert first["preds_per_model"][name] == \
            want["preds_per_model"][name][:5]
    assert got["preds_per_model"] == want["preds_per_model"]
    assert got["preds_per_img"] == want["preds_per_img"]
    for name in models:
        g, w = got["stats"][name], want["stats"][name]
        assert set(g) == set(w)
        for k in set(w) - {"CIDEr"}:
            assert g[k] == w[k], (name, k)
        assert g["CIDEr"] == pytest.approx(w["CIDEr"], rel=0, abs=1e-9)


def test_evaluate_checkpoints_in_memory_data(tmp_path):
    """``data=`` (an in-memory CocoData): the same output as
    reading the files; METEOR options that the data's opts do not carry are
    refused."""
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
        write_synthetic_coco,
    )
    from nes_img_captioning_tpu_torch.eval_on_test import evaluate_checkpoints

    arrays = synthetic_coco_arrays(n_train=16, n_val=8, n_test=8,
                                   vocab_size=20, fc_feat_size=32)
    copts = write_synthetic_coco(str(tmp_path / "d"), arrays)
    models = _checkpoints(tmp_path)
    kw = dict(num=8, input_encoding_size=8, rnn_size=8, fc_feat_size=32,
              device="cpu")
    want = evaluate_checkpoints(models, copts, **kw)
    got = evaluate_checkpoints(models, {}, data=CocoData.from_arrays(arrays),
                               **kw)
    assert got == want
    with pytest.raises(ValueError, match="METEOR"):
        evaluate_checkpoints(models, {"meteor_params": True},
                             data=CocoData.from_arrays(arrays), **kw)


def test_eval_on_test_cli_writes_its_json(tmp_path):
    """``eval_on_test.run`` with --device cpu: --model name=path, the
    output JSON under --out; --spice_cmd reaches the stats."""
    import sys

    from nes_img_captioning_tpu_torch.eval_on_test import run

    copts = make_synthetic_coco(str(tmp_path / "d"), n_train=16, n_val=8,
                                n_test=8, vocab_size=20, fc_feat_size=32)
    pth = _checkpoints(tmp_path)["nicnes"]
    tool = tmp_path / "fake_spice.py"
    tool.write_text("import json, sys\njson.dump({'SPICE': 0.3}, "
                    "open(sys.argv[2], 'w'))\n")
    out_dir = str(tmp_path / "out")
    run(["--model", f"nicnes={pth}", "--input_json", copts["input_json"],
         "--input_fc_dir", copts["input_fc_dir"], "--input_label_h5",
         copts["input_label_h5"], "--num", "8", "--out", out_dir,
         "--input_encoding_size", "8", "--rnn_size", "8", "--fc_feat_size",
         "32", "--spice_cmd", f"{sys.executable} {tool}", "--meteor_15",
         "--device", "cpu"])
    (path,) = glob.glob(out_dir + "/test_output_*.json")
    with open(path) as f:
        payload = json.load(f)
    assert set(payload) == {"stats", "preds_per_img", "preds_per_model"}
    stats = payload["stats"]["nicnes"]
    assert isinstance(stats["METEOR"], float)
    assert stats["SPICE"] == pytest.approx(0.3)
    assert "METEOR-1.5" in stats["metric_notes"]["METEOR"]


# ---- the SM-VECTOR dump ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["SM-G-SUM", "SM-G-ABS"])
def test_dump_all_sensitivities_equal_jax(coco, tmp_path, kind):
    """One file per batch of 8 of the seeded permutation of the 32 train
    images, each within rtol 2e-4, atol 1e-6 of JAX's file (the f32
    sensitivity bound of tests/test_torch_sensitivity.py), and read back by
    load_sensitivity_file."""
    from nes_img_captioning_tpu.ops.mutation import MutationKind as JKind
    from nes_img_captioning_tpu.ops.sensitivity import (
        dump_all_sensitivities as jdump,
    )
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.ops.sensitivity import (
        dump_all_sensitivities,
        load_sensitivity_file,
    )

    jtask, task = _tasks(_exp(coco, sensitivity_split=5))
    theta = 2.0 * np.asarray(jtask.generate_theta(jax.random.PRNGKey(3)))
    want = jdump(jtask, jnp.asarray(theta), 8, str(tmp_path / "jax"),
                 JKind(kind), 0.01, seed=4)
    got = dump_all_sensitivities(task, _t(theta), 8, str(tmp_path / "torch"),
                                 MutationKind(kind), 0.01, seed=4)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert os.path.basename(g).startswith(f"sens_t{i}_p0_")
        gv = load_sensitivity_file(g)
        wv = torch.load(w, weights_only=False).numpy()
        assert gv.shape == (task.spec.num_params,) and gv.min() >= 1.0
        assert (wv > 1.0).mean() > 0.05
        np.testing.assert_allclose(gv, wv, rtol=2e-4, atol=1e-6)


# ---- analysis helpers ----------------------------------------------------------------


def test_analysis_helpers_equal_jax(tmp_path):
    from nes_img_captioning_tpu.utils import analysis as jan
    from nes_img_captioning_tpu_torch.utils import analysis as tan

    for fn, args in (
            ("combine_diff_lengths", ([1, 2], [3, 4, 5])),
            ("combine_diff_lengths_pad", ([1, 2], [3, 4, 5], [7])),
            ("sample_at", (np.arange(0, 10, 2), np.array([0., 3., 9.]),
                           np.array([1., 2., 4.]))),
            ("tournament_counts", (10, 3, 500, 2, 7))):
        np.testing.assert_array_equal(getattr(tan, fn)(*args),
                                      getattr(jan, fn)(*args))
    infos = {"acc_stats": [0.1, 0.3, 0.2], "bs_stats": [4, 4, 4],
             "time_stats": [1.0, 2.0, 1.0]}
    for a, b in zip(tan.cst_from_infos(infos), jan.cst_from_infos(infos)):
        np.testing.assert_array_equal(a, b)
    log = tmp_path / "log.txt"
    log.write_text("| RewStd:              |      0.085 |\n"
                   "| RewStd:              |      0.070 |\n")
    assert tan.extract_stat_from_log(str(log), "RewStd") == \
        jan.extract_stat_from_log(str(log), "RewStd") == [0.085, 0.07]
    curves = ([(0, 1.0), (2, 2.0), (4, 3.0)], [(0, 5.0), (1, 6.0), (2, 7.0)])
    (tx, ty), (jx, jy) = tan.rasterize(*curves), jan.rasterize(*curves)
    for a, b in zip(tx + ty, jx + jy):
        np.testing.assert_array_equal(a, b)
    assert tan.readable_bytes(2048) == jan.readable_bytes(2048) == "2.0KB"
    out = tmp_path / "plot.png"
    tan.plot_score_vs({"a": ([0, 1, 2], [0.1, 0.2, 0.3])}, "samples",
                      str(out))
    assert out.stat().st_size > 0


# ---- tpu.profile ------------------------------------------------------------------


def _master_exp(copts, log_dir, name="mscoco_nes.json", **tpu):
    """experiments/mscoco_nes.json (or ``name``) cut to toy size, as
    tests/test_torch_master.py cuts it."""
    with open(os.path.join(REPO, "experiments", name)) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=4, val_batch_size=4, num_val_items=4,
                         snapshot_freq=0)
    exp["policy_options"]["model_options"].update(
        input_encoding_size=16, rnn_size=16, fc_feat_size=16)
    exp["nb_offspring"] = 4
    exp["caption_options"] = copts
    exp["tpu"] = {"seed": 0, "pop_chunk": 3, "precision": "f32",
                  "profile": True, **tpu}
    exp["log_dir"] = str(log_dir)
    return exp


@pytest.mark.parametrize("algo,iters,gpd", [
    ("nic_nes", 3, 1), ("nic_nes", 2, 2), ("nic_es", 2, 1)],
    ids=["nes_gen2", "nes_block_ends_run", "es_ends_at_gen2"])
def test_profile_writes_a_trace_profile_summary_reads(coco, tmp_path, capsys,
                                                      algo, iters, gpd):
    """tpu.profile on a CPU toy master: the dispatch that runs generation 2
    is traced (a block of 2 whole; a run that ends there still writes it)
    into <log_dir>/profile/, and profile_summary reads it: CPU events, no
    device events, so no device time."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.utils import profile_summary

    exp = _master_exp(coco, tmp_path / "run", gens_per_dispatch=gpd,
                      name="mscoco_es.json" if algo == "nic_es"
                      else "mscoco_nes.json")
    if algo == "nic_es":
        exp.update(nb_offspring=6, population_size=3, num_elites=1,
                   num_elite_cands=1)
    master = (ESMaster if algo == "nic_es" else NESMaster)(exp, device="cpu")
    master.run_master(max_iterations=iters)
    assert master._profiler is None
    (trace,) = glob.glob(str(tmp_path / "run" / "profile" / "*.json"))
    out = profile_summary.main([str(tmp_path / "run")])
    assert profile_summary.find_trace(str(tmp_path / "run")) == trace
    assert out["n_events"] > 0 and out["window_ms"] > 0
    assert out["rows"] == [] and out["idle"] is None
    assert "device time not measured" in capsys.readouterr().out


def test_profile_off_writes_no_trace(coco, tmp_path):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    exp = _master_exp(coco, tmp_path / "run")
    exp["tpu"]["profile"] = False
    NESMaster(exp, device="cpu").run_master(max_iterations=2)
    assert not os.path.exists(tmp_path / "run" / "profile")


def test_profile_summary_device_time_and_idle(tmp_path, capsys):
    """On a trace with device events: per-name device time and count,
    overlapping intervals counted once in the busy time, the window from
    the first to the last timed event of any kind, launches whose kernel
    has no record counted; a directory resolves to its newest trace."""
    import gzip
    import time

    from nes_img_captioning_tpu_torch.utils import profile_summary

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 90.0, "dur": 5.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "ts": 95.0, "dur": 5.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "member_kernel", "ts": 100.0,
         "dur": 1500.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "member_kernel", "ts": 1000.0,
         "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 3000.0,
         "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "pair_kernel", "ts": 6000.0,
         "dur": 3000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9500.0, "dur": 500.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 99999.0},
    ]
    d = tmp_path / "run" / "profile"
    d.mkdir(parents=True)
    (d / "old.pt.trace.json").write_text(json.dumps({"traceEvents": []}))
    time.sleep(0.01)
    with gzip.open(d / "trace_1.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    trace = profile_summary.find_trace(str(tmp_path / "run"))
    assert trace.endswith("trace_1.pt.trace.json.gz")
    out = profile_summary.summarize(trace)
    assert out["rows"] == [("pair_kernel", 3.0, 1), ("member_kernel", 2.0, 2),
                           ("Memcpy HtoD", 1.0, 1)]
    assert out["window_ms"] == pytest.approx(10.0)
    assert out["busy_ms"] == pytest.approx(5.5)
    assert out["idle"] == pytest.approx(0.45)
    assert out["unmatched_launches"] == 1
    profile_summary.main([str(tmp_path / "run"), "-n", "1"])
    printed = capsys.readouterr().out
    assert "pair_kernel" in printed and "member_kernel" not in printed
    assert "idle 45.00%" in printed
    assert "1 kernel launches have no kernel record" in printed

"""The port's parity runbook (scripts/torch_parity_run.py) on the CPU.

* its chain end to end on a reference-format fixture that the port writes
  (its own HDF5 writer): the bit-exact warm start, two generations, the
  validation series, the test-split evaluation and the files on disk;
* ``--cider-df`` reaching the training scorers;
* against the JAX package's chain (scripts/parity_run.py) on the same
  files and .pth: the warm-start theta bit for bit, the test evaluation of
  that .pth within 1e-9 in CIDEr, and the training series in length and
  finiteness only (the packages' noise streams differ);
* the real-data smoke, gated on NES_COCO_DATA as the JAX package's is.
"""

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


torch_parity_run = _script("torch_parity_run")

WIDTH, FEAT, VOCAB = 16, 16, 40


def _tiny_exp(path: str):
    """mscoco_nes.json shrunk to fixture scale (the JAX test's _tiny_exp:
    the same schema and knobs)."""
    exp = {
        "algorithm": "nic_nes",
        "config": {
            "eval_prob": 0.003, "noise_stdev": 0.01, "snapshot_freq": 2,
            "batch_size": 8, "val_batch_size": 8, "num_val_items": 8,
            "patience": 0, "schedule_start": 1000, "schedule_limit": 1000,
            "stdev_divisor": 1, "bs_multiplier": 1, "stepsize_divisor": 1,
            "l2coeff": 1e-7, "single_batch": False,
        },
        "policy_options": {
            "net": "fc_caption", "fitness": "greedy", "vbn": False,
            "model_options": {
                "safe_mutations": "",
                "input_encoding_size": WIDTH, "rnn_size": WIDTH,
                "fc_feat_size": FEAT,
            },
        },
        "optimizer_options": {"type": "adam", "args": {"stepsize": 0.001}},
        "dataset": "mscoco",
        "nb_offspring": 4,
        "num_elites": 1,
        "caption_options": {},
        "tpu": {"seed": 0},
    }
    with open(path, "w") as f:
        json.dump(exp, f)
    return path


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The reference layout written by the port (cocotalk.json, its own
    cocotalk_label.h5, fc/), a tiny experiment file and a reference-format
    .pth from the JAX package's init."""
    import jax

    from nes_img_captioning_tpu.models.fc_caption import (
        FCCaptionModel,
        FCModelOptions,
    )
    from nes_img_captioning_tpu_torch.data.synthetic import (
        synthetic_coco_arrays,
        write_synthetic_coco,
    )

    root = tmp_path_factory.mktemp("parity")
    data_dir = str(root / "data")
    write_synthetic_coco(data_dir, synthetic_coco_arrays(
        n_train=32, n_val=8, n_test=8, vocab_size=VOCAB, fc_feat_size=FEAT))
    model = FCCaptionModel(FCModelOptions(
        vocab_size=VOCAB, seq_length=16, input_encoding_size=WIDTH,
        rnn_size=WIDTH, fc_feat_size=FEAT))
    pth = str(root / "warm.pth")
    model.spec.save_pth(np.asarray(model.spec.init_theta(
        jax.random.PRNGKey(3))), pth)
    return {"data": data_dir, "pth": pth, "root": root,
            "exp": _tiny_exp(str(root / "tiny_nes.json")), "model": model}


def _summary_ok(summary: dict, out_dir: str, generations: int = 2):
    assert summary["warm_start"]["vector_roundtrip_exact"]
    assert summary["warm_start"]["tensor_roundtrip_exact"]
    assert len(summary["val_cider_series"]) == generations
    assert all(np.isfinite(v) for v in summary["val_cider_series"])
    assert len(summary["train_fitness_mean_series"]) == generations
    assert summary["test_stats"] is not None
    assert set(summary["test_stats"]) == {"nicnes_best", "nicnes_current"}
    for name, stats in summary["test_stats"].items():
        assert np.isfinite(stats["CIDEr"]), (name, stats)
    with open(os.path.join(out_dir, "parity_summary.json")) as f:
        assert json.load(f)["generations"] == generations
    assert os.path.isfile(os.path.join(out_dir, "test_output.json"))


def test_torch_parity_chain_against_jax(fixture, capsys):
    """The port's chain end to end with ``--device cpu``, and the JAX
    package's chain on the same files and .pth: the same summary keys, the
    warm start bit for bit, the series of equal length and finite."""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster

    argv = ["--data", fixture["data"], "--pth", fixture["pth"],
            "--exp", fixture["exp"], "--generations", "2",
            "--test-num", "8"]
    out = str(fixture["root"] / "torch_out")
    started = []
    init = NESMaster.__init__

    def spy(self, exp, *a, **k):
        init(self, exp, *a, **k)
        started.append((exp, self.theta.clone()))

    NESMaster.__init__ = spy
    try:
        summary = torch_parity_run.main(argv + ["--out", out,
                                                "--device", "cpu"])
    finally:
        NESMaster.__init__ = init
    _summary_ok(summary, out)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(summary))

    # the master started from the .pth, bit for bit JAX's load_pth
    from nes_img_captioning_tpu_torch.models.params import theta_from_numpy

    (exp, theta0), = started
    assert exp["from_single"] == fixture["pth"]
    want = theta_from_numpy(fixture["model"].spec.load_pth(fixture["pth"]))
    assert torch.equal(theta0, want)

    jax_run = _script("parity_run")
    jout = str(fixture["root"] / "jax_out")
    jsummary = jax_run.main(argv + ["--out", jout])
    _summary_ok(jsummary, jout)
    assert set(summary) == set(jsummary)
    assert summary["warm_start"]["num_params"] == \
        jsummary["warm_start"]["num_params"]
    for k in ("generations", "exp", "config", "cider_df"):
        assert summary[k] == jsummary[k], k


def test_evaluate_warm_start_equals_jax(fixture):
    """Both packages' evaluate_checkpoints of the runbook's .pth over the
    whole test split (the runbook's fourth step): the same captions, CIDEr
    within 1e-9."""
    from nes_img_captioning_tpu.eval_on_test import (
        evaluate_checkpoints as jeval,
    )
    from nes_img_captioning_tpu_torch.eval_on_test import evaluate_checkpoints

    args = type("A", (), {"input_json": None, "input_label_h5": None,
                          "input_fc_dir": None, "cider_df": None})
    copts = torch_parity_run.resolve_data(fixture["data"], args)
    models = {"warm": fixture["pth"]}
    kw = dict(num=8, split="test", batch_size=8, input_encoding_size=WIDTH,
              rnn_size=WIDTH, fc_feat_size=FEAT)
    got = evaluate_checkpoints(models, copts, device="cpu", **kw)
    want = jeval(models, copts, **kw)
    assert got["preds_per_model"] == want["preds_per_model"]
    assert got["stats"]["warm"]["CIDEr"] == pytest.approx(
        want["stats"]["warm"]["CIDEr"], rel=0, abs=1e-9)


def test_torch_parity_threads_cider_df(fixture):
    """--cider-df reaches the training scorers through the driver: the
    master's task holds the pickled table (its ref_len) and the training
    fitness moves with it. (How far it moves depends on the start: the
    frozen ref_len weighs the n-grams common in the fixture, which the
    JAX test's fresh init scores mostly on; the port's init stream is
    another, so the port's test checks the table itself.)"""
    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.fitness.ciderd import CiderScorer

    args = type("A", (), {"input_json": None, "input_label_h5": None,
                          "input_fc_dir": None, "cider_df": None})
    copts = torch_parity_run.resolve_data(fixture["data"], args)
    # a frozen table over the fixture's own train gts but an alien
    # ref_len: the same ranks, a shifted absolute scale
    gts = CocoData(copts).split_gts("train")
    fitted = CiderScorer(variant="cider-d").fit_df(gts)
    doc_freq = {tuple(str(t) for t in g): float(c)
                for order in fitted.df for g, c in order.items()}
    df_path = str(fixture["root"] / "coco-train-idxs.p")
    with open(df_path, "wb") as f:
        pickle.dump({"document_frequency": doc_freq,
                     "ref_len": float(np.log(40504.0))}, f, protocol=2)

    tables = []
    init = NESMaster.__init__

    def spy(self, exp, *a, **k):
        init(self, exp, *a, **k)
        tables.append(self.task._frozen_df)

    common = ["--data", fixture["data"], "--exp", fixture["exp"],
              "--generations", "1", "--skip-test-eval", "--device", "cpu"]
    NESMaster.__init__ = spy
    try:
        base = torch_parity_run.main(common + [
            "--out", str(fixture["root"] / "o1")])
        frozen = torch_parity_run.main(common + [
            "--cider-df", df_path, "--out", str(fixture["root"] / "o2")])
    finally:
        NESMaster.__init__ = init
    assert "warm_start" not in base and "test_stats" not in base
    assert frozen["cider_df"] == df_path
    assert tables[0] is None
    df, ref_len = tables[1]
    assert ref_len == float(np.log(40504.0))
    assert sum(len(d) for d in df) == len(doc_freq)
    b = base["train_fitness_mean_series"][0]
    z = frozen["train_fitness_mean_series"][0]
    assert np.isfinite([b, z]).all() and z != b, (b, z)


@pytest.mark.skipif(not os.environ.get("NES_COCO_DATA"),
                    reason="set NES_COCO_DATA=<dir with cocotalk.json/"
                           "cocotalk_label.h5/fc features> to smoke-test "
                           "the port's parity chain on real MSCOCO data")
def test_torch_parity_real_data_smoke(tmp_path):
    """2 tiny generations + a 32-image test eval over the real artifacts,
    on the card unless NES_DEVICE names another device."""
    data_dir = os.environ["NES_COCO_DATA"]
    argv = [
        "--data", data_dir, "--generations", "2",
        "--nb-offspring", "4", "--batch-size", "8", "--val-items", "64",
        "--test-num", "32", "--out", str(tmp_path / "out"),
        "--device", os.environ.get("NES_DEVICE", "cuda"),
    ]
    pth = os.path.join(data_dir, "bu_xent_09.pth")
    if os.path.isfile(pth):
        argv += ["--pth", pth]
    df = os.path.join(data_dir, "coco-train-idxs.p")
    if os.path.isfile(df):
        argv += ["--cider-df", df]
    summary = torch_parity_run.main(argv)
    assert len(summary["val_cider_series"]) == 2
    assert all(np.isfinite(v) for v in summary["val_cider_series"])
    assert summary["test_stats"] is not None

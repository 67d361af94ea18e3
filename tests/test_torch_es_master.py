"""The port's NIC-ES master on the CPU at toy size: the CLI, snapshots that
resume in either package, the seed stream across a resume, the fused gate,
the sampling kinds, and what it refuses."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_es import REPO, coco, es_exp, jax_master, torch_master  # noqa: F401
from torch_pin import one_intra_op_thread  # noqa: F401


def _zinfo(log_dir) -> str:
    (path,) = glob.glob(os.path.join(str(log_dir), "snapshot",
                                      "z_info_*.json"))
    return path


def test_cli_es_master_writes_a_snapshot(coco, tmp_path):
    """``python -m nes_img_captioning_tpu_torch.main master --device cpu``
    on a nic_es experiment trains 3 iterations (plain, then fused) and
    leaves z_info with its parents and candidates as .pth files, the
    podium's elite files and the validation predictions."""
    exp = es_exp(coco, tmp_path / "run")
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(exp))
    out = subprocess.run(
        [sys.executable, "-m", "nes_img_captioning_tpu_torch.main", "master",
         "--exp_file", str(path), "--max_iterations", "3", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RUNNING NIC-ES" in out.stderr
    with open(_zinfo(tmp_path / "run")) as f:
        infos = json.load(f)
    assert infos["iter"] == 3 and len(infos["acc_stats"]) == 3
    assert infos["algorithm"] == "nic_es"
    assert len(infos["parents"]) == exp["population_size"]
    assert len(infos["elites_to_evaluate"]) == exp["num_elite_cands"]
    assert len(infos["best_elites"]) == exp["num_elites"]
    paths = [p for _, p in infos["parents"] + infos["elites_to_evaluate"]]
    for p in paths + [p for p, _ in infos["best_elites"]]:
        assert os.path.isfile(p) and p.endswith(".pth"), p
    with open(tmp_path / "run" / "eval" / "eval_cache_val.json") as f:
        preds = json.load(f)
    assert len(preds) == 10 and {"image_id", "caption"} <= set(preds[0])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_es_snapshots_cross_load(coco, tmp_path, writer):
    """A snapshot written by either package resumes in the other: the
    parents' and candidates' .pth files load bit for bit, the podium and
    counters carry over, and the resumed run's z_info has the same keys."""
    make = {"jax": jax_master, "torch": torch_master}
    reader = "torch" if writer == "jax" else "jax"
    first = make[writer](es_exp(coco, tmp_path / "a"))
    first.run_master(max_iterations=2)
    zinfo = _zinfo(tmp_path / "a")
    with open(zinfo) as f:
        infos = json.load(f)
    exp2 = es_exp(coco, tmp_path / "b")
    exp2["from_infos"] = zinfo
    second = make[reader](exp2)
    spec = first.task.spec
    want = np.stack([np.asarray(spec.load_pth(p))
                     for _, p in infos["parents"]])
    got = np.asarray(second.parents_mat)[:len(want)]
    np.testing.assert_array_equal(got, want)
    assert second._n_parents == len(want) == exp2["population_size"]
    for (_, src), (_, dst) in zip(infos["elites_to_evaluate"],
                                  second.elites_to_evaluate):
        np.testing.assert_array_equal(np.asarray(spec.load_pth(dst)),
                                      np.asarray(spec.load_pth(src)))
    assert [s for _, s in second.it.best_elites()] == \
        [s for _, s in infos["best_elites"]]
    assert second.it.iteration() == 1  # stored post-increment, minus one
    second.run_master(max_iterations=2)
    with open(_zinfo(tmp_path / "b")) as f:
        assert set(json.load(f)) == set(infos)


def test_es_resume_continues_the_run(coco, tmp_path):
    """Plain generations: 4 in one run give the same seeds and fitness
    vectors, bit for bit, as 2, a snapshot and 2 more resumed from it (the
    sidecar restores the batch and the seed streams; the resumed run labels
    its first generation with the snapshot's iteration, as the JAX package
    does). The JAX master starts its seed stream again from tpu.seed on a
    resume."""
    def run(name, iters, resume_from=None):
        exp = es_exp(coco, tmp_path / name, fused_es=False)
        if resume_from:
            exp["from_infos"] = _zinfo(tmp_path / resume_from)
        m = torch_master(exp)
        seen = []
        orig = m.engine.eval_generation

        def spy(parents, sigma, seeds, pidx, idx_row, fresh=False,
                sens=None):
            art = orig(parents, sigma, seeds, pidx, idx_row, fresh, sens)
            seen.append((seeds.copy(), art["fitness"].clone()))
            return art

        m.engine.eval_generation = spy
        m.run_master(max_iterations=iters)
        return m, seen

    whole, w = run("whole", 4)
    half, h = run("half", 2)
    resumed, r = run("resumed", 3, resume_from="half")
    assert len(w) == 4 and len(h) == 2 and len(r) == 2
    for (sa, fa), (sb, fb) in zip(w[2:], r):
        np.testing.assert_array_equal(sb, sa)
        assert torch.equal(fb, fa)
    assert not np.array_equal(w[0][0], w[2][0])
    assert torch.equal(resumed.parents_mat, whole.parents_mat)

    exp = es_exp(coco, tmp_path / "jax_resumed")
    exp["from_infos"] = _zinfo(tmp_path / "half")
    fresh = np.random.default_rng(exp["tpu"]["seed"]).bit_generator.state
    assert jax_master(exp)._rng.bit_generator.state == fresh


@pytest.mark.parametrize("case,want", [
    ("steady", True), ("more_cands_than_offspring", False),
    ("no_cands", False), ("fused_es_false", False)])
def test_fused_gate_matches_jax(coco, tmp_path, case, want):
    """``_fused_capable`` resolves as the JAX master's: candidates must be
    a prefix of the kept children (1 <= C <= min(kept, offspring)), and
    tpu.fused_es false turns it off."""
    exp = es_exp(coco, tmp_path / "j")
    if case == "more_cands_than_offspring":
        exp.update(nb_offspring=3, num_elite_cands=4)
    elif case == "no_cands":
        exp["num_elite_cands"] = 0
    elif case == "fused_es_false":
        exp["tpu"]["fused_es"] = False
    jm = jax_master(exp)
    exp["log_dir"] = str(tmp_path / "t")
    assert torch_master(exp)._fused_capable() is jm._fused_capable() is want


def test_sampling_kind_runs_on_both_paths(coco, tmp_path):
    """The ``sample`` kind: each offspring's K3 lanes take their seeds from
    its seed (``ops/noise.lane_seeds``); the plain and fused paths give the
    same finite fitness vectors, bit for bit, over 3 generations."""
    fits = {}
    for path, tpu in (("plain", {"fused_es": False}), ("fused", {})):
        exp = es_exp(coco, tmp_path / path, **tpu)
        exp["policy_options"]["fitness"] = "sample"
        m = torch_master(exp)
        assert m.task.samples
        lanes = m.engine.lanes_of(np.array([1, 2], np.uint32))
        assert lanes.shape == (2, m.task.seq_per_img)
        assert len(set(lanes.ravel().tolist())) == lanes.size
        m.run_master(max_iterations=3)
        fits[path] = m.stats.to_dict()["score_stats"]
    assert fits["plain"] == fits["fused"]
    assert np.isfinite(np.asarray(fits["plain"])).all()


@pytest.mark.parametrize("case,error,match", [
    ("group_without_seed", ValueError, "tpu.seed"),
    ("mesh_shape_outside_group", ValueError, "main.py"),
    ("default_device", RuntimeError, "device='cpu'"),
])
def test_es_master_refuses_what_is_not_ported(coco, tmp_path, case, error,
                                              match):
    """A process group without tpu.seed raises (its ranks must draw the
    same streams), and so does tpu.mesh_shape [2] in a process outside a
    group (the message names main.py, which starts the ranks); without
    ``device="cpu"`` the master asks for the card, which this machine
    lacks."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESMaster
    from nes_img_captioning_tpu_torch.parallel.multihost import (
        init_multihost,
        shutdown_multihost,
    )

    if case == "default_device" and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    exp = es_exp(coco, tmp_path / case)
    device = "cpu"
    if case == "group_without_seed":
        del exp["tpu"]["seed"]
        init_multihost(num_processes=1, process_id=0, device="cpu")
    elif case == "mesh_shape_outside_group":
        exp["tpu"]["mesh_shape"] = [2]
    else:
        device = None
    try:
        with pytest.raises(error, match=match):
            ESMaster(exp, device=device)
    finally:
        shutdown_multihost()

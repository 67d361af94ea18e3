"""The population sharded over processes (``parallel/``) on the CPU: gloo,
2 ranks, at toy size.

Each rank is a process of its own running this file as a script
(``python tests/test_torch_parallel.py CASE WORLD RANK PORT DIR``, WORLD 0:
one process with no group), so the ranks and the one-process reference
start alike; they load the port only. The JAX package runs here, in the
test process: its NES engine on a mesh of 8 virtual devices (conftest)
gives the deltas that the port's ranks are handed, and the fitnesses and
theta they are held to. Every rendezvous, collective and subprocess has a
timeout, so a hang fails its test.

Tolerances: fitnesses 1e-5 and theta 1e-6 against JAX (the existing
port-against-JAX bars, tests/test_torch_generation.py; SGD, as
tests/test_torch_nes_smg.py steps, so a sum order moves theta by the
rounding of the gradient and not by Adam's epsilon); the ranks' fitnesses
and ES trajectories bit for bit the one process's; NES theta within 1e-6
of it (the partial gradients are summed in another order).
"""

import datetime
import glob
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds: a subprocess, and a rendezvous or collective. The local-rank CLI
# test takes 10-19 s alone and 53-66 s beside five busy 8-thread processes
# on 8 cores; a loaded test host once held it past 120 s after its ranks
# had met.
TIMEOUT = 300
F_PAIRS, B, SIGMA, STEP, L2 = 5, 4, 0.05, 0.01, 1e-7
ES_PATHS = {"plain": {"fused_es": False}, "fused": {},
            "blocked": {"gens_per_dispatch": 2}}
ES_ITERS = 4
NES_VARIANTS = ("delta", "noise", "host")


# ---- the rank processes ------------------------------------------------------


def _nes_engine(exp, variant, mesh):
    from nes_img_captioning_tpu_torch.algorithms.nes import NESEngine
    from nes_img_captioning_tpu_torch.algorithms.optimizers import SGD
    from nes_img_captioning_tpu_torch.ops.mutation import MutationKind
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask
    from nes_img_captioning_tpu_torch.utils.config import (
        Config,
        parse_tpu_config,
    )

    exp = json.loads(json.dumps(exp))
    if variant == "host":
        exp["tpu"]["device_cider"] = False
    task = CocoTask(exp, Config(batch_size=B), parse_tpu_config(exp),
                    device="cpu")
    return NESEngine(task, SGD(STEP), MutationKind.DEFAULT, pop_chunk=2,
                     kernel_perturb=variant != "host",
                     kernel_noise=variant == "noise", mesh=mesh)


def _nes_case(inputs: dict, mesh, tag: str) -> dict:
    """One generation of each variant from the same theta: the
    delta-operand pair path (K2) and the host-scored path handed JAX's
    deltas, the kernel-noise path (K5, K6) on the port's own stream."""
    out = {}
    theta0 = torch.from_numpy(inputs["theta"])
    for variant in NES_VARIANTS:
        eng = _nes_engine(inputs["exp"], variant, mesh)
        lay = eng.task.decode_layout
        deltas = {int(s): torch.from_numpy(d) for s, d in
                  zip(inputs["seeds"], inputs["deltas"])}
        if variant == "delta":
            deltas = {s: lay.to_dec(d, pad_scale=0.0)
                      for s, d in deltas.items()}
        if variant != "noise":
            eng.delta_of = lambda scale, seed, d=deltas: d[int(seed)]
        state = eng.optimizer.init(eng.dim, "cpu")
        sens = torch.ones_like(theta0)
        if variant == "host":
            art, dl = eng.eval_generation(theta0, sens, SIGMA,
                                          inputs["seeds"], inputs["idx"])
            fits = eng.host_fitness(art, inputs["idx"], F_PAIRS)
            _, theta, _ = eng.update(theta0, state, sens, SIGMA,
                                     inputs["seeds"], fits, STEP, L2,
                                     deltas=dl)
        else:
            theta, _, packed = eng.generation(
                theta0, state, sens, SIGMA, inputs["seeds"], inputs["idx"],
                STEP, L2)
            fits = eng.unpack(packed, F_PAIRS)[0]
        out[variant] = {"fitness": np.asarray(fits), "theta": theta.numpy()}
    return out


def _es_case(inputs: dict, mesh, tag: str) -> dict:
    """ESMaster on each path for ES_ITERS generations: the fitness
    vectors as the master reads them, the final children and podium rows,
    the stats."""
    from nes_img_captioning_tpu_torch.algorithms.es import ESEngine, ESMaster

    out = {}
    unpack_block = ESEngine.unpack_block
    for path, tpu in ES_PATHS.items():
        exp = json.loads(json.dumps(inputs["exp"]))
        exp["tpu"].update(tpu)
        exp["log_dir"] = os.path.join(exp["log_dir"], tag, path)
        m = ESMaster(exp, device="cpu", mesh=mesh)
        eng, fits = m.engine, []
        hf, uf = eng.host_fitness, eng.unpack_fused

        def spy(fn, many=False):
            def run(*a):
                res = fn(*a)
                if many:
                    fits.extend(res[0])
                else:
                    fits.append(res if fn is hf else res[0])
                return res
            return run

        eng.host_fitness, eng.unpack_fused = spy(hf), spy(uf)
        ub = spy(unpack_block, many=True)

        ESEngine.unpack_block = staticmethod(ub)
        try:
            m.run_master(max_iterations=ES_ITERS)
        finally:
            ESEngine.unpack_block = staticmethod(unpack_block)
        children = (m._selected_dev[:m._n_selected] if m.parents_mat is None
                    else m.parents_mat[:m._n_parents])
        out[path] = {
            "fitness": np.stack([np.asarray(f) for f in fits]),
            "children": children.numpy(),
            "podium": np.stack([m.task.spec.load_pth(p).numpy()
                                for p, _ in m.it.best_elites() if p]),
            "stats": {k: m.stats.to_dict()[k] for k in (
                "score_stats", "acc_stats", "norm_stats")},
            "log_dir": m.exp["log_dir"],
        }
    return out


def _meet_case(inputs: dict, mesh, tag: str) -> dict:
    """The group's ranks, gathered from each rank with its pid."""
    from nes_img_captioning_tpu_torch.parallel.mesh import all_gather

    own = torch.tensor([[mesh.rank, os.getpid()]])
    return {"world": mesh.world, "ranks": all_gather(mesh, own).numpy()}


def worker_main(case: str, world: int, rank: int, port: int, out_dir: str):
    """One rank (world 0: one process, no group): run ``case`` on the
    inputs in out_dir and save what it read back beside them."""
    from nes_img_captioning_tpu_torch.parallel import make_mesh
    from nes_img_captioning_tpu_torch.parallel.multihost import (
        init_multihost,
        shutdown_multihost,
    )

    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out_dir, f"{case}_inputs.pt"),
                        weights_only=False)
    if world:
        init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                       timeout=datetime.timedelta(seconds=TIMEOUT),
                       launcher_store=True)
    try:
        out = {"nes": _nes_case, "es": _es_case, "meet": _meet_case}[case](
            inputs, make_mesh(), f"w{world}")
    finally:
        shutdown_multihost()
    torch.save(out, os.path.join(out_dir, f"{case}_w{world}_r{rank}.pt"))


# ---- helpers of the tests --------------------------------------------------


def _run(procs_args, timeout=TIMEOUT):
    """Start every command at once, each in a session of its own; wait
    for all within ``timeout`` (killing every session on expiry) and assert
    that each exited 0. Returns their stderr transcripts."""
    procs = [subprocess.Popen(a, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for a in procs_args]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for a, p, (out, err) in zip(procs_args, procs, outs):
        assert p.returncode == 0, f"{a}:\n{out[-2000:]}\n{err[-4000:]}"
    return [err for _, err in outs]


def _free_port() -> int:
    """A port that was free a moment ago, for rank 0 of a ``--coordinator``
    group to bind (the CLI's multi-host form)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(case: str, out_dir: str) -> dict:
    """Run ``case`` as one process (key 0) and as 2 ranks (keys 1, 2 for
    ranks 0, 1), all at once, the ranks meeting at a store this process
    holds; returns their results."""
    from nes_img_captioning_tpu_torch.parallel.multihost import (
        hold_rendezvous,
    )

    store = hold_rendezvous(2, datetime.timedelta(seconds=TIMEOUT))
    me = os.path.abspath(__file__)
    runs = [(0, 0)] + [(2, r) for r in range(2)]
    _run([[sys.executable, me, case, str(w), str(r), str(store.port),
           out_dir] for w, r in runs])
    return {i: torch.load(os.path.join(out_dir, f"{case}_w{w}_r{r}.pt"),
                          weights_only=False)
            for i, (w, r) in enumerate(runs)}


def _coco_exp(copts, log_dir: str) -> dict:
    return {
        "dataset": "mscoco", "caption_options": dict(copts),
        "policy_options": {"fitness": "greedy", "model_options": {
            "input_encoding_size": 16, "rnn_size": 16, "fc_feat_size": 24}},
        "tpu": {"seed": 0, "fused_decode": True, "precision": "f32"},
        "log_dir": log_dir,
    }


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco

    d = tmp_path_factory.mktemp("coco_parallel")
    return make_synthetic_coco(str(d), n_train=24, n_val=8, n_test=4,
                               vocab_size=30, fc_feat_size=24, cap_len=6,
                               seed=2)


@pytest.fixture(scope="module")
def nes_runs(coco, tmp_path_factory):
    """JAX's NES engine on its 8-device mesh (XLA decode, host fitness):
    its deltas, fitnesses and theta after one SGD step; then the port's
    one process and 2 ranks handed those deltas."""
    import jax
    import jax.numpy as jnp

    from nes_img_captioning_tpu.algorithms.nes import NESEngine
    from nes_img_captioning_tpu.algorithms.optimizers import SGD
    from nes_img_captioning_tpu.ops.mutation import MutationKind
    from nes_img_captioning_tpu.parallel.mesh import make_mesh
    from nes_img_captioning_tpu.tasks.captioning import CocoTask
    from nes_img_captioning_tpu.utils.config import Config, parse_tpu_config

    d = str(tmp_path_factory.mktemp("nes_parallel"))
    exp = _coco_exp(coco, os.path.join(d, "run"))
    jexp = json.loads(json.dumps(exp))
    jexp["tpu"] = {"seed": 0, "precision": "f32", "mesh_shape": [8]}
    task = CocoTask(jexp, Config(batch_size=B), parse_tpu_config(jexp))
    mesh = make_mesh([8])
    eng = NESEngine(task, SGD(STEP), MutationKind.DEFAULT, mesh=mesh,
                    pop_chunk=2)
    rng = np.random.default_rng(4)
    seeds = rng.integers(0, 2**32, size=F_PAIRS, dtype=np.uint32)
    idx = rng.integers(0, 24, size=(F_PAIRS, B)).astype(np.int32)
    theta = task.generate_theta(jax.random.PRNGKey(3))
    sens = jnp.ones((eng.dim,), jnp.float32)
    art, deltas = eng.eval_generation(theta, sens, SIGMA, seeds, idx)
    fits = np.asarray(task.host_fitness(art, idx))
    _, theta1, _ = eng.update(theta, eng.optimizer.init(eng.dim), sens,
                              SIGMA, seeds, fits, STEP, L2, deltas=deltas)
    torch.save({"exp": exp, "seeds": seeds, "idx": idx,
                "theta": np.asarray(theta),
                "deltas": np.asarray(deltas).reshape(-1, eng.dim)[:F_PAIRS]},
               os.path.join(d, "nes_inputs.pt"))
    return {"jax": {"fitness": fits, "theta": np.asarray(theta1)},
            **_ranks("nes", d)}


@pytest.fixture(scope="module")
def es_runs(coco, tmp_path_factory):
    """experiments/mscoco_es.json cut to toy size with SM-G-SUM, one
    process and 2 ranks on each ES path."""
    d = str(tmp_path_factory.mktemp("es_parallel"))
    with open(os.path.join(REPO, "experiments", "mscoco_es.json")) as f:
        exp = json.load(f)
    exp["config"].update(batch_size=B, val_batch_size=4, num_val_items=8,
                         noise_stdev=0.05, snapshot_freq=ES_ITERS)
    exp["policy_options"]["model_options"].update(
        safe_mutations="SM-G-SUM", safe_mutation_underflow=0.01,
        input_encoding_size=16, rnn_size=16, fc_feat_size=24)
    exp.update(nb_offspring=7, population_size=5, num_elites=2,
               num_elite_cands=2, caption_options=dict(coco),
               log_dir=os.path.join(d, "run"))
    exp["tpu"] = {"seed": 5, "precision": "f32", "pop_chunk": 2}
    torch.save({"exp": exp}, os.path.join(d, "es_inputs.pt"))
    return _ranks("es", d)


# ---- the tests -----------------------------------------------------------------


@pytest.mark.parametrize("n,world", [(1, 2), (7, 2), (8, 2), (5, 3),
                                     (144, 2), (1000, 2)])
def test_shard_plan_covers_every_member_once(n, world):
    """The ranks' shards hold every member exactly once among their real
    members; a pad repeats the last member and weighs 0."""
    from nes_img_captioning_tpu_torch.parallel.mesh import ShardPlan

    plans = [ShardPlan(n, world, r) for r in range(world)]
    per = plans[0].per_rank
    assert per == -(-n // world)
    real = np.concatenate([p.index()[p.real()] for p in plans])
    np.testing.assert_array_equal(real, np.arange(n))
    w = torch.arange(1, n + 1, dtype=torch.float32)
    for p in plans:
        pads = ~p.real()
        assert (p.index()[pads] == n - 1).all()
        lw = p.local_weights(w)
        assert lw.shape == (per,)
        assert (lw[torch.from_numpy(pads)] == 0).all()
        np.testing.assert_array_equal(lw[torch.from_numpy(p.real())].numpy(),
                                      w.numpy()[p.index()[p.real()]])


@pytest.mark.parametrize("variant", NES_VARIANTS)
def test_two_rank_nes_generation(nes_runs, variant):
    """One NES generation on 2 ranks: the fitnesses bit for bit the one
    process's, the ranks' theta bit for bit each other's and within 1e-6
    of the one process's; the delta-operand and host-scored paths, handed
    JAX's deltas, within 1e-5 (fitnesses) and 1e-6 (theta) of JAX's
    8-device mesh."""
    one, r0, r1 = (nes_runs[i][variant] for i in (0, 1, 2))
    for r in (r0, r1):
        np.testing.assert_array_equal(r["fitness"], one["fitness"])
        np.testing.assert_allclose(r["theta"], one["theta"], rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(r0["theta"], r1["theta"])
    assert np.ptp(one["fitness"]) > 0
    if variant != "noise":
        np.testing.assert_allclose(r0["fitness"], nes_runs["jax"]["fitness"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r0["theta"], nes_runs["jax"]["theta"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", list(ES_PATHS))
def test_two_rank_es_run(es_runs, path):
    """ESMaster with SM-G-SUM on 2 ranks, ES_ITERS generations: every
    fitness vector, the children, the podium rows and the stats bit for bit
    the one process's on both ranks; rank 1 kept its files out of the run's
    directory."""
    one, r0, r1 = (es_runs[i][path] for i in (0, 1, 2))
    assert one["fitness"].shape == (ES_ITERS, 7)
    assert np.ptp(one["fitness"]) > 0
    for r in (r0, r1):
        for key in ("fitness", "children", "podium"):
            np.testing.assert_array_equal(r[key], one[key], err_msg=key)
        assert r["stats"] == one["stats"]
    assert r0["log_dir"].endswith(os.path.join("w2", path))
    assert "nes_replica_logdir_" in r1["log_dir"]


def _stat_lines(err: str, label: str) -> dict:
    """{pid: [values]} of a transcript's ``| label:`` stat lines."""
    out = {}
    for m in re.finditer(r"pid=(\d+)\] \| " + label + r": .*\| *(\S+) \|",
                         err):
        out.setdefault(m.group(1), []).append(m.group(2))
    return out


def _mnist_exp(tmp_path, algo: str) -> dict:
    with open(os.path.join(REPO, "experiments", f"mnist_{algo}.json")) as f:
        exp = json.load(f)
    exp["nb_offspring"] = 8
    exp["synthetic_sizes"] = [64, 16]
    exp["config"].update({"batch_size": 8, "snapshot_freq": 2,
                          "patience": 0})
    exp["log_dir"] = str(tmp_path / "run")
    return exp


def _cli(exp_file, iters: int, *flags):
    return [sys.executable, "-m", "nes_img_captioning_tpu_torch.main",
            "master", "--exp_file", str(exp_file), "--max_iterations",
            str(iters), "--device", "cpu", *flags]


def _one_zinfo(run_dir) -> dict:
    (path,) = glob.glob(os.path.join(str(run_dir), "snapshot",
                                     "z_info_*.json"))
    with open(path) as f:
        text = f.read()
    assert "nes_replica_logdir_" not in text
    return path, json.loads(text)


def test_cli_two_processes_nes_and_resume(tmp_path):
    """mnist_nes.json (plain mutation, cut to toy size) as 2 processes of
    the CLI joined by --coordinator / --num_processes / --process_id
    (JAX: tests/test_multihost.py): both log the same RewMean, RewMax and
    UpdateRatio lines; one z_info, the primary's, whose files are in the
    run's directory. Its snapshot resumes in one process for one more
    iteration."""
    exp = _mnist_exp(tmp_path, "nes")
    exp["policy_options"]["model_options"]["safe_mutations"] = ""
    exp["tpu"] = {"seed": 11}
    exp_file = tmp_path / "exp.json"
    exp_file.write_text(json.dumps(exp))
    port = _free_port()
    errs = _run([_cli(exp_file, 2, "--coordinator", f"127.0.0.1:{port}",
                      "--num_processes", "2", "--process_id", str(r))
                 for r in range(2)])
    for label in ("RewMean", "RewMax", "UpdateRatio"):
        (a,), (b,) = (_stat_lines(e, label).values() for e in errs)
        assert len(a) == 2 and a == b, (label, a, b)
    assert "collectives over gloo" in errs[0]
    run_dir = tmp_path / "run"
    zpath, infos = _one_zinfo(run_dir)
    assert infos["iter"] == 2
    assert os.path.isfile(infos["current_model"])
    assert infos["current_model"].startswith(str(run_dir))

    exp["from_infos"] = zpath
    exp["log_dir"] = str(tmp_path / "resumed")
    (tmp_path / "resume.json").write_text(json.dumps(exp))
    _run([_cli(tmp_path / "resume.json", 3)])
    _, infos = _one_zinfo(tmp_path / "resumed")
    assert infos["iter"] == 3


def test_local_ranks_meet_while_ports_race(tmp_path):
    """Two ranks meet at the store their starter holds while another
    thread of the starter keeps trying to bind that store's port and churns
    through the system's free ports: the port is never free (the store holds
    it from the start, no port is released and bound again), and the ranks
    gather each other's rank and pid."""
    from nes_img_captioning_tpu_torch.parallel.multihost import (
        hold_rendezvous,
    )

    store = hold_rendezvous(2, datetime.timedelta(seconds=TIMEOUT))
    stop, taken, tries = threading.Event(), [], [0]

    def race():
        while not stop.is_set():
            with socket.socket() as a, socket.socket() as b:
                b.bind(("127.0.0.1", 0))  # another process's free port
                try:
                    a.bind(("127.0.0.1", store.port))
                    taken.append(store.port)
                except OSError:
                    pass
            tries[0] += 1

    racer = threading.Thread(target=race, daemon=True)
    torch.save({}, tmp_path / "meet_inputs.pt")
    racer.start()
    try:
        me = os.path.abspath(__file__)
        _run([[sys.executable, me, "meet", "2", str(r), str(store.port),
               str(tmp_path)] for r in range(2)])
    finally:
        stop.set()
        racer.join(timeout=10)
    assert not racer.is_alive() and not taken and tries[0] > 0
    outs = [torch.load(tmp_path / f"meet_w2_r{r}.pt", weights_only=False)
            for r in range(2)]
    for out in outs:
        assert out["world"] == 2
        assert out["ranks"][:, 0].tolist() == [0, 1]
    np.testing.assert_array_equal(outs[0]["ranks"], outs[1]["ranks"])


def test_cli_mesh_shape_starts_its_ranks(tmp_path):
    """mnist_es.json (SM-G-SUM, cut to toy size) with tpu.mesh_shape [2]
    and no --num_processes: one command starts 2 local ranks, which log
    the same RewMean, RewMax and EliteAcc lines over 4 iterations (the last
    2 as one block on both); one z_info, whose parents, candidates and
    podium files are in the run's directory."""
    exp = _mnist_exp(tmp_path, "es")
    exp.update(population_size=4, num_elites=1, num_elite_cands=1)
    exp["tpu"] = {"seed": 13, "gens_per_dispatch": 2, "mesh_shape": [2]}
    exp_file = tmp_path / "exp.json"
    exp_file.write_text(json.dumps(exp))
    (err,) = _run([_cli(exp_file, 4)])
    for label in ("RewMean", "RewMax", "EliteAcc"):
        by_pid = _stat_lines(err, label)
        assert len(by_pid) == 2, (label, by_pid)
        a, b = by_pid.values()
        assert len(a) == 4 and a == b, (label, a, b)
    assert err.count("(+1 chained)") == 2
    run_dir = str(tmp_path / "run")
    _, infos = _one_zinfo(run_dir)
    assert infos["iter"] == 4
    for _, path in infos["parents"] + infos["elites_to_evaluate"]:
        assert os.path.isfile(path) and path.startswith(run_dir), path
    for path, _ in infos["best_elites"]:
        assert os.path.isfile(path) and path.startswith(run_dir), path


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                int(sys.argv[4]), sys.argv[5])

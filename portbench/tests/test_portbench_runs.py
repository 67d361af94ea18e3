"""Whole runs of the benchmark on the CPU at a toy size: a cell dropped in
as files runs with no code edited, the program's plain CPU path agrees with
the reference, and the comparison fails the control (the reference at fp8)
and a run whose timed path is broken underneath. No run loads JAX.

The toy cell (``toy/``: a 16-wide captioner, 6 pairs x 4 images) is copied
with the benchmark into a temporary root, under the limits of
``nes_fc128_pairs2000``.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench.harness import bench  # noqa: E402
from portbench.readings import readings  # noqa: E402

CELL = "toy_nes"
LIMITS_OF = "nes_fc128_pairs2000"
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A checkout's copy of the benchmark with the toy cell's files
    dropped into its folders and named in its BENCHMARK.json."""
    top = tmp_path_factory.mktemp("checkout")
    dst = top / "portbench"
    shutil.copytree(REPO / "portbench", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "workloads"):
        for f in (dst / "tests" / "toy" / sub).iterdir():
            shutil.copy(f, dst / sub / f.name)
    wl = json.loads((dst / "workloads" / f"{CELL}.json").read_text())
    wl["limits"] = json.loads(
        (dst / "workloads" / f"{LIMITS_OF}.json").read_text())["limits"]
    (dst / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.setdefault("workloads", []).append(CELL)
    (top / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


def run(root: Path, seed: int = SEED) -> dict:
    torch.set_num_threads(1)
    return bench.run_cell(CELL, seed, 0.2, False, "cpu", root)


def test_a_dropped_cell_runs_and_agrees_with_the_reference(root):
    res = run(root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}
    for value, limit in res["checks"].values():
        assert value <= limit / 100


@pytest.mark.parametrize("side", ["control", "half", "token"])
def test_the_control_and_the_planted_faults_are_not_correct(root, side):
    nums = readings(CELL, SEED, side, torch.device("cpu"), root=root)
    limits = json.loads((root / "workloads" / f"{CELL}.json").read_text())[
        "limits"]
    assert any(nums[k] > limits[k] for k in limits), nums


def _state_unchanged(mp):
    from nes_img_captioning_tpu_torch.algorithms import optimizers

    mp.setattr(optimizers.Adam, "step",
               lambda self, state, theta, g, lr: (state, theta,
                                                  torch.zeros(())))


def _half_batch(mp):
    from nes_img_captioning_tpu_torch.tasks.captioning import CocoTask

    orig = CocoTask._device_fitness

    def half(self, seq, idx, dev=None, lp=None, base_seq=None):
        h = idx.shape[-1] // 2
        return orig(self, seq[:, :h], idx[:, :h], dev,
                    None if lp is None else lp[:, :h], base_seq)

    mp.setattr(CocoTask, "_device_fitness", half)


def _token_altered(mp):
    from nes_img_captioning_tpu_torch.ops import decode_cuda

    orig = decode_cuda.decode_pair_perturb

    def altered(base, *a, **kw):
        seq, lp = orig(base, *a, **kw)
        V = base["logit_w"].shape[-1] - 1
        seq = seq.clone()
        seq[..., 0] = seq[..., 0] % V + 1
        return seq, lp

    mp.setattr(decode_cuda, "decode_pair_perturb", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    res = run(root)
    assert not res["correct"]
    assert res["failed"] >= 1


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nes_img_captioning_tpu_torch_x",
                        sys.modules[__name__])
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nes_img_captioning_tpu.ops",
                        sys.modules[__name__])
    assert bench.forbidden_modules() == ["nes_img_captioning_tpu"]


def test_a_run_loads_no_jax(root):
    code = (
        "import sys, torch; sys.path.insert(0, %r);"
        "from pathlib import Path; from portbench.harness import bench;"
        "torch.set_num_threads(1);"
        "r = bench.run_cell(%r, 5, 0.1, False, 'cpu', Path(%r));"
        "print(r['correct'], bench.forbidden_modules())"
    ) % (str(REPO), CELL, str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"

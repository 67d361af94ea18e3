"""Port parity for NIC-ES with SM-G-SUM and SM-G-ABS (exact and with the
probe estimator): 3 generations of the port's ESMaster against the JAX
package's on the plain and fused paths. The experiment, seams and checks
are those of ``test_torch_es_smg.py``.
"""

import pytest

from test_torch_es import CALLS, PATHS, coco  # noqa: F401
from test_torch_es_smg import _assert_same_trajectory, _run_pair, smg_exp

from torch_pin import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("mutation,probes,path", [
    ("SM-G-SUM", 0, "plain"), ("SM-G-SUM", 0, "fused"),
    ("SM-G-ABS", 0, "plain"), ("SM-G-SUM", 3, "fused")],
    ids=["sum-plain", "sum-fused", "abs-plain", "probes-fused"])
def test_smg_trajectory_matches_jax(coco, tmp_path, monkeypatch, mutation,
                                    probes, path):
    """3 generations of SM-G NIC-ES (greedy CIDEr-D on the device) on the
    plain path (the master's _update_sensitivities) and the fused path (the
    sensitivities inside the generation), against JAX's: the same streams
    and selections, fitness within 1e-5."""
    tpu = dict(PATHS[path])
    if probes:
        tpu["sensitivity_probes"] = probes
    exp = smg_exp(coco, tmp_path / "jax", mutation, **tpu)
    jax_run, torch_run = _run_pair(exp, tmp_path, monkeypatch, 3)
    _assert_same_trajectory(jax_run, torch_run, 3)
    assert torch_run[0]["calls"] == CALLS[path][:3]

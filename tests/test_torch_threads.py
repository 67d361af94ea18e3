"""The port's CPU tests run torch on one intra-op thread (``torch_pin``),
and what the port holds at more threads.

The guard: every ``tests/test_torch_*.py`` module carries the pin, a port
test runs on one thread, and a process it starts does too.

At 4 threads (``test_members_together_at_four_threads``), M members decoded
together are not bit for bit M calls of one member (MKL blocks a batched
product over the member axis another way), so the 4-thread case holds:
tokens equal, or first apart at a near-tie of the one-by-one decode (top-2
gap under ``NEAR_TIE``, ROADMAP.md §3); lp within the port's bar (2e-5, and
1e-4 with the vbn norm, as against JAX in ``test_torch_norm_variants.py``)
up to that step; and ``calc_sensitivities`` rows within ``SENS_RTOL`` of
``calc_sensitivity``.
"""

import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nes_img_captioning_tpu_torch.models.fc_caption import FCCaptionModel
from nes_img_captioning_tpu_torch.ops import decode_cuda as tdc
from nes_img_captioning_tpu_torch.ops import sensitivity as tsens
from nes_img_captioning_tpu_torch.ops.decode_layout import DecodeLayout
from nes_img_captioning_tpu_torch.ops.mutation import MutationKind

import torch_pin
from test_torch_decode import _setup
from test_torch_norm_variants import _models, _theta, _tol
from test_torch_sensitivity import UNDERFLOW, _idx, _tasks
from test_torch_sensitivity import _theta as _sens_theta
from test_torch_sensitivity import coco  # noqa: F401
from torch_pin import one_intra_op_thread  # noqa: F401

TESTS = pathlib.Path(__file__).resolve().parent
THREADS = 4
NEAR_TIE = 1e-4
# calc_sensitivities' rows against calc_sensitivity read up to 2.46e-6
# relative at 2, 6 and 8 threads on an 8-core AMD EPYC (MKL 2024.2), 0 at 1,
# 3 and 4: about 21 f32 ulps of reordered sums. 1e-5 leaves 4x for another
# host's blocking, while another parent's row misses by orders of magnitude.
SENS_RTOL = 1e-5


def test_every_port_test_module_carries_the_pin(request):
    """Each tests/test_torch_*.py module holds the pin fixture, and pytest
    applies it to every port test it collected."""
    paths = sorted(TESTS.glob("test_torch_*.py"))
    assert len(paths) >= 38
    missing = [p.name for p in paths
               if getattr(importlib.import_module(p.stem),
                          "one_intra_op_thread", None)
               is not torch_pin.one_intra_op_thread]
    assert not missing, f"modules without the pin: {missing}"
    unpinned = [item.nodeid for item in request.session.items
                if item.path.name.startswith("test_torch_")
                and "one_intra_op_thread" not in getattr(
                    item, "fixturenames", ())]
    assert not unpinned, unpinned[:10]


def test_port_tests_and_their_processes_run_on_one_thread():
    """Inside a port test torch runs one intra-op thread (unless the
    switch asks for more), and so does a process the test starts."""
    n = torch_pin.pinned_threads()
    if torch_pin.THREADS_VAR not in os.environ:
        assert n == 1
    assert torch.get_num_threads() == n
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == n


def _hold(seq_b, lp_b, seq_1, lp_1, gap_1, tol):
    """Batched (seq_b, lp_b) against one-by-one (seq_1, lp_1) decodes, each
    (M, B, T), with gap_1 the one-by-one top-2 gaps: per member, tokens
    equal or first apart where every differing row was a near-tie, and lp
    within tol on the steps before that (a vbn member's rows share batch
    statistics, so a flip moves all of them after it)."""
    T = seq_b.shape[-1]
    for m in range(seq_b.shape[0]):
        diff = seq_b[m] != seq_1[m]
        t0 = int(diff.any(0).nonzero()[0]) if diff.any() else T
        if t0 < T:
            gap = float(gap_1[m][diff[:, t0], t0].max())
            assert gap < NEAR_TIE, (m, t0, gap)
        err = float((lp_b[m, :, :t0] - lp_1[m, :, :t0]).abs().max()) \
            if t0 else 0.0
        assert err <= tol, (m, t0, err)


def eager_members(variant):
    """test_sample_members_bitwise_single_member_calls' greedy inputs at
    the current thread count: (seq, lp) of the 4 members together and
    (seq, lp, top-2 gap) one by one (gaps replayed by
    chip_smoke.eager_top2_gaps), each (4, 6, 16)."""
    import chip_smoke

    jm, opts = _models(variant)
    thetas = torch.from_numpy(np.stack([_theta(jm, s) for s in range(4)]))
    feats = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 6, 32)).astype(np.float32))
    tm = FCCaptionModel(opts, device="meta")
    seq, lp = tm.sample_members(thetas, feats, True)
    ones = [tm.sample_members(thetas[m:m + 1], feats[m:m + 1], True)
            for m in range(4)]
    seq_1 = torch.cat([s for s, _ in ones])
    gap_1 = torch.stack([
        chip_smoke.eager_top2_gaps(tm, thetas[m], feats[m], seq_1[m])
        for m in range(4)])
    return seq, lp, seq_1, torch.cat([l for _, l in ones]), gap_1


def k1_members():
    """test_plain_k1_early_stop_and_batch_of_members' 2 members through
    K1's plain twin, as eager_members."""
    jm, theta, spec, topts = _setup(40, 16, 8, seed=5)
    boosted = theta.copy()
    boosted[jm.spec.offset("logit.bias")] += 8.0
    feats = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 16)).astype(np.float32))
    members = [tdc.prepare_decode_params(spec, torch.from_numpy(t), topts)
               for t in (boosted, theta)]
    batched = {k: torch.stack([m[k] for m in members]) for k in members[0]}
    seq, lp = tdc.decode_fused(batched, feats)
    ones = [tdc.decode_fused_plain(m, feats, top2_gap=True) for m in members]
    return (seq, lp, *(torch.stack(o) for o in zip(*ones)))


def k2_pairs():
    """test_plain_k2_batch_of_pairs_and_pad_lanes' 3 pairs through K2's
    plain twin, as eager_members over 6 (pair, sign) members; a sign's
    top-2 gaps from K1's twin on prep(base ± delta)."""
    jm, theta, spec, topts = _setup(50, 16, 8, seed=0)
    tl = DecodeLayout(spec, topts)
    base_vec = tl.to_dec(torch.from_numpy(theta))
    base = tl.prep(base_vec, torch.float32)
    sc = tl.to_dec(torch.full((spec.num_params,), 1.0), pad_scale=0.0)
    g = torch.Generator().manual_seed(4)
    deltas = torch.stack([sc * torch.randn(tl.dim_dec, generator=g)
                          for _ in range(3)])
    feats = torch.randn((3, 4, 16), generator=g)
    seq, lp = tdc.decode_pair_perturb(base, tl.prep(deltas, torch.float32),
                                      feats, need_logprobs=True)
    ones = [tdc.decode_pair_perturb(base, tl.prep(deltas[p], torch.float32),
                                    feats[p], need_logprobs=True)
            for p in range(3)]
    gaps = [tdc.decode_fused_plain(
        tl.prep(base_vec + s * deltas[p], torch.float32), feats[p],
        top2_gap=True)[2] for p in range(3) for s in (1.0, -1.0)]
    seq_1 = torch.stack([s for s, _ in ones])
    lp_1 = torch.stack([l for _, l in ones])
    # (pair, sign) -> one axis of 6 members, sign-minor as the gaps
    return (*(x.flatten(0, 1) for x in (seq, lp, seq_1, lp_1)),
            torch.stack(gaps))


def sensitivity_rows(coco_opts):
    """test_calc_sensitivities_rows_do_not_depend_on_p's 7 parents at the
    current thread count: calc_sensitivities' rows (7, dim) and
    calc_sensitivity of each parent alone (7, dim)."""
    jtask, ttask = _tasks(coco_opts, 4)
    idx = torch.as_tensor(_idx(), dtype=torch.long)
    kind = MutationKind.SAFE_GRAD_SUM
    thetas = torch.from_numpy(np.stack([_sens_theta(jtask, s) for s in
                                        range(1, 8)]).astype(np.float32))
    rows = tsens.calc_sensitivities(ttask, thetas, idx, kind, UNDERFLOW)
    return rows, torch.stack([
        tsens.calc_sensitivity(ttask, th, idx, kind, UNDERFLOW)
        for th in thetas])


@pytest.mark.parametrize("case", ["eager-none", "eager-vbn",
                                  "eager-vbn_e_affine", "eager-layer_n",
                                  "k1", "k2", "sensitivities"])
def test_members_together_at_four_threads(case, request):
    """At 4 intra-op threads, members (pairs, parents) computed together
    against one at a time, within the bars of the module docstring; the
    pin's count is back afterwards."""
    n = torch.get_num_threads()
    with torch_pin.intra_op_threads(THREADS):
        if case == "sensitivities":
            rows, single = sensitivity_rows(request.getfixturevalue("coco"))
        elif case.startswith("eager-"):
            variant = case.split("-", 1)[1]
            _hold(*eager_members(variant), _tol(variant))
        else:
            _hold(*{"k1": k1_members, "k2": k2_pairs}[case](), 2e-5)
    if case == "sensitivities":
        torch.testing.assert_close(rows, single, rtol=SENS_RTOL, atol=0)
        assert not torch.equal(rows[0], rows[1])
    assert torch.get_num_threads() == n

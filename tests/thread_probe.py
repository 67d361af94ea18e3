"""How far the port's "members together equal members one by one" results
move with torch's intra-op thread count, on the CPU: the evidence behind
the one-thread pin of the port's tests (``tests/torch_pin.py``) and the
bars of ``test_torch_threads.py::test_members_together_at_four_threads``.

    JAX_PLATFORMS=cpu python tests/thread_probe.py [THREADS ...]

Defaults: 1 2 4 8. For each count: the eager captioner's 4 members
(variants none, vbn, vbn_e_affine, layer_n, vbn_affine), K1's plain twin
on 2 members and K2's on 3 pairs, each together against one by one
(members whose tokens differ, the largest top-2 gap at a first
difference, the largest |lp| gap before it); ``calc_sensitivities``' 7
rows against ``calc_sensitivity`` (largest relative gap); and
``test_eager_greedy_matches_jax[vbn_affine]``'s decode against JAX's
(tokens that differ, the first differing step and its top-2 gap replayed
on JAX's tokens). Also the probe of the cause: ``torch.baddbmm`` over 4
members at (4, 6, 32) x (4, 32, 31) against one member at a time. A
measurement, not a check: not collected by pytest.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _first_apart(seq_b, lp_b, seq_1, lp_1, gap_1):
    """(members apart, largest top-2 gap at a first difference, largest
    |lp| gap before each member's first difference)."""
    T = seq_b.shape[-1]
    apart, gap, err = 0, 0.0, 0.0
    for m in range(seq_b.shape[0]):
        diff = seq_b[m] != seq_1[m]
        t0 = int(diff.any(0).nonzero()[0]) if diff.any() else T
        if t0 < T:
            apart += 1
            gap = max(gap, float(gap_1[m][diff[:, t0], t0].max()))
        if t0:
            err = max(err, float((lp_b[m, :, :t0] - lp_1[m, :, :t0])
                                 .abs().max()))
    return apart, gap, err


def _baddbmm_invariant() -> bool:
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 6, 32), generator=g)
    w = torch.randn((4, 32, 31), generator=g)
    b = torch.randn((4, 1, 31), generator=g)
    together = torch.baddbmm(b, x, w)
    return all(torch.equal(together[m], torch.baddbmm(
        b[m:m + 1], x[m:m + 1], w[m:m + 1])[0]) for m in range(4))


def _vbn_affine_against_jax() -> str:
    import chip_smoke
    from test_torch_norm_variants import _models, _theta
    from torch_pin import intra_op_threads

    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCCaptionModel,
    )

    jm, opts = _models("vbn_affine")
    theta = _theta(jm)
    feats = np.random.default_rng(2).normal(size=(6, 32)).astype(np.float32)
    seq_j = np.array(jm.sample(jnp.asarray(theta), jnp.asarray(feats),
                               greedy=True)[0])
    tm = FCCaptionModel(opts, theta=torch.from_numpy(theta), device="cpu")
    seq = tm.sample(torch.from_numpy(feats))[0].numpy()
    diff = seq != seq_j
    if not diff.any():
        return "0 of 96 tokens differ"
    t0 = int(diff.any(0).nonzero()[0][0])
    rows = diff[:, t0].nonzero()[0]

    def gaps(tokens):
        return chip_smoke.eager_top2_gaps(
            tm, torch.from_numpy(theta), torch.from_numpy(feats),
            torch.from_numpy(tokens))[rows, t0].tolist()

    with intra_op_threads(1):
        gap_1 = gaps(seq_j)
    return (f"{int(diff.sum())} of 96 tokens differ, first at step {t0} "
            f"rows {rows.tolist()}: top-2 gap on JAX's tokens {gaps(seq_j)} "
            f"(replayed at 1 thread: {gap_1}), on the port's {gaps(seq)}")


def main(argv) -> None:
    jax.config.update("jax_platforms", "cpu")
    from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
    from test_torch_threads import (
        eager_members,
        k1_members,
        k2_pairs,
        sensitivity_rows,
    )
    from torch_pin import intra_op_threads

    counts = [int(a) for a in argv] or [1, 2, 4, 8]
    coco = make_synthetic_coco(tempfile.mkdtemp(), n_train=24, n_val=4,
                               n_test=4, vocab_size=30, fc_feat_size=24)
    print(f"torch {torch.__version__}, default {torch.get_num_threads()} "
          f"intra-op threads, {os.cpu_count()} cores")
    cases = {f"eager-{v}": (lambda v=v: eager_members(v))
             for v in ("none", "vbn", "vbn_e_affine", "layer_n",
                       "vbn_affine")}
    cases.update(k1=k1_members, k2=k2_pairs)
    for n in counts:
        with intra_op_threads(n):
            print(f"threads {n}: baddbmm over 4 members batch-invariant: "
                  f"{_baddbmm_invariant()}")
            for name, build in cases.items():
                apart, gap, err = _first_apart(*build())
                print(f"  {name}: members apart {apart}, top-2 gap at a "
                      f"first difference {gap:.3g}, max |lp| gap before "
                      f"it {err:.3g}")
            rows, single = sensitivity_rows(coco)
            rel = float(((rows - single).abs() / single.abs()).max())
            print(f"  sensitivities: max relative gap {rel:.3g}")
            print(f"  vbn_affine against JAX: {_vbn_affine_against_jax()}")


if __name__ == "__main__":
    main(sys.argv[1:])

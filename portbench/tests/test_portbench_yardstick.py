"""The benchmark's own arithmetic, on the CPU: the copied FLOP counts
reproduce the kernel table's bounds, the interval union counts overlapping
streams once, and the data repeats for a seed.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import data as bench_data  # noqa: E402
from portbench.harness import flops  # noqa: E402
from portbench.harness.trace import union_s  # noqa: E402

V1, F, T = 9488, 2048, 16


@pytest.mark.parametrize("width, batches, rows, ms", [
    (128, 2 * 48, 64, 0.2783),    # K2, true regime: 48 pairs x 64 rows
    (512, 2 * 48, 128, 3.0323),   # K2 at 512: 48 pairs x 128 rows
    (128, 16, 128, 0.0928),       # K1, an ES chunk: 16 members x 128 rows
])
def test_decode_bounds_match_the_kernel_table(width, batches, rows, ms):
    steps = torch.full((batches,), T)
    got = flops.decode_flops(steps, rows, F, V1, width, width) \
        / flops.PEAK_BF16 * 1e3
    assert round(got, 4) == ms


def test_pair_launch_bound_is_its_operations_at_128():
    b = flops.pair_launch_bound_s(48, 64, F, V1, 128, 128, 2_894_592, T, T)
    assert round(b * 1e3, 4) == 0.2783


def test_executed_steps_end_at_the_batch_last_eos():
    seq = torch.tensor([[[5, 0, 0, 0], [5, 6, 0, 0]],
                        [[5, 6, 7, 8], [0, 0, 0, 0]]])
    assert flops.executed_steps(seq, 4).tolist() == [3, 4]


@pytest.mark.parametrize("spans, busy", [
    ([(0, 10), (5, 15), (20, 30)], 25),        # two streams overlap once
    ([(0, 100), (10, 20), (30, 40)], 100),     # one inside another
    ([(50, 60), (0, 10)], 20),                 # out of order
])
def test_union_counts_overlapping_streams_once(spans, busy):
    assert union_s(spans) == busy / 1e9


SIZES = {"train": 20, "restval": 6, "val": 5, "test": 3, "cap_len": 4,
         "caps_per_img": 5, "paraphrase": 0.3, "feat_noise": 0.1}


@pytest.mark.parametrize("seed", [7, 2**31 + 11, 2**33 + 5])
def test_data_repeats_for_a_seed(seed):
    a = bench_data.make_arrays(SIZES, 40, 16, 16, seed, "cpu")
    b = bench_data.make_arrays(SIZES, 40, 16, 16, seed, "cpu")
    c = bench_data.make_arrays(SIZES, 40, 16, 16, seed + 1, "cpu")
    for k in ("labels", "feats", "label_start_ix", "label_end_ix"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["info"] == b["info"]
    assert not np.array_equal(a["feats"], c["feats"])
    split = bench_data.split_rows(a)
    assert {k: len(v) for k, v in split.items()} == {
        "train": 26, "val": 5, "test": 3}
    assert a["labels"].shape == (34 * 5, 16)
    assert (a["labels"][:, 4:] == 0).all() and (a["labels"][:, :4] > 0).all()

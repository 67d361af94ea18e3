"""The one intra-op thread that every ``tests/test_torch_*.py`` module runs
torch on, and the processes it starts too.

Each port test module imports the fixture, which is autouse and
module-scoped, so the pin covers that module alone:

    from torch_pin import one_intra_op_thread  # noqa: F401

Why: with several intra-op threads MKL blocks a batched product
(``torch.baddbmm`` over a member axis, as the eager captioner takes it)
differently from the same product on one member, so "M members together
equal M calls of one member, bit for bit" holds only on one thread; and
the suite's parallel xdist workers, each running torch's default of one
thread per core, oversubscribe the host's cores many times over.

``NES_TORCH_TEST_THREADS=<n>`` pins n threads instead, to reproduce a test
at more threads (``OMP_NUM_THREADS`` does nothing under the pin).
"""

import contextlib
import os

import pytest
import torch

THREADS_VAR = "NES_TORCH_TEST_THREADS"
CHILD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def pinned_threads() -> int:
    """The intra-op thread count of the port's tests: 1 unless the switch
    asks for another."""
    return int(os.environ.get(THREADS_VAR, "1"))


@contextlib.contextmanager
def intra_op_threads(n: int):
    """Run the block on ``n`` intra-op threads, then restore the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield n
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Run the module's tests on ``pinned_threads()`` intra-op threads and
    give every process they start that count in ``OMP_NUM_THREADS`` and
    ``MKL_NUM_THREADS``; restore the count and the environment after the
    module's last test."""
    n = pinned_threads()
    env = {k: os.environ.get(k) for k in CHILD_VARS}
    os.environ.update({k: str(n) for k in CHILD_VARS})
    try:
        with intra_op_threads(n):
            yield n
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

"""The window's model FLOPs (the rollouts' and the validation's forward
decodes, counted from their shapes and executed steps) over the window's
host seconds, as a share of one H100's dense bf16 peak."""

from portbench.harness.flops import PEAK_BF16


def read(run):
    if not run["gens"]:
        return None
    rate = run["gens"] * run["flops_per_gen"] / run["window_s"]
    return 100.0 * rate / PEAK_BF16

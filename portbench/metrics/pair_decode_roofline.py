"""The pair kernel's (K2, ``decode_pair_perturb``) share of its roofline:
the least time of one launch from its shapes (``flops.pair_launch_bound_s``:
its products at the bf16 peak, or its bytes once over HBM, whichever is
longer) over its mean device time per launch in the traced cycle. Nothing
to read where the window ran no K2 launch."""

from portbench.harness.flops import pair_launch_bound_s

NAME = "::pair_kernel<"


def read(run):
    tr = run["trace"]
    if not tr or not run["counters"].get("decode_pair_perturb"):
        return None
    rows = [v for k, v in tr["ops"].items() if NAME in k]
    n = sum(v[1] for v in rows)
    if not n:
        return None
    per_launch = sum(v[0] for v in rows) / n
    bound = pair_launch_bound_s(run["pop_chunk"], run["B"], run["F"],
                                run["V1"], run["E"], run["R"],
                                run["dim_dec"], run["steps"], run["T"])
    return 100.0 * bound / per_launch

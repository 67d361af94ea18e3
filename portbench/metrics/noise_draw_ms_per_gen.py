"""Device milliseconds per generation of torch's normal-distribution
kernels (the seeded draws of the pairs' deltas), by kernel name in the
traced cycle."""


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    s = [v[0] for k, v in tr["ops"].items() if "normal" in k.lower()]
    return 1e3 * sum(s) / tr["gens"] if s else None

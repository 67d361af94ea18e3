"""Device milliseconds per generation of the traced cycle that are neither
a decode kernel (the pair and member kernels) nor a normal draw: delta
products and stacks, gathers, CIDEr-D, the update, copies."""

DECODE = ("::pair_kernel<", "::member_kernel<")


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    skip = sum(v[0] for k, v in tr["ops"].items()
               if any(d in k for d in DECODE) or "normal" in k.lower())
    return 1e3 * (tr["busy_s"] - skip) / tr["gens"]

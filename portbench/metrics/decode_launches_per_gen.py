"""Launches of the program's decode wrappers (``decode_cuda``'s
``launches`` counters of every ``decode*`` wrapper) over the window, per
generation."""


def read(run):
    if not run["gens"] or not run["counters"]:
        return None
    return sum(run["counters"].values()) / run["gens"]

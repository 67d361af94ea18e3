"""Share of the window in which no operation ran on the card:
100 x (1 - the traced cycle's device busy seconds per generation (the
union of its operations' intervals) x the window's generations / the
window's host seconds). The busy time comes from the trace; the host time
from the same run's untraced window, since the profiler's own host work
lengthens the traced cycle (by 5-10% on the card's host) and would count
as idle."""


def read(run):
    tr = run["trace"]
    if not tr or not run["gens"]:
        return None
    busy = tr["busy_s"] / tr["gens"] * run["gens"]
    return 100.0 * (1.0 - busy / run["window_s"])

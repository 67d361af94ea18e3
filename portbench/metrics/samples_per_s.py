"""Captions the window's generations decoded and scored for fitness (2 x
pairs x batch rows each; no pad lane, no validation row) over the
window's host seconds."""


def read(run):
    if not run["gens"]:
        return None
    return run["gens"] * run["captions_per_gen"] / run["window_s"]

"""Seconds from the process's start to the end of the warm-up
generations: imports, the data, the master's set-up and the warm-up."""


def read(run):
    return run["setup_s"]

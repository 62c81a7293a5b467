"""Seconds from the start of the process to the start of the window:
imports, kernel build or load, weights, derivatives, the base commit and
the warm-up (host clock)."""


def read(run):
    return run.setup_s

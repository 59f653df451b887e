"""Seconds from the process's start to the window's: imports, the card,
the kernels' build or load, weights and data from the seed, the labels,
the global Fisher and the warm-up request."""


def read(r):
    return r.setup_s

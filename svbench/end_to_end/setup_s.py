"""Seconds from the start of the process to the start of the window:
imports, the card's start, the kernels' build or load, the inputs, the
warm-up."""


def read(run):
    return run.setup_s

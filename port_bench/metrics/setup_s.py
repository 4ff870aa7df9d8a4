"""Seconds from the process's start to the first timed step: imports,
kernel build or load, molecules, model, weights, warm-up and capture."""


def read(run):
    return run.setup_s

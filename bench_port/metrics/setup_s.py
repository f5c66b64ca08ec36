"""Seconds from process start to the first timed request: imports, seeded weights on the card, the kernels' build or load, warm-up."""
from bench_port.lib import readers


def read(run):
    return readers.setup_s(run)

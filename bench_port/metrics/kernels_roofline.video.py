"""Least time of the work asked of the op entries over the device time of the hand-written kernels they launched, in %."""
from bench_port.lib import readers


def read(run):
    return readers.kernels_roofline(run)

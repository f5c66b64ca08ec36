"""Least time at the peaks of the videos' model flops (counted on meta tensors by the reference) over the traced window, in %."""
from bench_port.lib import readers


def read(run):
    return readers.mfu_pct(run)

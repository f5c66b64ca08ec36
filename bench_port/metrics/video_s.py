"""Wall seconds of the window's videos over their count, each from its prompt encode until its uint8 frames are on the host."""
from bench_port.lib import readers


def read(run):
    return readers.mean_request_s(run)

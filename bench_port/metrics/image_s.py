"""Wall seconds of the window's image requests over their count, each from its prompt encodes until its uint8 images are on the host."""
from bench_port.lib import readers


def read(run):
    return readers.mean_request_s(run)

"""Mean host microseconds of a call of the program's op entries (K1, K2, K3, K7) in the traced window."""
from bench_port.lib import readers


def read(run):
    return readers.dispatch_us(run)

"""Mean host us of a call of the op entries (K1, K2, K3, K7), stamped by the program inside them."""
from bench_port.lib import spans


def read(run):
    return spans.entry_host_us(run)

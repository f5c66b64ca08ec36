"""Host ms a request spent in the program's gc spans (cyclic garbage collections) in the traced window."""
from bench_port.lib import spans


def read(run):
    return spans.gc_ms(run)

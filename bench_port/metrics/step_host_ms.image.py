"""Host ms of a denoise step: the program's step spans, no synchronise."""
from bench_port.lib import spans


def read(run):
    return spans.step_host_ms(run)

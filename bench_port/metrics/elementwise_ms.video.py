"""Device ms a denoise step of kernels in no category (elementwise and reductions), from the trace."""
from bench_port.lib import readers


def read(run):
    return readers.elementwise_ms(run)

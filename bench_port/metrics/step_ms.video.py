"""Device ms of a denoise step: the program's step spans' CUDA event pairs, over the window's steps."""
from bench_port.lib import spans


def read(run):
    return spans.step_ms(run)

"""Device ms of a denoise step of an image request (CUDA events from before the sampler's call to its last step, over the steps)."""
from bench_port.lib import readers


def read(run):
    return readers.step_ms(run)

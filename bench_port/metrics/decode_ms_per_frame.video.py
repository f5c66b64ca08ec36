"""Device ms of the fp32 VAE decode a frame (CUDA events around the decode, over its frames)."""
from bench_port.lib import readers


def read(run):
    return readers.decode_ms_per_frame(run)

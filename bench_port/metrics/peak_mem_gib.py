"""torch.cuda.max_memory_allocated over set-up and window, in GiB."""
from bench_port.lib import readers


def read(run):
    return readers.peak_mem_gib(run)

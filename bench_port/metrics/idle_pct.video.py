"""Share of the traced window (first request's start to last's end) with nothing running on the device, in %."""
from bench_port.lib import readers


def read(run):
    return readers.idle_pct(run)

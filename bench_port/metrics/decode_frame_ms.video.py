"""Device ms of the program's decode spans over the frames they decoded."""
from bench_port.lib import spans


def read(run):
    return spans.decode_frame_ms(run)

"""What the ``program_span`` metrics of the program's own spans read:
the records of ``video_style_transfer_tpu_torch.utils.tracing``, which
the program keeps while the traced window's profiler session runs (the
only session of a run: set-up runs before it, the check after it).

Each reader returns None where the program recorded nothing: an
untraced run, or a program without that module or span."""
from __future__ import annotations

from statistics import mean


def recorded():
    """The program's spans, their event pairs read; None without any."""
    try:
        from video_style_transfer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.read() or None


def _closed(spans, name=None, prefix=None):
    return [s for s in spans or () if s.end is not None
            and (name is None or s.name == name)
            and (prefix is None or s.name.startswith(prefix))]


def step_ms(run):
    """Mean device ms of the program's ``step`` spans (their CUDA event
    pairs): one denoise step, the k/v precompute outside it."""
    xs = [s.device_s for s in _closed(recorded(), "step")
          if s.device_s is not None]
    return 1e3 * mean(xs) if xs else None


def step_host_ms(run):
    """Mean host ms of the program's ``step`` spans."""
    xs = [s.host_s for s in _closed(recorded(), "step")]
    return 1e3 * mean(xs) if xs else None


def decode_frame_ms(run):
    """Device ms of the program's ``decode`` spans over the frames their
    ``decode.frame`` children decoded."""
    spans = recorded()
    dev = [s.device_s for s in _closed(spans, "decode")
           if s.device_s is not None]
    frames = sum((s.attrs or {}).get("frames", 0)
                 for s in _closed(spans, "decode.frame"))
    return 1e3 * sum(dev) / frames if dev and frames else None


def entry_host_us(run):
    """Mean host us of a call of the op entries (K1, K2, K3, K7), the
    program's ``op.*`` spans, stamped inside the entries."""
    xs = [s.host_s for s in _closed(recorded(), prefix="op.")]
    return 1e6 * mean(xs) if xs else None


def gc_ms(run):
    """Host ms a request in the program's ``gc`` spans (cyclic garbage
    collections) over the window, divided by the window's requests."""
    spans = recorded()
    if spans is None or not run.request_s:
        return None
    return 1e3 * sum(s.host_s for s in _closed(spans, "gc")) \
        / len(run.request_s)

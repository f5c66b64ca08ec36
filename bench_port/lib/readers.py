"""What the metric files under ``metrics/`` read from a finished run (the
harness's ``run`` namespace: setup_s, request_s, peak_bytes, the
generator's CUDA-event timings and entry log, and the trace summary). Each
returns None where the run holds nothing to read, so the metric is left
out of the result line, never read as 0."""
from __future__ import annotations

from statistics import mean

from bench_port.lib import categories


def setup_s(run):
    return run.setup_s


def mean_request_s(run):
    return mean(run.request_s) if run.request_s else None


def peak_mem_gib(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None


def step_ms(run):
    xs = run.driver.step_ms
    return mean(xs) if xs else None


def decode_ms_per_frame(run):
    xs = run.driver.decode_ms
    return mean(xs) if xs else None


def _steps(run):
    return run.traffic["steps"] * len(run.request_s)


def elementwise_ms(run, range_name: str = "step"):
    """Device ms of kernels in no category, launched in the denoise
    steps, a step."""
    tr = run.trace
    if tr is None or not run.request_s:
        return None
    cats = tr["by_range"].get(range_name)
    if not cats:
        return None
    return 1e3 * cats.get(categories.OTHER, 0.0) / _steps(run)


def idle_pct(run):
    tr = run.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def dispatch_us(run):
    calls = run.driver.entries.calls
    if not calls:
        return None
    return mean(ns for _, ns, _ in calls) / 1e3


def kernels_roofline(run):
    """The least time of the work asked of the op entries (K1-K7) over
    the device time of the hand-written kernels they launched."""
    tr, calls = run.trace, run.driver.entries.calls
    if tr is None or not calls:
        return None
    device = sum(s for cat, s in tr["by_category"].items()
                 if categories.kernel_id(cat) is not None)
    if device <= 0:
        return None
    return 100.0 * sum(least for _, _, least in calls) / device


def mfu_pct(run):
    """The least time the request's model flops take at the peaks, over
    the traced window's length."""
    from bench_port.lib import work
    tr = run.trace
    if tr is None or not run.request_s or tr["window_s"] <= 0:
        return None
    low, f32 = run.driver.request_model_flops()
    least = low / work.PEAK_BF16 + f32 / work.PEAK_FP32
    return 100.0 * least * len(run.request_s) / tr["window_s"]

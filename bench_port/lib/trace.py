"""The traced run's instruments and their reduction, all in memory.

- ``Ranges``: the benchmark's own host ranges (encode, fold, step, decode,
  ...) as perf_counter intervals, and, in a traced run, a marker kernel
  (``torch.cuda._sleep``, "spin_kernel") launched where each range opens,
  so that the device's timeline can be cut at the same boundaries: the
  device runs the marker after everything launched before it.
- ``EntryLog``: a wrapper around each op entry of the program's
  hand-written kernels (K1, K2, K3, K7) that times the call's host span
  and counts the least time of the work it was asked for
  (``lib/work.py``).
- ``reduce``: from the profiler's device events (kernels, copies and
  fills) and the markers, the busy and idle time of the traced window,
  device time by category and by range, and the longest idle gaps named
  by the host range open when each began.

The profiler records the device only (``ProfilerActivity.CUDA``); no
Chrome trace is written.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

from bench_port.lib import categories, work

MARKER = "spin_kernel"


class Ranges:
    def __init__(self, markers: bool):
        self.markers = markers
        self.closed = []           # (name, t0, t1), host seconds
        self.opened = []           # names, in the order their markers ran
        self._open = []

    def open(self, name: str):
        if self.markers:
            torch.cuda._sleep(1)
            self.opened.append(name)
        self._open.append((name, time.perf_counter()))

    def close(self):
        name, t0 = self._open.pop()
        self.closed.append((name, t0, time.perf_counter()))

    def __call__(self, name: str):
        ranges = self

        class _Ctx:
            def __enter__(self):
                ranges.open(name)

            def __exit__(self, *exc):
                ranges.close()
        return _Ctx()

    def innermost(self, t: float):
        best = None
        for name, t0, t1 in self.closed:
            if t0 <= t < t1 and (best is None or t0 >= best[1]):
                best = (name, t0)
        return None if best is None else best[0]


class EntryLog:
    """Host span and least time of every call of the wrapped entries
    while ``on``."""

    def __init__(self):
        self.on = False
        self.calls = []            # (kernel id, host ns, least seconds)

    def wrap(self, fn, kid: str, name: str):
        fn = getattr(fn, "__wrapped__", fn)
        count = work.ENTRIES[kid][name]
        log = self

        def entry(*args, **kw):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kw)
            t1 = time.perf_counter_ns()
            if log.on:
                log.calls.append((kid, t1 - t0, count(*args, **kw)))
            return out
        entry.__wrapped__ = fn
        return entry


def install_entry_wrappers(log: EntryLog):
    """Wrap the program's op entries where its models call them."""
    from video_style_transfer_tpu_torch.models import attention, motion
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import layer_norm as ln
    for mod, name, kid in ((fa, "flash_attention", "K1"),
                           (fa, "flash_attention_qkv", "K1"),
                           (attention, "geglu_projection", "K2"),
                           (motion, "temporal_attention", "K3"),
                           (ln, "layer_norm", "K7")):
        setattr(mod, name, log.wrap(getattr(mod, name), kid, name))


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def device_events(prof):
    """[(name, start s, end s)] of every device activity, on the
    profiler's clock, sorted by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            t0, dt = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            t0, dt = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append((e.name(), t0, t0 + dt))
    out.sort(key=lambda x: x[1])
    return out


def _union(intervals, lo, hi):
    busy, end = 0.0, lo
    for _, a, b in intervals:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def reduce(events, ranges: Ranges, host_end: float):
    """The trace's summary. The window runs from the first marker (the
    start of the first request) to the host's end of the last request,
    moved onto the device clock by the first marker's offset."""
    markers = [e for e in events if MARKER in e[0]]
    kernels = [e for e in events if MARKER not in e[0]]
    if not markers or not kernels or len(markers) != len(ranges.opened):
        return None
    first_host = min(t0 for _, t0, _ in ranges.closed)
    offset = first_host - markers[0][1]
    lo, hi = markers[0][1], host_end - offset
    inside = [e for e in kernels if e[1] < hi and e[2] > lo]
    busy = _union(inside, lo, hi)
    by_cat, by_name = defaultdict(float), defaultdict(float)
    by_range = defaultdict(lambda: defaultdict(float))
    starts = [m[1] for m in markers]
    j = 0
    for name, a, b in inside:
        while j + 1 < len(starts) and starts[j + 1] <= a:
            j += 1
        cat = categories.category(name)
        by_cat[cat] += b - a
        by_name[name] += b - a
        by_range[ranges.opened[j]][cat] += b - a
    gaps, end = [], lo
    for _, a, b in inside:
        if a > end:
            gaps.append((a - end, ranges.innermost(end + offset) or "none"))
        end = max(end, b)
    if hi > end:
        gaps.append((hi - end, ranges.innermost(end + offset) or "none"))
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": hi - lo, "busy_s": busy,
            "by_category": dict(by_cat),
            "by_range": {k: dict(v) for k, v in by_range.items()},
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for s, n in gaps[:10]]}

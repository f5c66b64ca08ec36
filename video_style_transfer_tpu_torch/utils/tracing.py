"""The port's spans and counters: where a request, a denoise step or a
train step spends its host time, on the clock of torch's profiler.

A span is a name, a host start and end, the span that was open when it
opened (its parent) and the request it belongs to (``request()`` opens a
request and gives every span inside it its id). Spans are kept in
memory, in the order they opened, and read at the end: ``self_seconds``
is a span's duration less what its children cover, ``summary`` the
totals by name. A span opened with a CUDA ``device`` also records a
``torch.cuda.Event`` pair on that device's stream; the pairs are read
once, with one synchronise, when the records are read (``read``).

The host stamps are ``time.time_ns()``: CLOCK_REALTIME, the clock
``c10::getTime()`` stamps the profiler's events with. So ``idle_gaps``
can give each idle stretch of a profiler trace's device timeline to the
innermost span that was open when it began; nothing is put on the
device's timeline to line the two up (no ``record_function``, no NVTX
range, no marker kernel).

Recording is on while a ``torch.profiler`` session is active, or between
``enable()`` and ``disable()`` (``recording()`` for a block). Off, a span
costs one flag check: it records nothing, allocates nothing and launches
nothing.

Spans of the port (names as recorded):

- ``request``, ``encode``, ``fold`` (attribute ``projections``);
- ``precompute_kv``, ``step`` with ``unet``, ``guidance`` and
  ``scheduler``; ``decode`` with a ``decode.frame`` a chunk (attribute
  ``frames``); the three with an event pair on CUDA;
- ``unet.embed``, ``unet.down.{i}``, ``unet.mid``, ``unet.up.{i}``;
- ``op.K1.<route>``, ``op.K2.<route>``, ``op.K3.<route>``,
  ``op.K7.<route>``: a call of an op entry, from its first line to its
  launch's return (route ``plain`` off the card); kept flat until read,
  so that recording them keeps no object the garbage collector tracks;
- ``sync.<site>``: a call that waits for the device; ``gc``: one
  collection of the cyclic garbage collector (attribute ``generation``;
  its parent is the innermost span other than an op entry's);
- ``load``, ``train.step`` with ``data``, ``forward_backward`` and
  ``optimizer``; ``checkpoint``, ``validation``, ``export``.

Counters (``count``) sit at the same boundaries: ``moment_cache.hits``
and ``moment_cache.misses``. The kernels' launch counters stay the op
modules' globals; ``launch_counts`` reads them.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

if not hasattr(_profiler, "_is_profiler_enabled"):
    # a torch without the flag: only enable() turns recording on
    _profiler = SimpleNamespace(_is_profiler_enabled=False)

_now = time.time_ns


class Span:
    """One span's record (a context manager while it is open). start and
    end: host ns on time.time_ns; parent: the enclosing Span or None;
    request: the request id or None; device_s: the event pair's seconds
    once read (None without one); attrs: small named values."""

    __slots__ = ("name", "start", "end", "parent", "request", "attrs",
                 "events", "device_s", "_tracer")

    def __init__(self, tracer, name: str, attrs=None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.start = self.end = None
        self.parent = self.request = self.events = self.device_s = None

    def __enter__(self):
        self._tracer._open(self)
        return self

    def __exit__(self, *exc):
        self._tracer._close(self)
        return False

    @property
    def host_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def seconds(self) -> float:
        """Device seconds where the span has an event pair (once read),
        else host seconds."""
        return self.host_s if self.device_s is None else self.device_s


class _Off:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Tracer:
    """The process's record (one, as the profiler session is one)."""

    def __init__(self):
        self.enabled = False
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._stack: List[Span] = []
        self._requests = 0
        self._gc_start = None
        self._gc_hooked = False
        # op-entry calls, flat (name, start, end, id of the parent Span):
        # no object the garbage collector tracks is kept a call, so the
        # ~17.5 k calls of an image request add no collections; they
        # become Spans when read
        self._ops: list = []
        self._op_name = None
        self._op_start = 0
        self._merged = 0

    def hook_gc(self):
        if not self._gc_hooked:
            gc.callbacks.append(self._on_gc)
            self._gc_hooked = True

    def _open(self, s: Span):
        stack = self._stack
        if stack:
            s.parent = stack[-1]
            s.request = s.parent.request
        if s.name == "request":
            self._requests += 1
            s.request = self._requests
        self.spans.append(s)
        stack.append(s)
        s.start = _now()
        if s.events is not None:
            s.events[0].record(s.events[2])

    def _close(self, s: Span):
        if s.events is not None:
            s.events[1].record(s.events[2])
        s.end = _now()
        stack = self._stack
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)

    def _on_gc(self, phase, info):
        if not active():
            self._gc_start = None
            return
        if phase == "start":
            self._gc_start = _now()
            return
        if self._gc_start is None:
            return
        s = Span(self, "gc", {"generation": info.get("generation")})
        s.start, s.end, self._gc_start = self._gc_start, _now(), None
        if self._stack:
            s.parent = self._stack[-1]
            s.request = s.parent.request
        self.spans.append(s)

    def _merge_ops(self):
        """The op-entry calls recorded since the last read, as Spans in
        start order among the spans opened since then."""
        ops = self._ops
        if ops:
            by_id = {id(s): s for s in self.spans}
            new = []
            for k in range(0, len(ops), 4):
                s = Span(self, ops[k])
                s.start, s.end = ops[k + 1], ops[k + 2]
                s.parent = by_id.get(ops[k + 3])
                s.request = None if s.parent is None else s.parent.request
                new.append(s)
            ops.clear()
            tail = self.spans[self._merged:] + new
            tail.sort(key=lambda s: s.start)
            self.spans[self._merged:] = tail
        self._merged = len(self.spans)

    def read(self, clear: bool = False) -> List[Span]:
        """The spans recorded so far, their event pairs read (one
        synchronise if any is pending); with `clear`, forgotten here."""
        self._merge_ops()
        pending = [s for s in self.spans if s.events is not None
                   and s.end is not None]
        if pending:
            torch.cuda.synchronize()
            for s in pending:
                s.device_s = s.events[0].elapsed_time(s.events[1]) * 1e-3
                s.events = None
        out = list(self.spans)
        if clear:
            self.drop(0)
        return out

    def drop(self, start: int):
        """Forget the read spans from position `start` on."""
        del self.spans[start:]
        self._merged = len(self.spans)

    def reset(self):
        """Forget every span and counter (open spans stay open)."""
        self._ops.clear()
        self.drop(0)
        self.counters.clear()


class _OpSpan:
    """The span of an op-entry call (one object, reused: see
    ``Tracer._ops``)."""

    __slots__ = ()

    def __enter__(self):
        TRACER._op_start = _now()

    def __exit__(self, *exc):
        t = TRACER
        end = _now()
        ops = t._ops
        ops.append(t._op_name)
        ops.append(t._op_start)
        ops.append(end)
        ops.append(id(t._stack[-1]) if t._stack else 0)
        t._op_name = None
        return False


_OP = _OpSpan()
_OP_NAMES: Dict[tuple, str] = {}


TRACER = Tracer()


def active() -> bool:
    return TRACER.enabled or _profiler._is_profiler_enabled


def span(name: str, device=None, **attrs):
    """A context manager recording span `name` while tracing is on; with
    a CUDA `device`, also an event pair on its current stream."""
    if not (TRACER.enabled or _profiler._is_profiler_enabled):
        return OFF
    TRACER.hook_gc()
    s = Span(TRACER, name, attrs or None)
    if device is not None and torch.device(device).type == "cuda":
        s.events = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True),
                    torch.cuda.current_stream(device))
    return s


def request():
    """The span of one request: it and every span inside it share a new
    request id."""
    return span("request")


def op_span(kernel: str, route, *args):
    """The span of one call of an op entry, ``op.<kernel>.<route>``;
    `route` is the name, or a function of `args` that gives it (called
    only while tracing is on)."""
    if not (TRACER.enabled or _profiler._is_profiler_enabled):
        return OFF
    key = (kernel, route if isinstance(route, str) else route(*args))
    name = _OP_NAMES.get(key)
    if name is None:
        name = _OP_NAMES[key] = f"op.{key[0]}.{key[1]}"
    if TRACER._op_name is not None:
        # an op entry inside another: a Span of its own
        return span(name)
    TRACER.hook_gc()
    TRACER._op_name = name
    return _OP


def count(name: str, n: int = 1):
    """Add n to counter `name` while tracing is on."""
    if TRACER.enabled or _profiler._is_profiler_enabled:
        TRACER.counters[name] += n


def enable():
    TRACER.enabled = True
    TRACER.hook_gc()


def disable():
    TRACER.enabled = False


class Recording:
    """What ``recording()`` yields: ``take()`` returns the spans recorded
    since the last take, read."""

    def __init__(self, tracer: Tracer, owned: bool):
        self.tracer, self.owned = tracer, owned
        self.start = self.mark = len(tracer.read())

    def take(self) -> List[Span]:
        spans = self.tracer.read()[self.mark:]
        if self.owned and not _profiler._is_profiler_enabled:
            # nothing else reads them: the tracer need not keep them
            self.tracer.drop(self.mark)
        else:
            self.mark += len(spans)
        return spans


@contextmanager
def recording():
    """Record inside the block; yields a Recording. Where nothing else
    recorded when it began, the spans of the block are the block's own:
    a take, and the block's end, drop them from the tracer. The state
    before it is restored."""
    was, owned = TRACER.enabled, not active()
    rec = Recording(TRACER, owned)
    enable()
    try:
        yield rec
    finally:
        TRACER.enabled = was
        if owned:
            TRACER.read()
            TRACER.drop(rec.start)


def read(clear: bool = False) -> List[Span]:
    return TRACER.read(clear)


# ---- what the records say ---------------------------------------------------

def self_seconds(spans: List[Span]) -> Dict[int, float]:
    """{id(span): host seconds less what its children among `spans`
    cover}. A thread's spans nest, so the children's durations add up to
    the part they cover."""
    covered = defaultdict(int)
    for s in spans:
        if s.parent is not None and s.end is not None:
            covered[id(s.parent)] += s.end - s.start
    return {id(s): (s.end - s.start - covered[id(s)]) * 1e-9
            for s in spans if s.end is not None}


def summary(spans: List[Span]) -> Dict[str, dict]:
    """{name: {count, host_s, self_s, device_s}} over closed spans;
    device_s sums the read event pairs (None where the name has none)."""
    selfs = self_seconds(spans)
    out: Dict[str, dict] = {}
    for s in spans:
        if s.end is None:
            continue
        row = out.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "device_s": None})
        row["count"] += 1
        row["host_s"] += s.host_s
        row["self_s"] += selfs[id(s)]
        if s.device_s is not None:
            row["device_s"] = (row["device_s"] or 0.0) + s.device_s
    return out


def named(spans: List[Span], name: str) -> List[Span]:
    return [s for s in spans if s.name == name and s.end is not None]


def now() -> int:
    """A host stamp on the spans' clock (ns)."""
    return _now()


def since(stamp: int) -> float:
    """Host seconds since `stamp` (``now()``)."""
    return (_now() - stamp) * 1e-9


def seconds(spans: List[Span], name: str) -> float:
    """Seconds of the closed spans called `name` (device seconds where
    they carry events, read, else host)."""
    return sum(s.seconds for s in named(spans, name))


def launch_counts() -> dict:
    """Launches of every hand-written kernel in this process so far, by
    kernel name (each op wrapper counts where it launches, nowhere
    else)."""
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu, group_norm
    from video_style_transfer_tpu_torch.ops import layer_norm
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta
    return {"flash_attention_fwd": fa.LAUNCHES,
            "geglu_projection": geglu.LAUNCHES,
            "temporal_attention": ta.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "flash_attention_bwd_delta": fa.DELTA_LAUNCHES,
            "temporal_attention_bwd": ta.BWD_LAUNCHES,
            "layer_norm": layer_norm.LAUNCHES,
            "layer_norm_affine_grad": layer_norm.AFFINE_LAUNCHES,
            "group_norm": group_norm.LAUNCHES,
            "group_norm_silu": group_norm.SILU_LAUNCHES}


# ---- spans beside a profiler trace ------------------------------------------

def device_events(prof):
    """[(name, start s, end s)] of every device activity a finished
    ``torch.profiler`` session recorded (kernels, copies, fills), on the
    profiler's clock, sorted by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        t0 = e.start_ns() * 1e-9
        out.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
    out.sort(key=lambda x: x[1])
    return out


def idle_gaps(events, spans: List[Span], lo: Optional[float] = None,
              hi: Optional[float] = None):
    """The stretches of [lo, hi] (seconds on the profiler's clock;
    default: the first event's start to the last one's end) in which no
    device event ran, each as (start s, seconds, name of the innermost
    span open when it began, or None). events: (name, start s, end s)."""
    events = sorted(events, key=lambda e: e[1])
    if lo is None:
        lo = events[0][1] if events else 0.0
    if hi is None:
        hi = max((e[2] for e in events), default=lo)
    starts, end = [], lo
    for _, a, b in events:
        if b <= lo or a >= hi:
            continue
        if a > end:
            starts.append((end, min(a, hi) - end))
        end = max(end, b)
    if hi > end:
        starts.append((end, hi - end))
    # sweep the spans' opens and closes in time order beside the gaps
    marks = []
    for s in spans:
        if s.start is None:
            continue
        marks.append((s.start * 1e-9, 1, id(s), s))
        if s.end is not None:
            marks.append((s.end * 1e-9, 0, id(s), s))
    marks.sort(key=lambda m: (m[0], m[1]))
    out, stack, j = [], [], 0
    for t, length in starts:
        while j < len(marks) and marks[j][0] <= t:
            _, opening, _, s = marks[j]
            if opening:
                stack.append(s)
            elif stack and stack[-1] is s:
                stack.pop()
            elif s in stack:
                stack.remove(s)
            j += 1
        out.append((t, length, stack[-1].name if stack else None))
    return out


def gap_totals(gaps) -> Dict[Optional[str], float]:
    """{owning span name: idle seconds}, largest first."""
    tot = defaultdict(float)
    for _, length, name in gaps:
        tot[name] += length
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def chrome_events(spans: List[Span], base_ns: int = 0, pid="program spans"):
    """The spans as Chrome-trace complete events ("X", microseconds from
    base_ns) on a track of their own."""
    out = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": pid}}]
    for s in spans:
        if s.end is None:
            continue
        args = {"request": s.request, "parent": getattr(s.parent, "name",
                                                         None)}
        if s.device_s is not None:
            args["device_ms"] = s.device_s * 1e3
        if s.attrs:
            args.update(s.attrs)
        out.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                    "tid": 0, "ts": (s.start - base_ns) / 1e3,
                    "dur": (s.end - s.start) / 1e3, "args": args})
    return out

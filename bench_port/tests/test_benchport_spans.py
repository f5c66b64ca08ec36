"""The ``program_span`` metrics read from the program's own spans: None
where nothing was recorded (an untraced run, or a program without the
tracing module), numbers for the host metrics after a tiny CPU request
with tracing on. The device metrics need the spans' CUDA events, so they
stay None on the CPU."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from video_style_transfer_tpu_torch.utils import tracing

HOST = ("step_host_ms.video", "step_host_ms.image", "entry_host_us.image",
        "gc_ms.image")
DEVICE = ("step_ms.video", "step_ms.image", "decode_frame_ms.video")


@pytest.fixture
def clean_tracer():
    tracing.disable()
    tracing.TRACER.reset()
    yield tracing.TRACER
    tracing.disable()
    tracing.TRACER.reset()


def _run(n_requests=1):
    return SimpleNamespace(request_s=[1.0] * n_requests, trace=None)


@pytest.mark.parametrize("metric", HOST + DEVICE)
def test_nothing_recorded_reads_none(tiny_registry, clean_tracer, metric):
    assert tiny_registry.reader(metric)(_run()) is None


@pytest.mark.parametrize("metric", HOST + DEVICE)
def test_a_program_without_tracing_reads_none(tiny_registry, monkeypatch,
                                              metric):
    monkeypatch.setitem(sys.modules,
                        "video_style_transfer_tpu_torch.utils.tracing", None)
    assert tiny_registry.reader(metric)(_run()) is None


@pytest.mark.parametrize("cell", ["tiny_video", "tiny_image"])
def test_a_traced_request_gives_the_host_metrics(tiny_registry, clean_tracer,
                                                 cell):
    entry = tiny_registry.cell(cell)
    drv = tiny_registry.driver("serve").Driver(
        tiny_registry.config(entry["config"]),
        tiny_registry.traffic(entry["traffic"]),
        tiny_registry.cell_spec(cell), 2 ** 31 + 7, "cpu", False)
    drv.setup()
    assert not tracing.TRACER.spans        # set-up records nothing
    tracing.enable()
    drv.request(0)
    tracing.disable()
    run = _run()
    steps = drv.traffic["steps"]
    assert len(tracing.named(tracing.read(), "step")) == steps
    for metric in HOST:
        value = tiny_registry.reader(metric)(run)
        # a request may hold no collection; the op entries here are K2
        # and K7 on their plain versions
        assert value >= 0 if metric.startswith("gc_ms") else value > 0
    for metric in DEVICE:
        assert tiny_registry.reader(metric)(run) is None

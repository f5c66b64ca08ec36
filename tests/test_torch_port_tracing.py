"""The port's spans and counters (``utils/tracing.py``): nesting, parents,
request ids and self time; nothing recorded or allocated while off; the
profiler session turning recording on; garbage-collector spans; the
launch counters read through tracing; idle gaps given to the innermost
open span; the exporter; and every span name of the tiny CPU pipelines,
CLIs and trainers."""
from __future__ import annotations

import gc
import json
import os
import time
import tracemalloc

import pytest
import torch

from video_style_transfer_tpu_torch.cli import common
from video_style_transfer_tpu_torch.utils import tracing
from video_style_transfer_tpu_torch.utils.tracing import Span


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.TRACER.reset()
    yield
    tracing.disable()
    tracing.TRACER.reset()


def _names(spans):
    return {s.name for s in spans}


def test_spans_nest_with_parents_requests_and_self_time():
    with tracing.recording() as rec:
        with tracing.span("outside"):
            pass
        with tracing.request() as req:
            with tracing.span("a") as a:
                time.sleep(0.002)
                with tracing.span("b", rows=3) as b:
                    time.sleep(0.004)
        with tracing.request() as req2:
            pass
        spans = rec.take()
    assert [s.name for s in spans] == ["outside", "request", "a", "b",
                                       "request"]
    assert spans[0].parent is None and spans[0].request is None
    assert a.parent is req and b.parent is a and b.attrs == {"rows": 3}
    assert req.request == a.request == b.request != req2.request
    selfs = tracing.self_seconds(spans)
    assert selfs[id(a)] == pytest.approx(a.host_s - b.host_s)
    assert selfs[id(b)] == pytest.approx(b.host_s) and b.host_s >= 0.004
    assert selfs[id(req)] == pytest.approx(req.host_s - a.host_s)
    row = tracing.summary(spans)["request"]
    assert row["count"] == 2 and row["device_s"] is None
    # the spans were the block's own: nothing is left in the tracer
    assert not tracing.TRACER.spans


def test_off_records_and_allocates_nothing():
    from video_style_transfer_tpu_torch.ops import layer_norm

    x, w, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    layer_norm.layer_norm(x, w, b)

    def calls():
        for _ in range(2000):
            with tracing.span("step", device="cpu"):
                pass
            with tracing.op_span("K1", lambda: "never called"):
                pass
            tracing.count("moment_cache.hits")

    calls()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if d.traceback[0].filename == tracing.__file__)
    assert grown == 0
    assert tracing.span("x") is tracing.OFF
    assert not tracing.TRACER.spans and not tracing.TRACER.counters


def test_the_profiler_session_turns_recording_on():
    assert not tracing.active()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.active()
        with tracing.span("inside"):
            torch.ones(4).sum()
        tracing.count("moment_cache.misses", 2)
    assert not tracing.active()
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.read()] == ["inside"]
    assert tracing.TRACER.counters == {"moment_cache.misses": 2}


def test_a_forced_collection_is_a_gc_span():
    with tracing.recording() as rec:
        with tracing.span("outer") as outer:
            gc.collect(1)
        spans = rec.take()
    collected = tracing.named(spans, "gc")
    assert collected and collected[0].parent is outer
    assert collected[0].attrs == {"generation": 1}
    assert outer.start <= collected[0].start <= collected[0].end \
        <= outer.end
    gc.collect(0)                       # off: no span
    assert not tracing.named(tracing.read(), "gc")


def test_kernel_launch_counts_read_the_op_counters(monkeypatch):
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import layer_norm

    before = common.kernel_launch_counts()
    assert before == tracing.launch_counts()
    monkeypatch.setattr(fa, "LAUNCHES", fa.LAUNCHES + 3)
    monkeypatch.setattr(layer_norm, "AFFINE_LAUNCHES",
                        layer_norm.AFFINE_LAUNCHES + 1)
    got = common.launches_since(before)
    assert got["flash_attention_fwd"] == 3
    assert got["layer_norm_affine_grad"] == 1
    assert sum(got.values()) == 4


def _span(name, t0, t1, parent=None):
    s = Span(tracing.TRACER, name)
    s.start, s.end, s.parent = int(t0 * 1e9), int(t1 * 1e9), parent
    return s


def test_idle_gaps_go_to_the_innermost_open_span():
    req = _span("request", 10.0, 20.0)
    step = _span("step", 11.0, 15.0, req)
    op = _span("op.K1.wgmma", 12.0, 12.5, step)
    sync = _span("sync.check_finite", 16.0, 16.2, req)
    spans = [req, step, op, sync]
    events = [("k0", 10.5, 11.5), ("k1", 12.2, 12.8), ("k2", 12.6, 14.0),
              ("k3", 16.1, 17.0), ("k4", 18.0, 21.0)]
    gaps = tracing.idle_gaps(events, spans, lo=10.0, hi=22.0)
    got = [(round(t, 6), round(n, 6), name) for t, n, name in gaps]
    assert got == [(10.0, 0.5, "request"),        # before the first kernel
                   (11.5, 0.7, "step"),
                   (14.0, 2.1, "step"),            # opens in the step
                   (17.0, 1.0, "request"),
                   (21.0, 1.0, None)]              # after every span
    assert tracing.gap_totals(gaps)["step"] == pytest.approx(2.8)
    # the default window is the events' own
    assert [g[2] for g in tracing.idle_gaps(events, spans)][0] == "step"


def test_the_exporter_writes_spans_and_idle_gaps(tmp_path):
    from video_style_transfer_tpu_torch.utils import observability

    observability.start_profiler_trace(str(tmp_path))
    with tracing.request():
        with tracing.span("encode"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = observability.stop_profiler_trace()
    with open(path) as f:
        trace = json.load(f)
    mine = [e for e in trace["traceEvents"]
            if e.get("pid") == "program spans" and e["ph"] == "X"]
    assert {e["name"] for e in mine} == {"request", "encode"}
    base = trace.get("baseTimeNanoseconds", 0)
    enc = next(e for e in mine if e["name"] == "encode")
    assert enc["args"]["parent"] == "request"
    mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    # one time base: the profiler's op lies inside the program's span
    assert enc["ts"] <= mm[0]["ts"] <= enc["ts"] + enc["dur"]
    assert enc["ts"] == pytest.approx(
        (tracing.named(tracing.read(), "encode")[0].start - base) / 1e3)
    with open(os.path.join(tmp_path, "idle_gaps.json")) as f:
        gaps = json.load(f)
    assert gaps["window_s"] > 0 and gaps["device_events"] == 0


SERVING = {"request", "encode", "fold", "precompute_kv", "step", "unet",
           "guidance", "scheduler", "decode", "decode.frame", "unet.embed",
           "unet.down.0", "unet.down.1", "unet.mid", "unet.up.0",
           "unet.up.1", "op.K2.plain", "op.K7.plain", "sync.check_finite",
           "sync.latents", "sync.frames", "load"}


@pytest.mark.parametrize("cli", ["infer_video", "infer"])
def test_the_tiny_clis_record_every_serving_span(cli):
    from video_style_transfer_tpu_torch.cli import infer, infer_video

    mod = infer_video if cli == "infer_video" else infer
    argv = ["--smoke", "--device", "cpu", "--prompt", "a horse"]
    argv += ["--modes", "both"] if cli == "infer_video" else ["--seeds", "0"]
    report = {}
    with tracing.recording() as rec:
        mod.generate(mod.build_parser().parse_args(argv), report)
        spans = rec.take()
    assert SERVING <= _names(spans)
    steps = tracing.named(spans, "step")
    assert len(steps) == 2
    assert all(s.parent.name == "request" for s in steps)
    rep = report["both"] if cli == "infer_video" else \
        report["images"]["both_seed0"]
    fold = tracing.named(spans, "fold")[0]
    assert fold.attrs["projections"] == report.get(
        "n_folded", rep.get("n_folded")) > 0
    assert rep["denoise_step_s"] == [s.host_s for s in steps]
    assert rep["decode_s"] == pytest.approx(
        tracing.seconds(spans, "decode")) and rep["decode_s"] > 0
    assert rep["precompute_kv_s"] > 0


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_qkv",
                                   "temporal_attention"])
def test_the_attention_entries_record_their_span(entry):
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta

    q = torch.randn(1, 8, 2, 64)
    with tracing.recording() as rec:
        if entry == "flash_attention":
            fa.flash_attention(q, q, q)
        elif entry == "flash_attention_qkv":
            fa.flash_attention_qkv(torch.randn(1, 8, 3 * 128), 2)
        else:
            ta.temporal_attention(q, q, q)
        spans = rec.take()
    want = "op.K3.plain" if entry == "temporal_attention" else "op.K1.plain"
    assert [s.name for s in spans] == [want]


def test_the_stage2_trainer_records_its_spans(tmp_path):
    from video_style_transfer_tpu_torch.cli import train_animatediff

    report = {}
    args = train_animatediff.build_parser().parse_args([
        "--smoke", "--device", "cpu", "--prompt", "a horse",
        "--max_train_steps", "2", "--lr_warmup_steps", "0",
        "--output_dir", str(tmp_path)])
    with tracing.recording() as rec:
        train_animatediff.train(args, report)
        spans = rec.take()
    assert {"train.step", "data", "forward_backward", "optimizer",
            "sync.metrics", "load", "export"} <= _names(spans)
    steps = tracing.named(spans, "train.step")
    assert len(steps) == len(report["step_s"]) == len(report["loss"]) == 2
    assert all(s.parent.name == "train.step"
               for s in tracing.named(spans, "optimizer"))
    assert report["step_s"][0] + report["encode_s"][0] == pytest.approx(
        steps[0].host_s)
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert {"loss", "sec_per_step", "data_s", "optimizer_s"} <= set(lines[0])
    assert lines[-1]["optimizer_s"] > 0


def test_the_moment_cache_counts_hits_and_misses():
    from video_style_transfer_tpu_torch.config import VAEConfig
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.vae import init_vae_encoder

    cfg = VAEConfig.tiny()
    bundle = common.ModelBundle(
        unet=None, unet_cfg=None, vae=None, vae_cfg=cfg, clip_l=None,
        clip_l_cfg=None, clip_g=None, clip_g_cfg=None,
        device=torch.device("cpu"),
        vae_scale_factor=2 ** (len(cfg.block_out_channels) - 1),
        vae_encoder=init_vae_encoder(Init(0, "cpu"), cfg))
    cache = common.LatentMomentCache(bundle)
    frames = torch.rand(3, 16, 16, 3) * 2 - 1
    with tracing.recording() as rec:
        cache.moments(frames, [0, 1, 2])
        cache.moments(frames, [1, 2, 3])
        spans = rec.take()
    assert rec.tracer.counters == {"moment_cache.misses": 4,
                                   "moment_cache.hits": 2}
    assert len(tracing.named(spans, "sync.moment_cache")) == 4

"""The yardstick: per-call work against PERF.md's bound column, the idle
share of a synthetic trace, the model-flop count against a hand count,
and the whole-name import check."""
from __future__ import annotations

import pytest
import torch

from bench_port.lib import flops, guard, trace, work
from bench_port.tests.tiny import TINY


def _t(shape, dtype):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("ms, least", [
    # K1 serving L2 (32, 1024, 20x64) bf16: bound 0.174 ms
    (0.174, lambda: work.flash_attention(
        *(_t((32, 1024, 20, 64), torch.bfloat16) for _ in range(3)))),
    # K2 spatial L2 (32768, 1280 -> 5120) bf16: bound 0.869 ms
    (0.869, lambda: work.geglu_projection(
        _t((32768, 1280), torch.bfloat16), _t((10240, 1280), torch.bfloat16),
        _t((10240,), torch.bfloat16))),
    # K3 serving L0 (16, 32768, 8x40) bf16: bound 0.401 ms
    (0.401, lambda: work.temporal_attention(
        *(_t((16, 32768, 8, 40), torch.bfloat16) for _ in range(3)))),
    # K2 spatial L2 fp32 at 3xTF32: 5.209 ms (12.821 at 67 TFLOP/s)
    (5.209, lambda: work.geglu_projection(
        _t((32768, 1280), torch.float32), _t((10240, 1280), torch.float32),
        _t((10240,), torch.float32))),
])
def test_least_time_matches_the_bound_column(ms, least):
    assert least() * 1e3 == pytest.approx(ms, rel=2e-3)


def test_fp32_is_counted_at_the_3xtf32_rate():
    assert work.flop_rate(torch.float32) == pytest.approx(494.7e12 / 3)
    assert work.flop_rate(torch.bfloat16) == 989e12


def test_fused_qkv_counts_as_three_inputs():
    qkv = _t((2, 4096, 3 * 640), torch.bfloat16)
    split = [_t((2, 4096, 10, 64), torch.bfloat16)] * 3
    assert work.flash_attention_qkv(qkv, 10) == pytest.approx(
        work.flash_attention(*split))


def _summary(kernels, ranges):
    events = sorted(kernels + [("spin_kernel", t, t + 1e-6)
                               for t in ranges["markers"]],
                    key=lambda e: e[1])
    rg = trace.Ranges(markers=False)
    rg.opened = ranges["opened"]
    rg.closed = ranges["closed"]
    return trace.reduce(events, rg, ranges["host_end"])


def test_idle_counts_the_gap_before_the_first_kernel():
    # device clock = host clock - 100: the request opens at host 100.0,
    # its marker runs at device 0.0, the first kernel at 0.3
    s = _summary(
        [("gemm_a", 0.3, 0.5), ("elementwise_x", 0.5, 0.6),
         ("gemm_b", 0.8, 1.0)],
        {"markers": [0.0], "opened": ["request"],
         "closed": [("request", 100.0, 101.0), ("encode", 100.0, 100.3),
                    ("step", 100.6, 101.0)],
         "host_end": 101.0})
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.5)
    names = [n for n, _ in s["idle_gaps"]]
    assert names[0] == "encode" and "step" in names
    assert s["by_category"]["gemm"] == pytest.approx(0.4)


def test_model_flops_equal_a_hand_count():
    total = 0
    for name in ("clip_l", "clip_g"):
        c = TINY[name]
        s, d, i = c["max_position_embeddings"], c["hidden_size"], \
            c["intermediate_size"]
        layer = 4 * 2 * s * d * d + 2 * 2 * s * d * i + 2 * 2 * s * s * d
        total += c["num_layers"] * layer
        if c["projection_dim"]:
            total += 2 * d * c["projection_dim"]
    assert flops.prompt_encode(TINY) == total


def test_unet_flops_scale_with_rows():
    one = flops.unet_call(TINY, 1, 1, 4, 4)
    assert one > 0 and flops.unet_call(TINY, 2, 1, 4, 4) == 2 * one


@pytest.mark.parametrize("names, bad", [
    (["torch", "video_style_transfer_tpu_torch",
      "video_style_transfer_tpu_torch.ops.layer_norm"], []),
    (["video_style_transfer_tpu.models.unet"], ["video_style_transfer_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_names(names, bad):
    assert guard.forbidden_modules(names) == bad

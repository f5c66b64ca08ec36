"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here is marked ``cuda`` and skips without a GPU. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest sets up JAX's CPU backend.)
Inputs have unit variance; the tolerances are `_assert_close`'s.
"""
import pytest
import torch

from video_style_transfer_tpu_torch.ops import flash_attention as tfa
from video_style_transfer_tpu_torch.ops import geglu as tgeglu
from video_style_transfer_tpu_torch.ops import temporal_attention as tta


def _assert_close(out, ref):
    """|out - ref| <= atol + rtol*|ref|: bf16 atol 2e-2 plus 2^-6
    relative (the kernel rounds once, the plain version at up to four
    points, each half a bf16 ulp = 2^-8 relative); fp32 atol 1e-5 (only
    the order of the f32 sums differs)."""
    atol, rtol = (2e-2, 2 ** -6) if out.dtype == torch.bfloat16 else (1e-5,
                                                                       0.0)
    excess = (out.float() - ref.float()).abs() - rtol * ref.float().abs()
    assert excess.max().item() <= atol


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 192),
                                     (torch.float32, 512)])
def test_cuda_flash_matches_plain(dtype, d):
    # bf16 d <= 128 takes the register-resident kernel, the rest the
    # shared-memory one; S = 1100 leaves a masked kv tail in both
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 1100, 3 * 2 * d, device="cuda", generator=g,
                      dtype=dtype)
    q, k, v = (t.unflatten(-1, (2, d)) for t in qkv.split(2 * d, -1))
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    _assert_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_geglu_matches_plain(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1000, 320, device="cuda", generator=g, dtype=dtype)
    w = torch.randn(2 * 1280, 320, device="cuda", generator=g,
                    dtype=dtype) * 0.05
    b = torch.randn(2 * 1280, device="cuda", generator=g, dtype=dtype) * 0.1
    gate = tgeglu._default_gate_for(dtype)
    out = tgeglu.geglu_projection(x, w, b)
    ref = tgeglu.geglu_plain(x, w, b, gate)
    _assert_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 40),
                                     (torch.float32, 160)])
def test_cuda_temporal_attention_matches_plain(dtype, d):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(16, 300, 3 * 8 * d, device="cuda", generator=g,
                      dtype=dtype)
    out = tta.temporal_attention_qkv(qkv, 8)
    q, k, v = (t.unflatten(-1, (8, d)) for t in qkv.split(8 * d, -1))
    ref = tta.temporal_attention_plain(q, k, v, d ** -0.5)
    _assert_close(out, ref)

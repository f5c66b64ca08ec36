"""K1's three routes and K4's four: which kernel each (dtype, head_dim)
takes on the card, how the FMA route and the wide wgmma kernel split
their kv walk, how the wide kernel splits O's columns and how the FMA
template tiles each head dim, and K1's plain
version (what a CPU tensor runs, and what the card's kernels are held
against) against the JAX package's Pallas routes at ragged lengths,
`out` and `lse` both.

The JAX functions run in interpret mode on the CPU, as the other port
tests run them; f32 at 2e-5 (both sides compute exact f32 softmax math,
only the order of the sums differs).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.ops import flash_attention as jfa
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.fixture
def no_library(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("CPU call reached the CUDA kernel library")
    monkeypatch.setattr(cuda_build, "library", refuse)


@pytest.mark.parametrize("dtype,d,want", [
    *((torch.bfloat16, d, "wgmma") for d in (64, 128, 192, 256)),
    *((torch.bfloat16, d, "wgmma") for d in (320, 384, 448, 512)),
    (torch.float32, 64, "tf32x3"),
    *((torch.float32, d, "fma") for d in tfa.HEAD_DIMS if d not in (64,
                                                                  512)),
    (torch.float32, 512, "fma"),
])
def test_route_names_the_kernel(dtype, d, want):
    assert tfa.route(dtype, d) == want


@pytest.mark.parametrize("dtype,d,exc", [(torch.float16, 64, TypeError),
                                         (torch.bfloat16, 96, ValueError),
                                         (torch.float32, 576, ValueError)])
def test_route_refuses_what_k1_does_not_take(dtype, d, exc):
    with pytest.raises(exc):
        tfa.route(dtype, d)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.float32, 64, "tf32x3"),
    (torch.bfloat16, 128, "wgmma_sliced"),
    (torch.bfloat16, 192, "wgmma_sliced"),
    (torch.float32, 128, "tf32x3_sliced"), (torch.float16, 64, TypeError),
    (torch.bfloat16, 96, ValueError), (torch.float32, 576, ValueError),
    *((torch.bfloat16, d, "wgmma_sliced") for d in (256, 320, 384, 448,
                                                    512)),
    *((torch.float32, d, "tf32x3_sliced") for d in (192, 256, 320, 384,
                                                    448, 512))])
def test_bwd_route_names_the_kernels(dtype, d, want):
    # K4 takes every head dim K1 takes: d = 64 on its own kernels (bf16
    # wgmma + TMA, fp32 3xTF32), d = 128-512 on the D-sliced ones (bf16
    # wgmma + TMA, fp32 3xTF32); anything else raises before a launch
    if isinstance(want, str):
        assert tfa.bwd_route(dtype, d) == want
    else:
        with pytest.raises(want):
            tfa.bwd_route(dtype, d)


@pytest.mark.parametrize("d,sq,sk", [(64, 200, 200), (64, 136, 264),
                                     (192, 200, 200), (192, 136, 264),
                                     (320, 200, 200), (320, 136, 264),
                                     (448, 200, 200), (448, 136, 264),
                                     (512, 200, 200), (512, 136, 264)])
def test_plain_matches_jax_route_out_and_lse(no_library, d, sq, sk):
    # d = 64 packs two heads per 128 lanes (`_flash_fwd_bs_hd`, K1's TPU
    # kernels); d = 192 cannot pack (`_flash_fwd_bhsd`, `_attn_kernel`,
    # K6), nor can d = 320 and 448, the wide wgmma kernel's head dims that
    # only the BHSD route reaches; d = 512 is the VAE's one head a block
    # (`_flash_fwd_bs_hd`, `_attn_kernel_packed`, the FMA route's and the
    # wide kernel's TPU kernel). d >= 320 at the VAE's one head and batch
    # one, as the bf16 decode calls it. block_k = 128 leaves a masked kv
    # tail in the last kv block, so all take their online-softmax kernels.
    b, h = (1, 1) if d >= 320 else (2, 4)
    scale = d ** -0.5
    q = _rand(50 + d, (b, sq, h, d))
    k, v = (_rand(51 + d + i, (b, sk, h, d)) for i in range(2))
    if jfa._packable(h, d):
        out, lse = jfa._flash_fwd_bs_hd(
            *(jnp.asarray(a.reshape(a.shape[0], a.shape[1], h * d))
              for a in (q, k, v)),
            num_heads=h, scale=scale, block_q=sq, block_k=128)
        want_out = np.asarray(out).reshape(b, sq, h * d)
    else:
        def bhsd(a):
            return jnp.asarray(a.transpose(0, 2, 1, 3)
                               .reshape(b * h, a.shape[1], d))
        out, lse = jfa._flash_fwd_bhsd(bhsd(q), bhsd(k), bhsd(v),
                                       scale=scale, block_q=sq, block_k=128)
        want_out = np.asarray(out).reshape(b, h, sq, d) \
            .transpose(0, 2, 1, 3).reshape(b, sq, h * d)
    want_lse = np.asarray(lse).reshape(b, h, sq)
    got, got_lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (b, sq, h * d) and got_lse.shape == (b, h, sq)
    np.testing.assert_allclose(got.numpy(), want_out, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=TOL, rtol=0)


@pytest.mark.parametrize("blocks,kv_tiles,sms,want", [
    (256, 64, 132, 1),    # (1,16384,1x512): 256 blocks fill two waves
    (64, 16, 132, 2),     # (1,4096,1x512): 64 -> 128 blocks in one wave
    (16, 5, 132, 5),      # at most one split a kv tile
    (1, 1, 132, 1),
    (150, 64, 132, 7),    # 1050 blocks fill 8 waves of 132 to 99 %
])
def test_fma_kv_splits_fill_the_card(blocks, kv_tiles, sms, want):
    got = tfa.kv_splits(blocks, kv_tiles, sms)
    assert got == want
    per = -(-kv_tiles // got)
    assert (got - 1) * per < kv_tiles  # every split owns a kv tile


@pytest.mark.parametrize("d,want", [(320, (192, 128)), (384, (192, 192)),
                                    (448, (256, 192)), (512, (256, 256))])
def test_wide_o_split_by_head_dim(d, want):
    # the wide kernel's two consumer warpgroups own O's columns [0, D0)
    # and [D0, D): each part starts on a 64-wide V panel and is at most
    # 256 wide (one wgmma, 128 f32 registers a thread)
    got = tfa.wide_o_split(d)
    assert got == want and sum(got) == d
    assert all(part % 64 == 0 and 64 <= part <= 256 for part in got)
    assert max(got) // 2 <= 128  # O floats a thread of the warpgroup


@pytest.mark.parametrize("d", [64, 256, 576])
def test_wide_o_split_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        tfa.wide_o_split(d)


@pytest.mark.parametrize("d,want", [
    (128, (32, 128, 4, 4)), (192, (16, 192, 2, 6)), (256, (16, 256, 4, 8)),
    (320, (8, 160, 2, 10)), (384, (8, 192, 4, 12)), (448, (8, 224, 2, 14)),
    (512, (8, 256, 4, 16))])
def test_fma_tiles_by_head_dim(d, want):
    # the FMA template's per-d choices (csrc/flash_attention_f32.cu's
    # FmaCfg): V chunks of as many rows (a power of two) as fit a K
    # chunk's 256 x 16 floats, V boxes of at most 256 columns holding
    # whole column quarters, float4 loads of O's columns where each
    # quarter splits into 8 lanes' float4s, else float2
    got = tfa.fma_tiles(d)
    assert (got["v_rows"], got["v_box"], got["vector"], got["o_cols"]) \
        == want
    stage = tfa.FMA_BLOCK_K * 16
    assert got["v_rows"] * d <= stage < 2 * got["v_rows"] * d or \
        got["v_rows"] == 32
    assert tfa.FMA_BLOCK_K % got["v_rows"] == 0
    assert got["v_box"] <= 256 and got["v_box"] % (d // 4) == 0
    # a thread's O columns: 8 lanes of a quarter share d / 4 columns in
    # whole vectors
    assert 8 * got["o_cols"] == d // 4 and got["o_cols"] % got["vector"] == 0


@pytest.mark.parametrize("d", [64, 96, 576])
def test_fma_tiles_refuse_other_head_dims(d):
    with pytest.raises(ValueError):
        tfa.fma_tiles(d)


@pytest.mark.parametrize("shape,want", [
    ((1, 16384, 1, 512), 1),   # 256 q blocks fill 1.94 waves of 132
    ((1, 4096, 1, 512), 2),    # 64 q blocks -> 128
    ((1, 1000, 1, 320), 8),    # 16 q blocks over 16 kv tiles -> 128
    ((8, 1000, 1, 512), 1),    # 128 q blocks
    ((1, 4096, 1, 64), 1),     # d = 64: the d <= 256 kernel never splits
])
def test_wide_kv_splits_by_shape(monkeypatch, shape, want):
    # the split count K1's wrapper packs for a bf16 call, from the wide
    # kernel's 64-row q blocks and 64-key kv tiles on a 132-SM card
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(tfa, "_check_layout", lambda q, k, v: None)
    monkeypatch.setattr(tfa, "_ACCEPTED", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    kernel, splits, _, wide = tfa._check(q, q, q)
    assert kernel == "wgmma" and splits == want
    assert wide == (shape[-1] in tfa.WIDE_HEAD_DIMS)


def test_check_caches_accepted_layouts_only(monkeypatch):
    # K1's wrapper checks a (q, k, v) layout once: a layout the full check
    # accepted is found again by (dtype, device, shape, stride, pointer
    # alignment), with its route and its call's packed layout; any of
    # those changed, or a layout it refused, goes through the full check
    # again
    seen = []

    def full_check(q, k, v):
        seen.append((q.shape, q.stride(), q.data_ptr() % 16))
        if q.shape[-1] == 96:
            raise ValueError("refused")

    monkeypatch.setattr(tfa, "_check_layout", full_check)
    monkeypatch.setattr(tfa, "_ACCEPTED", {})
    qkv = torch.zeros(2, 16, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(256, -1))
    first = tfa._check(q, k, v)
    assert first[:2] == ("wgmma", 1)
    assert tfa._check(q, k, v) is first
    tfa._check(*(t.clone() for t in (q, k, v)))   # other strides
    tfa._check(q[:, 1:], k[:, 1:], v[:, 1:])      # other shape, offset
    assert tfa._check(q.float(), k.float(), v.float())[0] == "tf32x3"
    assert len(seen) == 4
    bad = torch.zeros(2, 16, 4, 96, dtype=torch.bfloat16)
    for _ in range(2):
        with pytest.raises(ValueError):
            tfa._check(bad, bad, bad)
    assert len(seen) == 6

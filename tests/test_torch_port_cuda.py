"""The port's CUDA kernels (K1 on its three routes, the wgmma route's
wide kernel at d >= 320 and the FMA template at every fp32 head dim but
64 included, K2 on both its routes, K3's tensor-core forward at every
frame count, K4 on its four routes (d = 64 and the D-sliced kernels at
d = 128-512), K5, K7, the GroupNorm(+SiLU) kernels)
against their plain PyTorch versions on the card, and gradients through
their autograd wrappers against the CPU.
Every test here is marked ``cuda`` and skips without a GPU. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest sets up JAX's CPU backend.)
Inputs have unit variance; the tolerances are `_assert_close`'s.
"""
import pytest
import torch

from video_style_transfer_tpu_torch.ops import flash_attention as tfa
from video_style_transfer_tpu_torch.ops import geglu as tgeglu
from video_style_transfer_tpu_torch.ops import group_norm as tgn
from video_style_transfer_tpu_torch.ops import layer_norm as tln
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
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 320),
                                     (torch.bfloat16, 384),
                                     (torch.bfloat16, 448),
                                     (torch.bfloat16, 512),
                                     (torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.float32, 192),
                                     (torch.float32, 256),
                                     (torch.float32, 320),
                                     (torch.float32, 384),
                                     (torch.float32, 448),
                                     (torch.float32, 512)])
def test_cuda_flash_matches_plain(dtype, d):
    # bf16 d <= 256 takes the wgmma + TMA kernel, bf16 d >= 320 (the VAE
    # under --vae_dtype bfloat16) the wide wgmma + TMA one, fp32 d = 64 the
    # 3xTF32 one, every other fp32 d the FMA template (`route`); q, k and
    # v are strided views of one fused projection and S = 1100 leaves
    # masked q and kv tails in all
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 1100, 3 * 2 * d, device="cuda", generator=g,
                      dtype=dtype)
    q, k, v = (t.unflatten(-1, (2, d)) for t in qkv.split(2 * d, -1))
    before = tfa.LAUNCHES
    out, lse = tfa.flash_attention_fwd(q, k, v)
    assert tfa.LAUNCHES == before + 1
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    _assert_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_cuda_flash_wgmma_ragged_cross_lengths(d):
    # the wgmma route's two kernels (d >= 320: the wide one, at each of
    # its column splits of O) at seq_q != seq_k, neither a multiple of a
    # tile: q a contiguous tensor, k and v strided views of one fused kv
    # projection (B, Sk, 2*H*D)
    _need_cuda()
    assert tfa.route(torch.bfloat16, d) == "wgmma"
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 1000, 3, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    kv = torch.randn(2, 1037, 2 * 3 * d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    k, v = (t.unflatten(-1, (3, d)) for t in kv.split(3 * d, -1))
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    assert out.shape == (2, 1000, 3 * d) and lse.shape == (2, 3, 1000)
    _assert_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def _wgmma_case(b, sq, sk, h, d, seed):
    """q a strided view of a fused (B, Sq, 3*H*D) projection (its k and
    v parts unused), k and v of a fused (B, Sk, 2*H*D) one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, 3 * h * d, device="cuda", generator=g,
                    dtype=torch.bfloat16)[..., :h * d].unflatten(-1, (h, d))
    kv = torch.randn(b, sk, 2 * h * d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    k, v = (t.unflatten(-1, (h, d)) for t in kv.split(h * d, -1))
    return q, k, v


def _assert_flash_close(q, k, v):
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, q.shape[-1] ** -0.5)
    b, sq, h, d = q.shape
    assert out.shape == (b, sq, h * d) and lse.shape == (b, h, sq)
    _assert_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one tile", "fewer tiles than SMs",
                                  "not a multiple of the SMs"])
def test_cuda_flash_wgmma_persistent_tiles(case):
    # the d = 64 kernel walks (q block, head, batch) tiles of 192 query
    # rows (csrc/flash_attention_sm90.cu: D64Cfg::BR) at a stride of its
    # grid (one block per SM, fewer where there are fewer tiles): a grid
    # of one block, a grid narrower than the card, and a tile count the
    # grid does not divide (blocks walk one or two tiles); ragged q and kv
    # tails in each
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, sq, sk, h = {"one tile": (1, 100, 77, 1),
                    "fewer tiles than SMs": (2, 1000, 1037, 3),
                    "not a multiple of the SMs": (5, 1000, 1000, 7)}[case]
    tiles = b * h * -(-sq // 192)
    assert {"one tile": tiles == 1,
            "fewer tiles than SMs": 1 < tiles < sms,
            "not a multiple of the SMs": tiles > sms and tiles % sms}[case]
    before = tfa.ROUTE_LAUNCHES["wgmma"]
    _assert_flash_close(*_wgmma_case(b, sq, sk, h, 64, seed=5))
    assert tfa.ROUTE_LAUNCHES["wgmma"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_cuda_flash_wgmma_kv_shorter_than_q(d):
    # Sq > Sk, neither a multiple of a tile, at every head dim of the route
    _need_cuda()
    _assert_flash_close(*_wgmma_case(2, 1037, 300, 3, d, seed=6))


@pytest.mark.cuda
def test_cuda_flash_wgmma_map_cache():
    # the wrapper keeps the encoded tensor maps: a second call on the same
    # tensors reuses them, a call on new tensors of the same shape (other
    # data, and other addresses while the first are alive) must not
    _need_cuda()
    first = _wgmma_case(2, 1000, 1037, 3, 64, seed=7)
    out1 = _assert_flash_close(*first)
    out2 = _assert_flash_close(*first)
    assert torch.equal(out1, out2)
    second = _wgmma_case(2, 1000, 1037, 3, 64, seed=8)
    out3 = _assert_flash_close(*second)
    assert not torch.equal(out1, out3)
    # and new tensors where the first ones were freed
    del first, out1, out2
    torch.cuda.synchronize()
    _assert_flash_close(*_wgmma_case(2, 1000, 1037, 3, 64, seed=9))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(50, 77), (64, 64), (130, 1)])
def test_cuda_flash_wide_few_q_blocks(sq, sk):
    # one, one and three 64-row q blocks (the last two of 64 and 2 rows),
    # kv walks of two tiles, one tile and a single key; the small grids
    # split the kv walk where there is more than one tile
    _need_cuda()
    _assert_flash_close(*_wgmma_case(1, sq, sk, 1, 512, seed=13))


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(1, 512), (1, 320), (8, 512)])
def test_cuda_flash_wide_kv_split(b, d):
    # at b = 1 the grid (16 q blocks of 64 rows at H = 1) leaves the card
    # mostly idle, so the wrapper splits the kv walk (17 kv tiles of 64
    # keys) and a second kernel merges the parts into bf16 out and lse;
    # at b = 8 (128 blocks) it does not split
    _need_cuda()
    sq, sk, h = 1000, 1037, 1
    splits = tfa.kv_splits(b * h * -(-sq // tfa.WIDE_BLOCK_Q),
                           -(-sk // tfa.WIDE_BLOCK_K),
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    assert (splits > 1) == (b == 1)
    q, k, v = _wgmma_case(b, sq, sk, h, d, seed=12)
    out = _assert_flash_close(q, k, v)
    # bf16 `out` is ~1/sqrt(Sk) in size, mostly below the absolute 2e-2,
    # so it is also held to its own scale: normwise <= 2^-8 (the kernel
    # rounds P and out to bf16, ~1.5e-3 expected), which a 3 % scale fault
    # of the output fails
    ref = tfa.flash_attention_plain(q, k, v, d ** -0.5)[0].float()

    def normwise(o):
        return ((o.float() - ref).norm() / ref.norm()).item()
    assert normwise(out) <= 2 ** -8
    assert normwise(out * 0.97) > 2 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 8])
def test_cuda_flash_fma_cross_lengths(b):
    # the FMA route (fp32 d = 512) at seq_q != seq_k, with tails in both
    # its 64-row query blocks (1000 = 15 * 64 + 40) and its 256-key kv
    # tiles (1100 = 4 * 256 + 76): q a contiguous tensor, k and v strided
    # views of one fused kv projection. At b = 2 the grid is small enough
    # that the kv walk splits and a second kernel combines the parts; at
    # b = 8 it does not.
    _need_cuda()
    d, h, sq, sk = 512, 3, 1000, 1100
    assert tfa.route(torch.float32, d) == "fma"
    assert sq % tfa.FMA_BLOCK_Q and sk % tfa.FMA_BLOCK_K
    splits = tfa.kv_splits(b * h * -(-sq // tfa.FMA_BLOCK_Q),
                           -(-sk // tfa.FMA_BLOCK_K),
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    assert (splits > 1) == (b == 2)
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g)
    kv = torch.randn(b, sk, 2 * h * d, device="cuda", generator=g)
    k, v = (t.unflatten(-1, (h, d)) for t in kv.split(h * d, -1))
    before = tfa.ROUTE_LAUNCHES["fma"]
    out, lse = tfa.flash_attention_fwd(q, k, v)
    assert tfa.ROUTE_LAUNCHES["fma"] == before + 1
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    assert out.shape == (b, sq, h * d) and lse.shape == (b, h, sq)
    _assert_close(out, ref)
    _assert_close(lse, ref_lse)
    # the check sees a 3 % scale fault of either output
    with pytest.raises(AssertionError):
        _assert_close(out * 0.97, ref)
    with pytest.raises(AssertionError):
        _assert_close(lse * 0.97, ref_lse)


def _geglu_reference(x, w, b, gate):
    """The plain version K2 is held to: in bf16 as it is; in fp32 on
    float64 copies of the inputs (rounded back to fp32), because the fp32
    plain version (cuBLAS's fp32 GEMM) is itself up to ~3e-5 from that
    at the UNet's shapes, more than the fp32 tolerance, while the 3xTF32
    kernel is within it."""
    if x.dtype == torch.bfloat16:
        return tgeglu.geglu_plain(x, w, b, gate)
    return tgeglu.geglu_plain(x.double(), w.double(), b.double(),
                              gate).float()


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
    ref = _geglu_reference(x, w, b, gate)
    _assert_close(out, ref)


def _geglu_case(m, c, inner, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, c, device="cuda", generator=g, dtype=dtype)
    w = torch.randn(2 * inner, c, device="cuda", generator=g,
                    dtype=dtype) * c ** -0.5
    b = torch.randn(2 * inner, device="cuda", generator=g, dtype=dtype) * 0.1
    return x, w, b


def _assert_geglu_close(x, w, b, gate=None):
    gate = gate or tgeglu._default_gate_for(x.dtype)
    route = tgeglu.route(x.dtype)
    before = tgeglu.LAUNCHES, tgeglu.ROUTE_LAUNCHES[route]
    out = tgeglu.geglu_fwd(x, w, b, gate)
    assert (tgeglu.LAUNCHES, tgeglu.ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == (x.shape[0], w.shape[0] // 2)
    ref = _geglu_reference(x, w, b, gate)
    _assert_close(out, ref)
    # the check sees a 3 % scale fault
    with pytest.raises(AssertionError):
        _assert_close(out * 0.97, ref)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,inner", [
    (1, 320, 1280),      # one row: a tile of 1 row, fewer tiles than SMs
    (127, 64, 64),       # one tile
    (1000, 200, 136),    # C past a 64 slice, inner past a column tile
    (300, 72, 200),      # both ragged, inner not a multiple of 64
    (129, 1280, 5120),   # a second, nearly empty row of tiles
    (16900, 320, 1280),  # 133 x 20 tiles: the grid does not divide them
])
def test_cuda_geglu_bf16_ragged_shapes(m, c, inner):
    # rows past M, K past C and columns past inner (a wrong mask would read
    # gate rows into h) against the plain version
    _need_cuda()
    _assert_geglu_close(*_geglu_case(m, c, inner, seed=m))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,inner", [
    (1, 320, 1280),      # one row: fewer tiles than SMs
    (127, 64, 64),       # one tile, K in two restarts
    (1000, 200, 136),    # C past a 32-wide stage, inner past a column tile
    (300, 72, 200),      # both ragged, inner not a multiple of 64
    (129, 1280, 5120),   # a second, nearly empty row of tiles
    (2100, 320, 1280),   # 17 x 20 tiles: a second raster group of rows
])
def test_cuda_geglu_fp32_ragged_shapes(m, c, inner):
    # the 3xTF32 route's rows past M, K past C (zero-filled x and W
    # halves) and columns past inner against the plain version
    _need_cuda()
    _assert_geglu_close(*_geglu_case(m, c, inner, torch.float32, seed=m))


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["erf5", "cdf3", "poly14"])
def test_cuda_geglu_fp32_gates(gate):
    _need_cuda()
    _assert_geglu_close(*_geglu_case(777, 320, 1280, torch.float32, seed=3),
                        gate=gate)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["erf5", "cdf3", "poly14"])
def test_cuda_geglu_bf16_gates(gate):
    _need_cuda()
    _assert_geglu_close(*_geglu_case(777, 320, 1280, seed=3), gate=gate)


@pytest.mark.cuda
def test_cuda_geglu_map_cache():
    # the wrapper keeps the encoded tensor maps and the checked layout: a
    # second call on the same tensors reuses them, a call on new tensors
    # of the same shape (other data, and other addresses while the first
    # are alive) must not
    _need_cuda()
    first = _geglu_case(1000, 320, 1280, seed=7)
    out1 = _assert_geglu_close(*first)
    out2 = _assert_geglu_close(*first)
    assert torch.equal(out1, out2)
    second = _geglu_case(1000, 320, 1280, seed=8)
    out3 = _assert_geglu_close(*second)
    assert not torch.equal(out1, out3)
    # and new tensors where the first ones were freed
    del first, out1, out2
    torch.cuda.synchronize()
    _assert_geglu_close(*_geglu_case(1000, 320, 1280, seed=9))


@pytest.mark.cuda
def test_cuda_geglu_raises_on_what_it_does_not_take():
    _need_cuda()
    x, w, b = _geglu_case(64, 320, 1280)
    before = tgeglu.LAUNCHES
    for args in ((x[:, :316].contiguous(), w[:, :316].contiguous(),
                  b),                                   # C % 8
                 (x, w[:2 * 1276], b[:2 * 1276]),       # inner % 8
                 (x.t().contiguous().t(), w, b),        # not contiguous
                 (x, w.float(), b),                     # mixed dtypes
                 (x.half(), w.half(), b.half()),        # fp16
                 (x, w, b.cpu())):                      # mixed devices
        with pytest.raises((ValueError, TypeError)):
            tgeglu.geglu_fwd(*args, "cdf3")
    assert tgeglu.LAUNCHES == before


def _ta_case(f, n, h, d, dtype, layout="fused", seed=0):
    """Seeded q, k, v (F, N, H, d): views of one fused (F, N, 3 H d)
    projection, or ("separate") three tensors with strides of their own:
    q contiguous, k stored pixel-major (N, F, H, d), v with 8 elements of
    padding after each head."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g, dtype=dtype)
    if layout == "fused":
        qkv = randn(f, n, 3 * h * d)
        return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1)]
    return [randn(f, n, h, d), randn(n, f, h, d).transpose(0, 1),
            randn(f, n, h, d + 8)[..., :d]]


def _assert_ta_close(q, k, v):
    """K3 on (q, k, v): one launch, within `_assert_close` of the plain
    version, and a 3 % scale fault of its output refused."""
    before = tta.LAUNCHES
    out = tta.temporal_attention(q, k, v)
    assert tta.LAUNCHES == before + 1
    ref = tta.temporal_attention_plain(q, k, v, q.shape[-1] ** -0.5)
    _assert_close(out, ref)
    with pytest.raises(AssertionError):
        _assert_close((out.float() * 0.97).to(out.dtype), ref)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f,d,n,h,layout", [
    # the serving path's motion levels (d = 40, 80, 160 at 16 frames) and
    # 32-frame clips at level 2 (two row tiles a pair)
    (torch.bfloat16, 16, 40, 300, 8, "fused"),
    (torch.float32, 16, 160, 300, 8, "fused"),
    (torch.bfloat16, 16, 80, 300, 8, "fused"),
    (torch.bfloat16, 16, 160, 300, 8, "fused"),
    (torch.bfloat16, 32, 160, 300, 8, "fused"),
    (torch.float32, 32, 160, 300, 8, "fused"),
    # every frame count's n-tile count and row tiles: F = 1, 8 (stage 2),
    # 13, 24 and 32 frames past the last whole tile
    *[(dt, f, 40, 300, 8, "fused") for dt in (torch.bfloat16, torch.float32)
      for f in (1, 8, 13, 24, 32)],
    # head dims: d = 16 (the tiny config), 40 and 80 in fp32, d = 512 in
    # fp32 at 8 frames and d = 264 in bf16 (wider than a TMA box: rows
    # copied one by one)
    (torch.bfloat16, 16, 16, 300, 8, "fused"),
    (torch.float32, 16, 16, 300, 8, "fused"),
    (torch.float32, 16, 40, 300, 8, "fused"),
    (torch.float32, 16, 80, 300, 8, "fused"),
    (torch.float32, 8, 512, 37, 3, "fused"),
    (torch.bfloat16, 13, 264, 37, 3, "fused"),
    # pairs that do not fill the persistent grid, stages whose pixels run
    # past N (stage 2's 8-frame L0 takes two pixels a stage) or whose heads
    # are 3 or 5
    (torch.bfloat16, 16, 40, 5, 8, "fused"),
    (torch.bfloat16, 8, 40, 301, 8, "fused"),
    (torch.bfloat16, 16, 80, 7, 3, "fused"),
    (torch.float32, 24, 40, 11, 5, "fused"),
    # three tensors with their own strides
    (torch.bfloat16, 16, 40, 300, 8, "separate"),
    (torch.float32, 32, 160, 40, 8, "separate"),
    (torch.bfloat16, 8, 264, 20, 2, "separate"),
])
def test_cuda_temporal_attention_matches_plain(dtype, f, d, n, h, layout):
    _need_cuda()
    _assert_ta_close(*_ta_case(f, n, h, d, dtype, layout))


@pytest.mark.cuda
def test_cuda_temporal_attention_map_cache():
    # the wrapper keeps the checked layout and the C side the encoded
    # tensor maps: a second call on the same tensors reuses them, a call on
    # new tensors of the same shape (other data, and other addresses while
    # the first are alive) must not
    _need_cuda()
    first = _ta_case(16, 300, 8, 40, torch.bfloat16, seed=7)
    out1 = _assert_ta_close(*first)
    out2 = _assert_ta_close(*first)
    assert torch.equal(out1, out2)
    second = _ta_case(16, 300, 8, 40, torch.bfloat16, seed=8)
    out3 = _assert_ta_close(*second)
    assert not torch.equal(out1, out3)
    # and new tensors where the first ones were freed
    del first, out1, out2
    torch.cuda.synchronize()
    _assert_ta_close(*_ta_case(16, 300, 8, 40, torch.bfloat16, seed=9))


def _assert_close_bwd(out, ref):
    """Backward kernels. bf16, against each output's own scale (the
    gradients are ~1/sqrt(S) in size, far below an absolute 2e-2): the
    normwise error |out - ref|_2 / |ref|_2 at most 2^-10 and the largest
    entry's error at most 2^-6 of max |ref|, two bf16 ulps (both round p
    and ds at the same points, so only rounding flips differ: ~2e-4
    normwise). fp32:
    1e-5 absolute plus 1e-5 relative (dk/dv are f32 sums over every query
    row, and K4 takes exp2 where the plain version takes exp)."""
    diff = out.double() - ref.double()
    if out.dtype == torch.bfloat16:
        assert diff.norm().item() <= 2 ** -10 * ref.double().norm().item()
        assert (diff.abs().max().item()
                <= 2 ** -6 * ref.double().abs().max().item())
        return
    excess = diff.abs() - 1e-5 * ref.double().abs()
    assert excess.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bwd_matches_plain(dtype):
    # S = 1100 leaves masked q and kv tails in both kernels
    _need_cuda()
    d = 64
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 1100, 3 * 2 * d, device="cuda", generator=g,
                      dtype=dtype)
    q, k, v = (t.unflatten(-1, (2, d)) for t in qkv.split(2 * d, -1))
    do = torch.randn(2, 1100, 2 * d, device="cuda", generator=g, dtype=dtype)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, d ** -0.5)
    route = tfa.bwd_route(dtype, d)
    before = (tfa.BWD_ROUTE_LAUNCHES[route], tfa.DELTA_LAUNCHES)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    assert (tfa.BWD_ROUTE_LAUNCHES[route], tfa.DELTA_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, ref):
        _assert_close_bwd(a, b)
        # the check sees a 3 % scale fault
        with pytest.raises(AssertionError):
            _assert_close_bwd((a.float() * 0.97).to(dtype), b)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1100, 700), (700, 1100), (100, 50)])
def test_cuda_flash_bwd_wgmma_cross_lengths(sq, sk):
    # bf16 K4 (the wgmma route) at Sq != Sk: q and kv tails in both
    # kernels, kv tiles that end inside their first half (700 = 5 x 128 +
    # 60, 50 < 64); q its own tensor, k and v strided views of one fused
    # (B, Sk, 2*H*D) projection; B*H = 6
    _need_cuda()
    b, h, d = 2, 3, 64
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    kv = torch.randn(b, sk, 2 * h * d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    k, v = (t.unflatten(-1, (h, d)) for t in kv.split(h * d, -1))
    do = torch.randn(b, sq, h * d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, d ** -0.5)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    for a, r, want in zip(got, ref, (q, k, v)):
        assert a.shape == want.shape and a.is_contiguous()
        _assert_close_bwd(a, r)
        with pytest.raises(AssertionError):
            _assert_close_bwd((a.float() * 0.97).to(a.dtype), r)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1100, 700), (700, 1100), (100, 50)])
def test_cuda_flash_tf32x3_cross_lengths(sq, sk):
    # fp32 K1 and K4 at d = 64 (the 3xTF32 route) at Sq != Sk: q and kv
    # tails in the forward and both backward kernels, and tiles that end
    # inside their first half (700 = 10 x 64 + 60, 50 < 64); q its own
    # tensor, k and v strided views of one fused projection; B*H = 6
    _need_cuda()
    b, h, d = 2, 3, 64
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g)
    kv = torch.randn(b, sk, 2 * h * d, device="cuda", generator=g)
    k, v = (t.unflatten(-1, (h, d)) for t in kv.split(h * d, -1))
    do = torch.randn(b, sq, h * d, device="cuda", generator=g)
    before = (tfa.ROUTE_LAUNCHES["tf32x3"], tfa.BWD_ROUTE_LAUNCHES["tf32x3"])
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref_out, ref_lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    _assert_close(out, ref_out)
    _assert_close(lse, ref_lse)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, d ** -0.5)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    assert (tfa.ROUTE_LAUNCHES["tf32x3"],
            tfa.BWD_ROUTE_LAUNCHES["tf32x3"]) == (before[0] + 1,
                                                  before[1] + 1)
    for a, r, want in zip(got, ref, (q, k, v)):
        assert a.shape == want.shape and a.is_contiguous()
        _assert_close_bwd(a, r)
        with pytest.raises(AssertionError):
            _assert_close_bwd(a * 0.97, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bwd_delta_matches_formula(dtype):
    # K4's delta kernel against rowsum(dO * O) in torch: f32 sums of 64
    # products in another order, so 1e-5 of the result, normwise and at
    # the largest entry
    _need_cuda()
    b, s, h, d = 2, 1100, 3, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    o, do = (torch.randn(b, s, h * d, device="cuda", generator=g,
                         dtype=dtype) for _ in range(2))
    before = tfa.DELTA_LAUNCHES
    got = tfa.flash_attention_bwd_delta(o, do, h)
    assert tfa.DELTA_LAUNCHES == before + 1
    want = (do.float() * o.float()).unflatten(-1, (h, d)).sum(-1) \
        .transpose(1, 2)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    diff = (got - want).double()
    assert diff.norm().item() <= 1e-5 * want.double().norm().item()
    assert diff.abs().max().item() <= 1e-5 * want.abs().max().item()
    with pytest.raises(AssertionError):
        bad = got * (1 + 1e-4)
        assert ((bad - want).double().norm().item()
                <= 1e-5 * want.double().norm().item())


def _sliced_case(dtype, d, b, h, sq, sk, seed, fused):
    """K4 on the D-sliced route against its plain version: (q, k, v) from
    one fused (B, S, 3*H*D) projection (fused, Sq = Sk) or q its own
    tensor and k, v views of one (B, Sk, 2*H*D) projection; one backward
    launches the route once and the delta kernel once."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn(b, sq, 3 * h * d, device="cuda", generator=g,
                          dtype=dtype)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    else:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g, dtype=dtype)
        kv = torch.randn(b, sk, 2 * h * d, device="cuda", generator=g,
                         dtype=dtype)
        k, v = (t.unflatten(-1, (h, d)) for t in kv.split(h * d, -1))
    do = torch.randn(b, sq, h * d, device="cuda", generator=g, dtype=dtype)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, d ** -0.5)
    route = tfa.bwd_route(dtype, d)
    assert route.endswith("_sliced")
    before = (tfa.BWD_ROUTE_LAUNCHES[route], tfa.DELTA_LAUNCHES)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    assert (tfa.BWD_ROUTE_LAUNCHES[route], tfa.DELTA_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    for a, r, want in zip(got, ref, (q, k, v)):
        assert a.shape == want.shape and a.is_contiguous()
        _assert_close_bwd(a, r)
        # the check sees a 3 % scale fault
        with pytest.raises(AssertionError):
            _assert_close_bwd((a.float() * 0.97).to(dtype), r)
    return got, (q, k, v, out, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(dt, d)
                                     for dt in (torch.bfloat16, torch.float32)
                                     for d in (128, 192, 256, 320, 384, 448,
                                               512)])
def test_cuda_flash_bwd_sliced_matches_plain(dtype, d):
    # K4 at d = 128-512 (bf16 on wgmma + TMA, fp32 at 3xTF32, each block a
    # slice of D: 128 wide, the last 64 at d = 192, 320, 448): q, k, v
    # strided views of one fused projection, S = 1100 leaves q and kv
    # tails in both kernels, two heads (one above 256, as the VAE)
    _need_cuda()
    _sliced_case(dtype, d, 2, 2 if d <= 256 else 1, 1100, 1100, seed=d,
                 fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,sq,sk", [(128, 1100, 700), (320, 700, 1100),
                                     (512, 100, 50), (448, 77, 300)])
def test_cuda_flash_bwd_sliced_cross_lengths(dtype, d, sq, sk):
    # Sq != Sk: streamed tiles that end inside their first half (50 < 64
    # keys for bf16 dq, 77 = 64 + 13 q rows for bf16 dk/dv, 2 x 32 + 13 in
    # fp32), own tiles past the end; q its own tensor, k and v views of one
    # fused projection; B*H = 4
    _need_cuda()
    _sliced_case(dtype, d, 2, 2, sq, sk, seed=7 + d, fused=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,sq,sk", [(128, 1100, 200), (128, 200, 1100),
                                     (512, 1100, 200), (512, 200, 1100)])
def test_cuda_flash_bwd_sliced_cross_lengths_past_the_tiles(dtype, d, sq,
                                                             sk):
    # Sq and Sk not multiples of the kernels' tiles (64 streamed rows in
    # bf16, 32 in fp32; 128 or 64 own rows): 200 = 3 x 64 + 8 and 1100 =
    # 17 x 64 + 12 leave a ragged last streamed tile and own rows past the
    # end in both kernels, at one block (d = 128) and a cluster of four
    # (d = 512)
    _need_cuda()
    _sliced_case(dtype, d, 2, 2, sq, sk, seed=31 + d + sq, fused=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bwd_sliced_deterministic(dtype):
    # no atomics: two backwards of the VAE's head (d = 512, one head) are
    # bitwise equal
    _need_cuda()
    first, args = _sliced_case(dtype, 512, 1, 1, 1500, 1500, seed=11,
                               fused=True)
    again = tfa.flash_attention_bwd(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 192, 320, 448, 512])
def test_cuda_flash_bwd_delta_every_head_dim(dtype, d):
    # the delta kernel at a row wider than one warp's 16-byte loads (bf16
    # d = 512: 64 vectors, two a thread) and at counts of vectors that 32
    # does not divide (d = 192: 24 bf16 vectors, 8 threads of 3)
    _need_cuda()
    b, s, h = 2, 301, 2
    g = torch.Generator(device="cuda").manual_seed(d)
    o, do = (torch.randn(b, s, h * d, device="cuda", generator=g,
                         dtype=dtype) for _ in range(2))
    before = tfa.DELTA_LAUNCHES
    got = tfa.flash_attention_bwd_delta(o, do, h)
    assert tfa.DELTA_LAUNCHES == before + 1
    want = (do.float() * o.float()).unflatten(-1, (h, d)).sum(-1) \
        .transpose(1, 2)
    diff = (got - want).double()
    assert diff.norm().item() <= 1e-5 * want.double().norm().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 512])
def test_cuda_autograd_through_sliced_flash(d):
    # fp32 gradients through flash_attention_qkv at d = 128 (two heads) and
    # d = 512 (the VAE's one head): K1 forward, K4's sliced backward,
    # against the same call on the CPU (the plain versions)
    _need_cuda()
    h = 2 if d == 128 else 1
    g = torch.Generator().manual_seed(d)
    qkv = torch.randn(1, 700, 3 * h * d, generator=g)
    before = tfa.BWD_ROUTE_LAUNCHES["tf32x3_sliced"]
    _grads_vs_cpu(lambda x: tfa.flash_attention_qkv(x, h), [qkv])
    assert tfa.BWD_ROUTE_LAUNCHES["tf32x3_sliced"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f,d", [(torch.bfloat16, 8, 40),
                                       (torch.float32, 16, 160),
                                       (torch.bfloat16, 32, 80),
                                       (torch.float32, 2, 40),
                                       (torch.bfloat16, 4, 16),
                                       (torch.bfloat16, 12, 32),
                                       (torch.float32, 32, 600),
                                       (torch.bfloat16, 32, 1208)])
def test_cuda_temporal_attention_bwd_matches_plain(dtype, f, d):
    # K5 against its plain version: stages of whole pairs at 4001 pixels
    # (every block's ring of stages wraps; F = 2 fp32, the stage2_fp32
    # path's clip, and F = 4 bf16 take 3 and 6 pixels a stage, so the last
    # stage is partial; F <= 8 packs 16 / F pairs into a row tile, F = 12
    # leaves rows of its tile past the clip) and, at the widest heads K3
    # takes at 32 frames
    # (pair_fits), column chunks of one pair a stage at 601 pixels x 2
    # heads (blocks take one or two groups of a pair a warp, the last
    # group partial)
    _need_cuda()
    n, h = (601, 2) if d > 256 else (4001, 8)
    assert tta.pair_fits(f, d, torch.tensor([], dtype=dtype).element_size())
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(f, n, 3 * h * d, device="cuda", generator=g,
                      dtype=dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    do = torch.randn(f, n, h * d, device="cuda", generator=g, dtype=dtype)
    before = tta.BWD_LAUNCHES
    got = tta.temporal_attention_bwd(q, k, v, do)
    assert tta.BWD_LAUNCHES == before + 1
    ref = tta.temporal_attention_bwd_plain(q, k, v, do, d ** -0.5)
    for a, b in zip(got, ref):
        assert a.shape == (f, n, h, d) and a.is_contiguous()
        _assert_close_bwd(a, b)
        with pytest.raises(AssertionError):
            _assert_close_bwd((a.float() * 0.97).to(dtype), b)


@pytest.mark.cuda
def test_cuda_temporal_attention_bwd_separate_and_expanded_views():
    # K5 on q of its own strides and k, v expanded over the pixels (a zero
    # stride, which no TMA map takes: the wrapper copies such a view to a
    # dense one first), as K3 takes them
    _need_cuda()
    f, n, h, d = 8, 301, 4, 40
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(f, n, h, 2 * d, device="cuda", generator=g)[..., :d]
    k, v = (torch.randn(f, 1, h, d, device="cuda", generator=g)
            .expand(f, n, h, d) for _ in range(2))
    assert k.stride(1) == 0
    do = torch.randn(f, n, h * d, device="cuda", generator=g)
    before = tta.BWD_LAUNCHES
    got = tta.temporal_attention_bwd(q, k, v, do)
    assert tta.BWD_LAUNCHES == before + 1
    ref = tta.temporal_attention_bwd_plain(q, k, v, do, d ** -0.5)
    for a, b in zip(got, ref):
        _assert_close_bwd(a, b)


def _grads_vs_cpu(fn, inputs):
    """fn's output on the card carries a grad_fn, and its gradients (the
    kernel forward, the kernel or torch backward) match the same call on
    the CPU (the plain versions); fp32, 1e-4 of each gradient's max."""
    cuda_in = [t.cuda().requires_grad_() for t in inputs]
    cpu_in = [t.clone().requires_grad_() for t in inputs]
    out = fn(*cuda_in)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (out * cot.cuda()).sum().backward()
    (fn(*cpu_in) * cot).sum().backward()
    for a, b in zip(cuda_in, cpu_in):
        scale = b.grad.abs().max().item()
        assert (a.grad.cpu() - b.grad).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_autograd_through_flash():
    _need_cuda()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 1100, 2, 64, generator=g) for _ in range(3))
    before = tfa.BWD_LAUNCHES
    _grads_vs_cpu(tfa.flash_attention, [q, k, v])
    assert tfa.BWD_LAUNCHES == before + 1


@pytest.mark.cuda
def test_cuda_autograd_through_wgmma_flash():
    # bf16 d = 64: the wgmma forward's out and lse are K4's residuals; the
    # gradients through the autograd Function equal the plain backward
    # fed the same residuals, and the forward's lse is the plain one
    _need_cuda()
    d = 64
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(2, 1100, 3 * 2 * d, device="cuda", generator=g,
                      dtype=torch.bfloat16)
    do = torch.randn(2, 1100, 2 * d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    leaf = qkv.clone().requires_grad_()
    before = (tfa.LAUNCHES, tfa.BWD_LAUNCHES)
    out = tfa.flash_attention_qkv(leaf, 2)
    out.backward(do)
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES) == (before[0] + 1,
                                                before[1] + 1)
    q, k, v = (t.unflatten(-1, (2, d)) for t in qkv.split(2 * d, -1))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    assert torch.equal(o, out.detach())
    _, ref_lse = tfa.flash_attention_plain(q, k, v, d ** -0.5)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, d ** -0.5)
    for a, b in zip(leaf.grad.split(2 * d, -1), ref):
        _assert_close_bwd(a.unflatten(-1, (2, d)), b)


@pytest.mark.cuda
def test_cuda_autograd_through_geglu():
    _need_cuda()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1000, 320, generator=g)
    w = torch.randn(2 * 1280, 320, generator=g) * 0.05
    b = torch.randn(2 * 1280, generator=g) * 0.1
    before = tgeglu.LAUNCHES
    _grads_vs_cpu(tgeglu.geglu_projection, [x, w, b])
    assert tgeglu.LAUNCHES == before + 1


@pytest.mark.cuda
def test_cuda_autograd_through_temporal_attention():
    _need_cuda()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(8, 300, 8, 40, generator=g) for _ in range(3))
    before = (tta.LAUNCHES, tta.BWD_LAUNCHES)
    _grads_vs_cpu(tta.temporal_attention, [q, k, v])
    assert (tta.LAUNCHES, tta.BWD_LAUNCHES) == (before[0] + 1,
                                                before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,c", [(torch.bfloat16, 4096, 1280),
                                       (torch.bfloat16, 154, 768),
                                       (torch.bfloat16, 1001, 320),
                                       (torch.float32, 515, 640),
                                       (torch.float32, 9, 2048),
                                       (torch.bfloat16, 3, 8)])
def test_cuda_layer_norm_matches_plain(dtype, m, c):
    # any M (the last block's spare warps leave), every width of the
    # models; both sides keep f32 inside and round once: one output ulp
    # (2^-7 relative) in bf16, 1e-5 in fp32, plus 1e-5 near zero
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(m, c, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    w = (1 + 0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    b = (0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    before = tln.LAUNCHES
    out = tln.layer_norm(x.reshape(1, m, c), w, b).reshape(m, c)
    assert tln.LAUNCHES == before + 1
    ref = tln.layer_norm_reference(x, w, b)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    excess = (out.float() - ref.float()).abs() - rtol * ref.float().abs()
    assert excess.max().item() <= 1e-5
    # scale and bias held in f32 beside a bf16 x are read as they are
    out32 = tln.layer_norm(x, w.float(), b.float())
    assert tln.LAUNCHES == before + 2
    assert torch.equal(out32, out)
    # the check sees a 3 % scale fault
    bad = (out.float() * 0.97).to(dtype)
    assert ((bad.float() - ref.float()).abs()
            - rtol * ref.float().abs()).max().item() > 1e-5


@pytest.mark.cuda
def test_cuda_layer_norm_raises_on_what_it_does_not_take():
    _need_cuda()
    ones = torch.ones(324, device="cuda")
    with pytest.raises(ValueError, match="multiple of"):
        tln.layer_norm(torch.randn(8, 324, device="cuda",
                                   dtype=torch.bfloat16), ones, ones)
    big = torch.ones(4096, device="cuda")
    with pytest.raises(ValueError, match="up to 2048"):
        tln.layer_norm(torch.randn(8, 4096, device="cuda"), big, big)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tln.layer_norm(torch.randn(8, 320, device="cuda",
                                   dtype=torch.float16), ones[:320],
                       ones[:320])
    with pytest.raises(ValueError, match="one CUDA device"):
        tln.layer_norm(torch.randn(8, 320, device="cuda"),
                       torch.ones(320), torch.ones(320))
    with pytest.raises(TypeError, match="floating scale and bias"):
        tln.layer_norm(torch.randn(8, 320, device="cuda"),
                       ones[:320].int(), ones[:320].int())
    # no fallback to the library call on the card
    before = tln.LAUNCHES
    with pytest.raises(ValueError):
        tln.layer_norm(torch.randn(8, 324, device="cuda",
                                   dtype=torch.bfloat16), ones, ones)
    assert tln.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_layer_norm_casts_a_narrower_affine_to_f32():
    # an affine held in neither x's dtype nor f32 (bf16 beside f32 x) is
    # cast to f32, as the JAX formula's astype(float32) does
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(300, 640, device="cuda", generator=g)
    w = (1 + 0.1 * torch.randn(640, device="cuda", generator=g)).bfloat16()
    b = (0.1 * torch.randn(640, device="cuda", generator=g)).bfloat16()
    out = tln.layer_norm(x, w, b)
    assert torch.equal(out, tln.layer_norm(x, w.float(), b.float()))
    _assert_close(out, tln.layer_norm_reference(x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,c", [(torch.bfloat16, 154, 1280),
                                       (torch.bfloat16, 1024, 1280),
                                       (torch.bfloat16, 300, 640),
                                       (torch.bfloat16, 4096, 320),
                                       (torch.float32, 77, 768),
                                       (torch.float32, 2048, 1280)])
def test_cuda_layer_norm_statistics(dtype, m, c):
    # each row's f32 mean and rstd, written only when asked for, at M
    # that take 1, 2, 4 and 8 rows a block; y is the same either way.
    # f32 sums in another order: 1e-5 + 1e-5 relative
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(m, c, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    w = (1 + 0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    b = (0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    y, mean, rstd = tln.layer_norm_fwd(x, w, b, stats=True)
    assert torch.equal(y, tln.layer_norm_fwd(x, w, b))
    assert mean.shape == rstd.shape == (m, 1)
    assert mean.dtype == rstd.dtype == torch.float32
    for got, want in zip((mean, rstd), tln.layer_norm_stats_reference(x)):
        excess = (got - want).abs() - 1e-5 * want.abs()
        assert excess.max().item() <= 1e-5
        # the check sees a 3 % fault
        assert ((got * 0.97 - want).abs()
                - 1e-5 * want.abs()).max().item() > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("need", [(True, False, False), (True, True, True)])
def test_cuda_layer_norm_backward_route(xdt, sdt, need):
    # the card's backward (dx from aten's native_layer_norm_backward on
    # K7's statistics, dscale and dbias from K7's kernels) against the
    # plain formula's autograd on the card: bf16
    # normwise within 2^-10 of each gradient, fp32 dx within 1e-5 + 1e-5
    # relative and dscale, dbias (sums over all rows) within 1e-5 plus
    # 2^-20 of their largest entry; never the plain formula's autograd
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    m, c = 4096, 320
    x = (torch.randn(m, c, device="cuda", generator=g) * 1.5 + 0.3).to(xdt)
    w = (1 + 0.1 * torch.randn(c, device="cuda", generator=g)).to(sdt)
    b = (0.1 * torch.randn(c, device="cuda", generator=g)).to(sdt)
    cot = torch.randn(m, c, device="cuda", generator=g).to(xdt)
    grads = []
    for fn in (tln.layer_norm, tln.layer_norm_reference):
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(
            need[1]), b.clone().requires_grad_(need[2])]
        before = tln.LAUNCHES
        out = fn(*leaves)
        if fn is tln.layer_norm:
            assert "_LayerNorm" in type(out.grad_fn).__name__
            assert tln.LAUNCHES == before + 1
        out.backward(cot)
        grads.append([t.grad for t in leaves])
    for i, (got, want) in enumerate(zip(*grads)):
        if not need[i]:
            assert got is None and want is None
            continue
        assert got.dtype == want.dtype
        d, r = got.double() - want.double(), want.double()
        if xdt == torch.bfloat16:
            assert d.norm().item() <= 2 ** -10 * r.norm().item()
        elif i == 0:
            assert ((d.abs() - 1e-5 * r.abs()).max().item()) <= 1e-5
        else:
            assert d.abs().max().item() <= 1e-5 + 2 ** -20 * r.abs().max(
            ).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,c", [(torch.bfloat16, 8 * 16384, 320),
                                       (torch.bfloat16, 1001, 1280),
                                       (torch.bfloat16, 7, 8),
                                       (torch.float32, 2 * 16384, 320),
                                       (torch.float32, 515, 2048)])
def test_cuda_layer_norm_affine_grads_match_plain(dtype, m, c):
    # the backward's dscale and dbias kernels: f32 sums over all rows (any
    # M, the last warp's run cut short), within 1e-5 plus 2^-20 of the
    # largest entry of the plain sums (their order differs); rounded once
    # to a bf16 output, within that plus half a bf16 ulp (2^-8 relative)
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn(m, c, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    dy = torch.randn(m, c, device="cuda", generator=g).to(dtype)
    mean, rstd = tln.layer_norm_stats_reference(x)
    before = tln.AFFINE_LAUNCHES
    got = tln.layer_norm_affine_grads(dy, x, mean, rstd)
    assert tln.AFFINE_LAUNCHES == before + 1
    want = tln.layer_norm_affine_grads_plain(dy, x, mean, rstd)
    assert got.shape == want.shape == (2, c) and got.dtype == torch.float32
    for a, r in zip(got, want):
        limit = 1e-5 + 2 ** -20 * r.abs().max().item()
        assert (a - r).abs().max().item() <= limit
        assert (a * 0.97 - r).abs().max().item() > limit
    half = tln.layer_norm_affine_grads(dy, x, mean, rstd, torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.shape == (2, c)
    for a, r in zip(half.float(), want):
        limit = 1e-5 + 2 ** -20 * r.abs().max().item() + 2 ** -8 * r.abs()
        assert ((a - r).abs() <= limit).all()


@pytest.mark.cuda
def test_cuda_layer_norm_no_copy_on_the_models_views():
    # the motion modules' (F, N, C) tokens and the transformer blocks' (N,
    # S, C) tokens are contiguous: no copy before the kernel
    _need_cuda()
    from video_style_transfer_tpu_torch.models import layers
    p = {"weight": torch.ones(320, device="cuda"),
         "bias": torch.zeros(320, device="cuda")}
    x = torch.randn(4, 64, 320, device="cuda")
    before = tln.COPIES
    layers.layer_norm(p, x)
    assert tln.COPIES == before
    # a strided view is copied once and still normalised right
    t = torch.randn(64, 4, 320, device="cuda").transpose(0, 1)
    _assert_close(layers.layer_norm(p, t),
                  tln.layer_norm_reference(t, p["weight"], p["bias"]))
    assert tln.COPIES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("first", ["x", "scale"])
def test_cuda_layer_norm_misaligned_x_then_scale(first):
    # x misaligned beside an aligned affine, then an aligned x beside a
    # misaligned scale (and the reverse order), in one process at one
    # shape: each call takes its own cached layout (a copy of x, a copy of
    # the affine), never the other's, and both normalise right
    _need_cuda()
    c = 320

    def at(n, offset):
        base = torch.randn(n + 8, device="cuda").to(torch.bfloat16)
        return base[offset:offset + n]
    calls = {"x": (at(64 * c, 4).view(64, c), at(c, 0), at(c, 0)),
             "scale": (at(64 * c, 0).view(64, c), at(c, 4), at(c, 0))}
    order = [first, "scale" if first == "x" else "x"]
    before = tln.COPIES
    for name in order:
        x, w, b = calls[name]
        _assert_close(tln.layer_norm(x, w, b),
                      tln.layer_norm_reference(x, w, b))
        torch.cuda.synchronize()
    # only the misaligned x is copied
    assert tln.COPIES == before + 1


@pytest.mark.cuda
def test_cuda_autograd_through_layer_norm():
    _need_cuda()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 640, generator=g)
    w = 1 + 0.1 * torch.randn(640, generator=g)
    b = 0.1 * torch.randn(640, generator=g)
    before = tln.LAUNCHES
    _grads_vs_cpu(tln.layer_norm, [x, w, b])
    assert tln.LAUNCHES == before + 1


# the GroupNorm calls of the paths, one of each distinct (shape, eps): the
# video step's (32 rows; its motion modules 2 rows of 16 frames), the image
# step's (8 rows), the fp32 decode's (a frame; the image path's 4 rows)
_BF, _F32 = torch.bfloat16, torch.float32
GN_SHAPES = [
    ((32, 128, 128, 320), _BF, 1e-5), ((32, 128, 128, 640), _BF, 1e-5),
    ((32, 128, 128, 960), _BF, 1e-5), ((2, 16 * 128, 128, 320), _BF, 1e-6),
    ((32, 64, 64, 320), _BF, 1e-5), ((32, 64, 64, 640), _BF, 1e-5),
    ((32, 64, 64, 960), _BF, 1e-5), ((32, 64, 64, 1280), _BF, 1e-5),
    ((32, 64, 64, 1920), _BF, 1e-5), ((32, 64, 64, 640), _BF, 1e-6),
    ((2, 16 * 64, 64, 640), _BF, 1e-6), ((32, 32, 32, 640), _BF, 1e-5),
    ((32, 32, 32, 1280), _BF, 1e-5), ((32, 32, 32, 1920), _BF, 1e-5),
    ((32, 32, 32, 2560), _BF, 1e-5), ((2, 16 * 32, 32, 1280), _BF, 1e-6),
    ((8, 128, 128, 320), _BF, 1e-5), ((8, 64, 64, 1920), _BF, 1e-5),
    ((8, 32, 32, 2560), _BF, 1e-5), ((8, 32, 32, 1280), _BF, 1e-6),
    ((1, 128, 128, 512), _F32, 1e-6), ((1, 256, 256, 512), _F32, 1e-6),
    ((1, 512, 512, 512), _F32, 1e-6), ((1, 512, 512, 256), _F32, 1e-6),
    ((1, 1024, 1024, 256), _F32, 1e-6), ((1, 1024, 1024, 128), _F32, 1e-6),
    ((4, 1024, 1024, 128), _F32, 1e-6)]


def _gn_inputs(shape, dtype, seed=0, shift=0.3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, device="cuda", generator=g) * 1.5
         + shift).to(dtype)
    w = (1 + 0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    b = (0.1 * torch.randn(c, device="cuda", generator=g)).to(dtype)
    return x, w, b


def _assert_gn_close(out, ref, atol=1e-5):
    """bf16: within one ulp of ref plus `atol` (the two differ only in the
    order of the f32 statistics' sums: ~1e-7 of the f32 affine's terms,
    which may move a value across a rounding boundary, and which near a
    zero of x * scale + shift exceed that small output's ulp); fp32: 1e-5
    + 1e-5*|ref|."""
    a, r = out.float(), ref.float()
    if out.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(a.abs(), r.abs()))
        ulp = torch.ldexp(torch.ones_like(a), e - 8)
        assert bool(((a - r).abs() <= ulp + atol).all())
    else:
        assert ((a - r).abs() - 1e-5 * r.abs()).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,eps", GN_SHAPES,
                         ids=[f"{s}-{str(d)[6:]}-{e}" for s, d, e in
                              GN_SHAPES])
def test_cuda_group_norm_matches_plain(shape, dtype, eps):
    # with and without SiLU: the norm against the plain version; the fused
    # SiLU against F.silu of the same call's norm (one ulp: expf's last
    # bit), and in fp32 against the plain version too
    _need_cuda()
    x, w, b = _gn_inputs(shape, dtype)
    before = tgn.LAUNCHES, tgn.SILU_LAUNCHES
    y = tgn.group_norm(x, w, b, 32, eps=eps)
    ys = tgn.group_norm(x, w, b, 32, eps=eps, silu=True)
    assert (tgn.LAUNCHES, tgn.SILU_LAUNCHES) == (before[0] + 2,
                                                 before[1] + 1)
    assert y.dtype == ys.dtype == dtype and y.shape == shape
    ref = tgn.group_norm_plain(x, w, b, 32, eps)
    _assert_gn_close(y, ref)
    _assert_gn_close(ys, torch.nn.functional.silu(y), atol=0.0)
    if dtype == torch.float32:
        _assert_gn_close(ys, torch.nn.functional.silu(ref))


def _row_statistics(x, w, b, groups, eps):
    """Each (row, group)'s mean and variance from the partial sums the
    statistics kernel left in the scratch, merged in float64."""
    entry = tgn._ACCEPTED[tgn._key(x, w, b, groups, eps, False)]
    rows, positions, chunk, c, _, chunks = tgn._LAYOUT.unpack(entry[0])[:6]
    part = tgn._SCRATCH[(x.get_device(), torch.cuda.current_stream(
        ).cuda_stream)][:entry[4]].view(rows, groups, chunks, 2).double()
    n = torch.tensor([e - s for s, e in tgn.chunk_bounds(positions, chunks,
                                                         chunk)],
                     dtype=torch.float64, device=x.device) * (c // groups)
    mean = (part[..., 0] * n).sum(-1) / n.sum()
    m2 = (part[..., 1] + n * (part[..., 0] - mean[..., None]) ** 2).sum(-1)
    return mean, m2 / n.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,shift", [
    ((32, 64, 64, 960), _BF, 0.3), ((2, 16 * 32, 32, 1280), _BF, 0.3),
    ((1, 1024, 1024, 128), _F32, 0.3), ((8, 32, 32, 1280), _BF, 20.0),
    ((1, 256, 256, 512), _F32, 20.0)])
def test_cuda_group_norm_statistics(shape, dtype, shift):
    # the statistics kernel's partial sums, merged, against float64
    # statistics of x: a common offset 13x the spread does not cancel
    _need_cuda()
    x, w, b = _gn_inputs(shape, dtype, shift=shift)
    tgn.group_norm(x, w, b, 32, eps=1e-6)
    torch.cuda.synchronize()
    mean, var = _row_statistics(x, w, b, 32, 1e-6)
    xg = x.double().reshape(shape[0], -1, 32, shape[-1] // 32)
    var64, mean64 = torch.var_mean(xg, dim=(1, 3), unbiased=False)
    assert ((mean - mean64).abs() <= 1e-5 * var64.sqrt()).all()
    assert ((var - var64).abs() <= 1e-5 * var64).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((2, 16 * 128, 128, 320), _BF),
                                         ((1, 1024, 1024, 128), _F32)])
def test_cuda_group_norm_deterministic(shape, dtype):
    _need_cuda()
    x, w, b = _gn_inputs(shape, dtype)
    for silu in (False, True):
        first = tgn.group_norm(x, w, b, 32, eps=1e-6, silu=silu)
        assert torch.equal(first, tgn.group_norm(x, w, b, 32, eps=1e-6,
                                                 silu=silu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [_F32, _BF])
@pytest.mark.parametrize("need", [(True, False, False), (True, True, True)])
@pytest.mark.parametrize("silu", [False, True])
def test_cuda_autograd_through_group_norm(dtype, need, silu):
    # the Function's forward launches the kernels, its backward is the
    # plain formula's vjp from the saved x: the plain autograd's gradients
    _need_cuda()
    ins = _gn_inputs((4, 16, 16, 320), dtype)
    cot = _gn_inputs((4, 16, 16, 320), dtype, seed=1)[0]
    grads = []
    for fn in (tgn.group_norm, tgn.group_norm_reference):
        leaves = [t.clone().requires_grad_(n) for t, n in zip(ins, need)]
        before = tgn.LAUNCHES
        if fn is tgn.group_norm:
            y = fn(*leaves, 32, eps=1e-5, silu=silu)
            assert "_GroupNorm" in type(y.grad_fn).__name__
            assert tgn.LAUNCHES == before + 1
        else:
            y = fn(*leaves, 32, 1e-5, silu)
        grads.append(torch.autograd.grad(
            y, [t for t in leaves if t.requires_grad], cot))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_group_norm_raises_on_what_it_does_not_take():
    _need_cuda()

    def call(x, c=None, groups=32, wdev="cuda"):
        c = x.shape[-1] if c is None else c
        w = torch.ones(c, device=wdev, dtype=x.dtype)
        return tgn.group_norm(x, w, torch.zeros_like(w), groups)

    with pytest.raises(TypeError):
        call(torch.randn(2, 4, 4, 320, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError):
        call(torch.randn(2, 4, 4, 36, device="cuda", dtype=_BF), groups=4)
    with pytest.raises(ValueError):
        call(torch.randn(2, 4, 4, 320, device="cuda"), groups=24)
    with pytest.raises(ValueError):
        call(torch.randn(2, 4, 4, 320, device="cuda"), wdev="cpu")


@pytest.mark.cuda
def test_cuda_group_norm_copies_a_strided_x():
    _need_cuda()
    x, w, b = _gn_inputs((2, 16, 16, 640), _BF)
    view = x[..., :320]
    before = tgn.COPIES
    y = tgn.group_norm(view, w[:320], b[:320], 32, silu=True)
    assert tgn.COPIES == before + 1
    _assert_gn_close(y, tgn.group_norm(view.contiguous(), w[:320], b[:320],
                                       32, silu=True))

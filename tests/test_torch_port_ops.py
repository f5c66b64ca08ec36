"""The PyTorch port's kernel modules against the JAX package.

Each kernel's plain PyTorch version (what a CPU tensor runs) is held
against the JAX function on its Pallas route, which runs in interpret
mode on the CPU, in f32 at 2e-5 (both sides compute exact f32 softmax /
gate math; only the order of the sums differs). The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.ops import flash_attention as jfa
from video_style_transfer_tpu.ops import geglu as jgeglu
from video_style_transfer_tpu.ops import temporal_attention as jta
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import flash_attention as tfa
from video_style_transfer_tpu_torch.ops import geglu as tgeglu
from video_style_transfer_tpu_torch.ops import temporal_attention as tta
from video_style_transfer_tpu_torch.ops.attention import sdpa_fused_qkv

TOL = 2e-5


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture
def no_library(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("CPU call reached the CUDA kernel library")
    monkeypatch.setattr(cuda_build, "library", refuse)


# ------------------------------------------------------------------ K1

def test_flash_qkv_matches_pallas(no_library):
    b, s, h, d = 2, 256, 4, 64
    qkv = _rand(0, (b, s, 3 * h * d))
    want = jfa.flash_attention_qkv(jnp.asarray(qkv), h)
    got = tfa.flash_attention_qkv(_t(qkv), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # the dispatch's forced flash route lands on the same function
    got2 = sdpa_fused_qkv(_t(qkv), h, impl="flash")
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_flash_one_head_d512_matches_pallas(no_library):
    b, s, h, d = 1, 128, 1, 512
    q, k, v = (_rand(i, (b, s, h, d)) for i in range(3))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = tfa.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_flash_kv_tail_online_softmax_matches_pallas(no_library):
    # block_k = 128 at S = 200: two kv blocks, the second one masked —
    # the Pallas route is the online-softmax `_attn_kernel_packed`
    b, s, h, d = 1, 200, 2, 64
    q, k, v = (_rand(10 + i, (b, s, h, d)) for i in range(3))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_k=128)
    got = tfa.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("s,block_k", [(256, 256), (200, 128)])
def test_flash_lse_matches_pallas(no_library, s, block_k):
    b, h, d = 2, 4, 64
    q, k, v = (_rand(20 + i, (b, s, h, d)) for i in range(3))
    scale = d ** -0.5
    _, lse = jfa._flash_fwd_bs_hd(
        *(jnp.asarray(a.reshape(b, s, h * d)) for a in (q, k, v)),
        num_heads=h, scale=scale, block_q=s, block_k=block_k)
    # (B*H/pack, pack, S) -> (B, H, S): head = group*pack + t
    want = np.asarray(lse).reshape(b, h, s)
    _, got = tfa.flash_attention_fwd(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("m,c,inner", [
    (64, 64, 256),
    (200, 72, 384),   # ragged: C and M not multiples of 64, inner of 256
])
def test_geglu_matches_pallas(no_library, m, c, inner):
    assert m % 8 == 0 and jgeglu._pick_block_i(inner, 512) > 0  # kernel
    x = _rand(30, (2, m // 2, c))
    w = _rand(31, (c, 2 * inner), 0.1)
    bias = _rand(32, (2 * inner,), 0.1)
    want = jgeglu.geglu_projection(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(bias))
    got = tgeglu.geglu_projection(_t(x), _t(w.T.copy()), _t(bias))
    assert got.shape == (2, m // 2, inner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_geglu_check_caches_accepted_layouts_only(monkeypatch):
    # K2's wrapper checks an (x, w, b) layout once: a layout the full check
    # accepted is found again by (dtype, device, shape, stride, pointer
    # alignment), with its call's packed layout; any of those changed, or a
    # layout it refused, goes through the full check again
    seen = []

    def full_check(x2d, w, b):
        seen.append((x2d.shape, w.shape, x2d.stride()))
        if x2d.shape[1] == 12:
            raise ValueError("refused")

    monkeypatch.setattr(tgeglu, "_check_layout", full_check)
    monkeypatch.setattr(tgeglu, "_ACCEPTED", {})
    x = torch.zeros(40, 16, dtype=torch.bfloat16)
    w = torch.zeros(64, 16, dtype=torch.bfloat16)
    b = torch.zeros(64, dtype=torch.bfloat16)
    first = tgeglu._check(x, w, b)
    assert first == tgeglu._LAYOUT.pack(-1, 1, 40, 16, 32)
    assert tgeglu._check(x, w, b) is first
    assert len(seen) == 1
    tgeglu._check(x[1:], w, b)                       # other shape, offset
    tgeglu._check(x.float(), w.float(), b.float())  # other dtype
    tgeglu._check(x, w[:32], b[:32])                # other inner
    assert len(seen) == 4
    bad = torch.zeros(40, 12, dtype=torch.bfloat16)
    for _ in range(2):
        with pytest.raises(ValueError):
            tgeglu._check(bad, torch.zeros(64, 12, dtype=torch.bfloat16), b)
    assert len(seen) == 6


def test_geglu_call_packing_matches_c_struct():
    # the wrapper's three packed parts make csrc/geglu.cu's GegluCall:
    # five pointers, then six ints ending in the gate
    import re
    src = (cuda_build.CSRC / "geglu.cu").read_text()
    got = re.search(r"offsetof\(vst::GegluCall, gate\) == (\d+) &&\s*"
                    r"sizeof\(vst::GegluCall\) == (\d+)", src)
    assert got, "geglu.cu states GegluCall's layout"
    head = tgeglu._POINTERS.size + tgeglu._LAYOUT.size
    assert (head, head + 4) == tuple(map(int, got.groups()))
    assert all(len(v) == 4 for v in tgeglu._GATE.values())
    assert set(tgeglu._GATE) == set(tgeglu._GATES)


def test_geglu_gate_is_dtype_gated():
    # erf5 for f32 (cdf3's 2.6e-5 error would break 2e-5 f32 parity),
    # cdf3 for bf16 — the JAX package's `_default_gate_for`
    assert tgeglu._default_gate_for(torch.float32) == "erf5"
    assert jgeglu._default_gate_for(jnp.float32) == "erf5"
    assert tgeglu._default_gate_for(torch.bfloat16) == "cdf3"
    assert jgeglu._default_gate_for(jnp.bfloat16) == "cdf3"


@pytest.mark.parametrize("name,torch_fn,jax_fn", [
    ("cdf3", tgeglu._gelu_cdf3, jgeglu._gelu_cdf3),
    ("erf_as", tgeglu._erf_as, jgeglu._erf_as),
    ("erf5", tgeglu._gelu_exact, jgeglu._gelu_exact),
    ("poly14", tgeglu._gelu_poly14, jgeglu._gelu_poly14),
])
def test_gate_functions_match_jax(name, torch_fn, jax_fn):
    x = np.linspace(-9.0, 9.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(torch_fn(_t(x)).numpy(),
                               np.asarray(jax_fn(jnp.asarray(x))),
                               atol=TOL, rtol=0)


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("f,h,d,n", [(4, 2, 8, 128), (4, 2, 4, 128)])
def test_temporal_attention_matches_jax(no_library, f, h, d, n):
    # d = 8 takes the Pallas kernel (interpret), d = 4 the XLA route
    p = h * d
    q, k, v = (_rand(40 + i, (f, n, p)) for i in range(3))
    frames = lambda a: [jnp.asarray(a[i].T) for i in range(f)]  # (P, N)
    want = jta.temporal_attention_frames(frames(q), frames(k), frames(v),
                                         num_heads=h)
    want = np.stack([np.asarray(o).T for o in want])           # (F, N, P)
    got = tta.temporal_attention(*(_t(a).reshape(f, n, h, d)
                                   for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_temporal_attention_qkv_reads_fused_segments(no_library):
    # the motion module passes strided (F, N, H, d) views of one fused
    # (F, N, 3P) projection
    f, n, h, d = 3, 16, 2, 8
    qkv = _t(_rand(50, (f, n, 3 * h * d)))
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    np.testing.assert_array_equal(
        tta.temporal_attention(q, k, v).numpy(),
        tta.temporal_attention(q.contiguous(), k.contiguous(),
                               v.contiguous()).numpy())


def test_cpu_calls_count_no_launches(no_library):
    before = (tfa.LAUNCHES, tgeglu.LAUNCHES, tta.LAUNCHES)
    x = _t(_rand(60, (1, 8, 2, 64)))
    tfa.flash_attention(x, x, x)
    tgeglu.geglu_projection(_t(_rand(61, (8, 16))), _t(_rand(62, (32, 16))),
                            _t(_rand(63, (32,))))
    tta.temporal_attention(x, x, x)
    assert (tfa.LAUNCHES, tgeglu.LAUNCHES, tta.LAUNCHES) == before


def test_backward_is_refused():
    # the first backward runs (K4's plain version on the CPU); the kernel
    # backward is itself not differentiable, so a second order is refused
    q = _t(_rand(70, (1, 8, 1, 64))).requires_grad_()
    out = tfa.flash_attention(q, q.detach(), q.detach())
    cot = torch.ones_like(out).requires_grad_()
    (g,) = torch.autograd.grad(out, q, grad_outputs=cot, create_graph=True)
    assert torch.isfinite(g).all()
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_ctypes_signatures_match_c_entries():
    # every C entry point's parameter list (from the .cu source) matches
    # the argument types ctypes passes: a mismatch reads the stream
    # pointer from the wrong slot and crashes the process on the card
    import ctypes
    import re
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    seen = set()
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = []
            for p in params.split(","):
                decl = " ".join(p.split()[:-1])
                types.append(ctypes.c_void_p if "*" in p
                             else kinds[decl])
            assert cuda_build.SIGNATURES[name] == types, name
            seen.add(name)
    assert seen == set(cuda_build.SIGNATURES)

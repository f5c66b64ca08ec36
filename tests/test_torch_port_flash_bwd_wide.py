"""K4 at every head dim the forward takes (d = 128-512), and gradients
through the SDXL VAE, against the JAX package.

The JAX flash-attention backward (`_flash_bwd_bhsd`: `_dqkv_kernel`, or
`_dq_kernel` + `_dkv_kernel`) is generic in d; its three `custom_vjp`
entries (BHSD, packed, fused qkv) run here in interpret mode on the CPU.
The port's plain backward (what a CPU tensor runs, and what the card's
D-sliced kernels are held against) must match them, and so must the
gradients of the port's `vae_decode` / `vae_encode` those of `jax.vjp` of
the JAX functions, with the mid-block attention (one head, d = 128 at
this config) on the port's plain attention or on its flash-attention
autograd Function. f32 throughout; 5e-5 (both sides exact f32, only the
order of the sums differs; the VAE's weight gradients, sums over every
pixel, against their own largest entry).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.config import VAEConfig as JVAEConfig
from video_style_transfer_tpu.models import vae as jvae
from video_style_transfer_tpu.ops import flash_attention as jfa
from video_style_transfer_tpu_torch.config import VAEConfig
from video_style_transfer_tpu_torch.models import attention as tattn
from video_style_transfer_tpu_torch.models import vae as tvae
from video_style_transfer_tpu_torch.ops import attention as tops
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import flash_attention as tfa
from video_style_transfer_tpu_torch.utils import convert

BWD_TOL = 5e-5
WIDE_DIMS = (128, 192, 256, 320, 384, 448, 512)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


@pytest.fixture
def no_library(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("CPU call reached the CUDA kernel library")
    monkeypatch.setattr(cuda_build, "library", refuse)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("s,block_k", [(256, None), ((200, 136), 128)],
                         ids=["fused", "split-200x136"])
def test_flash_bwd_wide_plain_matches_jax_vjp(no_library, d, s, block_k):
    # one head, as the VAE: S = 256 takes the fused `_dqkv_kernel` (one kv
    # block); (Sq, Sk) = (200, 136) with 128-row blocks the split
    # `_dq_kernel` + `_dkv_kernel` with q and kv tails. d = 128, 256, 384
    # and 512 reach them through the packed entry, d = 192, 320 and 448
    # (no lane packing) through the BHSD one
    sq, sk = (s, s) if isinstance(s, int) else s
    b, h = 1, 1
    q = _rand(10 + d, (b, sq, h, d))
    k, v = (_rand(11 + d + i, (b, sk, h, d)) for i in range(2))
    g = _rand(13 + d, (b, sq, h, d))
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(
        *a, block_q=None if sq == sk else 128, block_k=block_k),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v))
    got = tfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), out, lse,
                                        _t(g).reshape(b, sq, h * d),
                                        d ** -0.5)
    for gt, w in zip(got, want):
        _close(gt, w, BWD_TOL)
    # the autograd route of a CPU tensor lands on the same plain backward
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (tfa.flash_attention(tq, tk, tv) * _t(g)).sum().backward()
    for gt, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(gt, w, BWD_TOL)


@pytest.mark.parametrize("d,h", [(128, 2), (256, 1)])
def test_flash_qkv_wide_autograd_matches_jax_packed_vjp(no_library, d, h):
    # the fused-qkv entry (`_flash_packed_qkv`, its backward through
    # `_flash_bwd_bhsd`) at S = 200 with 128-row blocks: the port's
    # gradient of the fused projection, q, k and v strided views of it
    s = 200
    qkv = _rand(30 + d, (1, s, 3 * h * d))
    g = _rand(31 + d, (1, s, h * d))
    _, vjp = jax.vjp(lambda x: jfa.flash_attention_qkv(
        x, h, block_q=128, block_k=128), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    tx = _t(qkv, True)
    (tfa.flash_attention_qkv(tx, h) * _t(g)).sum().backward()
    _close(tx.grad, want, BWD_TOL)


# ring stages of the bf16 kernels (dk/dv, dq) at each head dim: as many
# as fit beside the own rows and, with a cluster, the receive buffers
BF16_STAGES = {128: (4, 4), 192: (3, 3), 256: (3, 3), 320: (2, 2),
               384: (2, 2), 448: (2, 3), 512: (2, 3)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_bwd_plan_pins_the_slices(dtype, d):
    # the plan of K4's kernels at d = 128-512 (static_asserted in their
    # CUDA sources); nothing is recomputed (14 flops) at any d. D split
    # across the blocks of a cluster, 128 columns a block (the last 64
    # where D / 64 is odd), which sum their shares of S and dP. bf16: 128
    # own rows a block, 64 streamed rows a tile in both kernels through as
    # many ring stages as fit (at most 4). fp32: 64 own rows, 32 streamed
    # rows a tile through two stages, S and dP on TF32 wgmma, and dV, dK
    # and dQ too as transposed products (P^T, dS^T or dS written hi and lo
    # as their B operand), each streamed tile's lo part copied once into
    # one buffer, 231424 bytes a block
    plan = tfa.bwd_plan(dtype, d)
    bf16 = dtype == torch.bfloat16
    assert plan["route"] == ("wgmma_sliced" if bf16 else "tf32x3_sliced")
    assert plan["split"] == "cluster"
    assert plan["cluster"] == -(-d // 128)
    assert plan["rows"] == (128 if bf16 else 64)
    for kern in ("dkv", "dq"):
        slices = plan["slices"][kern]
        assert [c for c, _ in slices] == list(range(0, d, 128))
        assert sum(w for _, w in slices) == d
        assert all(w == 128 for _, w in slices[:-1])
        assert slices[-1][1] in (64, 128)
        assert all(w % 16 == 0 for _, w in slices)
    if bf16:
        assert plan["stream"] == {"dkv": 64, "dq": 64}
        assert (plan["stages"]["dkv"], plan["stages"]["dq"]) == \
            BF16_STAGES[d]
    else:
        assert plan["stages"] == {"dkv": 2, "dq": 2}
        assert plan["stream"] == {"dkv": 32, "dq": 32}
        # 1 KB of alignment and 1 KB of barriers and rows, the own rows (2
        # x 64 x 128 fp32), two stages of both streamed tensors as landed
        # (2 x 32 x 128 fp32 each), one lo buffer of the same size, P^T /
        # dS^T hi and lo for two warpgroups (2 x 2 x 64 x 32 fp32), 6
        # exchange slots of 2 KB for each of two warpgroups, the P hand-off
        # (4 x 2 KB)
        want = (2048 + 2 * 64 * 128 * 4 + 3 * 2 * 32 * 128 * 4
                + 2 * 2 * 64 * 32 * 4 + 2 * 6 * 2048 + 4 * 2048)
        assert want == 231424 <= 232448
        assert plan["smem"] == {"dkv": want, "dq": want}
        assert plan["wgmma"] == ("S", "dP", "dV", "dK", "dQ")
        assert plan["copies"] == ("lo",)
        assert plan["transposed"] == ("dV", "dK", "dQ")
        assert plan["slots"] == 6
    assert plan["flops"] == 14


def _cluster_columns(dtype, d):
    # block r of the cluster owns columns [128 r, 128 r + 128) of D (the
    # last 64 wide where D / 64 is odd), and each quarter of a streamed
    # tile (bf16: a 16-column k step of 64; fp32: an 8-column n tile of
    # 32) has one owner block, which sums its shares; every block owns at
    # least one, in rank order
    plan = tfa.bwd_plan(dtype, d)
    nc = plan["cluster"]
    assert nc == {128: 1, 192: 2, 256: 2, 320: 3, 384: 3, 448: 4,
                  512: 4}[d]
    assert plan["slices"]["dkv"] == plan["slices"]["dq"] == tuple(
        (128 * r, min(128, d - 128 * r)) for r in range(nc))
    owners = plan["owners"]
    assert len(owners) == 4 and list(owners) == sorted(owners)
    assert set(owners) == set(range(nc))


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_bwd_plan_splits_the_cluster_columns(d):
    _cluster_columns(torch.bfloat16, d)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_bwd_plan_splits_the_fp32_cluster_columns(d):
    _cluster_columns(torch.float32, d)


@pytest.mark.parametrize("cluster", [2, 3, 4])
def test_exchange_slots_receive_every_share_once(cluster):
    # fp32's exchange (csrc/flash_attention_bwd_sliced_tf32.cu's
    # fs_r1_slot / fs_r2_slot): every n tile of a streamed tile has
    # exactly one owner; each block receives, in distinct slots of its 6,
    # every other block's share of each n tile it owns (round 1) and the
    # sum of each n tile it does not own (round 2), and nothing else
    owners = tfa.TILE_OWNERS[cluster - 1]
    slots = tfa.exchange_slots(cluster)
    assert sorted(slots) == list(range(cluster))
    for r, got in slots.items():
        want = {("share", s, j) for j in range(4) if owners[j] == r
                for s in range(cluster) if s != r}
        want |= {("sum", j) for j in range(4) if owners[j] != r}
        assert set(got) == want
        assert len(set(got.values())) == len(got)
        assert set(got.values()) == set(range(len(got)))
        assert len(got) <= tfa.TF32_SLICED_SLOTS
    # the values the CUDA source static_asserts
    if cluster == 3:
        assert slots[0][("share", 2, 1)] == 3 and slots[1][("sum", 3)] == 4
        assert [len(slots[r]) for r in range(3)] == [6, 5, 5]
    if cluster == 4:
        assert slots[0][("sum", 1)] == 3 and slots[3][("share", 0, 3)] == 0


def test_bwd_plan_values_at_the_vae_head():
    # d = 512 (the VAE's head): bf16 is a cluster of four blocks, one k
    # step each, its dk/dv kernel keeping 2 ring stages and its dq kernel 3
    # beside their receive buffers; fp32 is a cluster of four blocks too,
    # one n tile each, 32 streamed rows a tile beside its 64 own rows, 128
    # columns a block (at every d; one block at d = 128); both do 14 * Sq
    # * Sk * D flops, as at every d
    bf, f32 = (tfa.bwd_plan(dt, 512) for dt in (torch.bfloat16,
                                                torch.float32))
    assert bf["cluster"] == 4 and bf["owners"] == (0, 1, 2, 3)
    assert bf["stages"] == {"dkv": 2, "dq": 3}
    assert tfa.bwd_plan(torch.bfloat16, 448)["stages"] == {"dkv": 2, "dq": 3}
    assert (bf["flops"], f32["flops"]) == (14, 14)
    assert tfa.bwd_plan(torch.bfloat16, 128)["flops"] == 14
    assert tfa.bwd_plan(torch.bfloat16, 128)["cluster"] == 1
    assert f32["cluster"] == 4 and f32["owners"] == (0, 1, 2, 3)
    assert f32["stream"]["dq"] == 32 and f32["slices"]["dq"][1] == (128, 128)
    assert [tfa.bwd_plan(torch.float32, d)["stream"]["dkv"]
            for d in WIDE_DIMS] == [32] * 7
    assert [tfa.bwd_plan(torch.float32, d)["rows"]
            for d in WIDE_DIMS] == [64] * 7
    assert tfa.bwd_plan(torch.float32, 128)["cluster"] == 1
    assert tfa.bwd_plan(torch.float32, 192)["slices"]["dkv"] == (
        (0, 128), (128, 64))
    for d in (64, 96, 576):
        with pytest.raises(ValueError):
            tfa.bwd_plan(torch.float32, d)
    with pytest.raises(TypeError):
        tfa.bwd_plan(torch.float16, 128)


def _vae_cfgs():
    # a tiny VAE whose mid block has 128 channels: its attention is one
    # head at d = 128, 64 tokens at an 8x8 latent
    kw = dict(block_out_channels=(16, 128))
    return JVAEConfig.tiny(**kw), VAEConfig.tiny(**kw)


def _flash_on_cpu(monkeypatch):
    """Route the port's fused self-attention through the flash-attention
    autograd Function on the CPU (its plain forward and backward), as a
    CUDA tensor takes it to K1 and K4."""
    monkeypatch.setattr(tattn, "sdpa_fused_qkv",
                        lambda qkv, heads: tops.sdpa_fused_qkv(
                            qkv, heads, impl="flash"))


def _mid_attention(tree, side):
    return tree[side]["mid_block"]["attentions"][0]


@functools.lru_cache(maxsize=None)
def _jax_vae_grads(side):
    """The JAX side of one VAE gradient check, once a test process: the
    parameters, the input, the cotangent, and jax.vjp's gradients of the
    input and of the mid attention's tensors (converted to the port's
    layout)."""
    jcfg, _ = _vae_cfgs()
    jp = jax.jit(lambda k: jvae.init_vae(k, jcfg))(jax.random.PRNGKey(3))
    if side == "decoder":
        x, cot = _rand(40, (1, 8, 8, 4)), _rand(41, (1, 16, 16, 3))
        jfn = lambda p, a: jvae.vae_decode(p, jcfg, a)  # noqa: E731
        conv = convert.convert_vae_decoder
    else:
        x, cot = _rand(42, (1, 16, 16, 3), 0.5), _rand(43, (1, 8, 8, 4))
        jfn = lambda p, a: jvae.vae_encode(p, jcfg, a)  # noqa: E731
        conv = convert.convert_vae_encoder
    gp, gx = jax.jit(lambda p, a, c: jax.vjp(jfn, p, a)[1](c))(
        jp, jnp.asarray(x), jnp.asarray(cot))
    return jp, x, cot, _mid_attention(conv(gp), side), np.asarray(gx)


def _vae_grads_check(side, route, monkeypatch):
    _, tcfg = _vae_cfgs()
    jp, x, cot, want_attn, gx = _jax_vae_grads(side)
    if side == "decoder":
        tp, tfn = convert.convert_vae_decoder(jp), tvae.vae_decode
    else:
        tp, tfn = convert.convert_vae_encoder(jp), tvae.vae_encode
    if route == "flash":
        _flash_on_cpu(monkeypatch)
    calls = []
    real_bwd = tfa.flash_attention_bwd_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real_bwd(*a, **kw)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", counted)
    attn = _mid_attention(tp, side)
    leaves = {}
    for name, sub in attn.items():
        for leaf, t in sub.items():
            sub[leaf] = leaves[(name, leaf)] = t.clone().requires_grad_()
    tx = _t(x, True)
    out = tfn(tp, tcfg, tx)
    assert out.shape == cot.shape
    (out * _t(cot)).sum().backward()
    # the flash route's backward ran once, at the mid attention's head
    assert calls == ([(1, 64, 1, 128)] if route == "flash" else [])
    _close(tx.grad, gx, BWD_TOL)
    assert len(leaves) >= 8  # q, k, v, out projections and the norm
    for (name, leaf), t in leaves.items():
        want = np.asarray(want_attn[name][leaf])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(t.grad.numpy() / scale, want / scale,
                                   atol=BWD_TOL, rtol=0,
                                   err_msg=f"{name}.{leaf}")


@pytest.mark.parametrize("route", ["plain", "flash"])
@pytest.mark.parametrize("side", ["decoder", "encoder"])
def test_vae_grads_match_jax_vjp(no_library, monkeypatch, side, route):
    # torch.autograd through the port's vae_decode (w.r.t. the latents) and
    # vae_encode (w.r.t. the image), and w.r.t. every tensor of the mid
    # block's attention, against jax.vjp of the JAX functions; the port's
    # mid attention on its plain route (what a CPU tensor takes) and on the
    # flash-attention autograd Function (K1 and K4 on the card)
    _vae_grads_check(side, route, monkeypatch)

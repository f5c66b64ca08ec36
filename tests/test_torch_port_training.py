"""The PyTorch port's stage-2 training slice against the JAX package.

Everything runs in f32 on the CPU from the same numpy or JAX draws; the
JAX side reaches its Pallas kernels in interpret mode. Tolerances:
- kernel backward plain versions (K4 flash attention, K5 temporal
  attention, the GEGLU manual backward) 5e-5: exact f32 math on both
  sides, only the order of the sums differs (dk/dv sum over every query
  row);
- the stage-2 loss rtol 1e-5, every trainable gradient rtol 1e-4 / atol
  1e-6 (f32 round-off compounds through the UNet's forward and backward),
  two optimizer updates 1e-6.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.config import VAEConfig as JVAEConfig
from video_style_transfer_tpu.lora import surgery as jsurgery
from video_style_transfer_tpu.lora import temporal as jtemporal
from video_style_transfer_tpu.lora import unzip as junzip
from video_style_transfer_tpu.models import layers as jlayers
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu.models import vae as jvae
from video_style_transfer_tpu.ops import flash_attention as jfa
from video_style_transfer_tpu.ops import geglu as jgeglu
from video_style_transfer_tpu.ops import temporal_attention as jta
from video_style_transfer_tpu.schedulers import ddpm as jddpm
from video_style_transfer_tpu.training import schedules as jschedules
from video_style_transfer_tpu.training import stage2 as jstage2
from video_style_transfer_tpu_torch.cli import train_animatediff
from video_style_transfer_tpu_torch.config import UNetConfig, VAEConfig
from video_style_transfer_tpu_torch.lora import surgery as tsurgery
from video_style_transfer_tpu_torch.lora import temporal as ttemporal
from video_style_transfer_tpu_torch.lora import unzip as tunzip
from video_style_transfer_tpu_torch.models import layers as tlayers
from video_style_transfer_tpu_torch.models import vae as tvae
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import flash_attention as tfa
from video_style_transfer_tpu_torch.ops import geglu as tgeglu
from video_style_transfer_tpu_torch.ops import temporal_attention as tta
from video_style_transfer_tpu_torch.schedulers import ddpm as tddpm
from video_style_transfer_tpu_torch.training import schedules as tschedules
from video_style_transfer_tpu_torch.training import stage2 as tstage2
from video_style_transfer_tpu_torch.utils import convert
from video_style_transfer_tpu_torch.utils import motion_convert as tmotion

BWD_TOL = 5e-5


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


# ------------------------------------------------------- fault repairs

def test_group_norm_grads_match_jax():
    x = _rand(0, (2, 4, 4, 16))
    w = 1.0 + _rand(1, (16,), 0.1)
    b = _rand(2, (16,), 0.1)
    cot = _rand(3, (2, 4, 4, 16))

    def jloss(x_, w_, b_):
        y = jlayers.group_norm({"scale": w_, "bias": b_}, x_, num_groups=4)
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    y = tlayers.group_norm({"weight": tw, "bias": tb}, tx, num_groups=4)
    (y * _t(cot)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        _close(got, ref, 2e-5)


def test_group_norm_keeps_one_pass_form_without_grad(monkeypatch):
    calls = []
    real = torch.addcmul

    def spy(*args, **kw):
        calls.append("out" in kw)
        return real(*args, **kw)

    monkeypatch.setattr(torch, "addcmul", spy)
    p = {"weight": _t(np.ones(16)), "bias": _t(np.zeros(16))}
    x = _t(_rand(4, (2, 4, 4, 16)))
    with torch.inference_mode():
        a = tlayers.group_norm(p, x, num_groups=4)
    b = tlayers.group_norm(p, x.requires_grad_(), num_groups=4)
    assert calls == [True, False]
    assert b.grad_fn is not None
    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("s,block_k", [
    (256, None), (200, 128),
    pytest.param((200, 136), 128, id="200x136-128")])
def test_flash_bwd_plain_matches_jax_vjp(no_library, s, block_k):
    # S = 256: one kv block, the fused `_dqkv_kernel`; S = 200 with
    # block_k = 128: the split `_dq_kernel` + `_dkv_kernel` with a masked
    # kv tail; (Sq, Sk) = (200, 136): the split kernels at Sq != Sk, tails
    # in both (block_q 128)
    sq, sk = (s, s) if isinstance(s, int) else s
    b, h, d = 1, 2, 64
    q = _rand(10, (b, sq, h, d))
    k, v = (_rand(11 + i, (b, sk, h, d)) for i in range(2))
    g = _rand(13, (b, sq, h, d))
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(
        *a, block_q=None if sq == sk else 128, block_k=block_k),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    scale = d ** -0.5
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v))
    got = tfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), out, lse,
                                        _t(g).reshape(b, sq, h * d), scale)
    for gt, w in zip(got, want):
        _close(gt, w, BWD_TOL)
    # the autograd route of a CPU tensor lands on the same plain backward
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (tfa.flash_attention(tq, tk, tv) * _t(g)).sum().backward()
    for gt, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(gt, w, BWD_TOL)


def test_flash_d192_matches_jax_bhsd_route(no_library):
    # d = 192 cannot pack heads into the TPU's 128 lanes (`_packable`
    # fails), so the JAX package takes `_flash_bhsd` (the `_attn_kernel`
    # Pallas kernel, K6); the port's K1 covers it as an instance
    b, s, h, d = 1, 128, 2, 192
    assert not jfa._packable(h, d)
    q, k, v = (_rand(20 + i, (b, s, h, d)) for i in range(3))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = tfa.flash_attention(_t(q), _t(k), _t(v))
    _close(got, want, 2e-5)


# ------------------------------------------------------------------ K5

@pytest.mark.parametrize("f,n", [(4, 128), (2, 128), (32, 16)])
def test_temporal_bwd_plain_matches_jax_vjp(no_library, f, n):
    # d = 8 takes the Pallas route (`_bwd_kernel` in interpret mode) at 2
    # and 4 frames; at 32 frames, the most K3 and K5 take, its 1024
    # unrolled steps take minutes to interpret, so the JAX side is the vjp
    # of its XLA reference (`impl="xla"`), the same function
    h, d = 2, 8
    p = h * d
    q, k, v = (_rand(30 + i, (f, n, p)) for i in range(3))
    g = _rand(33, (f, n, p))
    frames = lambda a: [jnp.asarray(a[i].T) for i in range(f)]  # noqa
    impl = "xla" if f == 32 else "auto"
    _, vjp = jax.vjp(
        lambda *a: list(jta.temporal_attention_frames(*a, num_heads=h,
                                                      impl=impl)),
        frames(q), frames(k), frames(v))
    want = [np.stack([np.asarray(x).T for x in dx])
            for dx in vjp(frames(g))]                    # (F, N, P) each
    tq, tk, tv = (_t(a).reshape(f, n, h, d).requires_grad_()
                  for a in (q, k, v))
    (tta.temporal_attention(tq, tk, tv) * _t(g)).sum().backward()
    for gt, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(gt.reshape(f, n, p), w, BWD_TOL)
    plain = tta.temporal_attention_bwd_plain(
        *(_t(a).reshape(f, n, h, d) for a in (q, k, v)), _t(g), d ** -0.5)
    for gt, w in zip(plain, want):
        _close(gt.reshape(f, n, p), w, BWD_TOL)


# ---------------------------------------------------------------- GEGLU

def test_geglu_bwd_matches_jax_vjp(no_library):
    m, c, inner = 64, 64, 256
    assert m % 8 == 0 and jgeglu._pick_block_i(inner, 512) > 0  # kernel
    x = _rand(40, (m, c))
    w = _rand(41, (c, 2 * inner), 0.1)
    bias = _rand(42, (2 * inner,), 0.1)
    g = _rand(43, (m, inner))
    _, vjp = jax.vjp(jgeglu.geglu_projection, *map(jnp.asarray, (x, w, bias)))
    dx, dw, db = vjp(jnp.asarray(g))
    tx, tw, tb = _t(x, True), _t(w.T.copy(), True), _t(bias, True)
    (tgeglu.geglu_projection(tx, tw, tb) * _t(g)).sum().backward()
    _close(tx.grad, dx, BWD_TOL)
    _close(tw.grad, np.asarray(dw).T, BWD_TOL)
    _close(tb.grad, db, BWD_TOL)
    # a frozen projection asks for dx only
    tx2 = _t(x, True)
    tw2, tb2 = _t(w.T.copy()), _t(bias)
    (tgeglu.geglu_projection(tx2, tw2, tb2) * _t(g)).sum().backward()
    _close(tx2.grad, dx, BWD_TOL)
    assert tw2.grad is None and tb2.grad is None


# ------------------------------------------------------------- LoRA

def _unzip_pair(in_f, out_f, rank=4):
    """JAX UnZipLoRA params and a state with a live mask and an off
    branch, both sides."""
    jp = junzip.init_unzip_lora_params(jax.random.PRNGKey(5), in_f, out_f,
                                       rank=rank)
    jp = dict(jp, merge_content=jnp.asarray(_rand(6, (out_f,)) + 1.0),
              merge_style=jnp.asarray(_rand(7, (out_f,)) + 1.0))
    js = junzip.init_unzip_lora_state(out_f)
    mask = np.random.default_rng(8).random(out_f) < 0.5
    js = dict(js, mask_content=jnp.asarray(mask),
              use_mask_content=jnp.asarray(True))
    return jp, js, convert.convert_tree(jp), convert.convert_lora_state(js)


@pytest.mark.parametrize("mode", ["base", "both", "content", "style"])
def test_dual_linear_matches_jax(mode):
    in_f, out_f = 24, 40
    jl, js, tl, ts = _unzip_pair(in_f, out_f)
    kern = _rand(9, (in_f, out_f), 0.2)
    bias = _rand(10, (out_f,), 0.1)
    x, xc, xs = (_rand(11 + i, (3, 5, in_f)) for i in range(3))
    jp = {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias), "lora": jl}
    tp = {"weight": _t(kern.T.copy()), "bias": _t(bias), "lora": tl}
    want = junzip.dual_linear(jp, *map(jnp.asarray, (x, xc, xs)), mode=mode,
                              state=js)
    got = tunzip.dual_linear(tp, _t(x), _t(xc), _t(xs), mode=mode, state=ts)
    _close(got, want, 2e-5)


def test_orthogonality_loss_matches_jax():
    jl, _, tl, _ = _unzip_pair(32, 48)
    jt = jtemporal.init_temporal_lora(jax.random.PRNGKey(12), 32, 48, rank=8,
                                      alpha=2.0)
    jt = dict(jt, b=jnp.asarray(_rand(13, (8, 48), 0.1)))
    tt = convert.convert_tree(jt)
    want = float(jtemporal.orthogonality_loss(jt, jl))
    got = float(ttemporal.orthogonality_loss(tt, tl))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close(ttemporal.temporal_delta(tt), jtemporal.temporal_delta(jt), 1e-6)


def _expand(path, k):
    """A JAX stacked path -> the port's per-layer path for layer k."""
    i = path.index("transformer_blocks")
    return path[:i + 1] + (k,) + path[i + 1:]


@pytest.fixture(scope="module")
def lora_unet():
    cfg = JUNetConfig.tiny(use_motion_modules=True)
    jp = junet.init_unet(jax.random.PRNGKey(0), cfg)
    jp, jstate = jsurgery.insert_unziplora(jp, jax.random.PRNGKey(1), rank=4)
    jp = jsurgery.insert_temporal_lora(jp, jax.random.PRNGKey(2), rank=4)
    # nonzero temporal-LoRA b, so a gets gradients and the orthogonality
    # term is live
    rng = np.random.default_rng(3)
    for path in jsurgery.iter_motion_attention_paths(jp):
        for proj in jsurgery.PROJS:
            tl = jsurgery.tree_get(jp, path + (proj, "tlora"))
            tl = dict(tl, b=jnp.asarray(
                rng.standard_normal(tl["b"].shape).astype(np.float32) * 0.05))
            jp = jsurgery.tree_set(jp, path + (proj, "tlora"), tl)
    return cfg, jp, jstate


def test_spatial_pairs_match_jax(lora_unet):
    _, jp, _ = lora_unet
    want = sorted((_expand(tp, k), _expand(sp, k))
                  for tp, sp, n in jsurgery.spatial_pairs(jp)
                  for k in range(n))
    got = sorted(tsurgery.spatial_pairs(convert.convert_tree(jp)))
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("kw", [{}, {"train_mergers": True},
                                {"train_full_motion": True}])
def test_trainable_set_matches_jax(lora_unet, kw):
    _, jp, _ = lora_unet
    jmask = jstage2.trainable_mask(jp, **kw)
    jl = [(m, np.asarray(x).size) for m, x in zip(jax.tree.leaves(jmask),
                                                  jax.tree.leaves(jp))]
    tp = convert.convert_tree(jp)
    tmask = tstage2.trainable_mask(tp, **kw)
    flags = dict(tstage2.iter_leaves(tmask))
    tl = [(flags[p], t.numel()) for p, t in tstage2.iter_leaves(tp)]
    # the tiny stacks hold one layer each, so the leaf counts compare
    assert sum(m for m, _ in tl) == sum(bool(m) for m, _ in jl)
    assert sum(n for m, n in tl if m) == sum(n for m, n in jl if m)


# ------------------------------------------------------------ stage 2

LAMBDA_ORTH = 0.1
CFG_DROPOUT = 0.5


def _jax_batch(cfg):
    b, f = 1, 2
    pooled_dim = (cfg.projection_class_embeddings_input_dim
                  - 6 * cfg.addition_time_embed_dim)
    return {
        "latents": _rand(50, (b, f, 8, 8, 4)),
        "ctx": _rand(51, (b, 7, cfg.cross_attention_dim)),
        "pooled": _rand(52, (b, pooled_dim)),
        "uncond_ctx": _rand(53, (b, 7, cfg.cross_attention_dim)),
        "uncond_pooled": _rand(54, (b, pooled_dim)),
        "time_ids": np.float32([[16, 16, 0, 0, 16, 16]]),
    }


def _jax_draws(key, latents_shape):
    """stage2_loss's own draws, as it takes them."""
    k_t, k_n, k_d = jax.random.split(key, 3)
    b = latents_shape[0]
    return {
        "t": torch.from_numpy(np.array(jax.random.randint(
            k_t, (b,), 0, 1000))).long(),
        "noise": _t(jax.random.normal(k_n, latents_shape, jnp.float32)),
        "drop": torch.from_numpy(np.asarray(jax.random.bernoulli(
            k_d, CFG_DROPOUT, (b, 1, 1))).reshape(b).copy()),
    }


def _port_setup(jp, jstate, cfg):
    tp = convert.convert_tree(jp)
    ts = convert.convert_lora_state(jstate)
    trainable = tstage2.split_trainable(tp, tstage2.trainable_mask(tp))
    return tp, ts, trainable


@pytest.fixture(scope="module")
def stage2_case(lora_unet):
    cfg, jp, jstate = lora_unet
    sched = jddpm.make_schedule()
    batch = _jax_batch(cfg)
    key = jax.random.PRNGKey(7)
    pairs = jsurgery.spatial_pairs(jp)
    mask = jstage2.trainable_mask(jp)
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    mleaves = jax.tree_util.tree_leaves(mask)

    def loss_fn(train_list):
        it = iter(train_list)
        full = [next(it) if m else jax.lax.stop_gradient(l)
                for l, m in zip(leaves, mleaves)]
        p = jax.tree_util.tree_unflatten(treedef, full)
        return jstage2.stage2_loss(
            p, cfg, sched, jax.tree.map(jnp.asarray, batch), key,
            pairs=pairs, lambda_orth=LAMBDA_ORTH, cfg_dropout=CFG_DROPOUT,
            mode="both", state=jstate, remat=False)

    (loss, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        [l for l, m in zip(leaves, mleaves) if m])
    it = iter(g)
    gfull = jax.tree_util.tree_unflatten(
        treedef, [next(it) if m else jnp.zeros_like(l)
                  for l, m in zip(leaves, mleaves)])
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "grads": convert.convert_tree(gfull),
            "draws": _jax_draws(key, batch["latents"].shape),
            "batch": {k: _t(v) for k, v in batch.items()}}


def _port_loss(lora_unet, stage2_case, remat=False):
    cfg, jp, jstate = lora_unet
    tp, ts, trainable = _port_setup(jp, jstate, cfg)
    loss, aux = tstage2.stage2_loss(
        tp, UNetConfig.tiny(use_motion_modules=True), tddpm.make_schedule(),
        stage2_case["batch"], stage2_case["draws"],
        pairs=tsurgery.spatial_pairs(tp), lambda_orth=LAMBDA_ORTH,
        mode="both", state=ts, remat=remat)
    loss.backward()
    return loss, aux, tp, trainable


def test_stage2_loss_matches_jax(lora_unet, stage2_case):
    loss, aux, _, _ = _port_loss(lora_unet, stage2_case)
    np.testing.assert_allclose(loss.item(), stage2_case["loss"], rtol=1e-5)
    for k in ("loss_mse", "loss_orth"):
        np.testing.assert_allclose(aux[k].item(), stage2_case["aux"][k],
                                   rtol=1e-5)
    assert stage2_case["aux"]["loss_orth"] > 0


def test_stage2_grads_match_jax(lora_unet, stage2_case):
    _, _, _, trainable = _port_loss(lora_unet, stage2_case)
    assert len(trainable) > 0
    for path, t in trainable:
        want = tsurgery.tree_get(stage2_case["grads"], path)
        np.testing.assert_allclose(t.grad.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


def test_stage2_remat_grads_equal(lora_unet, stage2_case):
    _, _, _, ref = _port_loss(lora_unet, stage2_case)
    _, _, _, tr = _port_loss(lora_unet, stage2_case, remat=True)
    for (path, a), (_, b) in zip(ref, tr):
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0,
                                   msg=str(path))


def test_stage2_optimizer_two_steps_match_optax(lora_unet, stage2_case):
    # make_optimizer's multi_transform hands the clip + AdamW chain only
    # the trainable leaves, so the JAX side runs on those leaves alone
    cfg, jp, jstate = lora_unet
    _, _, trainable = _port_setup(jp, jstate, cfg)
    paths = [path for path, _ in trainable]
    tg = [tsurgery.tree_get(stage2_case["grads"], p) for p in paths]
    jparams = [jnp.asarray(t.detach().numpy()) for _, t in trainable]
    norm = float(np.sqrt(sum(float((g * g).sum()) for g in tg)))
    # the first step's gradients stay under max_grad_norm, the second's
    # (twice as large) are clipped; warmup 1: the first update has LR 0
    kw = dict(lr=1e-3, total_steps=4, warmup=1, max_grad_norm=1.5 * norm)
    jopt = jstage2.make_optimizer([True] * len(jparams), **kw)
    jst = jopt.init(jparams)
    topt = tstage2.make_optimizer([t for _, t in trainable], **kw)
    for scale in (1.0, 2.0):
        updates, jst = jax.jit(jopt.update)([jnp.asarray(g.numpy()) * scale
                                    for g in tg], jst, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        topt.step([g * scale for g in tg])
        for path, (_, t), want in zip(paths, trainable, jparams):
            np.testing.assert_allclose(
                t.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0,
                err_msg=f"scale {scale} {path}")


def test_stage2_frozen_params_bitwise_unchanged(lora_unet, stage2_case):
    cfg, jp, jstate = lora_unet
    tp, ts, trainable = _port_setup(jp, jstate, cfg)
    before = {p: t.clone() for p, t in tstage2.iter_leaves(tp)}
    opt = tstage2.make_optimizer([t for _, t in trainable], lr=1e-3,
                                 total_steps=4, warmup=0)
    step = tstage2.make_train_step(
        UNetConfig.tiny(use_motion_modules=True), tddpm.make_schedule(), opt,
        tsurgery.spatial_pairs(tp), lambda_orth=LAMBDA_ORTH,
        cfg_dropout=CFG_DROPOUT, lora_state=ts)
    metrics = step(tp, [stage2_case["batch"]], torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    names = {p for p, _ in trainable}
    moved = 0
    for path, t in tstage2.iter_leaves(tp):
        if path in names:
            moved += not torch.equal(t, before[path])
        else:
            assert torch.equal(t, before[path]), path
            assert t.grad is None
    assert moved == len(names)


def test_stage2_grad_accum_averages_micro_batches(lora_unet, stage2_case):
    # two micro-batches: one update from the mean of their gradients,
    # each with its own draws in generator order
    cfg, jp, jstate = lora_unet
    tcfg, sched = UNetConfig.tiny(use_motion_modules=True), \
        tddpm.make_schedule()
    b1 = stage2_case["batch"]
    b2 = dict(b1, latents=b1["latents"].flip(1))
    kw = dict(lr=1e-3, total_steps=4, warmup=0)
    tp, ts, trainable = _port_setup(jp, jstate, cfg)
    step = tstage2.make_train_step(
        tcfg, sched, tstage2.make_optimizer([t for _, t in trainable], **kw),
        tsurgery.spatial_pairs(tp), lambda_orth=LAMBDA_ORTH,
        cfg_dropout=CFG_DROPOUT, lora_state=ts)
    step(tp, [b1, b2], torch.Generator().manual_seed(0))

    rp, rs, rtrain = _port_setup(jp, jstate, cfg)
    gen = torch.Generator().manual_seed(0)
    grads = None
    for mb in (b1, b2):
        dr = tstage2.draw_stage2(sched, tuple(mb["latents"].shape),
                                 cfg_dropout=CFG_DROPOUT, generator=gen,
                                 device="cpu")
        loss, _ = tstage2.stage2_loss(
            rp, tcfg, sched, mb, dr, pairs=tsurgery.spatial_pairs(rp),
            lambda_orth=LAMBDA_ORTH, mode="both", state=rs)
        g = torch.autograd.grad(loss, [t for _, t in rtrain])
        grads = g if grads is None else [a + c for a, c in zip(grads, g)]
    tstage2.make_optimizer([t for _, t in rtrain], **kw).step(
        [g / 2 for g in grads])
    for (path, a), (_, ref) in zip(trainable, rtrain):
        torch.testing.assert_close(a, ref, rtol=0, atol=1e-7,
                                   msg=str(path))


# ------------------------------------------------- VAE, DDPM, schedules

def test_vae_encode_matches_jax():
    jcfg, tcfg = JVAEConfig.tiny(), VAEConfig.tiny()
    jp = jax.jit(lambda k: jvae.init_vae(k, jcfg))(jax.random.PRNGKey(2))
    tp = convert.convert_vae_encoder(jp)
    x = np.clip(_rand(60, (2, 16, 16, 3)), -1, 1)
    eps = _rand(61, (2, 8, 8, 4))
    mean, logvar = jax.jit(lambda p, a: jvae.vae_encode_moments(
        p, jcfg, a))(jp, jnp.asarray(x))
    tmean, tlogvar = tvae.vae_encode_moments(tp, tcfg, _t(x))
    _close(tmean, mean, 1e-4)
    _close(tlogvar, logvar, 1e-4)
    want = (np.asarray(mean) + np.exp(0.5 * np.asarray(logvar)) * eps) \
        * jcfg.scaling_factor
    _close(tvae.vae_encode(tp, tcfg, _t(x), _t(eps)), want, 1e-4)


def test_add_noise_and_velocity_match_jax():
    s = jddpm.make_schedule()
    x0, noise = _rand(70, (3, 4, 4, 4)), _rand(71, (3, 4, 4, 4))
    t = np.array([0, 500, 999])
    for jfn, tfn in ((jddpm.add_noise, tddpm.add_noise),
                     (jddpm.velocity_target, tddpm.velocity_target)):
        want = jfn(s, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        got = tfn(tddpm.make_schedule(), _t(x0), _t(noise),
                  torch.from_numpy(t))
        _close(got, want, 1e-6)


@pytest.mark.parametrize("name", jschedules.NAMES)
def test_lr_schedules_match_jax(name):
    kw = dict(warmup=3, total_steps=10, num_cycles=2, power=2.0)
    jf = jschedules.make_lr_schedule(name, 1e-3, **kw)
    tf = tschedules.make_lr_schedule(name, 1e-3, **kw)
    steps = range(0, 13)
    np.testing.assert_allclose([tf(s) for s in steps],
                               [float(jf(s)) for s in steps], rtol=1e-5,
                               atol=1e-12)
    if name != "constant":
        assert tf(0) == 0.0  # warmup: the first update has LR 0


# ------------------------------------------------------------------ CLI

def test_train_cli_smoke_cpu(tmp_path):
    path = train_animatediff.main([
        "--smoke", "--device", "cpu", "--prompt", "a horse",
        "--max_train_steps", "2", "--lr_warmup_steps", "0",
        "--output_dir", str(tmp_path)])
    # the motion checkpoint that cli.infer_video --motion_checkpoint reads
    assert path == str(tmp_path / "motion_modules.safetensors")
    saved = tmotion.load_motion_checkpoint(str(tmp_path))
    assert saved and all(np.isfinite(v).all() for v in saved.values())
    assert all("motion_modules" in k and "tlora" not in k for k in saved)


@pytest.mark.parametrize("flag,value", [
    ("--video_dir", "clips"), ("--motion_adapter_path", "m.safetensors"),
    ("--resume_from_checkpoint", "latest"), ("--optimizer", "adamw8bit"),
    ("--unziplora_name_or_path", "stage1"), ("--data_parallel", "2")])
def test_train_cli_refuses_unported(tmp_path, flag, value):
    args = train_animatediff.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--prompt", "a horse",
         "--max_train_steps", "1", "--output_dir", str(tmp_path), flag,
         value])
    # the loaders have landed: their flags now look for the files
    expect = {"--motion_adapter_path": (FileNotFoundError,
                                        "no motion checkpoint"),
              "--unziplora_name_or_path": (FileNotFoundError, "stage1"),
              "--data_parallel": (SystemExit, "needs 2 processes")}
    if flag in expect:
        exc, match = expect[flag]
        with pytest.raises(exc, match=match):
            train_animatediff.train(args)
        return
    # the dataset, resume and 8-bit AdamW have landed, with the JAX CLI's
    # behaviour: under --smoke a video directory without videos falls
    # back to synthetic clips, `latest` without a checkpoint starts
    # afresh, and adamw8bit trains
    report = {}
    tr = train_animatediff.train(args, report)
    assert len(report["loss"]) == 1 and np.isfinite(report["loss"][0])
    assert tr.dataset is None and tr.start == 0
    assert tr.resumed_from is None
    assert tr.optimizer.kind == (value if flag == "--optimizer"
                                 else "adamw")

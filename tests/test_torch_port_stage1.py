"""The PyTorch port's stage-1 trainer against the JAX package, on the
CPU in f32 at the tiny UNet without motion modules, the weights carried
across by the converter and every draw made from a seed.

- cone_columns and select_columns: equal (the port computes the cone
  in float64 from the f32 factors; the scores of these inputs are the
  same counts), select_columns on scores full of ties; mergers_similarity
  within one f32 ulp (a mean summed in another order);
- the block-separation tables and layer assignments: equal;
- make_train_step over every phase (reset, sampling, select, zeroout,
  tail), with --with_finetune_mask off at one micro-batch with both
  priors (its losses and gradients are the stage1_loss checks) and on at
  two micro-batches (against JAX's scan): at each step the loss and its
  parts rtol 1e-4 and the port's own gradients within rtol 1e-4 / atol
  1e-6 of JAX's, then, from JAX's gradients, every mask, score and flag
  equal and every LoRA leaf within 1e-6;
- the three-group optimizer (adamw, adamw8bit, prodigy) against JAX's
  make_optimizer, with the clip engaged; and both stage-2 optimizers and
  the three-group one on bf16 leaves.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from video_style_transfer_tpu.cli import train_unziplora as jcli
from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.lora import surgery as jsurgery
from video_style_transfer_tpu.lora import unzip as junzip
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu.schedulers import ddpm as jddpm
from video_style_transfer_tpu.training import stage1 as jstage1
from video_style_transfer_tpu.training import stage2 as jstage2
from video_style_transfer_tpu_torch.config import UNetConfig
from video_style_transfer_tpu_torch.lora import surgery as tsurgery
from video_style_transfer_tpu_torch.lora import unzip as tunzip
from video_style_transfer_tpu_torch.models.layers import MetaInit
from video_style_transfer_tpu_torch.models.unet import init_unet
from video_style_transfer_tpu_torch.schedulers import ddpm as tddpm
from video_style_transfer_tpu_torch.training import stage1 as tstage1
from video_style_transfer_tpu_torch.training import stage2 as tstage2
from video_style_transfer_tpu_torch.training.prodigy import Prodigy
from video_style_transfer_tpu_torch.utils import convert

OPT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny trainer's ops are too small to share among threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _collapse(path):
    """A port per-layer path -> the JAX stacked path (the layer index after
    "transformer_blocks" dropped); the layer index."""
    i = path.index("transformer_blocks")
    return path[:i + 1] + path[i + 2:], path[i + 1]


# ------------------------------------------------ similarity, cone, top-k

def _lora_case(seed, in_f=48, out_f=40, rank=4):
    """LoRA factors, mergers in (0, 1) and gradients (merger terms
    included), numpy."""
    rng = np.random.default_rng(seed)
    lp = {b: {"down": _rand(rng, (in_f, rank), 0.5),
              "up": _rand(rng, (rank, out_f), 0.5)}
          for b in ("content", "style")}
    lg = {b: {"down": _rand(rng, (in_f, rank), 1e-4),
              "up": _rand(rng, (rank, out_f), 1e-4)}
          for b in ("content", "style")}
    for b in ("content", "style"):
        lp[f"merge_{b}"] = rng.uniform(0.1, 1.0, out_f).astype(np.float32)
        lg[f"merge_{b}"] = _rand(rng, (out_f,), 1e-4)
    return lp, lg


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("use_c,use_s", [(False, False), (True, False),
                                         (True, True)])
def test_mergers_similarity_matches_jax(use_c, use_s):
    lp, _ = _lora_case(1)
    rng = np.random.default_rng(2)
    st = {"mask_content": rng.random(40) < 0.5,
          "mask_style": rng.random(40) < 0.5,
          "use_mask_content": np.bool_(use_c),
          "use_mask_style": np.bool_(use_s)}
    for state in (None, st):
        want = np.asarray(junzip.mergers_similarity(
            _to_j(lp), None if state is None else _to_j(state)))
        got = tunzip.mergers_similarity(
            _to_t(lp), None if state is None else _to_t(state))
        assert got.dtype == torch.float32
        # a mean of 40 f32 products: torch and XLA sum them in another
        # order, so the last bit may differ (a bound, ROADMAP.md section 3)
        assert abs(got.item() - float(want)) <= np.spacing(
            np.float32(want)), (state is None, got.item(), want)


@pytest.mark.parametrize("branch", ["content", "style"])
@pytest.mark.parametrize("merger_grads", [True, False])
def test_cone_columns_match_jax(branch, merger_grads):
    lp, lg = _lora_case(3)
    if not merger_grads:   # the selection's case: merger terms zeroed
        lg = dict(lg, merge_content=np.zeros(40, np.float32),
                  merge_style=np.zeros(40, np.float32))
    cone = np.asarray(junzip.cone_matrix(_to_j(lp), _to_j(lg), branch))
    frac = float((np.abs(cone) > 1e-5).mean())
    assert 0.2 < frac < 0.8, frac   # the threshold splits these rows
    want = np.asarray(junzip.cone_columns(_to_j(lp), _to_j(lg), branch))
    got = tunzip.cone_columns(_to_t(lp), _to_t(lg), branch)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the f32 cone itself, within the order of its sums
    np.testing.assert_allclose(
        tunzip.cone_matrix(_to_t(lp), _to_t(lg), branch).numpy(), cone,
        rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("avoid", [False, True])
@pytest.mark.parametrize("ratio", [0.1, 0.3])
def test_select_columns_match_jax_with_ties(avoid, ratio):
    rng = np.random.default_rng(4)
    out = 64
    # counts over 8 rows: every score ties with many others
    sc = (rng.integers(0, 9, out) / 8).astype(np.float32)
    ss = (rng.integers(0, 9, out) / 8).astype(np.float32)
    pc, ps = rng.random(out) < 0.1, rng.random(out) < 0.1
    for prev_c, prev_s in ((np.zeros(out, bool), np.zeros(out, bool)),
                           (pc, ps)):
        want = junzip.select_columns(*map(jnp.asarray, (sc, ss, prev_c,
                                                        prev_s)),
                                     ratio=ratio, avoid=avoid)
        got = tunzip.select_columns(*map(torch.from_numpy,
                                         (sc, ss, prev_c, prev_s)),
                                    ratio=ratio, avoid=avoid)
        for g, w in zip(got, want):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and got[1].any()


# --------------------------------------------- block-separation tables

def test_freeze_tables_and_patterns_match_jax():
    assert tsurgery.FREEZE_UNET_CONTENT == jcli.FREEZE_UNET_CONTENT
    assert tsurgery.FREEZE_UNET_STYLE == jcli.FREEZE_UNET_STYLE
    extra = {"down_blocks.": ["2_0,1_1_q,k", "1_A_2_out"],
             "up_blocks.": ["A_A_1_v"], "mid_block": ["N_0_A_A"]}
    for table in (jcli.FREEZE_UNET_CONTENT, jcli.FREEZE_UNET_STYLE, extra):
        for lpb in (1, 2):
            assert tsurgery.expand_block_patterns(
                table, layers_per_block=lpb) == \
                jsurgery.expand_block_patterns(table, layers_per_block=lpb)


@pytest.mark.parametrize("tables", ["freeze", "content_only", "none"])
def test_layer_assignments_match_jax_on_sdxl(tables):
    """The SDXL layout (shape-only trees): every per-layer label equals
    the JAX label of its stack."""
    mc, ms = {"freeze": (jcli.FREEZE_UNET_CONTENT, jcli.FREEZE_UNET_STYLE),
              "content_only": (jcli.FREEZE_UNET_CONTENT, {}),
              "none": ({}, {})}[tables]
    jtree = jax.eval_shape(
        lambda k: junet.init_unet(k, JUNetConfig.sdxl()),
        jax.random.PRNGKey(0))
    want = jsurgery.layer_assignments(jtree, mc, ms, layers_per_block=2)
    ttree = init_unet(MetaInit(), UNetConfig.sdxl())
    got = tsurgery.layer_assignments(ttree, mc, ms, layers_per_block=2)
    assert len(got) == 70 * 8
    stacks = set()
    for path, label in got.items():
        key, _ = _collapse(path)
        assert label == want[key], path
        stacks.add(key)
    assert stacks == set(want)
    assert {"both", "style", "content"} >= set(got.values())
    if tables == "freeze":
        assert set(got.values()) == {"both", "style", "content"}


# ------------------------------------------------------- the trainer

def _lora_unet():
    cfg = JUNetConfig.tiny()
    jp = junet.init_unet(jax.random.PRNGKey(0), cfg)
    jp, jstate = jsurgery.insert_unziplora(jp, jax.random.PRNGKey(1),
                                           rank=4)
    return cfg, jp, jstate


def _batch(cfg, rng, b=1, priors=()):
    d = cfg.cross_attention_dim
    pdim = (cfg.projection_class_embeddings_input_dim
            - 6 * cfg.addition_time_embed_dim)
    time_ids = np.tile(np.float32([[16, 16, 0, 0, 16, 16]]), (b, 1))
    out = {"latents": _rand(rng, (b, 8, 8, 4)),
           "ctx": _rand(rng, (b, 7, d)), "ctx_content": _rand(rng, (b, 7, d)),
           "ctx_style": _rand(rng, (b, 7, d)), "pooled": _rand(rng, (b, pdim)),
           "time_ids": time_ids}
    for branch in priors:
        out[f"prior_{branch}"] = {"latents": _rand(rng, (b, 8, 8, 4)),
                                  "ctx": _rand(rng, (b, 7, d)),
                                  "pooled": _rand(rng, (b, pdim)),
                                  "time_ids": time_ids}
    return out


def _jax_draws(key, batch):
    """stage1_loss's own draws, as it takes them from its key."""
    keys = jax.random.split(key, 6)

    def one(kt, kn, shape):
        return {"t": torch.from_numpy(np.array(jax.random.randint(
                    kt, (shape[0],), 0, 1000))).long(),
                "noise": _t(jax.random.normal(kn, shape, jnp.float32))}

    out = one(keys[0], keys[1], batch["latents"].shape)
    for bi, branch in enumerate(("content", "style")):
        if f"prior_{branch}" in batch:
            out[f"prior_{branch}"] = one(
                keys[2 + 2 * bi], keys[3 + 2 * bi],
                batch[f"prior_{branch}"]["latents"].shape)
    return out


def _port_batch(batch):
    return {k: (_port_batch(v) if isinstance(v, dict) else _t(v))
            for k, v in batch.items()}


def _live_state(jp, jstate):
    """Mergers in (0.2, 1) and live masks on half the projections, so
    the similarity term and the masked forward both count."""
    rng = np.random.default_rng(5)
    for i, path in enumerate(jstage1.lora_proj_paths(jp)):
        lp = dict(jsurgery.tree_get(jp, path)["lora"])
        st = dict(jsurgery.tree_get(jstate, path))
        for b in ("content", "style"):
            shape = lp[f"merge_{b}"].shape
            lp[f"merge_{b}"] = jnp.asarray(
                rng.uniform(0.2, 1.0, shape).astype(np.float32))
            if i % 2:
                st[f"mask_{b}"] = jnp.asarray(rng.random(shape) < 0.7)
                st[f"use_mask_{b}"] = jnp.ones(shape[:1], bool)
        jp = jsurgery.tree_set(jp, path + ("lora",), lp)
        jstate = jsurgery.tree_set(jstate, path, st)
    return jp, jstate


def test_trainable_set_and_block_logs_match_jax():
    """The LoRA leaves the trainer trains, and the per-block LoRA norm and
    merger means it logs, against JAX's on the same tensors."""
    from video_style_transfer_tpu.utils import observability as jobs
    from video_style_transfer_tpu_torch.utils import observability as tobs
    _, jp, jstate = _lora_unet()
    jp, _ = _live_state(jp, jstate)
    jl = [(m, np.asarray(x).size) for m, x in zip(
        jax.tree.leaves(jstage1.trainable_mask(jp)), jax.tree.leaves(jp))]
    tp = convert.convert_tree(jp)
    flags = dict(tstage2.iter_leaves(tstage1.trainable_mask(tp)))
    tl = [(flags[p], t.numel()) for p, t in tstage2.iter_leaves(tp)]
    # the tiny stacks hold one layer each, so the leaf counts compare
    assert sum(m for m, _ in tl) == sum(bool(m) for m, _ in jl) > 0
    assert sum(n for m, n in tl if m) == sum(n for m, n in jl if m)
    assert tstage1.lora_proj_paths(tp) == list(
        tsurgery.layer_assignments(tp, {}, {}))
    for branch in ("content", "style"):
        for kw in ({}, {"with_merge": True, "norm": "L1"}):
            want = jobs.lora_norm_log(jp, branch, **kw)
            got = tobs.lora_norm_log(tp, branch, **kw)
            assert set(got) == set(want) and len(want) == 4
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)
        want = jobs.lora_merge_log(jp, branch)
        got = tobs.lora_merge_log(tp, branch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)


SIM_LAMBDA, PRIOR_W, PRIOR_W2 = 0.5, 1.0, 0.5


def _recorder():
    """A transformation that keeps the gradients it is handed (the
    merger-gated ones make_train_step passes the optimizer) as its state:
    chained before make_optimizer, it lets the test read JAX's step
    gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


# two schedules that reach every phase: one sample time (5 steps), and
# two, whose second selection ORs new columns into the first (9 steps)
SEPS = {1: dict(enabled=True, max_steps=4, sample_times=1,
                steps_per_epoch=2, column_ratio=0.25),
        2: dict(enabled=True, max_steps=8, sample_times=2,
                steps_per_epoch=2, column_ratio=0.25)}
PHASES = {1: ["reset", "sampling", "select", "zeroout", "tail"],
          2: ["reset", "sampling", "select", "zeroout"] * 2 + ["tail"]}


def _own_selection(state, grads, jgrads, assignments, cfg, step, log):
    """At a selection step: the selection from the port's own gradients
    against the one from JAX's (both through the port's arithmetic);
    logs (step, path, output, columns differing, largest difference)."""
    for path, label in assignments.items():
        lp = tsurgery.tree_get(state.params, path)["lora"]
        st = tsurgery.tree_get(state.lora_state, path)
        own = tstage1.select_projection(
            lp, tstage1.lora_grads(grads, path), st, label, cfg)
        jax_g = {p: tsurgery.tree_get(jgrads, p) for p in grads}
        ref = tstage1.select_projection(
            lp, tstage1.lora_grads(jax_g, path), st, label, cfg)
        for name, a, b in zip(("score_content", "score_style",
                               "mask_content", "mask_style"), own, ref):
            if not torch.equal(a, b):
                log.append((step, path, name, int((a != b).sum()),
                            float((a.float() - b.float()).abs().max())))


def _run_both(finetune: bool, accum: int, priors=(), sample_times=2):
    """JAX's make_train_step and the port's over every phase from the same
    tensors, state and batches (mergers in (0.2, 1), random masks live on
    half the projections); the port takes JAX's draws. At each step the
    port's own gradients are compared with JAX's and then replaced by
    them, so that the phases' arithmetic runs on equal gradients. Returns
    what the tests read: per-step losses, gradient and state mismatches,
    the port's tensors."""
    cfg, jp, jstate = _lora_unet()
    jp, jstate = _live_state(jp, jstate)
    sep = jstage1.ColumnSepConfig(finetune_mask=finetune,
                                  **SEPS[sample_times])
    jas = jsurgery.layer_assignments(jp, {}, {}, layers_per_block=1)
    opt = optax.chain(_recorder(), jstage1.make_optimizer(jp,
                                                          total_steps=8))
    jstep = jax.jit(jstage1.make_train_step(
        cfg, jddpm.make_schedule(), opt, sep_cfg=sep, assignments=jas,
        mask=jstage1.trainable_mask(jp), similarity_lambda=SIM_LAMBDA,
        prior_weight=PRIOR_W, prior_weight_2=PRIOR_W2, remat=False,
        grad_accum=accum))
    js = jstage1.init_state(jp, jstate, opt)

    tp = convert.convert_tree(jp)
    tas = tsurgery.layer_assignments(tp, {}, {}, layers_per_block=1)
    topt = tstage1.make_optimizer(tp, total_steps=8)
    ts = tstage1.init_state(tp, convert.convert_lora_state(jstate), topt)
    tcfg = tstage1.ColumnSepConfig(finetune_mask=finetune,
                                   **SEPS[sample_times])
    tstep = tstage1.make_train_step(
        UNetConfig.tiny(), tddpm.make_schedule(), sep_cfg=tcfg,
        assignments=tas, similarity_lambda=SIM_LAMBDA, prior_weight=PRIOR_W,
        prior_weight_2=PRIOR_W2)
    frozen = {p: t.clone() for p, t in tstage2.iter_leaves(tp)
              if not t.requires_grad}
    rng = np.random.default_rng(8)
    out = {"losses": [], "grad_bad": [], "grads_checked": {},
           "own_selection": [],
           "state_bad": [], "param_err": [], "phases": [],
           "want_phases": PHASES[sample_times],
           "tp": tp, "ts": ts, "topt": topt, "tas": tas, "frozen": frozen}
    for i in range(len(PHASES[sample_times])):
        out["phases"].append(tstage1.phase_name(i, tcfg))
        micro = [_batch(cfg, rng, priors=priors) for _ in range(accum)]
        jbatch = (micro[0] if accum == 1 else
                  jax.tree.map(lambda *x: np.stack(x), *micro))
        key = jax.random.PRNGKey(100 + i)
        keys = [key] if accum == 1 else list(jax.random.split(key, accum))
        # JAX gates the merger gradients it records; they are read where
        # this step leaves them ungated (merger_on, no column gate)
        ungated_mergers = ts.merger_on and out["phases"][-1] not in (
            "zeroout", "tail")
        js, jm = jstep(js, _to_j(jbatch), key)
        jgrads = convert.convert_tree(js.opt_state[0])

        def feed(state, grads, step=i, ungated=ungated_mergers):
            if tstage1.phase_name(step, tcfg) == "select":
                _own_selection(state, grads, jgrads, tas, tcfg, step,
                               out["own_selection"])
            for path in grads:
                want = tsurgery.tree_get(jgrads, path)
                label = tstage1.path_label(path)
                if label != "merger" or ungated:
                    out["grads_checked"][label] = \
                        out["grads_checked"].get(label, 0) + 1
                    if not np.allclose(grads[path].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6):
                        err = float((grads[path] - want).abs().max())
                        out["grad_bad"].append((step, path, err))
                grads[path] = want.clone()

        tm = tstep(ts, [_port_batch(b) for b in micro],
                   draws=[_jax_draws(k, b) for k, b in zip(keys, micro)],
                   on_grads=feed)
        out["losses"].append(({k: v.item() for k, v in tm.items()},
                              {k: float(v) for k, v in jm.items()}))
        if (ts.orth_on, ts.merger_on, ts.step) != (
                bool(js.orth_on), bool(js.merger_on), int(js.step)):
            out["state_bad"].append((i, "flags"))
        jlora = convert.convert_lora_state(js.lora_state)
        for path in tas:
            got, want = (tsurgery.tree_get(ts.lora_state, path),
                         tsurgery.tree_get(jlora, path))
            for k in ("mask_content", "mask_style", "use_mask_content",
                      "use_mask_style", "score_content", "score_style"):
                if not torch.equal(got[k], want[k].reshape(got[k].shape)):
                    out["state_bad"].append((i, path, k))
        jparams = convert.convert_tree(js.params)
        out["param_err"].append(max(
            float((t.detach() - tsurgery.tree_get(jparams, path)).abs()
                  .max()) for path, t in topt.trainable))
    return out


@pytest.fixture(scope="module")
def run_priors():
    """--with_finetune_mask off, one micro-batch, both priors on, one
    sample time."""
    return _run_both(False, 1, priors=("content", "style"), sample_times=1)


@pytest.fixture(scope="module")
def run_accum():
    """--with_finetune_mask on, two micro-batches (JAX's scan), two
    sample times."""
    return _run_both(True, 2, sample_times=2)


def test_stage1_loss_matches_jax(run_priors):
    """stage1_loss with both priors, at every step (the similarity term
    on from the first selection, the masks live)."""
    sims = []
    for i, (got, want) in enumerate(run_priors["losses"]):
        assert set(got) == set(want) == {
            "loss", "loss_rec", "loss_sim", "loss_prior_content",
            "loss_prior_style"}, i
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        sims.append(want["loss_sim"])
    assert any(0 < x < 1 for x in sims[3:]), sims   # masked, overlapping


def test_stage1_grads_match_jax(run_priors):
    """Every LoRA leaf's gradient at every step (the mergers' where the
    step leaves them ungated), rtol 1e-4 / atol 1e-6; the frozen SDXL
    weights get none and stay bitwise as they were."""
    assert run_priors["grad_bad"] == []
    checked = run_priors["grads_checked"]
    assert set(checked) == {"content", "style", "merger"}, checked
    for path, t in tstage2.iter_leaves(run_priors["tp"]):
        if path in run_priors["frozen"]:
            assert not t.requires_grad and t.grad is None, path
            assert torch.equal(t, run_priors["frozen"][path]), path


@pytest.mark.parametrize("case", ["run_priors", "run_accum"])
def test_train_step_every_phase_matches_jax(case, request):
    """From equal gradients, every mask, score and use-mask flag and
    orth_on, merger_on and the step equal JAX's after every step, and
    every LoRA leaf within the optimizer tolerance."""
    run = request.getfixturevalue(case)
    assert run["phases"] == run["want_phases"]
    assert run["state_bad"] == []
    assert max(run["param_err"]) <= OPT_TOL, run["param_err"]
    masks = [tsurgery.tree_get(run["ts"].lora_state, p)["mask_style"]
             for p in run["tas"]]
    assert any(bool(m.any()) for m in masks)
    for path, t in run["topt"].trainable:
        if tstage1.path_label(path) == "merger":
            assert 0.0 <= float(t.detach().min()) <= float(
                t.detach().max()) <= 1.0


@pytest.mark.parametrize("case", ["run_priors", "run_accum"])
def test_selection_from_own_gradients_within_bound(case, request):
    """The bound of ROADMAP.md section 3: from the port's own gradients
    (within rtol 1e-4 of JAX's) a selection's masks equal those from
    JAX's gradients; a score may differ by one row (a cone element at
    the 1e-5 threshold within the gradients' difference)."""
    run = request.getfixturevalue(case)
    rows = {"mask_content": 0, "mask_style": 0}
    for step, path, name, n, diff in run["own_selection"]:
        assert name not in rows, (step, path, name, n)
        in_features = tsurgery.tree_get(run["tp"], path)["weight"].shape[1]
        assert diff <= 1.0 / in_features * (1 + 1e-6), (step, path, name)


def test_grad_accum_matches_jax_scan(run_accum):
    """Two micro-batches a step against JAX's scan: the averaged loss and
    gradients at every step."""
    assert run_accum["grad_bad"] == []
    for i, (got, want) in enumerate(run_accum["losses"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")


# ----------------------------------------------------- the optimizers

def _opt_tree(rng, dtype=np.float32):
    """Two projections: LoRA factors above the 8-bit size (4608
    entries), mergers, and a frozen kernel."""
    def proj():
        lora = {b: {"down": _rand(rng, (96, 48), 0.1).astype(dtype),
                    "up": _rand(rng, (48, 96), 0.1).astype(dtype)}
                for b in ("content", "style")}
        for b in ("content", "style"):
            lora[f"merge_{b}"] = rng.uniform(0.2, 1, 96).astype(dtype)
        return {"kernel": _rand(rng, (96, 96)).astype(dtype), "lora": lora}
    return {"blocks": [proj(), proj()]}


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_t(v) for v in tree]
    t = torch.from_numpy(np.array(tree, np.float32))
    return t.to(torch.bfloat16) if tree.dtype != np.float32 else t


def _opt_grads(rng, tree, scale):
    return jax.tree.map(lambda x: _rand(rng, x.shape, scale), tree)


def _run_optimizers(kind, dtype=np.float32, steps=3):
    """JAX's make_optimizer and the port's on the same tree and gradients
    (the frozen kernel's zero, as make_train_step feeds them); returns
    ({path: (port, jax)} leaves, the JAX state, the port optimizer, the
    port's tree, the starting tree). Prodigy takes learning rates near
    1, as its users are told to (its adapted step D starts at 1e-6)."""
    import ml_dtypes
    npdt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    rng = np.random.default_rng(9)
    tree = _opt_tree(rng, npdt)
    scale = 1000.0 if kind == "prodigy" else 1.0
    kw = dict(lr_content=1e-3 * scale, lr_style=2e-3 * scale,
              lr_merger=5e-2 * scale, weight_decay=0.05, total_steps=6,
              warmup=1, schedule="linear", max_grad_norm=1.0,
              optimizer=kind)
    jparams = _to_j(tree)
    jopt = jstage1.make_optimizer(jparams, **kw)
    jst = jopt.init(jparams)
    update = jax.jit(jopt.update)
    tp = _tree_t(tree)
    topt = tstage1.make_optimizer(tp, **kw)
    labels = jstage1.param_labels(jparams)
    for i in range(steps):
        # step 1's gradients are clipped (norm > 1), the others not
        grads = _opt_grads(rng, tree, 0.05 if i == 1 else 1e-3)
        grads = jax.tree.map(lambda g, lbl: g * 0 if lbl == "frozen" else g,
                             grads, labels)
        jg = jax.tree.map(lambda g, p: jnp.asarray(g, p.dtype), grads,
                          jparams)
        upd, jst = update(jg, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = _tree_t(jax.tree.map(lambda g: np.asarray(g, npdt), grads))
        topt.step([tsurgery.tree_get(tg, p).to(t.dtype)
                   for p, t in topt.trainable])
    jt = _tree_t(jax.tree.map(lambda x: np.asarray(x), jparams))
    pairs = {p: (t.detach(), tsurgery.tree_get(jt, p))
             for p, t in topt.trainable}
    return pairs, jst, topt, tp, tree


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit", "prodigy"])
def test_stage1_optimizer_matches_jax(kind):
    pairs, jst, topt, tp, tree = _run_optimizers(kind)
    assert {tstage1.path_label(p) for p in pairs} == {"content", "style",
                                                      "merger"}
    for path, (got, want) in pairs.items():
        start = torch.from_numpy(np.asarray(
            tsurgery.tree_get(tree, path), np.float32))
        moved = (want - start).abs().max()
        assert moved > 0, path
        # 1e-6, or (prodigy's steps are D-scaled, ~1e-5 of the 8-bit
        # moments' steps) 1e-4 of the tensor's own step
        tol = OPT_TOL if kind != "prodigy" else 1e-4 * float(moved)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol, err_msg=str(path))
    # the frozen kernel is not the optimizer's, and kept no state
    for path, t in tstage2.iter_leaves(tp):
        if path[-1] == "kernel":
            assert not t.requires_grad and torch.equal(
                t, torch.from_numpy(np.asarray(tsurgery.tree_get(tree,
                                                                path))))
    if kind == "prodigy":
        # each group's own D estimate, as JAX's multi_transform keeps it
        for g, opt in topt.groups.items():
            want = float(jst[1].inner_states[g].inner_state.estim_lr)
            np.testing.assert_allclose(opt.estim_lr.item(), want, rtol=1e-5,
                                       err_msg=g)
    state = topt.state_dict()
    assert set(state) == {"content", "style", "merger"}
    assert all(s["count"] == 3 for s in state.values())


def test_prodigy_honours_per_group_lr():
    """The JAX package's test_prodigy_honors_per_group_lr on the port: a
    100x merger learning rate moves the mergers ~100x as far."""
    cfg = UNetConfig.tiny()
    from video_style_transfer_tpu_torch.models.layers import Init
    tp = init_unet(Init(0), cfg)
    tp, _ = tsurgery.insert_unziplora(tp, Init(1), rank=4)
    opt = tstage1.make_optimizer(tp, lr_content=1e-4, lr_style=1e-4,
                                 lr_merger=1e-2, optimizer="prodigy",
                                 total_steps=10, max_grad_norm=1e9)
    # from zero, a tensor after the step is its update (the ~1e-10 steps
    # of the LoRA factors would vanish in the rounding of nonzero values)
    with torch.no_grad():
        for _, t in opt.trainable:
            t.zero_()
    opt.step([torch.ones_like(t) for _, t in opt.trainable])
    mag = {"merger": [], "content": []}
    for path, t in opt.trainable:
        lbl = tstage1.path_label(path)
        if lbl == "merger" or (lbl == "content" and path[-1] == "down"):
            mag[lbl].append(float(t.detach().abs().mean()))
    ratio = np.mean(mag["merger"]) / np.mean(mag["content"])
    assert 50.0 < ratio < 200.0, ratio


def test_prodigy_state_round_trip():
    p = [torch.randn(8, 4), torch.randn(4)]
    opt = Prodigy([t.clone() for t in p], lambda s: 1.0, weight_decay=0.1)
    opt.step([torch.randn_like(t) for t in p])
    saved = opt.state_dict()
    other = Prodigy([t.clone() for t in p], lambda s: 1.0, weight_decay=0.1)
    other.load_state_dict(saved)
    assert other.count == 1
    assert torch.equal(other.estim_lr, opt.estim_lr)
    with pytest.raises(ValueError):
        other.load_state_dict({**saved, "grad_sum": saved["grad_sum"][:1]})


# ------------------------------------- both optimizers on bf16 leaves

def _bf16_excess(got, want):
    """The largest part of |got - want| beyond one bf16 step (2^-7
    relative) at the larger of the two magnitudes."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    step = 2.0 ** (torch.floor(torch.log2(big)) - 7)
    return float(((g - w).abs() - step).clamp_min(0).max())


# the bound on bf16 leaves, from identical tensors before each step: one
# bf16 step of the result, plus 2^-5 of the learning rate. XLA fuses the
# bf16 moment and update arithmetic and rounds once where the port
# rounds after each operation (AdamW: the O(1) Adam ratio through about
# four bf16 roundings; 8-bit AdamW: the decay term wd * p in bf16). Read
# on these tensors: at most 0.018 lr beyond one step, 0-4 % of the
# entries differing (ROADMAP.md section 3).
BF16_LR_SHARE = 2.0 ** -5


@pytest.mark.parametrize("kind", ["adamw", "adamw8bit"])
def test_stage2_optimizers_on_bf16_leaves_match_jax(kind):
    """Three steps on bf16 tensors (the stage-2 motion weights' dtype)
    against optax's adamw and JAX's adamw8bit chain on the same bf16
    leaves, the port's tensors set to JAX's after each step (the moments
    stay each side's own); the second step's gradients are clipped."""
    import ml_dtypes
    rng = np.random.default_rng(10)
    shapes = [(64, 96), (8, 16)]
    params = [_rand(rng, s).astype(ml_dtypes.bfloat16) for s in shapes]
    lr = 1e-2
    kw = dict(lr=lr, total_steps=6, warmup=0, weight_decay=0.05,
              max_grad_norm=1.0, optimizer=kind)
    jopt = jstage2.make_optimizer([True, True], **kw)
    jparams = [jnp.asarray(p) for p in params]
    jst = jopt.init(jparams)
    update = jax.jit(jopt.update)
    tparams = [torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16)
               for p in params]
    topt = tstage2.make_optimizer(tparams, **kw)
    worst, differing = 0.0, 0
    for i in range(3):
        gs = [_rand(rng, s, 1e-2 if i != 1 else 1.0).astype(
            ml_dtypes.bfloat16) for s in shapes]
        upd, jst = update([jnp.asarray(g) for g in gs], jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.step([torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
                   for g in gs])
        for t, w in zip(tparams, jparams):
            assert t.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            ref = torch.from_numpy(np.asarray(w).astype(np.float32)).to(
                torch.bfloat16)
            worst = max(worst, _bf16_excess(t, ref) / lr)
            differing += int((t != ref).sum())
            with torch.no_grad():
                t.copy_(ref)
    assert worst <= BF16_LR_SHARE, worst
    assert differing < 0.05 * 3 * sum(np.prod(s) for s in shapes)


def test_stage1_optimizer_on_bf16_leaves_matches_jax():
    """The three-group wrapper (AdamW) on bf16 LoRA leaves against JAX's
    make_optimizer on the same leaves, under the same bound, each group
    against its own learning rate."""
    import ml_dtypes
    rng = np.random.default_rng(11)
    tree = _opt_tree(rng, ml_dtypes.bfloat16)
    lrs = {"content": 1e-2, "style": 2e-2, "merger": 5e-2}
    kw = dict(lr_content=lrs["content"], lr_style=lrs["style"],
              lr_merger=lrs["merger"], weight_decay=0.05, total_steps=6,
              max_grad_norm=1.0)
    jparams = _to_j(tree)
    jopt = jstage1.make_optimizer(jparams, **kw)
    jst = jopt.init(jparams)
    update = jax.jit(jopt.update)
    tp = _tree_t(tree)
    topt = tstage1.make_optimizer(tp, **kw)
    labels = jstage1.param_labels(jparams)
    worst = 0.0
    for i in range(3):
        grads = _opt_grads(rng, tree, 0.05 if i == 1 else 1e-3)
        grads = jax.tree.map(lambda g, lbl: g * 0 if lbl == "frozen" else g,
                             grads, labels)
        jg = jax.tree.map(lambda g: jnp.asarray(g, jnp.bfloat16), grads)
        upd, jst = update(jg, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = _tree_t(jax.tree.map(
            lambda g: np.asarray(g, ml_dtypes.bfloat16), grads))
        topt.step([tsurgery.tree_get(tg, p) for p, _ in topt.trainable])
        jt = _tree_t(jax.tree.map(np.asarray, jparams))
        for path, t in topt.trainable:
            ref = tsurgery.tree_get(jt, path)
            assert t.dtype == ref.dtype == torch.bfloat16, path
            worst = max(worst, _bf16_excess(t.detach(), ref)
                        / lrs[tstage1.path_label(path)])
            with torch.no_grad():
                t.copy_(ref)
    assert worst <= BF16_LR_SHARE, worst

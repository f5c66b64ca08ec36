"""Stage-1 trainer: joint content/style UnZipLoRA training on SDXL (the
JAX package's training/stage1.py).

The loss is the noise-prediction MSE of the "both" forward with
triple-prompt conditioning (combined, content, style), plus lambda times
the merger similarity once it is switched on, plus optional dual prior
preservation: one forward in "content" mode on the content class
images and one in "style" mode on the style ones, each with its own
timestep and noise. Three optimizer groups (content LoRA, style LoRA,
mergers; the reference's 5e-5 / 5e-5 / 5e-3) share one global-norm clip
and one schedule shape; the mergers are clamped to [0, 1] after every
update.

The periodic column separation runs on the host, one phase a step from
the step index (``_phase``): with sampled_steps = ceil(max_steps /
sample_times) and steps_per_epoch = ne, step s sits at pos = s %
sampled_steps, and is

- "reset" at pos 0: the column masks stop applying, the mergers freeze
  and the similarity loss switches off;
- "sampling" at 0 < pos < ne;
- "select" at pos >= ne with (s - ne) % sampled_steps == 0: each
  projection's cone (W .* dW, from this step's gradients, its merger
  terms zeroed) scores its columns, top-k picks new masks (content
  first, style kept off content's columns), OR'd with the old ones; the
  masks, mergers and similarity loss switch on;
- "zeroout" otherwise, and "tail" from sample_times * sampled_steps
  on: the merger gradients are gated by the masks (each branch's own
  with finetune_mask, else their overlap).

One step, in the JAX package's order: the gradients of the LoRA leaves
(the frozen SDXL weights get none); the phase's update of the masks,
scores and flags from those ungated gradients and the pre-step
tensors, at the step index before its increment; the gate of this step
from the masks before the update, times the old merger_on; the
gradients gated, clipped and applied with the updates gated again; the
mergers clamped. A gated merger is not skipped: its moments decay on a
zero gradient and its group's count moves, as optax's do. The new flags
first act on the next step's forward.

Data parallelism (a ``parallel.mesh.Grid``, the reference's DDP): each
rank holds its rows of the global batch and draws the step's timesteps
and noise for the whole of it; its loss is its share (squared errors
over the global count, the replicated merger similarity over the world
size), and the gradients are summed over the world before the column
separation reads them, so every rank computes the same cone, the same
masks and the same update.

Draws come in from the caller (``draw_stage1``, from a
``torch.Generator``), so a test can hand the loss the JAX trainer's.
Activations run in the UNet's dtype (bf16 at full width); the LoRA
leaves stay f32, with no master weights. The state is in place: the
params and the LoRA state tree hold the live tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch

from video_style_transfer_tpu_torch.config import UNetConfig
from video_style_transfer_tpu_torch.lora.surgery import (
    PROJS, iter_spatial_attention_paths, tree_get)
from video_style_transfer_tpu_torch.lora.unzip import (
    BRANCHES, cone_columns, mergers_similarity, select_columns)
from video_style_transfer_tpu_torch.models.unet import unet_apply
from video_style_transfer_tpu_torch.schedulers.ddpm import add_noise
from video_style_transfer_tpu_torch.training.adam8bit import AdamW8bit
from video_style_transfer_tpu_torch.training.prodigy import Prodigy
from video_style_transfer_tpu_torch.training.schedules import (
    make_lr_schedule)
from video_style_transfer_tpu_torch.training.stage2 import (
    AdamW, check_state_like, clip_by_global_norm, iter_leaves)
from video_style_transfer_tpu_torch.utils import tracing

GROUPS = ("content", "style", "merger")
OPTIMIZERS = ("adamw", "adamw8bit", "prodigy")
PHASES = ("tail", "reset", "sampling", "select", "zeroout")


class ColumnSepConfig(NamedTuple):
    """Schedule constants: sampled_steps = ceil(max_steps /
    sample_times); steps_per_epoch the optimizer updates of one epoch.
    The reference's --with_accumulate_cone is not modelled: its
    accumulator is overwritten at selection before it is read."""
    enabled: bool = False
    max_steps: int = 600
    sample_times: int = 3
    steps_per_epoch: int = 1
    column_ratio: float = 0.1
    avoid: bool = True           # content-priority, no overlap
    finetune_mask: bool = False  # gate each branch by its own mask

    @property
    def sampled_steps(self) -> int:
        return -(-self.max_steps // self.sample_times)


@dataclass
class Stage1State:
    """The trainer's state. params and lora_state hold the live tensors
    (the LoRA leaves trainable); orth_on: the similarity loss is on;
    merger_on: the mergers train this step; step: updates made."""
    params: Any
    optimizer: Any
    lora_state: Any
    orth_on: bool = False
    merger_on: bool = True
    step: int = 0


# ------------------------------------------------------------- optimizer

def path_label(path) -> str:
    """"content", "style" or "merger" for a LoRA leaf, else "frozen"."""
    if "lora" in path:
        if path[-1] in ("merge_content", "merge_style"):
            return "merger"
        if "content" in path:
            return "content"
        if "style" in path:
            return "style"
    return "frozen"


def param_labels(params):
    """A tree shaped like params of path_label's labels."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        return path_label(path)
    return walk(params, ())


def trainable_mask(params):
    """True at every LoRA leaf (content and style factors, mergers)."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree != "frozen"
    return walk(param_labels(params))


def split_trainable(params):
    """Mark the LoRA leaves trainable (requires_grad) and freeze the rest;
    returns [(path, tensor)] of the LoRA leaves in tree order."""
    out = []
    for path, t in iter_leaves(params):
        train = path_label(path) != "frozen"
        t.requires_grad_(train)
        if train:
            out.append((path, t))
    return out


def lora_proj_paths(params):
    """Every spatial attention projection that carries a LoRA."""
    return [p + (proj,) for p in iter_spatial_attention_paths(params)
            for proj in PROJS if "lora" in tree_get(params, p)[proj]]


class Stage1Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), multi_transform({content,
    style, merger: the optimizer at the group's learning rate, frozen:
    set_to_zero})) over the trainable tensors: one clip over every
    gradient, then each group's own optimizer (training.stage2.AdamW,
    training.adam8bit.AdamW8bit or training.prodigy.Prodigy) on its own
    schedule of one shape. Frozen tensors are not held and get no
    state. ``state_dict`` holds the three groups' states; a load checks
    all three before it copies any in."""

    def __init__(self, trainable, groups: Dict[str, Any], kind: str,
                 max_grad_norm: float):
        self.trainable = list(trainable)
        self.kind = kind
        self.max_grad_norm = max_grad_norm
        self.groups = groups
        labels = [path_label(p) for p, _ in self.trainable]
        self.index = {g: [i for i, lbl in enumerate(labels) if lbl == g]
                      for g in GROUPS}

    def step(self, grads, gates=None):
        """grads: one per trainable tensor; gates: None, or one update
        multiplier per tensor (None for none)."""
        grads = clip_by_global_norm(grads, self.max_grad_norm)
        for g, opt in self.groups.items():
            idx = self.index[g]
            if not idx:
                continue
            opt.step([grads[i] for i in idx],
                     None if gates is None else [gates[i] for i in idx])

    def state_dict(self) -> dict:
        return {g: opt.state_dict() for g, opt in self.groups.items()}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if not isinstance(state, dict) or set(state) != set(self.groups):
            raise ValueError(f"{self.kind} state: groups differ")
        for g, opt in self.groups.items():
            check_state_like(state[g], {"count": 0, **opt.moments()},
                             f"{self.kind} state.{g}")
        for g, opt in self.groups.items():
            opt.load_state_dict(state[g])


def make_optimizer(params, *, lr_content: float = 5e-5,
                   lr_style: float = 5e-5, lr_merger: float = 5e-3,
                   weight_decay: float = 1e-4, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0, total_steps: int = 600,
                   warmup: int = 0, schedule: str = "constant",
                   num_cycles: int = 1, power: float = 1.0,
                   optimizer: str = "adamw",
                   prodigy_beta3: Optional[float] = None,
                   prodigy_safeguard_warmup: bool = True
                   ) -> Stage1Optimizer:
    """The three-group optimizer over the LoRA leaves of `params` (marked
    trainable here, everything else frozen). optimizer: "adamw",
    "adamw8bit" (blockwise 8-bit moments) or "prodigy" (decoupled,
    bias-corrected; the group's learning rate multiplies its adapted
    step)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; one of "
                         f"{OPTIMIZERS}")
    trainable = split_trainable(params)
    lrs = {"content": lr_content, "style": lr_style, "merger": lr_merger}
    groups = {}
    for g in GROUPS:
        tensors = [t for p, t in trainable if path_label(p) == g]
        sched = make_lr_schedule(schedule, lrs[g], warmup=warmup,
                                 total_steps=total_steps,
                                 num_cycles=num_cycles, power=power)
        kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  max_grad_norm=None)
        if optimizer == "prodigy":
            groups[g] = Prodigy(tensors, sched, beta3=prodigy_beta3,
                                safeguard_warmup=prodigy_safeguard_warmup,
                                **kw)
        elif optimizer == "adamw8bit":
            groups[g] = AdamW8bit(tensors, sched, **kw)
        else:
            groups[g] = AdamW(tensors, sched, **kw)
    return Stage1Optimizer(trainable, groups, f"stage1-{optimizer}",
                           max_grad_norm)


# ------------------------------------------------------------------ loss

def draw_stage1(sched, latent_shape, prior_shapes=None, *,
                generator: torch.Generator, device):
    """The per-step draws of stage1_loss: the instance timesteps t (B,)
    int64 and noise (the latent shape, f32), then for each prior branch
    of `prior_shapes` ({"content" | "style": latent shape}), in that
    order, its own {"t", "noise"} under "prior_<branch>"."""
    def one(shape):
        t = torch.randint(0, sched["num_train_timesteps"], (shape[0],),
                          generator=generator, device=device)
        noise = torch.randn(tuple(shape), generator=generator,
                            device=device, dtype=torch.float32)
        return {"t": t, "noise": noise}

    out = one(latent_shape)
    for branch in BRANCHES:
        if prior_shapes and branch in prior_shapes:
            out[f"prior_{branch}"] = one(prior_shapes[branch])
    return out


def _similarity_loss(params, lora_state, lora_paths):
    """Mean merger similarity over every projection layer."""
    vals = [mergers_similarity(tree_get(params, path)["lora"],
                               tree_get(lora_state, path))
            for path in lora_paths]
    return torch.mean(torch.stack(vals))


def _mse(pred, target, share=None):
    """The mean squared error, or with `share` (the world size) this
    rank's share of the global one (its rows among equal shares)."""
    err = (pred.float() - target.float()) ** 2
    return torch.mean(err) if share is None else \
        torch.sum(err) / (err.numel() * share)


def stage1_loss(params, unet_cfg: UNetConfig, sched, batch, draws, *,
                lora_state, lora_paths, orth_on: bool,
                similarity_lambda: float, prior_weight: float = 0.0,
                prior_weight_2: float = 0.0, remat: bool = False,
                dtype=None, share=None):
    """batch: latents (B, h, w, 4) scaled; ctx, ctx_content, ctx_style
    (B, S, D) the combined, content and style prompt encodings; pooled
    (B, P); time_ids (B, 6); optionally prior_content / prior_style,
    each {latents, ctx, pooled, time_ids}. draws: draw_stage1's. dtype:
    the UNet's activation dtype (default: its weights'). share: None, or
    the world size for this rank's share of the loss (module docstring).
    Returns (loss, {"loss_rec", "loss_sim", "loss_prior_<branch>" per
    prior run})."""
    if dtype is None:
        dtype = params["conv_in"]["weight"].dtype
    latents = batch["latents"]
    noise = draws["noise"].to(latents.dtype)
    noisy = add_noise(sched, latents, noise, draws["t"])
    pred = unet_apply(params, unet_cfg, noisy.to(dtype), draws["t"],
                      (batch["ctx"], batch["ctx_content"],
                       batch["ctx_style"]),
                      batch["pooled"], batch["time_ids"], mode="both",
                      state=lora_state, remat=remat)
    rec = _mse(pred, noise, share)
    sim = _similarity_loss(params, lora_state, lora_paths)
    if share is not None:
        sim = sim / share
    loss = rec + similarity_lambda * sim if orth_on else rec
    aux = {"loss_rec": rec, "loss_sim": sim}
    for branch, weight in (("content", prior_weight),
                           ("style", prior_weight_2)):
        prior = batch.get(f"prior_{branch}")
        if prior is None or weight == 0.0:
            continue
        pd = draws[f"prior_{branch}"]
        pnoise = pd["noise"].to(prior["latents"].dtype)
        pnoisy = add_noise(sched, prior["latents"], pnoise, pd["t"])
        ppred = unet_apply(params, unet_cfg, pnoisy.to(dtype), pd["t"],
                           (prior["ctx"], None, None), prior["pooled"],
                           prior["time_ids"], mode=branch, state=lora_state,
                           remat=remat)
        ploss = _mse(ppred, pnoise, share)
        loss = loss + weight * ploss
        aux[f"loss_prior_{branch}"] = ploss
    return loss, aux


# --------------------------------------------------- column separation

def _phase(step: int, cfg: ColumnSepConfig) -> Dict[str, bool]:
    ss, ne = cfg.sampled_steps, cfg.steps_per_epoch
    tail = step >= cfg.sample_times * ss
    pos = step % ss
    reset = pos == 0 and not tail
    sampling = pos < ne and not reset and not tail
    select = pos >= ne and (step - ne) % ss == 0 and not tail
    zeroout = not (tail or reset or sampling or select)
    return {"tail": tail, "reset": reset, "sampling": sampling,
            "select": select, "zeroout": zeroout}


def phase_name(step: int, cfg: ColumnSepConfig) -> str:
    """The one phase of `step` (PHASES)."""
    ph = _phase(step, cfg)
    return next(k for k in PHASES if ph[k])


def lora_grads(grads, path):
    """The LoRA gradient tree of the projection at `path`, from the
    gradients by trainable path."""
    base = tuple(path) + ("lora",)
    out = {b: {k: grads[base + (b, k)] for k in ("down", "up")}
           for b in BRANCHES}
    for b in BRANCHES:
        out[f"merge_{b}"] = grads[base + (f"merge_{b}",)]
    return out


def select_projection(lp, lg, st, label: str, cfg: ColumnSepConfig):
    """One projection's selection: (score_content, score_style,
    mask_content, mask_style) from its LoRA params `lp`, gradients `lg`
    (the merger terms are zeroed here: at a selection the reference's
    mergers are frozen and hold no gradient) and state `st`."""
    lg = dict(lg, merge_content=torch.zeros_like(lg["merge_content"]),
              merge_style=torch.zeros_like(lg["merge_style"]))
    score_c = cone_columns(lp, lg, "content")
    score_s = cone_columns(lp, lg, "style")
    mc, ms = select_columns(score_c, score_s, st["mask_content"],
                            st["mask_style"], ratio=cfg.column_ratio,
                            avoid=cfg.avoid and label == "both")
    if label == "style":
        mc = torch.ones_like(st["mask_content"])
    elif label == "content":
        ms = torch.ones_like(st["mask_style"])
    return score_c, score_s, mc, ms


@torch.no_grad()
def column_sep_update(lora_state, params, grads, step: int,
                      cfg: ColumnSepConfig, assignments: Dict):
    """One schedule transition of the LoRA state, in place. grads: the
    ungated gradients by trainable path; params: the tensors before this
    step's update. Returns (gates, phase): gates {projection path:
    (gate_content, gate_style)} multiplies this step's merger gradients
    and updates, taken from the masks before this transition (None where
    the phase gates nothing), phase _phase's dict. The cone and top-k run
    only at a selection step."""
    ph = _phase(step, cfg)
    gates = {}
    apply_gate = ph["zeroout"] or ph["tail"]
    for path in assignments:
        st = tree_get(lora_state, path)
        if apply_gate:
            if cfg.finetune_mask:
                gc, gs = st["mask_content"], st["mask_style"]
            else:
                gc = gs = st["mask_content"] & st["mask_style"]
            gates[path] = (gc.to(torch.float32), gs.to(torch.float32))
        else:
            gates[path] = None
    if ph["select"]:
        for path, label in assignments.items():
            st = tree_get(lora_state, path)
            picked = select_projection(tree_get(params, path)["lora"],
                                       lora_grads(grads, path), st, label,
                                       cfg)
            for key, val in zip(("score_content", "score_style",
                                 "mask_content", "mask_style"), picked):
                st[key].copy_(val)
    if ph["select"] or ph["reset"]:
        for path in assignments:
            st = tree_get(lora_state, path)
            for b in BRANCHES:
                st[f"use_mask_{b}"].fill_(bool(ph["select"]))
    return gates, ph


def apply_schedule_flags(state: Stage1State, ph):
    """(orth_on, merger_on): a selection turns both on, a reset off;
    otherwise they carry."""
    if ph["select"]:
        return True, True
    if ph["reset"]:
        return False, False
    return state.orth_on, state.merger_on


@torch.no_grad()
def clamp_mergers(params, lora_paths):
    """Mergers live in [0, 1]."""
    for path in lora_paths:
        lp = tree_get(params, path)["lora"]
        lp["merge_content"].clamp_(0.0, 1.0)
        lp["merge_style"].clamp_(0.0, 1.0)


# ------------------------------------------------------------ train step

def _merger_factors(state: Stage1State, gates, paths):
    """{trainable path of a merger: its gradient and update multiplier}
    (merger_on before this step, times the phase's gate); None where it
    is one."""
    out = {}
    for path in paths:
        for i, b in enumerate(BRANCHES):
            key = tuple(path) + ("lora", f"merge_{b}")
            if not state.merger_on:
                out[key] = 0.0
            elif gates is not None and gates[path] is not None:
                out[key] = gates[path][i]
            else:
                out[key] = None
    return out


def make_train_step(unet_cfg: UNetConfig, sched, *,
                    sep_cfg: ColumnSepConfig, assignments: Dict,
                    similarity_lambda: float = 0.5,
                    prior_weight: float = 0.0, prior_weight_2: float = 0.0,
                    remat: bool = False, dtype=None, grid=None):
    """Returns step(state, micro_batches, generator=None, draws=None,
    on_grads=None) -> metrics, which updates `state` in place. Each
    micro-batch (one per gradient-accumulation step) takes its own draws,
    from `generator` in order, or draws[i]; the gradients are summed over
    them and divided by their count, the losses averaged, then one update
    is made. on_grads(state, grads) sees the averaged, ungated gradients
    by trainable path before the column separation reads them. grid
    (parallel.mesh.Grid): the micro-batches hold this rank's rows of
    equal shares; the draws are made for the global batch, the
    gradients summed over the world first, the metrics global."""
    from video_style_transfer_tpu_torch.parallel import distributed

    paths = list(assignments)
    dp = grid.data if grid is not None else 1

    def step(state: Stage1State, micro_batches, generator=None,
             draws=None, on_grads=None):
        opt = state.optimizer
        accum = len(micro_batches)
        losses, auxs = [], []
        with tracing.span("forward_backward"):
            for i, mb in enumerate(micro_batches):
                if draws is not None:
                    dr = draws[i]
                else:
                    def whole(shape):
                        return (shape[0] * dp,) + tuple(shape[1:])
                    priors = {b: whole(mb[f"prior_{b}"]["latents"].shape)
                              for b in BRANCHES if f"prior_{b}" in mb}
                    dr = draw_stage1(sched, whole(mb["latents"].shape),
                                     priors, generator=generator,
                                     device=mb["latents"].device)
                    if dp > 1:
                        dr = grid.take(dr)
                loss, aux = stage1_loss(
                    state.params, unet_cfg, sched, mb, dr,
                    lora_state=state.lora_state, lora_paths=paths,
                    orth_on=state.orth_on,
                    similarity_lambda=similarity_lambda,
                    prior_weight=prior_weight, prior_weight_2=prior_weight_2,
                    remat=remat, dtype=dtype,
                    share=grid.size if dp > 1 else None)
                loss.backward()
                losses.append(loss.detach())
                auxs.append({k: v.detach() for k, v in aux.items()})
        with tracing.span("optimizer"):
            grads = {}
            for path, t in opt.trainable:
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                grads[path] = g / accum if accum > 1 else g
                t.grad = None
            distributed.all_reduce_tensors(list(grads.values()))
            if on_grads is not None:
                on_grads(state, grads)
            gates, ph = None, None
            if sep_cfg.enabled:
                gates, ph = column_sep_update(state.lora_state, state.params,
                                              grads, state.step, sep_cfg,
                                              assignments)
            factors = _merger_factors(state, gates, paths)
            mults = [factors.get(path) for path, _ in opt.trainable]
            gated = [grads[path] if m is None else grads[path] * m
                     for (path, _), m in zip(opt.trainable, mults)]
            opt.step(gated, gates=mults)
            clamp_mergers(state.params, paths)
        if ph is not None:
            state.orth_on, state.merger_on = apply_schedule_flags(state, ph)
        state.step += 1
        return distributed.global_metrics({
            "loss": torch.stack(losses).mean(),
            **{k: torch.stack([a[k] for a in auxs]).mean()
               for k in auxs[0]}})

    return step


def init_state(params, lora_state, optimizer, *,
               orth_on: bool = False) -> Stage1State:
    """orth_on starts off and first switches on at a selection step, so
    without the column separation the similarity loss never engages;
    orth_on=True forces it."""
    return Stage1State(params, optimizer, lora_state, orth_on, True, 0)

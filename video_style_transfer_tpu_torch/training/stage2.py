"""Stage-2 trainer: temporal-LoRA fine-tuning of the motion modules on one
video (the JAX package's training/stage2.py).

The motion UNet holds frozen SDXL + UnZipLoRA spatial weights and trains
the temporal LoRA a/b plus every motion-module weight except the
attention base projections (the reference's freeze set). The loss is the
eps- (or v-) MSE on (B, F, h, w, 4) latents with one timestep per clip,
10 % CFG prompt dropout to the empty-prompt encodings, plus the rank-space
temporal/spatial orthogonality penalty. The optimizer is AdamW with a
global-norm clip, both written to optax's formulas, its moments in fp32
or blockwise in 8 bits (training/adam8bit.py).

Freezing is ``requires_grad``: frozen tensors get no gradient and are not
in the optimizer (the port's form of optax.multi_transform +
set_to_zero), so they stay bitwise unchanged. The random draws (t,
noise, dropout) are a function of their own, so a test can hand the loss
the JAX trainer's draws.

Data and frame parallelism (a ``parallel.mesh.Grid``): every rank draws
the step's timesteps, noise and dropout flags for the whole global
batch and keeps its own clips and frames; its loss is its share (its
squared errors over the global count, the replicated orthogonality
term over the world size), so the gradients summed over the world
before the clip are one process's gradients, and the clip and the
optimizer see what one process sees.

Activations run in the UNet's dtype (bf16 at full width, as the
reference's mixed-precision autocast does; the JAX trainer feeds its f32
latents to the bf16-stored UNet and so computes in f32); the LoRA and
temporal-LoRA leaves stay f32, with no master weights.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from video_style_transfer_tpu_torch.config import UNetConfig
from video_style_transfer_tpu_torch.lora.surgery import tree_get
from video_style_transfer_tpu_torch.lora.temporal import orthogonality_loss
from video_style_transfer_tpu_torch.models.unet import unet_apply
from video_style_transfer_tpu_torch.schedulers.ddpm import (
    add_noise, velocity_target)
from video_style_transfer_tpu_torch.training.schedules import (
    make_lr_schedule)

_PROJS = ("to_q", "to_k", "to_v", "to_out")


def trainable_mask(params, *, train_mergers: bool = False,
                   train_full_motion: bool = False):
    """Tree of bools shaped like params: True = trainable. Temporal-LoRA
    a/b always; every other motion-module weight except the attention
    base projections (norms, GroupNorm, ff, proj_in/out); with
    train_full_motion the attention bases too; the UnZipLoRA mergers with
    train_mergers."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        if "tlora" in path:
            return path[-1] in ("a", "b")
        if "motion_modules" in path:
            if train_full_motion and "lora" not in path:
                return True
            is_attn_base = any(isinstance(k, str) and k in _PROJS
                               for k in path)
            return not is_attn_base
        return (train_mergers and "lora" in path
                and isinstance(path[-1], str)
                and path[-1].startswith("merge_"))
    return walk(params, ())


def iter_leaves(tree, path=()):
    """(path, leaf) of every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, path + (i,))
    else:
        yield path, tree


def split_trainable(params, mask):
    """Mark the trainable tensors (requires_grad) and freeze the rest;
    returns [(path, tensor)] of the trainable ones."""
    flags = dict(iter_leaves(mask))
    out = []
    for path, t in iter_leaves(params):
        t.requires_grad_(bool(flags[path]))
        if flags[path]:
            out.append((path, t))
    return out


def check_state_like(got, want, where="state"):
    """Raise ValueError unless `got` has the structure of `want`: the same
    dict keys, list lengths, and tensors of the same shape and dtype
    (other leaves, such as counts, are free)."""
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"{where}: a tensor was expected, got "
                             f"{type(got).__name__}")
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"{where}: {tuple(got.shape)} {got.dtype}, "
                             f"expected {tuple(want.shape)} {want.dtype}")
    elif isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{where}: keys differ")
        for k in want:
            check_state_like(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{where}: {len(got)} entries, expected "
                             f"{len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            check_state_like(g, w, f"{where}[{i}]")


def copy_state(dst, src):
    """Copy every tensor of `src` into the tensor at the same place of
    `dst` (a structure check_state_like accepted)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            copy_state(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            copy_state(d, s)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: with g_norm = ||all grads||_2, g <- g
    if g_norm < max_norm else g / g_norm * max_norm."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, ...))
    over the trainable tensors only (max_grad_norm None: no clip, for a
    caller that clips several optimizers' gradients together):

    - clip: with g_norm = ||all grads||_2, g <- g if g_norm < max_norm
      else g / g_norm * max_norm (no epsilon: torch's clip_grad_norm_
      divides by norm + 1e-6);
    - mu <- (1 - b1) g + b1 mu, nu <- (1 - b2) g^2 + b2 nu, bias-corrected
      with the incremented count; u = mu_hat / (sqrt(nu_hat) + eps) + wd p;
    - p <- p - lr(count) u, the schedule read before the increment.

    Moments are kept in each tensor's dtype, as optax does.
    ``state_dict()`` is the count and the moments as CPU copies;
    ``load_state_dict`` checks a state's structure before it copies
    anything in."""

    kind = "adamw"

    def __init__(self, params: List[torch.Tensor], schedule: Callable, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2,
                 max_grad_norm: Optional[float] = 0.5):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.init_moments()

    def init_moments(self):
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def moments(self) -> dict:
        """The live moment tensors, by name."""
        return {"mu": self.mu, "nu": self.nu}

    def state_dict(self) -> dict:
        return {"count": self.count, **_to_cpu(self.moments())}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        check_state_like(state, {"count": 0, **self.moments()},
                         f"{self.kind} state")
        copy_state(self.moments(), {k: state[k] for k in self.moments()})
        self.count = int(state["count"])

    def clip(self, grads):
        if self.max_grad_norm is None:
            return list(grads)
        return clip_by_global_norm(grads, self.max_grad_norm)

    @torch.no_grad()
    def step(self, grads, gates=None):
        """One update from `grads` (one per tensor). `gates`: None, or one
        multiplier per tensor (None for none), applied to the update
        before it is added (the moments and the count move regardless,
        as optax's do when a caller gates its updates)."""
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        gates = gates or [None] * len(self.params)
        for p, g, m, v, gate in zip(self.params, self.clip(grads), self.mu,
                                    self.nu, gates):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u.add_(p, alpha=self.weight_decay)
            if gate is not None:
                u = u * gate
            p.add_(u, alpha=-lr)


OPTIMIZERS = ("adamw", "adamw8bit")


def make_optimizer(params: List[torch.Tensor], *, lr: float = 2e-5,
                   total_steps: int = 1000, warmup: int = 100,
                   weight_decay: float = 1e-2, max_grad_norm: float = 0.5,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   schedule: str = "cosine", num_cycles: int = 1,
                   power: float = 1.0, optimizer: str = "adamw") -> AdamW:
    """AdamW + cosine decay with warmup + clip 0.5 (the reference's
    stage-2 defaults) over the trainable tensors; ``adamw8bit`` keeps the
    moments blockwise in 8 bits (training/adam8bit.py)."""
    sched = make_lr_schedule(schedule, lr, warmup=warmup,
                             total_steps=total_steps, num_cycles=num_cycles,
                             power=power)
    if optimizer == "adamw":
        cls = AdamW
    elif optimizer == "adamw8bit":
        from video_style_transfer_tpu_torch.training.adam8bit import (
            AdamW8bit)
        cls = AdamW8bit
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}; one of "
                         f"{OPTIMIZERS}")
    return cls(params, sched, b1=b1, b2=b2, eps=eps,
               weight_decay=weight_decay, max_grad_norm=max_grad_norm)


def draw_stage2(sched, latent_shape, *, cfg_dropout: float,
                generator: torch.Generator, device):
    """The per-step draws of stage2_loss: one timestep per clip
    t (B,) int64, the noise (B, F, h, w, 4) f32 and the CFG-dropout flags
    drop (B,) bool."""
    b = latent_shape[0]
    t = torch.randint(0, sched["num_train_timesteps"], (b,),
                      generator=generator, device=device)
    noise = torch.randn(latent_shape, generator=generator, device=device,
                        dtype=torch.float32)
    drop = torch.rand((b,), generator=generator, device=device) < cfg_dropout
    return {"t": t, "noise": noise, "drop": drop}


def stage2_loss(params, unet_cfg: UNetConfig, sched, batch, draws, *,
                pairs, lambda_orth: float = 1e-4,
                prediction_type: str = "epsilon", mode: str = "both",
                state=None, remat: bool = False, dtype=None,
                frame_shard=None, share=None):
    """batch: latents (B, F, h, w, 4) scaled, ctx (B, S, D), pooled
    (B, P), time_ids (B, 6), optionally uncond_ctx / uncond_pooled (the
    encoded empty prompt; zeros otherwise). draws: draw_stage2's dict.
    remat: unet_apply's. dtype: the UNet's activation dtype (default: its
    weights'). frame_shard: unet_apply's (F is then this rank's frames).
    share: None, or (the global batch's latent element count, the world
    size) for a rank's share of the loss (module docstring). Returns
    (loss, {"loss_mse", "loss_orth"})."""
    latents = batch["latents"]
    b, f = latents.shape[:2]
    if dtype is None:
        dtype = params["conv_in"]["weight"].dtype
    t = draws["t"]
    t_rows = t.repeat_interleave(f)
    rows = latents.reshape(b * f, *latents.shape[2:])
    noise_rows = draws["noise"].to(latents.dtype).reshape(rows.shape)
    noisy = add_noise(sched, rows, noise_rows, t_rows)

    drop = draws["drop"].reshape(b, 1, 1)
    uncond_ctx = batch.get("uncond_ctx")
    if uncond_ctx is None:
        uncond_ctx = torch.zeros_like(batch["ctx"])
    uncond_pooled = batch.get("uncond_pooled")
    if uncond_pooled is None:
        uncond_pooled = torch.zeros_like(batch["pooled"])
    ctx = torch.where(drop, uncond_ctx, batch["ctx"])
    pooled = torch.where(drop[:, :, 0], uncond_pooled, batch["pooled"])

    pred = unet_apply(params, unet_cfg, noisy.to(dtype), t,
                      (ctx.to(dtype), None, None), pooled,
                      batch["time_ids"], num_frames=f, mode=mode,
                      state=state, remat=remat, frame_shard=frame_shard)
    if prediction_type == "v_prediction":
        target = velocity_target(sched, rows, noise_rows, t_rows)
    else:
        target = noise_rows
    err = (pred.float() - target.float()) ** 2
    loss_mse = torch.mean(err) if share is None else \
        torch.sum(err) / share[0]

    loss_orth = torch.zeros((), device=latents.device)
    if lambda_orth > 0.0 and pairs:
        total = sum(orthogonality_loss(tree_get(params, tp),
                                       tree_get(params, sp))
                    for tp, sp in pairs)
        loss_orth = lambda_orth * total / len(pairs)
        if share is not None:
            loss_orth = loss_orth / share[1]
    return loss_mse + loss_orth, {"loss_mse": loss_mse,
                                  "loss_orth": loss_orth}


def make_train_step(unet_cfg: UNetConfig, sched, optimizer: AdamW, pairs, *,
                    lambda_orth: float = 1e-4, cfg_dropout: float = 0.1,
                    prediction_type: str = "epsilon", mode: str = "both",
                    lora_state=None, dtype=None, grid=None):
    """Returns step(params, micro_batches, generator, on_grads=None) ->
    metrics. Each micro-batch (one per gradient-accumulation step) gets
    its own draws; the gradients are summed over them and divided by
    their count, the loss averaged, then one optimizer update is made;
    on_grads(grads) sees the gradients (one per optimizer tensor) just
    before it. Every activation is
    stored (no remat): the 8-frame 1024^2 step fits one 80 GB card.
    grid (parallel.mesh.Grid): the micro-batches hold this rank's clips
    and frames of the global batch (equal shares); the draws are made
    for the global batch, the gradients summed over the world before the
    update, and the metrics are the global batch's."""
    from video_style_transfer_tpu_torch.parallel import distributed

    def step(params, micro_batches, generator: torch.Generator,
             on_grads=None):
        accum = len(micro_batches)
        losses, auxs = [], []
        for mb in micro_batches:
            shape = tuple(mb["latents"].shape)
            shard, share = None, None
            if grid is not None and grid.size > 1:
                shape = (shape[0] * grid.data, shape[1] * grid.frame) \
                    + shape[2:]
                shard = grid.frame_shard(shape[1])
                share = (math.prod(shape), grid.size)
            dr = draw_stage2(sched, shape, cfg_dropout=cfg_dropout,
                             generator=generator,
                             device=mb["latents"].device)
            if share is not None:
                dr = grid.take(dr, frames=True)
            loss, aux = stage2_loss(
                params, unet_cfg, sched, mb, dr, pairs=pairs,
                lambda_orth=lambda_orth, prediction_type=prediction_type,
                mode=mode, state=lora_state, dtype=dtype, frame_shard=shard,
                share=share)
            loss.backward()
            losses.append(loss.detach())
            auxs.append({k: v.detach() for k, v in aux.items()})
        grads = []
        for p in optimizer.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g / accum if accum > 1 else g)
            p.grad = None
        distributed.all_reduce_tensors(grads)
        if on_grads is not None:
            on_grads(grads)
        optimizer.step(grads)
        metrics = {"loss": torch.stack(losses).mean(),
                   **{k: torch.stack([a[k] for a in auxs]).mean()
                      for k in auxs[0]}}
        return distributed.global_metrics(metrics)

    return step

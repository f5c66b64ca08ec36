"""Prodigy (Mishchenko and Defazio, "Prodigy: An Expeditiously Adaptive
Parameter-Free Learner", 2023): AdamW whose step size D is estimated as
it trains, for one group of tensors. This is the port's own copy of the
formulas of optax 0.2.6's ``optax.contrib.prodigy``, which the JAX
package's stage-1 optimizer uses; it needs no package.

At update count k (0 first), with lr(k) the group's schedule and D the
current estimate (estim_lr, starting at ESTIM_LR0):

    bc   = sqrt(1 - b2^(k+1)) / (1 - b1^(k+1))
    dlr  = D lr(k) bc
    dg   = D g
    m    = b1 m + (1 - b1) dg,   v = b2 v + (1 - b2) dg^2
    s    = b3 s + D dg / ESTIM_LR0      (safeguard_warmup; else dlr dg /
                                          ESTIM_LR0)
    num  = b3 num + (D / ESTIM_LR0) dlr <g, p0 - p>
    D    = max(D, ESTIM_LR_COEF num / sum |s|)
    p   += -wd dlr p - dlr m / (sqrt(v) + D eps)   (D the new estimate)

It is always decoupled (weight decay outside the Adam ratio) and bias
corrected, as optax's is. b3 defaults to sqrt(b2). <g, p0 - p> and sum |s|
run over every tensor of the group, so each group adapts its own D; the
group's learning rate multiplies the adapted step, as the reference's
per-group "lr" does. The scalars (D, num) stay on the tensors' device,
in their dtype.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from video_style_transfer_tpu_torch.training.stage2 import AdamW

# optax's defaults, which the JAX package's stage-1 optimizer keeps
ESTIM_LR0 = 1e-6
ESTIM_LR_COEF = 1.0


class Prodigy(AdamW):
    """The interface of ``training.stage2.AdamW`` (clip, step with an
    update gate, state_dict): the state is the count, the moments m and
    v, the weighted gradient sum s, the initial tensors p0, D and num."""

    kind = "prodigy"

    def __init__(self, params: List[torch.Tensor], schedule: Callable, *,
                 b1: float = 0.9, b2: float = 0.999,
                 beta3: Optional[float] = None, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = None,
                 safeguard_warmup: bool = False):
        self.beta3 = b2 ** 0.5 if beta3 is None else beta3
        self.safeguard_warmup = safeguard_warmup
        super().__init__(params, schedule, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay,
                         max_grad_norm=max_grad_norm)

    def init_moments(self):
        dev = self.params[0].device if self.params else "cpu"
        # the scalars take the tensors' least precise dtype, as optax's do
        dtype = min((p.dtype for p in self.params),
                    key=lambda d: torch.finfo(d).bits,
                    default=torch.float32)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.grad_sum = [torch.zeros_like(p) for p in self.params]
        self.params0 = [p.detach().clone() for p in self.params]
        self.estim_lr = torch.tensor(ESTIM_LR0, dtype=dtype, device=dev)
        self.numerator = torch.zeros((), dtype=dtype, device=dev)

    def moments(self) -> dict:
        return {"exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq,
                "grad_sum": self.grad_sum, "params0": self.params0,
                "estim_lr": self.estim_lr, "numerator": self.numerator}

    @torch.no_grad()
    def step(self, grads, gates=None):
        grads = self.clip(grads)
        gates = gates or [None] * len(self.params)
        sched = self.schedule(self.count)
        self.count += 1
        dt = self.estim_lr.dtype
        c = torch.tensor(self.count, dtype=torch.int32)
        bc = ((1 - torch.tensor(self.b2, dtype=torch.float32) ** c) ** 0.5
              / (1 - torch.tensor(self.b1, dtype=torch.float32) ** c))
        d = self.estim_lr
        dlr = (d * sched * bc.to(d.device)).to(dt)
        dgs = [d * g for g in grads]
        num_acc = sum(torch.sum(g * (p0 - p)) for g, p0, p in
                      zip(grads, self.params0, self.params))
        b1, b2, b3 = self.b1, self.b2, self.beta3
        for i, dg in enumerate(dgs):
            self.exp_avg[i] = b1 * self.exp_avg[i] + (1 - b1) * dg
            self.exp_avg_sq[i] = b2 * self.exp_avg_sq[i] + (1 - b2) * dg * dg
            scale = d if self.safeguard_warmup else dlr
            self.grad_sum[i] = (b3 * self.grad_sum[i]
                                + scale * dg / ESTIM_LR0)
        self.numerator = (b3 * self.numerator
                          + (d / ESTIM_LR0) * dlr * num_acc).to(dt)
        denominator = sum(torch.sum(torch.abs(s)) for s in self.grad_sum)
        estimate = ESTIM_LR_COEF * self.numerator / denominator
        self.estim_lr = torch.maximum(d, estimate.to(dt))
        for p, ea, eas, gate in zip(self.params, self.exp_avg,
                                    self.exp_avg_sq, gates):
            u = (-self.weight_decay * dlr * p
                 - dlr * ea / (torch.sqrt(eas) + self.estim_lr * self.eps))
            if gate is not None:
                u = u * gate
            p.add_(u)

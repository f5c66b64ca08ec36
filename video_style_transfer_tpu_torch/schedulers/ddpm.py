"""Diffusion noise schedule (SDXL scaled_linear, 1000 steps) as host
numpy tables, and the DDPM training helpers."""
from __future__ import annotations

import numpy as np
import torch


def make_schedule(num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012):
    """scaled_linear betas; returns a dict of tables (fp64 setup, fp32
    tables)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return {
        "num_train_timesteps": num_train_timesteps,
        "betas": betas.astype(np.float32),
        "alphas_cumprod": alphas_cumprod.astype(np.float32),
    }


def _coefs(sched, t, x0):
    acp = torch.as_tensor(sched["alphas_cumprod"], device=x0.device)[
        torch.as_tensor(t, device=x0.device)]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (torch.sqrt(acp).reshape(shape).to(x0.dtype),
            torch.sqrt(1.0 - acp).reshape(shape).to(x0.dtype))


def add_noise(sched, x0, noise, t):
    """x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps; t: (B,) integer."""
    sqrt_acp, sqrt_1m = _coefs(sched, t, x0)
    return sqrt_acp * x0 + sqrt_1m * noise


def velocity_target(sched, x0, noise, t):
    """v = sqrt(acp_t) eps - sqrt(1 - acp_t) x0 (v-prediction)."""
    sqrt_acp, sqrt_1m = _coefs(sched, t, x0)
    return sqrt_acp * noise - sqrt_1m * x0

"""Euler discrete sampler (diffusers' "leading" spacing, steps_offset 1,
linear sigma interpolation). The table is built in host numpy; the step
math runs on tensors."""
from __future__ import annotations

import numpy as np
import torch


def euler_timetable(sched, num_inference_steps: int):
    """"leading" spacing with steps_offset 1 (the SDXL pipeline's).
    Returns {"timesteps": (steps,) f32, "sigmas": (steps+1,) f32 with a
    final 0, "init_sigma": float} as numpy."""
    t_max = sched["num_train_timesteps"]
    acp = np.asarray(sched["alphas_cumprod"], np.float64)
    sigmas_full = np.sqrt((1 - acp) / acp)
    ratio = t_max // num_inference_steps
    timesteps = (np.arange(num_inference_steps) * ratio).round()[::-1] + 1.0
    sigmas = np.concatenate([np.interp(timesteps, np.arange(t_max),
                                       sigmas_full), [0.0]])
    init_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)
    return {"timesteps": timesteps.astype(np.float32),
            "sigmas": sigmas.astype(np.float32),
            "init_sigma": float(np.float32(init_sigma))}


def scale_model_input(sample, sigma: float):
    """x / sqrt(sigma^2 + 1)."""
    return sample / torch.tensor(float(np.sqrt(np.float32(sigma) ** 2 + 1)),
                                 dtype=torch.float32).to(sample.dtype)


def euler_step(sample, model_output, sigma: float, sigma_next: float):
    """One deterministic Euler step (s_churn = 0, epsilon prediction) in
    f32; `sample` is the unscaled latent."""
    sigma = float(np.float32(sigma))
    sigma_next = float(np.float32(sigma_next))
    x = sample.float()
    denoised = x - sigma * model_output.float()
    derivative = (x - denoised) / sigma
    return (x + derivative * (sigma_next - sigma)).to(sample.dtype)

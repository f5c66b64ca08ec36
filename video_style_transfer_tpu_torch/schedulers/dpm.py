"""DPM-Solver++ (2M, midpoint). VP formulation: alpha_t = sqrt(acp),
sigma_t = sqrt(1 - acp), lambda = log(alpha / sigma). The table is built
in host numpy (f64 setup, f32 tables, as the Euler one); the step's
coefficients are f32 host scalars and its math runs on tensors in f32."""
from __future__ import annotations

import numpy as np
import torch


def dpm_timetable(sched, num_inference_steps: int, *,
                  timestep_spacing: str = "leading", steps_offset: int = 1,
                  final_sigma: str = "zero"):
    """{"timesteps": (steps,), "alpha", "sigma", "lambda": (steps+1,)},
    f32 numpy.

    "leading" follows diffusers' DPMSolverMultistepScheduler, which
    divides by steps + 1 (unlike EulerDiscrete): ratio = T // (steps+1),
    timesteps = (arange(steps+1) * ratio).round()[::-1][:-1] +
    steps_offset. final_sigma "zero" ends the trajectory at (alpha 1,
    sigma 0), so the last update returns the x0 prediction exactly;
    "sigma_min" ends it at sigma(t=0)."""
    t_max = sched["num_train_timesteps"]
    acp_full = np.asarray(sched["alphas_cumprod"], np.float64)
    if timestep_spacing == "leading":
        ratio = t_max // (num_inference_steps + 1)
        timesteps = (np.arange(num_inference_steps + 1)
                     * ratio).round()[::-1][:-1]
        timesteps = timesteps.astype(np.int64) + steps_offset
    elif timestep_spacing == "linspace":
        timesteps = np.linspace(0, t_max - 1, num_inference_steps + 1) \
            .round().astype(np.int64)[::-1][:-1]
    else:
        raise ValueError(timestep_spacing)
    acp = acp_full[np.clip(timesteps, 0, t_max - 1)]
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1 - acp)
    if final_sigma == "zero":
        alpha = np.concatenate([alpha, [1.0]])
        sigma = np.concatenate([sigma, [0.0]])
    elif final_sigma == "sigma_min":
        alpha = np.concatenate([alpha, [np.sqrt(acp_full[0])]])
        sigma = np.concatenate([sigma, [np.sqrt(1 - acp_full[0])]])
    else:
        raise ValueError(final_sigma)
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-30))
    return {"timesteps": timesteps.astype(np.float32),
            "alpha": alpha.astype(np.float32),
            "sigma": sigma.astype(np.float32),
            "lambda": lam.astype(np.float32)}


def to_x0(sample, model_output, alpha_t, sigma_t, *,
          prediction_type: str = "epsilon"):
    """The clean-sample prediction, in f32."""
    alpha_t, sigma_t = float(alpha_t), float(sigma_t)
    x, out = sample.float(), model_output.float()
    if prediction_type == "epsilon":
        return (x - sigma_t * out) / alpha_t
    if prediction_type == "v_prediction":
        return alpha_t * x - sigma_t * out
    if prediction_type == "sample":
        return out
    raise ValueError(prediction_type)


def dpm_init_carry(shape, device="cpu"):
    """(prev_x0, prev_lambda, have_prev) multistep memory."""
    return (torch.zeros(shape, dtype=torch.float32, device=device), 0.0,
            False)


def dpm_step(sample, x0, carry, idx: int, table):
    """One DPM-Solver++ update from trajectory point idx to idx + 1.
    Returns (new_sample, new_carry). The first and the terminal step are
    first order, the others 2M midpoint."""
    prev_x0, prev_lam, have_prev = carry
    x, x0 = sample.float(), x0.float()
    f32 = np.float32
    lam_s, lam_t = f32(table["lambda"][idx]), f32(table["lambda"][idx + 1])
    sig_s, sig_t = f32(table["sigma"][idx]), f32(table["sigma"][idx + 1])
    alp_t = f32(table["alpha"][idx + 1])
    terminal = bool(sig_t <= 0.0)
    h = lam_t - lam_s
    r = (lam_s - f32(prev_lam)) / (f32(1.0) if h == 0 else h)
    d = x0
    if have_prev and not terminal:
        d = x0 + 0.5 * ((x0 - prev_x0) / float(f32(1.0) if r == 0 else r))
    ratio = f32(0.0) if terminal else sig_t / (f32(1.0) if sig_s == 0
                                               else sig_s)
    phi = f32(-1.0) if terminal else np.expm1(-h)
    new_x = float(ratio) * x - float(alp_t * phi) * d
    return new_x.to(sample.dtype), (x0, float(lam_s), True)

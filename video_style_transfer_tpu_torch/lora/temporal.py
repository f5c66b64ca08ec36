"""Temporal LoRA on the motion-module attention projections (the JAX
package's lora/temporal.py): a frozen base linear plus ``(alpha/rank) *
x @ a @ b`` with a ~ N(0, 0.01) (in, r) and b = 0 (r, out), so the delta
is zero at step 0. The adapter sits under key ``tlora`` of a
projection's params: {"a", "b", "scale"}, scale a 0-d tensor."""
from __future__ import annotations

import torch


def init_temporal_lora(ini, in_features: int, out_features: int, *,
                       rank: int = 32, alpha: float = 1.0,
                       init_std: float = 0.01, dtype=torch.float32):
    return {
        "a": ini.normal((in_features, rank), init_std, dtype),
        "b": torch.zeros((rank, out_features), dtype=dtype,
                         device=ini.device),
        "scale": torch.tensor(alpha / rank, dtype=dtype, device=ini.device),
    }


def apply_temporal_lora(p, x, x32=None):
    """fp32 rank-space delta, rounded once to x's dtype. x32: x already
    cast to fp32 (shared by projections of the same input)."""
    if x32 is None:
        x32 = x.float()
    y = (x32 @ p["a"].float()) @ p["b"].float()
    return (y * p["scale"].float()).to(x.dtype)


def temporal_delta(p):
    """Composed (in, out) delta with the scale applied."""
    return (p["a"] @ p["b"]) * p["scale"]


def orthogonality_loss(tlora, spatial_lora):
    """||W_t^T W_c||_F^2 + ||W_t^T W_s||_F^2 for one paired layer, in
    rank space: with D = a b, ||D_t D_c^T||_F^2 = tr(Q^T H_t Q H_c), Q =
    b_t b_c^T, H = a^T a; no (in, in) or (out, in) matrix is formed. The
    spatial LoRAs are detached (frozen stage-1 weights)."""
    a_t = tlora["a"].float()                                    # (in, rt)
    b_t = tlora["b"].float() * tlora["scale"].float()           # (rt, out)
    h_t = a_t.t() @ a_t                                         # (rt, rt)

    def one(branch):
        a = spatial_lora[branch]["down"].detach().float()       # (in, rc)
        b = spatial_lora[branch]["up"].detach().float()         # (rc, out)
        q = b_t @ b.t()                                         # (rt, rc)
        h_c = a.t() @ a                                         # (rc, rc)
        return ((q.t() @ h_t @ q) * h_c).sum()

    return one("content") + one("style")

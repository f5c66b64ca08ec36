"""Kernel categories by name, first match wins: a frozen copy of the
program's ``cli/profile_step.py`` CATEGORIES (cuDNN's convolutions are
implicit GEMMs by name). The hand-written kernels K1-K7 are launched
only by the program's op entries, so their categories are the device
time those entries launch."""
from __future__ import annotations

CATEGORIES = (
    ("K1 flash_attention_fwd (wgmma)", ("flash_fwd_sm90_",)),
    ("K1 flash_attention_fwd (fma)", ("flash_fwd_f32_kernel",)),
    ("K1 flash_attention_fwd (kv-split combine)", ("flash_combine_kernel",)),
    ("K1 flash_attention_fwd (tf32x3)", ("flash_fwd_tf32_kernel",)),
    ("K2 geglu_projection", ("geglu_bf16_kernel", "geglu_f32_kernel",
                             "geglu_split_w_kernel")),
    ("K3 temporal_attention", ("ta_fwd_mma_kernel",)),
    ("K4 flash_attention_bwd", ("flash_bwd_",)),
    ("K5 temporal_attention_bwd", ("ta_bwd_mma_kernel",)),
    ("K7 layer_norm", ("::layer_norm_kernel",)),
    ("K7 layer_norm dscale/dbias", ("layer_norm_affine_grad",)),
    ("layer_norm backward (aten)", ("layer_norm_grad", "gammabetabackward")),
    ("layer_norm (library)", ("layer_norm", "layernorm")),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "winograd")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
)

OTHER = "other"


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return OTHER


def kernel_id(cat: str):
    """"K1" ... "K7" for a hand-written kernel's category, else None."""
    head = cat.split(" ", 1)[0]
    return head if head[:1] == "K" and head[1:].isdigit() else None

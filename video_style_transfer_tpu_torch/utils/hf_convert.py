"""HF/diffusers checkpoint <-> the port's parameter trees.

The port stores weights in PyTorch's own layouts (linear (out, in), conv
OIHW, norm weight/bias) and keeps one dict per layer, so a diffusers
state dict maps onto the tree by name alone: no transposes and no
stacking (the JAX converter's work). The mapping is generated by walking
a params template, so loading and exporting are the same table run in
opposite directions. Templates may live on the ``meta`` device
(``models.layers.MetaInit``): key names and shapes need no storage, and
``load_sdxl`` fills such a template tensor by tensor, each moved to the
device in its target dtype as it is read.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from video_style_transfer_tpu_torch.config import (
    CLIPConfig, UNetConfig, VAEConfig)
from video_style_transfer_tpu_torch.lora.surgery import (
    copy_structure, tree_get)
from video_style_transfer_tpu_torch.utils import safetensors_io

_FF_MAP = {"proj": "net.0.proj", "out": "net.2"}
_PROJ_MAP = {"to_out": "to_out.0"}
_PARAM_KEYS = ("weight", "bias")


def _walk(tree, path=()):
    """Yield (path, module_dict) for every parameterised leaf module (a
    dict holding a ``weight`` tensor); LoRA adapters are skipped."""
    if isinstance(tree, dict):
        if isinstance(tree.get("weight"), torch.Tensor):
            yield path, tree
            return
        for k, v in tree.items():
            if k in ("lora", "tlora"):
                continue
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


def _hf_name(path: Tuple) -> str:
    """A tree path as the diffusers module name."""
    parts: List[str] = []
    i = 0
    while i < len(path):
        k = path[i]
        if k == "ff" and i + 1 < len(path):
            parts.append("ff." + _FF_MAP[path[i + 1]])
            i += 2
            continue
        parts.append(_PROJ_MAP.get(k, str(k)) if isinstance(k, str)
                     else str(k))
        i += 1
    return ".".join(parts)


def _index(template, select=None) -> Dict[str, Tuple]:
    """checkpoint key -> path of the tensor in the tree."""
    out = {}
    for path, mod in _walk(template):
        if select is not None and not select(path):
            continue
        name = _hf_name(path)
        for key in _PARAM_KEYS:
            if key in mod:
                out[f"{name}.{key}"] = path + (key,)
    return out


def state_dict_keys(template, select=None) -> set:
    """The exact set of checkpoint keys convert_to_params consumes and
    export_to_state_dict emits for this template."""
    return set(_index(template, select))


def state_dict_shapes(template, select=None) -> Dict[str, Tuple[int, ...]]:
    """checkpoint key -> the shape convert_to_params accepts for it
    (torch convention, which is also the tree's)."""
    return {k: tuple(tree_get(template, p).shape)
            for k, p in _index(template, select).items()}


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _items(sd) -> Iterable:
    return sd.items() if isinstance(sd, dict) else sd


def _tensor(a, device, dtype):
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def _fill(template, index: Dict[str, Tuple], sd, *, dtype, device,
          strict: bool, warn_unexpected: bool, label: str):
    out = copy_structure(template)
    seen, unexpected = set(), []
    for name, t in _items(sd):
        path = index.get(name)
        if path is None:
            unexpected.append(name)
            continue
        want = tuple(tree_get(template, path).shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{label} checkpoint shape mismatch at {name}: "
                             f"{tuple(t.shape)} != {want}")
        _put(out, path, _tensor(t, device, dtype))
        seen.add(name)
    missing = [k for k in index if k not in seen]
    if strict and missing:
        raise KeyError(f"{label}: {len(missing)} missing keys, e.g. "
                       f"{missing[:5]}")
    for name in missing:
        # a template leaf the checkpoint has no value for (the motion
        # modules of a plain SDXL UNet file) stays zero
        leaf = tree_get(template, index[name])
        if leaf.device.type == "meta":
            _put(out, index[name], torch.zeros(leaf.shape, dtype=dtype,
                                               device=device))
    if unexpected and warn_unexpected:
        warnings.warn(f"{label}: {len(unexpected)} checkpoint keys not "
                      f"consumed by the template, e.g. "
                      f"{sorted(unexpected)[:5]}")
    return out


def convert_to_params(sd, template, *, dtype=torch.float32, device="cpu",
                      strict: bool = True, select=None):
    """Fill a template from a diffusers state dict (a dict, or an
    iterable of (name, tensor) pairs read one at a time). Returns a new
    tree; leaves outside `select` are the template's own."""
    return _fill(template, _index(template, select), sd, dtype=dtype,
                 device=device, strict=strict, warn_unexpected=True,
                 label="convert_to_params")


def export_to_state_dict(params, select=None) -> Dict[str, np.ndarray]:
    """Inverse of convert_to_params, as float32 numpy."""
    return {k: tree_get(params, p).detach().float().cpu().numpy()
            for k, p in _index(params, select).items()}


# ---------------------------------------------------------------------------
# CLIP (transformers CLIPTextModel naming)
# ---------------------------------------------------------------------------

def _clip_index(cfg: CLIPConfig) -> Dict[str, Tuple]:
    pre = "text_model."
    idx = {
        pre + "embeddings.token_embedding.weight": ("token_embedding",),
        pre + "embeddings.position_embedding.weight":
            ("position_embedding",),
    }
    for key in _PARAM_KEYS:
        idx[f"{pre}final_layer_norm.{key}"] = ("final_layer_norm", key)
    for i in range(cfg.num_layers):
        base = f"{pre}encoder.layers.{i}."
        for key in _PARAM_KEYS:
            for ln in ("layer_norm1", "layer_norm2"):
                idx[f"{base}{ln}.{key}"] = ("layers", i, ln, key)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                idx[f"{base}self_attn.{proj}.{key}"] = ("layers", i, proj,
                                                        key)
            for fc in ("fc1", "fc2"):
                idx[f"{base}mlp.{fc}.{key}"] = ("layers", i, fc, key)
    if cfg.projection_dim is not None:
        idx["text_projection.weight"] = ("text_projection", "weight")
    return idx


def clip_source_shapes(cfg: CLIPConfig) -> Dict[str, Tuple[int, ...]]:
    """checkpoint key -> the shape convert_clip requires."""
    from video_style_transfer_tpu_torch.models.clip import init_clip
    from video_style_transfer_tpu_torch.models.layers import MetaInit
    template = init_clip(MetaInit(), cfg)
    return {k: tuple(tree_get(template, p).shape)
            for k, p in _clip_index(cfg).items()}


def convert_clip(sd, cfg: CLIPConfig, dtype=torch.float32, device="cpu"):
    """transformers CLIPTextModel(-WithProjection) state dict -> the
    port's CLIP params. Buffers the model does not use
    (text_model.embeddings.position_ids) are ignored; every consumed
    tensor is shape-checked."""
    from video_style_transfer_tpu_torch.models.clip import init_clip
    from video_style_transfer_tpu_torch.models.layers import MetaInit
    return _fill(init_clip(MetaInit(dtype), cfg), _clip_index(cfg), sd,
                 dtype=dtype, device=device, strict=True,
                 warn_unexpected=False, label="clip")


# ---------------------------------------------------------------------------
# A diffusers-layout SDXL directory
# ---------------------------------------------------------------------------

def _iter_safetensors_dir(path: str, skip=None):
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    for fname in files:
        for name, t in safetensors_io.iter_file(os.path.join(path, fname)):
            if skip is None or not skip(name):
                yield name, t


def load_sdxl(model_dir: str, *, dtype=torch.bfloat16, with_motion=False,
              vae_dir=None, configs=None, device="cpu",
              encoder: bool = False):
    """Load a diffusers-layout SDXL directory (unet/ vae/ text_encoder/
    text_encoder_2/) into the port's trees on `device`: the UNet and the
    CLIPs in `dtype`, the VAE in fp32. Returns {"unet": (params, cfg),
    "vae": (decoder params, cfg), "vae_encoder": encoder params or None,
    "clip_l": ..., "clip_g": ...}.

    vae_dir: a separate VAE checkpoint, either a bare VAE directory or a
    diffusers repo with a vae/ subdirectory. configs: optional (UNet,
    VAE, CLIP-L, CLIP-bigG) configs for checkpoints of another size. With
    with_motion the motion modules, which an SDXL UNet file lacks, are
    zeros until a motion checkpoint is imported."""
    from video_style_transfer_tpu_torch.models.layers import MetaInit
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.models.vae import (
        init_vae_decoder, init_vae_encoder)

    if not os.path.isdir(os.path.join(model_dir, "unet")):
        raise FileNotFoundError(
            f"not a diffusers SDXL directory (no unet/): {model_dir}")
    if configs is None:
        ucfg = UNetConfig.sdxl(use_motion_modules=with_motion)
        vcfg = VAEConfig.sdxl()
        lcfg = CLIPConfig.sdxl_clip_l()
        gcfg = CLIPConfig.sdxl_big_g()
    else:
        ucfg, vcfg, lcfg, gcfg = configs

    unet = convert_to_params(
        _iter_safetensors_dir(os.path.join(model_dir, "unet")),
        init_unet(MetaInit(dtype), ucfg), dtype=dtype, device=device,
        strict=not with_motion)
    vdir = os.path.join(model_dir, "vae")
    if vae_dir:
        nested = os.path.join(vae_dir, "vae")
        vdir = nested if os.path.isdir(nested) else vae_dir
    vae_t = init_vae_decoder(MetaInit(), vcfg)
    skip = None
    if encoder:
        vae_t.update(init_vae_encoder(MetaInit(), vcfg))
    else:
        def skip(name):
            return name.startswith(("encoder.", "quant_conv."))
    vae = convert_to_params(_iter_safetensors_dir(vdir, skip), vae_t,
                            dtype=torch.float32, device=device)
    vae_encoder = None
    if encoder:
        vae_encoder = {k: vae.pop(k) for k in ("encoder", "quant_conv")}
    clip_l = convert_clip(
        _iter_safetensors_dir(os.path.join(model_dir, "text_encoder")),
        lcfg, dtype, device)
    clip_g = convert_clip(
        _iter_safetensors_dir(os.path.join(model_dir, "text_encoder_2")),
        gcfg, dtype, device)
    return {"unet": (unet, ucfg), "vae": (vae, vcfg),
            "vae_encoder": vae_encoder,
            "clip_l": (clip_l, lcfg), "clip_g": (clip_g, gcfg)}

"""Turn the JAX package's parameter pytrees (as numpy arrays) into the
port's parameters: the inverse of the JAX layouts (linear (in, out) ->
(out, in), conv HWIO -> OIHW, norm ``scale`` -> ``weight``), with the
layer-stacked subtrees (leading layer axis) split into per-layer lists.
A projection's ``lora`` (UnZipLoRA down/up/mergers) and ``tlora``
(temporal LoRA a/b/scale) keep the JAX orientation and stay f32; the
UnZipLoRA state tree keeps its dict layout and dtypes, its stacked
``transformer_blocks`` split into per-layer dict entries. Leaves may be
any array type ``numpy.asarray`` accepts."""
from __future__ import annotations

import numpy as np
import torch

# subtrees whose leaves carry a leading layer axis in the JAX layout
_STACKED = ("transformer_blocks", "layers")


def _tensor(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_take(v, i) for v in tree]
    return np.asarray(tree)[i]


def convert_tree(tree, dtype=torch.float32):
    """Convert a JAX param tree or subtree (``init_unet`` with motion
    modules, ``init_clip``, any block of them)."""
    if isinstance(tree, dict):
        if "kernel" in tree:
            k = np.asarray(tree["kernel"])
            if k.ndim == 2:
                w = k.T
            elif k.ndim == 4:
                w = k.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"kernel of rank {k.ndim}")
            out = {"weight": _tensor(w, dtype)}
            if tree.get("bias") is not None:
                out["bias"] = _tensor(tree["bias"], dtype)
            for key in ("lora", "tlora"):
                if key in tree:
                    out[key] = convert_tree(tree[key], torch.float32)
            return out
        if set(tree) == {"scale", "bias"}:
            return {"weight": _tensor(tree["scale"], dtype),
                    "bias": _tensor(tree["bias"], dtype)}
        out = {}
        for key, val in tree.items():
            if key in _STACKED:
                n = np.asarray(next(_leaves(val))).shape[0]
                out[key] = [convert_tree(_take(val, i), dtype)
                            for i in range(n)]
            else:
                out[key] = convert_tree(val, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [convert_tree(v, dtype) for v in tree]
    return _tensor(tree, dtype)


def convert_lora_state(state):
    """JAX ``insert_unziplora`` state tree -> the port's: the same dicts
    (integer keys included), bool and f32 leaves as they are, the stacked
    ``transformer_blocks`` split into {layer: entry}."""
    if isinstance(state, dict):
        out = {}
        for key, val in state.items():
            if key in _STACKED:
                n = np.asarray(next(_leaves(val))).shape[0]
                out[key] = {i: convert_lora_state(_take(val, i))
                            for i in range(n)}
            else:
                out[key] = convert_lora_state(val)
        return out
    return torch.from_numpy(np.array(state))


def convert_vae_encoder(params, dtype=torch.float32):
    """JAX ``init_vae`` tree -> port encoder params (the decoder and
    post_quant_conv are dropped)."""
    return convert_tree({"encoder": params["encoder"],
                         "quant_conv": params["quant_conv"]}, dtype)


def convert_vae_decoder(params, dtype=torch.float32):
    """JAX ``init_vae`` tree -> port decoder params (the encoder and
    quant_conv are dropped)."""
    return convert_tree({"decoder": params["decoder"],
                         "post_quant_conv": params["post_quant_conv"]},
                        dtype)


def to_device(tree, device=None, dtype=None):
    """Move (and optionally cast) every tensor of a tree of dicts, lists
    and tuples (named tuples included); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, dtype) for v in tree]
    if isinstance(tree, tuple):
        items = [to_device(v, device, dtype) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree.to(device=device, dtype=dtype)

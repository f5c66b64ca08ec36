"""Read and write the safetensors container with the standard library,
numpy and torch only.

Layout: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus an
optional ``__metadata__`` of strings; offsets count from the end of the
header), then the raw little-endian, row-major tensor bytes.

Tensors are read one at a time: ``iter_file`` seeks to each tensor's
bytes, wraps them as a torch tensor and moves it to the target device and
dtype before the next is read, so a full-width checkpoint never needs a
whole-model host copy.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024


def read_header(path: str) -> Tuple[Dict, int]:
    """(header dict, byte offset where the tensor data starts)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is not credible")
        header = json.loads(f.read(n).decode("utf-8"))
    return header, 8 + n


def iter_file(path: str, *, device=None,
              dtype: Optional[torch.dtype] = None
              ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) in file order. `dtype` casts floating-point
    tensors (integer and bool tensors keep theirs); `device` moves each
    tensor as it is read."""
    header, base = read_header(path)
    entries = [(k, v) for k, v in header.items() if k != "__metadata__"]
    entries.sort(key=lambda kv: kv[1]["data_offsets"][0])
    with open(path, "rb") as f:
        for name, ent in entries:
            if ent["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype "
                                 f"{ent['dtype']}")
            tdt = _DTYPES[ent["dtype"]]
            begin, end = ent["data_offsets"]
            shape = tuple(ent["shape"])
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if end - begin != count * tdt.itemsize:
                raise ValueError(f"{path}: {name} spans {end - begin} bytes,"
                                 f" its shape and dtype need "
                                 f"{count * tdt.itemsize}")
            if count == 0:
                t = torch.empty(shape, dtype=tdt)
            else:
                f.seek(base + begin)
                buf = bytearray(end - begin)
                if f.readinto(buf) != end - begin:
                    raise ValueError(f"{path}: {name} is truncated")
                t = torch.frombuffer(buf, dtype=tdt).reshape(shape)
            if dtype is not None and t.is_floating_point():
                t = t.to(device=device, dtype=dtype)
            elif device is not None:
                t = t.to(device)
            yield name, t


def load_file(path: str, *, device=None,
              dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    return dict(iter_file(path, device=device, dtype=dtype))


def load_numpy(path: str) -> Dict[str, np.ndarray]:
    """Every tensor as numpy; bfloat16 (which numpy lacks) as float32."""
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for k, t in iter_file(path)}


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def save_file(tensors: Dict, path: str,
              metadata: Optional[Dict[str, str]] = None) -> str:
    """Write a dict of numpy arrays or torch tensors. Tensors are ordered
    by name and written one at a time."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        tdt = t.dtype if isinstance(t, torch.Tensor) else \
            torch.from_numpy(np.empty(0, np.asarray(t).dtype)).dtype
        if tdt not in _NAMES:
            raise TypeError(f"{name}: dtype {tdt} cannot be stored")
        shape = tuple(t.shape)
        nbytes = (int(np.prod(shape, dtype=np.int64)) if shape else 1) \
            * tdt.itemsize
        header[name] = {"dtype": _NAMES[tdt], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)   # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = _as_tensor(tensors[name])
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return path

"""Seeded weights on the device, in a few large calls.

The reference's parameter functions are walked once with a recording
initialiser, which hands back ``meta`` tensors and notes each leaf's
shape, dtype and draw. Then each (dtype, draw) group is one flat buffer
filled by one ``uniform_`` or ``normal_`` call from a CUDA generator (the
CPU one in the tests), every leaf a view into it scaled by its bound.
Each leaf starts on a 256-byte boundary, as a separate allocation would.
The tree the reference functions built is then rebuilt with the views in
place of the ``meta`` tensors.
"""
from __future__ import annotations

import torch

_ALIGN_BYTES = 256


class Recorder:
    """The initialiser interface of ``reference/params.py``."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.leaves = []            # (meta tensor, draw, argument)

    def _leaf(self, shape, draw, arg, dtype=None):
        t = torch.empty(tuple(shape), device="meta",
                        dtype=dtype or self.dtype)
        self.leaves.append((t, draw, arg))
        return t

    def uniform(self, shape, bound):
        return self._leaf(shape, "uniform", bound)

    def around_one(self, shape, spread):
        return self._leaf(shape, "around_one", spread)

    def normal(self, shape, std, dtype=None):
        return self._leaf(shape, "normal", std, dtype)

    def ones(self, n):
        return self._leaf((n,), "const", 1.0)

    def zeros(self, n):
        return self._leaf((n,), "const", 0.0)


def _replace(tree, table):
    if isinstance(tree, dict):
        return {k: _replace(v, table) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replace(v, table) for v in tree]
    if isinstance(tree, torch.Tensor) and id(tree) in table:
        return table[id(tree)]
    return tree


def materialize(trees, recorder: Recorder, generator: torch.Generator,
                device):
    """Real tensors for every leaf the recorder noted, drawn from
    `generator` on `device`; returns `trees` (any nesting of dicts and
    lists) with them in place."""
    groups = {}
    for t, draw, arg in recorder.leaves:
        kind = "uniform" if draw in ("uniform", "around_one") else draw
        groups.setdefault((t.dtype, kind), []).append((t, draw, arg))
    table = {}
    for (dtype, kind), leaves in groups.items():
        if kind == "const":
            for t, _, val in leaves:
                table[id(t)] = torch.full(t.shape, val, dtype=dtype,
                                          device=device)
            continue
        align = _ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        offsets, total = [], 0
        for t, _, _ in leaves:
            offsets.append(total)
            total += -(-t.numel() // align) * align
        buf = torch.empty(total, dtype=dtype, device=device)
        if kind == "uniform":
            buf.uniform_(-1.0, 1.0, generator=generator)
        else:
            buf.normal_(0.0, 1.0, generator=generator)
        for (t, draw, arg), off in zip(leaves, offsets):
            view = buf[off:off + t.numel()].view(t.shape)
            view.mul_(arg)
            if draw == "around_one":
                view.add_(1.0)
            table[id(t)] = view
    return _replace(trees, table)

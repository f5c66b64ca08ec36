"""The (data, frame, model) grid of ranks and the global-batch helpers.

The JAX package's ``create_mesh`` builds a ('data', 'frame'[, 'model'])
device mesh and GSPMD places the collectives; here the same grid is a
layout of processes, row-major with 'model' fastest: rank = (data_index
* frame + frame_index) * model + model_index. Batch rows (clips, images)
split over 'data'; the frames of a clip split over 'frame',
contiguously, each rank holding both CFG rows of its frames when
serving; the ranks of a model group hold slices of the spatial
transformers' weights (parallel/tensor.py) and run the same rows.
Parameters are otherwise replicated.

Rows are global: every rank builds the whole host batch from the step
seed (clips, noise, timesteps, CFG dropout, latent draws) and keeps its
own rows (``Grid.take`` for a tree of draws, ``Grid.positions`` for the
flat frame positions an encoder keeps): the JAX package's ``make_global_array`` / ``shard_batch_tree`` contract, so
an N-rank run computes what one process computes.

What needs no counterpart: ``rowsharded_kernel``, ``context_constraint``,
``manual_region`` and ``context_mesh`` exist because GSPMD cannot split a
Pallas call and must be told where a layout changes; here each rank
already holds only its rows and calls its kernels on them, and the one
layout change (the motion modules' frame <-> pixel exchange) is written
out in ``models/motion.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch.distributed as dist

from video_style_transfer_tpu_torch.parallel import distributed


def split_counts(n: int, parts: int) -> Tuple[int, ...]:
    """Rows of each of `parts` contiguous shards of `n` rows: the first
    n % parts shards hold one row more."""
    if parts > n:
        raise ValueError(f"{n} rows cannot give each of {parts} ranks one")
    return tuple(n // parts + (i < n % parts) for i in range(parts))


def shard_rows(n: int, parts: int, index: int) -> slice:
    """The rows of shard `index` of `n` rows split `parts` ways."""
    counts = split_counts(n, parts)
    start = sum(counts[:index])
    return slice(start, start + counts[index])


@dataclass(frozen=True)
class FrameShard:
    """A clip's frames split over a frame group: this rank holds
    frames[start:start + counts[index]] of `frames`. `group` is the
    process group of the ranks that share the clip (None: the world)."""
    group: Optional[object]
    counts: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.counts)

    @property
    def frames(self) -> int:
        return sum(self.counts)

    @property
    def start(self) -> int:
        return sum(self.counts[:self.index])

    @property
    def local(self) -> int:
        return self.counts[self.index]

    @property
    def even(self) -> bool:
        return len(set(self.counts)) == 1

    def slice(self) -> slice:
        return slice(self.start, self.start + self.local)


@dataclass(frozen=True)
class Grid:
    """This rank's place in a (data, frame, model) grid of `data * frame
    * model` ranks. Each group holds the ranks that differ from this one
    only in that axis: frame_group (None when frame == 1), data_group
    (None when data == 1), model_group (None when model == 1)."""
    data: int
    frame: int
    rank: int
    frame_group: Optional[object] = None
    data_group: Optional[object] = None
    model: int = 1
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.frame * self.model

    @property
    def data_index(self) -> int:
        return self.rank // (self.frame * self.model)

    @property
    def frame_index(self) -> int:
        return self.rank // self.model % self.frame

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def frame_shard(self, frames: int) -> Optional[FrameShard]:
        """How `frames` frames split over this rank's frame group (None
        without frame parallelism)."""
        if self.frame == 1:
            return None
        return FrameShard(self.frame_group, split_counts(frames, self.frame),
                          self.frame_index)

    def data_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n` rows."""
        return shard_rows(n, self.data, self.data_index)

    def positions(self, rows: int, frames: int = 1) -> Optional[List[int]]:
        """This rank's flat positions r * frames + j in a global batch of
        `rows` rows of `frames` frames each: its rows, and its frames of
        each (None on a grid of one: every position)."""
        if self.size == 1:
            return None
        shard = self.frame_shard(frames)
        mine = range(frames) if shard is None else range(frames)[
            shard.slice()]
        return [r * frames + j for r in range(rows)[self.data_rows(rows)]
                for j in mine]

    def take(self, tree, frames: bool = False):
        """This rank's part of a nested dict of global-batch tensors: its
        rows of dim 0 of each and, with `frames`, its frames of dim 1 of
        each that has one (a (B, F, ...) draw)."""
        if isinstance(tree, dict):
            return {k: self.take(v, frames) for k, v in tree.items()}
        rows = self.data_rows(tree.shape[0])
        if frames and self.frame > 1 and tree.dim() > 1:
            return tree[rows, self.frame_shard(tree.shape[1]).slice()]
        return tree[rows]


def create_mesh(*, data: Optional[int] = None,
                frame: Optional[int] = None, model: int = 1) -> Grid:
    """The (data, frame, model) grid over every rank of the world. With
    one of data / frame given the other takes the ranks `model` leaves;
    with neither, they all go on 'frame' (the video-serving layout).
    Every rank must call it, in the same order as its other group
    creations: it makes the groups of every axis."""
    n = distributed.world_size()
    rest = max(n // model, 1)
    if data is None and frame is None:
        data, frame = 1, rest
    elif data is None:
        data = max(rest // frame, 1)
    elif frame is None:
        frame = max(rest // data, 1)
    if data * frame * model != n:
        raise ValueError(f"a {data} x {frame} x {model} grid needs "
                         f"{data * frame * model} processes; the world has "
                         f"{n}")
    r = distributed.rank()
    sizes = (data, frame, model)

    def coords(rank):
        g = Grid(data, frame, rank, model=model)
        return g.data_index, g.frame_index, g.model_index

    groups = [None, None, None]
    if n > 1:
        # new_group is collective: every rank makes every group, in one
        # order (axis by axis, each group's lowest rank ascending)
        for axis in range(3):
            if sizes[axis] == 1:
                continue
            lines = {}
            for q in range(n):
                c = coords(q)
                lines.setdefault(c[:axis] + c[axis + 1:], []).append(q)
            mine = coords(r)
            for key, ranks in lines.items():
                g = (dist.group.WORLD if len(ranks) == n
                     else dist.new_group(ranks))
                if key == mine[:axis] + mine[axis + 1:]:
                    groups[axis] = g
    return Grid(data, frame, r, frame_group=groups[1],
                data_group=groups[0], model=model, model_group=groups[2])


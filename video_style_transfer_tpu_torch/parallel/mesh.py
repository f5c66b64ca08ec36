"""The (data, frame) grid of ranks and the global-batch helpers.

The JAX package's ``create_mesh`` builds a ('data', 'frame') device mesh
and GSPMD places the collectives; here the same grid is a layout of
processes, row-major: rank = data_index * frame + frame_index. Batch
rows (clips, images) split over 'data'; the frames of a clip split
over 'frame', contiguously, each rank holding both CFG rows of its
frames when serving. Parameters are replicated.

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
    """This rank's place in a (data, frame) grid of `data * frame`
    ranks. frame_group: the ranks of this rank's data row (None when
    frame == 1); data_group: the ranks of its frame column (None when
    data == 1)."""
    data: int
    frame: int
    rank: int
    frame_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.frame

    @property
    def data_index(self) -> int:
        return self.rank // self.frame

    @property
    def frame_index(self) -> int:
        return self.rank % self.frame

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
                frame: Optional[int] = None) -> Grid:
    """The (data, frame) grid over every rank of the world. With one of
    data / frame given the other takes the remaining ranks; with neither,
    every rank is on 'frame' (the video-serving layout). Every rank must
    call it, in the same order as its other group creations: it makes
    the groups of every row and column."""
    n = distributed.world_size()
    if data is None and frame is None:
        data, frame = 1, n
    elif data is None:
        data = max(n // frame, 1)
    elif frame is None:
        frame = max(n // data, 1)
    if data * frame != n:
        raise ValueError(f"a {data} x {frame} grid needs {data * frame} "
                         f"processes; the world has {n}")
    r = distributed.rank()
    frame_group = data_group = None
    if n > 1:
        # new_group is collective: every rank makes every group
        for d in range(data):
            ranks = list(range(d * frame, (d + 1) * frame))
            g = (dist.new_group(ranks) if frame < n
                 else dist.group.WORLD) if frame > 1 else None
            if d == r // frame:
                frame_group = g
        for f in range(frame):
            ranks = list(range(f, n, frame))
            g = (dist.new_group(ranks) if data < n
                 else dist.group.WORLD) if data > 1 else None
            if f == r % frame:
                data_group = g
    return Grid(data, frame, r, frame_group, data_group)


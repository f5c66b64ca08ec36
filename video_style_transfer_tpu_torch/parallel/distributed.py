"""Processes and collectives: one process per rank, torch.distributed.

The JAX package runs one SPMD program over a mesh of devices and starts
its processes with ``jax.distributed.initialize``. The port follows
PyTorch's idiom instead: one process per GPU, a process group, and
explicit collectives where the math crosses ranks.

- ``init_distributed`` joins the process group that the coordinator
  flags (``--coordinator_address host:port``, ``--num_processes``,
  ``--process_id``) or torchrun's environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) describe. A
  world of one is a no-op, and so is a group that already exists, so a
  caller (a test, a harness) may set up its own group first.
- ``is_main_process`` gates every filesystem write, ``barrier(name)`` is
  the rendezvous after one (the reference's
  ``accelerator.wait_for_everyone``).
- ``all_reduce_sum`` and ``all_to_all`` are the two collectives the
  models run under autograd: their backwards are the same collective
  (a sum's gradient is summed; an all-to-all's is the inverse
  all-to-all, which for equal splits is the same call).
  ``torch.distributed.nn.functional`` has both, but warns that it is
  deprecated; these are the few lines the port needs.
  ``EXCHANGED_BYTES`` counts the bytes this process's all-to-alls sent
  to other ranks (forward and backward), ``MODEL_REDUCED_BYTES`` the
  payload of its tensor-parallel reductions.
- ``gather_rows`` collects row shards of unequal counts without
  autograd (decoded frames, served images); ``all_reduce_tensors`` sums
  a trainer's gradients in place, bucketed by dtype, and
  ``global_metrics`` a step's metrics.

Multi-host runs restore checkpoints and read class images from the
output directory process 0 wrote, so that directory must be shared by
every host.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: Optional[torch.device] = None) -> bool:
    """Join the process group the arguments (or, where one is None,
    torchrun's environment variables) describe; returns True if this
    call created it. A world of one and an existing group are no-ops
    (False).

    coordinator_address: ``host:port`` (TCP rendezvous), or a
    ``tcp://`` or ``file://`` URL as torch.distributed takes it.
    backend: None picks ``nccl`` for a CUDA `device` and ``gloo``
    otherwise. Raises ValueError for a topology it cannot start."""
    if dist.is_available() and dist.is_initialized():
        return False
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None and num_processes in (None, 1):
        if process_id not in (None, 0):
            raise ValueError(f"process id {process_id} in a world of one "
                             f"process")
        return False
    if num_processes is None:
        raise ValueError("a coordinator address needs --num_processes (or "
                         "WORLD_SIZE)")
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need "
                         f"--coordinator_address host:port (or MASTER_ADDR "
                         f"and MASTER_PORT)")
    if process_id is None:
        raise ValueError("a multi-process run needs --process_id (or RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of "
                         f"{num_processes}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend is None:
        backend = ("nccl" if device is not None
                   and torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def world_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK (torchrun), else the
    rank modulo the host's card count (one process a card)."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank() % n if n else 0


def is_main_process() -> bool:
    """True on the one process that writes files (checkpoints, metrics,
    artifacts, videos, images)."""
    return rank() == 0


def barrier(name: str) -> None:
    """Every process waits here until all arrive (no-op in a world of
    one). `name` says which meeting this is in a hang's traceback."""
    del name
    if world_size() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


# bytes sent to other ranks by all_to_all in this process (the chunk a
# rank keeps for itself is not counted)
EXCHANGED_BYTES = 0
# the payload (numel x element size) of this process's model-axis
# reductions: the partial products of the row-parallel projections
# (parallel/tensor.py reduce_partial)
MODEL_REDUCED_BYTES = 0


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        global EXCHANGED_BYTES
        ctx.group = group
        x = x.contiguous()
        n = dist.get_world_size(group)
        EXCHANGED_BYTES += x.numel() * x.element_size() * (n - 1) // n
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Split dim 0 of `x` into one equal chunk per rank of `group`, send
    chunk j to rank j, and stack what arrives in rank order;
    differentiable (its backward is the same exchange)."""
    return _AllToAll.apply(x, group)


def gather_rows(x: torch.Tensor, counts: Sequence[int],
                group=None) -> torch.Tensor:
    """Concatenate every rank's rows: rank r holds counts[r] rows (x is
    its own). Rows are zero-padded to the largest count for the
    exchange and the padding dropped. Not differentiable."""
    m = max(counts)
    if x.shape[0] < m:
        x = torch.cat([x, x.new_zeros((m - x.shape[0],) + x.shape[1:])])
    parts = [torch.empty_like(x) for _ in counts]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


# the most bytes all_reduce_tensors packs into one collective
BUCKET_BYTES = 256 << 20


def all_reduce_tensors(tensors: List[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks of `group`, in place: tensors of
    one dtype and device are packed into flat buckets of at most
    BUCKET_BYTES for the exchange (a trainer's thousands of LoRA
    gradients take a few collectives, not thousands). Half-precision
    buckets are summed in float32 and rounded once, which is closer to
    one process's gradient (chip_smoke.py's probe also reads gloo's own
    bf16 sum of CUDA tensors)."""
    if world_size() <= 1 or not tensors:
        return
    buckets, sizes = {}, {}
    for t in tensors:
        key = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if key not in buckets or sizes[key] + nbytes > BUCKET_BYTES:
            buckets.setdefault(key, []).append([])
            sizes[key] = 0
        buckets[key][-1].append(t)
        sizes[key] += nbytes
    for groups in buckets.values():
        for ts in groups:
            flat = torch.cat([t.reshape(-1).float() for t in ts])
            dist.all_reduce(flat, group=group)
            off = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n


def global_metrics(metrics):
    """A dict of scalar tensors that are each rank's share, summed over
    the world (one collective); unchanged in a world of one."""
    if world_size() <= 1:
        return metrics
    keys = list(metrics)
    total = torch.stack([metrics[k].float() for k in keys])
    all_reduce_tensors([total])
    return {k: total[i] for i, k in enumerate(keys)}

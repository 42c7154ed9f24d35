"""Data parallelism over torch.distributed (counterpart of
diagan_tpu/parallel/mesh.py).

The JAX package shards one program over a 1-D mesh of every visible device
(shard_map, `pmean` of the gradients, the device index folded into each
key, `psum` / `all_gather` for the logit sweep). Here each card runs its own
process, and the same semantics come from four collectives:

  - rank 0's parameters and buffers are broadcast at the start, so every
    replica starts equal (`broadcast_module`; the mesh's `replicate`);
  - every gradient is averaged across ranks before the optimizer step, one
    flat buffer per net and update (`all_reduce_mean_`; the steps' `pmean`);
  - mutable state that integrates rank-local batches (BatchNorm running
    statistics) is averaged before each read of it (`sync_buffers`; the
    chunk-end `pmean` of the state: the statistics are linear EMAs, so
    averaging before a read gives the per-chunk `pmean`'s values);
  - rows and (value, index) pairs are summed or gathered across ranks
    (`shard_logit_gather`, and the sharded logit sweep of
    train/logit_recorder.py).

`init_data_parallel` joins the group that torchrun's environment describes
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT), or a group the caller has
already initialised; with neither, it forms a world of one in process, the
JAX flag's "all visible devices" on a one-card host. With more than one card
visible and no such environment it raises and names the torchrun command.
The backend is NCCL for CUDA and gloo for the CPU; `backend=` overrides it
(gloo also takes CUDA tensors, e.g. two ranks sharing one card). A failed
init raises: nothing carries on in a single process.

Only all_reduce, broadcast, all_gather (list form) and barrier are used.
Control-plane traffic (the stop flag, barriers before and after rank 0
writes a file) goes over a gloo group on CPU tensors, so it never waits on
the card's stream.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass
class DataParallel:
    """A rank's view of its group: `rank` of `world`, its `device`, the
    group its data collectives use (`group`, on `backend`) and a gloo group
    for control flags and barriers (`cpu_group`). `bytes_all_reduced` counts
    the bytes `all_reduce_mean_` has reduced."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: object = field(repr=False)
    cpu_group: object = field(repr=False)
    bytes_all_reduced: int = 0

    @property
    def is_main(self):
        return self.rank == 0

    def barrier(self):
        dist.barrier(group=self.cpu_group)

    def any(self, flag):
        """True on every rank if `flag` is true on any rank."""
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, group=self.cpu_group)
        return bool(t.item())


def _group_for(backend):
    """The default group if it runs `backend`, else a new group over every
    rank on `backend` (every rank calls this in the same order)."""
    if dist.get_backend() == backend:
        return dist.group.WORLD
    return dist.new_group(backend=backend)


def init_data_parallel(device, backend=None) -> DataParallel:
    """Join (or form) the process group and return this rank's DataParallel.
    device: "cuda" or "cpu" (torchrun's LOCAL_RANK picks the card)."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda" and device.index is None:
        if launched:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        elif dist.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        elif torch.cuda.device_count() > 1:
            n = torch.cuda.device_count()
            raise RuntimeError(
                f"--data_parallel sees {n} cards but no torchrun environment (RANK, "
                f"WORLD_SIZE): launch one process per card with\n  torchrun --standalone "
                f"--nproc_per_node={n} -m diagan_tpu_torch.cli.<script> --data_parallel ...")
        else:
            device = torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if launched:
            dist.init_process_group(backend, init_method="env://")
        else:  # a world of one, in process
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    group = _group_for(backend)
    cpu_group = group if backend == "gloo" else _group_for("gloo")
    return DataParallel(dist.get_rank(), dist.get_world_size(), device, backend, group,
                        cpu_group)


def broadcast_module(module, dp: DataParallel, src=0):
    """Rank `src`'s parameters and buffers to every rank, in place."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src, group=dp.group)


def all_reduce_mean_(tensors, dp: DataParallel):
    """Average `tensors` across ranks in place: one flat buffer per dtype,
    summed with all_reduce and divided by the world size (the JAX `pmean`).
    It runs the collective at world 1 too."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=dp.group)
        flat.div_(dp.world)
        dp.bytes_all_reduced += flat.numel() * flat.element_size()
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in zip(flat.split([t.numel() for t in ts]),
                                                                ts)])


def all_reduce_grads_(module, dp: DataParallel):
    """Average the .grad of `module`'s parameters across ranks (those that
    have one: every rank runs the same graph, so the same ones)."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if grads:
        all_reduce_mean_(grads, dp)


def sync_buffers(module, dp: DataParallel):
    """Average `module`'s floating-point buffers across ranks: BatchNorm's
    running statistics, which integrate rank-local batches (spectral norm's
    u is a function of the replicated weights, so the same on every rank)."""
    bufs = [b for b in module.buffers() if b.is_floating_point()]
    if bufs:
        all_reduce_mean_(bufs, dp)


def shard_logit_gather(values, indices, dp: DataParallel):
    """Every rank's (values, indices), concatenated in rank order on every
    rank (the JAX tiled all_gather)."""
    out = []
    for t in (values, indices):
        parts = [torch.empty_like(t) for _ in range(dp.world)]
        dist.all_gather(parts, t.contiguous(), group=dp.group)
        out.append(torch.cat(parts))
    return tuple(out)


def per_rank_shard(array, rank, world):
    """The contiguous slice [rank * n // world, (rank + 1) * n // world) of
    `array` (the JAX per_host_shard's bounds)."""
    n = len(array)
    return array[rank * n // world:(rank + 1) * n // world]


def rank_block(n, rank, world):
    """Rank `rank`'s contiguous block [lo, hi) of n items split over `world`
    ranks after padding n to a multiple of world (the sharded logit sweep's
    batch split; the padding items, ids >= n, are dropped)."""
    per = -(-n // world)
    return min(n, rank * per), min(n, (rank + 1) * per)

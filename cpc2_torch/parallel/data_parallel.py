"""One rank of a data-parallel run (counterpart of the data side of
`cpc2_tpu/parallel/mesh.py` and of the collectives of
`cpc2_tpu/training.py:build_steps`).

The JAX package runs one `shard_map` program over a data mesh: per-device
batches, replicated parameters, gradients, losses, accuracies and
BatchNorm statistics `pmean`ed over the data axis. Here each rank is a
process with its own device, and `DataParallel` does those reductions
with `torch.distributed`: the gradients in one persistent flat buffer
(by dtype) that the parameters' `.grad`s are views of, and one
`all_reduce` on it; the metrics and the statistics each in one more.
Every collective is an `all_reduce` or a `broadcast`, so NCCL and `gloo`
(CPU tensors, or CUDA tensors on one card) both run it, and NCCL's can be
captured in a CUDA graph (`training.MultiStep`).

`--dcn_axis_size S` lays the ranks out node-major as S nodes of world / S
ranks (`rank_layout`, the JAX package's ('dcn_data', 'ici_data') mesh);
the all-reduce stays flat, since NCCL already keeps the hops inside a
node on NVLink, so the trajectory is the flat one's.

`gather_pool` is the all-gather of `--global_negatives` with a gradient:
each rank writes its rows into a zero-filled pool that is summed over the
ranks, and the backward sums the pool's gradient over the ranks and keeps
the rank's own slice (`psum_scatter`, the transpose of JAX's
`all_gather`).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

Tensor = torch.Tensor

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def rank_layout(world: int, dcn_axis_size: int = 0) -> np.ndarray:
    """The ranks as a (nodes, ranks a node) grid, node-major: rank r is on
    node r // (world / S). `dcn_axis_size` S <= 1 is one node of all the
    ranks; S must divide the world (`cpc2_tpu/parallel/mesh.py:56-66`)."""
    if dcn_axis_size and dcn_axis_size > 1:
        if world % dcn_axis_size:
            raise ValueError(f"dcn_axis_size={dcn_axis_size} does not "
                             f"divide the {world}-rank data mesh")
        return np.arange(world).reshape(dcn_axis_size, -1)
    return np.arange(world)[None, :]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s negatives and dropout generator: `seed`
    itself on rank 0 (a one-rank run draws what a run without ranks
    draws), a stream of its own on every other (the counterpart of
    `fold_in(rng, axis_index)`)."""
    return (seed + rank * 0x9E3779B97F4A7C15) % (2 ** 63)


def rank_rows(x, rank: int, world: int):
    """Rank `rank`'s contiguous share of axis 0 of `x` (a numpy array or a
    tensor), as `cpc2_tpu/parallel/mesh.py:shard_batch` shards a batch;
    the axis must divide by `world`."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    k = n // world
    return x[rank * k:(rank + 1) * k]


def _batch_norms(modules: Iterable[nn.Module]) -> List[Tensor]:
    return [t for module in modules for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for t in (m.running_mean, m.running_var) if t is not None]


def _copy_back(tensors: List[Tensor], flat: Tensor) -> None:
    """`flat`'s consecutive pieces into `tensors`, in one multi-tensor
    copy (a step's 200-odd gradients would otherwise take a launch
    each)."""
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t)
                                   for p, t in zip(pieces, tensors)])


class DataParallel:
    """Rank `rank` of `world` on `device`, in the default process group.
    `pod`: the ranks load their own files (`--distributed` over more than
    one rank), so a short batch is padded and weighted
    (`train_tails.PodTailRunner`); else every rank sees the one loader's
    global batch and takes its rows (`rows`)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 dcn_axis_size: int = 0, pod: bool = False):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.layout = rank_layout(world, dcn_axis_size)
        self.pod = pod
        self.backend = dist.get_backend()

    def rows(self, x):
        return rank_rows(x, self.rank, self.world)

    def all_reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        """`t` reduced in place over the ranks; a failure raises."""
        dist.all_reduce(t, op=_OPS[op])
        return t

    def host_values(self, values: Sequence[int], op: str = "sum"
                    ) -> List[int]:
        """Integers reduced over the ranks, back on the host."""
        t = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        return self.all_reduce(t, op).tolist()

    def check_lengths(self, lengths: Sequence[int], what: str) -> None:
        """Raise unless every rank has the same `lengths` (the lock-step
        guard of `cpc2_tpu/train.py:211-230`): a rank with more batches
        would wait in a collective no other rank joins."""
        lengths = [int(v) for v in lengths]
        top = self.host_values(lengths + [-v for v in lengths], "max")
        n = len(lengths)
        if top[:n] != [-v for v in top[n:]]:
            raise RuntimeError(
                f"per-rank {what} diverge across ranks (largest {top[:n]}, "
                f"smallest {[-v for v in top[n:]]}, this rank {lengths}): "
                f"the lock-step epoch loop needs every rank to yield the "
                f"same batch count. Shard --pathTrain/--pathVal so that the "
                f"ranks carry equal window counts.")

    def replicate(self, *modules: nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank (`replicate`)."""
        for module in modules:
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)

    @staticmethod
    def bind_gradients(params: Iterable[Tensor]) -> List[Tensor]:
        """One flat zeroed buffer a dtype for the gradients of `params`,
        each parameter's `.grad` a view of it, as DDP's
        `gradient_as_bucket_view`: backward accumulates into the views
        (the trainer zeroes them in place, never to None), and
        `reduce_gradients` reduces the buffers as they stand."""
        by_dtype = {}
        for p in params:
            if p.requires_grad:
                by_dtype.setdefault(p.dtype, []).append(p)
        flats = []
        for group in by_dtype.values():
            flat = torch.zeros(sum(p.numel() for p in group),
                               dtype=group[0].dtype, device=group[0].device)
            for p, piece in zip(group, flat.split([p.numel()
                                                   for p in group])):
                p.grad = piece.view_as(p)
            flats.append(flat)
        return flats

    def reduce_gradients(self, flats: Sequence[Tensor],
                         mean: bool = True) -> None:
        """The gradient buffers of `bind_gradients` summed over the ranks,
        then divided by the world with `mean` (`pmean(grads)`) or kept as
        the sum (the weighted step's `psum`): one `all_reduce` a
        buffer."""
        for flat in flats:
            self.all_reduce(flat)
            if mean:
                flat.div_(self.world)

    def reduce_batch_stats(self, modules: Iterable[nn.Module],
                           present: Optional[Tensor] = None) -> None:
        """The BatchNorm running statistics averaged over the ranks
        (`pmean(new_bs)`); with `present` (a 0-d tensor, 1 where this
        rank's batch holds a real row, else 0) over those ranks only
        (`cpc2_tpu/training.py:300-314`)."""
        stats = _batch_norms(modules)
        if not stats:
            return
        flat = torch.cat([t.reshape(-1) for t in stats])
        if present is None:
            self.all_reduce(flat).div_(self.world)
        else:
            m = present.to(flat.dtype).reshape(1)
            flat = self.all_reduce(torch.cat([flat * m, m]))
            flat = flat[:-1] / flat[-1].clamp_min(1.0)
        _copy_back(stats, flat)

    def gather_states(self, state: Tensor) -> List[Tensor]:
        """Every rank's byte tensor `state` (a generator's state), in rank
        order: each rank writes its row of a zero-filled table that is
        summed over the ranks."""
        table = torch.zeros((self.world, state.numel()), dtype=torch.int64,
                            device=self.device)
        table[self.rank] = state.to(self.device, torch.int64).reshape(-1)
        table = self.all_reduce(table).cpu().to(torch.uint8)
        return [row.clone() for row in table]

    def check_replicas(self, *modules: nn.Module) -> None:
        """Raise unless every rank holds the same parameters and buffers:
        the bits of each tensor's float64 sum compared over the ranks (a
        replica that drifted would go on training apart, and only rank
        0's is saved)."""
        bits = torch.stack([t.detach().double().sum() for module in modules
                            for t in module.state_dict().values()]
                           ).view(torch.int64)
        top = self.all_reduce(torch.cat([bits, ~bits]), "max")
        n = bits.numel()
        differ = int((top[:n] != ~top[n:]).sum())
        if differ:
            raise RuntimeError(f"the ranks' replicas differ in {differ} of "
                               f"{n} tensors")


class _GatherPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z: Tensor, dp: DataParallel) -> Tensor:
        rows = z.shape[0]
        pool = z.new_zeros((dp.world * rows,) + tuple(z.shape[1:]))
        pool[dp.rank * rows:(dp.rank + 1) * rows] = z
        dp.all_reduce(pool)
        ctx.dp, ctx.rows = dp, rows
        return pool

    @staticmethod
    def backward(ctx, g: Tensor):
        g = ctx.dp.all_reduce(g.contiguous().clone())
        start = ctx.dp.rank * ctx.rows
        return g[start:start + ctx.rows], None


def gather_pool(z: Tensor, dp: DataParallel) -> Tensor:
    """Every rank's `z` (rows, ...) stacked in rank order, (world * rows,
    ...), with a gradient: the pool's gradient summed over the ranks, this
    rank's slice. Every rank must call it with the same shape."""
    return _GatherPool.apply(z, dp)

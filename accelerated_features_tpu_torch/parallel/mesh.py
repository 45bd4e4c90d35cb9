"""The (data, model) mesh of the port, on `torch.distributed` process
groups: the counterpart of the JAX package's `parallel/mesh.py`.

* 'data': batch and image-pair parallelism; gradients and BatchNorm
  statistics are summed over it.
* 'model': tensor parallelism of the fine-matcher MLP and keypoint-set
  (sequence) sharding of the matchers.

Rank r of the default group sits at (r // model, r % model): 'model' is
the innermost axis, as in the JAX mesh, so on a multi-host job its ranks
are neighbours. Every rank builds every axis group in the same order
(`torch.distributed.new_group` is collective), an axis of one rank too,
so that a job of one rank still runs its collectives through NCCL or
gloo. Without a process group the collectives are identities.

The collectives used are `all_reduce`, `all_gather` and `broadcast` only,
which NCCL runs on CUDA tensors and gloo on CPU tensors and, staged
through the host, on CUDA tensors. `AxisSum` is an all-reduce with a
gradient (the backward all-reduces too); `copy_to` and `reduce_from` are
Megatron's two tensor-parallel operators.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A (data, model) grid of the first data x model ranks of the default
    group: `shape` (dict), this rank's `coords` (dict) and, per axis, the
    group of the ranks that share this rank's other coordinate (None
    without a process group, and on a `local` mesh). Ranks past the grid
    are not `active`: they hold no coordinates and take part in no
    collective of the mesh."""

    def __init__(self, shape: Tuple[int, int],
                 axis_names: Tuple[str, str] = AXES, local: bool = False):
        rank, size = (0, 1) if local else world()
        d, m = (int(x) for x in shape)
        if d * m > size or d < 1 or m < 1:
            raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, the "
                             f"process group has {size}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (d, m)))
        self.rank = rank
        self.active = rank < d * m
        self.coords = dict(zip(self.axis_names, (rank // m, rank % m))) \
            if self.active else {}
        self.groups: Dict[str, Any] = {}
        rows = [[i * m + j for i in range(d)] for j in range(m)]  # data
        cols = [[i * m + j for j in range(m)] for i in range(d)]  # model
        grouped = not local and dist.is_available() and dist.is_initialized()
        for name, lists in ((self.axis_names[0], rows),
                            (self.axis_names[1], cols)):
            self.groups[name] = None
            if not grouped:
                continue
            for ranks in lists:   # collective: every rank makes every group
                g = dist.new_group(ranks)
                if rank in ranks:
                    self.groups[name] = g

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    # ---- collectives (no gradient) ----------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """A new tensor: t summed (or maxed, `op="max"`) over `axis`."""
        if self.groups[axis] is None:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.groups[axis])
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """Every rank's t along `axis`, in axis order: concatenated along
        `dim` (`tiled`) or stacked in a new leading dimension."""
        if self.groups[axis] is None:
            return t if tiled else t[None]
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(self.shape[axis])]
        dist.all_gather(parts, wire.contiguous(), group=self.groups[axis])
        if t.dtype == torch.bool:
            parts = [p.bool() for p in parts]
        return torch.cat(parts, dim) if tiled else torch.stack(parts)

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The tensor of the rank at coordinate 0 of `axis`."""
        group = self.groups[axis]
        if group is None:
            return t
        out = t.detach().clone().contiguous()
        root = dist.get_global_rank(group, 0)
        dist.broadcast(out, root, group=group)
        return out

    def reducer(self, axis: str) -> "AxisSum":
        return AxisSum(self, axis)


class _AllReduce(torch.autograd.Function):
    """y = sum over the axis of x; dx = sum over the axis of dy, the
    adjoint when every rank's loss reads its own copy of y."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_reduce(dy.contiguous(), ctx.axis), None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-split
    layer, whose shards each see only their columns' share of dx."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_reduce(dy.contiguous(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial products of a
    row-split layer."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class AxisSum:
    """Callable all-reduce sum over one axis that carries the gradient;
    `size` is the axis length (BatchNorm's global count is the local count
    times it)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis, self.size = mesh, axis, mesh.size(axis)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.groups[self.axis] is None:
            return t
        return _AllReduce.apply(t, self.mesh, self.axis)


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.groups[axis] is None:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.groups[axis] is None:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = AXES) -> Mesh:
    """A (data, model) mesh over the default group; by default every rank
    on 'data'."""
    return Mesh(shape or (world()[1], 1), axis_names)


def local_mesh() -> Mesh:
    """A 1x1 mesh of no process group, whatever group exists: every
    collective of it is the identity. The single-device train step runs
    through it."""
    return Mesh((1, 1), local=True)


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def replicate(mesh: Mesh, tree: Any, axes: Tuple[str, ...] = AXES) -> Any:
    """Every tensor of `tree` as the rank at coordinate 0 of each axis in
    `axes` holds it (a broadcast from the axis root)."""
    def bcast(t):
        for axis in axes:
            t = mesh.broadcast(t, axis)
        return t
    return _tree_map(bcast, tree)


def shard_on(mesh: Mesh, tree: Any, axis: str = "data", dim: int = 0
             ) -> Any:
    """This rank's slice of every tensor of `tree` along `dim`, by its
    coordinate on `axis`; the dimension must divide evenly."""
    n, i = mesh.size(axis), mesh.index(axis)

    def cut(t):
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide over {n} ranks of '{axis}'")
        step = t.shape[dim] // n
        return t.narrow(dim, i * step, step)
    return _tree_map(cut, tree)


__all__ = ["Mesh", "AxisSum", "make_mesh", "local_mesh", "replicate",
           "shard_on",
           "copy_to", "reduce_from", "world"]

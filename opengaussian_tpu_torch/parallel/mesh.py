"""The device mesh: one rank per device over torch.distributed (port of
opengaussian_tpu/parallel/mesh.py).

The reference trains on one GPU; the JAX package adds a one-axis mesh whose
devices take two roles in a step: each holds a contiguous shard of the splat
table for projection, SH and the parameter update, and a band of image
tiles for the blend (parallel/render.py). Here a mesh is a process group of
torch.distributed, one process (rank) per device: NCCL between GPUs, gloo
between CPU processes. The caller starts the processes and initializes the
default group (`torch.distributed.init_process_group`, or
parallel/distributed.py:init_distributed); `make_mesh` takes its first
n ranks.

Ranks hold plain shards, so where the JAX trainer runs a global operation on
its sharded arrays (densification, the k-means, checkpoints), the port
gathers the whole table onto every rank (`gather_gaussians`), runs the
single-device code identically there and shards the result again.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


# the collective under its newer name, where this torch has it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: object  # the torch.distributed process group of the mesh's ranks
    rank: int  # this process's place in the mesh, 0..size-1
    size: int  # ranks in the mesh
    device: torch.device  # this rank's device


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """A mesh of the first n_devices ranks of the default process group (all
    by default). Every rank of the default group must call it, since it may
    create a subgroup; a rank outside the mesh gets None. device: this
    rank's device, by default cuda:<current device> under NCCL, else the
    CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(init_process_group or parallel.distributed.init_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(group=group, rank=rank, size=n, device=torch.device(device))


def _tree_map(fn, tree):
    """fn on every tensor of a tree of tuples, lists, dicts, NamedTuples and
    dataclasses; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_gaussians(mesh: Mesh, tree):
    """This rank's contiguous N / D rows of every tensor of `tree` with a
    leading axis, on the mesh's device (0-d tensors whole): the splat
    table's shard."""

    def shard(x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0:
            return x.to(mesh.device)
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
        rows = x.shape[0] // mesh.size
        return x[mesh.rank * rows:(mesh.rank + 1) * rows].to(mesh.device)

    return _tree_map(shard, tree)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[n, ...] rows of every rank -> [D n, ...], in rank order, on every
    rank (no autograd). Bool tensors travel as uint8."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), mesh).bool()
    out = x.new_empty((x.shape[0] * mesh.size, *x.shape[1:]))
    _ALL_GATHER(out, x.contiguous(), group=mesh.group)
    return out


def gather_gaussians(mesh: Mesh, tree):
    """The inverse of `shard_gaussians`: every tensor of `tree` with a
    leading axis all-gathered back to the whole table, the ranks' rows in
    rank order (0-d tensors whole), on every rank. Every rank must call it.

    The JAX package needs no such function: GSPMD runs its trainer's global
    operations on the sharded arrays themselves. A port whose ranks hold
    plain shards gathers the table for them instead."""
    return _tree_map(lambda x: x if x.dim() == 0 else all_gather(x, mesh), tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree`, whole, on this rank's device."""
    return _tree_map(lambda x: x.to(mesh.device), tree)

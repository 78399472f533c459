"""The two-level k-means over a device mesh (port of
opengaussian_tpu/parallel/kmeans.py; the single-device semantics are
ops/kmeans.py's).

  * the features [N, D] stay sharded: each rank takes the distances and the
    one-hot sums of its own rows;
  * a Lloyd iteration all-reduces the per-cluster sums and counts, so every
    rank holds the same centers;
  * the k-means++ seeds come from a pool: each rank draws a fixed number of
    its rows by weight, the pools are all-gathered (a few thousand rows),
    and the D^2 seeding runs on the pool on every rank alike. The draws come
    from a torch.Generator seeded alike on every rank, which therefore draws
    the same numbers on each (each rank samples its own rows with them);
  * a reassignment runs Lloyd from the cached centers and from a fresh
    k-means++ restart, and keeps whichever quantizes better (the error
    all-reduced over the mesh), the restart's labels greedily aligned to the
    cached centers.

The assignments come back sharded like the features; ops/kmeans.py:quantize
works on them unchanged. Tests hand both packages the same seeds
(`init_centers=`), as for the single-device k-means.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from opengaussian_tpu_torch.ops.kmeans import (
    KMeansState,
    _align_labels,
    _dist2,
    init_centers_from_points,
)
from opengaussian_tpu_torch.parallel.mesh import Mesh, all_gather


def _sum_over(mesh: Mesh, *xs: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor of xs summed over the mesh, in one all-reduce."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])
    dist.all_reduce(flat, group=mesh.group)
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].reshape(x.shape))
        i += x.numel()
    return out


def _lloyd_sharded(feat_l, w_l, centers, iters: int, mesh: Mesh, slot_ok=None):
    """This rank's rows feat_l [n, D] (weights w_l [n]) and the centers [k, D]
    of every rank -> (centers, this rank's ids int32). slot_ok [k]: the
    centers that take part (the others keep their value and take no row)."""
    k = centers.shape[0]
    ar = torch.arange(k, device=feat_l.device)

    def nearest(c):
        d = _dist2(feat_l, c)
        if slot_ok is not None:
            d = torch.where(slot_ok[None, :], d, torch.inf)
        return torch.argmin(d, dim=-1)

    for _ in range(iters):
        onehot = (nearest(centers)[:, None] == ar[None, :]).to(torch.float32) * w_l[:, None]
        sums, counts = _sum_over(mesh, onehot.T @ feat_l, onehot.sum(dim=0))
        new = sums / (counts + 1e-6)[:, None]
        centers = new if slot_ok is None else torch.where(slot_ok[:, None], new, centers)
    return centers, nearest(centers).to(torch.int32)


def _init_pool(feat_l, w_l, generator, sample_per_shard: int, mesh: Mesh):
    """A pool of seeds: sample_per_shard rows of each rank drawn with
    replacement by weight, gathered. -> (pool [D s, F], its weights [D s])."""
    p = torch.cumsum(w_l + 1e-9, dim=0)
    u = torch.rand(sample_per_shard, generator=generator, device=feat_l.device)
    idx = torch.clamp(torch.searchsorted(p, u * p[-1], right=True), max=len(p) - 1)
    return all_gather(feat_l[idx], mesh), all_gather(w_l[idx], mesh)


@torch.no_grad()
def assign_root_sharded(mesh: Mesh, state: KMeansState, ins_feat, xyz, alive,
                        pos_weight: float, generator: torch.Generator | None = None,
                        iters: int = 5, init: bool = False, sample_per_shard: int = 1024,
                        init_centers: torch.Tensor | None = None) -> KMeansState:
    """The sharded ops/kmeans.py:assign_root: ins_feat [n, 6], xyz [n, 3] and
    alive [n] this rank's rows. -> the state with the centers the same on
    every rank and cls_ids this rank's rows. init_centers [k1, 9]: the fresh
    seeds, in place of the pool's k-means++."""
    k = state.centers.shape[0]
    f = torch.cat([ins_feat, xyz * pos_weight], dim=-1)
    f = torch.where(alive[:, None], f, 0.0)  # dead rows may hold NaN
    w = alive.to(torch.float32)
    if init_centers is None:
        pool, pool_w = _init_pool(f, w, generator, sample_per_shard, mesh)
        init_centers = init_centers_from_points(pool, pool_w, k, generator)

    def run(c0):
        c, ids = _lloyd_sharded(f, w, c0, iters, mesh)
        err = (torch.gather(_dist2(f, c), 1, ids.long()[:, None])[:, 0] * w).sum()
        (err,) = _sum_over(mesh, err)
        return c, ids, err

    c1, i1, e1 = run(init_centers)
    if init:
        return dataclasses.replace(state, centers=c1, cls_ids=i1)
    c2, i2, e2 = run(state.centers)
    c1, i1 = _align_labels(c1, i1, state.centers)
    better = e1 < e2
    return dataclasses.replace(state, centers=torch.where(better, c1, c2),
                               cls_ids=torch.where(better, i1, i2))


@torch.no_grad()
def assign_leaf_sharded(mesh: Mesh, state: KMeansState, ins_feat, alive,
                        selected_root: int, k2: int, generator: torch.Generator | None = None,
                        iters: int = 5, init: bool = False, sample_per_shard: int = 512,
                        init_centers: torch.Tensor | None = None) -> KMeansState:
    """The sharded ops/kmeans.py:assign_leaf: re-cluster one root's splats
    (ins_feat [n, 6], alive [n] and state.cls_ids / leaf_cls_ids this
    rank's rows) into its k2 slots, the slots at or past leaf_sub_num masked
    out of the argmin. init_centers [k2, 6]: the seeds with init, in place
    of the pool's k-means++."""
    f = torch.where(alive[:, None], ins_feat, 0.0)
    member = (state.cls_ids == selected_root) & alive
    w = member.to(torch.float32)
    start = selected_root * k2
    slot_ok = torch.arange(k2, device=f.device) < state.leaf_sub_num[selected_root]
    local = state.leaf_centers[start:start + k2]
    if init:
        if init_centers is None:
            pool, pool_w = _init_pool(f, w + 1e-9, generator, sample_per_shard, mesh)
            init_centers = init_centers_from_points(pool, pool_w, k2, generator)
        local = init_centers
    local, ids = _lloyd_sharded(f, w, local, iters, mesh, slot_ok)
    leaf_centers = state.leaf_centers.clone()
    leaf_centers[start:start + k2] = local
    return dataclasses.replace(state, leaf_centers=leaf_centers,
                               leaf_cls_ids=torch.where(member, ids + start,
                                                        state.leaf_cls_ids))

"""Two-level k-means codebook (port of opengaussian_tpu/ops/kmeans.py;
reference scene/kmeans_quantize.py:12-280).

The coarse (root) level clusters cat(ins_feat, xyz * pos_weight) [N, 9]
into k1 centers; Lloyd iterations recompute centers from one-hot sums, with
dead (padding) splats at weight 0; quantization uses the straight-through
estimator q = feat - feat.detach() + centers[ids]. The leaf level
(`assign_leaf`) clusters the 6-D features of one root's splats into that
root's k2 slots, of which only the first leaf_sub_num[root] take part; every
splat starts in the "unassigned" bucket k1 * k2.

Distances are |x|^2 - 2 x c^T + |c|^2 with a float32 matrix product at
PyTorch's default precision (no TF32). The k-means++ draws come from a
torch.Generator, which cannot reproduce the JAX package's PRNG: tests hand
both packages the same initial centers instead (`assign_root` and
`assign_leaf` take `init_centers=...`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class KMeansState:
    centers: torch.Tensor  # [k1, 9] coarse centers
    cls_ids: torch.Tensor  # [N] int32 coarse assignment
    leaf_centers: torch.Tensor  # [k1*k2+1, 6]
    leaf_cls_ids: torch.Tensor  # [N] int32 fine assignment
    leaf_sub_num: torch.Tensor  # [k1] int32 active leaves per root

    @staticmethod
    def create(n: int, k1: int, k2: int, device="cuda", dim: int = 6,
               pos_dim: int = 3) -> "KMeansState":
        dev = resolve_device(device)
        return KMeansState(
            centers=torch.zeros((k1, dim + pos_dim), device=dev),
            cls_ids=torch.zeros((n,), dtype=torch.int32, device=dev),
            leaf_centers=torch.zeros((k1 * k2 + 1, dim), device=dev),
            # all points start in the "unassigned" bucket k1*k2
            leaf_cls_ids=torch.full((n,), k1 * k2, dtype=torch.int32, device=dev),
            leaf_sub_num=torch.full((k1,), k2, dtype=torch.int32, device=dev),
        )

    def grow(self, new_cap: int) -> "KMeansState":
        """Pad the per-splat assignments to new_cap slots: new slots take
        root 0 and the unassigned leaf bucket (the JAX trainer's
        _maybe_grow)."""
        pad = new_cap - self.cls_ids.shape[0]
        unassigned = self.leaf_centers.shape[0] - 1
        return dataclasses.replace(
            self,
            cls_ids=torch.cat([self.cls_ids, self.cls_ids.new_zeros(pad)]),
            leaf_cls_ids=torch.cat([self.leaf_cls_ids,
                                    self.leaf_cls_ids.new_full((pad,), unassigned)]))


def kmeans_from_numpy(d: dict, device="cuda") -> KMeansState:
    """A KMeansState from numpy arrays of every field, e.g. the JAX
    package's KMeansState leaves."""
    dev = resolve_device(device)
    f = lambda k: torch.tensor(np.asarray(d[k], np.float32), device=dev)  # noqa: E731
    i = lambda k: torch.tensor(np.asarray(d[k], np.int32), device=dev)  # noqa: E731
    return KMeansState(centers=f("centers"), cls_ids=i("cls_ids"),
                       leaf_centers=f("leaf_centers"), leaf_cls_ids=i("leaf_cls_ids"),
                       leaf_sub_num=i("leaf_sub_num"))


def _dist2(x, c):
    """[N,D] x [K,D] -> squared distances [N,K]."""
    x2 = (x * x).sum(dim=-1, keepdim=True)
    c2 = (c * c).sum(dim=-1)
    return x2 - 2.0 * (x @ c.T) + c2[None, :]


def _lloyd(feat, weight, centers, iters: int):
    """weight [N] in {0,1}: dead splats don't pull centers.
    -> (centers, ids int32)."""
    k = centers.shape[0]
    ar = torch.arange(k, device=feat.device)
    for _ in range(iters):
        ids = torch.argmin(_dist2(feat, centers), dim=-1)
        onehot = (ids[:, None] == ar[None, :]).to(torch.float32) * weight[:, None]
        sums = onehot.T @ feat
        counts = onehot.sum(dim=0) + 1e-6
        centers = sums / counts[:, None]
    ids = torch.argmin(_dist2(feat, centers), dim=-1).to(torch.int32)
    return centers, ids


def init_centers_from_points(feat: torch.Tensor, weight: torch.Tensor, k: int,
                             generator: torch.Generator | None = None) -> torch.Tensor:
    """k-means++ (D^2) seeding over alive points: the first center drawn by
    weight, each next one with probability proportional to its squared
    distance from the centers so far."""
    p0 = weight / torch.clamp(weight.sum(), min=1.0)
    first = feat[torch.multinomial(p0, 1, generator=generator)[0]]
    centers = torch.zeros((k, feat.shape[1]), dtype=feat.dtype, device=feat.device)
    centers[0] = first
    d2 = ((feat - first) ** 2).sum(dim=-1) * weight
    for i in range(1, k):
        p = d2 / torch.clamp(d2.sum(), min=1e-12)
        nxt = feat[torch.multinomial(p, 1, generator=generator)[0]]
        centers[i] = nxt
        d2 = torch.minimum(d2, ((feat - nxt) ** 2).sum(dim=-1) * weight)
    return centers


def match_labels(centers, ref_centers):
    """Greedy bijective matching of `centers` onto `ref_centers` (closest
    pairs first). -> (perm, inv): new cluster i takes ref label perm[i];
    centers[inv] is the center table reordered to ref labels."""
    k = centers.shape[0]
    cost = _dist2(centers, ref_centers)  # [k_new, k_ref]
    perm = torch.zeros((k,), dtype=torch.int64, device=centers.device)
    for _ in range(k):  # on the device: no host round trip per step
        flat = torch.argmin(cost)
        i, j = flat // k, flat % k
        perm[i] = j
        cost[i, :] = torch.inf
        cost[:, j] = torch.inf
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(k, device=centers.device)
    return perm.to(torch.int32), inv.to(torch.int32)


def _align_labels(centers, ids, ref_centers):
    """Relabel `centers`/`ids` onto `ref_centers` labels via match_labels."""
    perm, inv = match_labels(centers, ref_centers)
    return centers[inv.long()], perm[ids.long()]


@torch.no_grad()
def assign_root(state: KMeansState, ins_feat: torch.Tensor, xyz: torch.Tensor,
                alive: torch.Tensor, pos_weight: float,
                generator: torch.Generator | None = None, iters: int = 5,
                init: bool = False, init_centers: torch.Tensor | None = None) -> KMeansState:
    """Cluster cat(ins_feat, xyz * pos_weight) of the alive splats into the
    k1 root centers.

    init: the first assignment, Lloyd from k-means++ seeds. Otherwise Lloyd
    from the cached centers competes with a fresh k-means++ restart
    (relabelled onto the cached labels by greedy center matching), and the
    clustering with the smaller quantization error wins, as in the JAX
    package. init_centers [k1, 9]: the seeds to use instead of drawing them
    from `generator`."""
    feat = torch.cat([ins_feat, xyz * pos_weight], dim=-1)
    # dead rows can hold NaN (densification surgery); 0 * NaN = NaN would
    # poison every center through the one-hot product, so they are zeroed
    feat = torch.where(alive[:, None], feat, 0.0)
    w = alive.to(torch.float32)

    def run(centers0):
        centers, ids = _lloyd(feat, w, centers0, iters)
        d = _dist2(feat, centers)
        err = (torch.gather(d, 1, ids.long()[:, None])[:, 0] * w).sum()
        return centers, ids, err

    fresh = (init_centers if init_centers is not None else
             init_centers_from_points(feat, w, state.centers.shape[0], generator))
    c1, i1, e1 = run(fresh)
    if init:
        centers, ids = c1, i1
    else:
        c2, i2, e2 = run(state.centers)
        c1, i1 = _align_labels(c1, i1, state.centers)
        better = e1 < e2
        centers = torch.where(better, c1, c2)
        ids = torch.where(better, i1, i2)
    return dataclasses.replace(state, centers=centers, cls_ids=ids)


@torch.no_grad()
def assign_leaf(state: KMeansState, ins_feat: torch.Tensor, alive: torch.Tensor,
                selected_root: int, k2: int, generator: torch.Generator | None = None,
                iters: int = 5, init: bool = False,
                init_centers: torch.Tensor | None = None) -> KMeansState:
    """Re-cluster the 6-D features of one root's splats into its k2 leaf
    slots (reference scene/kmeans_quantize.py:195-206, 232-241). Slots at or
    past the root's leaf_sub_num are masked out of the argmin and keep
    their centers. init: Lloyd from k-means++ seeds drawn over the root's
    splats (every other splat at weight 1e-9, as in the JAX package);
    otherwise from the root's cached leaf centers. init_centers [k2, 6]: the
    seeds to use instead of drawing them from `generator`."""
    feat = torch.where(alive[:, None], ins_feat, 0.0)  # see assign_root
    member = (state.cls_ids == selected_root) & alive
    w = member.to(torch.float32)
    start = selected_root * k2
    n_sub = state.leaf_sub_num[selected_root]
    local = state.leaf_centers[start:start + k2]
    if init:
        local = (init_centers if init_centers is not None else
                 init_centers_from_points(feat, w + 1e-9, k2, generator))
    ar = torch.arange(k2, device=feat.device)
    slot_ok = ar < n_sub

    def nearest(c):
        return torch.argmin(torch.where(slot_ok[None, :], _dist2(feat, c), torch.inf),
                            dim=-1)

    for _ in range(iters):
        onehot = (nearest(local)[:, None] == ar[None, :]).to(torch.float32) * w[:, None]
        new_c = (onehot.T @ feat) / (onehot.sum(dim=0) + 1e-6)[:, None]
        local = torch.where(slot_ok[:, None], new_c, local)
    ids = nearest(local).to(torch.int32)
    leaf_centers = state.leaf_centers.clone()
    leaf_centers[start:start + k2] = local
    leaf_ids = torch.where(member, ids + start, state.leaf_cls_ids)
    return dataclasses.replace(state, leaf_centers=leaf_centers, leaf_cls_ids=leaf_ids)


def quantize(state: KMeansState, ins_feat: torch.Tensor, mode: str) -> torch.Tensor:
    """Straight-through quantized features [N, 6]: the value of each splat's
    center, the gradient of ins_feat."""
    if mode == "root":
        sampled = state.centers[state.cls_ids.long()][:, :6]
    else:
        sampled = state.leaf_centers[state.leaf_cls_ids.long()]
    return ins_feat - ins_feat.detach() + sampled.detach()

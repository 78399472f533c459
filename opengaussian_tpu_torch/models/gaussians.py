"""Gaussian parameter store (port of opengaussian_tpu/models/gaussians.py).

A frozen dataclass of tensors padded to a capacity that is a multiple of
4096, with an `alive` mask; padded slots have `logit_opacity = -10`,
identity quaternions and `alive = False`, and render as fully transparent.
The padding keeps every array the same shape as the JAX package's, so the
two compare slot for slot.

Densification (reference scene/gaussian_model.py:452-508) works as in the
JAX package: new splats go into dead slots found with a stable argsort,
overflow is dropped and reported, and the Adam moment surgery (reference
scene/gaussian_model.py:357-427) writes zeros into the moments of children
and split parents. Each event returns new tensors; the inputs are not
changed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models.optimizer import AdamState
from opengaussian_tpu_torch.ops.projection import quat_to_rotmat
from opengaussian_tpu_torch.ops.sh import rgb_to_sh

PARAM_FIELDS = (
    "means",
    "sh_dc",
    "sh_rest",
    "log_scales",
    "quats",
    "logit_opacity",
    "ins_feat",
)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """All tensors are [N_cap, ...]; slots with alive=False are padding."""

    means: torch.Tensor  # [N,3]
    sh_dc: torch.Tensor  # [N,1,3]
    sh_rest: torch.Tensor  # [N,(K-1),3]
    log_scales: torch.Tensor  # [N,3]
    quats: torch.Tensor  # [N,4] (w,x,y,z), unnormalized
    logit_opacity: torch.Tensor  # [N]
    ins_feat: torch.Tensor  # [N,6] continuous instance features
    alive: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacity(self) -> torch.Tensor:
        # dead slots render as fully transparent
        return torch.where(self.alive, torch.sigmoid(self.logit_opacity), 0.0)

    @property
    def sh(self) -> torch.Tensor:
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)  # [N,K,3]

    def normalized_ins_feat(self, quantized: torch.Tensor | None = None):
        """L2-normalized instance feature (all-zero rows stay zero); pass
        quantized features to mimic the reference's get_ins_feat(origin=False)."""
        f = self.ins_feat if quantized is None else quantized
        sq = torch.sum(f * f, dim=-1, keepdim=True)
        n = torch.sqrt(torch.where(sq > 0, sq, 1.0))
        return torch.where(sq > 0, f / n, 0.0)

    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_FIELDS}

    def with_params(self, p: dict) -> "GaussianState":
        return dataclasses.replace(self, **p)


@dataclasses.dataclass(frozen=True)
class DensifyStats:
    """Screen-space gradient accumulation driving densification
    (reference scene/gaussian_model.py:510-514)."""

    grad_accum: torch.Tensor  # [N] sum of ||d ndc||
    denom: torch.Tensor  # [N] visible-step count
    max_radii2d: torch.Tensor  # [N] running max of on-screen radius

    @staticmethod
    def zeros(n: int, device="cuda") -> "DensifyStats":
        dev = resolve_device(device)
        z = lambda: torch.zeros((n,), dtype=torch.float32, device=dev)  # noqa: E731
        return DensifyStats(grad_accum=z(), denom=z(), max_radii2d=z())

    def update(self, screen_grad: torch.Tensor, radii: torch.Tensor) -> "DensifyStats":
        """screen_grad [N,2] = grad of loss w.r.t. the NDC screen tap;
        radii [N] int (0 => not visible)."""
        vis = radii > 0
        return DensifyStats(
            grad_accum=self.grad_accum
            + torch.where(vis, torch.linalg.vector_norm(screen_grad, dim=-1), 0.0),
            denom=self.denom + vis.to(torch.float32),
            max_radii2d=torch.maximum(self.max_radii2d, radii.to(torch.float32)),
        )


def round_capacity(n: int, multiple: int = 4096) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def state_from_numpy(d: dict, device="cuda") -> GaussianState:
    """A GaussianState from numpy arrays of every field (PARAM_FIELDS and
    `alive`), e.g. the JAX package's GaussianState leaves, already padded."""
    dev = resolve_device(device)
    fields = {k: torch.tensor(np.asarray(d[k], np.float32), device=dev)
              for k in PARAM_FIELDS}
    alive = torch.tensor(np.asarray(d["alive"], bool), device=dev)
    return GaussianState(alive=alive, **fields)


def adam_from_numpy(mu: dict, nu: dict, count, device="cuda") -> AdamState:
    """An AdamState from numpy moments keyed by PARAM_FIELDS and a step
    count, e.g. the JAX package's AdamState leaves."""
    dev = resolve_device(device)
    t = lambda d: {k: torch.tensor(np.asarray(d[k], np.float32), device=dev)  # noqa: E731
                   for k in PARAM_FIELDS}
    return AdamState(mu=t(mu), nu=t(nu), count=int(count))


def stats_from_numpy(grad_accum, denom, max_radii2d, device="cuda") -> DensifyStats:
    """DensifyStats from numpy arrays, e.g. the JAX package's."""
    dev = resolve_device(device)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    return DensifyStats(t(grad_accum), t(denom), t(max_radii2d))


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance to the k nearest neighbors (scale init), on
    scipy's cKDTree as the reference fork's CPU replacement of distCUDA2."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
    return (d[:, 1:] ** 2).mean(axis=1)


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int = 3,
    seed: int = 0,
    capacity: int | None = None,
    device="cuda",
) -> GaussianState:
    """Initialize from an SfM point cloud (reference
    scene/gaussian_model.py:181-209): scales from sqrt of the KNN mean
    squared distance, identity rotations, opacity 0.1, ins_feat ~ U[0,1).
    The draws come from numpy's generator with `seed`, as in the JAX
    package, so both packages start from the same features."""
    n = points.shape[0]
    cap = capacity or round_capacity(n)
    k = (sh_degree + 1) ** 2
    rng = np.random.default_rng(seed)

    dist2 = np.maximum(knn_mean_sq_dist(points), 1e-7)
    log_scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, dtype=np.float32)
        out[:n] = x
        return out

    quats = pad(np.tile(np.float32([1, 0, 0, 0]), (n, 1)))
    quats[n:, 0] = 1.0
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    logit = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))
    return state_from_numpy(dict(
        means=pad(points.astype(np.float32)),
        sh_dc=pad(rgb_to_sh(colors.astype(np.float32))[:, None, :]),
        sh_rest=pad(np.zeros((n, k - 1, 3), np.float32)),
        log_scales=pad(log_scales.astype(np.float32)),
        quats=quats,
        logit_opacity=pad(np.full((n,), logit, np.float32), fill=-10.0),
        ins_feat=pad(rng.random((n, 6), np.float32)),
        alive=alive,
    ), device)


# ---------------------------------------------------------------------------
# densification
# ---------------------------------------------------------------------------


def densify_and_prune(
    state: GaussianState,
    moments: tuple,  # (mu, nu): dicts matching state.params()
    stats: DensifyStats,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,  # 0 => disabled (reference passes None)
    percent_dense: float,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """One densify+prune event (reference scene/gaussian_model.py:452-508 and
    train.py:593-605). Returns (state, moments, stats, n_overflow).

    noise [2, cap, 3]: the standard-normal draws of the split children,
    before they are scaled by the splats' scales (the JAX package draws them
    with jax.random.normal(key, (2, cap, 3))). Without it they are drawn
    from `generator` on the state's device."""
    mu, nu = moments
    cap = state.capacity
    dev = state.device
    if noise is None:
        if generator is None:
            raise ValueError("densify_and_prune needs noise or a generator")
        noise = torch.randn((2, cap, 3), generator=generator, device=dev)
    grads = torch.where(stats.denom > 0, stats.grad_accum / stats.denom, 0.0)
    scales = torch.exp(state.log_scales)
    max_scale = scales.max(dim=-1).values

    hot = state.alive & (grads >= max_grad)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)

    # --- allocate one dead slot per clone/split ---
    needs = clone_mask | split_mask
    dead_slots = torch.argsort(state.alive.to(torch.int32), stable=True)  # dead first
    n_dead = cap - state.num_alive
    rank = torch.cumsum(needs.to(torch.int64), 0) - 1
    fits = needs & (rank < n_dead)
    n_overflow = needs.sum() - fits.sum()
    src = torch.nonzero(fits).squeeze(1)  # source slot -> child slot dest
    dest = dead_slots[rank[src]]

    # --- child parameters: split children (and the rewritten parent) are
    # offset by N(0, scale) rotated into world space (reference
    # densify_and_split) ---
    eps = noise * scales[None]
    rot = quat_to_rotmat(state.quats)  # [cap,3,3]
    offs = torch.einsum("nij,knj->kni", rot, eps)  # [2,cap,3]
    split_scales = torch.log(scales / (0.8 * 2))
    sm = split_mask[:, None]

    child = state.params()
    child["means"] = torch.where(sm, state.means + offs[1], state.means)
    child["log_scales"] = torch.where(sm, split_scales, state.log_scales)

    def scatter(base, vals):
        out = base.clone()
        out[dest] = vals[src]
        return out

    p = state.params()
    new_p = {k: scatter(p[k], child[k]) for k in PARAM_FIELDS}
    # rewrite split parents in place (sample 0 of 2)
    new_p["means"] = torch.where(sm, state.means + offs[0], new_p["means"])
    new_p["log_scales"] = torch.where(sm, split_scales, new_p["log_scales"])
    alive = state.alive.clone()
    alive[dest] = True

    # --- optimizer moment surgery: children and split parents get zeros ---
    def fresh(m: dict) -> dict:
        out = {}
        for k, x in m.items():
            x = x.clone()
            x[dest] = 0.0
            smask = split_mask.reshape((cap,) + (1,) * (x.dim() - 1))
            out[k] = torch.where(smask, 0.0, x)
        return out

    mu, nu = fresh(mu), fresh(nu)

    # --- prune (reference densify_and_prune tail) ---
    prune = torch.sigmoid(new_p["logit_opacity"]) < min_opacity
    if max_screen_size:
        # Reference quirk preserved: densification_postfix zeroes max_radii2D
        # BEFORE the prune reads it (scene/gaussian_model.py:450,505), so the
        # screen-size condition never fires there; only the world-size check
        # (scale > 0.1 * extent) is live.
        big_ws = torch.exp(new_p["log_scales"]).max(dim=-1).values > 0.1 * extent
        prune = prune | big_ws
    alive = alive & ~prune

    new_state = dataclasses.replace(state, alive=alive, **new_p)
    return new_state, (mu, nu), DensifyStats.zeros(cap, dev), n_overflow


def reset_opacity(state: GaussianState, moments: tuple):
    """Clamp opacity to <= 0.01 and zero its Adam moments
    (reference scene/gaussian_model.py:300-303, train.py:604-605)."""
    mu, nu = moments
    new_logit = inverse_sigmoid(
        torch.clamp(torch.sigmoid(state.logit_opacity), max=0.01))
    mu = {**mu, "logit_opacity": torch.zeros_like(mu["logit_opacity"])}
    nu = {**nu, "logit_opacity": torch.zeros_like(nu["logit_opacity"])}
    return dataclasses.replace(state, logit_opacity=new_logit), (mu, nu)


def grow_capacity(x, new_cap: int):
    """Pad every [N_cap, ...] tensor of a GaussianState, a DensifyStats or a
    moments dict with zeros to new_cap, as the JAX package pads its leaves."""

    def pad(t: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((new_cap,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        out[: t.shape[0]] = t
        return out

    if isinstance(x, dict):
        return {k: pad(v) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: pad(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})

"""Checkpoint save and restore (port of opengaussian_tpu/train/checkpoint.py).

A checkpoint is a flat .npz of the whole training state in the JAX
package's key layout: /state/<field>, /adam/mu/<field>, /adam/nu/<field>,
/adam/count, /stats/<field>, /kmeans/<field> and /iteration. A checkpoint
written by either package loads in the other. `load_torch` reads a
reference `chkpnt*.pth` (torch.save((capture(), iteration)), reference
scene/gaussian_model.py:84-120, train.py:613-616) in its 14-tuple form and
in the legacy 12-tuple form of vanilla 3DGS, which gets fresh instance
features and a reset optimizer (reference train.py:168-184), as does
`ensure_ins_feat` for a state whose features are all zero.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.models.gaussians import (
    DensifyStats,
    GaussianState,
    round_capacity,
)
from opengaussian_tpu_torch.models.optimizer import AdamState
from opengaussian_tpu_torch.ops.kmeans import KMeansState


def _fields(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def save(path: str, state: GaussianState, adam: AdamState, stats: DensifyStats,
         kmeans: KMeansState | None, iteration: int):
    """Write the training state to `path` (.npz)."""
    tree = {
        "state": _fields(state),
        "adam": {"mu": adam.mu, "nu": adam.nu, "count": np.int32(adam.count)},
        "stats": _fields(stats),
        "kmeans": _fields(kmeans) if kmeans is not None else {},
        "iteration": np.int64(iteration),
    }
    flat = {}

    def rec(prefix, d):
        if isinstance(d, dict):
            for k, v in d.items():
                rec(f"{prefix}/{k}", v)
        else:
            flat[prefix] = d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)

    rec("", tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load(path: str, device="cuda"):
    """-> (GaussianState, AdamState, DensifyStats, KMeansState | None,
    iteration), the tensors on `device`."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    nest: dict = {}
    for k in z.files:
        *parents, leaf = k.strip("/").split("/")
        d = nest
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = z[k]
    t = lambda d: {k: torch.as_tensor(v, device=dev) for k, v in d.items()}  # noqa: E731
    state = GaussianState(**t(nest["state"]))
    adam = AdamState(mu=t(nest["adam"]["mu"]), nu=t(nest["adam"]["nu"]),
                     count=int(nest["adam"]["count"]))
    stats = DensifyStats(**t(nest["stats"]))
    kms = KMeansState(**t(nest["kmeans"])) if nest.get("kmeans") else None
    return state, adam, stats, kms, int(nest["iteration"])


_TORCH_GROUP_TO_FIELD = {
    # reference training_setup group names -> GaussianState fields
    # (reference scene/gaussian_model.py:216-224)
    "xyz": "means",
    "f_dc": "sh_dc",
    "f_rest": "sh_rest",
    "opacity": "logit_opacity",
    "scaling": "log_scales",
    "rotation": "quats",
    "ins_feat": "ins_feat",
}


def load_torch(path: str, seed: int = 0, capacity: int | None = None, device="cuda"):
    """Load a reference `chkpnt*.pth` into (GaussianState, AdamState,
    DensifyStats, iteration, spatial_lr_scale), padded to `capacity`
    (default: the next multiple of 4096). A legacy 12-tuple (no ins_feat)
    gets U[0,1) features from np.random.default_rng(seed) and a fresh
    optimizer. This is what lets the ScanNet recipe (resume stages 1-3 from a
    stage-0 checkpoint) start from reference artifacts."""
    dev = resolve_device(device)
    model_params, iteration = torch.load(path, map_location="cpu", weights_only=False)

    def tonp(x):
        return (np.ascontiguousarray(x.detach().cpu().numpy()) if hasattr(x, "detach")
                else np.asarray(x))

    if len(model_params) == 12:
        (_sh_deg, xyz, f_dc, f_rest, scaling, rotation, opacity,
         max_radii2d, grad_accum, denom, _opt_dict, lr_scale) = model_params
        rng = np.random.default_rng(seed)
        ins_feat = rng.random((tonp(xyz).shape[0], 6)).astype(np.float32)
        opt_dict = None  # the reference replaces it with a fresh optimizer
    else:
        (_sh_deg, xyz, f_dc, f_rest, scaling, rotation, opacity,
         ins_feat, _ins_feat_q, max_radii2d, grad_accum, denom,
         opt_dict, lr_scale) = model_params
        ins_feat = tonp(ins_feat)

    xyz = tonp(xyz).astype(np.float32)
    n = xyz.shape[0]
    cap = capacity or round_capacity(n)

    def pad(x, fill=0.0):
        x = np.asarray(x, np.float32)
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    quats = pad(tonp(rotation))
    quats[n:, 0] = 1.0
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    state = GaussianState(
        means=t(pad(xyz)), sh_dc=t(pad(tonp(f_dc))), sh_rest=t(pad(tonp(f_rest))),
        log_scales=t(pad(tonp(scaling))), quats=t(quats),
        logit_opacity=t(pad(tonp(opacity).reshape(n), fill=-10.0)),
        ins_feat=t(pad(np.asarray(ins_feat, np.float32).reshape(n, -1))),
        alive=t(alive))

    adam = opt_mod.init(state.params())
    if opt_dict is not None:
        # torch Adam state_dict: param indices follow group insertion order
        idx_to_field = {}
        pi = 0
        for g in opt_dict["param_groups"]:
            for _ in g["params"]:
                idx_to_field[pi] = _TORCH_GROUP_TO_FIELD.get(g.get("name", ""))
                pi += 1
        mu, nu, count = dict(adam.mu), dict(adam.nu), 0
        for pi, st in opt_dict.get("state", {}).items():
            field = idx_to_field.get(int(pi))
            if field is None:
                continue
            row_shape = (n,) + tuple(mu[field].shape[1:])
            mu[field] = t(pad(tonp(st["exp_avg"]).reshape(row_shape)))
            nu[field] = t(pad(tonp(st["exp_avg_sq"]).reshape(row_shape)))
            count = max(count, int(tonp(st["step"]).reshape(())))
        adam = AdamState(mu=mu, nu=nu, count=count)

    stats = DensifyStats(grad_accum=t(pad(tonp(grad_accum).reshape(n))),
                         denom=t(pad(tonp(denom).reshape(n))),
                         max_radii2d=t(pad(tonp(max_radii2d).reshape(n))))
    return state, adam, stats, int(iteration), float(lr_scale)


def ensure_ins_feat(state: GaussianState, seed: int = 0) -> GaussianState:
    """Fresh U[0,1) instance features where every feature is zero (legacy
    3DGS checkpoints; reference train.py:170-183), drawn from
    np.random.default_rng(seed) as in the JAX package."""
    if float(state.ins_feat.abs().max()) > 0:
        return state
    rng = np.random.default_rng(seed)
    return dataclasses.replace(state, ins_feat=torch.as_tensor(
        rng.random(tuple(state.ins_feat.shape), np.float32), device=state.device))

"""One rank of the port's 2-rank mesh scenarios (tests/test_torch_parallel.py).

Run as `PYTHONPATH=<repo> python tests/torch_mesh_worker.py RANK WORLD STORE
OUT`, one process per rank: it joins a gloo group through the file store
STORE, runs every scenario on its shard and writes OUT/rank{RANK}.npz for the
test to hold against the JAX package. It imports torch, numpy and the port
only (never JAX); the scenes come from the functions below, which the test
calls too, so both sides build the same inputs from the same seeds.
"""

from __future__ import annotations

import dataclasses
import datetime
import sys

import numpy as np
import torch

CFG = dict(max_per_tile=256, chunk=32, min_intersections=16384)
BAND_P = 8192
W, H = 80, 48  # 5 x 3 = 15 tiles: two ranks pad the tile range to 16
WIN = dict(max_per_tile=64, chunk=32, min_intersections=65536, tile_windows=12)
RENDER_CASES = {  # name -> RasterizeConfig fields
    "stream": dict(CFG),
    "stream_band": dict(CFG, band_intersection_budget=BAND_P),
    "dense": dict(CFG, pallas_input="dense"),
    "dense_band": dict(CFG, pallas_input="dense", band_intersection_budget=BAND_P),
    "compact_band": dict(CFG, bwd_layout="compact", band_intersection_budget=BAND_P),
    "window_band": dict(WIN, band_intersection_budget=32768),
}
GRAD_CASES = ("stream", "stream_band", "dense_band", "compact_band")
STEPS = 8


def random_scene(n, seed=0):
    """tests/test_rasterize.py:random_scene, in numpy."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(scale=0.6, size=n), rng.normal(scale=0.6, size=n),
                      rng.uniform(2.0, 6.0, size=n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.1, 0.95, size=n).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, scales, quats, op, cols


def deep_scene(n=400, seed=4):
    """tests/test_windows.py:deep_scene."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(0, 0.08, n), rng.normal(0, 0.06, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.05, 0.6, n).astype(np.float32)
    pay = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, scales, quats, op, pay


def scene_of(case: str):
    return deep_scene() if case.startswith("window") else random_scene(256)


def toy_points(n=64, seed=2):
    """tests/test_parallel.py:_toy_training_state's cloud and colors."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.uniform(2.5, 5, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    gt = rng.uniform(0.3, 0.7, (48, 64, 3)).astype(np.float32)
    return pts, cols, gt


def alpha_target(seed=7):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (48, 64)).astype(np.float32)


def grad_target(seed=0):
    return np.random.default_rng(seed).uniform(size=(H, W, 3)).astype(np.float32)


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops import budget
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.parallel.distributed import scaling_bench
    from opengaussian_tpu_torch.parallel.mesh import make_mesh, shard_gaussians
    from opengaussian_tpu_torch.parallel.render import make_sharded_train_step, render_sharded
    from opengaussian_tpu_torch.parallel.steps import make_sharded_steps

    mesh = make_mesh()
    res = {}
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    bg = torch.tensor([0.1, 0.2, 0.3])
    for case, fields in RENDER_CASES.items():
        means, scales, quats, op, cols = scene_of(case)
        cov = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
        m, c, o, p = shard_gaussians(mesh, (torch.as_tensor(means), cov, torch.as_tensor(op),
                                            torch.as_tensor(cols)))
        m.requires_grad_(True)
        p.requires_grad_(True)
        img, alpha, depth, radii, n_lost = render_sharded(
            mesh, cam, m, c, o, p, bg, RasterizeConfig(**fields))
        res.update({f"{case}/image": img.detach(), f"{case}/alpha": alpha.detach(),
                    f"{case}/depth": depth.detach(), f"{case}/radii": radii,
                    f"{case}/n_lost": n_lost})
        if case in GRAD_CASES:
            loss = ((img - torch.as_tensor(grad_target())) ** 2).sum()
            gm, gp = torch.autograd.grad(loss, [m, p])
            res.update({f"{case}/loss": loss.detach(), f"{case}/g_means": gm,
                        f"{case}/g_cols": gp})
    # a band budget far below the need: its drops show in n_lost
    means, scales, quats, op, cols = random_scene(400, seed=3)
    cov = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    sh = shard_gaussians(mesh, tuple(torch.as_tensor(x) for x in (means, op, cols)))
    c = shard_gaussians(mesh, cov)
    *_, n_lost = render_sharded(mesh, cam, sh[0], c, sh[1], sh[2], torch.zeros(3),
                                RasterizeConfig(**dict(CFG, band_intersection_budget=64)))
    res["tight/n_lost"] = n_lost

    # the band probe: each rank probes its own shard
    pts, cols, gt = toy_points(n=128)
    probe_state = G.create_from_pcd(pts, cols, capacity=128, seed=0, device="cpu")
    shard = shard_gaussians(mesh, probe_state)
    big = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 128, 128)
    tuned = budget.tuned_config(RasterizeConfig(**CFG), shard, [big], mesh=mesh)
    *_, n_lost = render_sharded(mesh, big, shard.means, build_cov3d(shard.scales, shard.quats),
                                shard.opacity, shard.sh_dc[:, 0], torch.zeros(3), tuned)
    res.update({"probe/intersection_budget": tuned.intersection_budget,
                "probe/max_per_tile": tuned.max_per_tile,
                "probe/band_intersection_budget": tuned.band_intersection_budget,
                "probe/n_lost": n_lost})

    # the stage-0 step: one step with the gated alpha loss, then 8 steps
    pts, cols, gt = toy_points()
    cam0 = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48)
    state = G.create_from_pcd(pts, cols, capacity=128, seed=0, device="cpu")
    adam = opt_mod.init(state.params())
    stats = G.DensifyStats.zeros(128, "cpu")
    ocfg = OptimizationConfig()
    state, mu, nu, stats = shard_gaussians(mesh, (state, adam.mu, adam.nu, stats))
    adam = opt_mod.AdamState(mu=mu, nu=nu, count=adam.count)
    steps = make_sharded_steps(mesh, RasterizeConfig(**CFG), ocfg, 1.0)
    bg0 = torch.tensor([0.3, 0.2, 0.1])
    s1, a1, st1, loss, aux = steps.stage0(state, adam, stats, cam0, torch.as_tensor(gt),
                                          torch.as_tensor(alpha_target()), 1, bg0,
                                          has_alpha=torch.tensor(True))
    res["stage0/loss"] = loss
    res.update({f"stage0/param/{k}": v for k, v in s1.params().items()})
    res.update({f"stage0/mu/{k}": v for k, v in a1.mu.items()})
    res.update({f"stage0/nu/{k}": v for k, v in a1.nu.items()})
    res.update({f"stage0/stats/{f.name}": getattr(st1, f.name)
                for f in dataclasses.fields(st1)})
    for name in ("stage1", "stage21", "stage22", "eval_render"):
        try:
            getattr(steps, name)()
        except NotImplementedError as e:
            res[f"left_out/{name}"] = "14b" in str(e)
    step = make_sharded_train_step(mesh, cam0, RasterizeConfig(**CFG), ocfg, 1.0)
    losses = []
    for it in range(STEPS):
        state, adam, loss, _ = step(state, adam, stats, torch.as_tensor(gt), it,
                                    torch.zeros(3))
        losses.append(float(loss))
    res["train/losses"] = np.asarray(losses)

    rows = scaling_bench(sizes=[1, 2], width=64, height=48, n_gauss=256, iters=2)
    res["scaling"] = np.asarray([[r["devices"], r["ms_per_step"], r["mpix_s"],
                                  r["efficiency"]] for r in rows])
    np.savez(f"{out}/rank{rank}.npz", **{
        k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

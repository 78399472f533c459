"""Multi-process start-up and the mesh-scaling bench (port of
opengaussian_tpu/parallel/distributed.py).

  * `init_distributed()`: torch.distributed's default process group from
    the JAX package's environment variables (OPENGS_NUM_PROCESSES,
    OPENGS_COORDINATOR as host:port, OPENGS_PROCESS_ID), NCCL where CUDA
    is available, else gloo; a single process does nothing;
  * `scaling_bench(...)`: times the sharded stage-0 step
    (parallel/steps.py) on meshes of the first 1, 2, ... ranks and reports
    Mpix/s and the parallel efficiency of each size. Run one process per
    device, e.g. `OPENGS_NUM_PROCESSES=2 OPENGS_COORDINATOR=localhost:29500
    OPENGS_PROCESS_ID=<rank> python -m opengaussian_tpu_torch.parallel.distributed
    --sizes 1 2`; one process alone runs size 1.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=5)  # a collective that waits longer fails


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize torch.distributed's default process group for a mesh over
    several processes. Arguments default to OPENGS_COORDINATOR (host:port of
    rank 0), OPENGS_NUM_PROCESSES and OPENGS_PROCESS_ID. With one process
    (or none named) it does nothing and returns False; else True once the
    group is up. Under NCCL each process takes the GPU of its rank modulo
    the visible GPUs."""
    n = num_processes or int(os.environ.get("OPENGS_NUM_PROCESSES", "0")) or None
    coordinator = coordinator or os.environ.get("OPENGS_COORDINATOR") or None
    if n in (None, 1) and coordinator is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None or n is None:
        raise ValueError("a multi-process start needs both OPENGS_NUM_PROCESSES and "
                         "OPENGS_COORDINATOR")
    rank = process_id if process_id is not None else int(
        os.environ.get("OPENGS_PROCESS_ID", "0"))
    backend = _backend()
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=n,
                            rank=rank, timeout=TIMEOUT)
    return dist.get_world_size() > 1


def scaling_bench(sizes=None, width: int = 648, height: int = 484, n_gauss: int = 100_000,
                  iters: int = 10, seed: int = 0, device=None) -> list[dict]:
    """Time the sharded stage-0 step on meshes of the first s ranks for each
    s in sizes (those up to the world's size) on one synthetic scene: n_gauss
    random splats of opacities N(0, 2) in logit, a random target. Every rank
    of the default group must call it (one is started when none is). ->
    [{devices, ms_per_step, mpix_s, efficiency}], the slowest rank's time per
    step over `iters` steps after one warm-up step; on ranks outside a size's
    mesh that size's row is missing. device: this rank's device (default:
    its GPU under NCCL, else the CPU)."""
    import dataclasses

    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops import budget
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.parallel.mesh import make_mesh, shard_gaussians
    from opengaussian_tpu_torch.parallel.steps import make_sharded_steps

    if not dist.is_initialized():  # one process: a group of one
        dist.init_process_group(_backend(), store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    sizes = [s for s in (sizes or [1, 2, 4, 8]) if s <= world]
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 1.2, n_gauss), rng.normal(0, 0.9, n_gauss),
                    rng.uniform(2.0, 10.0, n_gauss)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)
    base = G.create_from_pcd(pts, cols, capacity=n_gauss, seed=seed, device=device)
    base = dataclasses.replace(
        base, log_scales=base.log_scales + np.log(0.15),
        logit_opacity=torch.as_tensor(rng.normal(0.0, 2.0, n_gauss).astype(np.float32),
                                      device=device))
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 1.1, 0.9, width, height)
    rcfg = budget.tuned_config(RasterizeConfig(max_per_tile=1024, chunk=64), base, [cam])
    gt = torch.as_tensor(rng.uniform(0, 1, (height, width, 3)).astype(np.float32),
                         device=device)
    bg = torch.zeros(3, device=device)
    ocfg = OptimizationConfig()
    rows, base_ms = [], None
    for nd in sizes:
        mesh = make_mesh(nd, device)
        if mesh is None:
            continue
        adam = opt_mod.init(base.params())
        state, mu, nu, stats = shard_gaussians(
            mesh, (base, adam.mu, adam.nu, G.DensifyStats.zeros(n_gauss, device)))
        adam = opt_mod.AdamState(mu=mu, nu=nu, count=adam.count)
        steps = make_sharded_steps(mesh, rcfg, ocfg, 1.0)
        state, adam, stats, loss, _ = steps.stage0(state, adam, stats, cam, gt, None, 1, bg)
        _sync(mesh)
        t0 = time.perf_counter()
        for i in range(iters):
            state, adam, stats, loss, _ = steps.stage0(state, adam, stats, cam, gt, None,
                                                        i + 2, bg)
        _sync(mesh)
        ms = torch.tensor((time.perf_counter() - t0) / iters * 1000.0, dtype=torch.float64,
                          device=device)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX, group=mesh.group)
        ms = float(ms)
        base_ms = base_ms or ms
        rows.append(dict(devices=nd, ms_per_step=round(ms, 2),
                         mpix_s=round(width * height / ms / 1e3, 2),
                         efficiency=round(base_ms / ms / (nd / sizes[0]), 3)))
    return rows


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group)


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description="mesh-scaling benchmark of the sharded "
                                            "stage-0 step")
    p.add_argument("--sizes", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--width", type=int, default=648)
    p.add_argument("--height", type=int, default=484)
    p.add_argument("--n_gauss", type=int, default=100_000)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    init_distributed()
    rows = scaling_bench(args.sizes, args.width, args.height, args.n_gauss, args.iters)
    if dist.get_rank() == 0:
        for row in rows:
            print(json.dumps(row))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

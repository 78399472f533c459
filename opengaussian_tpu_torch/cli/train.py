"""Training CLI (port of opengaussian_tpu/cli/train.py; reference
train.py:1029-1064), with the same flags.

    python -m opengaussian_tpu_torch.cli.train -s <scene> -m <out> --iterations N

Runs on the GPU through the whole schedule: stage 0 (3DGS pretraining),
stage 1 (SAM instance features), stage 2.1 (the root codebook), stage 2.2
(the leaf codebook) and, when --iterations passes start_leaf_cb_iter, stage
3 after the last iteration, which writes cluster_lang.npz into the output
directory. It saves point_cloud/iteration_N/point_cloud.ply at the save
milestones, which `opengaussian_tpu_torch.cli.render` renders, with the root
and leaf codebooks beside it once their stages have begun. It writes
chkpnt<N>.npz at each of --checkpoint_iterations and resumes from
--start_checkpoint (an .npz of either package or a reference .pth). It
writes the train_process/ PNG dumps unless --disable_intermediate_dumps, and
with --port N serves the SIBR remote viewer on 127.0.0.1:N while it trains.
--enable_multiview_sam_refinement refines the SAM masks across views once,
before the first stage-1 step; --save_memory keeps the views in host memory
and copies one to the device per step; --lazy_load implies --save_memory and
decodes each view from disk when it is used.

--mesh N trains over a mesh of N devices (parallel/mesh.py), one process
per device: start N processes with OPENGS_NUM_PROCESSES=N,
OPENGS_COORDINATOR=host:port (rank 0's) and OPENGS_PROCESS_ID=<rank>
(parallel/distributed.py:init_distributed; NCCL between GPUs, gloo between
CPU processes). A single process with --mesh 1 starts a process group of
one itself. An N larger than the processes raises. Rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from opengaussian_tpu_torch.config import PRESETS, Config, ModelConfig
from opengaussian_tpu_torch.data.dataset import load_scene
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.train.loop import Trainer

OPT_FLAGS = (
    "iterations", "start_ins_feat_iter", "start_root_cb_iter",
    "start_leaf_cb_iter", "root_node_num", "leaf_node_num",
    "pos_weight", "loss_weight", "sam_level", "frozen_init_pts",
    "save_memory", "enable_multiview_sam_refinement",
    "random_background", "leaf_update_fr", "lambda_dssim",
    "percent_dense", "densification_interval",
    "opacity_reset_interval", "densify_from_iter",
    "densify_until_iter", "densify_grad_threshold",
    "position_lr_init", "position_lr_final", "feature_lr",
    "ins_feat_lr", "opacity_lr", "scaling_lr", "rotation_lr",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train OpenGaussian (PyTorch port)")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", default="")
    p.add_argument("--images", default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--preset", default=None, help="config preset, e.g. lerf/teatime")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--start_ins_feat_iter", type=int, default=None)
    p.add_argument("--start_root_cb_iter", type=int, default=None)
    p.add_argument("--start_leaf_cb_iter", type=int, default=None)
    p.add_argument("--root_node_num", type=int, default=None)
    p.add_argument("--leaf_node_num", type=int, default=None)
    p.add_argument("--pos_weight", type=float, default=None)
    p.add_argument("--loss_weight", type=float, default=None)
    p.add_argument("--sam_level", type=int, default=None)
    p.add_argument("--frozen_init_pts", action="store_true", default=None)
    p.add_argument("--save_memory", action="store_true", default=None)
    p.add_argument("--lazy_load", action="store_true",
                   help="decode view pixels/sidecars from disk on access; "
                        "implies --save_memory")
    p.add_argument("--enable_multiview_sam_refinement", action="store_true",
                   default=None)
    p.add_argument("--random_background", action="store_true", default=None)
    p.add_argument("--leaf_update_fr", type=int, default=None)
    p.add_argument("--lambda_dssim", type=float, default=None)
    p.add_argument("--percent_dense", type=float, default=None)
    p.add_argument("--densification_interval", type=int, default=None)
    p.add_argument("--opacity_reset_interval", type=int, default=None)
    p.add_argument("--densify_from_iter", type=int, default=None)
    p.add_argument("--densify_until_iter", type=int, default=None)
    p.add_argument("--densify_grad_threshold", type=float, default=None)
    p.add_argument("--position_lr_init", type=float, default=None)
    p.add_argument("--position_lr_final", type=float, default=None)
    p.add_argument("--feature_lr", type=float, default=None)
    p.add_argument("--ins_feat_lr", type=float, default=None)
    p.add_argument("--opacity_lr", type=float, default=None)
    p.add_argument("--scaling_lr", type=float, default=None)
    p.add_argument("--rotation_lr", type=float, default=None)
    p.add_argument("--test_iterations", nargs="+", type=int, default=[30_000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=None)
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard training over N devices (0 = single device)")
    p.add_argument("--port", type=int, default=0,
                   help="SIBR remote-viewer TCP port (0 = viewer off)")
    p.add_argument("--disable_intermediate_dumps", action="store_true",
                   help="skip the periodic train_process/ PNG dumps")
    return p


def _mesh(n: int, dev):
    """The mesh of --mesh n: the process group from OPENGS_* (or the one
    already up), else a group of this process alone. -> the Mesh, or None
    on a rank outside it."""
    import torch
    import torch.distributed as dist

    from opengaussian_tpu_torch.parallel.distributed import _backend, init_distributed
    from opengaussian_tpu_torch.parallel.mesh import make_mesh

    init_distributed()
    alone = not dist.is_initialized()
    if alone:  # one process: a group of one
        dist.init_process_group(_backend(), store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_backend() != "nccl":
        dev = torch.device("cpu")
    try:
        return make_mesh(n, None if dev.type == "cuda" else dev)
    except ValueError:
        if alone:
            dist.destroy_process_group()
        raise


def main(argv=None, device="cuda", rcfg: RasterizeConfig | None = None) -> Trainer:
    """Parse the flags, train on `device` and save at the milestones. rcfg:
    the rasterizer's settings (default RasterizeConfig(), the stream layout).
    -> the Trainer, whose `losses` and `history` hold the run (None on a rank
    outside the --mesh). Under --mesh the process group stays up, for the
    Trainer's shards."""
    args = build_parser().parse_args(argv)
    cfg = PRESETS.get(args.preset, Config()) if args.preset else Config()
    opt_over = {k: getattr(args, k) for k in OPT_FLAGS if getattr(args, k) is not None}
    if args.lazy_load:  # lazy views need host-resident bundles
        opt_over["save_memory"] = True
    cfg = Config(
        model=ModelConfig(source_path=args.source_path, model_path=args.model_path,
                          images=args.images, resolution=args.resolution,
                          white_background=args.white_background, eval=args.eval),
        opt=dataclasses.replace(cfg.opt, **opt_over),
        pipe=cfg.pipe,
    )
    dev = resolve_device(device)
    out_dir = args.model_path or os.path.join("output", os.path.basename(args.source_path))
    mesh = None
    if args.mesh:
        mesh = _mesh(args.mesh, dev)
        if mesh is None:
            print(f"Outside the {args.mesh}-device mesh: nothing to train", flush=True)
            return None
        print(f"Sharding over {args.mesh} devices: {mesh}", flush=True)

    print(f"Loading scene {args.source_path} ...", flush=True)
    scene = load_scene(args.source_path, args.images, args.white_background, args.eval,
                       args.resolution, lazy=args.lazy_load)
    print(f"{len(scene.train_views)} train / {len(scene.test_views)} test views, "
          f"{len(scene.points)} init points, extent {scene.cameras_extent:.2f}",
          flush=True)
    tr = Trainer(scene, cfg, out_dir, rcfg=rcfg, seed=args.seed, device=dev, mesh=mesh)
    if args.port:
        tr.viewer_port = args.port
    if args.disable_intermediate_dumps:
        tr.save_intermediate = False
    if args.start_checkpoint:
        tr.restore_checkpoint(args.start_checkpoint)
        print(f"Resumed from {args.start_checkpoint} at iteration {tr.iteration}")

    o = cfg.opt
    save_iters = args.save_iterations or [o.start_ins_feat_iter, o.start_root_cb_iter,
                                          o.start_leaf_cb_iter, o.iterations]
    milestones = sorted(set(args.test_iterations) | set(save_iters)
                        | set(args.checkpoint_iterations) | {o.iterations})
    for ms in milestones:
        if ms <= tr.iteration:
            continue
        tr.train(until=min(ms, o.iterations))
        if ms in args.test_iterations:
            m = tr.evaluate()
            print(f"[ITER {tr.iteration}] eval PSNR {m['psnr']:.2f} L1 {m['l1']:.4f}")
        if ms in save_iters:
            print(f"[ITER {tr.iteration}] saving gaussians")
            tr.save()
        if ms in args.checkpoint_iterations:
            tr.save_checkpoint()
        if tr.iteration >= o.iterations:
            break

    if o.iterations > o.start_leaf_cb_iter:
        print("[Stage 3] language feature association ...", flush=True)
        tr.run_stage3()
    print("Training complete.")
    return tr


if __name__ == "__main__":
    import torch.distributed as dist

    main()
    if dist.is_initialized():
        dist.destroy_process_group()

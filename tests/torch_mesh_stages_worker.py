"""One rank of the port's 2-rank mesh-trainer scenarios
(tests/test_torch_mesh_stages.py).

Run as `PYTHONPATH=<repo> python tests/torch_mesh_stages_worker.py RANK WORLD
STORE IN OUT`, one process per rank: it joins a gloo group through the file
store STORE, reads the scenes the test wrote to IN (.npz, made with the JAX
package) and runs, on its shard, the sharded steps of stages 1, 2.1 and 2.2
and the evaluation render, the sharded k-means, sweeps and refiner, and
`cli.train --mesh 2` through stage 3; it writes OUT/rank{RANK}.npz for the
test to hold against the JAX package and the port's single-device trainer.
It imports torch, numpy and the port only (never JAX).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch

CFG = dict(max_per_tile=256, chunk=32, min_intersections=16384)
K1, K2, MAX_MASKS = 2, 3, 8
# the schedule of the trainer runs: every stage boundary, densify events in
# stage 0, the refiner before stage 1, stage 3 and a checkpoint at the end
SCHEDULE = ["--iterations", "16", "--start_ins_feat_iter", "4", "--start_root_cb_iter", "8",
            "--start_leaf_cb_iter", "12", "--densify_from_iter", "1",
            "--densify_until_iter", "4", "--densification_interval", "2",
            "--densify_grad_threshold", "1e-6", "--opacity_reset_interval", "1000",
            "--root_node_num", "4", "--leaf_node_num", "3", "--leaf_update_fr", "2",
            "--sam_level", "3", "--enable_multiview_sam_refinement",
            "--checkpoint_iterations", "16"]
STEP_ITS = {"stage1": 30_001, "stage21": 40_001, "stage22": 50_001}
RESCALE = {"stage1": 0.8, "stage21": 0.7, "stage22": 0.9}


def blob_scene(n=960, seed=5):
    """tests/test_parallel.py:_blob_scene: three feature blobs at three
    places. -> (feat [n, 6], xyz [n, 3], blob of each row [n])."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    feat = np.zeros((n, 6), np.float32)
    per = n // 3
    for b in range(3):
        sl = slice(b * per, (b + 1) * per)
        xyz[sl] = rng.normal(0, 0.05, (per, 3)) + np.array([b * 3.0, 0, 4.0])
        feat[sl] = np.eye(3, 6, dtype=np.float32)[b] * 2.0 + rng.normal(0, 0.03, (per, 6))
    return feat, xyz, np.repeat([0, 1, 2], per)


def leaf_scene(n=512, seed=7):
    """tests/test_parallel.py:test_sharded_kmeans_leaf_...'s scene: root 0
    (the first half) holds two sub-blobs, root 1 one. -> (feat, cls_ids)."""
    rng = np.random.default_rng(seed)
    feat = np.zeros((n, 6), np.float32)
    feat[: n // 4] = np.array([1, 0, 0, 0, 0, 0]) + rng.normal(0, 0.02, (n // 4, 6))
    feat[n // 4: n // 2] = np.array([0, 1, 0, 0, 0, 0]) + rng.normal(0, 0.02, (n // 4, 6))
    feat[n // 2:] = np.array([0, 0, 3, 0, 0, 0]) + rng.normal(0, 0.02, (n // 2, 6))
    return feat.astype(np.float32), np.where(np.arange(n) < n // 2, 0, 1).astype(np.int32)


def root_seeds(feat, xyz):
    """The k-means++ seeds both packages are handed: one row of each blob."""
    return np.concatenate([feat, xyz], 1)[[0, 400, 800]]


def main(rank: int, world: int, store: str, inp: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    from opengaussian_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    data = dict(np.load(inp))
    res: dict = {}
    for scenario in (steps_scenario, kmeans_scenario, sweeps_scenario, refiner_scenario,
                     trainer_scenario):
        t0 = time.perf_counter()
        scenario(mesh, data, res, out)
        print(f"{scenario.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez(f"{out}/rank{rank}.npz", **{
        k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in res.items()})
    dist.destroy_process_group()


def state_of(data: dict, key: str):
    from opengaussian_tpu_torch.models import gaussians as G

    return G.state_from_numpy({k: data[f"{key}/state/{k}"]
                               for k in G.PARAM_FIELDS + ("alive",)}, device="cpu")


def camera_of(data: dict, key: str):
    from opengaussian_tpu_torch.cameras import Camera

    f = lambda x: torch.tensor(data[f"{key}/{x}"], dtype=torch.float32)  # noqa: E731
    return Camera(R_w2c=f("R"), t_w2c=f("t"), fx=f("fx"), fy=f("fy"), cx=f("cx"),
                  cy=f("cy"), width=int(data[f"{key}/width"]),
                  height=int(data[f"{key}/height"]))


def kms_of(data: dict, key: str):
    from opengaussian_tpu_torch.ops import kmeans as km

    return km.kmeans_from_numpy({f: data[f"{key}/{f}"] for f in
                                 ("centers", "cls_ids", "leaf_centers", "leaf_cls_ids",
                                  "leaf_sub_num")}, device="cpu")


def steps_scenario(mesh, data, res, out):
    """Stages 1, 2.1 and 2.2 (a live root and a dead one) and eval_render on
    the two-blob scene, from the fresh state: stream, and dense and compact
    for stage 1 and the live stage 2.2."""
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.parallel.mesh import shard_gaussians
    from opengaussian_tpu_torch.parallel.steps import make_sharded_steps

    state, kms, cam = state_of(data, "steps"), kms_of(data, "steps/kms"), camera_of(data,
                                                                                      "steps/cam")
    adam = opt_mod.init(state.params())
    st, mu, nu, cls, leaf = shard_gaussians(mesh, (state, adam.mu, adam.nu, kms.cls_ids,
                                                   kms.leaf_cls_ids))
    adam = opt_mod.AdamState(mu=mu, nu=nu, count=0)
    kms = dataclasses.replace(kms, cls_ids=cls, leaf_cls_ids=leaf)
    t = lambda k: torch.as_tensor(data[f"steps/{k}"])  # noqa: E731
    sam, alpha, pseudo, bg = t("sam"), t("alpha"), t("pseudo"), torch.zeros(3)
    layouts = {"stream": {}, "dense": dict(pallas_input="dense"),
               "compact": dict(bwd_layout="compact")}
    for lay, extra in layouts.items():
        steps = make_sharded_steps(mesh, RasterizeConfig(**CFG, **extra), OptimizationConfig())
        runs = {"stage1": lambda: steps.stage1(st, adam, cam, sam, alpha, STEP_ITS["stage1"],
                                               bg, RESCALE["stage1"], MAX_MASKS,
                                               has_alpha=torch.tensor(True))}
        if lay != "dense":
            runs["stage22_live"] = lambda: steps.stage22(
                st, adam, kms, cam, pseudo, 0, True, None, STEP_ITS["stage22"], bg,
                RESCALE["stage22"])
        if lay == "stream":
            runs["stage21"] = lambda: steps.stage21(st, adam, kms, cam, pseudo, None,
                                                    STEP_ITS["stage21"], bg,
                                                    RESCALE["stage21"])
            runs["stage22_dead"] = lambda: steps.stage22(
                st, adam, kms, cam, pseudo, 0, False, None, STEP_ITS["stage22"], bg,
                RESCALE["stage22"])
        for name, run in runs.items():
            new, adam2, loss, *rest = run()
            key = f"steps/{lay}/{name}"
            res.update({f"{key}/loss": loss, f"{key}/n_lost": rest[-1],
                        f"{key}/ins_feat": new.ins_feat, f"{key}/mu": adam2.mu["ins_feat"],
                        f"{key}/nu": adam2.nu["ins_feat"],
                        f"{key}/means_same": torch.equal(new.means, st.means)})
            if name.startswith("stage22"):
                res[f"{key}/ok"] = rest[0]
        if lay == "stream":
            img, a, depth = steps.eval_render(st, cam, bg)
            res.update({"steps/eval/image": img, "steps/eval/alpha": a,
                        "steps/eval/depth": depth})


def kmeans_scenario(mesh, data, res, out):
    """assign_root_sharded and assign_leaf_sharded from injected seeds (held
    against the JAX package's with the same seeds) and from the pool's
    k-means++ (held for quality and label alignment)."""
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.parallel import kmeans as pkm
    from opengaussian_tpu_torch.parallel.mesh import shard_gaussians

    feat, xyz, true = blob_scene()
    n = len(feat)
    sh = shard_gaussians(mesh, (torch.as_tensor(feat), torch.as_tensor(xyz),
                                torch.ones(n, dtype=torch.bool)))
    seeds = torch.as_tensor(root_seeds(feat, xyz))
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731, the same on both ranks
    st0 = km.KMeansState.create(n // mesh.size, 3, 2, "cpu")
    a = pkm.assign_root_sharded(mesh, st0, *sh, 1.0, init=True, init_centers=seeds)
    cached = torch.as_tensor(data["kmeans/cached"])
    b = pkm.assign_root_sharded(mesh, dataclasses.replace(st0, centers=cached), *sh, 1.0,
                                init=False, init_centers=seeds)
    c = pkm.assign_root_sharded(mesh, st0, *sh, 1.0, gen(0), init=True)
    d = pkm.assign_root_sharded(mesh, dataclasses.replace(st0, centers=cached), *sh, 1.0,
                                gen(1), init=False)
    for name, s in (("seeded", a), ("reassign", b), ("pool", c), ("pool_reassign", d)):
        res[f"kmeans/root/{name}/centers"] = s.centers
        res[f"kmeans/root/{name}/ids"] = s.cls_ids
    feat, cls = leaf_scene()
    n = len(feat)
    f_sh, alive_sh, cls_sh = shard_gaussians(mesh, (torch.as_tensor(feat),
                                                    torch.ones(n, dtype=torch.bool),
                                                    torch.as_tensor(cls)))
    st = dataclasses.replace(km.KMeansState.create(n // mesh.size, 2, 4, "cpu"),
                             cls_ids=cls_sh, leaf_sub_num=torch.tensor([2, 1],
                                                                       dtype=torch.int32))
    seeds = torch.as_tensor(feat[[0, n // 4 + 1, 2, 3]])
    for name, kw in (("seeded", dict(init_centers=seeds)), ("pool", dict(generator=gen(2)))):
        s = pkm.assign_leaf_sharded(mesh, st, f_sh, alive_sh, 0, 4, init=True, **kw)
        res[f"kmeans/leaf/{name}/centers"] = s.leaf_centers
        res[f"kmeans/leaf/{name}/ids"] = s.leaf_cls_ids


def sweeps_scenario(mesh, data, res, out):
    """sweep1, sweep2 and lang_view on the two-blob scene, the leaf-mode
    pseudo labels through them, and the all-gathers of one lang_view view
    at k1 = 2 and 4."""
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.parallel import mesh as mesh_mod
    from opengaussian_tpu_torch.parallel.mesh import shard_gaussians
    from opengaussian_tpu_torch.parallel.sweeps import make_sweep_fns
    from opengaussian_tpu_torch.train import pseudo as pseudo_mod

    state, kms, cam = state_of(data, "steps"), kms_of(data, "steps/kms"), camera_of(data,
                                                                                      "steps/cam")
    gs, cls, leaf = shard_gaussians(mesh, (state, kms.cls_ids, kms.leaf_cls_ids))
    t = lambda k: torch.as_tensor(data[f"steps/{k}"])  # noqa: E731
    sam, pf, pids, bg = t("sam"), t("pseudo"), t("pseudo_ids"), torch.zeros(3)
    rcfg = RasterizeConfig(**CFG)
    fns = make_sweep_fns(mesh, rcfg, K1, K2, MAX_MASKS)
    f1, m1 = fns.sweep1(gs, cam, sam, bg)
    c2, o2 = fns.sweep2(gs, cam, pf, pids, cls, bg)
    occur = torch.ones(K1, dtype=torch.bool)
    mid, sc, ok = fns.lang_view(gs, leaf, cam, pf, pids, occur, bg)
    pl = pseudo_mod.construct_pseudo_labels(gs, [cam], sam[None], bg, MAX_MASKS, rcfg,
                                            mode="leaf", cls_ids=cls, k1=K1, k2=K2,
                                            sweep_fns=fns)
    res.update({"sweeps/sweep1/feat": f1, "sweeps/sweep1/ids": m1, "sweeps/sweep2/counts": c2,
                "sweeps/sweep2/occur": o2, "sweeps/lang/mid": mid, "sweeps/lang/score": sc,
                "sweeps/lang/ok": ok, "sweeps/pseudo/feat": pl.feat,
                "sweeps/pseudo/mask_ids": pl.mask_ids,
                "sweeps/pseudo/cluster_occur": pl.cluster_occur,
                "sweeps/pseudo/leaf_sub_num": pl.leaf_sub_num})
    real = mesh_mod._ALL_GATHER
    for k1 in (2, 4):
        calls = []

        def counting(out_t, in_t, group=None, **kw):
            calls.append(tuple(in_t.shape))
            return real(out_t, in_t, group=group, **kw)

        mesh_mod._ALL_GATHER = counting
        try:
            make_sweep_fns(mesh, rcfg, k1, K2, MAX_MASKS).lang_view(
                gs, leaf, cam, pf, pids, torch.ones(k1, dtype=torch.bool), bg)
        finally:
            mesh_mod._ALL_GATHER = real
        res[f"sweeps/gathers/k1_{k1}"] = np.asarray([s[0] for s in calls])


def refiner_scenario(mesh, data, res, out):
    """depth_votes and pixel_weights of each view of the two-blob refiner
    scene, and refine_sam_masks through them, with a trace that rank 0
    alone writes."""
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.parallel.mesh import shard_gaussians
    from opengaussian_tpu_torch.parallel.refine import make_refiner_fns
    from opengaussian_tpu_torch.refine.introspect import RefinerTrace
    from opengaussian_tpu_torch.refine.sam_refiner import refine_sam_masks

    cfg = RasterizeConfig(max_per_tile=64, chunk=32)
    st = shard_gaussians(mesh, state_of(data, "refine"))
    cams = [camera_of(data, f"refine/cam{v}") for v in range(2)]
    sam = data["refine/sam"]
    fns = make_refiner_fns(mesh, cfg)
    for v in range(2):
        votes, vis, depth = fns.depth_votes(st, cams[v], torch.as_tensor(sam[v]), 2)
        res.update({f"refine/votes{v}": votes, f"refine/visible{v}": vis,
                    f"refine/depth{v}": depth})
    t = lambda k: torch.as_tensor(data[f"refine/{k}"])  # noqa: E731
    res["refine/weights"] = fns.pixel_weights(st, cams[0], t("gid"), t("contrib"),
                                              t("synced"), t("n_match"), 2)
    trace = RefinerTrace(os.path.join(out, "refine"), emit=mesh.rank == 0)
    res["refine/ids"] = refine_sam_masks(st, cams, sam, cfg, anchor_stride=1, trace=trace,
                                         sharded_fns=fns)


def trainer_scenario(mesh, data, res, out):
    """cli.train --mesh 2 (Trainer(mesh=...)) through stage 3 on the COLMAP
    scene, then its evaluation and a train_process/ dump, and the
    checkpoint restored into a second mesh trainer; --mesh 3 on two ranks."""
    from opengaussian_tpu_torch.cli import train as cli_train
    from opengaussian_tpu_torch.config import Config, ModelConfig
    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.train import observe
    from opengaussian_tpu_torch.train.loop import Trainer

    scene = str(data["scene"])
    model = os.path.join(out, "cli_mesh")
    tr = cli_train.main(["-s", scene, "-m", model, *SCHEDULE, "--mesh", "2"], device="cpu")
    res["trainer/losses"] = torch.stack(tr.losses)
    res["trainer/alive"] = np.asarray([h["num_alive"] for h in tr.history])
    res["trainer/its"] = np.asarray([h["iteration"] for h in tr.history])
    res["trainer/sam_ids"] = tr.bundle.sam_ids
    res["trainer/psnr"] = tr.evaluate()["psnr"]
    observe.dump_intermediate(tr, tr.iteration, "2.2", 0)
    whole = tr._whole((tr.state, tr.kms.cls_ids, tr.kms.leaf_cls_ids))
    res.update({"trainer/capacity": tr.state.capacity, "trainer/ins_feat": whole[0].ins_feat,
                "trainer/cls_ids": whole[1], "trainer/leaf_ids": whole[2]})
    again = Trainer(load_scene(scene), Config(model=ModelConfig(), opt=tr.cfg.opt),
                    os.path.join(out, "restored"), seed=0, mesh=mesh)
    again.restore_checkpoint(os.path.join(model, "chkpnt16.npz"))
    back = again._whole((again.state, again.adam.mu, again.stats, again.kms.cls_ids))
    ref = tr._whole((tr.state, tr.adam.mu, tr.stats, tr.kms.cls_ids))
    same = [torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(ref))]
    res["trainer/restored_equal"] = all(same) and again.iteration == 16
    try:
        cli_train.main(["-s", scene, "-m", os.path.join(out, "mesh3"), *SCHEDULE, "--mesh",
                        "3"], device="cpu")
        res["trainer/mesh3"] = "ran"
    except ValueError as e:
        res["trainer/mesh3"] = str(e)


def _leaves(tree) -> list:
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            out.extend(x[k] for k in sorted(x))
        else:
            out.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])

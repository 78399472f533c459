"""The long-run regime: 200 stage-0 steps of the port's Trainer against the
JAX package's, on the quality scene at 160x120 (tools/synthetic.py,
QUALITY_FAST), from the same draws. The parity tests elsewhere hold single
steps or blocks of at most 40; this one holds a run through densification,
a capacity growth and the per-step numerics that add up over it (K3's sum
order, Adam's division, the split children).

The draws: the view order and the random backgrounds come from each
trainer's numpy generator with the same seed; densification's split noise
is injected into both, through the port's `densify_and_prune(noise=)` and
in place of the JAX package's `jax.random.normal`, one numpy draw per
densification. Densification comes after every 50th step; both packages'
capacity multiple is cut from 4,096 to 512, so the 300 initial points (a
capacity of 512) overflow it at the second densification and the third
doubles it to 1,024. Both run the stream as a user runs it here: no tile
windows, no frozen plan, budgets large enough that no slot is dropped or
truncated (the port sizes its stream per frame; the JAX trainer keeps 8
slots per splat, at least 65,536, and 512 per tile). The GT images are on
black, so the random backgrounds first cost PSNR while splats learn to
cover them; the comparison is of the two curves, not of their level.

At every 50-step mark the held-out PSNR agrees within 0.2 dB, the L1
within 2% and the alive count within 1%. Observed on the CPU: PSNR within
3e-4 dB, L1 within 5e-6 relative and equal alive counts (408, 512, 641,
818) and capacities. The JAX trainer runs in a thread beside the port's,
which keeps the module at ~110 s.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu_torch.config import Config, OptimizationConfig
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.tools import synthetic
from opengaussian_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

STEPS, EVERY = 200, 50
OPT = dict(iterations=STEPS, start_ins_feat_iter=10 ** 6, start_root_cb_iter=10 ** 6 + 1,
           start_leaf_cb_iter=10 ** 6 + 2, densify_from_iter=0, densify_until_iter=10 ** 6,
           densification_interval=EVERY, opacity_reset_interval=10 ** 6,
           densify_grad_threshold=0.0004, random_background=True)
CAPACITY_MULTIPLE = 512


def split_noise(event: int, cap: int) -> np.ndarray:
    """The standard-normal draws of the split children at densification
    `event` (1, 2, ...): [2, cap, 3] float32."""
    return np.random.default_rng(1000 + event).standard_normal((2, cap, 3)).astype(np.float32)


def jax_scene(scene):
    """The same views and initial cloud as the JAX package's Scene."""
    def view(v):
        c = v.camera
        cam = JCamera.from_fov(c.R_w2c.numpy(), c.t_w2c.numpy(), synthetic.FOVX,
                               synthetic.FOVY, c.width, c.height)
        return jdataset.View(camera=cam, image_name=v.image_name, gt_image=v.gt_image,
                             sam_mask=v.sam_mask, clip_feats=v.clip_feats)

    return jdataset.Scene(train_views=[view(v) for v in scene.train_views],
                          test_views=[view(v) for v in scene.test_views],
                          points=scene.points, colors=scene.colors,
                          cameras_extent=scene.cameras_extent, source_path=scene.source_path)


def curve(tr, lost) -> list[dict]:
    """Train to STEPS, evaluating after every EVERY steps."""
    out = []
    for k in range(EVERY, STEPS + 1, EVERY):
        tr.train(until=k, log_every=EVERY)
        m = tr.evaluate()
        out.append(dict(iteration=k, psnr=m["psnr"], l1=m["l1"],
                        alive=int(tr.state.num_alive), capacity=int(tr.state.capacity),
                        lost=lost(tr)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("longrun")
    mp = pytest.MonkeyPatch()
    for mod in (TG, JG):
        mp.setattr(mod, "round_capacity",
                   lambda n, multiple=CAPACITY_MULTIPLE, _f=mod.round_capacity: _f(n, multiple))
    events = {"port": 0, "jax": 0}
    t_densify, j_densify, real_normal = TG.densify_and_prune, JG.densify_and_prune, \
        jax.random.normal

    def port_densify(state, *a, generator=None, **kw):
        events["port"] += 1
        noise = torch.from_numpy(split_noise(events["port"], state.capacity))
        return t_densify(state, *a, noise=noise, **kw)

    def jax_densify(state, moments, stats, key, *a):
        events["jax"] += 1
        noise = jnp.asarray(split_noise(events["jax"], state.capacity))
        jax.random.normal = lambda *_a, **_k: noise  # the one draw of this call
        try:
            return j_densify(state, moments, stats, key, *a)
        finally:
            jax.random.normal = real_normal

    mp.setattr(TG, "densify_and_prune", port_densify)
    mp.setattr(JG, "densify_and_prune", jax_densify)
    q = synthetic.quality_scene(synthetic.QUALITY_FAST, "cpu")
    jtr = jloop.Trainer(jax_scene(q.scene), JConfig(opt=JOpt(**OPT)), str(tmp / "jax"),
                        rcfg=JRaster(max_per_tile=512, chunk=64), autotune_budgets=False)
    jtr.save_intermediate = False
    jtr.use_frozen_plans = False
    ttr = tloop.Trainer(q.scene, Config(opt=OptimizationConfig(**OPT)), str(tmp / "port"),
                        rcfg=q.rcfg, device="cpu", autotune_budgets=False)
    ttr.use_frozen_plans = False  # the JAX trainer's opt-out, as above
    ttr.save_intermediate = False
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(curve, jtr, lambda t: int(t._last_lost))
            port = curve(ttr, lambda t: t.counters["dropped"] + t.counters["truncated"])
            jax_curve = fut.result(timeout=600)
    finally:
        mp.undo()
    return dict(port=port, jax=jax_curve, events=dict(events))


def test_long_run_psnr_matches_jax(runs):
    """Held-out PSNR within 0.2 dB at every 50-step mark."""
    for p, j in zip(runs["port"], runs["jax"]):
        assert abs(p["psnr"] - j["psnr"]) <= 0.2, (p, j)
        assert np.isfinite(p["psnr"])


def test_long_run_l1_matches_jax(runs):
    """Held-out L1 within 2% at every 50-step mark."""
    for p, j in zip(runs["port"], runs["jax"]):
        assert abs(p["l1"] - j["l1"]) <= 0.02 * j["l1"], (p, j)


def test_long_run_alive_and_capacity_match_jax(runs):
    """The alive count within 1% at every mark, and the same capacity."""
    for p, j in zip(runs["port"], runs["jax"]):
        assert abs(p["alive"] - j["alive"]) <= 0.01 * j["alive"], (p, j)
        assert p["capacity"] == j["capacity"], (p, j)


def test_long_run_densifies_and_grows(runs):
    """The run is the regime it claims: 200 steps, a densification after
    each 50th (4, each drawing its noise), at least two of which add
    splats, and a capacity growth, in both packages; no slot lost."""
    port, jx = runs["port"], runs["jax"]
    assert [p["iteration"] for p in port] == list(range(EVERY, STEPS + 1, EVERY))
    assert runs["events"] == {"port": STEPS // EVERY, "jax": STEPS // EVERY}
    alive = [300] + [p["alive"] for p in port]
    assert sum(b > a for a, b in zip(alive, alive[1:])) >= 2, alive
    for c in (port, jx):
        assert c[0]["capacity"] == CAPACITY_MULTIPLE and c[-1]["capacity"] > c[0]["capacity"]
        assert all(p["lost"] == 0 for p in c), c

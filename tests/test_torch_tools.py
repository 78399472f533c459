"""The port's measuring tools (opengaussian_tpu_torch/tools/) against the JAX
repo's bench.py and tools/*.py on the CPU.

- The scenes equal the JAX tools' bit for bit: bench's workload (both
  scales, with the same tuned P and K), stage_bench's scene and view bundle,
  and refine_bench's scene (the JAX tool run with its refiner stubbed, so
  that it hands over what it built).
- One step of the bench's workload matches the JAX one (XLA, no tile
  windows): the image to the repo's 3e-5 + 1e-4 relative, the gradients to
  1e-3 normalised.
- stage_bench's recipe projection on fixed times against minutes worked by
  hand; trace_step's phase_of on the port's kernel names; the stage-2.2
  step through a frozen plan against the fresh one.
- Each tool's main at small sizes prints, as its last line, JSON with every
  key of the JAX tool's (listed here from its source) and finite figures;
  each raises without a GPU unless device="cpu" is passed.

The JAX modules are loaded from their files, and their size globals (and
the port's) are set by monkeypatch in this process; no JAX file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.render import render as jrender
from opengaussian_tpu_torch.config import OptimizationConfig
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, build_frozen_plan
from opengaussian_tpu_torch.render import render
from opengaussian_tpu_torch.tools import (
    ab_reduce,
    bench,
    mem_lazy,
    phase_bench,
    refine_bench,
    stage_bench,
    trace_step,
)
from opengaussian_tpu_torch.train import loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "logit_opacity", "ins_feat",
         "alive")
TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(path: str):
    """A JAX repo module loaded from its file (bench.py, tools/*.py)."""
    name = "jax_" + path.replace("/", "_").removesuffix(".py")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def assert_same_state(jst, tst):
    for f in STATE:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def normalised(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) / (float(np.abs(want[k]).max()) or 1.0)
               for k in want)


@pytest.fixture
def small_bench(monkeypatch):
    jb = jax_tool("bench.py")
    for mod in (jb, bench):
        monkeypatch.setattr(mod, "WIDTH", 160)
        monkeypatch.setattr(mod, "HEIGHT", 120)
        monkeypatch.setattr(mod, "N_GAUSS", 4000)
    return jb


@pytest.mark.parametrize("scale", [0.088, 0.15])
def test_bench_workload_matches_jax(small_bench, scale):
    """bench.make_workload's state and GT image bit for bit, and the same
    tuned P and K (bench.py:61-163)."""
    js, _jcam, jcfg, jgt, _jbg, _ = small_bench.make_workload(scale, backend="xla")
    ts, _tcam, tcfg, tgt, _tbg, _ = bench.make_workload(scale, device="cpu")
    assert_same_state(js, ts)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jgt))
    assert tcfg.max_intersections(4000) == jcfg.max_intersections(4000)
    assert tcfg.max_per_tile == jcfg.max_per_tile


def test_bench_step_matches_jax(small_bench):
    """One forward+backward of the calibrated workload against the JAX
    bench's (backend "xla", tile_windows 0): image and loss to the repo's
    tolerance, every gradient to 1e-3 normalised."""
    js, jcam, jcfg, jgt, jbg, jmk = small_bench.make_workload(0.088, backend="xla")
    ts, tcam, tcfg, tgt, tbg, tmk = bench.make_workload(0.088, device="cpu")
    jcfg = dataclasses.replace(jcfg, tile_windows=0)
    jl, jg = jmk(jcfg)(js)
    tl, tg = tmk(tcfg)(ts)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert normalised({k: v.numpy() for k, v in tg.items()},
                      {k: np.asarray(v) for k, v in jg.items()}) < 1e-3
    with torch.no_grad():
        img = render(tcam, ts, tbg, 3, tcfg).render.numpy()
    np.testing.assert_allclose(img, np.asarray(jrender(jcam, js, jbg, 3, jcfg).render), **TOL)


def test_stage_bench_scene_matches_jax(monkeypatch):
    """stage_bench's scene, codebook and view bundle at the smoke size, bit
    for bit (tools/stage_bench.py:52-166)."""
    js = jax_tool("tools/stage_bench.py")
    n, w, h = stage_bench.SMOKE
    monkeypatch.setattr(js, "N_GAUSS", n)
    monkeypatch.setattr(js, "WIDTH", w)
    monkeypatch.setattr(js, "HEIGHT", h)
    jst, jkms, _jcam, jrng = js.build_scene()
    tst, tkms, _tcam, trng = stage_bench.build_scene(device="cpu", n=n, width=w, height=h)
    assert_same_state(jst, tst)
    for f in ("centers", "cls_ids", "leaf_centers", "leaf_cls_ids", "leaf_sub_num"):
        a, b = np.asarray(getattr(jkms, f)), getattr(tkms, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    jb, tb = js.build_bundle(jrng), stage_bench.build_bundle(trng, "cpu", w, h)
    for f in ("R", "t", "fx", "fy", "cx", "cy", "gt_images", "alpha_masks", "has_alpha",
              "sam_ids"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (tb.width, tb.height, tb.max_masks) == (jb.width, jb.height, jb.max_masks)


def test_recipe_projection_by_hand():
    """Stages 1, 2.1 and 2.2 of 20k steps, sweeps over 100 views; the frozen
    steps count (the plan lost nothing), stage 2.2 at the faster of its
    two. By hand: stage 1 20k x 10 ms = 3.333 min; 2.1 20k x (8 + 50/200)
    = 2.75; 2.2 20k x (5 + 4/50) = 1.693; sweeps (2 x 30 + 120) x 100 =
    0.3 min; stage 3 (30 + 300) x 100 = 0.55; total 8.627, vs 20: 2.318."""
    res = dict(stage1_step_ms=12.0, stage21_step_ms=9.0, stage22_step_ms=5.0,
               frozen_plan_lost=0, stage1_frozen_ms=10.0, stage21_frozen_ms=8.0,
               stage22_frozen_ms=6.0, assign_root_ms=50.0, assign_leaf_ms=4.0,
               sweep1_view_ms=30.0, sweep2_view_ms=120.0, lang_view_ms=300.0)
    got = stage_bench.recipe_projection(res, 100)
    assert got == dict(recipe_views_assumed=100, recipe_stage1_min=3.33,
                       recipe_stage21_min=2.75, recipe_stage22_min=1.69,
                       recipe_sweeps_min=0.3, recipe_stage3_min=0.55, recipe_total_min=8.63,
                       anchor_total_min=20.0, vs_anchor=2.318)
    # a plan that lost slots: the fresh steps count
    lossy = stage_bench.recipe_projection(dict(res, frozen_plan_lost=3), 100)
    assert lossy["recipe_stage1_min"] == 4.0 and lossy["recipe_stage22_min"] == 1.69


def test_refine_scene_matches_jax(monkeypatch):
    """refine_bench.refine_scene against the scene tools/refine_bench.py
    builds (its refiner stubbed to capture it), at 2,000 splats and 3 views:
    the state bit for bit, the cameras and the SAM ids equal."""
    from opengaussian_tpu.refine import sam_refiner as jsr

    jr = jax_tool("tools/refine_bench.py")
    seen = {}

    def capture(gs, cams, sam_ids, rcfg, anchor_stride, timings):
        seen.update(gs=gs, cams=cams, sam=sam_ids, rcfg=rcfg, stride=anchor_stride)
        return np.zeros(sam_ids.shape, np.int32)

    monkeypatch.setattr(jsr, "refine_sam_masks", capture)
    monkeypatch.setattr(sys, "argv", ["refine_bench.py", "--splats", "2000", "--views", "3"])
    jr.main()
    gs, cams, sam = refine_bench.refine_scene(2000, 3, 32, "cpu")
    assert_same_state(seen["gs"], gs)
    np.testing.assert_array_equal(sam, seen["sam"])
    assert sam.dtype == seen["sam"].dtype
    for jc, tc in zip(seen["cams"], cams, strict=True):
        for f in ("R_w2c", "t_w2c", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    assert (seen["rcfg"].max_per_tile, seen["rcfg"].chunk, seen["stride"]) == (512, 64, 1000)


@pytest.mark.parametrize("name, phase", [
    ("void (anonymous namespace)::blend_stream_fwd_kernel<8>(float const*, int)",
     "K1/K5 forward blend"),
    ("void (anonymous namespace)::blend_tiles_fwd_groups_kernel<8>(float const*)",
     "K1/K5 forward blend"),
    ("void (anonymous namespace)::blend_stream_bwd_kernel<8>(float const*)", "K2/K4/K6 replay"),
    ("void (anonymous namespace)::blend_stream_bwd_compact_kernel<8>(float const*)",
     "K2/K4/K6 replay"),
    ("void (anonymous namespace)::blend_tiles_bwd_kernel<8>(float const*)", "K2/K4/K6 replay"),
    ("segment_reduce_perm(float const*, int const*, int const*, int, int)",
     "K3 per-splat reduce"),
    ("segment_reduce_vec(float const*, int const*, float*, int, int)", "K3 per-splat reduce"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>", "sort"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)",
     "projection and binning"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<...>",
     "projection and binning"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw", "SSIM and loss"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1",
     "cuBLAS products (projection, SH, SSIM)"),
    ("void gemv2N_kernel<int, int, float, float, float, float, 128, 2, 4, 4>",
     "cuBLAS products (projection, SH, SSIM)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "other"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::"
     "TensorIteratorBase&)::{lambda()#3}, at::native::memory::LoadWithCast<1>, "
     "at::native::memory::StoreWithCast<1>>  (a dtype conversion)", "other"),
    ("at::native::conv_depthwise2d_forward_kernel<float>", "SSIM and loss"),
    ("aten::conv2d", "SSIM and loss"),
    ("aten::sort", "sort"),
    ("aten::index", "projection and binning"),
])
def test_phase_of(name, phase):
    assert trace_step.phase_of(name) == phase


def test_stage22_frozen_step_equals_fresh():
    """stage_bench's stage22_frozen_ms path: the stage-2.2 step through the
    view's frozen plan (the root as a masked-opacity blend over the plan's
    stream, the JAX package's _stage22_body(frozen=)) gives the fresh
    step's loss, occurrence and parameters."""
    st, kms, cam, rng = stage_bench.build_scene(device="cpu", n=2000, width=64, height=48)
    bundle = stage_bench.build_bundle(rng, "cpu", 64, 48)
    rcfg = budget.tuned_config(RasterizeConfig(max_per_tile=1024, chunk=64), st, [cam],
                               headroom=1.3)
    pf = torch.as_tensor(rng.uniform(0, 1, (48, 64, 6)).astype(np.float32))
    root = int(np.bincount(kms.cls_ids.numpy()).argmax())
    plan = build_frozen_plan(cam, st.means, build_cov3d(st.scales, st.quats), st.opacity, rcfg)
    assert int(plan.n_dropped) + int(plan.n_truncated) == 0
    o = OptimizationConfig(root_node_num=stage_bench.K1, leaf_node_num=stage_bench.K2)
    args = (st, opt_mod.init(st.params()), kms, bundle, 0, 71_000, torch.zeros(3), 1.0, pf,
            root, True, rcfg, o)
    fresh = tloop.stage22_step(*args)
    frozen = tloop.stage22_step(*args, False, plan)
    assert bool(fresh[3]) and bool(frozen[3])
    np.testing.assert_allclose(float(frozen[2]), float(fresh[2]), rtol=1e-6)
    for k, v in fresh[0].params().items():
        np.testing.assert_allclose(frozen[0].params()[k].numpy(), v.numpy(), atol=1e-7)


def test_hold_against_plain_raises_past_its_bar():
    """The pre-timing check: an output off the CPU's run by more than its
    bar raises, naming it; within the bar it returns the largest error."""
    calls = []

    def run(dev):
        calls.append(dev)
        bump = 1e-2 if len(calls) == 1 else 0.0  # the first run stands for the card's
        return {"image": torch.ones(4) + bump, "d_x": torch.full((3,), 2.0)}

    with pytest.raises(AssertionError, match="image off its plain version"):
        bench.hold_against_plain("t", run, "cpu", 1e-3)
    calls.clear()
    assert bench.hold_against_plain("t", run, "cpu", 1e-3, {"image": 2e-2}) == \
        pytest.approx(1e-2)


@pytest.mark.parametrize("group_mode", ["auto", "dense"])
def test_stage_bench_kernel_check(monkeypatch, group_mode):
    """stage_bench's pre-timing check runs every render it holds (stage 0,
    stage 2.1, the cluster render over several roots, the two through a
    frozen plan) in both group modes; on the CPU both sides are plain and
    agree."""
    monkeypatch.setattr(stage_bench, "SMOKE", (1000, 64, 48))
    seen = {}
    hold = bench.hold_against_plain

    def spy(what, run, device, tol, tols=None):
        seen.update(run(torch.device("cpu")))
        return hold(what, run, device, tol, tols)

    monkeypatch.setattr(bench, "hold_against_plain", spy)
    assert stage_bench.check_kernels(group_mode, 0.088, 0.6, "cpu") < bench.GRAD_TOL
    assert {"stage 0 image", "stage 0 d_means", "stage 2.1 d_ins_feat",
            "stage 2.2 clusters", "stage 2.2 frozen d_ins_feat"} <= set(seen)
    assert seen["stage 2.2 clusters"].shape[0] == stage_bench.CHECK_ROOTS
    assert float(seen["stage 2.2 d_ins_feat"].abs().max()) > 0


def test_phase_bench_bisect_is_the_binning(small_bench):
    """phase_bench's staged prefixes run ops/binning.py's own stages: the
    last prefix's clamped counts equal bin_gaussians' counts."""
    state, cam, rcfg, *_ = bench.make_workload(0.088, device="cpu")
    got = {}

    def record(name, fn, table):
        got[name] = fn(0)
        table[name] = 0.0

    phase_bench.bisect_table(state, cam, rcfg, record)
    counts_sum, _ = got["proj+full bin"]
    assert int(got["proj+edges"]) == int(counts_sum) > 0


# every key of the JAX tool's JSON, from its source, and the port's additions
JAX_KEYS = {
    # bench.py:483-504
    "bench": ("metric", "value", "unit", "vs_baseline", "headline_regime", "heavy_mpix_s",
              "heavy_vs_baseline", "training_regime_mpix_s", "training_regime_vs_baseline",
              "training_regime_heavy_mpix_s", "training_regime_heavy_vs_baseline",
              "device", "default_mpix_s"),
    # tools/stage_bench.py:226-406 (res[...] and the recipe keys)
    "stage_bench": ("stage0_step_ms", "stage1_step_ms", "stage21_step_ms", "stage22_step_ms",
                    "frozen_plan_build_ms", "frozen_plan_lost", "stage1_frozen_ms",
                    "stage21_frozen_ms", "stage22_frozen_ms", "assign_root_ms",
                    "assign_leaf_ms", "sweep1_view_ms", "sweep2_view_ms", "lang_view_ms",
                    "recipe_views_assumed", "recipe_stage1_min", "recipe_stage21_min",
                    "recipe_stage22_min", "recipe_sweeps_min", "recipe_stage3_min",
                    "recipe_total_min", "anchor_total_min", "vs_anchor", "group_mode",
                    "device"),
    # tools/ab_reduce.py:140-148 (the --out payload)
    "ab_reduce": ("methodology", "iters_per_sample", "table", "device"),
    # tools/refine_bench.py:110-121 and the refiner's phases
    "refine_bench": ("workload", "refined_ids", "void_frac", "device_total_s", "host_total_s",
                     "total_s", "host_frac", "device_votes_s", "device_expand_s",
                     "host_stage1_merge_s", "host_dominant_s", "host_majority_s",
                     "host_expand_prep_s", "device"),
    # tools/mem_lazy.py:121-122
    "mem_lazy": ("views", "eager_mb", "lazy_mb", "device"),
    # tools/trace_step.py prints these as text (total device time, the phase
    # table, the top ops); the port's JSON carries them
    "trace_step": ("device_ms_per_step", "busy_ms", "wall_ms", "idle_share", "phases", "top",
                   "device"),
    # tools/phase_bench.py, bin_bisect.py and micro_bench.py print tables
    "phase_bench": ("prefixes", "bisect", "micro", "fwd_bwd_mpix_s", "device"),
}
TOOLS = {"bench": (bench, ["--iters", "1"]), "stage_bench": (stage_bench, ["--smoke"]),
         "ab_reduce": (ab_reduce, ["--iters", "1", "--reps", "1"]),
         "refine_bench": (refine_bench, ["--splats", "2000", "--views", "3"]),
         "mem_lazy": (mem_lazy, ["--views", "3"]),
         "trace_step": (trace_step, ["--iters", "1", "--top", "5"]),
         "phase_bench": (phase_bench, ["--iters", "1", "--p", "4096", "--n", "1000"])}


def finite(x) -> bool:
    if isinstance(x, dict):
        return all(finite(v) for v in x.values())
    if isinstance(x, list):
        return all(finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


@pytest.fixture
def small_tools(monkeypatch):
    """The tools at sizes the CPU runs in seconds."""
    monkeypatch.setattr(bench, "WIDTH", 64)
    monkeypatch.setattr(bench, "HEIGHT", 48)
    monkeypatch.setattr(bench, "N_GAUSS", 1000)
    monkeypatch.setattr(bench, "CHECK_W", 64)
    monkeypatch.setattr(bench, "CHECK_H", 48)
    monkeypatch.setattr(bench, "CHECK_SPLATS", 500)
    monkeypatch.setattr(bench, "SCAN_K", 2)
    monkeypatch.setattr(stage_bench, "SMOKE", (1000, 64, 48))
    monkeypatch.setattr(refine_bench, "WIDTH", 64)
    monkeypatch.setattr(refine_bench, "HEIGHT", 48)
    monkeypatch.setattr(refine_bench, "CHECK_SPLATS", 500)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_main_prints_the_jax_keys(tool, small_tools, capsys):
    mod, argv = TOOLS[tool]
    ret = mod.main(argv, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == json.loads(json.dumps(ret))
    missing = set(JAX_KEYS[tool]) - set(out)
    assert not missing, missing
    assert out["device"] == "cpu" and finite(out)
    if tool == "ab_reduce":
        assert set(out["table"]) == {f"{w}/{r}/{lay}" for w in ("calibrated", "heavy")
                                     for r, lay in ab_reduce.VARIANTS}
        for row in out["table"].values():
            assert set(row) == {"ms_per_step_median", "ms_per_step_samples", "mpix_s"}
    if tool == "phase_bench":  # tools/phase_bench.py:164-171's rows
        assert list(out["prefixes"]) == ["null", "proj", "proj+bin", "fwd(kernel)",
                                         "fwd(+loss)", "fwd+bwd"]
    if tool == "bench":
        assert out["metric"] == "fwd_bwd_mpix_per_s_1296x968_200k_gauss"
    if tool == "stage_bench":  # --smoke sizes the run, not the module
        assert (stage_bench.N_GAUSS, stage_bench.WIDTH, stage_bench.HEIGHT) == \
            (200_000, 648, 484)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_a_gpu_unless_asked_for_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[tool][0].main([])

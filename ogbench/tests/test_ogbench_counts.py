"""The frozen count and bound arithmetic against the program's own
(`rasterize_kernels.blend_stream_fwd_plain(count_work=True)` and
`tools/timing.py`), on a small scene."""

import pytest
import torch

from ogbench import counts, reference, run, scene
from ogbench.tests.conftest import SMALL


def _state_and_view(seed=5):
    cell = run.load_cell("lerf-teatime.s0-train")
    sc = dict(cell["config"]["scene"], **SMALL)
    gen = torch.Generator().manual_seed(seed)
    sp = scene.make_splats(sc, gen, "cpu")
    cam = scene.make_cameras(sc)[1]
    return sp, cam


def test_peaks_equal_the_tools():
    from opengaussian_tpu_torch.tools import timing

    assert counts.PEAKS == timing.PEAKS
    assert counts.peaks("NVIDIA H100 80GB HBM3") == timing.peaks("NVIDIA H100 80GB HBM3")
    for name in ("OPS_EVALUATED", "OPS_TESTED", "OPS_CULL", "OPS_BOX"):
        assert getattr(counts, name) == getattr(timing, name)


@pytest.mark.parametrize("seed", [5, 6])
def test_frame_work_equals_the_programs_count(seed):
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.models.gaussians import GaussianState
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import (RasterizeConfig, _blend_inputs,
                                                      _prepare, gather_rows)

    sp, c = _state_and_view(seed)
    gs = GaussianState(**sp)
    cam = Camera(R_w2c=torch.as_tensor(c["R"]), t_w2c=torch.as_tensor(c["t"]),
                 fx=torch.tensor(c["fx"]), fy=torch.tensor(c["fy"]),
                 cx=torch.tensor(c["cx"]), cy=torch.tensor(c["cy"]),
                 width=c["width"], height=c["height"])
    proj, bins, grids = _prepare(cam, gs.means, build_cov3d(gs.scales, gs.quats),
                                 gs.opacity, RasterizeConfig())
    opac, full = _blend_inputs(proj, gs.opacity, torch.rand(gs.capacity, 3))
    rows = gather_rows(proj.mean2d, proj.conic, opac, full, bins.sorted_gauss)
    toff = torch.arange(bins.counts.shape[0], dtype=torch.int32)
    _, _, want = rk.blend_stream_fwd_plain(rows, bins.counts, bins.tile_start, toff,
                                           grids[0], counts.CHUNK, count_work=True)

    ref_cam = dict(R=torch.as_tensor(c["R"]), t=torch.as_tensor(c["t"]),
                   fx=torch.tensor(c["fx"]), fy=torch.tensor(c["fy"]),
                   width=c["width"], height=c["height"])
    opacity = torch.where(sp["alive"], torch.sigmoid(sp["logit_opacity"]), 0.0)
    got = counts.frame_work(reference.project(
        reference.Arith(), ref_cam, sp["means"],
        reference.covariance(sp["log_scales"], sp["quats"]), opacity))
    assert got["live"] == int(bins.counts.sum())
    for k, w in want.items():
        assert got[k] == w, k


def test_bounds_equal_the_tools():
    from opengaussian_tpu_torch.tools import timing

    work = dict(live=123_456, tiles=2852, evaluated=9_000_000, in_box=4_000_000,
                tested=2_000_000, blended=1_500_000, boxes=200_000, box_tests=1_600_000)
    pf, pb = counts.peaks("NVIDIA H100 80GB HBM3")
    for C in (4, 7):
        want_f, _ = timing.fwd_bound("k1", work["live"], 6 + C, work["tiles"], 3, work, pf, pb)
        want_b, _ = timing.bwd_bound("k2", work["live"], 6 + C, work["tiles"], 3, work, pf, pb)
        got_f = counts.bound_s(*counts.fwd_cost(work, C), pf, pb) * 1e3
        got_b = counts.bound_s(*counts.bwd_cost(work, C), pf, pb) * 1e3
        assert got_f == pytest.approx(want_f, rel=1e-12)
        assert got_b == pytest.approx(want_b, rel=1e-12)

"""The port's spans and slot counters (utils/trace.py, train/loop.py).

  * `span` is the shared no-op context, and records nothing, where no
    profiler records;
  * `device_ops` puts a backward operation to the span of its forward
    operation through the autograd node's sequence number;
  * a stage-0 and a stage-1 `Trainer.train` step under a CPU profiler open
    each of their spans once a step, and the span table places their
    backward operations under `geometry` and `loss`;
  * `Trainer.counters` holds the sums of the binnings' own counts, eager and
    in blocks alike, and `tools.quality_run.slots_lost` reads them;
  * the log boundary's iter_time is the wall time per step since the
    previous log, and its TensorBoard scalars include the slot counters.
"""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opengaussian_tpu_torch.config import Config, OptimizationConfig
from opengaussian_tpu_torch.data import dataset
from opengaussian_tpu_torch.ops import rasterize
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.tools import quality_run
from opengaussian_tpu_torch.train import loop
from opengaussian_tpu_torch.utils import trace
from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

STAGE_OPT = dict(iterations=8, start_ins_feat_iter=3, start_root_cb_iter=100,
                 start_leaf_cb_iter=200, densify_until_iter=0, sam_level=3,
                 save_memory=True)


def trainer(tmp_path, opt=None, rcfg=None, **kw):
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    tr = loop.Trainer(dataset.load_scene(root),
                      Config(opt=OptimizationConfig(**(opt or STAGE_OPT))),
                      str(tmp_path / "out"), rcfg=rcfg or RasterizeConfig(chunk=32),
                      device="cpu", **kw)
    tr.save_intermediate = False
    tr.tb = None
    return tr


def host_spans(prof) -> list:
    return [e for e in prof.events() if e.name in trace.SPANS]


def within(e, outer) -> bool:
    return outer.time_range.start <= e.time_range.start <= outer.time_range.end


def test_span_is_a_shared_no_op_without_a_profiler():
    off = trace.span(trace.STEP)
    assert off is trace.span(trace.BLEND)
    with off:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).sin()
    assert host_spans(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = trace.span(trace.GEOMETRY)
        assert on is not off
        with on:
            torch.ones(4).sin()
    assert [e.name for e in host_spans(prof)] == [trace.GEOMETRY]


def test_device_ops_follow_the_sequence_link():
    """On the CPU the engine runs the backward inside the caller's
    `backward` span; the node's sequence number puts sin's backward (a cos
    and a mul) under `geometry`, and cos's (a sin, a neg, a mul) under
    `loss`. Whatever a node with no forward operation launches stays under
    `backward`."""
    x = torch.randn(64, requires_grad=True)

    def step():
        with trace.span(trace.STEP):
            with trace.span(trace.GEOMETRY):
                y = x.sin()
            with trace.span(trace.LOSS):
                z = y.cos().sum()
            with trace.span(trace.BACKWARD):
                (g,) = torch.autograd.grad(z, [x])
        return g

    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    bwd = next(e for e in prof.events() if e.name == trace.BACKWARD)
    during = Counter((op.span, op.name) for op in trace.device_ops(prof)
                     if bwd.time_range.start <= op.launched_at <= bwd.time_range.end)
    assert during[(trace.GEOMETRY, "aten::cos")] == 1
    assert during[(trace.LOSS, "aten::sin")] == 1
    assert during[(trace.LOSS, "aten::neg")] == 1
    before = Counter((op.span, op.name) for op in trace.device_ops(prof)
                     if op.launched_at < bwd.time_range.start)
    assert before[(trace.GEOMETRY, "aten::sin")] == 1
    assert before[(trace.LOSS, "aten::cos")] == 1
    table = trace.device_ms_by_span(prof)
    assert set(table) <= {trace.GEOMETRY, trace.LOSS, trace.BACKWARD, trace.STEP}
    assert all(v >= 0 for v in table.values())


STEP_SPANS = {trace.GEOMETRY, trace.BIN, trace.BLEND, trace.BLEND_BWD, trace.REDUCE,
              trace.LOSS, trace.BACKWARD, trace.UPDATE, trace.VIEW}


@pytest.mark.parametrize("stage,start", [("0", 1), ("1", 4)])
def test_trainer_steps_open_their_spans(tmp_path, stage, start):
    """Two traced steps of `stage` (save_memory, as the LeRF preset runs):
    one train.step span per step, each holding every span of the step's
    layers, one train.log span; the span table places device work under the
    forward spans from inside the backward span."""
    tr = trainer(tmp_path)
    tr.train(until=start)  # the probe and, in stage 1, the frozen plans
    assert tr._stage(start + 1) == stage
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(until=start + 2, log_every=10 ** 9)
    spans = host_spans(prof)
    steps = [e for e in spans if e.name == trace.STEP]
    assert len(steps) == 2
    assert [e.name for e in spans].count(trace.LOG) == 1
    for st in steps:
        inside = {e.name for e in spans if e is not st and within(e, st)}
        assert STEP_SPANS <= inside, STEP_SPANS - inside
    bwd = [e for e in spans if e.name == trace.BACKWARD]
    linked = Counter(op.span for op in trace.device_ops(prof)
                     if any(within_t(op.launched_at, b) for b in bwd))
    assert linked[trace.GEOMETRY] > 0 and linked[trace.LOSS] > 0 and linked[trace.BLEND_BWD] > 0
    table = trace.device_ms_by_span(prof, steps=2)
    assert STEP_SPANS - {trace.VIEW} <= set(table)


def within_t(t: float, outer) -> bool:
    return outer.time_range.start <= t <= outer.time_range.end


def recorded_bins(monkeypatch) -> list:
    """Every TileBins that rasterize._prepare's binning returns from now on."""
    seen, real = [], rasterize.bin_gaussians

    def spy(*a, **kw):
        bins = real(*a, **kw)
        seen.append(bins)
        return bins

    monkeypatch.setattr(rasterize, "bin_gaussians", spy)
    return seen


def expected(bins: list, steps: int) -> dict:
    total = sum(int(b.total) for b in bins)
    dropped = sum(int(b.n_dropped) for b in bins)
    truncated = sum(int(b.n_truncated) for b in bins)
    return dict(steps=steps, padded=sum(b.sorted_gauss.shape[0] for b in bins),
                live=total - dropped - truncated, dropped=dropped, truncated=truncated)


@pytest.mark.parametrize("blocks", [(), (2,)])
def test_counters_sum_the_binnings(tmp_path, monkeypatch, blocks):
    """Four stage-0 steps with max_per_tile cut below the deepest tile after
    the probe, logged once: the counters are the sums of the four binnings'
    own total, n_dropped and n_truncated, eager or in captured blocks, and
    quality_run's lost count is their dropped and truncated slots."""
    opt = dict(STAGE_OPT, save_memory=False, start_ins_feat_iter=50)
    tr = trainer(tmp_path, opt)
    tr.BLOCK_SIZES = blocks
    tr._tune_budgets()
    tr.rcfg = RasterizeConfig(max_per_tile=32, chunk=32,
                              intersection_budget=tr.rcfg.intersection_budget)
    bins = recorded_bins(monkeypatch)
    assert tr.counters == dict.fromkeys(loop.COUNTERS, 0)
    tr.train(until=4, log_every=10 ** 9)
    assert [r["iteration"] for r in tr.history] == [4]
    assert len(bins) == 4
    want = expected(bins, 4)
    assert tr.counters == want
    assert want["truncated"] > 0 and 0 < want["live"] < want["padded"]
    assert tr.history[-1]["counters"] == want
    assert quality_run.slots_lost(tr) == want["dropped"] + want["truncated"]


def test_counters_of_a_lossless_run(tmp_path, monkeypatch):
    """Stage 0 into stage 1 at the tuned budgets: nothing lost, so
    quality_run reads 0 as it did; stage 1's steps count their frozen
    plan's stream."""
    tr = trainer(tmp_path)
    tr.train(until=3)
    tr.train(until=6, log_every=10 ** 9)
    c = tr.counters
    assert c["steps"] == 6 and quality_run.slots_lost(tr) == 0
    assert c["padded"] == 6 * tr.rcfg.max_intersections(tr.state.capacity)
    assert 0 < c["live"] <= c["padded"]


class Scalars:
    def __init__(self):
        self.seen = {}

    def add_scalar(self, tag, value, step):
        self.seen.setdefault(tag, []).append((step, value))


def test_log_boundary_times_and_counts(tmp_path):
    """iter_time is the wall time per step since the previous log: a
    second call of two steps from iteration 2 reads its own wall time over
    2 steps, not over the absolute iteration 4. The scalars hold the live
    fill of the padded stream and the slots lost."""
    tr = trainer(tmp_path, dict(STAGE_OPT, save_memory=False))
    tr.train(until=2)
    tr.tb = Scalars()
    tr.train(until=4)
    rec = tr.history[-1]
    assert 0.8 <= rec["iter_time"] * 2 / rec["elapsed"] <= 1.01
    seen = tr.tb.seen
    assert seen["iter_time"] == [(4, rec["iter_time"])]
    (step, fill), = seen["slots/live_fill"]
    assert step == 4 and 0 < fill <= 1
    assert seen["slots/lost"] == [(4, 0)]

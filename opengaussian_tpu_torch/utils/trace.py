"""Spans of the port's work, and their device time in a torch.profiler trace.

`span(name)` marks a region of host code. While a torch profiler records,
it is a host operation named `name` in the profiler's own trace, so that
every device operation launched inside it can be put down to it through the
profiler's own link from a kernel to its launch, on the clock of the device
trace. With no profiler recording it is one shared no-op context, far
cheaper to enter and leave than a record_function, which costs its
dispatch even with no profiler. `spanned(name)` puts a whole function under
a span. There is no switch: a span is on wherever a profiler records, and
the profiler is the exporter.

The spans, each name given once here (`SPANS`), from the trainer down:

  train.step    Trainer.train: one eager step (`_run_single`)
  train.block   Trainer.train: a captured block of steps (BLOCK_SIZES);
                the graph's replays carry no inner span
  train.view    Trainer.view: the view's window copied from host memory
                (save_memory)
  train.events  the events between steps: densification, the opacity reset,
                the k-means, the pseudo labels, the refiner, the dumps
  train.probe   the budget probe (`_tune_budgets`, `_tune_group_budgets`)
  train.plans   the build of the frozen plans
  train.log     the log boundary: its host sync, history and TensorBoard
  geometry      render's covariances and colours (SH or the encoded
                features) and the rasterizer's projection
  bin           the binning, or a frozen plan's bins
  blend         the forward blend: its inputs, the row gather and K1 (K5),
                the folded windows and the untiled images
  blend.bwd     the blend's backward: K2, K4 or K6 and their glue
  reduce        the per-splat reduce (K3)
  loss          the losses, their masks and PSNR
  backward      the autograd engine's own work (torch.autograd.grad)
  update        Adam and the per-splat densification statistics

`device_ops(prof)` puts each device operation of a trace to a span:
  * to the innermost span open around the host call that launched it (the
    runtime's launch, which the profiler links to the device operation and
    places under the host operation that made it);
  * a kernel launched by a backward node of the autograd engine, which runs
    on the engine's own thread outside the caller's spans, to the span of
    the forward operation the node was recorded for (the node's
    `sequence_nr` and `fwd_thread`), so that a span's device time holds its
    backward too, unless a span is open inside the node (K2 and K3 under
    `blend.bwd` and `reduce`);
  * what is still unplaced but was launched while a `backward` span was
    open (the engine's seed gradient, its zero fills) to `backward`;
  * the rest to `UNPLACED`.
A span's time is its self time: an operation under nested spans counts for
the innermost. On the CPU, where the trace has no device track, each host
operation that contains no other stands for a device operation.
`device_ms_by_span(prof, steps)` sums them per span and step.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch.autograd import DeviceType

STEP = "train.step"
BLOCK = "train.block"
VIEW = "train.view"
EVENTS = "train.events"
PROBE = "train.probe"
PLANS = "train.plans"
LOG = "train.log"
GEOMETRY = "geometry"
BIN = "bin"
BLEND = "blend"
BLEND_BWD = "blend.bwd"
REDUCE = "reduce"
LOSS = "loss"
BACKWARD = "backward"
UPDATE = "update"
SPANS = (STEP, BLOCK, VIEW, EVENTS, PROBE, PLANS, LOG, GEOMETRY, BIN, BLEND, BLEND_BWD,
         REDUCE, LOSS, BACKWARD, UPDATE)
UNPLACED = "unplaced"

_OFF = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast
# the name of the profiler's record of a backward node's evaluation
_NODE = "autograd::engine::evaluate_function: "


def span(name: str):
    """A context that marks `name` (one of SPANS) while a torch profiler runs,
    else the shared no-op context. The mark is the profiler's fast record
    (a host operation named `name`): torch.profiler.record_function would
    also put a range of the same name on the device track, which readers
    of that track (tools/timing.py, the benchmark's idle gaps) would take
    for a kernel."""
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return _OFF


def spanned(name: str):
    """A decorator: the function's whole body under span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with span(name):
                return fn(*a, **kw)

        return inner

    return wrap


def _is_span(e) -> bool:
    return e.name in SPANS and e.device_type == DeviceType.CPU


def _is_launch(e) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cudaMemcpyAsync, cuLaunchKernel, ...)."""
    return e.name.startswith("cu") and "::" not in e.name


class DeviceOp(NamedTuple):
    span: str  # one of SPANS, or UNPLACED
    name: str  # the kernel, copy or fill (the host operation on the CPU)
    us: float  # its time
    launched_at: float  # the host's time of its launch


def device_ops(prof) -> list[DeviceOp]:
    """Each device operation of prof's trace (kernels, copies and fills) put
    to a span by the rules of the module's docstring; on a trace with no
    device track, each host operation that contains no other."""
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type != DeviceType.CPU
              and not e.is_user_annotation and e.name not in SPANS
              and not e.name.startswith("ProfilerStep")]
    # the runtime's launch shares its device operation's correlation id
    launch = {e.id: e for e in host if _is_launch(e)}
    forward = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not e.name.startswith(_NODE):
            forward.setdefault((e.thread, e.sequence_nr), e)
    backward = sorted((e.time_range.start, e.time_range.end) for e in host
                      if e.name == BACKWARD)
    starts = [s for s, _ in backward]

    def span_of(e, depth: int = 0) -> str | None:
        while e is not None:
            if _is_span(e):
                return e.name
            if e.name.startswith(_NODE) and depth < 4:
                fwd = forward.get((e.fwd_thread, e.sequence_nr))
                return (span_of(fwd, depth + 1) if fwd is not None else None) or BACKWARD
            e = e.cpu_parent
        return None

    def in_backward(t: float) -> bool:  # backward spans do not overlap
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= backward[i][1]

    if device:
        ops = [(launch.get(k.id), k) for k in device]
    else:  # the CPU: the host operations that contain no other
        ops = [(e, e) for e in host if not e.cpu_children and not _is_span(e)]
    out = []
    for at, e in ops:
        name = span_of(at) if at is not None else None
        t = at.time_range.start if at is not None else e.time_range.start
        if name is None:
            name = BACKWARD if in_backward(t) else UNPLACED
        out.append(DeviceOp(name, e.name, e.time_range.end - e.time_range.start, t))
    return out


def device_ms_by_span(prof, steps: int = 1) -> dict[str, float]:
    """The device milliseconds per step under each span of prof's trace
    (`device_ops`), with UNPLACED, largest first."""
    by = defaultdict(float)
    for op in device_ops(prof):
        by[op.span] += op.us / 1e3 / steps
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))

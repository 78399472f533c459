"""One module per training stage, found by the stage id in a traffic file.

A traffic mix names its stage ("stage": "0", "1", "2.1", ...); the harness
loads `ogbench/stages/s<id>.py` (dots as underscores: "2.2" -> `s2_2.py`)
through `load`, as it loads a metric's reader by the metric's name. So a
configuration of another stage comes with a module of its own, and the
harness (ogbench/run.py, ogbench/counts.py) holds no branch on the stage.

A stage module provides:

  * `draws(seed, n_views, n) -> [dict]`: the trainer's random draws of its
    first n steps from its seed, one dict a step with at least "view" (the
    view's index). `TrainerRng` replays the trainer's generator.
  * `follow(cfg, traffic, inputs, seed, device, precision="fp32",
    fault=None) -> dict(losses, first_grads, params)`: the plain
    reference's first `check_steps` steps from the start, at precision
    "fp32" or "tf32" (the control), with fault None or "half"
    (ogbench/calibrate.py needs all three). `follow_steps` runs them from a
    step function. It takes nothing that the program made: what the start
    holds beyond the splats it makes again with the stage's own `start`,
    and what the program derives in its steps (cluster assignments, pseudo
    features, rescale draws) it works out again with plain code from those
    and from `draws`.
  * `payload_width`: the channels the blend carries, depth included.
  * `view_work(ar, splats, view, draw) -> dict`: the blend work of one
    step (ogbench/counts.py:frame_work) from the start's splats (device
    tensors), the step's reference view and its draws.
  * `step_ops(work, n_splats, capacity, width, height) -> int`: the fp32
    operations one step needs, given its view's work.

and, where the stage needs it (the default here):

  * `start(cfg, traffic, inputs, seed) -> {name: numpy array}`: arrays
    that the start checkpoint holds beyond the splats, Adam's moments and
    the densification statistics, under the program's .npz names (the
    `kmeans/<field>` group that the checkpoint's loader reads into a
    KMeansState), made from the inputs and the seed. Default: none.

Nothing here imports the program: a stage module is the reference's side.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import re
from typing import Callable, NamedTuple

import numpy as np
import torch

from ogbench import reference

STAGE_ID = re.compile(r"^[0-9A-Za-z]+(\.[0-9A-Za-z]+)*$")
# what the start checkpoint holds already (ogbench/run.py:write_start)
BASE_GROUPS = ("state", "adam", "stats", "iteration")


def no_start(cfg: dict, traffic: dict, inputs: dict, seed: int) -> dict:
    return {}


class Stage(NamedTuple):
    """A stage module's interface, with the defaults filled in."""

    id: str
    draws: Callable
    follow: Callable
    payload_width: int
    view_work: Callable
    step_ops: Callable
    start: Callable = no_start


REQUIRED = tuple(f for f in Stage._fields if f != "id" and f not in Stage._field_defaults)


def module_name(stage_id: str) -> str:
    if not STAGE_ID.match(stage_id):
        raise ValueError(f"not a stage id: {stage_id!r}")
    return "s" + stage_id.replace(".", "_")


def load(stage_id: str) -> Stage:
    """The stage module of `stage_id`, found on this package's search path
    (`__path__`) as a metric's reader is on its package's."""
    name = f"{__name__}.{module_name(stage_id)}"
    if importlib.util.find_spec(name) is None:
        raise FileNotFoundError(f"no stage module {name} for stage {stage_id!r}")
    mod = importlib.import_module(name)
    missing = [f for f in REQUIRED if not hasattr(mod, f)]
    if missing:
        raise TypeError(f"stage module {name} lacks {', '.join(missing)}")
    return Stage(id=stage_id, **{f: getattr(mod, f) for f in Stage._fields[1:]
                                 if hasattr(mod, f)})


class TrainerRng:
    """The trainer's draws from np.random.default_rng(seed), in its order:
    `view` takes the views from the end of a permutation of all of them,
    drawn whenever the queue is empty (Trainer._next_view)."""

    def __init__(self, seed: int, n_views: int):
        self.rng = np.random.default_rng(seed)
        self.n_views = n_views
        self.queue: list[int] = []

    def view(self) -> int:
        if not self.queue:
            self.queue = list(self.rng.permutation(self.n_views))
        return int(self.queue.pop())


def reference_view(cfg: dict, inputs: dict, vi: int, device) -> dict:
    """View vi for the reference: its camera, "gt" image and SAM "ids"."""
    c = inputs["cams"][vi]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return dict(R=torch.as_tensor(c["R"], device=device), t=torch.as_tensor(c["t"], device=device),
                fx=f32(c["fx"]), fy=f32(c["fy"]), width=c["width"], height=c["height"],
                gt=torch.as_tensor(inputs["images"][vi], device=device),
                ids=torch.as_tensor(inputs["ids"][vi], device=device))


def follow_steps(step: Callable, draws: list[dict], cfg: dict, traffic: dict, inputs: dict,
                 device, precision: str = "fp32", fault: str | None = None) -> dict:
    """The reference's first `check_steps` steps from the start
    (reference.run_steps), each on the view of its draws with the draws
    under "draw": step(ar, params, view, it, alive=, bg=, opt=, max_masks=,
    fault=) -> (loss, gradients)."""
    n = int(traffic["check_steps"])
    sp = inputs["splats"]
    params = {k: sp[k].to(device) for k in reference.LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.full_like(v, inputs["nu0"][k]) for k, v in params.items()}
    bg = torch.full((3,), 1.0 if cfg["model"]["white_background"] else 0.0, device=device)
    it0 = int(traffic["start_iteration"])
    views = [dict(reference_view(cfg, inputs, d["view"], device), draw=d) for d in draws[:n]]
    bound = functools.partial(step, alive=sp["alive"].to(device), bg=bg, opt=cfg["opt"],
                              max_masks=inputs["max_masks"], fault=fault)
    return reference.run_steps(bound, params, mu, nu, it0, views, it0, cfg["opt"],
                               inputs["extent"], precision)

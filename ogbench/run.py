"""Run one cell of the port's benchmark once.

    python3 -m ogbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, ogbench/ and the
program (opengaussian_tpu_torch). A cell (BENCHMARK.json "workloads") names
a configuration (ogbench/configs/<config>.json: the preset's options as
run, the scene's sizes) and a traffic mix (ogbench/traffic/<traffic>.json:
the stage, the start iteration, the steps of each call); its limits are in
ogbench/limits/<cell>.json, and what is particular to its stage (the
trainer's draws, the start's extra arrays, the reference's steps, the
counts) in the stage module ogbench/stages/s<stage>.py.

Set-up (counted in setup_s, from process start): the scene made from the
seed on the card (ogbench/scene.py), a `Trainer` at its defaults (fixed
budgets, frozen plans, eager steps) on it, brought to the start iteration
through `Trainer.restore_checkpoint` from a checkpoint the benchmark writes
into the run's temporary directory (the splats, Adam's moments, the
statistics and the stage's `start` arrays); then the first `check_steps`
steps through `Trainer.train`, which also run the budget probe and build
the frozen plans, and `warmup_steps` more. The window (--trace 0) calls
`Trainer.train(until=...)` to the next multiple of `chunk_steps` (a multiple
of the trainer's log_every, so that a call ends where a user's run logs)
until --seconds have passed, and ends in torch.cuda.synchronize(): step_ms
is its wall time over its steps, peak_mem_gib the most memory allocated
since the process started. A traced run (--trace 1) times one such call
untraced, then profiles the next, then SPAN_STEPS more with the host's
operations, and reports the per-layer metrics (ogbench/metrics/<name>.py,
from the record `traced_window` and `count_steps` make).

Every run then frees the program's state and follows the first steps with
the plain reference (the stage module's `follow` over ogbench/reference.py,
float32, TF32 off) from the same start;
ogbench/compare.py decides `correct`. The last line of standard
output is the result as one JSON object; the numbers compared, each with
its limit, are the last lines of standard error and the result's last key.

Exits 2 with no result where no CUDA card (or fewer than the cell asks
for) is present, and 3 where jax, jaxlib, flax or the JAX package
(opengaussian_tpu) was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import zipfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".ogbench_cache")
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
# TensorBoard, which the trainer logs to where it is installed, imports
# TensorFlow where it finds it, and TensorFlow imports JAX: keep TensorBoard
# to its own writer
sys.modules.setdefault("tensorflow", None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ogbench import compare, counts, reference, scene, stages  # noqa: E402
from ogbench.trace import device_ms_by_span, device_record, idle_gaps  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "opengaussian_tpu")
LEAVES = reference.LEAVES
SPAN_STEPS = 16  # steps of a traced run's host window


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix, stage module, limits and metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def data(*parts):
        with open(os.path.join(root, *parts)) as f:
            return json.load(f)

    traffic = data("ogbench", "traffic", cell["traffic"] + ".json")
    return dict(
        cell=cell, config=data(conf["file"]), traffic=traffic,
        stage=stages.load(traffic["stage"]),
        limits=data("ogbench", "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"] if name in m.get("workloads", [name])])


# -- the inputs --

def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The scene of `cfg` from `seed`: the splats (host tensors), cameras,
    images, SAM ids, the extent and Adam's start moments."""
    sc = cfg["scene"]
    gen = torch.Generator(device=device).manual_seed(seed)
    splats = {k: v.cpu() for k, v in scene.make_splats(sc, gen, device).items()}
    images = scene.make_images(sc, gen, device)
    cams = scene.make_cameras(sc)
    ids = [scene.make_sam_ids(sc, i) for i in range(len(cams))]
    return dict(splats=splats, images=images, cams=cams, ids=ids,
                extent=scene.cameras_extent(cams), nu0=traffic["adam_nu0"],
                max_masks=scene.max_masks(sc))


def write_start(path: str, inputs: dict, iteration: int, extra: dict | None = None):
    """A checkpoint of the start in the program's .npz layout
    (/state/<field>, /adam/{mu,nu}/<leaf>, /adam/count, /stats/<field>,
    /iteration, and `extra`'s {name: array}, such as /kmeans/<field>): the
    splats and `extra` stored, the constant moments and statistics
    deflated, so that a run writes little more than the splats."""
    from numpy.lib import format as npf

    extra = extra or {}
    clash = [k for k in extra if k.split("/")[0] in stages.BASE_GROUPS]
    if clash:
        raise ValueError(f"the stage's start would overwrite {clash}")

    sp = inputs["splats"]
    cap = sp["means"].shape[0]
    arrays = [(f"state/{k}", v.numpy(), zipfile.ZIP_STORED) for k, v in sp.items()]
    for k in LEAVES:
        shape = tuple(sp[k].shape)
        arrays.append((f"adam/mu/{k}", np.zeros(shape, np.float32), zipfile.ZIP_DEFLATED))
        arrays.append((f"adam/nu/{k}", np.full(shape, inputs["nu0"][k], np.float32),
                       zipfile.ZIP_DEFLATED))
    arrays += [(f"stats/{k}", np.zeros(cap, np.float32), zipfile.ZIP_DEFLATED)
               for k in ("grad_accum", "denom", "max_radii2d")]
    arrays += [("adam/count", np.asarray(iteration, np.int32), zipfile.ZIP_STORED),
               ("iteration", np.asarray(iteration, np.int64), zipfile.ZIP_STORED)]
    arrays += [(k, np.asarray(v), zipfile.ZIP_STORED) for k, v in extra.items()]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        for name, arr, how in arrays:
            member = name + ".npy"  # a name takes the file's deflate at level 1
            if how == zipfile.ZIP_STORED:
                member = zipfile.ZipInfo(member)
                member.compress_type = how
            with z.open(member, "w", force_zip64=True) as f:
                arr = arr if arr.ndim == 0 else np.ascontiguousarray(arr)
                npf.write_array(f, arr, allow_pickle=False)


def build_scene(cfg: dict, inputs: dict):
    """The program's Scene of the inputs (CPU cameras, host images, packed
    SAM levels). Its point cloud, which the restore replaces, is the first
    4096 splats."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.data.dataset import Scene, View

    level = cfg["opt"]["sam_level"]
    views = []
    for i, c in enumerate(inputs["cams"]):
        cam = Camera(R_w2c=torch.as_tensor(c["R"]), t_w2c=torch.as_tensor(c["t"]),
                     fx=torch.tensor(c["fx"], dtype=torch.float32),
                     fy=torch.tensor(c["fy"], dtype=torch.float32),
                     cx=torch.tensor(c["cx"], dtype=torch.float32),
                     cy=torch.tensor(c["cy"], dtype=torch.float32),
                     width=c["width"], height=c["height"])
        views.append(View(camera=cam, image_name=f"view_{i:04d}",
                          gt_image=inputs["images"][i],
                          sam_mask=scene.packed_sam(inputs["ids"][i], level)))
    sp = inputs["splats"]
    pts = sp["means"][:4096].numpy()
    cols = np.clip(sp["sh_dc"][:4096, 0].numpy() * scene.SH_C0 + 0.5, 0.0, 1.0)
    return Scene(train_views=views, test_views=[], points=pts, colors=cols,
                 cameras_extent=inputs["extent"], source_path="")


def make_trainer(cell: dict, inputs: dict, seed: int, device, out_dir: str):
    """A Trainer at its defaults on the inputs, restored to the mix's start
    iteration with the stage's start arrays."""
    from opengaussian_tpu_torch.config import Config, ModelConfig, OptimizationConfig
    from opengaussian_tpu_torch.train.loop import Trainer

    cfg, traffic = cell["config"], cell["traffic"]
    conf = Config(model=ModelConfig(**cfg["model"]), opt=OptimizationConfig(**cfg["opt"]))
    tr = Trainer(build_scene(cfg, inputs), conf, out_dir, seed=seed, device=device)
    tr.save_intermediate = False  # the CLI's --disable_intermediate_dumps
    path = os.path.join(out_dir, "start.npz")
    it0 = int(traffic["start_iteration"])
    write_start(path, inputs, it0, cell["stage"].start(cfg, traffic, inputs, seed))
    tr.restore_checkpoint(path)
    os.remove(path)
    if tr.iteration != it0:
        raise RuntimeError(f"restored iteration {tr.iteration}, wanted {it0}")
    return tr


def first_steps(tr, cell: dict) -> dict:
    """The check steps through the window's own call. -> the program's
    losses, first gradients (from the first moment after one step, which
    starts at 0) and parameters after the steps, on the host."""
    it0, n = tr.iteration, int(cell["traffic"]["check_steps"])
    tr.train(until=it0 + 1)
    first = {k: (tr.adam.mu[k] / (1.0 - reference.BETA1)).cpu() for k in LEAVES}
    tr.train(until=it0 + n)
    return dict(losses=[float(x) for x in tr.losses[-n:]], first_grads=first,
                params={k: v.cpu() for k, v in tr.state.params().items()})


# -- the window --

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_to_boundary(tr, chunk: int):
    """Train to the next iteration that is a multiple of `chunk`, where the
    trainer logs as a user's run does (chunk_steps is a multiple of its
    log_every)."""
    tr.train(until=(tr.iteration // chunk + 1) * chunk)


def timed_window(tr, traffic: dict, seconds: float, device) -> dict:
    """`Trainer.train` to the next multiple of `chunk_steps` until `seconds`
    have passed, ended in a synchronisation: the window's steps and wall
    time."""
    chunk = int(traffic["chunk_steps"])
    it_start, n_losses = tr.iteration, len(tr.losses)
    _sync(device)
    t0 = last = time.perf_counter()
    chunks = []
    while True:
        it = tr.iteration
        _train_to_boundary(tr, chunk)
        now = time.perf_counter()
        chunks.append((now - last) / (tr.iteration - it) * 1e3)
        last = now
        if now - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    losses = torch.stack(tr.losses[n_losses:])
    q = np.quantile(chunks, [0.0, 0.25, 0.5, 0.75, 1.0])
    log("ms a step by chunk of the window: min, quartiles, max " + ", ".join(f"{x:.3f}" for x in q))
    return dict(steps=tr.iteration - it_start, window_s=window_s,
                failed=int((~torch.isfinite(losses)).sum()))


def host_traced_steps(tr, steps: int, device) -> tuple[dict, object, float]:
    """`steps` steps under a trace of the host's operations and the
    device's. -> (the trainer's counters added over them, the profile, wall
    seconds)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    before = dict(tr.counters)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train(until=tr.iteration + steps)
        _sync(device)
        wall = time.perf_counter() - t0
    return {k: tr.counters[k] - before[k] for k in before}, prof, wall


def traced_window(tr, traffic: dict, device) -> dict:
    """The per-layer metrics' window. First one call of the window with the
    profiler off, to the next multiple of `chunk_steps`: its wall time per
    step is the step's time (the tracer slows a host-paced step). Then
    `gap_steps` traced and dropped while the profiler warms up, and the
    steps to the next multiple of `chunk_steps` traced with the device's
    activity alone: the device record, and the change of the trainer's
    counters over them ("counters"). Then SPAN_STEPS more traced with the
    host's operations too: the idle gaps' names and the device ms a step by
    the program's span ("spans"; None where that trace holds no device
    operation, so that no host time is read as the device's)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from opengaussian_tpu_torch.utils.trace import SPANS

    chunk, gap = int(traffic["chunk_steps"]), int(traffic["gap_steps"])
    dev_act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    n_losses = len(tr.losses)
    plain = timed_window(tr, traffic, 0.0, device)
    with profile(activities=[dev_act],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        tr.train(until=tr.iteration + gap)
        _sync(device)
        prof.step()
        it_start = tr.iteration
        before = dict(tr.counters)  # summed at the end of every train call
        t0 = time.perf_counter()
        _train_to_boundary(tr, chunk)
        _sync(device)
        window_s = time.perf_counter() - t0
        steps = tr.iteration - it_start
        counters = {k: tr.counters[k] - before[k] for k in before}
        prof.step()
    rec = device_record(prof, window_s)
    _, host, _ = host_traced_steps(tr, SPAN_STEPS, device)
    rec["breakdown"] = dict(device_ops=rec.pop("device_ops"), idle_gaps=idle_gaps(host))
    rec["spans"] = device_ms_by_span(host, SPAN_STEPS, SPANS) or None
    rec["counters"] = counters
    losses = torch.stack(tr.losses[n_losses:])
    rec.update(steps=steps, attempted=len(losses), failed=int((~torch.isfinite(losses)).sum()),
               first_step=it_start - int(traffic["start_iteration"]),
               step_s=plain["window_s"] / plain["steps"], plain_steps=plain["steps"])
    rcfg = tr.rcfg
    rec["slot_budget"] = (max(rcfg.intersection_budget, rcfg.min_intersections)
                          if rcfg.intersection_budget else 0)
    return rec


@torch.no_grad()
def count_steps(rec: dict, cell: dict, inputs: dict, seed: int, device,
                peak_flops: float | None, peak_bytes: float | None):
    """Each traced step's blend work, counted on the start's splats by the
    stage module (`view_work`, once for each distinct set of draws), and
    the sums the readers take: step_ops, and with the card's peaks
    fwd_bound_s and bwd_bound_s."""
    stage, cfg = cell["stage"], cell["config"]
    first = rec["first_step"]
    draws = stage.draws(seed, len(inputs["cams"]), first + rec["steps"])[first:]
    sp = {k: v.to(device) for k, v in inputs["splats"].items()}
    ar = reference.Arith("fp32")
    C = stage.payload_width
    cache, works = {}, []
    for d in draws:
        key = tuple(sorted(d.items()))
        if key not in cache:
            v = stages.reference_view(cfg, inputs, d["view"], device)
            cache[key] = stage.view_work(ar, sp, v, d)
        works.append(cache[key])
    sc = cfg["scene"]
    n, cap = int(sc["splats"]), int(sp["means"].shape[0])
    rec["works"] = works
    rec["step_ops"] = sum(stage.step_ops(w, n, cap, sc["width"], sc["height"]) for w in works)
    rec["peak_flops"] = peak_flops
    if peak_flops:
        rec["fwd_bound_s"] = sum(counts.bound_s(*counts.fwd_cost(w, C), peak_flops, peak_bytes)
                                 for w in works)
        rec["bwd_bound_s"] = sum(counts.bound_s(*counts.bwd_cost(w, C), peak_flops, peak_bytes)
                                 for w in works)


def read_metrics(metrics: list[dict], rec: dict) -> dict:
    out = {}
    for m in metrics:
        mod = importlib.import_module(f"ogbench.metrics.{m['name']}")
        v = mod.read(rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def setup(cell: dict, seed: int, device, out_dir: str) -> tuple:
    """The set-up of a run: inputs, trainer, first steps, warm-up.
    -> (trainer, inputs, the program's first steps, the seconds of each
    part: "start" (interpreter, imports, the card's context), "scene",
    "trainer" (its views on the device, the checkpoint written and
    restored), "first_steps" (with the budget probe, "probe", and the frozen
    plans, "plans", as the trainer logs them), "warmup")."""
    cfg, traffic = cell["config"], cell["traffic"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    parts, t = {}, time.perf_counter()
    parts["start"] = t - T_START

    def lap(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        parts[name], t = now - t, now

    inputs = make_inputs(cfg, traffic, seed, device)
    lap("scene")
    tr = make_trainer(cell, inputs, seed, device, out_dir)
    lap("trainer")
    prog = first_steps(tr, cell)
    lap("first_steps")
    tr.train(until=tr.iteration + int(traffic["warmup_steps"]))
    lap("warmup")
    parts["probe"] = sum(r["seconds"] for r in tr.budget_log)
    parts["plans"] = sum(r["seconds"] for r in tr.frozen_plan_log)
    return tr, inputs, prog, parts


def check(cell: dict, inputs: dict, prog: dict, seed: int, device) -> tuple[bool, dict, dict]:
    """The reference's verdict on the program's first steps.
    -> (correct, checks, the gaps with the worst leaves)."""
    ref = cell["stage"].follow(cell["config"], cell["traffic"], inputs, seed, device)
    start = {k: inputs["splats"][k] for k in LEAVES}
    g = compare.gaps(prog, ref, start)
    ok, checks = compare.verdict(g, cell["limits"])
    return ok, checks, g


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        root: str = ROOT) -> dict:
    """One run of cell `name`. -> the result object."""
    cell = load_cell(name, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out_dir = tempfile.mkdtemp(prefix="ogbench-")
    try:
        tr, inputs, prog, parts = setup(cell, seed, dev, out_dir)
        setup_s = time.perf_counter() - T_START
        traffic = cell["traffic"]
        rec = (traced_window(tr, traffic, dev) if trace
               else timed_window(tr, traffic, seconds, dev))
        found = forbidden_modules()
        if found:
            log("forbidden modules loaded:", ", ".join(found))
            raise SystemExit(3)
        peak_alloc = torch.cuda.max_memory_allocated(dev) if cuda else 0
        peak_resv = torch.cuda.max_memory_reserved(dev) if cuda else 0
        plans = tr._frozen_plans
        plan_state = ("off" if plans is False else "none" if plans is None else
                      f"built, {plans.nbytes()} bytes")
        del tr
        if cuda:
            torch.cuda.empty_cache()
        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        if trace:
            count_steps(rec, cell, inputs, seed, dev,
                        *(counts.peaks(kind) if cuda else (None, None)))
            metrics = read_metrics(cell["per_layer"], rec)
        else:
            step_ms = rec["window_s"] / rec["steps"] * 1e3
            values = dict(step_ms=step_ms, peak_mem_gib=peak_alloc / 2**30, setup_s=setup_s)
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell["end_to_end"]}
        ok, checks, g = check(cell, inputs, prog, seed, dev)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    device_rec = dict(platform="gpu" if cuda else "cpu", kind=kind,
                      count=1, memory_peak_bytes=int(peak_resv))
    if trace:
        device_rec.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    log("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    log(f"device: {power_limit() if cuda else 'cpu'}; frozen plans: {plan_state}; "
        f"steps {rec['steps']} in {rec['window_s']:.3f} s; worst leaves: gradient "
        f"{g['grad_leaf']}, change {g['change_leaf']} of {g['leaves']}")
    if trace:
        log(f"untraced: {rec['plain_steps']} steps at {rec['step_s'] * 1e3:.3f} ms a step; "
            f"traced: busy {rec['busy_s'] / rec['steps'] * 1e3:.3f} ms a step of "
            f"{rec['window_s'] / rec['steps'] * 1e3:.3f}")
    for k, c in checks.items():
        log(f"check {k} {c['value']:.6e} limit {c['limit']:.6e}")
    result = dict(correct=ok, attempted=rec.get("attempted", rec["steps"]),
                  failed=rec["failed"], metrics=metrics, device=device_rec)
    if trace:
        result["breakdown"] = rec["breakdown"]
    result["setup_parts"] = parts
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    chips = load_cell(a.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run(a.workload, a.seed, a.seconds, bool(a.trace))
    found = forbidden_modules()
    if found:
        log("forbidden modules loaded:", ", ".join(found))
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The rasterizer's hand-written CUDA kernels and their plain versions,
and the build and launch of every kernel of the port.

  * `blend_stream_fwd` (csrc/blend_stream_fwd.cu) is the counterpart of the
    JAX package's Pallas kernel `rasterize_pallas.py:blend_stream_pallas_fwd`:
    the forward alpha blend of every tile's depth-sorted run out of the slot
    stream.
  * `blend_stream_bwd` (csrc/blend_stream_bwd.cu) is the counterpart of
    `blend_stream_pallas_bwd`: the front-to-back replay that gives every slot
    of the stream its gradient row.
  * `blend_stream_bwd_compact` (csrc/blend_stream_bwd_compact.cu) is the
    counterpart of `blend_stream_pallas_bwd_compact`: the same replay, its
    rows written at chunk-compacted offsets beside their splat ids.
  * `segment_reduce_perm`, `segment_reduce` and `segment_reduce_sorted`
    (csrc/segment_reduce.cu) are the counterparts of
    `sorted_segment_reduce`: the per-splat sum of those rows. The
    permutation entry, the rasterizer's default (RasterizeConfig
    reduce_backend "sorted_mxu"), sums each splat's rows in a fixed order
    read off the binning's sort, without sorting; `segment_reduce` sums in
    atomic order (reduce_backend "scatter"); `segment_reduce_sorted` sorts
    the ids as the JAX package does and sums each id's rows in row order
    (the SAM refiner's votes).
  * `blend_tiles_fwd` (csrc/blend_tiles_fwd.cu) and `blend_tiles_bwd`
    (csrc/blend_tiles_bwd.cu) are the counterparts of `blend_tiles_pallas_fwd`
    and `blend_tiles_pallas_bwd`: the same blend and replay over a dense
    [T, K, 6 + C] block of gathered rows (the dense input layout). A dense
    block is a stream whose tile t starts at t * K, so the stream kernels and
    the dense ones share their walk (csrc/blend_tile.cuh), and the dense
    plain versions are the stream plain versions over that strided stream.
    The dense backward writes its rows at the stream positions the block
    was gathered from, so its output is the stream backward's.
  * `blend_tiles_fwd_groups` and `blend_tiles_bwd_groups` are the group
    entries of the same two sources: the dense blend and its replay once
    per group of a [G, N] opacity table, the group a grid axis, each row's
    opacity read by splat id (the JAX package's rasterize_groups, which
    vmaps the dense blend over the groups' opacities). Their launches count
    with K5's and K6's in chip_smoke.py.

  * `cov3d_fwd`/`cov3d_bwd`, `project_fwd`/`project_bwd` and
    `sh_fwd`/`sh_bwd` (csrc/geometry.cu, wrapped in ops/geometry_kernels.py)
    are the geometry layer in front of the blend: covariance, projection and
    SH colour, forward and backward, one thread per splat. They replace no
    Pallas kernel (the JAX package leaves this math to XLA's fusion).
  * `mask_loss_fwd`/`mask_loss_bwd` (csrc/mask_losses.cu, wrapped in
    ops/mask_loss_kernels.py) are the stage-1 SAM-mask losses: per-mask
    sums by pixel id, forward and backward. They replace no Pallas kernel
    (the JAX package builds these losses from dense mask stacks).

Each source notes the bound on the card and what its design does about it.
Each wrapper dispatches on the device of its inputs: a CPU tensor runs the
`*_plain` version, the same arithmetic in plain PyTorch; a CUDA tensor
launches the kernel, or raises. It never falls back. Each wrapper counts its
kernel's launches in `<wrapper>.launches`.

Every `csrc/*.cu` is compiled with nvcc for sm_90a at first use, one nvcc
process per source, all started together, into its own shared library with
a plain C entry point, loaded with ctypes. The build directory
`csrc/build/<hash>/` is keyed by the hash of all the sources, the headers
they include and the flags, so an edited source or header rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from opengaussian_tpu_torch.ops import blend, geometry_kernels, mask_loss_kernels
from opengaussian_tpu_torch.ops.projection import TILE

NPIX = TILE * TILE  # pixels per tile, one CUDA thread each
N_GEOM = 6  # row columns before the payload: mean2d 2, conic 3, opacity 1
WARP = 32

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_C = 16  # payload channels one thread holds: kMaxC in the blend sources

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> (source stem, argument types); each returns a cudaError_t
_ENTRIES = {
    "og_blend_stream_fwd": ("blend_stream_fwd", [_p, _i, _p, _p, _p, _i, _i, _i, _p, _p, _p]),
    "og_blend_stream_bwd": ("blend_stream_bwd", [_p, _i, _p, _p, _p, _i, _i, _i,
                                                 _p, _p, _p, _p, _p, _p]),
    "og_blend_stream_bwd_compact": ("blend_stream_bwd_compact",
                                    [_p, _i, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                     _p, _p, _p, _p, _p, _p, _p]),
    "og_segment_reduce": ("segment_reduce", [_p, _p, _i, _i, _i, _p, _p]),
    "og_segment_reduce_sorted": ("segment_reduce", [_p, _p, _p, _i, _i, _i, _i, _p, _p]),
    "og_segment_reduce_perm": ("segment_reduce", [_p, _p, _p, _i, _i, _i, _i, _p, _p]),
    "og_blend_tiles_fwd": ("blend_tiles_fwd", [_p, _i, _i, _i, _p, _i, _i, _i, _p, _p,
                                               _p]),
    "og_blend_tiles_bwd": ("blend_tiles_bwd", [_p, _i, _i, _i, _p, _p, _i, _i, _i,
                                               _p, _p, _p, _p, _p, _p]),
    "og_blend_tiles_fwd_groups": ("blend_tiles_fwd", [_p, _i, _i, _i, _p, _p, _p, _i, _i,
                                                      _i, _i, _i, _p, _p, _p]),
    "og_blend_tiles_bwd_groups": ("blend_tiles_bwd", [_p, _i, _i, _i, _p, _p, _p, _p, _i,
                                                      _i, _i, _i, _i, _i, _p, _p, _p, _p,
                                                      _p, _p]),
    "og_cov3d_fwd": ("geometry", [_p, _p, _i, _p, _p]),
    "og_cov3d_bwd": ("geometry", [_p, _p, _p, _i, _p, _p, _p]),
    "og_project_fwd": ("geometry", [_p] * 8 + [_i] * 3 + [_p] * 10),
    "og_project_bwd": ("geometry", [_p] * 6 + [_p, _i] * 3 + [_i] * 3 + [_p] * 4),
    "og_sh_fwd": ("geometry", [_i, _p, _i, _p, _p, _i, _p, _p]),
    "og_sh_bwd": ("geometry", [_i, _p, _i, _p, _p, _p, _i, _i, _p, _p, _p]),
    "og_mask_loss_fwd": ("mask_losses", [_p, _l, _l, _p, _p] + [_i] * 4 + [_p] * 8),
    "og_mask_loss_bwd": ("mask_losses", [_p, _l, _l, _p, _p] + [_i] * 4 + [_p] * 8),
}

_fns: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> tuple[dict[str, Path], str]:
    """Compile every csrc/*.cu into its own shared library unless a build of
    the same sources and headers exists; the nvcc processes run in parallel.
    -> ({source stem: library path}, compiler output; "" if cached)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16]
    libs = {src.stem: out / f"lib{src.stem}.so" for src in sources}
    todo = [src for src in sources if not libs[src.stem].exists()]
    if not todo:
        return libs, ""
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, tmp, proc in procs:
        text = proc.communicate()[0]
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{text}")
        else:
            os.replace(tmp, libs[src.stem])  # atomic: no reader sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, "".join(log)


def _fn(name: str):
    """The C entry point `name`, from the library of its source."""
    if name not in _fns:
        stem, argtypes = _ENTRIES[name]
        fn = getattr(ctypes.CDLL(str(build()[0][stem])), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry `name` on the current stream of `device`, which the
    CUDA runtime must also take as its current device: switch to it only
    when it is not."""
    fn = _fns.get(name) or _fn(name)
    # torch.cuda.current_stream(device).cuda_stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_stream(rows, counts, tstart, toff, chunk) -> None:
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] <= N_GEOM:
        raise ValueError(f"rows must be float32 [P, {N_GEOM}+C], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    T = counts.shape[0]
    for nm, x in (("counts", counts), ("tstart", tstart), ("toff", toff)):
        if x.dtype != torch.int32 or x.shape != (T,):
            raise ValueError(f"{nm} must be int32 [{T}], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != rows.device:
            raise ValueError(f"{nm} is on {x.device}, rows on {rows.device}")
    for nm, x in (("rows", rows), ("counts", counts), ("tstart", tstart), ("toff", toff)):
        if not x.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")


def _pixels(toff, grid_x: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel coordinates of each tile's lanes, [T, 1, NPIX] each."""
    lane = torch.arange(NPIX, device=dev)
    toff = toff.to(torch.int64)
    px = ((toff % grid_x) * TILE)[:, None] + (lane % TILE)[None, :]
    py = ((toff // grid_x) * TILE)[:, None] + (lane // TILE)[None, :]
    return px.to(torch.float32)[:, None, :], py.to(torch.float32)[:, None, :]


def _chunk_alpha(rows, counts, start, base: int, chunk: int, px, py):
    """One chunk of every tile's run: slots [base, base + chunk) of each.
    -> (kmask [T, chunk] slot exists, idx [T, chunk] stream rows,
    g [T, chunk, F] rows, dx, dy, gauss, araw, a [T, chunk, NPIX]), where a
    is alpha after the 0.99 clamp and the 1/255 skip (0 where skipped)."""
    k = base + torch.arange(chunk, device=rows.device)
    kmask = k[None, :] < counts[:, None]
    idx = torch.where(kmask, start[:, None] + k[None, :], 0)
    g = rows[idx]
    dx = g[..., 0:1] - px
    dy = g[..., 1:2] - py
    power = (-0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy)
             - g[..., 3:4] * dx * dy)
    gauss = torch.exp(torch.clamp(power, max=0.0))
    araw = torch.where(power <= 0.0, g[..., 5:6] * gauss, 0.0)
    a = torch.clamp(araw, max=blend.ALPHA_MAX)
    a = torch.where((a >= blend.ALPHA_MIN) & kmask[..., None], a, 0.0)
    return kmask, idx, g, dx, dy, gauss, araw, a


def slot_box_plain(g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward walk's cull box (blend_tile.cuh:slot_box),
    in the kernel's fp32 arithmetic (det in float64, as the kernel takes it).
    g [..., >= 6] f32 rows. -> [..., 4] f32 boxes (x0, x1, y0, y1): outside
    the box the slot's alpha stays below 1/255; empty (x0 > x1) when its
    opacity is below 1/255, unbounded where the kernel never culls."""
    mx, my, ca, cb, cc, o = g[..., :6].to(torch.float32).unbind(-1)
    det = (ca.double() * cc.double() - cb.double() * cb.double()).float()
    r = 1e-6 * ((torch.maximum(ca, cc) + cb.abs()) * (ca + cc) / det)
    lvl = (torch.log(o / blend.ALPHA_MIN) + 1e-5) / (1.0 - r) * 1.0001
    ex = torch.sqrt(2.0 * lvl * cc / det)
    ey = torch.sqrt(2.0 * lvl * ca / det)
    hx = ex + (ex * 1e-4 + mx.abs() * 2.4e-7 + 0.015625)
    hy = ey + (ey * 1e-4 + my.abs() * 2.4e-7 + 0.015625)
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], -1)
    ok = ((ca > 0) & (cc > 0) & (det > 0) & (r <= 0.5)
          & torch.isfinite(box).all(-1))
    inf = float("inf")
    box = torch.where(ok[..., None], box, box.new_tensor([-inf, inf, -inf, inf]))
    return torch.where((o < blend.ALPHA_MIN)[..., None],
                       box.new_tensor([inf, -inf, inf, -inf]), box)


def _new_work(T: int, dev) -> dict:
    """count_work's counters: per (tile, pixel) for the pair counts, one
    each for the per-slot ones."""
    work = {k: torch.zeros((T, NPIX), dtype=torch.int64, device=dev)
            for k in ("evaluated", "in_box", "tested", "blended")}
    work.update({k: torch.zeros((), dtype=torch.int64, device=dev)
                 for k in ("boxes", "box_tests")})
    return work


def _count_boxes(work: dict, g, kmask, done, toff, grid_x: int) -> torch.Tensor:
    """count_work's cull terms of one chunk: the slots of the tiles whose
    pixels have not all stopped ("boxes": one slot_box each, "box_tests":
    one test per slot and warp). -> [T, chunk, NPIX] bool: the pixel's warp
    rectangle (16 x 2 pixels) meets the slot's box, so a walk that culls
    still evaluates the pair."""
    staged = int((kmask & ~done.all(dim=1, keepdim=True)).sum())
    work["boxes"] += staged
    work["box_tests"] += staged * (NPIX // WARP)
    box = slot_box_plain(g)
    toff = toff.to(torch.int64)
    rx0 = ((toff % grid_x) * TILE).to(torch.float32)[:, None, None]
    ry0 = (((toff // grid_x) * TILE)[:, None]
           + 2 * torch.arange(NPIX // WARP, device=g.device)).to(torch.float32)[:, None, :]
    miss = ((rx0 + (TILE - 1) < box[..., 0:1]) | (rx0 > box[..., 1:2])
            | (ry0 + 1 < box[..., 2:3]) | (ry0 > box[..., 3:4]))
    return (~miss).repeat_interleave(WARP, dim=-1)


def blend_stream_fwd_plain(rows, counts, tstart, toff, grid_x: int, chunk: int,
                           count_work: bool = False):
    """Plain PyTorch version of the kernel: vectorized over tiles and pixels,
    a loop over chunks of each run and, inside a chunk, over its slots in
    depth order. Same operations in the same order as the kernel, so both
    round alike. Arguments and outputs as for `blend_stream_fwd`.

    With count_work, also returns the work this stream's data needs, as
    (slot, pixel) pair counts: {"evaluated": alpha computed (every slot a
    pixel walks, up to and including the one that stops it), "in_box": the
    evaluated pairs whose warp's 16 x 2 pixels meet the slot's cull box
    (`slot_box_plain`), the evaluations a walk that culls still makes,
    "tested": alpha >= 1/255, so the transmittance test ran, "blended": the
    pair composited its payload}, and per slot {"boxes": the slots staged
    by tiles still walking, one cull box each, "box_tests": one test per
    such slot and warp}."""
    _check_stream(rows, counts, tstart, toff, chunk)
    dev = rows.device
    T = counts.shape[0]
    C = rows.shape[1] - N_GEOM
    px, py = _pixels(toff, grid_x, dev)

    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    acc = torch.zeros((T, NPIX, C), dtype=torch.float32, device=dev)
    work = _new_work(T, dev)
    counts = counts.to(torch.int64)
    start = tstart.to(torch.int64)
    max_count = int(counts.max()) if T else 0
    for base in range(0, max_count, chunk):
        if bool(done.all()):
            break
        kmask, _, g, _, _, _, _, a = _chunk_alpha(rows, counts, start, base,
                                                  chunk, px, py)
        if count_work:
            meets = _count_boxes(work, g, kmask, done, toff, grid_x)
        for j in range(min(chunk, max_count - base)):
            aj = a[:, j]  # [T, NPIX]
            t_next = trans * (1.0 - aj)
            stop = t_next < blend.T_EPS
            contrib = (aj > 0.0) & ~stop & ~done
            if count_work:
                work["evaluated"] += kmask[:, j, None] & ~done
                work["in_box"] += kmask[:, j, None] & ~done & meets[:, j]
                work["tested"] += (aj > 0.0) & ~done
                work["blended"] += contrib
            w = torch.where(contrib, aj * trans, 0.0)
            acc = acc + w[..., None] * g[:, j, None, N_GEOM:]
            trans = torch.where(contrib, t_next, trans)
            done = done | stop
    out = acc.transpose(1, 2).contiguous(), trans
    if count_work:
        return (*out, {k: int(v.sum()) for k, v in work.items()})
    return out


def _staging_bytes(chunk: int, F: int) -> int:
    """The walks' staging in shared memory (blend_tile.cuh:fwd_smem_bytes): two
    mbarriers, two chunks' cull masks (a bit per slot and warp) and two
    buffers of the chunk's rows."""
    return 16 + 2 * (NPIX // WARP) * -(-chunk // 32) * 4 + 2 * chunk * F * 4


def _check_fwd_smem(chunk: int, F: int) -> None:
    if _staging_bytes(chunk, F) > 227 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds the shared memory "
                         "of a block")


def blend_stream_fwd(rows, counts, tstart, toff, grid_x: int, chunk: int):
    """Forward blend of every tile's run out of the sorted slot stream.

    rows [P, 6+C] f32: per sorted slot mean2d x/y, conic a/b/c, opacity and
    C payload channels (depth is the caller's last payload channel). Tile t
    blends rows [tstart[t], tstart[t] + counts[t]); its pixels are those of
    image tile toff[t]. counts/tstart/toff: [T] int32. chunk: rows staged per
    step. -> (accum [T, C, 256] premultiplied payload, t_final [T, 256]).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_stream_fwd.launches` counts kernel launches."""
    if rows.device.type == "cpu":
        return blend_stream_fwd_plain(rows, counts, tstart, toff, grid_x, chunk)
    if rows.device.type != "cuda":
        raise ValueError(f"blend_stream_fwd runs on cpu or cuda, not {rows.device}")
    _check_stream(rows, counts, tstart, toff, chunk)
    T = counts.shape[0]
    F = rows.shape[1]
    C = F - N_GEOM
    if C > MAX_C:
        raise ValueError(f"the kernel blends at most {MAX_C} channels, got {C}")
    _check_fwd_smem(chunk, F)
    accum = torch.empty((T, C, NPIX), dtype=torch.float32, device=rows.device)
    t_final = torch.empty((T, NPIX), dtype=torch.float32, device=rows.device)
    if T == 0:
        return accum, t_final
    _launch("og_blend_stream_fwd", rows.device, rows.data_ptr(), F,
            counts.data_ptr(), tstart.data_ptr(), toff.data_ptr(), T, grid_x,
            chunk, accum.data_ptr(), t_final.data_ptr())
    blend_stream_fwd.launches += 1
    return accum, t_final


blend_stream_fwd.launches = 0


def _check_bwd(n_fields: int, dev, counts, accum, t_final, g_accum, g_t) -> None:
    T, C = counts.shape[0], n_fields - N_GEOM
    for nm, x, shape in (("accum", accum, (T, C, NPIX)), ("t_final", t_final, (T, NPIX)),
                         ("g_accum", g_accum, (T, C, NPIX)), ("g_t", g_t, (T, NPIX))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{nm} must be float32 {list(shape)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{nm} is on {x.device}, the rows on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")


def _check_bwd_smem(chunk: int, F: int) -> None:
    """The backward walk's shared memory (blend_tile.cuh:bwd_smem_bytes): the
    forward's staging and the 8 warps' partials of a chunk."""
    if _staging_bytes(chunk, F) + (NPIX // WARP) * chunk * F * 4 > 227 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds the shared memory "
                         "of a block")


def _lane_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (NPIX lanes) in the kernel's order: within each
    warp of 32 lanes the shuffle-down tree (offsets 16, 8, 4, 2, 1), then the
    warps' partials one after another."""
    x = x.reshape(*x.shape[:-1], NPIX // WARP, WARP)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    x = x[..., 0]
    s = x[..., 0]
    for w in range(1, NPIX // WARP):
        s = s + x[..., w]
    return s


def blend_stream_bwd_plain(rows, counts, tstart, toff, accum, t_final, g_accum,
                           g_t, grid_x: int, chunk: int, count_work: bool = False):
    """Plain PyTorch version of the backward kernel: the forward's walk,
    vectorized over tiles and pixels, with the gradient of every (slot,
    pixel) pair summed over the tile's pixels in the kernel's order. Same
    operations in the same order as the kernel. Arguments and output as for
    `blend_stream_bwd`.

    With count_work, also returns the replay's work counts, those of
    `blend_stream_fwd_plain` ("blended": the pair composited, so it has
    gradient terms)."""
    _check_stream(rows, counts, tstart, toff, chunk)
    _check_bwd(rows.shape[1], rows.device, counts, accum, t_final, g_accum, g_t)
    dev = rows.device
    T, F = counts.shape[0], rows.shape[1]
    C = F - N_GEOM
    px, py = _pixels(toff, grid_x, dev)
    ga_total = g_accum[:, 0] * accum[:, 0]  # [T, NPIX]
    for c in range(1, C):
        ga_total = ga_total + g_accum[:, c] * accum[:, c]
    gtt = g_t * t_final

    d_rows = torch.zeros_like(rows)
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    bacc = torch.zeros((T, NPIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    work = _new_work(T, dev)
    counts = counts.to(torch.int64)
    start = tstart.to(torch.int64)
    max_count = int(counts.max()) if T else 0
    floor = 1.0 - blend.ALPHA_MAX  # rounds to 0.01f, as in the kernel
    for base in range(0, max_count, chunk):
        if bool(done.all()):
            break
        kmask, idx, g, dx, dy, gauss, araw, a = _chunk_alpha(
            rows, counts, start, base, chunk, px, py)
        if count_work:
            meets = _count_boxes(work, g, kmask, done, toff, grid_x)
        for j in range(min(chunk, max_count - base)):
            aj = a[:, j]
            t_next = trans * (1.0 - aj)
            stop = t_next < blend.T_EPS
            contrib = (aj > 0.0) & ~stop & ~done
            if count_work:
                work["evaluated"] += kmask[:, j, None] & ~done
                work["in_box"] += kmask[:, j, None] & ~done & meets[:, j]
                work["tested"] += (aj > 0.0) & ~done
                work["blended"] += contrib
            w = torch.where(contrib, aj * trans, 0.0)
            gj = g[:, j, :, None]  # [T, F, 1]
            gc = gj[:, N_GEOM] * g_accum[:, 0]
            for c in range(1, C):
                gc = gc + gj[:, N_GEOM + c] * g_accum[:, c]
            bacc = bacc + w * gc
            one_m_a = torch.clamp(1.0 - aj, min=floor)
            d_alpha = torch.where(
                contrib, trans * gc - (ga_total - bacc) / one_m_a - gtt / one_m_a,
                0.0)
            d_alpha = torch.where(araw[:, j] < blend.ALPHA_MAX, d_alpha, 0.0)
            d_power = aj * d_alpha
            ddx, ddy = dx[:, j], dy[:, j]
            ca, cb, cc = gj[:, 2], gj[:, 3], gj[:, 4]
            vals = torch.stack(
                [d_power * -(ca * ddx + cb * ddy), d_power * -(cc * ddy + cb * ddx),
                 d_power * (-0.5 * ddx * ddx), d_power * (-ddx * ddy),
                 d_power * (-0.5 * ddy * ddy), d_alpha * gauss[:, j]]
                + [w * g_accum[:, c] for c in range(C)], dim=1)  # [T, F, NPIX]
            rows_j = _lane_tree_sum(vals)  # [T, F]
            live = kmask[:, j]
            d_rows[idx[live, j]] = rows_j[live]
            trans = torch.where(contrib, t_next, trans)
            done = done | stop
    if count_work:
        return d_rows, {k: int(v.sum()) for k, v in work.items()}
    return d_rows


def blend_stream_bwd(rows, counts, tstart, toff, accum, t_final, g_accum, g_t,
                     grid_x: int, chunk: int):
    """Per-slot gradient rows of the stream blend.

    rows, counts, tstart, toff, grid_x, chunk: the forward's inputs (see
    `blend_stream_fwd`); accum [T, C, 256], t_final [T, 256]: its outputs;
    g_accum [T, C, 256], g_t [T, 256]: their cotangents. -> d_rows
    [P, 6 + C] f32: for every slot of the stream, the loss gradient by its
    row's fields (mean2d 2, conic 3, opacity 1, payload C), summed over the
    pixels of its tile; zero for slots no tile walks. The tiles' runs are
    disjoint, as the binned stream's are.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_stream_bwd.launches` counts kernel launches."""
    if rows.device.type == "cpu":
        return blend_stream_bwd_plain(rows, counts, tstart, toff, accum, t_final,
                                      g_accum, g_t, grid_x, chunk)
    if rows.device.type != "cuda":
        raise ValueError(f"blend_stream_bwd runs on cpu or cuda, not {rows.device}")
    _check_stream(rows, counts, tstart, toff, chunk)
    _check_bwd(rows.shape[1], rows.device, counts, accum, t_final, g_accum, g_t)
    T, F = counts.shape[0], rows.shape[1]
    if F - N_GEOM > MAX_C:
        raise ValueError(f"the kernel takes at most {MAX_C} channels, got {F - N_GEOM}")
    _check_bwd_smem(chunk, F)
    d_rows = torch.zeros_like(rows)
    if T == 0:
        return d_rows
    _launch("og_blend_stream_bwd", rows.device, rows.data_ptr(), F,
            counts.data_ptr(), tstart.data_ptr(), toff.data_ptr(), T, grid_x,
            chunk, accum.data_ptr(), t_final.data_ptr(), g_accum.data_ptr(),
            g_t.data_ptr(), d_rows.data_ptr())
    blend_stream_bwd.launches += 1
    return d_rows


blend_stream_bwd.launches = 0


def compact_starts(counts, chunk: int) -> torch.Tensor:
    """Each tile's first chunk in the compacted layout: cstart [T] int32, the
    exclusive cumsum of ceil(counts / chunk), on the counts' device."""
    nchunks = torch.div(counts + (chunk - 1), chunk, rounding_mode="floor")
    return torch.cumsum(nchunks, 0, dtype=torch.int32).sub_(nchunks)


def compact_rows(n_rows: int, n_tiles: int, chunk: int) -> int:
    """The compacted layout's length from numbers the host knows: chunk *
    max_chunks, max_chunks = (P + T (chunk - 1)) // chunk, which the tiles'
    sum of ceil(counts / chunk) chunks cannot pass while the counts sum to
    at most the stream's P rows (the JAX package's static max_chunks)."""
    return (n_rows + n_tiles * (chunk - 1)) // chunk * chunk


def compact_offsets(counts, chunk: int) -> tuple[torch.Tensor, int]:
    """compact_starts and NC, the number of chunks the tiles own: their rows
    are the first NC * chunk of the compacted layout. Reading NC is a host
    sync; the kernel's path does not."""
    nchunks = (counts.to(torch.int64) + chunk - 1) // chunk
    return compact_starts(counts, chunk), int(nchunks.sum())


def _check_ids(sorted_gauss, rows, n: int) -> None:
    if sorted_gauss.dtype != torch.int32 or tuple(sorted_gauss.shape) != (rows.shape[0],):
        raise ValueError(f"sorted_gauss must be int32 [{rows.shape[0]}], got "
                         f"{sorted_gauss.dtype} {tuple(sorted_gauss.shape)}")
    if sorted_gauss.device != rows.device or not sorted_gauss.is_contiguous():
        raise ValueError("sorted_gauss must be contiguous, on the rows' device")
    if not 0 <= n < 2**31:
        raise ValueError(f"n must be in [0, 2^31), got {n}")


def blend_stream_bwd_compact_plain(rows, counts, tstart, toff, sorted_gauss, accum,
                                   t_final, g_accum, g_t, grid_x: int, chunk: int,
                                   n: int):
    """Plain PyTorch version of the compact backward kernel: the stream
    backward's plain version (K2's walk), its rows placed at the compacted
    offsets, the ids beside them and the tails of the last chunks written.
    Arguments and outputs as for `blend_stream_bwd_compact`; the rows past
    the tiles' range, which the kernel leaves unwritten, are zero here."""
    _check_ids(sorted_gauss, rows, n)
    d = blend_stream_bwd_plain(rows, counts, tstart, toff, accum, t_final, g_accum,
                               g_t, grid_x, chunk)
    cstart = compact_starts(counts, chunk)
    dev = rows.device
    cnt = counts.to(torch.int64)
    tile = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    k = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[tile]
    src = tstart.to(torch.int64)[tile] + k
    dst = cstart.to(torch.int64)[tile] * chunk + k
    R = compact_rows(rows.shape[0], counts.shape[0], chunk)
    d_rows = torch.zeros((R, rows.shape[1]), dtype=torch.float32, device=dev)
    d_rows[dst] = d[src]
    ids = torch.full((R,), n, dtype=torch.int32, device=dev)
    ids[dst] = sorted_gauss[src]
    return d_rows, ids


def blend_stream_bwd_compact(rows, counts, tstart, toff, sorted_gauss, accum, t_final,
                             g_accum, g_t, grid_x: int, chunk: int, n: int):
    """Per-slot gradient rows of the stream blend, compacted by chunk, with
    each row's splat id.

    rows, counts, tstart, toff, grid_x, chunk: the forward's inputs (see
    `blend_stream_fwd`); sorted_gauss [P] int32: the splat of every stream
    slot; accum, t_final: the forward's outputs; g_accum, g_t: their
    cotangents; n: the splat count. Tile t owns NC_t = ceil(counts[t] /
    chunk) chunks of the output, from chunk cstart[t] on (`compact_starts`).
    -> (d_rows [R, 6 + C] f32, ids [R] int32), R = `compact_rows(P, T,
    chunk)`, a bound known without reading the counts: row k of tile t's
    range is the gradient row of its slot tstart[t] + k (zero after the
    tile's pixels all stopped) with that slot's splat as id; rows k >=
    counts[t] are zero with id n, which `segment_reduce` drops. The tiles'
    ranges cover the first NC * chunk rows, NC = sum of NC_t; past them every
    id is n and d_rows is left unwritten by the kernel. The per-splat sums
    equal those of `blend_stream_bwd`'s rows by sorted_gauss. No host sync.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_stream_bwd_compact.launches` counts kernel launches."""
    if rows.device.type == "cpu":
        return blend_stream_bwd_compact_plain(rows, counts, tstart, toff, sorted_gauss,
                                              accum, t_final, g_accum, g_t, grid_x,
                                              chunk, n)
    if rows.device.type != "cuda":
        raise ValueError(f"blend_stream_bwd_compact runs on cpu or cuda, not "
                         f"{rows.device}")
    _check_stream(rows, counts, tstart, toff, chunk)
    _check_bwd(rows.shape[1], rows.device, counts, accum, t_final, g_accum, g_t)
    _check_ids(sorted_gauss, rows, n)
    T, F = counts.shape[0], rows.shape[1]
    if F - N_GEOM > MAX_C:
        raise ValueError(f"the kernel takes at most {MAX_C} channels, got {F - N_GEOM}")
    _check_bwd_smem(chunk, F)
    R = compact_rows(rows.shape[0], T, chunk)
    if R >= 2**31:
        raise ValueError(f"{R} compacted rows exceed int32 offsets")
    d_rows = torch.empty((R, F), dtype=torch.float32, device=rows.device)
    if T == 0:
        return d_rows, torch.full((R,), n, dtype=torch.int32, device=rows.device)
    ids = torch.empty((R,), dtype=torch.int32, device=rows.device)
    cstart = compact_starts(counts, chunk)
    _launch("og_blend_stream_bwd_compact", rows.device, rows.data_ptr(), F,
            counts.data_ptr(), tstart.data_ptr(), toff.data_ptr(), cstart.data_ptr(),
            sorted_gauss.data_ptr(), T, grid_x, chunk, n, R, accum.data_ptr(),
            t_final.data_ptr(), g_accum.data_ptr(), g_t.data_ptr(), d_rows.data_ptr(),
            ids.data_ptr())
    blend_stream_bwd_compact.launches += 1
    return d_rows, ids


blend_stream_bwd_compact.launches = 0


def _check_reduce(rows, ids, n: int) -> None:
    if (rows.dtype == torch.float32 and rows.dim() == 2 and ids.dtype == torch.int32
            and ids.dim() == 1 and ids.shape[0] == rows.shape[0] < 2**31
            and ids.device == rows.device and rows.is_contiguous()
            and ids.is_contiguous() and 0 <= n < 2**31):
        return  # one test on the hot path; the messages below say what failed
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(f"rows must be float32 [R, F], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (rows.shape[0],):
        raise ValueError(f"ids must be int32 [{rows.shape[0]}], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if ids.device != rows.device:
        raise ValueError(f"ids is on {ids.device}, rows on {rows.device}")
    if not (rows.is_contiguous() and ids.is_contiguous()):
        raise ValueError("rows and ids must be contiguous")
    raise ValueError(f"n must be in [0, 2^31) and R below 2^31, got n={n}, "
                     f"R={rows.shape[0]}")


def segment_reduce_plain(rows, ids, n: int):
    """Plain PyTorch version of the reduce kernel: index_add_ of the rows
    whose id lies in [0, n). Arguments and output as for `segment_reduce`."""
    _check_reduce(rows, ids, n)
    keep = (ids >= 0) & (ids < n)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, ids[keep].to(torch.int64), rows[keep])


def segment_reduce(rows, ids, n: int):
    """Sum rows [R, F] f32 into [n, F] by ids [R] int32; rows whose id is
    outside [0, n) are dropped.

    CPU tensors run the plain version; CUDA tensors launch the kernel, whose
    atomic adds sum in an order that changes from run to run
    (RasterizeConfig(reduce_backend="scatter")).
    `segment_reduce.launches` counts the kernel's launches."""
    dev = rows.device
    if dev.type == "cpu":
        return segment_reduce_plain(rows, ids, n)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce runs on cpu or cuda, not {dev}")
    _check_reduce(rows, ids, n)
    R, F = rows.shape
    # the C entry zero-fills out on the stream before it adds the rows
    out = torch.empty((n, F), dtype=torch.float32, device=dev)
    if R == 0 or n * F == 0:
        return out.zero_()
    _launch("og_segment_reduce", dev, rows.data_ptr(), ids.data_ptr(), R, F, n,
            out.data_ptr())
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0


def segment_reduce_sorted(rows, ids, n: int, out=None):
    """`segment_reduce` in a fixed order: the ids sorted stably, then one
    thread per id sums its rows in row order. The sums repeat bit for bit
    and equal the plain version's on the CPU. Arguments as for
    `segment_reduce`; out: an [n, F] f32 tensor to add into (index_add_'s
    order: each id's sum starts from its value in out), else a new one.
    CPU tensors run the plain version (index_add_).
    `segment_reduce_sorted.launches` counts kernel launches."""
    dev = rows.device
    if out is not None and (out.dtype != torch.float32 or out.device != dev
                            or tuple(out.shape) != (n, rows.shape[-1])
                            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 [{n}, {rows.shape[-1]}] on "
                         f"{dev}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if dev.type == "cpu":
        if out is None:
            return segment_reduce_plain(rows, ids, n)
        _check_reduce(rows, ids, n)
        keep = (ids >= 0) & (ids < n)
        return out.index_add_(0, ids[keep].to(torch.int64), rows[keep])
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_sorted runs on cpu or cuda, not {dev}")
    _check_reduce(rows, ids, n)
    R, F = rows.shape
    acc = out is not None
    if not acc:
        out = torch.empty((n, F), dtype=torch.float32, device=dev)
    if R == 0 or n * F == 0:
        return out if acc else out.zero_()
    keys, order = torch.sort(ids, stable=True)
    _launch("og_segment_reduce_sorted", dev, rows.data_ptr(), keys.data_ptr(),
            order.data_ptr(), R, F, n, int(acc), out.data_ptr())
    segment_reduce_sorted.launches += 1
    return out


segment_reduce_sorted.launches = 0


def _check_perm(rows, pos, ends, n: int, groups: int) -> None:
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous float32 [G R, F], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if groups <= 0 or rows.shape[0] % groups or rows.shape[0] // groups >= 2**31:
        raise ValueError(f"{rows.shape[0]} rows do not split into {groups} groups of "
                         "fewer than 2^31")
    for nm, x, shape in (("pos", pos, (pos.shape[0],)), ("ends", ends, (n,))):
        if (x.dtype != torch.int32 or x.dim() != 1 or tuple(x.shape) != shape
                or x.device != rows.device or not x.is_contiguous()):
            raise ValueError(f"{nm} must be contiguous int32 {list(shape)} on the rows' "
                             f"device, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not 0 <= n < 2**31 or pos.shape[0] >= 2**31:
        raise ValueError(f"n and the length of pos must be below 2^31, got n={n}, "
                         f"{pos.shape[0]}")


def segment_reduce_perm_plain(rows, pos, ends, n: int, groups: int = 1):
    """Plain PyTorch version of the permutation entry: index_add_ of
    rows[pos] by the splat of each expanded slot, in expansion order,
    once per group. Arguments and output as for `segment_reduce_perm`."""
    _check_perm(rows, pos, ends, n, groups)
    dev, F = rows.device, rows.shape[1]
    p = torch.arange(pos.shape[0], device=dev)
    splat = torch.searchsorted(ends.to(torch.int64), p, right=True)
    keep = (splat < n) & (pos >= 0)
    idx, src = splat[keep], pos[keep].to(torch.int64)
    out = torch.zeros((groups, n, F), dtype=torch.float32, device=dev)
    for g, rows_g in enumerate(rows.reshape(groups, -1, F)):
        out[g].index_add_(0, idx, rows_g[src])
    return out.reshape(groups * n, F)


def segment_reduce_perm(rows, pos, ends, n: int, groups: int = 1):
    """`segment_reduce` in the binning's fixed order, with no sort.

    rows [G R, F] f32: G groups of R rows (the slots' gradient rows at their
    stream positions, or compacted); pos [L] int32: the row of each
    expanded slot within its group's R, or < 0 for none
    (`TileBins.slot_pos`, the inverse of the binning's sort); ends [n]
    int32: splat i owns expanded slots [ends[i - 1], ends[i]) (ends[-1] =
    0; `TileBins.splat_end`). -> [G n, F]: row g n + i sums group g's rows
    of splat i in the order of its slots. Where each splat's live slots
    lie in ascending stream order and every other row is zero (the binned
    stream's), the sums equal `segment_reduce_sorted`'s by the stream's ids
    bit for bit, and repeat from run to run.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `segment_reduce_perm.launches` counts kernel launches."""
    dev = rows.device
    if dev.type == "cpu":
        return segment_reduce_perm_plain(rows, pos, ends, n, groups)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_perm runs on cpu or cuda, not {dev}")
    _check_perm(rows, pos, ends, n, groups)
    F = rows.shape[1]
    out = torch.empty((groups * n, F), dtype=torch.float32, device=dev)
    if n * F == 0:
        return out
    _launch("og_segment_reduce_perm", dev, rows.data_ptr(), pos.data_ptr(), ends.data_ptr(),
            rows.shape[0] // groups, F, n, groups, out.data_ptr())
    segment_reduce_perm.launches += 1
    return out


segment_reduce_perm.launches = 0


def compact_positions(tstart, counts, chunk: int, n_rows: int) -> torch.Tensor:
    """The compact layout's row of each stream position: [n_rows] int32,
    cstart[t] * chunk + k for slot tstart[t] + k of tile t (k < counts[t]),
    -1 for a slot no tile walks. tstart must not decrease (the binned
    stream's, windows and bands included). No host sync."""
    q = torch.arange(n_rows, device=counts.device)
    t = torch.searchsorted(tstart.to(torch.int64), q, right=True) - 1
    ts = torch.clamp(t, min=0)
    k = q - tstart.to(torch.int64)[ts]
    live = (t >= 0) & (k < counts.to(torch.int64)[ts])
    row = compact_starts(counts, chunk).to(torch.int64)[ts] * chunk + k
    return torch.where(live, row, -1).to(torch.int32)


def _check_dense(gdata, counts, chunk: int) -> None:
    if gdata.dtype != torch.float32 or gdata.dim() != 3 or gdata.shape[2] <= N_GEOM:
        raise ValueError(f"gdata must be float32 [T, K, {N_GEOM}+C], got "
                         f"{gdata.dtype} {tuple(gdata.shape)}")
    T, K, _ = gdata.shape
    if counts.dtype != torch.int32 or tuple(counts.shape) != (T,):
        raise ValueError(f"counts must be int32 [{T}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if counts.device != gdata.device:
        raise ValueError(f"counts is on {counts.device}, gdata on {gdata.device}")
    if not (gdata.is_contiguous() and counts.is_contiguous()):
        raise ValueError("gdata and counts must be contiguous")
    if chunk <= 0 or K % chunk:
        raise ValueError(f"max_per_tile must be a multiple of chunk, got K={K}, "
                         f"chunk={chunk}")
    if T * K >= 2**31:
        raise ValueError(f"a dense block of {T} x {K} slots exceeds int32 offsets")


def _strided(gdata, counts, tile_offset: int):
    """The dense block as the stream whose tile t starts at t * K:
    -> (rows [T*K, F], counts clamped at K, tstart, toff), each [T] int32."""
    T, K, F = gdata.shape
    ar = torch.arange(T, dtype=torch.int32, device=gdata.device)
    return (gdata.reshape(T * K, F), torch.clamp(counts, max=K), ar * K,
            ar + tile_offset)


def blend_tiles_fwd_plain(gdata, counts, grid_x: int, chunk: int, tile_offset: int = 0,
                          count_work: bool = False):
    """Plain PyTorch version of the dense forward kernel: the stream forward's
    plain version over the strided stream, which is what the kernel walks.
    Arguments and outputs as for `blend_tiles_fwd`; count_work as for
    `blend_stream_fwd_plain`."""
    _check_dense(gdata, counts, chunk)
    return blend_stream_fwd_plain(*_strided(gdata, counts, tile_offset), grid_x, chunk,
                                  count_work)


def blend_tiles_fwd(gdata, counts, grid_x: int, chunk: int, tile_offset: int = 0):
    """Forward blend of a dense block of gathered rows.

    gdata [T, K, 6+C] f32: row k of tile t is the k-th slot of its
    depth-ordered run (mean2d x/y, conic a/b/c, opacity, C payload channels);
    rows k >= counts[t] are not read. counts [T] int32 (clamped at K).
    Tile t shades the pixels of image tile t + tile_offset. K must be a
    multiple of chunk. -> (accum [T, C, 256], t_final [T, 256]).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_tiles_fwd.launches` counts kernel launches."""
    if gdata.device.type == "cpu":
        return blend_tiles_fwd_plain(gdata, counts, grid_x, chunk, tile_offset)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_tiles_fwd runs on cpu or cuda, not {gdata.device}")
    _check_dense(gdata, counts, chunk)
    T, K, F = gdata.shape
    C = F - N_GEOM
    if C > MAX_C:
        raise ValueError(f"the kernel blends at most {MAX_C} channels, got {C}")
    _check_fwd_smem(chunk, F)
    accum = torch.empty((T, C, NPIX), dtype=torch.float32, device=gdata.device)
    t_final = torch.empty((T, NPIX), dtype=torch.float32, device=gdata.device)
    if T == 0:
        return accum, t_final
    _launch("og_blend_tiles_fwd", gdata.device, gdata.data_ptr(), T, K, F,
            counts.data_ptr(), tile_offset, grid_x, chunk, accum.data_ptr(),
            t_final.data_ptr())
    blend_tiles_fwd.launches += 1
    return accum, t_final


blend_tiles_fwd.launches = 0


def _check_starts(tstart, counts, n_rows: int) -> None:
    if tstart.dtype != torch.int32 or tstart.shape != counts.shape:
        raise ValueError(f"tstart must be int32 [{counts.shape[0]}], got {tstart.dtype} "
                         f"{tuple(tstart.shape)}")
    if tstart.device != counts.device or not tstart.is_contiguous():
        raise ValueError("tstart must be contiguous, on the counts' device")
    if not 0 <= n_rows < 2**31:
        raise ValueError(f"n_rows must be in [0, 2^31), got {n_rows}")


def blend_tiles_bwd_plain(gdata, counts, tstart, n_rows: int, accum, t_final, g_accum,
                          g_t, grid_x: int, chunk: int, tile_offset: int = 0,
                          count_work: bool = False):
    """Plain PyTorch version of the dense backward kernel: the stream
    backward's plain version over the strided stream, its live rows then
    placed at their stream positions. Arguments and output as for
    `blend_tiles_bwd`; count_work as for `blend_stream_bwd_plain`."""
    _check_dense(gdata, counts, chunk)
    _check_starts(tstart, counts, n_rows)
    T, K, F = gdata.shape
    out = blend_stream_bwd_plain(*_strided(gdata, counts, tile_offset), accum, t_final,
                                 g_accum, g_t, grid_x, chunk, count_work)
    d_slot = out[0] if count_work else out
    dev = gdata.device
    cnt = torch.clamp(counts, max=K).to(torch.int64)
    tile = torch.repeat_interleave(torch.arange(T, device=dev), cnt)
    k = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[tile]
    d_rows = torch.zeros((n_rows, F), dtype=torch.float32, device=dev)
    d_rows[tstart.to(torch.int64)[tile] + k] = d_slot[tile * K + k]
    return (d_rows, out[1]) if count_work else d_rows


def blend_tiles_bwd(gdata, counts, tstart, n_rows: int, accum, t_final, g_accum, g_t,
                    grid_x: int, chunk: int, tile_offset: int = 0):
    """Per-slot gradient rows of the dense-block blend, at the slots' stream
    positions.

    gdata, counts, grid_x, chunk, tile_offset: the forward's inputs (see
    `blend_tiles_fwd`); tstart [T] int32: the position in the sorted slot
    stream of each tile's first slot (`TileBins.tile_start`, from which the
    dense layout gathered row t); n_rows: the stream's length P; accum
    [T, C, 256], t_final [T, 256]: the forward's outputs; g_accum
    [T, C, 256], g_t [T, 256]: their cotangents. -> d_rows [P, 6 + C] f32:
    slot k < counts[t] of tile t gets, at row tstart[t] + k, the loss
    gradient by its row's fields (mean2d 2, conic 3, opacity 1, payload C)
    summed over the tile's pixels (`blend_stream_bwd`'s output for the
    stream the block was gathered from); zero for rows no tile walks. The
    runs tstart[t] + [0, counts[t]) must be disjoint and inside [0, P), as
    the binned stream's are. Only the live rows are written: nothing of
    T x K x (6 + C) size is allocated, and the per-splat reduce takes the
    stream's ids.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_tiles_bwd.launches` counts kernel launches."""
    if gdata.device.type == "cpu":
        return blend_tiles_bwd_plain(gdata, counts, tstart, n_rows, accum, t_final,
                                     g_accum, g_t, grid_x, chunk, tile_offset)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_tiles_bwd runs on cpu or cuda, not {gdata.device}")
    _check_dense(gdata, counts, chunk)
    _check_starts(tstart, counts, n_rows)
    T, K, F = gdata.shape
    _check_bwd(F, gdata.device, counts, accum, t_final, g_accum, g_t)
    if F - N_GEOM > MAX_C:
        raise ValueError(f"the kernel takes at most {MAX_C} channels, got {F - N_GEOM}")
    _check_bwd_smem(chunk, F)
    d_rows = torch.zeros((n_rows, F), dtype=torch.float32, device=gdata.device)
    if T == 0:
        return d_rows
    _launch("og_blend_tiles_bwd", gdata.device, gdata.data_ptr(), T, K, F,
            counts.data_ptr(), tstart.data_ptr(), tile_offset, grid_x, chunk,
            accum.data_ptr(), t_final.data_ptr(), g_accum.data_ptr(), g_t.data_ptr(),
            d_rows.data_ptr())
    blend_tiles_bwd.launches += 1
    return d_rows


blend_tiles_bwd.launches = 0


def _check_groups(gdata, gauss_idx, opac_g) -> None:
    T, K, _ = gdata.shape
    if gauss_idx.dtype != torch.int32 or tuple(gauss_idx.shape) != (T, K):
        raise ValueError(f"gauss_idx must be int32 [{T}, {K}], got {gauss_idx.dtype} "
                         f"{tuple(gauss_idx.shape)}")
    if opac_g.dtype != torch.float32 or opac_g.dim() != 2:
        raise ValueError(f"opac_g must be float32 [G, N], got {opac_g.dtype} "
                         f"{tuple(opac_g.shape)}")
    for nm, x in (("gauss_idx", gauss_idx), ("opac_g", opac_g)):
        if x.device != gdata.device or not x.is_contiguous():
            raise ValueError(f"{nm} must be contiguous, on gdata's device")


def _group_block(gdata, gauss_idx, opac_g, g: int):
    """The block whose opacity column is group g's: opac_g[g, gauss_idx]."""
    block = gdata.clone()
    block[..., 5] = opac_g[g][gauss_idx.to(torch.int64)]
    return block


def blend_tiles_fwd_groups_plain(gdata, gauss_idx, opac_g, counts, grid_x: int,
                                 chunk: int, tile_offset: int = 0):
    """Plain PyTorch version of the group entry of the dense forward kernel:
    `blend_tiles_fwd_plain` once per group, on the block whose opacity
    column is that group's. Arguments and outputs as for
    `blend_tiles_fwd_groups`."""
    _check_dense(gdata, counts, chunk)
    _check_groups(gdata, gauss_idx, opac_g)
    outs = [blend_tiles_fwd_plain(_group_block(gdata, gauss_idx, opac_g, g), counts,
                                  grid_x, chunk, tile_offset)
            for g in range(opac_g.shape[0])]
    T, _, F = gdata.shape
    if not outs:
        return (gdata.new_zeros((0, T, F - N_GEOM, NPIX)), gdata.new_zeros((0, T, NPIX)))
    return torch.stack([a for a, _ in outs]), torch.stack([t for _, t in outs])


def blend_tiles_fwd_groups(gdata, gauss_idx, opac_g, counts, grid_x: int, chunk: int,
                           tile_offset: int = 0):
    """Forward blend of one dense block once per group of opacities.

    gdata [T, K, 6+C], counts [T], grid_x, chunk, tile_offset: as for
    `blend_tiles_fwd`; gdata's opacity column is not read. gauss_idx [T, K]
    int32: the splat of each row (`TileBins.gauss_idx`); opac_g [G, N] f32:
    each group's opacity by splat. Group g blends the block with row k of
    tile t at opacity opac_g[g, gauss_idx[t, k]]. -> (accum [G, T, C, 256],
    t_final [G, T, 256]).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_tiles_fwd_groups.launches` counts kernel launches."""
    if gdata.device.type == "cpu":
        return blend_tiles_fwd_groups_plain(gdata, gauss_idx, opac_g, counts, grid_x,
                                            chunk, tile_offset)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_tiles_fwd_groups runs on cpu or cuda, not {gdata.device}")
    _check_dense(gdata, counts, chunk)
    _check_groups(gdata, gauss_idx, opac_g)
    T, K, F = gdata.shape
    G, N = opac_g.shape
    if F - N_GEOM > MAX_C:
        raise ValueError(f"the kernel blends at most {MAX_C} channels, got {F - N_GEOM}")
    if G > 65535:
        raise ValueError(f"at most 65535 groups, got {G}")
    _check_fwd_smem(chunk, F)
    accum = torch.empty((G, T, F - N_GEOM, NPIX), dtype=torch.float32, device=gdata.device)
    t_final = torch.empty((G, T, NPIX), dtype=torch.float32, device=gdata.device)
    if T == 0 or G == 0:
        return accum, t_final
    _launch("og_blend_tiles_fwd_groups", gdata.device, gdata.data_ptr(), T, K, F,
            counts.data_ptr(), gauss_idx.data_ptr(), opac_g.data_ptr(), G, N, tile_offset,
            grid_x, chunk, accum.data_ptr(), t_final.data_ptr())
    blend_tiles_fwd_groups.launches += 1
    return accum, t_final


blend_tiles_fwd_groups.launches = 0


def blend_tiles_bwd_groups_plain(gdata, gauss_idx, opac_g, counts, tstart, n_rows: int,
                                 accum, t_final, g_accum, g_t, grid_x: int, chunk: int,
                                 tile_offset: int = 0):
    """Plain PyTorch version of the group entry of the dense backward kernel:
    `blend_tiles_bwd_plain` once per group, on the block whose opacity
    column is that group's. Arguments and output as for
    `blend_tiles_bwd_groups`."""
    _check_dense(gdata, counts, chunk)
    _check_groups(gdata, gauss_idx, opac_g)
    outs = [blend_tiles_bwd_plain(_group_block(gdata, gauss_idx, opac_g, g), counts,
                                  tstart, n_rows, accum[g], t_final[g], g_accum[g], g_t[g],
                                  grid_x, chunk, tile_offset)
            for g in range(opac_g.shape[0])]
    if not outs:
        return gdata.new_zeros((0, n_rows, gdata.shape[2]))
    return torch.stack(outs)


def blend_tiles_bwd_groups(gdata, gauss_idx, opac_g, counts, tstart, n_rows: int, accum,
                           t_final, g_accum, g_t, grid_x: int, chunk: int,
                           tile_offset: int = 0):
    """Per-slot gradient rows of `blend_tiles_fwd_groups`, one slab of the
    stream per group.

    gdata, gauss_idx, opac_g, counts, grid_x, chunk, tile_offset: the
    forward's inputs; tstart, n_rows: as for `blend_tiles_bwd`; accum
    [G, T, C, 256], t_final [G, T, 256]: the forward's outputs; g_accum,
    g_t: their cotangents. -> d_rows [G, P, 6 + C] f32: slab g is
    `blend_tiles_bwd`'s output for group g's block (its opacity column
    opac_g[g, gauss_idx]); its opacity column is the gradient by the group's
    opacity.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_tiles_bwd_groups.launches` counts kernel launches."""
    if gdata.device.type == "cpu":
        return blend_tiles_bwd_groups_plain(gdata, gauss_idx, opac_g, counts, tstart,
                                            n_rows, accum, t_final, g_accum, g_t, grid_x,
                                            chunk, tile_offset)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_tiles_bwd_groups runs on cpu or cuda, not {gdata.device}")
    _check_dense(gdata, counts, chunk)
    _check_groups(gdata, gauss_idx, opac_g)
    _check_starts(tstart, counts, n_rows)
    T, K, F = gdata.shape
    G, N = opac_g.shape
    for nm, x, shape in (("accum", accum, (G, T, F - N_GEOM, NPIX)),
                         ("t_final", t_final, (G, T, NPIX)),
                         ("g_accum", g_accum, (G, T, F - N_GEOM, NPIX)),
                         ("g_t", g_t, (G, T, NPIX))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != gdata.device
                or not x.is_contiguous()):
            raise ValueError(f"{nm} must be contiguous float32 {list(shape)} on gdata's "
                             f"device, got {x.dtype} {tuple(x.shape)}")
    if F - N_GEOM > MAX_C:
        raise ValueError(f"the kernel takes at most {MAX_C} channels, got {F - N_GEOM}")
    if G > 65535:
        raise ValueError(f"at most 65535 groups, got {G}")
    _check_bwd_smem(chunk, F)
    d_rows = torch.zeros((G, n_rows, F), dtype=torch.float32, device=gdata.device)
    if T == 0 or G == 0:
        return d_rows
    _launch("og_blend_tiles_bwd_groups", gdata.device, gdata.data_ptr(), T, K, F,
            counts.data_ptr(), tstart.data_ptr(), gauss_idx.data_ptr(), opac_g.data_ptr(),
            G, N, n_rows, tile_offset, grid_x, chunk, accum.data_ptr(), t_final.data_ptr(),
            g_accum.data_ptr(), g_t.data_ptr(), d_rows.data_ptr())
    blend_tiles_bwd_groups.launches += 1
    return d_rows


blend_tiles_bwd_groups.launches = 0


# every kernel wrapper, with its launch counter (a captured training step
# adds its launches to these on each replay)
KERNEL_WRAPPERS = (blend_stream_fwd, blend_stream_bwd, blend_stream_bwd_compact,
                   segment_reduce, segment_reduce_sorted, segment_reduce_perm,
                   blend_tiles_fwd, blend_tiles_bwd, blend_tiles_fwd_groups,
                   blend_tiles_bwd_groups, *geometry_kernels.KERNEL_WRAPPERS,
                   *mask_loss_kernels.KERNEL_WRAPPERS)

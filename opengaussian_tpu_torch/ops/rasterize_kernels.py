"""The rasterizer's hand-written CUDA kernels and their plain versions.

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
  * `segment_reduce` (csrc/segment_reduce.cu) is the counterpart of
    `sorted_segment_reduce`: the per-splat sum of those rows.
  * `blend_tiles_fwd` (csrc/blend_tiles_fwd.cu) and `blend_tiles_bwd`
    (csrc/blend_tiles_bwd.cu) are the counterparts of `blend_tiles_pallas_fwd`
    and `blend_tiles_pallas_bwd`: the same blend and replay over a dense
    [T, K, 6 + C] block of gathered rows (the dense input layout). A dense
    block is a stream whose tile t starts at t * K, so the stream kernels and
    the dense ones share their walk (csrc/blend_tile.cuh), and the dense
    plain versions are the stream plain versions over that strided stream.

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

from opengaussian_tpu_torch.ops import blend
from opengaussian_tpu_torch.ops.projection import TILE

NPIX = TILE * TILE  # pixels per tile, one CUDA thread each
N_GEOM = 6  # row columns before the payload: mean2d 2, conic 3, opacity 1
WARP = 32

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_C = 16  # payload channels one thread holds: kMaxC in the blend sources

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> (source stem, argument types); each returns a cudaError_t
_ENTRIES = {
    "og_blend_stream_fwd": ("blend_stream_fwd", [_p, _i, _p, _p, _p, _i, _i, _i, _p, _p, _p]),
    "og_blend_stream_bwd": ("blend_stream_bwd", [_p, _i, _p, _p, _p, _i, _i, _i,
                                                 _p, _p, _p, _p, _p, _p]),
    "og_blend_stream_bwd_compact": ("blend_stream_bwd_compact",
                                    [_p, _i, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                     _p, _p, _p, _p, _p, _p, _p]),
    "og_segment_reduce": ("segment_reduce", [_p, _p, _ll, _i, _i, _p, _p]),
    "og_blend_tiles_fwd": ("blend_tiles_fwd", [_p, _i, _i, _i, _p, _i, _i, _i, _p, _p,
                                               _p]),
    "og_blend_tiles_bwd": ("blend_tiles_bwd", [_p, _i, _i, _i, _p, _i, _i, _i,
                                               _p, _p, _p, _p, _p, _p]),
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
    with torch.cuda.device(device):
        err = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
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


def blend_stream_fwd_plain(rows, counts, tstart, toff, grid_x: int, chunk: int,
                           count_work: bool = False):
    """Plain PyTorch version of the kernel: vectorized over tiles and pixels,
    a loop over chunks of each run and, inside a chunk, over its slots in
    depth order. Same operations in the same order as the kernel, so both
    round alike. Arguments and outputs as for `blend_stream_fwd`.

    With count_work, also returns the work this stream's data needs, as
    (slot, pixel) pair counts: {"evaluated": alpha computed (every slot a
    pixel walks, up to and including the one that stops it), "tested":
    alpha >= 1/255, so the transmittance test ran, "blended": the pair
    composited its payload}."""
    _check_stream(rows, counts, tstart, toff, chunk)
    dev = rows.device
    T = counts.shape[0]
    C = rows.shape[1] - N_GEOM
    px, py = _pixels(toff, grid_x, dev)

    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    acc = torch.zeros((T, NPIX, C), dtype=torch.float32, device=dev)
    work = {k: torch.zeros((T, NPIX), dtype=torch.int64, device=dev)
            for k in ("evaluated", "tested", "blended")}
    counts = counts.to(torch.int64)
    start = tstart.to(torch.int64)
    max_count = int(counts.max()) if T else 0
    for base in range(0, max_count, chunk):
        if bool(done.all()):
            break
        kmask, _, g, _, _, _, _, a = _chunk_alpha(rows, counts, start, base,
                                                  chunk, px, py)
        for j in range(min(chunk, max_count - base)):
            aj = a[:, j]  # [T, NPIX]
            t_next = trans * (1.0 - aj)
            stop = t_next < blend.T_EPS
            contrib = (aj > 0.0) & ~stop & ~done
            if count_work:
                work["evaluated"] += kmask[:, j, None] & ~done
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
    if chunk * F * 4 > 48 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds 48 KiB of "
                         "shared memory")
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

    With count_work, also returns the pair counts of the replay:
    {"evaluated": alpha computed again, "tested": alpha >= 1/255,
    "blended": the pair composited, so it has gradient terms}."""
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
    work = {k: torch.zeros((T, NPIX), dtype=torch.int64, device=dev)
            for k in ("evaluated", "tested", "blended")}
    counts = counts.to(torch.int64)
    start = tstart.to(torch.int64)
    max_count = int(counts.max()) if T else 0
    floor = 1.0 - blend.ALPHA_MAX  # rounds to 0.01f, as in the kernel
    for base in range(0, max_count, chunk):
        if bool(done.all()):
            break
        kmask, idx, g, dx, dy, gauss, araw, a = _chunk_alpha(
            rows, counts, start, base, chunk, px, py)
        for j in range(min(chunk, max_count - base)):
            aj = a[:, j]
            t_next = trans * (1.0 - aj)
            stop = t_next < blend.T_EPS
            contrib = (aj > 0.0) & ~stop & ~done
            if count_work:
                work["evaluated"] += kmask[:, j, None] & ~done
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
    pixels of its tile; zero for slots no tile walks.

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
    if (1 + NPIX // WARP) * chunk * F * 4 > 227 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds the shared memory "
                         "of a block")
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


def compact_offsets(counts, chunk: int) -> tuple[torch.Tensor, int]:
    """Each tile's first chunk in the compacted layout: cstart [T] int32, the
    exclusive cumsum of ceil(counts / chunk), and NC, the number of chunks
    (a host sync)."""
    nchunks = (counts.to(torch.int64) + chunk - 1) // chunk
    ends = torch.cumsum(nchunks, 0)
    nc = int(ends[-1]) if counts.numel() else 0
    return (ends - nchunks).to(torch.int32), nc


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
    Arguments and outputs as for `blend_stream_bwd_compact`."""
    _check_ids(sorted_gauss, rows, n)
    d = blend_stream_bwd_plain(rows, counts, tstart, toff, accum, t_final, g_accum,
                               g_t, grid_x, chunk)
    cstart, nc = compact_offsets(counts, chunk)
    dev = rows.device
    cnt = counts.to(torch.int64)
    tile = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
    k = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[tile]
    src = tstart.to(torch.int64)[tile] + k
    dst = cstart.to(torch.int64)[tile] * chunk + k
    d_rows = torch.zeros((nc * chunk, rows.shape[1]), dtype=torch.float32, device=dev)
    d_rows[dst] = d[src]
    ids = torch.full((nc * chunk,), n, dtype=torch.int32, device=dev)
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
    chunk) chunks of the output, from chunk cstart[t] on (`compact_offsets`).
    -> (d_rows [NC * chunk, 6 + C] f32, ids [NC * chunk] int32), NC =
    sum of NC_t: row k of tile t's range is the gradient row of its slot
    tstart[t] + k (zero after the tile's pixels all stopped) with that
    slot's splat as id; rows k >= counts[t] are zero with id n, which
    `segment_reduce` drops. The per-splat sums equal those of
    `blend_stream_bwd`'s rows by sorted_gauss.

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
    if (1 + NPIX // WARP) * chunk * F * 4 > 227 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds the shared memory "
                         "of a block")
    cstart, nc = compact_offsets(counts, chunk)
    d_rows = torch.empty((nc * chunk, F), dtype=torch.float32, device=rows.device)
    ids = torch.empty((nc * chunk,), dtype=torch.int32, device=rows.device)
    if T == 0:
        return d_rows, ids
    _launch("og_blend_stream_bwd_compact", rows.device, rows.data_ptr(), F,
            counts.data_ptr(), tstart.data_ptr(), toff.data_ptr(), cstart.data_ptr(),
            sorted_gauss.data_ptr(), T, grid_x, chunk, n, accum.data_ptr(),
            t_final.data_ptr(), g_accum.data_ptr(), g_t.data_ptr(), d_rows.data_ptr(),
            ids.data_ptr())
    blend_stream_bwd_compact.launches += 1
    return d_rows, ids


blend_stream_bwd_compact.launches = 0


def _check_reduce(rows, ids, n: int) -> None:
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
    if not 0 <= n < 2**31:
        raise ValueError(f"n must be in [0, 2^31), got {n}")


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
    atomic adds sum in an order that changes from run to run.
    `segment_reduce.launches` counts kernel launches."""
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, ids, n)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on cpu or cuda, not {rows.device}")
    _check_reduce(rows, ids, n)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if rows.numel() == 0 or n == 0:
        return out
    _launch("og_segment_reduce", rows.device, rows.data_ptr(), ids.data_ptr(),
            rows.shape[0], rows.shape[1], n, out.data_ptr())
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0


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
    if chunk * F * 4 > 48 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds 48 KiB of "
                         "shared memory")
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


def blend_tiles_bwd_plain(gdata, counts, accum, t_final, g_accum, g_t, grid_x: int,
                          chunk: int, tile_offset: int = 0, count_work: bool = False):
    """Plain PyTorch version of the dense backward kernel: the stream
    backward's plain version over the strided stream. Arguments and output as
    for `blend_tiles_bwd`; count_work as for `blend_stream_bwd_plain`."""
    _check_dense(gdata, counts, chunk)
    out = blend_stream_bwd_plain(*_strided(gdata, counts, tile_offset), accum, t_final,
                                 g_accum, g_t, grid_x, chunk, count_work)
    if count_work:
        return out[0].view(gdata.shape), out[1]
    return out.view(gdata.shape)


def blend_tiles_bwd(gdata, counts, accum, t_final, g_accum, g_t, grid_x: int,
                    chunk: int, tile_offset: int = 0):
    """Per-slot gradient rows of the dense-block blend.

    gdata, counts, grid_x, chunk, tile_offset: the forward's inputs (see
    `blend_tiles_fwd`); accum [T, C, 256], t_final [T, 256]: its outputs;
    g_accum [T, C, 256], g_t [T, 256]: their cotangents. -> d_slot
    [T, K, 6 + C] f32: slot k of tile t gets the loss gradient by its row's
    fields (mean2d 2, conic 3, opacity 1, payload C) summed over the tile's
    pixels; zero for k >= counts[t] and for slots the walk did not reach.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    `blend_tiles_bwd.launches` counts kernel launches."""
    if gdata.device.type == "cpu":
        return blend_tiles_bwd_plain(gdata, counts, accum, t_final, g_accum, g_t,
                                     grid_x, chunk, tile_offset)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_tiles_bwd runs on cpu or cuda, not {gdata.device}")
    _check_dense(gdata, counts, chunk)
    T, K, F = gdata.shape
    _check_bwd(F, gdata.device, counts, accum, t_final, g_accum, g_t)
    if F - N_GEOM > MAX_C:
        raise ValueError(f"the kernel takes at most {MAX_C} channels, got {F - N_GEOM}")
    if (1 + NPIX // WARP) * chunk * F * 4 > 227 * 1024:
        raise ValueError(f"chunk {chunk} x {F} fields exceeds the shared memory "
                         "of a block")
    d_slot = torch.zeros_like(gdata)
    if T == 0:
        return d_slot
    _launch("og_blend_tiles_bwd", gdata.device, gdata.data_ptr(), T, K, F,
            counts.data_ptr(), tile_offset, grid_x, chunk, accum.data_ptr(),
            t_final.data_ptr(), g_accum.data_ptr(), g_t.data_ptr(), d_slot.data_ptr())
    blend_tiles_bwd.launches += 1
    return d_slot


blend_tiles_bwd.launches = 0

"""The rasterizer's hand-written CUDA kernels and their plain versions.

`blend_stream_fwd` is the counterpart of the JAX package's Pallas kernel
`opengaussian_tpu/ops/rasterize_pallas.py:blend_stream_pallas_fwd`: the
forward alpha blend of every tile's depth-sorted run out of the slot
stream. Its CUDA source is `csrc/blend_stream_fwd.cu` (the bound on the card
and the design are noted there).

The wrapper dispatches on the device of its inputs: a CPU tensor runs
`blend_stream_fwd_plain`, the same arithmetic in plain PyTorch; a CUDA
tensor launches the kernel, or raises. It never falls back.

The kernel is compiled with nvcc for sm_90a at first use into
`csrc/build/` (one shared library with a plain C entry point, loaded with
ctypes) and keyed by the source's hash, so an edited source rebuilds.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_C = 16  # payload channels one thread accumulates: kMaxC in the source
SOURCE = CSRC / "blend_stream_fwd.cu"

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile csrc/blend_stream_fwd.cu into a shared library unless a build
    of the same source exists. -> (library path, compiler output; "" if
    cached)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libblend_stream_fwd_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.og_blend_stream_fwd.argtypes = [p, i, p, p, p, i, i, i, p, p, p]
        lib.og_blend_stream_fwd.restype = i
        _lib = lib
    return _lib


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
    lane = torch.arange(NPIX, device=dev)
    toff = toff.to(torch.int64)
    px = ((toff % grid_x) * TILE)[:, None] + (lane % TILE)[None, :]
    py = ((toff // grid_x) * TILE)[:, None] + (lane // TILE)[None, :]
    px = px.to(torch.float32)[:, None, :]  # [T, 1, NPIX]
    py = py.to(torch.float32)[:, None, :]

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
        k = base + torch.arange(chunk, device=dev)
        kmask = k[None, :] < counts[:, None]  # [T, chunk]
        idx = torch.where(kmask, start[:, None] + k[None, :], 0)
        g = rows[idx]  # [T, chunk, F]
        dx = g[..., 0:1] - px  # [T, chunk, NPIX]
        dy = g[..., 1:2] - py
        power = (-0.5 * (g[..., 2:3] * dx * dx + g[..., 4:5] * dy * dy)
                 - g[..., 3:4] * dx * dy)
        gauss = torch.exp(torch.clamp(power, max=0.0))
        araw = torch.where(power <= 0.0, g[..., 5:6] * gauss, 0.0)
        a = torch.clamp(araw, max=blend.ALPHA_MAX)
        a = torch.where((a >= blend.ALPHA_MIN) & kmask[..., None], a, 0.0)
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
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _load().og_blend_stream_fwd(
            rows.data_ptr(), F, counts.data_ptr(), tstart.data_ptr(),
            toff.data_ptr(), T, grid_x, chunk, accum.data_ptr(),
            t_final.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_stream_fwd launch failed: cudaError {err}")
    blend_stream_fwd.launches += 1
    return accum, t_final


blend_stream_fwd.launches = 0

"""COLMAP sparse-reconstruction parsers (binary and text).

Standalone numpy decoding of COLMAP's cameras/images/points3D files —
functional equivalent of the reference's parser
(reference scene/colmap_loader.py:83-294), written against the documented
COLMAP binary format. Only the fields the pipeline consumes are kept.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] (w,x,y,z) world->cam rotation
    tvec: np.ndarray  # [3] world->cam translation
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            img_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            out[img_id] = ColmapImage(
                img_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                cam_id,
                name.decode("utf-8"),
            )
    return out


def read_points3d_binary(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> xyz [M,3] f64, rgb [M,3] u8, error [M].

    Records are variable-length (a track list follows each point), so a
    light offset walk finds the record starts (one int read per record) and
    the fixed 43-byte headers then decode in one strided numpy gather —
    ~50x faster than per-record struct unpacking at ScanNet scale (1M+
    points)."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        buf = f.read()
    offsets = np.empty(n, np.int64)
    p = 0
    for i in range(n):
        if p + 51 > len(buf):
            raise ValueError(
                f"truncated points3D file: record {i}/{n} at offset {p}, "
                f"file has {len(buf)} payload bytes"
            )
        offsets[i] = p
        ntrack = int.from_bytes(buf[p + 43:p + 51], "little")
        p += 51 + 8 * ntrack
    if p > len(buf):
        raise ValueError(
            f"truncated points3D file: last track list runs to {p}, "
            f"file has {len(buf)} payload bytes"
        )
    data = np.frombuffer(buf, np.uint8)
    hdr = data[offsets[:, None] + np.arange(43)[None, :]]  # [n, 43] copies
    f64 = np.ascontiguousarray(hdr[:, 8:32]).view("<f8").reshape(n, 3)
    rgb = hdr[:, 32:35].copy()
    err = np.ascontiguousarray(hdr[:, 35:43]).view("<f8").reshape(n)
    return f64.astype(np.float64), rgb, err.astype(np.float64)


# --- text variants ---


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            out[cam_id] = ColmapCamera(
                cam_id,
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return out


def read_images_text(path) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for meta in lines[::2]:  # every other line is the 2D point list
        p = meta.split()
        out[int(p[0])] = ColmapImage(
            int(p[0]),
            np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]),
            int(p[8]),
            p[9],
        )
    return out


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([int(x) for x in p[4:7]])
            err.append(float(p[7]))
    return np.array(xyz), np.array(rgb, np.uint8), np.array(err)


def write_cameras_binary(cams: dict[int, ColmapCamera], path):
    model_ids = {v[0]: k for k, v in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, model_ids[c.model], c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def write_images_binary(imgs: dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(
                struct.pack(
                    "<idddddddi", im.id, *im.qvec.tolist(), *im.tvec.tolist(), im.camera_id
                )
            )
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz, rgb, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i].tolist(), *rgb[i].tolist(), 0.0))
            f.write(struct.pack("<Q", 0))

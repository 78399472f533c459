"""Minimal PLY reader/writer (binary little-endian + ascii read).

Own implementation (the image has no `plyfile`); covers what the pipeline
needs: point clouds with float/uchar vertex properties, and the Gaussian
snapshot format with the reference's exact attribute list
(reference scene/gaussian_model.py:249-298): x y z, nx ny nz (zeros), 6
ins_feat fields, f_dc_*, f_rest_*, opacity, scale_*, rot_*, plus a
visualization RGB (feature -> color, low-opacity points grayed).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}
_NAMES = {"<f4": "float", "<f8": "double", "u1": "uchar", "<i4": "int", "<u4": "uint"}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the 'vertex' element into {property: array}."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        props: list[tuple[str, str]] = []
        count = 0
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, n = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    count = int(n)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, _DTYPES[typ]))
            elif line == "end_header":
                break
        dtype = np.dtype([(n, t) for n, t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "ascii":
            rows = [f.readline().split() for _ in range(count)]
            data = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return {n: np.array(data[n]) for n, _ in props}


def write_ply(path, fields: dict[str, np.ndarray]):
    """Write a 'vertex' element, binary little-endian. All arrays [N]."""
    names = list(fields)
    n = len(fields[names[0]])
    arrs = []
    dtype = []
    for k in names:
        a = np.asarray(fields[k])
        t = "u1" if a.dtype == np.uint8 else "<f4"
        arrs.append(a.astype(t))
        dtype.append((k, t))
    rec = np.empty(n, dtype=np.dtype(dtype))
    for k, a in zip(names, arrs):
        rec[k] = a
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k, t in dtype:
            f.write(f"property {_NAMES[t]} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


# --- Gaussian snapshot (the reference's point_cloud/iteration_N/*.ply) ---


def save_gaussian_ply(path, state, sh_degree: int = 3):
    """state: models.gaussians.GaussianState (alive slots only are written)."""
    alive = np.asarray(state.alive)
    means = np.asarray(state.means)[alive]
    ins = np.asarray(state.ins_feat)[alive]
    f_dc = np.asarray(state.sh_dc)[alive].reshape(means.shape[0], -1)  # [N,3]
    f_rest = np.asarray(state.sh_rest)[alive]
    # reference layout: features [N, K, 3] flattened channel-major (transpose
    # of (K,3) -> (3,K)) to f_rest_0..f_rest_44
    f_rest = f_rest.transpose(0, 2, 1).reshape(means.shape[0], -1)
    op = np.asarray(state.logit_opacity)[alive]
    scl = np.asarray(state.log_scales)[alive]
    rot = np.asarray(state.quats)[alive]

    fields: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        fields[k] = means[:, i]
    for k in ("nx", "ny", "nz"):
        fields[k] = np.zeros(means.shape[0], np.float32)
    ins_names = ["ins_feat_r", "ins_feat_g", "ins_feat_b", "ins_feat_r2", "ins_feat_g2", "ins_feat_b2"]
    for i, k in enumerate(ins_names):
        fields[k] = ins[:, i]
    for i in range(3):
        fields[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        fields[f"f_rest_{i}"] = f_rest[:, i]
    fields["opacity"] = op
    for i in range(3):
        fields[f"scale_{i}"] = scl[:, i]
    for i in range(4):
        fields[f"rot_{i}"] = rot[:, i]
    # visualization color: first 3 feature channels in [0,1]; transparent
    # points gray (reference scene/gaussian_model.py:277-288)
    vis = (ins[:, :3] / (np.linalg.norm(ins, axis=1, keepdims=True) + 1e-12) + 1) / 2
    opac = 1 / (1 + np.exp(-op))
    vis[opac < 0.1] = 0.5
    for i, k in enumerate(("red", "green", "blue")):
        fields[k] = (np.clip(np.nan_to_num(vis[:, i]), 0, 1) * 255).astype(np.uint8)
    write_ply(path, fields)


def load_gaussian_ply(path, sh_degree: int = 3):
    """-> dict of arrays (means, sh_dc, sh_rest, log_scales, quats,
    logit_opacity, ins_feat), alive-only (unpadded)."""
    v = read_ply(path)
    n = len(v["x"])
    k = (sh_degree + 1) ** 2
    means = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    ins_names = ["ins_feat_r", "ins_feat_g", "ins_feat_b", "ins_feat_r2", "ins_feat_g2", "ins_feat_b2"]
    ins = np.stack([v[nm] for nm in ins_names], -1).astype(np.float32)
    sh_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :].astype(np.float32)
    n_rest = 3 * (k - 1)
    rest = np.stack([v[f"f_rest_{i}"] for i in range(n_rest)], -1).astype(np.float32)
    sh_rest = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    return dict(
        means=means,
        sh_dc=sh_dc,
        sh_rest=sh_rest,
        logit_opacity=v["opacity"].astype(np.float32),
        log_scales=np.stack([v[f"scale_{i}"] for i in range(3)], -1).astype(np.float32),
        quats=np.stack([v[f"rot_{i}"] for i in range(4)], -1).astype(np.float32),
        ins_feat=ins,
    )


def load_point_cloud(path):
    """-> (points [N,3], colors [N,3] in [0,1]) for SfM init plys
    (reference fetchPly, scene/dataset_readers.py:141-154)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float64)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float64) / 255.0
    else:
        cols = np.random.rand(pts.shape[0], 3)
    return pts, cols


def store_point_cloud(path, xyz, rgb):
    """rgb in [0,255] uint8. Matches reference storePly layout."""
    fields = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    }
    write_ply(path, fields)

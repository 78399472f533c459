"""Bit-packed codebook snapshots.

Same artifact family as the reference (save_kmeans in train.py:62-100 +
load_code_book in utils/opengs_utlis.py:68-88): per-point cluster indices
packed at ceil(log2(k)) bits into kmeans_inds.bin, centers + an args dict on
the side. Centers are stored as .npy plus a torch-saved .pth twin; the bin packing
itself is bit-compatible (big-endian bit order like bitarray). Copy of
opengaussian_tpu/utils/codebook.py.
"""

from __future__ import annotations

import os

import numpy as np


def _pack_bits(indices: np.ndarray, n_bits: int) -> bytes:
    bits = ((indices[:, None] >> np.arange(n_bits - 1, -1, -1)[None, :]) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def _unpack_bits(data: bytes, total_len: int, n_bits: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[:total_len]
    bits = bits.reshape(-1, n_bits)
    weights = 1 << np.arange(n_bits - 1, -1, -1)
    return (bits * weights).sum(axis=1)


def save_codebook(out_dir: str, centers: np.ndarray, indices: np.ndarray, param: str = "ins_feat"):
    os.makedirs(out_dir, exist_ok=True)
    k = centers.shape[0]
    n_bits = max(int(np.ceil(np.log2(k))), 1)
    indices = np.asarray(indices, np.int64)
    packed = _pack_bits(indices, n_bits)
    with open(os.path.join(out_dir, "kmeans_inds.bin"), "wb") as f:
        f.write(packed)
    np.save(
        os.path.join(out_dir, "kmeans_args.npy"),
        dict(params=[param], n_bits=n_bits, total_len=int(indices.size * n_bits)),
    )
    np.save(os.path.join(out_dir, "kmeans_centers.npy"), np.asarray(centers))
    # reference-readable twin: the reference's load_code_book expects a
    # torch-saved {param: tensor} dict (train.py:100); emit it when torch is
    # importable so reference tooling can consume this repo's artifacts
    try:
        import torch

        torch.save({param: torch.from_numpy(np.asarray(centers).copy())},
                   os.path.join(out_dir, "kmeans_centers.pth"))
    except ImportError:
        pass


def load_codebook(base_path: str):
    """-> (centers [k, d], indices [N]). Reads this repo's .npy centers or a
    reference-written kmeans_centers.pth ({param: tensor} torch dict,
    reference train.py:100 / utils/opengs_utlis.py:68-88); the bin/args pair
    is bit-compatible in both directions (n_bits comes from the args file,
    covering the reference's ceil(log2(N)) sizing quirk)."""
    args = np.load(os.path.join(base_path, "kmeans_args.npy"), allow_pickle=True).item()
    with open(os.path.join(base_path, "kmeans_inds.bin"), "rb") as f:
        data = f.read()
    inds = _unpack_bits(data, args["total_len"], args["n_bits"])
    npy = os.path.join(base_path, "kmeans_centers.npy")
    if os.path.exists(npy):
        centers = np.load(npy)
    else:
        import torch

        d = torch.load(os.path.join(base_path, "kmeans_centers.pth"),
                       map_location="cpu", weights_only=False)
        key = args["params"][0] if args["params"][0] in d else next(iter(d))
        centers = np.asarray(d[key].detach().cpu().numpy(), np.float32)
    return centers, inds.reshape(len(args["params"]), -1)[0]

"""COLMAP SfM runner.

Port of opengaussian_tpu/cli/convert.py (the reference's convert.py:31-124):
shells out to a system `colmap` (and optionally ImageMagick) to build the
undistorted sparse reconstruction layout (sparse/0 + images/) that the COLMAP
scene reader consumes. External binaries required; this tool only
orchestrates and runs nothing on the GPU:

    python -m opengaussian_tpu_torch.cli.convert -s <scene> [--no_gpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def run(cmd: list[str]):
    print("+", " ".join(cmd), flush=True)
    r = subprocess.run(cmd)
    if r.returncode != 0:
        raise SystemExit(f"command failed ({r.returncode}): {' '.join(cmd)}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    args = p.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        raise SystemExit(
            f"colmap not found ({colmap!r}); install COLMAP or run SfM elsewhere "
            "and provide sparse/0 + images/ directly."
        )
    src = args.source_path
    use_gpu = "0" if args.no_gpu else "1"

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src,
         "--output_type", "COLMAP"])

    # move sparse/* -> sparse/0 (reference convert.py:92-103)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))
    print("done.")


if __name__ == "__main__":
    main()

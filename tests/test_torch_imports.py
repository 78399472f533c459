"""Import hygiene: the port and chip_smoke.py never import JAX or the JAX
package, so they run where neither is installed."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import opengaussian_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "opengaussian_tpu"))
        print(len(names), bad)
        assert not bad, bad
        for m in ("cli.render", "cli.train", "train.loop", "train.losses", "ops.ssim",
                  "models.optimizer", "config", "train.lang", "train.checkpoint",
                  "ops.knn", "cli.render_by_text", "cli.render_by_click", "eval.lpips",
                  "eval.metrics", "eval.lerf_iou", "eval.scannet", "cli.full_eval",
                  "cli.convert", "cli.scannet2blender", "cli.vis_pts_feat", "train.observe",
                  "viewer.network_gui", "refine.sam_refiner", "refine.introspect",
                  "cli.vis_refinement", "data.lazy", "ops.budget", "parallel.mesh",
                  "parallel.distributed", "parallel.render", "parallel.steps"):
            assert "opengaussian_tpu_torch." + m in names, m
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 60

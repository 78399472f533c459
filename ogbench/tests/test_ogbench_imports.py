"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the program's name, opengaussian_tpu_torch, begins with the
JAX package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "opengaussian_tpu"}
PROGRAM = "opengaussian_tpu_torch"


def _sources():
    for d, _, files in os.walk(HERE):
        if os.sep + "tests" in d[len(HERE):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=os.path.basename)
def test_no_source_imports_jax(path):
    assert not FORBIDDEN & set(_imported_tops(path))


REFERENCE_SIDE = ["reference.py", "compare.py", "counts.py", "scene.py"] + sorted(
    os.path.join("stages", f) for f in os.listdir(os.path.join(HERE, "stages"))
    if f.endswith(".py"))


@pytest.mark.parametrize("path", REFERENCE_SIDE)
def test_the_reference_side_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imported_tops(os.path.join(HERE, path)))


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(HERE), timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """ogbench.run and every module of the program a run calls into, loaded
    in a fresh process: no top-level jax, jaxlib, flax or opengaussian_tpu."""
    mods = _loaded(
        "import json, sys, ogbench.run, ogbench.calibrate\n"
        "import opengaussian_tpu_torch.train.loop, opengaussian_tpu_torch.data.dataset\n"
        "import opengaussian_tpu_torch.config, opengaussian_tpu_torch.cameras\n"
        "from torch.utils import tensorboard\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not FORBIDDEN & set(mods)


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import json, sys, ogbench.reference, ogbench.compare, ogbench.counts\n"
                   "import ogbench.stages.s0, ogbench.stages.s1\n"
                   "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not (FORBIDDEN | {PROGRAM}) & set(mods)

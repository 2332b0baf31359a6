"""The import check: a run loads no JAX module and not the JAX package
(top-level names compared whole, so the port, cvo_slam_tpu_torch,
passes), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import run

from .util import ROOT

REFERENCE = os.path.join(ROOT, "benchmark", "reference")
SMALL_RUN = """
import json, sys
from benchmark import run
from benchmark.tests.util import SEED, small_cell
cell, ov = small_cell("tum_fr1-pallas.track")
res = run.run_cell(cell, SEED, 1.0, False, "cpu", overrides=ov)
print(json.dumps(run.forbidden_modules()))
"""


def _python(code: str):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    out = _python(SMALL_RUN)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_modules(["cvo_slam_tpu_torch",
                                  "cvo_slam_tpu_torch.cvo.engine", "jaxtyping",
                                  "numpy"]) == []
    assert run.forbidden_modules(["cvo_slam_tpu.cvo", "jaxlib.xla_client",
                                  "jax", "flax.linen"]) == [
        "cvo_slam_tpu", "flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_port():
    """Statically, no import in benchmark/reference names the port, the
    JAX package or JAX; and loaded alone it brings none of them."""
    for name in os.listdir(REFERENCE):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REFERENCE, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in (
                    "cvo_slam_tpu_torch", "cvo_slam_tpu", "jax", "jaxlib",
                    "flax"), (name, m)
    out = _python("import sys, json\n"
                  "import benchmark.reference.frontend, "
                  "benchmark.reference.cvo, benchmark.reference.tracker\n"
                  "print(json.dumps(sorted({m.split('.')[0] for m in "
                  "sys.modules} & {'cvo_slam_tpu_torch', 'cvo_slam_tpu', "
                  "'jax', 'jaxlib', 'flax'})))")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_cli_refuses_without_a_card():
    """No CUDA here: the CLI exits 2 and prints no result."""
    out = _python("import sys\nfrom benchmark import run\n"
                  "sys.exit(run.main(['--workload', 'tum_fr1-pallas.track',"
                  " '--seed', '1', '--seconds', '1', '--trace', '0']))")
    assert out.returncode == 2
    assert out.stdout.strip() == ""

"""Nothing the benchmark runs loads jax or the JAX package, and its
yardstick (reference, frames, roofline, judge, trace, bench) loads nothing
of the program.  Top-level module names are compared whole:
``rpcc_tpu_torch`` is the program, ``rpcc_tpu`` the JAX package."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "rpcc_tpu"}
YARDSTICK = ["portbench.reference", "portbench.frames", "portbench.roofline", "portbench.judge",
             "portbench.trace", "portbench.bench"]


def _loaded_after(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=bench.ROOT, capture_output=True, text=True, env=env, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_yardstick_loads_nothing_of_the_program_or_jax():
    code = "import sys; sys.path.insert(0, '.')\n" + "\n".join(f"import {m}" for m in YARDSTICK)
    readers = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(bench.HERE, "metrics", "*.py")))
    code += "\n" + "\n".join(f"bench.reader({name!r})" for name in readers)
    code = code.replace("import portbench.bench", "import portbench.bench as bench")
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {"rpcc_tpu_torch"}), loaded & (FORBIDDEN | {"rpcc_tpu_torch"})


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(bench.HERE, "**", "*.py"), recursive=True)),
                         ids=lambda p: os.path.relpath(p, bench.HERE))
def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN


def test_a_cpu_run_of_the_harness_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from portbench import run\n"
            "out = run.run_cell('hdl32e_nclt_dbscan_nonuniform.archive_encode', 5, 0.5, False, device='cpu',\n"
            "                   overrides={'traffic': {'frames': 2, 'batch_size': 2}})\n"
            "assert out['correct'], out\n"
            "assert not run.forbidden_modules()")
    loaded = _loaded_after(code)
    assert "rpcc_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "rpcc_tpu_torch_fake_for_test", sys)
    assert "rpcc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rpcc_tpu", sys)
    assert "rpcc_tpu" in run.forbidden_modules()

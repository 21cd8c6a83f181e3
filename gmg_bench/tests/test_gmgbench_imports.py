"""Nothing the benchmark runs loads JAX or the JAX package: every module
of ``gmg_bench`` and the program's modules it drives are imported in a
fresh process, and each loaded module's top-level name is compared whole
(``coulomb_gmg_tpu_torch`` begins with ``coulomb_gmg_tpu``)."""

import json
import os
import subprocess
import sys

from gmg_bench import cells, run

MODULES = ["gmg_bench.run", "gmg_bench.cells", "gmg_bench.inputs",
           "gmg_bench.check", "gmg_bench.trace", "gmg_bench.control",
           "gmg_bench.reference.fem", "gmg_bench.reference.density",
           "gmg_bench.metrics._roofline", "gmg_bench.metrics._stages",
           "coulomb_gmg_tpu_torch.driver", "coulomb_gmg_tpu_torch.config",
           "coulomb_gmg_tpu_torch.io.lammps",
           "coulomb_gmg_tpu_torch.utils.logging", "torch.profiler"]


def test_nothing_the_benchmark_runs_loads_jax():
    readers = sorted(f[:-3] for f in os.listdir(os.path.join(
        cells.PKG, "metrics")) if f.endswith(".py") and f[0] != "_"
        and f != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from gmg_bench import cells\n"
        f"for r in {readers!r}: cells.metric_reader(r)\n"
        "from gmg_bench.run import forbidden_modules\n"
        "print(json.dumps([sorted({m.split('.')[0] for m in sys.modules}),"
        " forbidden_modules()]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    tops, found = json.loads(out.splitlines()[-1])
    assert "coulomb_gmg_tpu_torch" in tops and "torch" in tops
    for bad in run.FORBIDDEN:
        assert bad not in tops, bad
    assert found == []


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["coulomb_gmg_tpu_torch.driver",
                                  "jaxtyping", "flaxen.x", "torch"]) == []
    assert run.forbidden_modules(["coulomb_gmg_tpu.driver", "jax.numpy",
                                  "jaxlib", "flax"]) == [
        "coulomb_gmg_tpu", "flax", "jax", "jaxlib"]

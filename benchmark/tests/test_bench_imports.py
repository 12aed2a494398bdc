"""No process of a run loads JAX or the JAX package: the check compares
each loaded module's top-level name whole (the port's ``dbsr_tpu_torch``
begins with ``dbsr_tpu``), and each cell's imports pass it."""

import subprocess
import sys

import pytest

from benchmark import harness


def test_names_are_compared_whole():
    mods = {"dbsr_tpu_torch": 1, "dbsr_tpu_torch.ops.warp": 1,
            "jaxtyping": 1, "flaxen": 1, "torch": 1}
    assert harness.forbidden_loaded(mods) == []
    mods.update({"dbsr_tpu": 1, "dbsr_tpu.ops": 1, "jax": 1,
                 "jaxlib.xla_client": 1, "flax.core": 1})
    assert harness.forbidden_loaded(mods) == [
        "dbsr_tpu", "dbsr_tpu.ops", "flax.core", "jax", "jaxlib.xla_client"]


# what each kind of loop imports of the program, at run time included
PROGRAM = {
    "train": ["dbsr_tpu_torch.configs.dbsr.default_synthetic",
              "dbsr_tpu_torch.training.trainer", "dbsr_tpu_torch.kernels",
              "dbsr_tpu_torch.parallel.multihost",
              "dbsr_tpu_torch.data.procedural",
              "dbsr_tpu_torch.data.synthetic",
              "dbsr_tpu_torch.models.dbsr", "dbsr_tpu_torch.environment"],
    "direct": ["dbsr_tpu_torch.serving", "dbsr_tpu_torch.kernels"],
    "http": ["dbsr_tpu_torch.serving", "dbsr_tpu_torch.serving_daemon",
             "dbsr_tpu_torch.kernels"],
}


@pytest.mark.parametrize("workload",
                         [w["name"] for w in harness.load_manifest()
                          ["workloads"]])
def test_a_cells_imports_load_nothing_of_jax(workload):
    cell = harness.find_cell(workload)
    load = cell.traffic["load"]
    mods = ["benchmark.run", "benchmark.control",
            f"benchmark.loads.{load}", "benchmark.loads.http_client",
            "benchmark.reference.dbsr", "benchmark.reference.checkpoint",
            "benchmark.oracle", "benchmark.inputs"] + PROGRAM[load]
    readers = [m["name"] for m in cell.per_layer]
    code = ("import importlib, sys\n"
            "from benchmark import harness\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"for r in {readers!r}: harness.metric_reader(r)\n"
            "found = harness.forbidden_loaded()\n"
            "print(found)\n"
            "sys.exit(1 if found else 0)\n")
    env = dict(__import__("os").environ, USE_FLAX="0")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT),
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stdout + p.stderr


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.oracle, benchmark.inputs, benchmark.yardstick\n"
            "import benchmark.reference.dbsr, benchmark.reference.checkpoint\n"
            "import benchmark.reference.procedural\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('dbsr_tpu_torch', 'dbsr_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr

"""What the benchmark imports: never JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the package's),
and the references and generators nothing of the program under test."""
import ast
import pkgutil
import subprocess
import sys

import perfbench
from perfbench import harness

OWN = ("reference", "gen", "roofline.py")


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["g2o_frontend_tpu_torch.slam", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["g2o_frontend_tpu.ops", "jax.numpy", "flax"]) == ["flax", "g2o_frontend_tpu", "jax"]


def test_importing_every_module_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(perfbench.__path__, "perfbench.") if ".tests" not in m.name]
    mods += ["perfbench.drivers." + n for n in ("pwn_live", "pwn_scan", "se2_solve")]
    code = ("import importlib, sys; from perfbench import harness\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import g2o_frontend_tpu_torch.slam.pwn_tracker, g2o_frontend_tpu_torch.solvers.schur_pcg\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_references_and_generators_import_nothing_of_the_program():
    files = [p for name in OWN for p in ([harness.HERE / name] if name.endswith(".py")
                                         else sorted((harness.HERE / name).glob("*.py")))]
    assert len(files) >= 5
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".", 1)[0]
                assert top not in ("g2o_frontend_tpu", "g2o_frontend_tpu_torch", "jax", "jaxlib", "flax"), (path, name)

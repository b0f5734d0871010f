"""The harness loads neither JAX nor the JAX package, and its reference
loads nothing of the system under test. Each check runs in a fresh
interpreter, so what the test process has loaded cannot hide or fake a
leak."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import vdb_bench

HERE = Path(vdb_bench.__file__).resolve().parent
PORT = "cuda_acceleratedvectordatabaseengine_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_acceleratedvectordatabaseengine_tpu")


def _top_level_after(imports: list[str]) -> set[str]:
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(' '.join(sorted({m.split('.', 1)[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return set(out.stdout.split())


def test_no_module_of_the_harness_loads_jax_or_the_jax_package():
    mods = [m.name for m in pkgutil.walk_packages([str(HERE)], "vdb_bench.")
            if ".tests" not in m.name]
    assert "vdb_bench.run" in mods and "vdb_bench.harness" in mods
    loaded = _top_level_after(mods + [f"{PORT}.server.service"])
    assert PORT in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_system_under_test():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".", 1)[0] not in (PORT, *FORBIDDEN), (f, n)
    loaded = _top_level_after(["vdb_bench.reference.exact"])
    assert PORT not in loaded and not loaded & set(FORBIDDEN)


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "vdb_bench.run", "--workload",
         "sift-1m-128.q1", "--seed", str(2**31 + 5), "--seconds", "1"],
        cwd=HERE.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""

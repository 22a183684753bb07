"""The harness loads no JAX module in the process that runs a cell, and the
reference's modules never import the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import harness

# The modules that make the reference's results and the yardstick.
REFERENCE_SIDE = ("reference", "scene", "counts", "trace", "readers")


def test_no_jax_module_is_loaded_by_a_run(tiny_root):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from pathlib import Path\n"
        "from benchmark import harness, run\n"
        f"cell = harness.load_cell('mipnerf360_outdoor_4.train_late', Path({str(tiny_root)!r}))\n"
        "run.run_cell(cell, 1, 0.2, True, 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, check=True)
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "gaussiansplattingmlx_tpu_torch" in top  # the program ran
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussiansplattingmlx_tpu_torch_x", sys)
    assert "gaussiansplattingmlx_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_the_reference_never_imports_the_program():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        + "".join(f"import benchmark.{m}\n" for m in REFERENCE_SIDE)
        + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, check=True)
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not top & {"gaussiansplattingmlx_tpu_torch", *harness.FORBIDDEN}
    for name in REFERENCE_SIDE:
        tree = ast.parse((harness.BENCH_DIR / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("gaussiansplattingmlx_tpu"), (name, node.module)
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("gaussiansplattingmlx_tpu")
                               for a in node.names), name

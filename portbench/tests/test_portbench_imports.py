"""What the harness loads, by top-level module name compared whole:
neither ``jax`` nor the JAX package (``kubedl_tpu``; the port's name,
``kubedl_tpu_torch``, begins with it), and the reference nothing of the
port."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
HARNESS = Path(__file__).resolve().parents[1]

LOAD_ALL = """
import json, sys
import portbench.run, portbench.calibrate, portbench.train_cell
import portbench.serve_cell, portbench.reference.train
from portbench import spec
from portbench.tests import tiny
from portbench import train_cell, serve_cell
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
res = train_cell.run(tiny.run_of("train", seconds=0.2))
res = serve_cell.run(tiny.run_of("chat", seconds=0.2))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_names(LOAD_ALL)
    assert "kubedl_tpu_torch" in names
    assert forbidden_modules(names) == []


def test_the_check_compares_whole_names():
    assert forbidden_modules(["kubedl_tpu_torch.models", "jaxtyping"]) == []
    assert forbidden_modules(["kubedl_tpu.models", "jax.numpy",
                              "flax"]) == ["flax", "jax", "kubedl_tpu"]


def test_the_reference_imports_nothing_of_the_port():
    for path in (HARNESS / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if not node.level else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "kubedl_tpu_torch", "kubedl_tpu", "jax"), (path, m)
    names = _top_names("import json, sys\n"
                       "import portbench.reference.model\n"
                       "import portbench.reference.train\n"
                       "print(json.dumps(sorted({m.split('.')[0] "
                       "for m in sys.modules})))")
    assert "kubedl_tpu_torch" not in names and not forbidden_modules(names)


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "qwen2-7b.train", "--seed", str(2**33), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

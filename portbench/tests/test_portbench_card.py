"""On the card: every cell of ``BENCHMARK.json`` runs once through the
command, with a short window, and prints a correct result line; a traced
run prints every per-layer metric the cell lists. Skips without a card.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_a_cell_runs_on_the_card(cell, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", cell, "--seed",
         str(2**33 + 17), "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_for(spec.benchmark(), cell, kind)}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"

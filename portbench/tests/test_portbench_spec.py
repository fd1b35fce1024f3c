"""The harness finds a configuration, a traffic mix, a cell and a
per-layer metric added as new files, by the names ``BENCHMARK.json``
gives them: adding to the benchmark is adding files."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run, spec

HERE = Path(__file__).resolve().parents[1]


def _new_files(root: Path) -> None:
    base = root / "portbench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        (base / sub).mkdir(parents=True)
    shutil.copy(HERE / "configs" / "qwen2-7b.json",
                base / "configs" / "other-model.json")
    (base / "traffic" / "bursty.json").write_text(json.dumps(
        {"kind": "requests", "arrival": {"kind": "poisson"},
         "prompt": {"median": 64, "sigma": 0.5, "min": 8, "max": 128},
         "output": {"median": 8, "sigma": 0.5, "min": 2, "max": 16},
         "lead_s": 1}))
    (base / "cells" / "other-model.bursty.json").write_text(json.dumps(
        {"kind": "serve", "lanes": 2, "max_len": 256, "rate_per_s": 1.0,
         "check_requests": 2, "check_per_request": 4,
         "limits": {"logit_gap": 0.5}}))
    (base / "metrics" / "host_ticks.py").write_text(
        "def read(ctx):\n"
        "    return None if ctx.ticks is None else float(ctx.ticks)\n")
    (root / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "other-model",
                     "file": "portbench/configs/other-model.json"}],
        "workloads": [{"name": "other-model.bursty", "config": "other-model",
                       "traffic": "bursty", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "host_ticks.bursty", "unit": "count",
                       "workloads": ["other-model.bursty"]},
                      {"name": "host_ticks.elsewhere", "unit": "count",
                       "workloads": ["another.cell"]}]}))


def test_new_files_are_found_by_name(tmp_path):
    _new_files(tmp_path)
    bench, w, cell, mix, cfg = run.load("other-model.bursty", root=tmp_path)
    assert w["traffic"] == "bursty" and cell["rate_per_s"] == 1.0
    assert mix["prompt"]["median"] == 64
    assert cfg["hidden_size"] == 3584
    names = [m["name"] for m in spec.metrics_for(bench, w["name"],
                                                  "per_layer")]
    assert names == ["host_ticks.bursty"]
    read = spec.reader("host_ticks.bursty", base=tmp_path / "portbench")
    assert read(SimpleNamespace(ticks=3)) == 3.0
    assert read(SimpleNamespace(ticks=None)) is None


def test_the_layers_read_only_what_they_find(tmp_path):
    _new_files(tmp_path)
    bench = spec.benchmark(tmp_path)
    base = tmp_path / "portbench"
    assert run.read_layers(bench, "other-model.bursty",
                           SimpleNamespace(ticks=None), base) == {}
    assert run.read_layers(bench, "other-model.bursty",
                           SimpleNamespace(ticks=5), base) == {
        "host_ticks.bursty": {"value": 5.0, "unit": "count"}}


def test_every_cell_of_the_benchmark_has_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        _, _, cell, mix, cfg = run.load(w["name"])
        assert cell["kind"] in ("train", "serve")
        assert cfg["torch_dtype"] == "bfloat16"
        assert set(cell["limits"])
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("what", ["family", "kind"])
def test_an_unknown_family_or_cell_kind_is_refused(what):
    cfg = spec.load_json(HERE / "configs" / "qwen2-7b.json")
    if what == "family":
        with pytest.raises(SystemExit, match="unknown model family"):
            spec.port_config(dict(cfg, family="mamba"))
    else:
        with pytest.raises(SystemExit, match="unknown cell kind"):
            spec.driver({"kind": "embed"})
    assert spec.family(cfg) == "llama"
    assert spec.driver({"kind": "serve"}) == "serve_cell"

"""Where the harness finds what belongs to one cell, by name.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric sits in a file of its own, and is found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the published configuration as it is run
  (Hugging Face keys), with ``reduced``, ``assumed`` and ``deployment``;
* ``traffic/<traffic>.json``: the parameters the one generator
  (``traffic.py``) reads;
* ``cells/<workload>.json``: the kind of run (``train`` or ``serve``) and
  its settings (batch, lanes, rate ...);
* ``metrics/<family>.py``: the reader of every per-layer metric whose name
  starts with ``<family>`` (the part before the first dot).

So a later cell, mix or metric is a new file, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_file(name: str, base: Path = HERE) -> dict:
    return load_json(base / "cells" / f"{name}.json")


def traffic_file(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` (``end_to_end`` or ``per_layer``)
    this cell reports: those that list it, or list no cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def reader(metric: str, base: Path | None = None):
    """The ``read(ctx) -> float | None`` of a per-layer metric: the
    module ``metrics/<family>.py`` of the name's part before the first
    dot, loaded from its file."""
    family = metric.split(".", 1)[0]
    path = (base or HERE) / "metrics" / f"{family}.py"
    if not path.exists():
        raise SystemExit(f"no reader {path} for per-layer metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


#: the model families a configuration file may name
FAMILIES = ("llama", "moe")
#: the kinds of cell, and the module of the harness that drives each
DRIVERS = {"train": "train_cell", "serve": "serve_cell"}


def family(cfg: dict) -> str:
    """The configuration's ``family``, one of :data:`FAMILIES`."""
    fam = cfg.get("family")
    if fam not in FAMILIES:
        raise SystemExit(f"unknown model family {fam!r}; the harness runs "
                         f"{FAMILIES}")
    return fam


def driver(cell: dict) -> str:
    """The harness module that drives a cell of this ``kind``."""
    kind = cell.get("kind")
    if kind not in DRIVERS:
        raise SystemExit(f"unknown cell kind {kind!r}; the harness runs "
                         f"{sorted(DRIVERS)}")
    return DRIVERS[kind]


def port_config(cfg: dict, overrides: dict | None = None):
    """The port's config object for a configuration file's published keys
    (``family`` picks ``LlamaConfig`` or ``MoEConfig``), with a cell's
    run settings (``remat``, ``loss_chunk``) on top."""
    fam = family(cfg)
    from kubedl_tpu_torch.models.llama import LlamaConfig
    from kubedl_tpu_torch.models.moe import MoEConfig
    kw = dict(vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
              n_layers=cfg["num_hidden_layers"],
              n_heads=cfg["num_attention_heads"],
              n_kv_heads=cfg["num_key_value_heads"],
              d_ff=cfg["intermediate_size"], rope_theta=cfg["rope_theta"],
              rms_eps=cfg["rms_norm_eps"], dtype=cfg["torch_dtype"],
              tie_embeddings=cfg["tie_word_embeddings"])
    if cfg["hidden_act"] != "silu":
        raise SystemExit(f"hidden_act {cfg['hidden_act']!r} is not run here")
    kw.update(overrides or {})
    if fam == "moe":
        return MoEConfig(n_experts=cfg["num_local_experts"],
                         top_k=cfg["num_experts_per_tok"],
                         capacity_factor=cfg["capacity_factor"], **kw)
    return LlamaConfig(qkv_bias=cfg.get("qkv_bias", False), **kw)

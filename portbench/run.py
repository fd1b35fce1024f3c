"""Run one cell of the port's benchmark once.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``kubedl_tpu_torch``. The cell's
files (``spec.py``) say what runs: a ``train`` cell drives the port's
``Trainer.step``, a ``serve`` cell its ``ContinuousBatchingEngine``; a
cell kind, a model family or a traffic mix the harness does not know is
refused before the card is touched. Set-up
makes the weights on the card from the seed and warms every shape the
traffic uses; the window then runs for ``--seconds``; then what the window
produced is compared with the plain reference (``reference/``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics, read from the window's device trace, spans and
counters), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, also printed as the last
lines of standard error.

Exits non-zero with no result when the card or the cards the cell needs
are missing, and when ``jax``, ``jaxlib``, ``flax`` or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import spec, traffic  # noqa: E402

#: build and kernel caches, at fixed paths inside the checkout
CACHE = spec.ROOT / "build" / "portbench"
#: top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "kubedl_tpu")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def set_cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load(name: str, root=spec.ROOT):
    """(workload entry, cell file, traffic file, configuration file) of a
    cell, found by name."""
    bench = spec.benchmark(root)
    w = spec.workload(bench, name)
    base = root / spec.HERE.name
    cfg = spec.load_json(root / spec.config_entry(bench, w["config"])["file"])
    return bench, w, spec.cell_file(name, base), \
        spec.traffic_file(w["traffic"], base), cfg


def device_info(torch, ctx) -> dict:
    """The card, and the peak memory the program reached (read before the
    reference ran)."""
    trace = ctx.trace
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(ctx.memory_peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
    return out


def is_correct(checks: dict) -> bool:
    """Every number compared is finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def read_layers(bench: dict, cell: str, ctx, base=None) -> dict:
    """Every per-layer metric this cell lists, by its reader; a reader
    that finds nothing to read gives None, and the metric is left out."""
    out = {}
    for m in spec.metrics_for(bench, cell, "per_layer"):
        value = spec.reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    bench, w, cell, mix, cfg = load(args.workload)
    t = time.perf_counter()
    driver = importlib.import_module(f"{__package__}.{spec.driver(cell)}")
    traffic.kind(mix, driver.MIX)
    spec.family(cfg)
    import torch
    phases = {"start_s": t - T_START, "imports_s": time.perf_counter() - t}
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: the cell {w['name']} needs {w['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from .reference.model import set_exact
    set_exact()
    run = SimpleNamespace(name=w["name"], cell=cell, mix=mix, cfg=cfg,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda"),
                          t_start=T_START, trace_path=CACHE / "trace.json",
                          phases=phases)
    res = driver.run(run)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = read_layers(bench, w["name"], res.ctx)
    else:
        metrics = {m["name"]: {"value": res.e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_for(bench, w["name"], "end_to_end")}
    checks = res.checks
    line = {"correct": is_correct(checks), "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics,
            "device": device_info(torch, res.ctx)}
    if args.trace and res.ctx.trace is not None:
        line["breakdown"] = res.ctx.trace.breakdown()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0

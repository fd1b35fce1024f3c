#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time on the card.

    python3 profile_torch_training.py

Needs one CUDA card. Runs ``python -m kubedl_tpu_torch.train``'s ``main``
in-process on the training slice's model (Llama-3-8B at full width, 8
layers deep, random bf16 weights from seed 0, remat on, loss_chunk 512,
synthetic batches of 4 x 2048) for 5 steps, with the trainer's profile
window (``optimizer.profile_dir``) on steps 3 and 4. It then reads the
chrome trace that window exports and prints:

* device busy time against the wall time of the window (the idle share)
  and the number of device operations;
* the device time of the kernels launched inside each of the step's
  ranges (``train.loss_and_grads``, ``train.optimizer``);
* the device time of the three flash kernels, of the matrix products and
  of everything else, and the top kernels by device time.

The card's name and power limit come first (``nvidia-smi``).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from kubedl_tpu_torch.train import __main__ as train_main

OUT = Path(__file__).resolve().parent / "build" / "profile_torch_training"
CONFIG = {"model": "llama.llama3_8b", "model_overrides": {"n_layers": 8},
          "mode": "pretrain", "data": {"kind": "synthetic"},
          "batch": 4, "seq": 2048, "steps": 5, "seed": 0, "log_every": 1,
          "optimizer": {"warmup_steps": 1, "profile_dir": str(OUT / "trace"),
                        "profile_start_step": 2, "profile_steps": 2}}
PROFILED_STEPS = CONFIG["optimizer"]["profile_steps"]
RANGES = ("train.loss_and_grads", "train.optimizer")
#: kernel-name classes for the breakdown
CLASSES = (("flash kernels (K1-K3)", re.compile(r"flash_(fwd|dq|dkv)_kernel")),
           ("matrix products", re.compile(r"gemm|xmma|cutlass|sm90_|nvjet",
                                          re.I)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarise(trace: dict) -> None:
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    wall = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    print(f"== {PROFILED_STEPS} training steps: wall {wall / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {len(device)} device operations")

    # each device operation belongs to the range its launch fell in
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in RANGES]
    per_range = dict.fromkeys(RANGES + ("outside the ranges",), 0.0)
    for e in device:
        t = launched.get(e.get("args", {}).get("correlation"))
        name = next((n for s, end, n in spans
                     if t is not None and s <= t <= end),
                    "outside the ranges")
        per_range[name] += e["dur"]
    for name, t in per_range.items():
        host = sum(end - s for s, end, n in spans if n == name)
        print(f"   {t / 1e3:10.3f} ms device, {host / 1e3:10.3f} ms host  "
              f"{name}")

    kernels = [e for e in device if e["cat"] == "kernel"]
    total = sum(e["dur"] for e in kernels)
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], n + 1)
    print(f"== kernels: {total / 1e3:.3f} ms over {len(kernels)} launches")
    rest = total
    for label, pat in CLASSES:
        t = sum(tn[0] for name, tn in by_name.items() if pat.search(name))
        rest -= t
        print(f"   {t / 1e3:10.3f} ms {100 * t / total:5.1f}%  {label}")
    print(f"   {rest / 1e3:10.3f} ms {100 * rest / total:5.1f}%  everything "
          "else (elementwise, reductions, copies, optimizer)")
    for name, (t, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:20]:
        print(f"   {t / 1e3:10.3f} ms {100 * t / total:5.1f}%  x{n:<5d} "
              f"{name[:100]}")


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    cfg_path = OUT / "train.json"
    cfg_path.write_text(json.dumps(CONFIG))
    rc = train_main.main(["--config", str(cfg_path)])
    traces = sorted((OUT / "trace").glob("*.json"))
    if rc != 0 or len(traces) != 1:
        raise SystemExit(f"training returned {rc} and wrote {traces}")
    summarise(json.loads(traces[0].read_text()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

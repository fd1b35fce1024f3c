#!/usr/bin/env python3
"""Where the PyTorch port's serving engine spends its time on the card.

    python3 profile_torch_serving.py

Needs one CUDA card. Builds Llama-3-8B at full width and depth (random
bf16 weights from seed 0), serves a batch of 4 random 128-token prompts
through ``InferenceEngine.generate`` and prints:

* host wall time of prefill + first token (``generate(..., 1)``) and of
  each further decoded token (``generate(..., 17)`` minus that, over 16);
* one ``generate(..., 9)`` under ``torch.profiler``: the device time by
  kernel (top 15), the device's busy time against the wall time of the
  profiled window (its idle share), and the number of kernel launches;
* one ``/v1/embeddings``-shaped forward (2 x 512 tokens through
  ``forward_hidden``) under the profiler, with the flash kernel's share;
* the predictor's engine (``ContinuousBatchingEngine``, paged, 8 lanes,
  each lane 502 tokens into a 501-token prompt): 5 decode ticks replayed
  as the CUDA graph and 5 run eagerly on the same lane state, each under
  the profiler — wall, device busy, idle share, device kernels and the
  host's launch calls (kernel launches plus graph launches) per tick.

The card's name and power limit come first (``nvidia-smi``).
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerateConfig, InferenceEngine)


#: host calls that put work on the card: kernel launches and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its host wall time, the
    device's busy time (the sum of its kernels' times), the device kernels
    it ran and the host's launch calls (``LAUNCH_CALLS``). ``chip_smoke.py``
    counts a decode tick's launches with this too."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"wall_us": wall_us, "kernels": kernels,
            "busy_us": sum(e.time_range.elapsed_us() for e in kernels),
            "host_calls": sum(1 for e in prof.events()
                              if e.name in LAUNCH_CALLS)}


def _profiled(fn, label: str, top: int = 15) -> None:
    p = device_profile(fn)
    wall_us, busy_us, kernels = p["wall_us"], p["busy_us"], p["kernels"]
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"== {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
          f"{len(kernels)} kernel launches, {p['host_calls']} host launch "
          f"calls")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"   {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}%  x{n:<5d} "
              f"{name[:110]}")


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}")
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = InferenceEngine(cfg, params, GenerateConfig(max_len=1024))
    prompts = np.random.default_rng(0).integers(
        3, cfg.vocab_size, (4, 128)).tolist()

    eng.generate(prompts, 2)                     # warm-up
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.generate(prompts, 17)
    per_tok = (time.perf_counter() - t0 - ttft) / 16
    print(f"batch 4 x 128-token prompts: prefill + first token "
          f"{1e3 * ttft:.3f} ms, {1e3 * per_tok:.3f} ms per further token")

    _profiled(lambda: eng.generate(prompts, 9),
              "generate(batch 4, prompt 128, 9 tokens)")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        3, cfg.vocab_size, (2, 512)), device="cuda")
    with torch.inference_mode():
        llama.forward_hidden(cfg, eng.params, toks)   # warm-up
        _profiled(lambda: llama.forward_hidden(cfg, eng.params, toks),
                  "forward_hidden(2 x 512 tokens), the /v1/embeddings path")

    cont = ContinuousBatchingEngine(cfg, eng.params, lanes=8, max_len=1024)
    prompt = np.random.default_rng(2).integers(3, cfg.vocab_size,
                                               500).tolist()
    for i in range(8):
        cont.submit(prompt + [i + 3], 256)
    cont.step()              # prefill every lane, capture the decode graph

    def ticks(route):
        for _ in range(5):
            cont.decode_tick(route).argmax(-1).cpu()

    for route, label in ((None, "graph"), ("eager", "eager")):
        ticks(route)                                 # warm
        _profiled(lambda: ticks(route),
                  f"5 decode ticks of the continuous engine, 8 lanes, "
                  f"{label} route", top=8)
    print(f"decode ticks by route over the run: {cont.tick_launches}")


if __name__ == "__main__":
    main()

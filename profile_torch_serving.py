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
  ``forward_hidden``) under the profiler, with the flash kernel's share.

The card's name and power limit come first (``nvidia-smi``).
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.serving import GenerateConfig, InferenceEngine


def _profiled(fn, label: str, top: int = 15) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"== {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
          f"{len(kernels)} kernel launches")
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


if __name__ == "__main__":
    main()

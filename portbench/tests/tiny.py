"""Tiny configurations and cells for the CPU tests: the cells' whole paths
at small widths in float32 (so the port and the reference agree to
rounding), driven without the look for a card."""

from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace

import torch

LLAMA = {"family": "llama", "hidden_act": "silu", "hidden_size": 64,
         "intermediate_size": 128, "num_attention_heads": 4,
         "num_hidden_layers": 2, "num_key_value_heads": 2,
         "rms_norm_eps": 1e-6, "rope_theta": 1e6, "vocab_size": 256,
         "tie_word_embeddings": False, "torch_dtype": "float32",
         "qkv_bias": True}
MOE = {**{k: v for k, v in LLAMA.items() if k != "qkv_bias"},
       "family": "moe", "num_local_experts": 4, "num_experts_per_tok": 2,
       "capacity_factor": 2.0, "rms_norm_eps": 1e-5}

TRAIN_CELL = {"kind": "train", "batch": 2, "seq": 64,
              "model_overrides": {"remat": True, "loss_chunk": 16},
              "optimizer": {"lr": 3e-4, "warmup_steps": 1,
                            "decay_steps": 10000, "weight_decay": 0.1,
                            "beta1": 0.9, "beta2": 0.95, "grad_clip": 1.0},
              "check_steps": 3,
              # float32 on both sides: the gaps are rounding (~1e-7 to
              # ~1e-5 on the CPU)
              "limits": {"loss_gap": 1e-4, "grad_gap": 1e-4,
                         "change_gap": 1e-3}}
DOCS = {"kind": "documents",
        "length": {"median": 24, "sigma": 1.0, "min": 4, "max": 80}}

SERVE_CELL = {"kind": "serve", "lanes": 4, "max_len": 128,
              "rate_per_s": 6.0, "check_requests": 4,
              "check_per_request": 10,
              "limits": {"logit_gap": 1e-3}}
#: the Mixtral cell compares the mean gap (float32 here: rounding only)
BATCH_CELL = {**SERVE_CELL, "limits": {"logit_gap_mean": 1e-4}}
OPEN = {"kind": "requests", "arrival": {"kind": "poisson"},
        "prompt": {"median": 20, "sigma": 0.9, "min": 4, "max": 48},
        "output": {"median": 8, "sigma": 0.8, "min": 2, "max": 24},
        "lead_s": 0.5}
CLOSED = {**OPEN, "arrival": {"kind": "closed", "clients": 8}}


def run_of(kind: str, seed: int = 2**33 + 5, seconds: float = 1.0,
           trace: bool = False, tmp: Path = Path(".")):
    """A run namespace as ``run.main`` builds one, on the CPU."""
    cfg, cell, mix = {"train": (LLAMA, TRAIN_CELL, DOCS),
                      "chat": (LLAMA, SERVE_CELL, OPEN),
                      "batch": (MOE, BATCH_CELL, CLOSED)}[kind]
    return SimpleNamespace(name=kind, cfg=dict(cfg), cell=dict(cell),
                           mix=dict(mix), seed=seed, seconds=seconds,
                           trace=trace, device=torch.device("cpu"),
                           t_start=time.perf_counter(),
                           trace_path=Path(tmp) / "trace.json")


def correct(res) -> bool:
    from portbench.run import is_correct
    return is_correct(res.checks)

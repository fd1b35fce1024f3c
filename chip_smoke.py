#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``). Imports only the
port (``kubedl_tpu_torch``), never JAX or the JAX package. Phases; any
failure raises and the script exits non-zero before its last line:

1. build — every kernel under ``kubedl_tpu_torch/csrc/`` with ``nvcc``
   for ``sm_90a`` (build seconds and ``ptxas`` resource lines printed);
2. kernel check — each kernel against its plain PyTorch version on the
   card, on the serving path's shape and on the edge cases, then timed
   beside its plain version, a PyTorch library call and its bound;
3. serving — Llama-3-8B at full width (random bf16 weights from a seed)
   behind ``InferenceServer`` over ``InferenceEngine``: ``:predict``
   (buffered, streamed, and greedy held against ``greedy_rollout``),
   ``/v1/completions`` and ``/v1/embeddings``, whose every layer must
   launch the flash kernel once;
4. the kernels line (JSON), the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import urllib.request

#: published H100 SXM peaks (NVIDIA data sheet), dense
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

#: the serving path's attention shape: the embeddings request below sends
#: two inputs, the longer 512 tokens, through Llama-3-8B's 32 q / 8 kv
#: heads of width 128
MAIN = dict(b=2, sq=512, sk=512, nh=32, nkv=8, hd=128, dtype="bfloat16",
            causal=True)
#: out within one bf16 ulp at unit scale (the kernel and the plain version
#: sum in different orders before rounding); f32 to its last digits; lse
#: is f32 on both sides
ATOL = {"bfloat16": 1e-2, "float32": 2e-5, "lse": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def _inputs(torch, case, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, case["dtype"])

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    b, sq, sk = case["b"], case["sq"], case["sk"]
    q = randn(b, sq, case["nh"], case["hd"])
    k = randn(b, sk, case["nkv"], case["hd"])
    v = randn(b, sk, case["nkv"], case["hd"])
    seg = None
    if case.get("segments"):
        # three packed documents per row, boundaries differing per row
        pos = torch.arange(sq, device="cuda")
        seg = torch.stack([(pos >= sq // 3 + 7 * i).int()
                           + (pos >= (2 * sq) // 3 - 5 * i).int()
                           for i in range(b)])
    return q, k, v, seg


def _kw(case, seg):
    return dict(segment_ids=seg, offsets=case.get("offsets"),
                window=case.get("window", 0))


def _time_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call. A 64 MB write between calls pushes
    the inputs out of the 50 MB L2, as a layer's worth of other work does
    on the serving path."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def _flash_bound(torch, case, seg) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the work these
    inputs need. Each of q/k/v/out/lse moves once at the HBM rate; the
    products of the (row, key) pairs the mask keeps (4*hd operations
    each: q.k and p.v) run at the peak rate of the input type."""
    b, sq, sk, nh, nkv, hd = (case[n] for n in
                              ("b", "sq", "sk", "nh", "nkv", "hd"))
    item = 2 if case["dtype"] == "bfloat16" else 4
    moved = item * hd * (2 * b * sq * nh + 2 * b * sk * nkv) + 4 * b * nh * sq
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    keep = torch.ones(1, sq, sk, dtype=torch.bool)
    if case["causal"]:
        q_off, k_off = case.get("offsets") or (0, 0)
        keep = (cols + k_off) <= (rows + q_off)
        if case.get("window", 0):
            keep &= (cols + k_off) > (rows + q_off) - case["window"]
        keep = keep[None]
    if seg is not None:
        seg = seg.cpu()
        keep = keep & (seg[:, :, None] == seg[:, None, :])
    pairs = int(keep.expand(b, sq, sk).sum())
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 4 * hd * pairs * nh / PEAK_FLOPS_PER_S[case["dtype"]]
    return 1e3 * max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from kubedl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(_build.sources())} kernel source(s), built "
        f"{sorted(logs)} in {dt:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernel_check(torch):
    from kubedl_tpu_torch.ops import attention as attn

    cases = {
        "main": MAIN,
        "non_causal": {**MAIN, "causal": False},
        "mha": {**MAIN, "nkv": 32},
        "window_128": {**MAIN, "window": 128},
        "segment_ids": {**MAIN, "segments": True},
        "offsets": {**MAIN, "offsets": (256, 0)},
        "offsets_masked_rows": {**MAIN, "offsets": (0, 256)},
        "ragged_300": {**MAIN, "sq": 300, "sk": 300},
        "sq_gt_sk": {**MAIN, "sq": 512, "sk": 256},
        "float32": {**MAIN, "dtype": "float32"},
        "hd_64": {**MAIN, "hd": 64, "sq": 200, "sk": 200},
        "hd_256": {**MAIN, "hd": 256, "sq": 256, "sk": 256},
        "hd_80_padded": {**MAIN, "hd": 80, "sq": 130, "sk": 130},
    }
    errs = {}
    for i, (name, case) in enumerate(cases.items()):
        q, k, v, seg = _inputs(torch, case, seed=100 + i)
        out, lse = attn.flash_forward(q, k, v, case["causal"], **_kw(case, seg))
        ref, ref_lse = attn.flash_forward_plain(q, k, v, case["causal"],
                                                **_kw(case, seg))
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = (math.isfinite(err) and err <= ATOL[case["dtype"]]
              and lse_err <= ATOL["lse"]
              and bool(torch.isfinite(out.float()).all()))
        log(f"[kernel] flash_forward {name}: out max_abs_err {err:.3e} "
            f"(atol {ATOL[case['dtype']]:g}), lse max_abs_err "
            f"{lse_err:.3e} (atol {ATOL['lse']:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_forward disagrees with its plain "
                                 f"version on case {name}")
        errs[name] = err

    q, k, v, seg = _inputs(torch, MAIN, seed=100)
    causal = MAIN["causal"]
    kernel_ms = _time_ms(torch, lambda: attn.flash_forward(q, k, v, causal))
    plain_ms = _time_ms(torch,
                        lambda: attn.flash_forward_plain(q, k, v, causal),
                        reps=20)
    # yardstick only: PyTorch's fused attention on the same inputs (the
    # port never calls it)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(
        torch, lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True))
    bound_ms, bound_by = _flash_bound(torch, MAIN, seg)
    log(f"[kernel] flash_forward at b=2 s=512 nh=32 nkv=8 hd=128 bf16 "
        f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_forward", "route": "cuda",
            "source": "kubedl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "kubedl_tpu/ops/attention.py:259:_flash_kernel",
            "max_abs_err": errs["main"], "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _post(url: str, path: str, body: dict) -> str:
    req = urllib.request.Request(
        url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return r.read().decode()


def phase_serving(torch, cfg, device="cuda"):
    """Drive the serving path; returns flash_forward launches during it."""
    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.serving import (GenerateConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)
    from kubedl_tpu_torch.serving.engine import greedy_rollout
    from kubedl_tpu_torch.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"[serve] model: d_model {cfg.d_model}, {cfg.n_layers} layers "
        f"deep, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.2f} B params "
        f"{str(cfg.dtype).removeprefix('torch.')}, random from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = InferenceEngine(cfg, params, GenerateConfig(max_len=1024),
                          device=device)
    srv = InferenceServer(eng, ServerConfig(
        model_name="llama3-8b", host="127.0.0.1", port=0,
        tokenizer=ByteTokenizer())).start()
    rng = np.random.default_rng(0)
    try:
        attn.flash_forward.launches = 0
        # 1. buffered :predict, 4 instances of mixed lengths
        lens = (256, 200, 97, 31)
        prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]
        t0 = time.perf_counter()
        got = json.loads(_post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": 16}
                          for p in prompts]}))
        preds = [p["tokens"] for p in got["predictions"]]
        if [len(t) for t in preds] != [16] * 4 or not all(
                0 <= t < cfg.vocab_size for p in preds for t in p):
            raise AssertionError(f"bad :predict tokens {preds}")
        log(f"[serve] :predict 4 instances (lengths {lens}) x 16 tokens in "
            f"{time.perf_counter() - t0:.2f} s")
        # 2. streamed :predict
        raw = _post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": prompts[2], "max_tokens": 8}],
            "stream": True})
        events = [json.loads(line[len("data: "):])
                  for line in raw.splitlines() if line.startswith("data: ")]
        streamed = [e["token"] for e in events if "token" in e]
        if not (events[-1].get("done") and events[-1]["tokens"] == streamed
                and len(streamed) == 8):
            raise AssertionError(f"bad stream {events}")
        log(f"[serve] streamed :predict: {len(streamed)} token events + done")
        # 3. /v1/completions on text
        cmpl = json.loads(_post(srv.url, "/v1/completions", {
            "prompt": "The port serves Llama-3-8B on one card.",
            "max_tokens": 8}))
        if cmpl["usage"]["completion_tokens"] != 8:
            raise AssertionError(f"bad completion {cmpl}")
        log(f"[serve] /v1/completions: usage {cmpl['usage']}")
        # 4. /v1/embeddings, 2 inputs: every layer launches the kernel once
        texts = ["kubedl " * 73, "a TPU kernel ported by hand to Hopper " * 8]
        texts[0] = texts[0][:511]          # + BOS = 512 tokens: MAIN's shape
        before = attn.flash_forward.launches
        t0 = time.perf_counter()
        emb = json.loads(_post(srv.url, "/v1/embeddings", {"input": texts}))
        emb_s = time.perf_counter() - t0
        launched = attn.flash_forward.launches - before
        vecs = np.asarray([d["embedding"] for d in emb["data"]])
        norms = np.linalg.norm(vecs, axis=-1)
        if vecs.shape != (2, cfg.d_model) or not np.isfinite(vecs).all() \
                or np.abs(norms - 1).max() > 1e-3:
            raise AssertionError(f"bad embeddings: shape {vecs.shape}, "
                                 f"norms {norms}")
        if launched != cfg.n_layers:
            raise AssertionError(f"embeddings launched flash_forward "
                                 f"{launched} times, want {cfg.n_layers}")
        log(f"[serve] /v1/embeddings 2 inputs ({emb['usage']['prompt_tokens']}"
            f" tokens) in {emb_s:.3f} s: {launched} flash_forward launches, "
            f"unit norms {norms.round(6).tolist()}")
        # 5. greedy :predict with equal lengths against greedy_rollout
        same = rng.integers(3, cfg.vocab_size, (4, 128))
        got = json.loads(_post(srv.url, "/v1/models/llama3-8b:predict", {
            "instances": [{"prompt_tokens": p, "max_tokens": 16}
                          for p in same.tolist()]}))
        served = [p["tokens"] for p in got["predictions"]]
        rolled = greedy_rollout(cfg, eng.params, same, 16).tolist()
        if served != rolled:
            raise AssertionError(f"greedy :predict {served} != "
                                 f"greedy_rollout {rolled}")
        log("[serve] greedy :predict (4 x 128 tokens) == greedy_rollout")
        launches = attn.flash_forward.launches

        # the embeddings against the same forward with the plain attention
        # path (chunked) in place of the kernel
        from unittest import mock

        from kubedl_tpu_torch.tokenizer import encode_prompt
        tok = ByteTokenizer()
        ids = [encode_prompt(tok, t) for t in texts]
        toks = np.zeros((2, max(map(len, ids))), np.int64)
        for i, r in enumerate(ids):
            toks[i, :len(r)] = r
        plain = mock.patch.object(
            llama, "multi_head_attention",
            lambda *a, **k: attn.multi_head_attention(*a, impl="chunked",
                                                      **k))
        with plain, torch.inference_mode():
            x = llama.forward_hidden(cfg, eng.params,
                                     torch.as_tensor(toks, device=device))
        ref = []
        for i, r in enumerate(ids):
            pooled = x[i, :len(r)].float().mean(0)
            ref.append((pooled / pooled.norm()).cpu().numpy())
        cos = [float(np.dot(a, b)) for a, b in zip(vecs, ref)]
        if min(cos) < 0.99:
            raise AssertionError(f"embeddings disagree with the plain "
                                 f"attention path: cosine {cos}")
        log(f"[serve] embeddings vs the plain attention path: cosine "
            f"{[round(c, 6) for c in cos]}, max_abs_err "
            f"{float(np.abs(vecs - np.asarray(ref)).max()):.3e}")

        perf = eng.score_throughput(batch=4, prompt_len=128, new_tokens=16)
        log(f"[serve] batch 4, prompt 128: TTFT {perf['ttft_ms']:.2f} ms; "
            f"a 16-token generation {perf['latency_per_token_ms']:.3f} ms "
            f"per token, prefill included "
            f"({perf['decode_tokens_per_s']:.1f} tokens/s)")
    finally:
        srv.stop()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import kubedl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    phase_build()
    row = phase_kernel_check(torch)
    from kubedl_tpu_torch.models import llama
    row["launches"] = phase_serving(torch, llama.llama3_8b())
    log(f"[serve] {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak "
        "device memory")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``). Imports only the
port (``kubedl_tpu_torch``), never JAX or the JAX package. Phases; any
failure raises and the script exits non-zero before its last line:

1. build — every kernel under ``kubedl_tpu_torch/csrc/`` with ``nvcc``
   for ``sm_90a`` (build seconds and ``ptxas`` resource lines printed);
2. forward kernel check — the flash forward against its plain PyTorch
   version on the card, on the serving path's shape, the edge cases and
   the training shape at b=1, each case on the route ``flash_fwd_route``
   gives it (``sm90``: the tensor-core kernel of ``flash_fwd_sm90.cu``
   for bf16/f16 at hd 64 and 128; ``simt``: ``flash_fwd.cu`` for the
   rest), timed beside its plain version, SDPA, its bound and the
   earlier design (``flash_fwd.cu`` on the same bf16 inputs);
3. serving — Llama-3-8B at full width (random bf16 weights from a seed)
   behind ``InferenceServer`` over ``InferenceEngine``: ``:predict``
   (buffered, streamed, and greedy held against ``greedy_rollout``),
   ``/v1/completions`` and ``/v1/embeddings``, whose every layer must
   launch the flash kernel once, every launch on the ``sm90`` route;
4. backward kernel check — the dQ and dK/dV kernels against their plain
   versions on the forward's 13 cases and the training shape at b=1, each
   case on the route ``flash_bwd_route`` gives it (``sm90``: the
   tensor-core kernels of ``flash_bwd_sm90.cu`` for bf16/f16 at hd 64 and
   128; ``simt``: ``flash_bwd.cu`` for the rest);
5. timing at the training shape (b=4, s=2048, Llama-3-8B's heads, bf16,
   causal) — each of the three kernels beside its plain version, SDPA's
   forward or backward and its bound (the forward also beside its
   earlier design), and Δ (``flash_delta``);
6. training — ``python -m kubedl_tpu_torch.train``'s ``main`` in-process
   on Llama-3-8B at full width, 8 layers deep, batch 4 x 2048, 6 steps
   on one repeated batch: seconds per step, tokens/s, MFU, peak memory,
   falling loss and the kernels' launches per step, every forward and
   backward launch on the ``sm90`` route;
7. gradient check — every parameter's gradient at b=1 through the
   kernels against the gradient through the chunked attention path;
8. the kernels line (JSON), the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import unittest.mock
import urllib.request
from pathlib import Path

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

#: the training path's attention shape: Llama-3-8B's heads at the
#: training slice's batch 4 x seq 2048
TRAIN = dict(b=4, sq=2048, sk=2048, nh=32, nkv=8, hd=128, dtype="bfloat16",
             causal=True)
#: dq/dk/dv sum up to reps * s terms of growing size: bf16 results within
#: 4 bf16 ulps (2**-7 each) at the scale of the largest value, f32 within
#: 1e-5 of that scale
BWD_TOL = {"bfloat16": 4 * 2.0 ** -7, "float32": 1e-5}
#: causal dq/dk/dv are large at the first rows and keys and small in the
#: bulk, so the bound above sits near a typical value. The norm-wise
#: relative error ||got - want|| / ||want|| cannot hide in the bulk: the
#: kernel and the plain version both sum in float32 and round once, so
#: bf16 results differ by at most one rounding (2**-8 relative) wherever
#: they differ, and f32 ones by reordered sums; the bound is twice that
BWD_NORM_TOL = {"bfloat16": 2 * 2.0 ** -8, "float32": 1e-5}
#: operations per kept (row, key) pair: K1 q.k and p.v; K2 adds dO.v and
#: ds.k; K3 q.k, dO.v, p^T.dO and ds^T.q
OPS_PER_PAIR = {"flash_forward": 4, "flash_dq": 6, "flash_dkv": 8}
TRAIN_STEPS = 6
#: the tensor-core kernels' designs, for the kernels line
DESIGN = {
    "flash_forward": "wgmma bf16, persistent grid (1 block per SM) dealing "
                     "(b*nh, 128 q rows) tiles heaviest first; TMA Q and a "
                     "3-stage ring of 128-key K/V tiles (K and V under "
                     "their own mbarriers) run on across tiles; 1 producer "
                     "warp + 2 consumer warpgroups of 64 q rows; S = Q.K^T "
                     "from smem, online softmax in registers (exp2, quad "
                     "reductions, branch-free masks), O += P.V with P from "
                     "registers (rest of P in a second product on edge "
                     "tiles), O through smem by TMA store",
    "flash_dq": "wgmma bf16, TMA ring of K/V tiles (2 stages) under "
                "mbarriers, 1 producer warp + 2 consumer warpgroups of 64 q "
                "rows, block per (b*nh, 128 q rows), heaviest first; S and "
                "dP from smem, dQ += dS.K with dS from registers",
    "flash_dkv": "wgmma bf16, K/V resident, TMA ring of (Q, dO, lse, delta) "
                 "tiles (2 stages) under mbarriers, 1 producer warp + 2 "
                 "consumer warpgroups of 64 k rows, block per (b*nkv, 128 k "
                 "rows) over the GQA group's heads, heaviest first; S^T and "
                 "dP^T from smem, dV += P^T.dO and dK += dS^T.Q from "
                 "registers"}
#: norm-wise relative gap of a parameter's gradient between the kernel
#: path and the chunked path: both round attention outputs and dq/dk/dv
#: to bf16 (unit roundoff 2**-9), at other places, through 8 layers; the
#: bound allows ~25 roundoffs of drift
GRAD_REL_BOUND = 0.05
BUILD_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"
#: cycles of the spin before each timed call (~0.25 ms at the H100's clock)
SPIN_CYCLES = 500_000


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
    on the serving path. A spin on the card (~0.25 ms) then keeps it busy
    while the host runs the call's Python and launch path, so the start
    event does not fire before the call's first kernel is queued and the
    time is the card's alone (the host's share is timed apart)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def _earlier_fwd_ms(torch, attn, fn, **kw) -> float:
    """``_time_ms`` of ``fn`` with every forward launch sent to the
    ``simt`` route: the earlier design of K1 (``flash_fwd.cu``) on inputs
    the ``sm90`` route takes, timed as the new design is."""
    with unittest.mock.patch.object(attn, "flash_fwd_route",
                                    lambda dtype, hd: "simt"):
        before = attn.flash_forward.launches_by_route["simt"]
        ms = _time_ms(torch, fn, **kw)
        if attn.flash_forward.launches_by_route["simt"] == before:
            raise AssertionError("the earlier design was not launched")
    return ms


def _flash_bound(torch, case, seg, name="flash_forward") -> tuple:
    """(ms, "bytes" or "operations"): the least time for the work these
    inputs need. Each input and output moves once at the HBM rate: K1
    reads q/k/v and writes out/lse, K2 reads q/k/v/dO/lse/Δ and writes
    dq, K3 reads the same and writes dk/dv. The products of the (row,
    key) pairs the mask keeps (``OPS_PER_PAIR`` x hd operations each) run
    at the peak rate of the input type."""
    b, sq, sk, nh, nkv, hd = (case[n] for n in
                              ("b", "sq", "sk", "nh", "nkv", "hd"))
    item = 2 if case["dtype"] == "bfloat16" else 4
    q_side, kv_side, rows = b * sq * nh * hd, b * sk * nkv * hd, b * nh * sq
    moved = {"flash_forward": item * (2 * q_side + 2 * kv_side) + 4 * rows,
             "flash_dq": item * (3 * q_side + 2 * kv_side) + 8 * rows,
             "flash_dkv": item * (2 * q_side + 4 * kv_side) + 8 * rows}[name]
    rows_i = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    keep = torch.ones(1, sq, sk, dtype=torch.bool)
    if case["causal"]:
        q_off, k_off = case.get("offsets") or (0, 0)
        keep = (cols + k_off) <= (rows_i + q_off)
        if case.get("window", 0):
            keep &= (cols + k_off) > (rows_i + q_off) - case["window"]
        keep = keep[None]
    if seg is not None:
        seg = seg.cpu()
        keep = keep & (seg[:, :, None] == seg[:, None, :])
    pairs = int(keep.expand(b, sq, sk).sum())
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (OPS_PER_PAIR[name] * hd * pairs * nh
             / PEAK_FLOPS_PER_S[case["dtype"]])
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
            if any(w in line for w in ("Used", "spill", "wgmma",
                                       "Performance")):
                log(f"[build] {name}: {line.strip()}")


#: the kernels' check cases: the serving shape and the edge cases
CASES = {
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
#: the training shape at b=1, checked beside the edge cases
TRAIN_B1 = {**TRAIN, "b": 1}


def phase_kernel_check(torch):
    from kubedl_tpu_torch.ops import attention as attn

    errs = {}
    for i, (name, case) in enumerate({**CASES,
                                      "train_b1": TRAIN_B1}.items()):
        q, k, v, seg = _inputs(torch, case, seed=100 + i)
        route = attn.flash_fwd_route(q.dtype, case["hd"])
        before = attn.flash_forward.launches_by_route[route]
        out, lse = attn.flash_forward(q, k, v, case["causal"], **_kw(case, seg))
        ref, ref_lse = attn.flash_forward_plain(q, k, v, case["causal"],
                                                **_kw(case, seg))
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = (math.isfinite(err) and err <= ATOL[case["dtype"]]
              and lse_err <= ATOL["lse"]
              and bool(torch.isfinite(out.float()).all())
              and attn.flash_forward.launches_by_route[route] == before + 1)
        log(f"[kernel] flash_forward {name} ({route}): out max_abs_err "
            f"{err:.3e} (atol {ATOL[case['dtype']]:g}), lse max_abs_err "
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
    earlier_ms = _earlier_fwd_ms(
        torch, attn, lambda: attn.flash_forward(q, k, v, causal))
    # the host's share: back-to-back calls, not synchronised, so the card
    # (faster here) waits on the wrapper's checks and the launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        attn.flash_forward(q, k, v, causal)
    host_ms = (time.perf_counter() - t0) * 1e3 / 100
    torch.cuda.synchronize()
    log(f"[kernel] flash_forward at b=2 s=512 nh=32 nkv=8 hd=128 bf16 "
        f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"earlier design (flash_fwd.cu) {earlier_ms:.4f} ms; host path "
        f"{host_ms:.4f} ms per call back to back")
    return {"max_abs_err": errs["main"], "train_max_abs_err":
            errs["train_b1"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "earlier_design_ms": earlier_ms,
            "host_ms": host_ms}


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
        attn.flash_forward.launches_by_route = {"sm90": 0, "simt": 0}
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
        before_sm90 = attn.flash_forward.launches_by_route["sm90"]
        t0 = time.perf_counter()
        emb = json.loads(_post(srv.url, "/v1/embeddings", {"input": texts}))
        emb_s = time.perf_counter() - t0
        launched = attn.flash_forward.launches - before
        on_sm90 = attn.flash_forward.launches_by_route["sm90"] - before_sm90
        vecs = np.asarray([d["embedding"] for d in emb["data"]])
        norms = np.linalg.norm(vecs, axis=-1)
        if vecs.shape != (2, cfg.d_model) or not np.isfinite(vecs).all() \
                or np.abs(norms - 1).max() > 1e-3:
            raise AssertionError(f"bad embeddings: shape {vecs.shape}, "
                                 f"norms {norms}")
        if launched != cfg.n_layers or on_sm90 != launched:
            raise AssertionError(f"embeddings launched flash_forward "
                                 f"{launched} times, {on_sm90} on sm90; "
                                 f"want {cfg.n_layers}, all on sm90")
        log(f"[serve] /v1/embeddings 2 inputs ({emb['usage']['prompt_tokens']}"
            f" tokens) in {emb_s:.3f} s: {launched} flash_forward launches, "
            f"all sm90, unit norms {norms.round(6).tolist()}")
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
        if attn.flash_forward.launches_by_route != {"sm90": launches,
                                                    "simt": 0}:
            raise AssertionError(
                f"serving launched flash_forward on routes "
                f"{attn.flash_forward.launches_by_route}: every launch "
                f"should take sm90")

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


def _bwd_err(torch, got, want, dtype) -> dict:
    """The max abs error beside its tolerance at the largest value's
    scale, the norm-wise relative error beside its bound, and the median
    |want| (the bulk's scale)."""
    got, want = got.float(), want.float()
    mag = want.abs()
    diff = got - want
    err = dict(max=float(diff.abs().max()),
               tol=BWD_TOL[dtype] * max(float(mag.max()), 1.0),
               rel=float(diff.norm() / want.norm().clamp_min(1e-30)),
               rel_tol=BWD_NORM_TOL[dtype], median=float(mag.median()))
    err["ok"] = (math.isfinite(err["max"]) and err["max"] <= err["tol"]
                 and err["rel"] <= err["rel_tol"]
                 and bool(torch.isfinite(got).all()))
    return err


def phase_bwd_check(torch):
    """K2 and K3 against their plain versions on the forward's cases and
    the training shape at b=1. Returns {kernel: max abs error} there."""
    from kubedl_tpu_torch.ops import attention as attn

    cases = {**CASES, "train_b1": TRAIN_B1}
    errs = {}
    for i, (name, case) in enumerate(cases.items()):
        q, k, v, seg = _inputs(torch, case, seed=200 + i)
        do = torch.randn(q.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(300 + i)).to(q.dtype)
        causal, kw = case["causal"], _kw(case, seg)
        route = attn.flash_bwd_route(q.dtype, case["hd"])
        o, lse = attn.flash_forward(q, k, v, causal, **kw)
        delta = attn.flash_delta(o, do)
        dq = attn.flash_dq(q, k, v, do, lse, delta, causal, **kw)
        dk, dv = attn.flash_dkv(q, k, v, do, lse, delta, causal, **kw)
        ref_dq = attn.flash_dq_plain(q, k, v, do, lse, delta, causal, **kw)
        ref_dk, ref_dv = attn.flash_dkv_plain(q, k, v, do, lse, delta,
                                              causal, **kw)
        torch.cuda.synchronize()
        parts = []
        for label, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                 ("dv", dv, ref_dv)):
            e = _bwd_err(torch, got, want, case["dtype"])
            parts.append(f"{label} {e['max']:.3e} (tol {e['tol']:.3g}, "
                         f"median |want| {e['median']:.3g}) rel "
                         f"{e['rel']:.3e} (bound {e['rel_tol']:.3g})")
            if not e["ok"]:
                raise AssertionError(f"backward kernel disagrees with its "
                                     f"plain version on case {name}: "
                                     f"{label} {e}")
            errs[(name, label)] = e["max"]
        log(f"[bwd] {name} ({route}): " + ", ".join(parts) + " ok")
    return {"flash_dq": errs[("train_b1", "dq")],
            "flash_dkv": max(errs[("train_b1", "dk")],
                             errs[("train_b1", "dv")])}


def phase_timing(torch):
    """K1, K2 and K3 at the training shape, each beside its plain
    version, SDPA (forward for K1, backward for K2 and K3 together: the
    one library call that computes dq/dk/dv) and its bound; and Δ, the
    PyTorch op the backward runs before K2 and K3."""
    from kubedl_tpu_torch.ops import attention as attn

    case = TRAIN
    q, k, v, _ = _inputs(torch, case, seed=400)
    do = torch.randn(q.shape, device="cuda",
                     generator=torch.Generator(device="cuda")
                     .manual_seed(401)).to(q.dtype)
    causal = case["causal"]
    o, lse = attn.flash_forward(q, k, v, causal)
    delta = attn.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # yardsticks only (the port never calls SDPA): the forward with GQA,
    # the backward on k/v repeated to the q heads
    reps = case["nh"] // case["nkv"]
    leaves = [t.detach().clone().requires_grad_() for t in
              (qt, kt.repeat_interleave(reps, 1), vt.repeat_interleave(reps,
                                                                      1))]
    out = sdpa(*leaves, is_causal=causal)
    gt = do.transpose(1, 2)
    sdpa_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, gt, retain_graph=True))
    timed = {
        "flash_forward": (lambda: attn.flash_forward(q, k, v, causal),
                          lambda: attn.flash_forward_plain(q, k, v, causal),
                          _time_ms(torch, lambda: sdpa(
                              qt, kt, vt, is_causal=causal,
                              enable_gqa=True))),
        "flash_dq": (lambda: attn.flash_dq(*args),
                     lambda: attn.flash_dq_plain(*args), sdpa_bwd_ms),
        "flash_dkv": (lambda: attn.flash_dkv(*args),
                      lambda: attn.flash_dkv_plain(*args), sdpa_bwd_ms),
    }
    rows = {}
    for name, (kernel, plain, library_ms) in timed.items():
        ms = _time_ms(torch, kernel, reps=20, warmup=2)
        plain_ms = _time_ms(torch, plain, reps=5, warmup=1)
        bound_ms, bound_by = _flash_bound(torch, case, None, name)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        if name == "flash_forward":
            rows[name]["earlier_design_ms"] = _earlier_fwd_ms(
                torch, attn, kernel, reps=20, warmup=2)
        log(f"[time] {name} at b=4 s=2048 nh=32 nkv=8 hd=128 bf16 causal: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{'backward ' if name != 'flash_forward' else ''}"
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            + (f", earlier design (flash_fwd.cu) "
               f"{rows[name]['earlier_design_ms']:.4f} ms"
               if name == "flash_forward" else ""))
    rows["flash_dq"]["delta_ms"] = _time_ms(
        torch, lambda: attn.flash_delta(o, do), reps=20, warmup=2)
    log(f"[time] flash_delta (PyTorch) at the same shape: "
        f"{rows['flash_dq']['delta_ms']:.4f} ms")
    return rows


def _train_config() -> tuple:
    """(config path, token path, config dict) of the training phase: the
    slice's Llama-3-8B run on one batch of 4 x 2049 tokens from seed 0,
    written as a token file so every step sees the same rows."""
    import numpy as np

    BUILD_OUT.mkdir(parents=True, exist_ok=True)
    tokens = BUILD_OUT / "train_tokens.bin"
    np.random.default_rng(0).integers(0, 128256, 4 * 2049,
                                      dtype=np.int32).tofile(tokens)
    cfg = {"model": "llama.llama3_8b", "model_overrides": {"n_layers": 8},
           "mode": "pretrain", "data": {"kind": "tokens",
                                        "path": str(tokens)},
           "batch": 4, "seq": 2048, "steps": TRAIN_STEPS, "seed": 0,
           "optimizer": {"warmup_steps": 1}, "log_every": 1}
    path = BUILD_OUT / "train.json"
    path.write_text(json.dumps(cfg))
    return str(path), str(tokens), cfg


def model_flops_per_token(cfg, seq: int) -> float:
    """Fwd+bwd FLOPs per trained token (``bench.py``'s formula): 6*N
    params term + causal-attention term 12*L*d_head*n_heads*(seq/2)."""
    return (6.0 * cfg.num_params
            + 12.0 * cfg.n_layers * cfg.hd * cfg.n_heads * (seq / 2))


def phase_training(torch):
    """``python -m kubedl_tpu_torch.train``'s main, in-process. Returns
    (launches by kernel, config path, token path)."""
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.train import __main__ as train_main

    cfg_path, tokens, cfg = _train_config()
    config, _ = train_main.resolve_model(cfg, device="cuda")
    n_layers = config.n_layers
    marks = []
    torch.cuda.reset_peak_memory_stats()
    log(f"[train] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before training; model {config.num_params / 1e9:.3f} B params, "
        f"{n_layers} layers, d_model {config.d_model}, heads "
        f"{config.n_heads}/{config.n_kv_heads}, d_ff {config.d_ff}, vocab "
        f"{config.vocab_size}, remat {config.remat}, loss_chunk "
        f"{config.loss_chunk}")
    kernels = (attn.flash_forward, attn.flash_dq, attn.flash_dkv)
    for fn in kernels:
        fn.launches = 0
    for fn in kernels:
        fn.launches_by_route = {"sm90": 0, "simt": 0}
    t0 = time.perf_counter()
    rc = train_main.main(["--config", cfg_path],
                         on_step=lambda step, loss: marks.append(
                             (time.perf_counter(), step, loss)))
    launches = {fn.__name__: fn.launches for fn in kernels}
    by_route = {fn.__name__: dict(fn.launches_by_route) for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    losses = [m[2] for m in marks]
    if rc != 0 or len(marks) != TRAIN_STEPS:
        raise AssertionError(f"training returned {rc} after {len(marks)} "
                             f"steps")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    want = {"flash_forward": 2 * n_layers * TRAIN_STEPS,
            "flash_dq": n_layers * TRAIN_STEPS,
            "flash_dkv": n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"training launched {launches}, want {want} "
                             f"(K1 2*L per step with remat, K2/K3 L)")
    for name, routes in by_route.items():
        if routes != {"sm90": want[name], "simt": 0}:
            raise AssertionError(f"training launched {name} on routes "
                                 f"{routes}: every launch should take sm90")
    steady = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    step_s = sum(steady) / len(steady)
    tokens_per_step = cfg["batch"] * cfg["seq"]
    tok_s = tokens_per_step / step_s
    mfu = (model_flops_per_token(config, cfg["seq"]) * tok_s
           / PEAK_FLOPS_PER_S["bfloat16"])
    log(f"[train] losses {[round(x, 4) for x in losses]}")
    log(f"[train] first step {marks[0][0] - t0:.3f} s (model init, data "
        f"and first launches included); steps 2-{TRAIN_STEPS}: "
        f"{step_s:.4f} s per step, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} against 989 TFLOP/s bf16 "
        f"({model_flops_per_token(config, cfg['seq']):.4e} FLOP/token)")
    log(f"[train] per-step times {[round(x, 4) for x in steady]} s")
    log(f"[train] {peak / 2**30:.2f} GiB peak device memory; launches "
        f"{launches} over {TRAIN_STEPS} steps = "
        f"{ {k: n // TRAIN_STEPS for k, n in launches.items()} } per step; "
        f"routes {by_route}")
    return launches, cfg, tokens


def phase_grad_check(torch, cfg, tokens):
    """One step's gradient of every parameter leaf at b=1, through the
    kernels and through the chunked attention path, on the same weights
    and tokens."""
    from unittest import mock

    import numpy as np

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import attention as attn
    from kubedl_tpu_torch.train import __main__ as train_main
    from kubedl_tpu_torch.train.trainer import tree_leaves

    config, _ = train_main.resolve_model(cfg, device="cuda")
    row = np.fromfile(tokens, dtype=np.int32)[:cfg["seq"] + 1]
    toks = torch.as_tensor(row[None].astype(np.int64), device="cuda")
    params = llama.init_params(
        config, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    leaves = tree_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)

    def grads(impl):
        patch = mock.patch.object(
            llama, "multi_head_attention",
            lambda *a, **k: attn.multi_head_attention(*a, impl=impl, **k))
        with patch:
            loss = llama.loss_fn(config, params, toks[:, :-1], toks[:, 1:])
            out = torch.autograd.grad(loss, [p for _, p in leaves])
        return loss.item(), out

    before = attn.flash_dq.launches
    loss_k, g_k = grads("kernel")
    if attn.flash_dq.launches != before + config.n_layers:
        raise AssertionError("the kernel path did not launch the dQ kernel "
                             "once per layer")
    loss_c, g_c = grads("chunked")
    rel = {}
    for (name, _), a, b in zip(leaves, g_k, g_c):
        rel[name] = float((a.float() - b.float()).norm()
                          / b.float().norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    log(f"[grad] b=1 s={cfg['seq']}: loss kernel {loss_k:.6f}, chunked "
        f"{loss_c:.6f}; relative gradient gap per leaf "
        f"{ {k: float(f'{x:.3e}') for k, x in rel.items()} }")
    log(f"[grad] worst {worst} {rel[worst]:.4e} (bound {GRAD_REL_BOUND})")
    if not rel[worst] <= GRAD_REL_BOUND:
        raise AssertionError(f"gradient of {worst} through the kernels is "
                             f"{rel[worst]:.3e} from the chunked path's")


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
    fwd = phase_kernel_check(torch)
    from kubedl_tpu_torch.models import llama
    serving_launches = phase_serving(torch, llama.llama3_8b())
    log(f"[serve] {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak "
        "device memory")
    gc.collect()                 # the 16 GB serving model goes first
    torch.cuda.empty_cache()
    bwd_err = phase_bwd_check(torch)
    times = phase_timing(torch)
    train_launches, cfg, tokens = phase_training(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_grad_check(torch, cfg, tokens)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    src = "kubedl_tpu_torch/csrc/"
    shape = "b=4 s=2048 nh=32 nkv=8 hd=128 bf16 causal"
    rows = [
        {"name": "flash_forward", "route": "cuda",
         "source": src + "flash_fwd_sm90.cu",
         "replaces": "kubedl_tpu/ops/attention.py:259:_flash_kernel",
         "launches": serving_launches + train_launches["flash_forward"],
         "launches_by_path": {
             "serving": serving_launches,
             "training": train_launches["flash_forward"]},
         "max_abs_err": fwd["train_max_abs_err"], **times["flash_forward"],
         "shape": shape, "library": "sdpa forward",
         "serving": {k: fwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "earlier_design_ms",
                                         "host_ms")},
         "kernel_route": "sm90", "design": DESIGN["flash_forward"]},
        {"name": "flash_dq", "route": "cuda",
         "source": src + "flash_bwd_sm90.cu",
         "replaces": "kubedl_tpu/ops/attention.py:449:_flash_dq_kernel",
         "launches": train_launches["flash_dq"],
         "max_abs_err": bwd_err["flash_dq"], **times["flash_dq"],
         "shape": shape, "library": "sdpa backward (dq, dk and dv)",
         "kernel_route": "sm90",
         "design": DESIGN["flash_dq"]},
        {"name": "flash_dkv", "route": "cuda",
         "source": src + "flash_bwd_sm90.cu",
         "replaces": "kubedl_tpu/ops/attention.py:512:_flash_dkv_kernel",
         "launches": train_launches["flash_dkv"],
         "max_abs_err": bwd_err["flash_dkv"], **times["flash_dkv"],
         "shape": shape, "library": "sdpa backward (dq, dk and dv)",
         "kernel_route": "sm90",
         "design": DESIGN["flash_dkv"]},
    ]
    print(json.dumps({"kernels": rows}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

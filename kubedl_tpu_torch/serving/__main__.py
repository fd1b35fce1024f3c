"""Predictor container entrypoint: ``python -m kubedl_tpu_torch.serving``.

Counterpart of ``python -m kubedl_tpu.serving``, with the same
environment contract:

* ``KUBEDL_MODEL_PATH``   — ``models/io.py`` artifact directory
* ``KUBEDL_MODEL_NAME``   — REST route name (default: dir basename)
* ``KUBEDL_SERVING_LANES``    — continuous-batching lane count (4)
* ``KUBEDL_SERVING_QUANTIZE`` — "int8", "int4", or "": weight-only
  quantization; the artifact loads on the host and each weight reaches
  the card already quantized
* ``KUBEDL_SERVING_SPEC_K``   — >0 enables speculative lanes with the
  draft model at ``KUBEDL_SERVING_DRAFT_PATH``: every lane drafts k tokens
  per round and ONE [lanes, k+1] target pass verifies them
* ``KUBEDL_SERVING_TP``       — >1 serves the model tensor-parallel over
  that many cards of this host: this process is rank 0 (the HTTP front,
  the tokenizer, the scheduler) on ``cuda:0`` and starts ranks 1..N-1 as
  ``python -m kubedl_tpu_torch.serving.tp`` on ``cuda:1..N-1``, which
  repeat its device steps; each rank loads only its shard of the
  artifact. Refused above the host's cards (on the CPU, its cores)
  before anything loads, with weight quantization, and where ``tp`` does
  not split the heads, ``d_ff`` or the vocabulary evenly
* ``KUBEDL_KV_MODE``          — "paged" (default), "dense" or "parity"
* ``KUBEDL_SERVING_KV_BLOCK`` / ``KUBEDL_SERVING_POOL_BLOCKS`` — paged
  pool geometry: tokens per block and usable block count (0 = engine
  defaults; the pool defaults to the dense slab's capacity)
* ``KUBEDL_SERVING_MAX_LEN``  — cache capacity per lane (1024)
* ``KUBEDL_SERVING_MAX_NEW``  — batch mode's default ``max_tokens`` (256)
* ``KUBEDL_SERVING_PORT``     — default 8501
* ``KUBEDL_SERVING_WARMUP``   — default 1: one tiny generation BEFORE the
  HTTP server binds (on the card it captures the decode graph), so
  readiness means "captured and serving"; 0 skips
* ``KUBEDL_TOKENIZER``        — "byte", or a directory of HuggingFace
  tokenizer assets; unset, assets inside the model directory load
  automatically; "off" disables even that

The engine runs on the card; ``main(..., device="cpu")`` is how tests
reach the CPU (its tensor-parallel ranks are gloo processes). SIGTERM
(pod shutdown) stops the HTTP server, drains the engine (posting stop to
the followers and waiting for them) and exits 0; a follower that exits
while serving ends the predictor with exit code 1.

Offline batch inference (no HTTP): ``--batch-input prompts.jsonl
--batch-output out.jsonl`` reads rows ``{"prompt": "text" | [ids],
"max_tokens"?: N}``, generates through the same engine the server would
use, writes ``{"prompt", "tokens", "text"?}`` rows in input order, and
exits.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading


def engine_settings(env) -> dict:
    """The engine's settings from the predictor's environment contract
    (the module docstring): ``build_engine``'s keyword arguments but the
    model path and the tokenizer's. ``Candidate.to_env()`` of the serving
    auto-configurator writes these names."""
    return {
        "lanes": int(env.get("KUBEDL_SERVING_LANES", "4") or 4),
        "quantize": env.get("KUBEDL_SERVING_QUANTIZE", ""),
        "spec_k": int(env.get("KUBEDL_SERVING_SPEC_K", "0") or 0),
        "draft_path": env.get("KUBEDL_SERVING_DRAFT_PATH", ""),
        "max_len": int(env.get("KUBEDL_SERVING_MAX_LEN", "1024") or 1024),
        "tp": int(env.get("KUBEDL_SERVING_TP", "1") or 1),
        "kv_block": int(env.get("KUBEDL_SERVING_KV_BLOCK", "0") or 0),
        "pool_blocks": int(env.get("KUBEDL_SERVING_POOL_BLOCKS", "0") or 0),
    }


def build_engine(model_path: str, lanes: int, quantize: str, spec_k: int,
                 draft_path: str = "", max_len: int = 1024, tp: int = 1,
                 eos_id: int = -1, tokenizer_vocab: int = 0,
                 kv_block: int = 0, pool_blocks: int = 0, device=None):
    """The ONE env-to-engine mapping (also used by tests): returns a
    started ``ContinuousBatchingEngine`` on ``device`` (the card unless
    the caller names the CPU). ``kv_block`` / ``pool_blocks`` (0 = engine
    defaults) size the paged KV pool; the layout itself is
    ``$KUBEDL_KV_MODE`` (paged by default). With ``quantize`` ("int8" or
    "int4") the weights load on the host and the engine quantizes them
    onto the device one matrix at a time, so the float weights never
    occupy the card. With ``tp`` > 1 this process becomes rank 0 of a
    tensor-parallel group whose other ranks it starts (see the module
    docstring); the engine's ``launcher`` holds them and ``stop`` ends
    them."""
    from .._device import resolve_device
    from ..models.io import read_config
    from .engine import (MESH_QUANTIZE_REFUSAL, check_serving_split,
                         local_device_count)

    dev = resolve_device(device)
    if tp > 1:
        have = local_device_count(dev)
        if have < tp:
            raise ValueError(f"KUBEDL_SERVING_TP={tp} but only {have} "
                             "local devices")
        if quantize:
            raise ValueError(MESH_QUANTIZE_REFUSAL)
    config = read_config(model_path)
    if eos_id >= config.vocab_size or tokenizer_vocab > config.vocab_size:
        # a mismatched tokenizer would encode ids past the embedding table
        # and serve garbage with a 200 — refuse at startup
        raise ValueError(
            f"tokenizer (vocab {tokenizer_vocab}, eos {eos_id}) does not "
            f"fit the model vocab ({config.vocab_size}) — wrong "
            "tokenizer for this model?")
    if spec_k > 0 and not draft_path:
        raise ValueError("KUBEDL_SERVING_SPEC_K > 0 needs "
                         "KUBEDL_SERVING_DRAFT_PATH")
    if tp > 1:
        check_serving_split(config, tp)
        if spec_k > 0:
            check_serving_split(read_config(draft_path), tp)
    from .batching import resolve_kv_mode
    spec = {"model_path": model_path, "lanes": lanes, "quantize": quantize,
            "spec_k": spec_k, "draft_path": draft_path, "max_len": max_len,
            "eos_id": eos_id, "kv_block": kv_block,
            "pool_blocks": pool_blocks, "kv_mode": resolve_kv_mode()}
    if tp == 1:
        return engine_for_rank(spec, dev).start()
    import json

    from ..parallel.launch import start_local_ranks
    from .tp import TIMEOUT_S
    if dev.type == "cuda":
        import torch
        dev = torch.device("cuda", 0)       # rank r takes card r
    ranks = start_local_ranks(tp, "kubedl_tpu_torch.serving.tp",
                              ["--spec", json.dumps(spec)], dev, TIMEOUT_S)
    try:
        engine = engine_for_rank(spec, dev, tp=tp)
    except BaseException:
        ranks.close(kill=True)
        raise
    engine.launcher = ranks
    return engine.start()


def engine_for_rank(spec: dict, device, tp: int = 1):
    """The engine of ``build_engine``'s ``spec`` on ``device``, not yet
    started: under ``tp`` > 1 (an open group of ``tp`` ranks) on this
    rank's serving mesh, every leaf loaded as this rank's shard only."""
    from ..models.io import load_model, read_config
    from .batching import ContinuousBatchingEngine
    from .engine import GenerateConfig, serving_cut

    mesh = None
    if tp > 1:
        from ..parallel.mesh import MeshConfig, build_mesh
        mesh = build_mesh(MeshConfig(dp=1, fsdp=1, tp=tp), device=device)

    def load(path, where):
        select = (None if mesh is None
                  else serving_cut(read_config(path), mesh))
        return load_model(path, device=where, select=select)

    quantize = spec["quantize"]
    config, params = load(spec["model_path"],
                          "cpu" if quantize else device)
    kw = {}
    if spec["kv_block"]:
        kw["kv_block"] = spec["kv_block"]
    if spec["pool_blocks"]:
        kw["pool_blocks"] = spec["pool_blocks"]
    if spec["spec_k"] > 0:
        dcfg, dparams = load(spec["draft_path"], device)
        kw.update(draft_config=dcfg, draft_params=dparams,
                  spec_k=spec["spec_k"])
    max_len = spec["max_len"]
    return ContinuousBatchingEngine(
        config, params, lanes=spec["lanes"], max_len=max_len,
        gen=GenerateConfig(max_len=max_len, eos_id=spec["eos_id"]),
        quantize=quantize or None, device=device, mesh=mesh,
        kv_mode=spec["kv_mode"], **kw)


def run_batch(engine, tokenizer, in_path: str, out_path: str,
              default_max_tokens: int = 256) -> int:
    """Offline bulk generation: all rows ride the continuous-batching
    lanes concurrently; output preserves input order."""
    import json

    from ..tokenizer import encode_prompt
    log = logging.getLogger("kubedl_tpu_torch.serving")
    rows = []
    with open(in_path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"no rows in {in_path}")
    prompts = []
    for i, row in enumerate(rows):
        p = row.get("prompt")
        if isinstance(p, str):
            if tokenizer is None:
                raise ValueError(
                    f"row {i}: text prompt needs a tokenizer "
                    "($KUBEDL_TOKENIZER or assets in the model dir)")
            prompts.append(encode_prompt(tokenizer, p))
        elif isinstance(p, list) and p:
            prompts.append([int(t) for t in p])
        else:
            raise ValueError(f"row {i}: prompt must be text or id list")
    caps = [int(r.get("max_tokens", default_max_tokens)) for r in rows]
    if hasattr(engine, "submit"):
        for p, cap in zip(prompts, caps):
            engine.validate(p, cap)
        outs = [r.result() for r in
                [engine.submit(p, cap) for p, cap in zip(prompts, caps)]]
    else:
        # an engine with the static contract (the speculative adapter):
        # buffered generate, each output cut to its row's cap
        outs = engine.generate(prompts, max(caps))
        outs = [o[:cap] for o, cap in zip(outs, caps)]
    with open(out_path, "w") as f:
        for done, (row, toks) in enumerate(zip(rows, outs), 1):
            out = {"prompt": row["prompt"], "tokens": toks}
            if tokenizer is not None:
                out["text"] = tokenizer.decode(toks)
            f.write(json.dumps(out) + "\n")
            if done % 50 == 0:
                log.info("batch inference: %d/%d rows", done, len(rows))
    log.info("batch inference: wrote %d rows to %s", len(rows), out_path)
    return 0


def main(argv=None, device=None) -> int:
    """Serve (or, with ``--batch-input``, generate offline) from
    ``$KUBEDL_MODEL_PATH``. ``device`` is the card unless the caller
    names the CPU (``device="cpu"``)."""
    import argparse

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("kubedl_tpu_torch.serving")
    ap = argparse.ArgumentParser(prog="python -m kubedl_tpu_torch.serving")
    ap.add_argument("--batch-input", help="JSONL prompts for offline "
                    "batch inference (no HTTP server)")
    ap.add_argument("--batch-output", help="JSONL output path")
    args = ap.parse_args(argv)
    if bool(args.batch_input) != bool(args.batch_output):
        ap.error("--batch-input and --batch-output go together")
    env = os.environ
    model_path = env.get("KUBEDL_MODEL_PATH", "")
    if not model_path:
        log.error("KUBEDL_MODEL_PATH is required")
        return 2
    settings = engine_settings(env)
    from ..tokenizer import has_tokenizer_assets, load_tokenizer
    tok_spec = env.get("KUBEDL_TOKENIZER", "")
    if not tok_spec and has_tokenizer_assets(model_path):
        # self-contained artifact: the checkpoint's tokenizer ships
        # alongside the weights
        tok_spec = model_path
    tokenizer = None if tok_spec == "off" else load_tokenizer(tok_spec)

    engine = build_engine(model_path, **settings,
                          eos_id=(tokenizer.eos_id if tokenizer is not None
                                  else -1),
                          tokenizer_vocab=(tokenizer.vocab_size
                                           if tokenizer is not None else 0),
                          device=device)
    if args.batch_input:
        try:
            return run_batch(engine, tokenizer, args.batch_input,
                             args.batch_output,
                             default_max_tokens=int(env.get(
                                 "KUBEDL_SERVING_MAX_NEW", "256") or 256))
        finally:
            engine.stop()
    if env.get("KUBEDL_SERVING_WARMUP", "1") == "1":
        # one generation BEFORE the HTTP server binds: on the card it
        # captures the decode graph, so the readiness probe means
        # "captured and serving"
        import time
        t0 = time.perf_counter()
        engine.submit([1], 2).result(timeout=600)
        log.info("warmup done in %.1fs", time.perf_counter() - t0)
    from .server import InferenceServer, ServerConfig
    server = InferenceServer(engine, ServerConfig(
        # `or`, not a get() default: the controller injects the var even
        # when the ModelVersion has no modelName (empty string)
        model_name=(env.get("KUBEDL_MODEL_NAME")
                    or os.path.basename(model_path.rstrip("/"))
                    or "model"),
        port=int(env.get("KUBEDL_SERVING_PORT", "8501") or 8501),
        tokenizer=tokenizer,
    )).start()
    log.info("serving %s on %s (lanes=%d quantize=%s kv=%s device=%s "
             "tp=%d tokenizer=%s)", model_path, server.url,
             settings["lanes"], settings["quantize"] or "off",
             engine.kv_mode, engine.device, settings["tp"],
             tok_spec if tokenizer is not None else "off")

    done = threading.Event()

    def shutdown(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    ranks = engine.launcher
    while not done.wait(1.0):
        if ranks is not None and ranks.failed.is_set():
            log.error("a tensor-parallel rank exited while serving")
            break
    failed = ranks is not None and ranks.failed.is_set()
    log.info("draining")
    server.stop()
    engine.stop()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

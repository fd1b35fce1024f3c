"""Inference HTTP server: the predictor process, ported.

Counterpart of ``kubedl_tpu/serving/server.py`` with every route, over
either engine: the continuous-batching ``ContinuousBatchingEngine`` (what
``python -m kubedl_tpu_torch.serving`` runs: lanes, per-request sampling,
token streaming, the prefix cache, speculative lanes) or the static
``InferenceEngine``:

* ``POST /v1/models/{name}:predict`` — body
  ``{"instances": [{"prompt_tokens": [...], "max_tokens": N}]}`` →
  ``{"predictions": [{"tokens": [...]}]}``; on the continuous engine each
  instance rides its own lane with its own sampling overrides
  (``temperature``/``top_k``/``top_p``), on the static one the instances
  are batched into a single generate call. With a tokenizer an instance
  may say ``{"text": ...}`` or ``{"messages": [...]}`` instead, and every
  prediction gains a decoded ``"text"``;
* the same route with ``"stream": true`` (single instance) — Server-Sent
  Events, one ``data: {"token": id}`` per generated token as its lane
  decodes it, then a final ``data: {"done": true, "tokens": [...]}``. The
  static engine emits them after the generation completes;
* ``POST /v1/models/{name}:registerPrefix`` — body ``{"prefix_tokens":
  [...], "pinned"?: bool, "model"?: adapter}``: prefill a shared system
  prompt once, scoped to one adapter of the engine's catalog with
  ``model`` (continuous engine only; a 400 on the static one);
* ``GET /v1/models/{name}`` — model status (readiness probe target);
* ``GET /metrics`` — Prometheus exposition (with the paged KV pool's
  gauges and per-lane draft acceptance on the continuous engine);
  ``GET /healthz`` — liveness;
* the OpenAI convention (with a tokenizer): ``POST /v1/completions``,
  ``POST /v1/chat/completions`` (buffered or streamed),
  ``POST /v1/embeddings`` (masked mean-pool of the final hidden states,
  L2-normalized) and ``GET /v1/models``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..metrics.registry import PagedKVMetrics, Registry


@dataclass
class ServerConfig:
    model_name: str = "model"
    host: str = "0.0.0.0"
    port: int = 8501               # TFServing's REST port
    max_batch: int = 16
    max_new_tokens: int = 256
    #: continuous-batching mode: bound on one request's wall time (and
    #: on each streamed token's wait) so a stopped engine surfaces as a
    #: JSON 500, not a hang
    request_timeout_s: float = 600.0
    #: cap on distinct registered prefixes: over it the least-recently-hit
    #: unpinned prefix is evicted (each holds KV blocks on the device)
    max_prefixes: int = 8
    #: optional text codec (``kubedl_tpu_torch.tokenizer``): enables "text"
    #: instances and decoded "text" in predictions/stream events
    tokenizer: Optional[object] = None


class InferenceServer:
    def __init__(self, engine, config: Optional[ServerConfig] = None):
        self.engine = engine
        self.config = config or ServerConfig()
        # one static generate (or embeddings forward) at a time: the card
        # runs one step at a time anyway
        self._gen_lock = threading.Lock()
        # itertools.count: next() is a single C call, safe under
        # ThreadingHTTPServer's concurrent handlers without a lock
        import itertools
        self._openai_ids = itertools.count(1)
        self._created = int(time.time())   # OpenAI model-object field
        self.metrics = Registry()
        self._m_requests = self.metrics.counter(
            "kubedl_serving_requests_total",
            "Prediction requests by mode and outcome",
            labels=("mode", "status"))
        self._m_tokens = self.metrics.counter(
            "kubedl_serving_generated_tokens_total",
            "Tokens generated across all requests")
        self._m_latency = self.metrics.histogram(
            "kubedl_serving_request_seconds",
            "Wall time per prediction request", labels=("mode",),
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60))
        self._m_ttft = self.metrics.histogram(
            "kubedl_serving_ttft_seconds",
            "Time to first streamed token",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10))
        self._m_kv = None
        if hasattr(engine, "pool_stats"):
            # continuous-batching predictors: paged KV pool occupancy,
            # prefix-sharing ratio and preemption counter on the scrape
            # page (dense mode still reports peak active lanes)
            self._m_kv = PagedKVMetrics(self.metrics)
        self._m_spec = self._m_spec_lane = None
        if hasattr(engine, "stats") and \
                hasattr(engine.stats, "acceptance_rate"):
            # speculative predictors (the continuous engine's speculative
            # lanes, or the standalone engine's adapter): draft quality on
            # the scrape page
            self._m_spec = (
                self.metrics.gauge("kubedl_serving_spec_proposed_total",
                                   "Draft tokens proposed"),
                self.metrics.gauge("kubedl_serving_spec_accepted_total",
                                   "Draft tokens accepted"),
                self.metrics.gauge("kubedl_serving_spec_acceptance_rate",
                                   "Lifetime draft acceptance rate"))
            if hasattr(engine, "lane_stats"):
                # the continuous engine's acceptance per lane
                self._m_spec_lane = self.metrics.gauge(
                    "kubedl_serving_spec_lane_acceptance_rate",
                    "Draft acceptance rate per continuous-batching lane",
                    labels=("lane",))
        server = self

        class Handler(_Handler):
            server_ref = server

        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self.config.host if self.config.host != "0.0.0.0" else "127.0.0.1"
        return f"http://{host}:{self.port}"

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="kubedl-inference", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def refresh_engine_metrics(self) -> None:
        """Pull the engine's pool and draft counters into the registry
        (on every ``/metrics`` scrape)."""
        if self._m_kv is not None:
            self._m_kv.refresh(self.engine.pool_stats())
        if self._m_spec is not None:
            st = self.engine.stats
            self._m_spec[0].set(st.proposed)
            self._m_spec[1].set(st.accepted)
            self._m_spec[2].set(st.acceptance_rate)
        if self._m_spec_lane is not None:
            for i, ls in enumerate(self.engine.lane_stats):
                self._m_spec_lane.set(ls.acceptance_rate, lane=str(i))

    # -- request handling --------------------------------------------------

    def _parse_instance(self, inst: dict) -> tuple:
        """(prompt, cap, want_logprobs, sampling) — the ONE validation/
        coercion rule for buffered and streaming predicts alike.
        ``sampling`` holds optional per-request temperature/top_k/top_p
        overrides (continuous-batching engines apply them per lane)."""
        toks = inst.get("prompt_tokens")
        if toks is None and ("text" in inst or "messages" in inst):
            tok = self.config.tokenizer
            if tok is None:
                raise ValueError(
                    "this predictor has no tokenizer (set "
                    "$KUBEDL_TOKENIZER); send prompt_tokens instead")
            if "messages" in inst:
                from ..tokenizer import render_chat
                toks = render_chat(tok, inst["messages"])
            else:
                if not isinstance(inst["text"], str) or not inst["text"]:
                    raise ValueError("text must be a non-empty string")
                from ..tokenizer import encode_prompt
                toks = encode_prompt(tok, inst["text"])
        if not isinstance(toks, list) or not toks:
            raise ValueError("each instance needs prompt_tokens or text")
        prompt = [int(t) for t in toks]
        cap = min(int(inst.get("max_tokens", 16)),
                  self.config.max_new_tokens)
        sampling = {}
        if "temperature" in inst:
            sampling["temperature"] = float(inst["temperature"])
        if "top_k" in inst:
            sampling["top_k"] = int(inst["top_k"])
        if "top_p" in inst:
            sampling["top_p"] = float(inst["top_p"])
        return prompt, cap, bool(inst.get("logprobs")), sampling

    def predict(self, body: dict) -> dict:
        instances = body.get("instances") or []
        if not instances:
            raise ValueError("no instances")
        if len(instances) > self.config.max_batch:
            raise ValueError(
                f"batch {len(instances)} exceeds max_batch "
                f"{self.config.max_batch}")
        prompts, caps, want_lp, samplings = [], [], [], []
        for inst in instances:
            p, cap, lp, sampling = self._parse_instance(inst)
            prompts.append(p)
            caps.append(cap)
            want_lp.append(lp)
            samplings.append(sampling)
        if hasattr(self.engine, "submit"):
            return self._predict_lanes(prompts, caps, want_lp, samplings)
        # static engine: decode to the longest request in one lockstep
        # batch, trim per instance to its own cap. Its sampler is
        # engine-wide — per-instance overrides need the lane engine.
        if any(samplings):
            raise ValueError(
                "per-request sampling params need the continuous-"
                "batching engine (this predictor runs the static one)")
        wl = any(want_lp)
        with self._gen_lock:
            outs = self.engine.generate(prompts, max(caps),
                                        return_logprobs=wl)
        preds = []
        for o, cap, lp in zip(outs, caps, want_lp):
            toks, lps = o if wl else (o, None)
            pred = {"tokens": toks[:cap]}
            if lp:
                pred["logprobs"] = lps[:cap]
            preds.append(pred)
        self._m_tokens.inc(sum(len(p["tokens"]) for p in preds))
        return {"predictions": self._decorate_text(preds)}

    def _predict_lanes(self, prompts, caps, want_lp, samplings) -> dict:
        """Continuous-batching engine: each instance rides its own lane
        (its background loop serializes device work — no lock), so a
        short request is never held back to the longest one's length.
        Every instance is validated before any is submitted: a bad late
        instance must 400 without burning lanes on discarded output."""
        for p, cap, s in zip(prompts, caps, samplings):
            self.engine.validate(p, cap)
            self.engine.validate_sampling(**s)
        reqs = [self.engine.submit(p, cap, logprobs=lp, **s)
                for p, cap, lp, s in zip(prompts, caps, want_lp, samplings)]
        timeout = self.config.request_timeout_s
        preds = []
        try:
            for r, lp in zip(reqs, want_lp):
                pred = {"tokens": r.result(timeout=timeout)}
                if lp:
                    pred["logprobs"] = r.logprobs
                preds.append(pred)
        except BaseException:
            # a timed-out (or aborted) batch must not keep burning lanes:
            # cancel every request still decoding before surfacing it
            for r in reqs:
                if not r.done.is_set():
                    r.cancel()
            raise
        finally:
            # tokens already generated are real device work even when a
            # later request times out
            self._m_tokens.inc(sum(len(r.tokens) for r in reqs))
        return {"predictions": self._decorate_text(preds)}

    def _decorate_text(self, preds: list) -> list:
        if self.config.tokenizer is not None:
            for p in preds:
                p["text"] = self.config.tokenizer.decode(p["tokens"])
        return preds

    def _with_text_events(self, events):
        """Add incremental ``"text"`` deltas to stream events (and the
        full decode to the final summary) when a tokenizer is configured.
        Token events whose bytes are mid-UTF-8-sequence carry an empty
        delta; the missing text arrives with the completing token."""
        from ..tokenizer import StreamDecoder
        dec = StreamDecoder(self.config.tokenizer)
        for ev in events:
            if "token" in ev:
                ev["text"] = dec.push(ev["token"])
            elif ev.get("done"):
                # full re-decode, not the decoder's held-back tail: the
                # summary must equal decode(tokens) exactly
                ev["text"] = self.config.tokenizer.decode(ev["tokens"])
            yield ev

    def predict_stream(self, body: dict):
        """Yield SSE event dicts for a single-instance streaming request.

        Validation errors raise BEFORE the first yield (the handler can
        still send a 400); anything after the first event is reported as
        a terminal ``{"error": ...}`` event on the open stream."""
        instances = body.get("instances") or []
        if len(instances) != 1:
            raise ValueError("stream mode takes exactly one instance")
        prompt, cap, want_lp, sampling = self._parse_instance(instances[0])

        if hasattr(self.engine, "submit"):
            self.engine.validate(prompt, cap)
            self.engine.validate_sampling(**sampling)   # before the 200

            def events():
                t0 = time.perf_counter()
                req = self.engine.submit(prompt, cap, logprobs=want_lp,
                                         **sampling)
                out, lps = [], []
                try:
                    # per-token bound: a stalled engine surfaces as an
                    # error event, not a silently frozen stream
                    for tok, lp in req.stream(
                            timeout=self.config.request_timeout_s):
                        if not out:
                            self._m_ttft.observe(time.perf_counter() - t0)
                        out.append(tok)
                        # per token, not on completion: an aborted stream
                        # still accounts for what it already served
                        self._m_tokens.inc()
                        ev = {"token": tok}
                        if lp is not None:
                            ev["logprob"] = lp
                            lps.append(lp)
                        yield ev
                finally:
                    # abandoned stream (client gone, stop string matched):
                    # free the lane instead of decoding into the void
                    if not req.done.is_set():
                        req.cancel()
                final = {"done": True, "tokens": out}
                if want_lp:
                    final["logprobs"] = lps
                yield final
            return (events() if self.config.tokenizer is None
                    else self._with_text_events(events()))

        # static engine: no incremental lane output — generate fully,
        # then emit token events (correctness-compatible fallback)
        if sampling:
            raise ValueError(
                "per-request sampling params need the continuous-"
                "batching engine (this predictor runs the static one)")

        def events_static():
            t0 = time.perf_counter()
            with self._gen_lock:
                outs = self.engine.generate([prompt], cap,
                                            return_logprobs=want_lp)
            toks_out, lps = outs[0] if want_lp else (outs[0], None)
            toks_out = toks_out[:cap]
            # post-hoc streaming: the first token arrives only after the
            # whole batch generated — the honest TTFT for this engine
            if toks_out:
                self._m_ttft.observe(time.perf_counter() - t0)
            self._m_tokens.inc(len(toks_out))
            for i, tok in enumerate(toks_out):
                ev = {"token": tok}
                if want_lp:
                    ev["logprob"] = lps[i]
                yield ev
            final = {"done": True, "tokens": toks_out}
            if want_lp:
                final["logprobs"] = lps[:cap]
            yield final
        return (events_static() if self.config.tokenizer is None
                else self._with_text_events(events_static()))

    # -- OpenAI-convention adapters ---------------------------------------

    def _openai_tok(self):
        tok = self.config.tokenizer
        if tok is None:
            raise ValueError(
                "OpenAI routes need a tokenizer (set $KUBEDL_TOKENIZER "
                "or ship tokenizer assets with the model)")
        return tok

    def _openai_parse(self, body: dict, chat: bool):
        """(prompt id lists, cap, sampling, stop strings) — the one
        request-to-instances rule for buffered and streaming flavors."""
        tok = self._openai_tok()
        from ..tokenizer import encode_prompt, render_chat
        if chat:
            prompts = [render_chat(tok, body.get("messages"))]
        else:
            p = body.get("prompt")
            if isinstance(p, str):
                prompts = [encode_prompt(tok, p)]
            elif isinstance(p, list) and p and \
                    all(isinstance(t, int) for t in p):
                prompts = [p]                      # token-id array form
            elif isinstance(p, list) and p and \
                    all(isinstance(s, str) for s in p):
                prompts = [encode_prompt(tok, s) for s in p]
            else:
                raise ValueError(
                    "prompt must be a string, list of strings, or "
                    "token-id array")
        n = int(body.get("n", 1))
        if n < 1:
            raise ValueError("n must be >= 1")
        cap = min(int(body.get("max_tokens", 16)),
                  self.config.max_new_tokens)
        sampling = {}
        if "temperature" in body:
            sampling["temperature"] = float(body["temperature"])
        if "top_p" in body:
            sampling["top_p"] = float(body["top_p"])
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        if not (isinstance(stop, list)
                and all(isinstance(s, str) and s for s in stop)):
            raise ValueError("stop must be a string or list of strings")
        return prompts, n, cap, sampling, stop

    @staticmethod
    def _apply_stop(text: str, stop: list):
        """(text truncated at the earliest stop match, matched?)."""
        cut = min((text.index(s) for s in stop if s in text),
                  default=None)
        return (text, False) if cut is None else (text[:cut], True)

    def _openai_id(self, prefix: str) -> str:
        return f"{prefix}-{next(self._openai_ids)}"

    def openai_models(self) -> dict:
        return {"object": "list", "data": [{
            "id": self.config.model_name, "object": "model",
            "created": self._created, "owned_by": "kubedl-tpu"}]}

    def openai_completions(self, body: dict, chat: bool) -> dict:
        prompts, n, cap, sampling, stop = self._openai_parse(body, chat)
        want_lp = bool(body.get("logprobs"))
        res = self.predict({"instances": [
            {"prompt_tokens": p, "max_tokens": cap, "logprobs": want_lp,
             **sampling}
            for p in prompts for _ in range(n)]})
        created = int(time.time())
        tok = self.config.tokenizer
        choices = []
        completion_tokens = 0
        for i, pred in enumerate(res["predictions"]):
            toks = pred["tokens"]
            completion_tokens += len(toks)
            text, matched = self._apply_stop(pred["text"], stop)
            finish = "stop" if matched or len(toks) < cap else "length"
            if matched and want_lp:
                # align logprobs with the truncated text: keep the
                # shortest token prefix whose decode already contains a
                # stop match (clients zip logprobs.tokens against text)
                for j in range(1, len(toks) + 1):
                    if self._apply_stop(tok.decode(toks[:j]), stop)[1]:
                        toks = toks[:j]
                        pred = {**pred,
                                "logprobs": pred["logprobs"][:j]}
                        break
            echo = (not chat) and bool(body.get("echo"))
            prompt_ids = prompts[i // max(n, 1)] if echo else []
            lp = None
            if want_lp:
                pieces = [tok.decode([t]) for t in toks]
                if echo:
                    # OpenAI echo contract: prompt tokens appear in the
                    # logprobs zip too, with null logprobs (we do not
                    # re-score the prompt)
                    pieces = [tok.decode([t])
                              for t in prompt_ids] + pieces
                    pred = {**pred, "logprobs":
                            [None] * len(prompt_ids)
                            + list(pred["logprobs"])}
                if chat:
                    # chat flavor: logprobs.content entries
                    lp = {"content": [
                        {"token": s, "logprob": float(v)}
                        for s, v in zip(pieces, pred["logprobs"])]}
                else:
                    lp = {"tokens": pieces,
                          "token_logprobs": [None if v is None
                                             else float(v)
                                             for v in pred["logprobs"]],
                          "top_logprobs": None, "text_offset": None}
            if chat:
                choices.append({"index": i, "finish_reason": finish,
                                "logprobs": lp,
                                "message": {"role": "assistant",
                                            "content": text}})
            else:
                if echo:
                    # OpenAI echo: the prompt text precedes the
                    # completion (distinct prompts repeat every n)
                    text = tok.decode(prompt_ids) + text
                choices.append({"index": i, "finish_reason": finish,
                                "text": text, "logprobs": lp})
        # each distinct prompt counts once, regardless of n (the OpenAI
        # usage contract clients build cost accounting on)
        prompt_tokens = sum(len(p) for p in prompts)
        return {
            "id": self._openai_id("chatcmpl" if chat else "cmpl"),
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": self.config.model_name,
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens},
        }

    def openai_embeddings(self, body: dict) -> dict:
        """``POST /v1/embeddings``: masked mean-pool of the model's final
        hidden states, L2-normalized — the standard decoder-as-embedder
        recipe. Serialized with generation on the device; on the card
        every layer's attention is one launch of the flash kernel. Under
        tensor-parallel serving the forward is one of the engine's device
        steps (``hidden_states``), so every rank runs it, on its own
        heads, in the order of the scheduler's steps."""
        tok = self._openai_tok()
        from ..tokenizer import encode_prompt
        inp = body.get("input")
        if isinstance(inp, str):
            texts = [inp]
        elif isinstance(inp, list) and inp and \
                all(isinstance(s, str) for s in inp):
            texts = inp
        else:
            raise ValueError("input must be a string or list of strings")
        if len(texts) > self.config.max_batch:
            raise ValueError(f"batch {len(texts)} exceeds max_batch "
                             f"{self.config.max_batch}")
        ids = [encode_prompt(tok, t) for t in texts]

        from .engine import resolve_family
        eng = self.engine
        config, params = eng.config, eng.params
        family = resolve_family(config)
        longest = max(len(r) for r in ids)
        if longest > config.max_seq_len:
            raise ValueError(
                f"input of {longest} tokens exceeds the model context "
                f"{config.max_seq_len}")
        # the JAX server pads to 128-token and power-of-two-row buckets to
        # bound its compiles; nothing compiles here (the kernel takes any
        # length), so the batch is padded to its longest input, or to the
        # family's bucket where padding moves the vectors (EMBED_BUCKET)
        pad_to, bucket = longest, family.EMBED_BUCKET
        if bucket:
            pad_to = min(-(-longest // bucket) * bucket, config.max_seq_len)
        toks = np.zeros((len(ids), pad_to), np.int64)
        for i, r in enumerate(ids):
            toks[i, :len(r)] = r
        nreal = np.asarray([len(r) for r in ids], np.int64)
        with self._gen_lock, torch.inference_mode():
            dev = eng.device
            if getattr(eng, "mesh", None) is not None:
                x = eng.hidden_states(toks)
            else:
                out = family.forward_hidden(config, params,
                                            torch.as_tensor(toks, device=dev))
                x = out[0] if isinstance(out, tuple) else out  # MoE: (x, aux)
            mask = (torch.arange(x.shape[1], device=dev)[None, :]
                    < torch.as_tensor(nreal, device=dev)[:, None]).float()
            pooled = (x.float() * mask[..., None]).sum(dim=1) \
                / torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
            vecs = pooled / torch.clamp_min(
                torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-9)
            vecs = vecs.cpu().numpy()
        n_tok = int(nreal.sum())
        return {
            "object": "list", "model": self.config.model_name,
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(v) for v in vec]}
                     for i, vec in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok},
        }

    def openai_stream(self, body: dict, chat: bool):
        """SSE chunk generator (validates before the first yield).
        Yields dicts (JSON chunks) and finally the raw ``[DONE]``
        sentinel string."""
        prompts, n, cap, sampling, stop = self._openai_parse(body, chat)
        if len(prompts) != 1 or n != 1:
            raise ValueError("stream mode takes one prompt with n=1")
        events = self.predict_stream({"instances": [
            {"prompt_tokens": prompts[0], "max_tokens": cap,
             **sampling}]})
        rid = self._openai_id("chatcmpl" if chat else "cmpl")
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"

        def chunk(piece=None, finish=None, role=None):
            if chat:
                delta = {}
                if role is not None:
                    delta["role"] = role
                if piece:
                    delta["content"] = piece
                choice = {"index": 0, "delta": delta,
                          "finish_reason": finish}
            else:
                choice = {"index": 0, "text": piece or "",
                          "finish_reason": finish}
            return {"id": rid, "object": obj, "created": created,
                    "model": self.config.model_name, "choices": [choice]}

        def gen():
            if chat:
                yield chunk(role="assistant")
            elif body.get("echo"):
                # OpenAI streams the echoed prompt before the deltas
                yield chunk(piece=self.config.tokenizer.decode(
                    prompts[0]))
            # hold back enough text that a stop string split across
            # token boundaries is still caught before it reaches the
            # client
            holdback = max((len(s) for s in stop), default=1) - 1
            pending = ""
            seen = ""       # all text received, incl. still-pending
            finish = None
            n_out = 0
            for ev in events:
                if "token" in ev:
                    n_out += 1
                    piece = ev.get("text", "")
                elif ev.get("done"):
                    # bytes the incremental decoder held back (a
                    # generation cut mid-UTF-8-character) only appear in
                    # the summary's full decode — emit the missing tail
                    piece = ev.get("text", "")[len(seen):]
                else:
                    continue
                seen += piece
                pending += piece
                cut, matched = self._apply_stop(pending, stop)
                if matched:
                    if cut:
                        yield chunk(piece=cut)
                    finish = "stop"
                    # closing `events` (GeneratorExit -> its finally)
                    # cancels the lane, so the device stops decoding
                    # tokens nobody will read
                    events.close()
                    break
                emit = (pending[:-holdback] if holdback
                        and len(pending) > holdback else
                        ("" if holdback else pending))
                if emit:
                    yield chunk(piece=emit)
                    pending = pending[len(emit):]
            if finish is None:
                if pending:
                    yield chunk(piece=pending)
                finish = "stop" if n_out < cap else "length"
            yield chunk(finish=finish)
            yield "[DONE]"
        return gen()

    def register_prefix(self, body: dict) -> dict:
        """Stash a shared prompt prefix's KV (continuous-batching engines
        only — the static engine has no shared cache to load). The engine
        enforces ``max_prefixes`` under its own lock: an idempotent
        re-registration passes, over the cap the least-recently-hit
        unpinned prefix is evicted, and ``pinned`` exempts this one.
        ``model`` scopes the prefix to one adapter of the engine's catalog
        (two models' identical token prefixes never alias each other's KV
        blocks); omitted, the prefix belongs to the base model and the
        answer carries no ``model`` key."""
        toks = body.get("prefix_tokens")
        if not isinstance(toks, list) or not toks:
            raise ValueError("prefix_tokens is required")
        if not hasattr(self.engine, "register_prefix"):
            raise ValueError("this engine does not support prefix caching")
        kw = {}
        model = str(body.get("model") or "")
        if model:
            if not getattr(self.engine, "multi_model", False):
                raise ValueError(
                    f"model {model!r} requested but this engine serves "
                    "only its base model (no adapter catalog configured)")
            model = self.engine.validate_model(model)
            if model:
                kw["model"] = model
        self.engine.register_prefix([int(t) for t in toks],
                                    max_prefixes=self.config.max_prefixes,
                                    pinned=bool(body.get("pinned")), **kw)
        out = {"registered": len(toks)}
        if model:
            out["model"] = model
        return out

    def status(self) -> dict:
        return {"model_version_status": [{
            "version": "1", "state": "AVAILABLE",
            "status": {"error_code": "OK", "error_message": ""}}]}


class _Handler(BaseHTTPRequestHandler):
    server_ref: InferenceServer = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _respond(self, status: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond_sse(self, events) -> str:
        """Stream ``data: {json}`` events with chunked framing (we speak
        raw HTTP/1.1 here, so the chunk lengths are written by hand).
        Errors after the first byte can't change the status line — they
        become a terminal error event instead. Returns "ok", "error"
        (mid-stream server failure), or "cancelled" (client went away) —
        the caller's metrics need the real outcome, and client aborts
        must not inflate the server error rate."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(payload) -> None:
            # raw strings pass through unquoted (the OpenAI convention
            # terminates streams with the literal `data: [DONE]`)
            body = (payload if isinstance(payload, str)
                    else json.dumps(payload))
            data = f"data: {body}\n\n".encode()
            self.wfile.write(f"{len(data):x}\r\n".encode()
                             + data + b"\r\n")
            self.wfile.flush()

        outcome = "ok"
        try:
            for ev in events:
                chunk(ev)
        except (BrokenPipeError, ConnectionResetError):
            # a client hitting Stop is normal, not a server fault
            return "cancelled"
        except Exception as e:  # noqa: BLE001 — surface on the stream
            outcome = "error"
            logging.getLogger("kubedl_tpu_torch.serving").exception(
                "stream failed")
            try:
                chunk({"error": f"{type(e).__name__}: {e}"})
            except OSError:
                return "error"
        try:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            return "cancelled" if outcome == "ok" else outcome
        return outcome

    def do_GET(self):
        cfg = self.server_ref.config
        if self.path == "/healthz":
            self._respond(200, {"status": "ok"})
        elif self.path == "/metrics":
            from ..metrics.http import write_exposition
            self.server_ref.refresh_engine_metrics()
            write_exposition(self, self.server_ref.metrics)
        elif self.path == "/v1/models":
            self._respond(200, self.server_ref.openai_models())
        elif self.path == f"/v1/models/{cfg.model_name}":
            # TFServing-convention status (readiness probes) AND the
            # OpenAI retrieve shape in one payload — both client kinds
            # read only their own fields
            self._respond(200, {
                **self.server_ref.status(),
                "id": cfg.model_name, "object": "model",
                "created": self.server_ref._created,
                "owned_by": "kubedl-tpu"})
        else:
            self._respond(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv = self.server_ref
        cfg = srv.config
        is_prefix = self.path == f"/v1/models/{cfg.model_name}:registerPrefix"
        is_chat = self.path == "/v1/chat/completions"
        is_cmpl = self.path == "/v1/completions"
        is_embed = self.path == "/v1/embeddings"
        if self.path != f"/v1/models/{cfg.model_name}:predict" \
                and not (is_prefix or is_chat or is_cmpl or is_embed):
            self._respond(404, {"error": f"no route {self.path}"})
            return
        t0 = time.perf_counter()
        mode = ("prefix" if is_prefix else "chat" if is_chat
                else "completions" if is_cmpl
                else "embeddings" if is_embed else "predict")
        outcome = "ok"
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            if is_prefix:
                self._respond(200, srv.register_prefix(body))
            elif is_embed:
                self._respond(200, srv.openai_embeddings(body))
            elif is_chat or is_cmpl:
                if body.get("stream"):
                    outcome = self._respond_sse(
                        srv.openai_stream(body, chat=is_chat))
                else:
                    self._respond(200,
                                  srv.openai_completions(body,
                                                         chat=is_chat))
            elif body.get("stream"):
                mode = "stream"
                # validation happens before the first event, so a bad
                # request still gets a clean 400 status; mid-stream
                # failures are swallowed into a terminal error event, so
                # the returned outcome feeds the metrics
                outcome = self._respond_sse(srv.predict_stream(body))
            else:
                self._respond(200, srv.predict(body))
        except (ValueError, KeyError, TypeError) as e:
            srv._m_requests.inc(mode=mode, status="error")
            if is_chat or is_cmpl or is_embed:
                # the envelope OpenAI SDKs parse (error.message/.type)
                self._respond(400, {"error": {
                    "message": str(e), "type": "invalid_request_error",
                    "param": None, "code": None}})
            else:
                self._respond(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — a crashed predict must
            # surface as a JSON 500, not a dropped connection
            srv._m_requests.inc(mode=mode, status="error")
            logging.getLogger("kubedl_tpu_torch.serving").exception(
                "predict failed")
            msg = f"{type(e).__name__}: {e}"
            self._respond(500, {"error": {
                "message": msg, "type": "server_error",
                "param": None, "code": None}}
                if (is_chat or is_cmpl or is_embed) else {"error": msg})
        else:
            srv._m_requests.inc(mode=mode, status=outcome)
            if outcome == "ok":
                srv._m_latency.observe(time.perf_counter() - t0, mode=mode)

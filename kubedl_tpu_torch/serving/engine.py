"""KV-cache generation engine: the counterpart of
``kubedl_tpu/serving/engine.py``.

* the KV cache is one ``[layers, batch, max_len, kv_heads, hd]`` block,
  written in place by every step (the JAX engine donates it to XLA for
  the same effect);
* prefill runs the prompt through the same cache-aware forward
  (``models.llama.forward_step``), decode feeds one token back per step;
* greedy or temperature/top-k/top-p sampling with a ``torch.Generator``,
  per-request stop handling on the host.

Tensor-parallel serving (the JAX engine's ``mesh``) and weight
quantization arrive with later slices and raise until then.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..models import llama


@dataclass(frozen=True)
class GenerateConfig:
    max_len: int = 1024            # cache capacity (prompt + generated)
    temperature: float = 0.0       # 0 = greedy
    top_k: int = 0                 # 0 = full softmax when sampling
    top_p: float = 1.0             # nucleus sampling mass (1.0 = off)
    eos_id: int = -1               # -1 = never stop early
    #: multi-token stop sequences (host-side suffix match after each
    #: generated token; the matched suffix stays in the output)
    stop_sequences: tuple = ()


def hit_stop(tokens: list, gen: GenerateConfig) -> bool:
    """True when the generated tokens end in eos or any stop sequence."""
    if not tokens:
        return False
    if gen.eos_id >= 0 and tokens[-1] == gen.eos_id:
        return True
    for seq in gen.stop_sequences:
        seq = list(seq)
        if seq and tokens[-len(seq):] == seq:
            return True
    return False


def resolve_family(config):
    """Model family module for a config. Only the llama family (Llama,
    Mistral, Qwen2, Gemma on ``LlamaConfig``) is ported."""
    if isinstance(config, llama.LlamaConfig):
        return llama
    raise NotImplementedError(
        f"{type(config).__name__} is not ported yet: only the llama family "
        "serves from the port (MoE is ROADMAP queue A's "
        "quantization/LoRA/MoE item)")


def spec_accept(drafts, dprobs, tprobs, rng):
    """The Leviathan et al. speculative accept/resample rule (numpy).

    ``drafts``: k proposed tokens; ``dprobs``/``tprobs``: the draft's /
    target's filtered probability vectors per slot (tprobs has k+1
    entries — the last is the bonus slot). Returns ``(n_accepted,
    next_token)``; each emitted token's marginal equals the target's."""
    for i, x in enumerate(drafts):
        if rng.random() >= min(1.0, float(tprobs[i][x])
                               / max(float(dprobs[i][x]), 1e-20)):
            resid = np.maximum(np.asarray(tprobs[i])
                               - np.asarray(dprobs[i]), 0.0)
            s = resid.sum()
            p = resid / s if s > 0 else np.asarray(tprobs[i])
            return i, int(rng.choice(len(p), p=p))
    return len(drafts), int(rng.choice(len(tprobs[-1]),
                                       p=np.asarray(tprobs[-1])))


@dataclass
class SpecStats:
    """Lifetime draft proposal/acceptance accounting."""
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def token_logprobs(logits, tokens):
    """log p(token) under the FULL softmax of ``logits`` [b, vocab] for
    the chosen ``tokens`` [b]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens[:, None].long())[:, 0]


def _categorical(logits, generator):
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_logits(logits, generator, temperature, top_k, top_p=1.0):
    """Greedy (temperature<=0) or temperature/top-k/top-p sampling — the
    one sampler of the engine. top-p keeps the smallest set of tokens
    whose probability mass reaches ``top_p``, after temperature and
    top-k. Draws come from ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the nucleus always includes the top token
        keep_sorted = (cum - probs) < top_p
        keep_sorted[..., 0] = True
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -1e30, logits)
    return _categorical(logits, generator).to(torch.int32)


def filtered_probs(logits, temperature: float, top_k: int = 0,
                   top_p: float = 1.0):
    """Host-side (numpy) probability vector after the same
    temperature/top-k/top-p filtering as :func:`sample_logits`."""
    x = np.asarray(logits, np.float64) / max(temperature, 1e-6)
    if top_k > 0:
        # tie semantics match sample_logits: the cut is `value < kth`, so
        # every token tied with the k-th logit stays in the set
        kth = np.sort(x)[-top_k]
        x = np.where(x < kth, -np.inf, x)
    if top_p < 1.0:
        order = np.argsort(x)[::-1]
        p_sorted = np.exp(x[order] - x[order[0]])
        p_sorted = p_sorted / p_sorted.sum()
        cum = np.cumsum(p_sorted)
        keep_sorted = (cum - p_sorted) < top_p
        keep_sorted[0] = True          # the nucleus never empties
        cutoff = x[order][keep_sorted].min()
        x = np.where(x < cutoff, -np.inf, x)
    x = x - x.max()
    p = np.exp(x)
    return p / p.sum()


def sample_logits_many(logits, generator, temps, top_ks, top_ps):
    """Per-row sampler: ``logits [n, V]`` with per-row temperature/
    top-k/top-p tensors. Rows with ``temps <= 0`` are greedy. Top-k is a
    rank cut on the sorted logits so k may differ per row."""
    v = logits.shape[-1]
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp_min(temps.float(), 1e-6)[:, None]
    sorted_l, _ = torch.sort(scaled, dim=-1, descending=True)
    idx = torch.clamp(top_ks.long() - 1, 0, v - 1)
    kth = torch.gather(sorted_l, -1, idx[:, None])
    use_k = top_ks[:, None] > 0
    scaled = torch.where(use_k & (scaled < kth), -1e30, scaled)
    ranks = torch.arange(v, device=logits.device)[None, :]
    sorted_l = torch.where(use_k & (ranks >= top_ks[:, None]), -1e30,
                           sorted_l)
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_ps.float()[:, None]
    keep_sorted[:, 0] = True
    cutoff = torch.where(keep_sorted, sorted_l,
                         torch.inf).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled < cutoff, -1e30, scaled)
    sampled = _categorical(scaled, generator).to(torch.int32)
    return torch.where(temps <= 0, greedy, sampled)


def kv_bytes_per_token(config, dtype_bytes: Optional[int] = None) -> int:
    """Device bytes one cached token costs across all layers (K and V)."""
    if dtype_bytes is None:
        dtype_bytes = config.dtype.itemsize
    return 2 * config.n_layers * config.n_kv_heads * config.hd * dtype_bytes


def _params_device(params: dict) -> torch.device:
    return params["embed"].device


def greedy_rollout(config, params, prompts, max_new: int):
    """Whole-generation greedy decode: prefill plus ``max_new - 1``
    single-token steps, argmax on the device, one copy to the host at the
    end. ``prompts`` is a [batch, prompt_len] integer array (fixed
    length); returns generated ids [batch, max_new] (int32, on the
    params' device). No eos / stop handling."""
    if max_new < 1:
        raise ValueError("max_new must be >= 1")
    dev = _params_device(params)
    tokens = torch.as_tensor(np.asarray(prompts), device=dev).long()
    if tokens.ndim != 2:
        raise ValueError("greedy_rollout needs a [batch, prompt_len] array")
    family = resolve_family(config)
    b, plen = tokens.shape
    with torch.inference_mode():
        cache = family.init_cache(config, b, plen + max_new, device=dev)
        logits, cache = family.forward_step(config, params, tokens, cache, 0)
        out = torch.empty((b, max_new), dtype=torch.int32, device=dev)
        out[:, 0] = torch.argmax(logits, dim=-1)
        for i in range(1, max_new):
            logits, cache = family.forward_step(
                config, params, out[:, i - 1:i].long(), cache, plen + i - 1)
            out[:, i] = torch.argmax(logits, dim=-1)
    return out


class InferenceEngine:
    """One loaded model and its prefill/decode steps on ``device``
    (``None``: the card; ``"cpu"`` only when asked). Parameters are moved
    to the device once."""

    def __init__(self, config: llama.LlamaConfig, params: dict,
                 gen: Optional[GenerateConfig] = None,
                 quantize: Optional[str] = None, mesh=None, tracer=None,
                 device=None):
        from ..trace import NOOP_TRACER
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet: ROADMAP queue "
                "A, context and pipeline parallelism")
        if quantize:
            raise NotImplementedError(
                f"quantize={quantize!r} is not ported yet: ROADMAP queue "
                "A's quantization/LoRA/MoE item")
        self.device = resolve_device(device)
        self.config = config
        self.gen = gen or GenerateConfig()
        #: span recorder: per-generate prefill/decode spans; the shared
        #: disabled tracer by default
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.params = {
            k: ({n: t.to(self.device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(self.device))
            for k, v in params.items()}
        self._family = resolve_family(config)

    def _step(self, cache, tokens, start_pos: int, valid):
        return self._family.forward_step(self.config, self.params, tokens,
                                         cache, start_pos, valid)

    # -- public API -------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                 seed: int = 0, return_logprobs: bool = False) -> list:
        """Batch-generate continuations. ``prompts`` are token-id lists;
        returns one list of generated ids per prompt (stops at eos or any
        configured stop sequence — see ``hit_stop``), or (ids, logprobs)
        pairs with ``return_logprobs``.

        Ragged batches are **left-padded**: every row's last real token
        sits at the bucket end, so one shared decode position works for
        the whole batch, pads are excluded from attention via the validity
        mask, and — because RoPE is relative — the per-row position shift
        is exact."""
        gen = self.gen
        dev = self.device
        b = len(prompts)
        prompt_len = max(max(len(p) for p in prompts), 1)
        if prompt_len + max_new_tokens > gen.max_len:
            raise ValueError(
                f"prompt {prompt_len} + new {max_new_tokens} tokens exceed "
                f"cache capacity {gen.max_len}")

        toks = np.zeros((b, prompt_len), np.int64)
        pad = np.zeros((b,), np.int64)
        for i, p in enumerate(prompts):
            pad[i] = prompt_len - len(p)
            toks[i, pad[i]:] = p
        # cache slot p is live for row i iff p >= pad[i]
        valid = torch.as_tensor(
            np.arange(gen.max_len)[None, :] >= pad[:, None], device=dev)

        tr = self.tracer if self.tracer.enabled else None
        trace_id = root_id = None
        t_start = t_prefill = 0.0
        if tr is not None:
            trace_id, root_id = tr.new_trace_id(), tr.new_span_id()
            t_start = tr.clock()
        out: list[list[int]] = [[] for _ in range(b)]
        lps: list[list[float]] = [[] for _ in range(b)]
        with torch.inference_mode():
            cache = self._family.init_cache(self.config, b, gen.max_len,
                                            device=dev)
            logits, cache = self._step(
                cache, torch.as_tensor(toks, device=dev), 0, valid)
            if tr is not None:
                t_prefill = tr.clock()
                tr.record("inference.prefill", t_start, t_prefill,
                          trace_id=trace_id, parent_id=root_id,
                          component="serving",
                          attributes={"batch": b,
                                      "promptTokens": prompt_len})
            rng = torch.Generator(device=dev).manual_seed(seed)
            done = np.zeros((b,), bool)
            cur_t = sample_logits(logits, rng, gen.temperature, gen.top_k,
                                  gen.top_p)
            cur = cur_t.cpu().numpy()
            cur_lp = (token_logprobs(logits, cur_t).cpu().numpy()
                      if return_logprobs else None)
            pos = prompt_len
            for _ in range(max_new_tokens):
                for i in range(b):
                    if not done[i]:
                        out[i].append(int(cur[i]))
                        if return_logprobs:
                            lps[i].append(float(cur_lp[i]))
                        if hit_stop(out[i], gen):
                            done[i] = True
                if done.all() or pos + 1 > gen.max_len:
                    break
                logits, cache = self._step(cache, cur_t[:, None].long(), pos,
                                           valid)
                cur_t = sample_logits(logits, rng, gen.temperature,
                                      gen.top_k, gen.top_p)
                cur = cur_t.cpu().numpy()
                if return_logprobs:
                    cur_lp = token_logprobs(logits, cur_t).cpu().numpy()
                pos += 1
        if tr is not None:
            t_end = tr.clock()
            generated = sum(len(o) for o in out)
            tr.record("inference.decode", t_prefill, t_end,
                      trace_id=trace_id, parent_id=root_id,
                      component="serving", attributes={"tokens": generated})
            tr.record("inference.generate", t_start, t_end,
                      trace_id=trace_id, span_id=root_id,
                      component="serving",
                      attributes={"batch": b, "tokens": generated})
        if return_logprobs:
            return [(o, lp) for o, lp in zip(out, lps)]
        return out

    def score_throughput(self, batch: int, prompt_len: int,
                         new_tokens: int = 16, seed: int = 0) -> dict:
        """Prefill + decode rates for a (batch, prompt) shape. Every
        ``generate`` ends with its tokens on the host, so each timed
        region ends after the device has finished."""
        rng = np.random.default_rng(seed)
        prompts = rng.integers(1, self.config.vocab_size,
                               (batch, prompt_len)).tolist()
        t0 = time.perf_counter()
        self.generate(prompts, 1, seed)      # first shape: warm-up
        t_prefill = time.perf_counter() - t0
        # warmed prefill + first token = the time to first token
        t0 = time.perf_counter()
        self.generate(prompts, 1, seed)
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.generate(prompts, new_tokens, seed)
        dt = time.perf_counter() - t0
        return {"batch": batch, "prompt_len": prompt_len,
                "prefill_s": t_prefill,
                "ttft_ms": 1000 * ttft,
                "decode_tokens_per_s": batch * new_tokens / dt,
                "latency_per_token_ms": 1000 * dt / new_tokens}

"""Speculative decoding: draft-model proposals verified by the target.
The counterpart of ``kubedl_tpu/serving/speculative.py``.

Decode reads every weight once per token of progress. Speculative
decoding (Leviathan et al., 2023) has a small draft model propose ``k``
tokens autoregressively, then the target verifies all of them in one
chunk forward (weights read once for up to ``k+1`` tokens of progress).
Greedy acceptance makes the output identical to the target's own greedy
decoding: the draft only changes speed, never content.

* verification is a single ``forward_step`` of shape ``[1, k+1]`` (the
  last accepted token and the k drafts) with ``all_logits``;
* rejected draft positions need no cache surgery: rewinding moves the
  position pointer back. ``forward_step`` attends only to the slots
  before ``start_pos + s`` (``models.llama.attention_step``), so the
  stale slots past the pointer are never read until the next write lands
  on them;
* both models keep dense caches the engine holds, written in place by
  every step; the draft can be quantized (``quantize_draft``).

The sampled path (``temperature > 0``) draws on the host with
``np.random.default_rng(seed)``, as the JAX engine does, over
:func:`~.engine.filtered_probs` and the :func:`~.engine.spec_accept`
rule, so every emitted token's marginal is the target's filtered
distribution.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from .batching import _bucket
from .engine import (GenerateConfig, SpecStats, filtered_probs,  # noqa: F401
                     hit_stop, maybe_quantize, resolve_family, spec_accept)


class SpeculativeServingAdapter:
    """Presents a :class:`SpeculativeEngine` through the static-engine
    serving contract (``generate(prompts, max_new)``), so the HTTP
    predictor can serve it. Sequences decode one at a time (the engine
    is single-lane); logprobs are not available on the speculative
    path."""

    def __init__(self, engine: "SpeculativeEngine",
                 gen: Optional[GenerateConfig] = None):
        self.engine = engine
        self.gen = gen
        #: lifetime acceptance accounting, on the predictor's /metrics
        self.stats = SpecStats()

    @property
    def config(self):
        """The target model's config, as the other engines expose theirs
        (the embeddings route reads it)."""
        return self.engine.tc

    @property
    def params(self):
        """The target model's params (the draft only changes decode
        speed, never representations)."""
        return self.engine.tp

    @property
    def device(self):
        """The device the target's weights live on."""
        return self.engine.device

    def generate(self, prompts, max_new_tokens: int,
                 seed: int = 0, return_logprobs: bool = False):
        if return_logprobs:
            raise ValueError(
                "logprobs are not available on the speculative path")
        return [self.engine.generate(p, max_new_tokens, gen=self.gen,
                                     seed=seed + i, stats=self.stats)
                for i, p in enumerate(prompts)]

    def stop(self) -> None:
        pass  # nothing running in the background


class SpeculativeEngine:
    """Speculative generation for one sequence at a time on ``device``
    (``None``: the card; ``"cpu"`` only when asked).

    ``target``/``draft`` are (config, params) pairs over the same
    vocabulary; ``k`` is the draft lookahead. Greedy output is
    token-identical to plain greedy decoding with the target alone."""

    def __init__(self, target_config, target_params, draft_config,
                 draft_params, k: int = 4, max_len: int = 1024,
                 quantize_draft: Optional[str] = None, device=None):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self.device = dev = resolve_device(device)
        self.tc = target_config
        self.tp = maybe_quantize(target_params, None, dev)
        self.dc = draft_config
        self.dp = maybe_quantize(draft_params, quantize_draft, dev)
        self.k = k
        self.max_len = max_len
        self.tfam = resolve_family(target_config)
        self.dfam = resolve_family(draft_config)
        self._reset_caches()

    def _reset_caches(self) -> None:
        """(Re)allocate the engine-held caches: at init and after a
        failure inside :meth:`generate`, so a step cut short leaves no
        half-written state behind."""
        self._t_cache = self.tfam.init_cache(self.tc, 1, self.max_len,
                                             device=self.device)
        self._d_cache = self.dfam.init_cache(self.dc, 1, self.max_len,
                                             device=self.device)

    # -- the device steps: float32 logits of one row ------------------------

    def _prefill(self, target: bool, toks, plen: int):
        """The prompt, right-padded to its bucket, into a cache; the
        logits at its last real token. The pads' slots are masked by
        ``valid`` and overwritten before any later query reads them."""
        cfg, fam, params, cache = self._model(target)
        valid = (torch.arange(self.max_len, device=self.device)
                 < plen)[None, :]
        logits, _ = fam.forward_step(cfg, params, toks, cache, 0,
                                     valid=valid, last_pos=plen - 1)
        return logits.float()

    def _step(self, target: bool, tokens: list, start: int,
              all_logits: bool = False):
        cfg, fam, params, cache = self._model(target)
        toks = torch.tensor([tokens], dtype=torch.long, device=self.device)
        logits, _ = fam.forward_step(cfg, params, toks, cache, start,
                                     all_logits=all_logits)
        return logits.float()

    def _model(self, target: bool) -> tuple:
        if target:
            return self.tc, self.tfam, self.tp, self._t_cache
        return self.dc, self.dfam, self.dp, self._d_cache

    def _prompt(self, prompt, plen: int):
        bucket = min(_bucket(plen), self.max_len)
        toks = torch.zeros((1, bucket), dtype=torch.long, device=self.device)
        toks[0, :plen] = torch.as_tensor(prompt, dtype=torch.long)
        return toks

    @staticmethod
    def _argmax(logits) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy()

    # -- public API ---------------------------------------------------------

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 stats: Optional[SpecStats] = None,
                 gen: Optional[GenerateConfig] = None,
                 seed: int = 0) -> list:
        """Continuation of ``prompt``. Greedy (``gen.temperature <= 0``,
        the default): token-identical to the target's own greedy decode,
        with fewer target passes. Sampled (``temperature > 0``):
        speculative sampling, whose accept/resample rule
        (``spec_accept``) makes every emitted token's marginal the
        target's filtered distribution; ``seed`` pins the draws.

        ``gen`` carries eos_id/stop_sequences; the shared ``hit_stop``
        rule is applied to every emitted token (a verified chunk is cut
        at the first stop), so outputs stay identical to the static and
        continuous engines' decode contract."""
        prompt = list(prompt) or [0]
        plen = len(prompt)
        if plen + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {plen} + new {max_new_tokens} exceeds "
                f"cache capacity {self.max_len}")
        try:
            with torch.inference_mode():
                if gen is not None and gen.temperature > 0.0:
                    return self._generate_sampled(
                        prompt, plen, max_new_tokens, stats, gen,
                        np.random.default_rng(seed))
                return self._generate(prompt, plen, max_new_tokens, stats,
                                      gen)
        except BaseException:
            # any abort (KeyboardInterrupt included) mid-step leaves the
            # caches partly written: start them over before propagating
            self._reset_caches()
            raise

    def _stop_len(self, gen):
        """``stop_len(out, start)``: the length to cut ``out`` to if a
        stop lands in ``out[start:]`` (every token is checked, not only
        the last of a verified chunk), else None. Only the trailing
        window a stop can match is sliced per position."""
        if gen is None:
            return lambda out, start: None
        win = max([1] + [len(s) for s in gen.stop_sequences])

        def stop_len(out, start):
            for i in range(start, len(out)):
                if hit_stop(out[max(0, i + 1 - win):i + 1], gen):
                    return i + 1
            return None
        return stop_len

    def _generate_sampled(self, prompt, plen, max_new_tokens, stats, gen,
                          rng):
        """Speculative sampling: the cache and position bookkeeping of
        the greedy :meth:`_generate`; only token selection differs (the
        draft samples its proposals, and ``spec_accept`` keeps or
        replaces them)."""
        k = self.k

        def probs(logits):
            return filtered_probs(logits, temperature=gen.temperature,
                                  top_k=gen.top_k, top_p=gen.top_p)

        stop_len = self._stop_len(gen)
        toks = self._prompt(prompt, plen)
        p0 = probs(self._prefill(True, toks, plen).cpu().numpy()[0])
        y = int(rng.choice(len(p0), p=p0))
        self._prefill(False, toks, plen)
        out = [y]
        cut = stop_len(out, 0)
        if cut is not None:
            return out[:min(cut, max_new_tokens)]
        pos = plen
        while (max_new_tokens - len(out) >= 2
               and pos + k + 1 < self.max_len):
            drafts, dprobs = [], []
            cur = y
            for i in range(k):
                dp = probs(self._step(False, [cur], pos + i).cpu().numpy()[0])
                cur = int(rng.choice(len(dp), p=dp))
                drafts.append(cur)
                dprobs.append(dp)
            t_logits = self._step(True, [y] + drafts, pos,
                                  all_logits=True).cpu().numpy()[0]
            tprobs = [probs(row) for row in t_logits]
            accepted, nxt = spec_accept(drafts, dprobs, tprobs, rng)
            if stats is not None:
                stats.proposed += k
                stats.accepted += accepted
            emitted = list(drafts[:accepted]) + [nxt]
            before = len(out)
            out.extend(emitted)
            cut = stop_len(out, before)
            if cut is not None:
                return out[:min(cut, max_new_tokens)]
            if accepted == k:
                # the k-th draft joined the sequence but never entered
                # the draft cache (the greedy loop's backfill)
                self._step(False, [drafts[-1]], pos + k)
            pos += accepted + 1
            y = emitted[-1]
        while len(out) < max_new_tokens and pos + 1 < self.max_len:
            pt = probs(self._step(True, [y], pos).cpu().numpy()[0])
            y = int(rng.choice(len(pt), p=pt))
            out.append(y)
            pos += 1
            if stop_len(out, len(out) - 1) is not None:
                break
        return out[:max_new_tokens]

    def _generate(self, prompt, plen, max_new_tokens, stats, gen=None):
        k = self.k
        stop_len = self._stop_len(gen)
        # the engine's caches are rewritten in place every call: a fresh
        # prefill's masks start over at position 0, so a previous
        # request's slots are never read
        toks = self._prompt(prompt, plen)
        y = int(self._argmax(self._prefill(True, toks, plen))[0])
        # the draft prefills the same prompt; only its cache matters
        self._prefill(False, toks, plen)

        out = [y]
        cut = stop_len(out, 0)
        if cut is not None:
            # never emit past the budget: the static engine stops at
            # max_new_tokens without seeing a later stop token
            return out[:min(cut, max_new_tokens)]
        pos = plen            # tokens verified into both caches so far
        # a round pays off only while >= 2 tokens are still wanted (it
        # costs k draft steps and one verify); the single-token tail
        # below finishes the last one. A round near the budget can still
        # propose more than remains, and SpecStats counts those
        while (max_new_tokens - len(out) >= 2
               and pos + k + 1 < self.max_len):
            # 1) the draft proposes k tokens autoregressively from y
            drafts = []
            cur = y
            for i in range(k):
                cur = int(self._argmax(self._step(False, [cur], pos + i))[0])
                drafts.append(cur)
            # 2) the target verifies the chunk [y, d1..dk] at once:
            #    targets[i] is the greedy token for slot pos+i+1, each
            #    conditioned on the drafts before it
            targets = self._argmax(self._step(True, [y] + drafts, pos,
                                              all_logits=True))[0]
            # 3) greedy acceptance: drafts[i] survives iff it equals the
            #    target's own choice; the first mismatch is replaced by the
            #    target token (always emitted, so a fully accepted round
            #    yields k + 1 tokens from one target pass)
            accepted = 0
            while accepted < k and drafts[accepted] == targets[accepted]:
                accepted += 1
            if stats is not None:
                stats.proposed += k
                stats.accepted += accepted
            emitted = list(drafts[:accepted]) + [int(targets[accepted])]
            before = len(out)
            out.extend(emitted)
            cut = stop_len(out, before)
            if cut is not None:
                # a stop inside the verified chunk: the caches hold the
                # whole chunk, but slots past any later pointer are never
                # read, so cutting the host-side output is enough; a stop
                # past the budget is one the static engine never makes
                return out[:min(cut, max_new_tokens)]
            if accepted == k:
                # fully accepted: d_k is part of the sequence (slot pos+k)
                # but the draft cache never took it in (it was only an
                # output); backfill it so later drafts see it
                self._step(False, [drafts[-1]], pos + k)
            # 4) rewind: both caches hold the verified chunk; slots past
            #    the new pos are not read until overwritten
            pos += accepted + 1
            y = int(targets[accepted])
        # near capacity the k+1 verify chunk no longer fits: finish with
        # single-token target steps, so the output stays exactly the
        # target's greedy decode (never shorter)
        while len(out) < max_new_tokens and pos + 1 < self.max_len:
            y = int(self._argmax(self._step(True, [y], pos))[0])
            out.append(y)
            pos += 1
            if stop_len(out, len(out) - 1) is not None:
                break
        return out[:max_new_tokens]

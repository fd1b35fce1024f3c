"""KV-cache generation engine: the counterpart of
``kubedl_tpu/serving/engine.py``.

* the KV cache is one ``[layers, batch, max_len, kv_heads, hd]`` block,
  written in place by every step (the JAX engine donates it to XLA for
  the same effect);
* prefill runs the prompt through the same cache-aware forward
  (``models.llama.forward_step``), decode feeds one token back per step;
* greedy or temperature/top-k/top-p sampling with a ``torch.Generator``,
  per-request stop handling on the host;
* weight-only int8/int4 quantization (``quantize=``, :func:`maybe_quantize`)
  applied as the weights move to the device, leaf by leaf;
* serving over a ``mesh`` of one host's cards (:func:`shard_for_serving`,
  :func:`init_mesh_serving`): under ``tp`` each rank holds its shard of
  every weight as a plain tensor (whole query heads, also where ``tp``
  does not divide them) and its KV heads of the cache, and the model
  runs the ``tp`` collectives inside each step; under ``ep`` it holds
  its experts of every MoE stack and the experts' outputs are summed
  over ``ep``; under ``fsdp`` it holds JAX's ``embed`` shard of each
  weight and the step gathers each one per use; over ``dp``, ``pp`` and
  ``cp`` everything is replicated and every rank runs the whole step
  (:func:`serving_mesh`). In torch every card is its
  own process, so :class:`InferenceEngine` under a mesh is driven SPMD:
  every rank calls ``generate`` with the same prompts. (The continuous
  engine, which the predictor serves, drives its followers through one
  step channel instead: ``serving/tp.py``.)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..models import llama
#: the model family module of a config (every family exposes the same
#: ``init_cache`` / ``forward_step`` / ``forward_step_paged`` contract)
from ..models.io import family_of as resolve_family
from ..parallel.collectives import is_sharded
from ..parallel.sharding import ShardedTensor


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


def params_to(params: dict, device) -> dict:
    """The parameter dict (``layers`` a nested dict) with every tensor (or
    wrapped quantized leaf) on ``device``; those already there are not
    copied."""
    return {k: ({n: t.to(device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def maybe_quantize(params: dict, quantize, device=None) -> dict:
    """Apply a serving quantization mode ('int8', 'int4', or None) to a
    param tree, landing it on ``device`` (default: where it lies). The
    quantized leaves move there one matrix at a time, so a tree held on
    the host never reaches the card in its float form; an unknown mode
    raises before anything moves."""
    if quantize in ("int8", "int4"):
        from ..ops.quant import quantize_params
        return quantize_params(params, mode=quantize, device=device)
    if quantize:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    return params if device is None else params_to(params, device)


#: the JAX package's words for the pair it refuses
MESH_QUANTIZE_REFUSAL = ("mesh-parallel serving does not compose with "
                         "weight quantization yet")


def local_device_count(device) -> int:
    """The devices one host gives tensor-parallel serving: its cards on
    ``cuda``; on the CPU, where each rank is a gloo process, its cores."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


#: the axes a serving step runs the model over (one host's cards): ``tp``
#: splits the heads, the MLP and the vocabulary, ``ep`` the MoE experts
#: and ``fsdp`` the ``embed`` dim of the stored leaves (gathered per use);
#: nothing is placed on ``dp``, ``pp`` or ``cp``, whose ranks hold
#: everything and run the whole step (:func:`serving_mesh`)
SERVING_AXES = ("fsdp", "ep", "tp")


def serving_tp(mesh) -> int:
    """The ``tp`` size of a serving mesh (1 for None or one rank), after
    refusing a mesh without a process group behind it
    (``llama._check_mesh``). The JAX engines take any local mesh and place
    the params by the family's specs, which name ``fsdp`` (``embed``),
    ``tp`` and ``ep`` (the expert stacks) and no other axis; so do the
    port's."""
    if mesh is None:
        return 1
    llama._check_mesh(mesh)
    return mesh.size("tp") if is_sharded(mesh) else 1


def serving_mesh(mesh):
    """The mesh a serving step runs the model on: ``mesh`` with ``dp``,
    ``pp`` and ``cp`` shown as 1. Serving replicates the params and the
    cache over them (JAX's placement), and every such rank runs the whole
    step on the whole batch and sequence, so the model must not take its
    training split of either (``models.llama`` reads a ``cp`` axis as a
    sharded sequence). Its process groups stay whole: the step channel
    still spans every rank (``serving/tp.py``)."""
    if mesh is None or all(mesh.size(a) == 1 for a in ("dp", "pp", "cp")):
        return mesh
    return replace(mesh, shape={**mesh.shape, "dp": 1, "pp": 1, "cp": 1})


def check_serving_split(config, tp: int, ep: int = 1, fsdp: int = 1) -> None:
    """Refuse a mesh that does not split a leaf it shards into equal
    shards, naming the dimension: the JAX package places the params with
    ``device_put``, which refuses the same splits. Under ``tp`` those are
    the query heads' columns (``n_heads * head_dim``; ``n_heads`` itself
    need not divide, each rank computes whole heads:
    ``models.llama.head_split``), the MLP's (or each expert's) hidden dim
    and the vocabulary; ``n_kv_heads`` need not divide either (the KV
    heads are then held whole on every rank). Under ``ep`` the MoE
    experts, under ``fsdp`` the model width."""
    dims = [("tp", tp, "n_heads * head_dim", config.n_heads * config.hd),
            ("tp", tp, "d_ff", config.d_ff),
            ("tp", tp, "vocab_size", config.vocab_size),
            ("fsdp", fsdp, "d_model", config.d_model)]
    experts = getattr(config, "n_experts", None)
    if experts is not None:
        dims.append(("ep", ep, "n_experts", experts))
    for axis, size, name, n in dims:
        if n % size:
            raise ValueError(
                f"serving over {axis}={size} needs {name} divisible by "
                f"{size}, got {name}={n}: the JAX package refuses this "
                "split too (its device_put places equal shards)")


def serving_cut(config, mesh):
    """``cut(name, leaf)``: this rank's shard of a whole leaf (named as
    ``layers/wq``) under the family's ``tp`` and ``ep`` specs (its ``tp``
    columns, and under ``ep`` its ``E/ep`` experts of every MoE stack); a
    leaf already of the shard's shape as it is; ``wk``/``wv`` (and their
    biases) whole where ``tp`` does not divide the KV heads. ``wq``,
    ``bq`` and ``wo`` are cut to the rank's whole query heads
    (``models.llama.head_split``): JAX's equal chunks where ``tp`` divides
    the heads, one head more on each of the first ``n_heads % tp`` ranks
    where it does not. ``fsdp`` is not cut here (:func:`shard_for_serving`
    places it: a leaf it shards never comes here)."""
    from ..parallel.sharding import local_shard, spec_leaves
    tp = serving_tp(mesh)
    sharded = is_sharded(mesh)
    ep = mesh.size("ep") if sharded else 1
    check_serving_split(config, tp, ep, mesh.size("fsdp") if sharded else 1)
    family = resolve_family(config)
    specs = spec_leaves(family.param_specs(config))
    shapes = {}
    for name, val in family.param_shapes(config).items():
        if name == "layers":
            shapes.update({f"layers/{k}": (config.n_layers,) + s
                           for k, (s, _) in val.items()})
        else:
            shapes[name] = val[0]
    whole = ({f"layers/{k}" for k in ("wk", "wv", "bk", "bv")}
             if config.n_kv_heads % tp else set())
    first, n = llama.head_split(config.n_heads, tp,
                                mesh.index("tp") if tp > 1 else 0)
    heads = {f"layers/{k}": d for k, d in llama._HEAD_DIMS.items()}

    def cut(name, leaf):
        if name in whole or tp * ep == 1:
            return leaf
        if tuple(leaf.shape) != tuple(shapes[name]):
            return leaf                  # already this rank's shard
        if name in heads:
            return leaf.narrow(leaf.ndim + heads[name], first * config.hd,
                               n * config.hd)
        return local_shard(leaf, mesh, specs[name])
    return cut


def shard_for_serving(config, params, cache, mesh):
    """This rank's local tree for model-parallel serving over a local
    mesh (the cards of ONE host, as the JAX function's): params by the
    family's logical specs (heads, ``mlp`` and the vocab on ``tp``, the
    MoE experts on ``ep``, ``embed`` on ``fsdp``; replicated over ``dp``,
    ``pp`` and ``cp``), cut once, on the mesh's device; the cache by KV
    heads when ``tp`` divides them, else whole on every rank (MQA), and
    whole over every other axis. Either tree may be None. Under ``tp`` and
    ``ep`` alone each leaf is a plain tensor (:func:`serving_cut`), and
    ``params`` may be whole or already this rank's shard
    (``models.io.load_model(select=)``). Under ``fsdp`` every leaf whose
    spec names it is JAX's shard of the whole leaf, held as a
    ``parallel.sharding.ShardedTensor`` that the step gathers per use
    (``materialize``, as in sharded training), and ``params`` must be
    whole. Both cache layouts carry the KV heads on axis 3, so one rule
    cuts the dense slab and the paged pool (the pool's block axis stays
    whole on every rank). Refuses a split that is not even
    (:func:`check_serving_split`)."""
    from ..parallel.sharding import local_shard, spec_leaves
    cut = serving_cut(config, mesh)
    dev = mesh.device
    placed = {}
    if is_sharded(mesh) and mesh.size("fsdp") > 1:
        placed = {name: s for name, s in spec_leaves(
            resolve_family(config).param_specs(config)).items()
            if any(e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e)
                   for e in s)}
    model_mesh = serving_mesh(mesh)

    def put(name, leaf):
        if name in placed:
            return ShardedTensor(
                local_shard(leaf, mesh, placed[name]).to(dev).contiguous(),
                placed[name], model_mesh)
        return cut(name, leaf).to(dev).contiguous()
    if params is not None:
        params = {k: ({n: put(f"layers/{n}", t) for n, t in v.items()}
                      if k == "layers" else put(k, v))
                  for k, v in params.items()}
    if cache is not None:
        from ..models.llama import kv_heads_local
        nkv = kv_heads_local(config, mesh)
        i = mesh.index("tp") if nkv != config.n_kv_heads else 0
        cache = {k: t[:, :, :, i * nkv:(i + 1) * nkv].to(dev).contiguous()
                 for k, t in cache.items()}
    return params, cache


def init_mesh_serving(config, params, quantize, mesh, device=None):
    """The ONE param-preparation path both engines share: validates the
    (mesh, quantize) pair, then either quantizes onto ``device`` (no
    mesh) or returns this rank's shard of the params for serving
    (:func:`shard_for_serving`). The unsupported mesh+quantize pair is
    refused BEFORE any quantization pass runs."""
    if mesh is None:
        return maybe_quantize(params, quantize, device)
    if quantize:
        raise ValueError(MESH_QUANTIZE_REFUSAL)
    return shard_for_serving(config, params, None, mesh)[0]


@torch.no_grad()
def load_into(dst, src) -> None:
    """Copy the tree ``src`` into the tensors of ``dst`` in place, leaf by
    leaf (a wrapped quantized leaf field by field): whatever holds
    ``dst``'s tensors (a captured CUDA graph holds their addresses) reads
    the new values. The trees must match in keys, shapes and dtypes."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"weights with keys {sorted(src)} do not match "
                             f"the served {sorted(dst)}")
        for k in dst:
            load_into(dst[k], src[k])
        return
    if isinstance(dst, ShardedTensor):
        dst, src = dst.local, src.local
    fields = getattr(dst, "_arrays", ())
    for d, s in ([(getattr(dst, f), getattr(src, f)) for f in fields]
                 if fields else [(dst, src)]):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a {tuple(s.shape)} {s.dtype} leaf cannot "
                             f"replace the served {tuple(d.shape)} {d.dtype}")
        d.copy_(s)


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
    to the device once, quantized on the way with ``quantize``. Under a
    serving ``mesh`` (the mesh's device; any of its axes) each
    rank holds its shard (:func:`init_mesh_serving`) and every rank calls
    :meth:`generate` with the same arguments; :attr:`mesh` is the one the
    model runs on (:func:`serving_mesh`)."""

    def __init__(self, config: llama.LlamaConfig, params: dict,
                 gen: Optional[GenerateConfig] = None,
                 quantize: Optional[str] = None, mesh=None, tracer=None,
                 device=None):
        from ..trace import NOOP_TRACER
        serving_tp(mesh)
        self.mesh = mesh = serving_mesh(mesh)
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.config = config
        self.gen = gen or GenerateConfig()
        #: span recorder: per-generate prefill/decode spans; the shared
        #: disabled tracer by default
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.quantize = quantize
        self.params = init_mesh_serving(config, params, quantize, mesh,
                                        self.device)
        self._family = resolve_family(config)

    def load_weights(self, params: dict) -> None:
        """Serve ``params`` from the next :meth:`generate` on (a refreshed
        policy: the JAX loop's ``init_mesh_serving`` onto the engine's
        mesh), prepared as at construction and copied into the tensors
        the engine holds. Under a mesh every rank calls it, as it calls
        ``generate``."""
        load_into(self.params, init_mesh_serving(
            self.config, params, self.quantize, self.mesh, self.device))

    def _step(self, cache, tokens, start_pos: int, valid):
        return self._family.forward_step(self.config, self.params, tokens,
                                         cache, start_pos, valid,
                                         mesh=self.mesh)

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
                                            device=dev, mesh=self.mesh)
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

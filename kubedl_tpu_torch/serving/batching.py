"""Continuous batching: slot-scheduled decoding over a shared KV cache.

Counterpart of ``kubedl_tpu/serving/batching.py``. The engine keeps a
fixed set of ``lanes`` (batch rows of one shared cache) and schedules
requests onto free lanes as they open:

* ONE decode step for all lanes per tick, with **per-row positions**
  (``llama.attention_step``'s vector ``start_pos``): requests of
  different lengths come and go without re-padding;
* prefill writes a single lane of the shared cache in place, with
  prompts right-padded into power-of-two buckets (the JAX engine's
  bucket shapes);
* dead lanes keep decoding garbage (masking happens in the scheduler,
  not the step), and their cache writes land on slots that are
  overwritten before ever becoming attendable;
* scheduling (arrivals, eos, lane reuse) is host-side Python between
  ticks.

**Paged KV (the default, ``KUBEDL_KV_MODE=paged``)**: KV lives in ONE
pool of fixed-size token blocks (``models.llama.init_block_pool``)
indexed through per-lane host-side block tables that grow on demand.
Registered prefixes pin their full blocks once and every matching
request's table references them (copy-on-write sharing with refcounts);
admission requires free blocks for the prompt plus headroom, and when
the pool runs dry mid-decode the lowest-progress lane is preempted back
to the queue (resumed later by re-prefilling prompt + generated-so-far).
``KUBEDL_KV_MODE=dense`` keeps a per-lane slab; ``parity`` runs both and
asserts token-identical logits every step.

**The decode tick on the card is a CUDA graph.** The JAX engine jits its
decode tick into one XLA program with the block tables as a traced
operand. Here :class:`DecodeTick` captures ``forward_step`` at
``[lanes, 1]`` once per engine, KV layout and model (the draft too), with
the tokens, positions and tables in one static buffer that is refilled
before each replay: growing, sharing or freeing blocks changes the
tables' values, never a shape. Sampling stays outside the graph, and so
do the prefill buckets and the speculative verify pass (eager). On the
CPU the tick runs eagerly; :func:`decode_tick_route` names the route.

**Weight quantization** (``quantize`` / ``quantize_draft``: "int8" or
"int4") quantizes the target's or the draft's weights as they move to
the device; the leaves stay quantized there and the tick's graph captures
their dequantize. **Multi-model adapters** (``adapters=`` an
``AdapterCatalog``, ``max_adapters``): requests carry a ``model=`` id and
the adapter's weight pages allocate from the same refcounted pool as KV
blocks (``serving/adapters.py``); residency is host accounting, so greedy
tokens under an adapter equal the base model's, as in the JAX engine.

**Serving over a mesh** (``mesh=`` a serving mesh over any of its axes,
one process per card): every rank builds the engine with the same
arguments and holds its shard of the weights (``tp`` columns of whole
query heads, ``ep`` experts, the ``embed`` dim's ``fsdp`` shard,
gathered per use) and its KV heads (``engine.init_mesh_serving``); over
``dp``, ``pp`` and ``cp`` it holds everything and runs the whole step
(``engine.serving_mesh``). Rank 0 runs the scheduler, and every
device step goes through :meth:`ContinuousBatchingEngine._dev`, which
posts the step and its host arguments on the step channel
(``serving/tp.py``) before running it; the other ranks call
:meth:`ContinuousBatchingEngine.follow` and repeat each step. The tick's
route is stated, never chosen silently: ``graph`` on a card when its
collectives can be captured (NCCL, or none in the step), ``eager`` under
a gloo group (:func:`decode_tick_route`).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops.decode import count_replays, paged_decode
from ..parallel.collectives import is_sharded
from ..trace import NOOP_TRACER
from .engine import (SERVING_AXES, GenerateConfig, SpecStats,
                     filtered_probs, hit_stop, init_mesh_serving, load_into,
                     resolve_family, sample_logits, sample_logits_many,
                     serving_mesh, serving_tp, spec_accept, token_logprobs)

log = logging.getLogger("kubedl_tpu_torch.serving")


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (max(n, 1).bit_length() - 1)


ENV_KV_MODE = "KUBEDL_KV_MODE"
KV_MODES = ("dense", "paged", "parity")


def resolve_kv_mode(mode: Optional[str] = None) -> str:
    """KV layout mode: explicit arg wins, then ``$KUBEDL_KV_MODE``, then
    the paged default. ``dense`` keeps the per-lane slab; ``parity`` runs
    both and asserts token-identical logits each step."""
    mode = mode or os.environ.get(ENV_KV_MODE, "") or "paged"
    if mode not in KV_MODES:
        raise ValueError(
            f"unknown KV mode {mode!r}; one of {KV_MODES}")
    return mode


def fit_block(block: int, max_len: int) -> int:
    """Largest block size <= ``block`` that divides ``max_len`` (halving
    search, floor 1). Divisibility makes the paged gather view EXACTLY
    ``max_len`` slots, so parity mode's logits compare with the dense
    slab's at the same reduction lengths."""
    b = max(int(block), 1)
    while max_len % b:
        b //= 2
    return max(b, 1)


class BlockPool:
    """Host-side allocator for the paged KV pool.

    Physical block ids run ``1..total`` — id 0 is the reserved garbage
    sink every free table entry points at. Blocks are refcounted so
    registered prefixes can pin blocks that many lanes reference
    concurrently: ``alloc`` starts a block at refcount 1, ``incref``
    adds a sharer, ``decref`` returns the block to the free list at
    zero. ``allocs`` counts lifetime block allocations."""

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"pool needs >= 1 usable block, got {total}")
        self.total = total
        # pop() hands out low ids first
        self._free = list(range(total, 0, -1))
        self._ref: dict[int, int] = {}
        self.allocs = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.total - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks referenced by more than one holder (prefix sharing)."""
        return sum(1 for r in self._ref.values() if r > 1)

    def alloc(self, n: int) -> Optional[list]:
        """n fresh blocks at refcount 1, or None when the pool is dry
        (all-or-nothing: a partial grant would leak on the retry path)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.allocs += n
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self._ref[b] += 1

    def decref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            r = self._ref[b] - 1
            if r:
                self._ref[b] = r
            else:
                del self._ref[b]
                self._free.append(b)

    def refcounts(self) -> dict:
        """Live block -> refcount snapshot (leak checks)."""
        return dict(self._ref)


@dataclass(frozen=True)
class _Prefix:
    """One registered prompt prefix. ``stored`` is the id of the
    dense-mode full KV copy (the engine's ``_stored``); ``blocks`` are the paged pool blocks pinned for the prefix's
    FULL blocks only — the partial tail block is never shared (two lanes
    would write different tokens into it), it is re-prefilled per lane.
    ``pinned`` prefixes are exempt from the least-recently-hit eviction
    at ``max_prefixes``. ``model`` scopes the entry ("" = base model)."""
    key: tuple
    plen: int
    stored: Optional[int] = None
    blocks: tuple = ()
    pinned: bool = False
    model: str = ""


@dataclass
class Request:
    """One in-flight generation; ``done`` fires when ``tokens`` is final
    (or the engine stopped — then ``cancelled`` is set). With
    ``want_logprobs`` each generated token's full-softmax log p lands in
    ``logprobs``.

    Tokens are appended by the scheduler thread as they decode;
    :meth:`stream` consumes them incrementally (the server's SSE path
    rides this), :meth:`result` waits for the final list."""
    prompt: list
    max_new: int
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)
    want_logprobs: bool = False
    #: adapter id this request decodes under ("" = the base model).
    #: Admission gates on the adapter being resident (a cold one faults
    #: its weight pages in through the pool first)
    model: str = ""
    #: per-request sampling overrides; None = the engine's GenerateConfig
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    cancelled: bool = False
    #: client-requested stop (set via :meth:`cancel`): the scheduler frees
    #: the lane at its next tick; tokens decoded so far remain
    cancel_requested: bool = False
    #: scheduler-reported failure (e.g. a request that can never be
    #: admitted because the KV pool is too small after prefix pins)
    error: Optional[str] = None
    #: request trace id, assigned at submit when the engine carries an
    #: enabled tracer; "" otherwise
    trace_id: str = ""
    _cond: threading.Condition = field(default_factory=threading.Condition)
    # trace bookkeeping (engine-side; meaningless when trace_id == "")
    _span_root: str = ""
    _t_submit: float = 0.0
    _t_queue: float = 0.0     # when the request (re-)entered the queue
    _t_decode: float = 0.0
    _preempts: int = 0
    #: speculative lanes: the per-request host rng of the sampled accept
    #: rule, made at first admission (a resumed request keeps it)
    _spec_rng: Optional[np.random.Generator] = None

    def cancel(self) -> None:
        """Stop generating for this request. Unlike engine shutdown,
        ``result()`` still returns the tokens decoded so far."""
        self.cancel_requested = True

    def result(self, timeout: Optional[float] = None) -> list:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.cancelled:
            raise RuntimeError(
                self.error or "generation cancelled: engine stopped")
        return self.tokens

    def stream(self, timeout: Optional[float] = None):
        """Yield ``(token_id, logprob_or_None)`` as the scheduler emits
        them; returns when generation finishes. ``timeout`` bounds the
        wait for EACH next token."""
        sent = 0
        while True:
            with self._cond:
                while len(self.tokens) <= sent and not self.done.is_set():
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            "no token within the streaming timeout")
                # snapshot under the lock: _push appends token and logprob
                # in one critical section, so the pairs read here align
                fresh = []
                while sent < len(self.tokens):
                    lp = (self.logprobs[sent] if self.want_logprobs
                          and sent < len(self.logprobs) else None)
                    fresh.append((self.tokens[sent], lp))
                    sent += 1
                finished = self.done.is_set() and sent >= len(self.tokens)
                cancelled = self.cancelled
            yield from fresh
            if finished:
                if cancelled:
                    raise RuntimeError(
                        self.error or "generation cancelled: engine stopped")
                return

    # -- scheduler-side helpers (single writer: the scheduler thread) ----

    def _push(self, tok: int, lp: Optional[float]) -> None:
        with self._cond:
            self.tokens.append(tok)
            if lp is not None:
                self.logprobs.append(lp)
            self._cond.notify_all()

    def _finish(self, cancelled: bool = False) -> None:
        with self._cond:
            self.cancelled = self.cancelled or cancelled
            self.done.set()
            self._cond.notify_all()


@dataclass
class _Lane:
    request: Optional[Request] = None    # None = free
    pos: int = 0               # next write position (== tokens so far)
    remaining: int = 0
    #: paged modes: pool blocks this lane references, in logical order
    #: (shared prefix blocks first, then private); freed via decref
    blocks: list = field(default_factory=list)
    #: disaggregated serving: a prefill lane whose request finished
    #: prefilling and waits for a free decode lane to take the
    #: block-table handoff; masked out of decode ticks
    parked: bool = False
    parked_at: float = 0.0     # tracer clock at park (handoff span)
    #: multi-model serving: the adapter this lane decodes under and the
    #: weight pages it increfed at admission (released exactly once via
    #: _free_lane; a handoff MOVES them with the block-table row)
    adapter: str = ""
    adapter_blocks: list = field(default_factory=list)

    def reset(self) -> None:
        self.request = None
        self.pos = 0
        self.remaining = 0
        self.blocks = []
        self.parked = False
        self.parked_at = 0.0
        self.adapter = ""
        self.adapter_blocks = []


def decode_tick_route(device, mesh=None) -> str:
    """How a decode tick runs on ``device``: ``graph`` on a CUDA device
    (a captured CUDA graph, replayed every tick; a capture that fails
    raises, there is no eager fallback) when the tick's collectives can
    be captured (NCCL, or a step that runs none: one rank, or only
    ``dp``, ``pp`` and ``cp``), ``eager`` under a gloo ``tp``, ``ep`` or
    ``fsdp`` group and off the card."""
    if torch.device(device).type != "cuda":
        return "eager"
    mesh = serving_mesh(mesh)
    for axis in SERVING_AXES:
        if is_sharded(mesh) and mesh.size(axis) > 1:
            import torch.distributed as dist
            if dist.get_backend(mesh.group(axis)) != "nccl":
                return "eager"
    return "graph"


class DecodeTick:
    """One ``[lanes, 1]`` decode step of one model over one KV store.

    ``step(cur [lanes, 1], pos [lanes], tables [lanes, n] or None) ->
    logits [lanes, vocab]`` writes the tick's K/V in place. The host
    inputs travel as one int64 buffer (:meth:`pack`: tokens, positions,
    then tables), the one a tensor-parallel rank 0 posts to its
    followers. On the ``graph`` route the first :meth:`run` copies the
    buffer to the device, runs ``step`` twice on a side stream (the
    allocator's and the libraries' warm-up; the communicators' too under
    a mesh) and captures it; every run then refills the static buffer
    with one host-to-device copy and replays. The logits come back in the graph's
    static output, valid until the next call. Re-running a tick on the
    same inputs rewrites the same K/V at the same slots, so the warm-up
    runs on live lane state are harmless. ``launches`` counts ticks by
    route; each replay also counts the attention kernel's calls it holds
    in ``ops.decode.paged_decode.launches``. With ``tracer`` enabled, ``launch_at`` is its clock read just
    before the last tick's replay (or eager step)."""

    def __init__(self, step, lanes: int, n_tables: int, device,
                 route: Optional[str] = None, tracer=NOOP_TRACER):
        self._step = step
        self.lanes = lanes
        self.n_tables = n_tables
        self.device = torch.device(device)
        self.route = route or decode_tick_route(self.device)
        self.launches = {"graph": 0, "eager": 0}
        self.tracer = tracer
        self.launch_at = 0.0
        self._graph = None
        self._static = None
        self._logits = None
        self._kernels = 0

    def _views(self, buf):
        n = self.lanes
        tables = buf[2 * n:].view(n, self.n_tables) if self.n_tables else None
        return buf[:n].view(n, 1), buf[n:2 * n], tables

    def pack(self, cur, pos, tables=None) -> np.ndarray:
        """The tick's host inputs as the one int64 buffer a replay copies
        in (what the step channel posts)."""
        parts = [np.asarray(cur).reshape(-1), np.asarray(pos).reshape(-1)]
        if self.n_tables:
            parts.append(np.asarray(tables).reshape(-1))
        return np.concatenate(parts).astype(np.int64)

    def eager(self, buf: np.ndarray):
        """The tick on a packed buffer run eagerly, whatever the route
        (the comparison path; not counted in ``launches``)."""
        return self._step(*self._views(
            torch.from_numpy(buf).to(self.device)))

    def run(self, buf: np.ndarray):
        """One tick on a packed buffer, on the tick's route (counted)."""
        if self.route == "eager":
            self.launches["eager"] += 1
            if self.tracer.enabled:
                self.launch_at = self.tracer.clock()
            return self.eager(buf)
        host = torch.from_numpy(buf)
        if self._graph is None:
            self._capture(host)
        self._static.copy_(host)
        if self.tracer.enabled:
            self.launch_at = self.tracer.clock()
        self._graph.replay()
        self.launches["graph"] += 1
        if self._kernels:
            count_replays(self._kernels)
        return self._logits

    def _capture(self, host: torch.Tensor) -> None:
        static = host.to(self.device)
        args = self._views(static)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step(*args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        captured = paged_decode.captured
        # thread_local: the HTTP threads may touch the card meanwhile
        # (an embeddings forward); only this thread's calls are captured
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            logits = self._step(*args)
        self._kernels = paged_decode.captured - captured
        self._static, self._logits, self._graph = static, logits, graph

    def reset(self) -> None:
        """Drop the captured graph (the next call captures anew)."""
        self._graph = self._static = self._logits = None


class ContinuousBatchingEngine:
    """Slot-scheduled generation over one shared cache, on ``device``
    (``None``: the card; ``"cpu"`` only when asked).

    ``run(requests)`` takes ``[(prompt_tokens, max_new_tokens), ...]`` in
    arrival order and returns one generated-id list per request; requests
    are admitted to lanes as earlier ones finish, so a short request never
    waits on a long co-batched one.

    Under a serving ``mesh`` (its device; see the module docstring) rank
    0 schedules and the other ranks call :meth:`follow`; the draft rides
    the same mesh, sharded by its own specs. ``launcher`` (set by the
    predictor) is the ``parallel.launch.LocalRanks`` of the followers
    this process started: :meth:`stop` closes it."""

    def __init__(self, config, params: dict,
                 lanes: int = 4, max_len: int = 1024,
                 gen: Optional[GenerateConfig] = None,
                 quantize: Optional[str] = None, seed: int = 0,
                 mesh=None, draft_config=None, draft_params=None,
                 spec_k: int = 0, quantize_draft: Optional[str] = None,
                 kv_mode: Optional[str] = None, kv_block: int = 64,
                 pool_blocks: Optional[int] = None,
                 headroom_blocks: int = 1, tracer=None,
                 prefill_lanes: int = 0, adapters=None,
                 max_adapters: Optional[int] = None, device=None):
        tp = serving_tp(mesh)
        mesh = serving_mesh(mesh)
        if max_adapters is not None and adapters is None:
            # the JAX engine ignores the cap without a catalog; a cap that
            # would silently do nothing is refused here
            raise ValueError("max_adapters caps resident adapters: it needs "
                             "an adapter catalog (adapters=)")
        self.family = family = resolve_family(config)
        self.mesh = mesh
        self.device = dev = (mesh.device if mesh is not None
                             else resolve_device(device))
        self.config = config
        #: span recorder: per request (queue/prefill/decode/preemption)
        #: and per decode step (``engine.step``/``tick``/``sample``, on
        #: the engine's own trace)
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self._trace_id = self.tracer.new_trace_id()
        self._steps_traced = 0
        self.lanes = lanes
        self.max_len = max_len
        self.gen = gen or GenerateConfig(max_len=max_len)
        #: KV layout: "paged" (default), "dense" (per-lane slab), or
        #: "parity" (both, asserted token-identical)
        self.kv_mode = resolve_kv_mode(kv_mode)
        #: tokens per pool block, clamped so it divides max_len
        self.kv_block = fit_block(kv_block, max_len)
        self._bpl = max_len // self.kv_block   # table entries per lane
        #: usable pool blocks (the garbage sink rides on top); the
        #: default matches the dense slab's capacity
        self.pool_blocks = (int(pool_blocks) if pool_blocks
                            else lanes * self._bpl)
        if self.pool_blocks < self._bpl:
            raise ValueError(
                f"pool_blocks {self.pool_blocks} < {self._bpl} blocks "
                f"needed for one full-length request (max_len {max_len} "
                f"/ block {self.kv_block})")
        #: admission watermark: free blocks required beyond the prompt's
        self.headroom_blocks = max(int(headroom_blocks), 0)
        #: disaggregated prefill/decode: the first ``prefill_lanes`` lanes
        #: only run prefills and hand their block table to a free decode
        #: lane (no KV copied)
        self.prefill_lanes = int(prefill_lanes)
        if self.prefill_lanes:
            if self.kv_mode != "paged":
                raise ValueError(
                    "disaggregated prefill lanes require the paged KV "
                    "layout (the handoff moves block-table references; "
                    "a dense slab would need a device KV copy)")
            if not 0 < self.prefill_lanes < lanes:
                raise ValueError(
                    f"prefill_lanes {self.prefill_lanes} must leave at "
                    f"least one decode lane (lanes {lanes})")
            if draft_params is not None and spec_k:
                raise ValueError(
                    "speculative decoding and disaggregated prefill "
                    "lanes are mutually exclusive (the verify round "
                    "spans every lane)")
        #: lifetime prefill→decode block-table handoffs (/metrics)
        self.handoffs = 0
        #: prompt tokens prefilled in the current / all scheduler ticks
        self.prefill_tokens_step = 0
        self.prefill_tokens_total = 0
        #: requests admitted (prefilled) in the current scheduler tick
        self.admitted_step = 0
        #: lifetime preemption count (pool ran dry; /metrics counter)
        self.preempted = 0
        #: peak simultaneously-active lanes
        self.peak_active = 0
        if adapters is not None and self.kv_mode == "dense":
            raise ValueError(
                "multi-model adapters require a paged KV layout (adapter "
                "weight pages live in the block pool; a dense slab has no "
                "pool to page them from)")
        #: the weights on the device: quantized there leaf by leaf under
        #: ``quantize`` ("int8"/"int4"), never densified afterwards; under
        #: a mesh, this rank's shard of each (quantize is refused there)
        self.quantize = quantize
        self.params = init_mesh_serving(config, params, quantize, mesh, dev)
        #: tensor-parallel serving: the step channel rank 0 posts every
        #: device step on (None without a mesh), the lock that keeps each
        #: post and its local run together, and the route of every tick
        self._channel = None
        if mesh is not None:
            from .tp import StepChannel
            self._channel = StepChannel(mesh)
        self._op_lock = threading.Lock()
        self.launcher = None
        route = decode_tick_route(dev, mesh)
        if mesh is not None:
            log.info("serving over a mesh, rank %d of %d (tp=%d): decode "
                     "tick route %s", self._channel.rank,
                     self._channel.world, tp, route)

        # -- speculative decoding per lane: the draft proposes spec_k
        # tokens for EVERY lane, the target verifies all lanes' chunks in
        # one [lanes, k+1] pass
        self.spec_k = int(spec_k) if draft_params is not None else 0
        if self.spec_k:
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    "target and draft must share a vocabulary")
            self.dcfg = draft_config
            self.dfam = resolve_family(draft_config)
            # the draft rides the same mesh, cut by its own specs
            self.dparams = init_mesh_serving(draft_config, draft_params,
                                             quantize_draft, mesh, dev)
            #: aggregate + per-lane acceptance accounting (/metrics)
            self.stats = SpecStats()
            self.lane_stats = [SpecStats() for _ in range(lanes)]
            # the draft cache stays a dense slab in every kv mode
            self._d_cache = self.dfam.init_cache(self.dcfg, lanes, max_len,
                                                 device=dev, mesh=mesh)
            self._d_tick = DecodeTick(
                lambda cur, pos, _: self.dfam.forward_step(
                    self.dcfg, self.dparams, cur, self._d_cache, pos,
                    mesh=mesh)[0],
                lanes, 0, dev, route, self.tracer)
            #: per-request host rng for the sampled accept rule,
            #: allocated at admission (seed + admission ordinal)
            self._spec_admitted = 0

        self._prefixes: list = []   # sorted [_Prefix], longest first
        #: dense mode: each prefix's KV, by the id its ``_Prefix.stored``
        #: holds (every rank keeps its own under the same ids)
        self._stored: dict = {}
        self._stored_ids = itertools.count(1)
        #: admission-time hit ordinals per prefix key — the
        #: least-recently-hit order register_prefix evicts in
        self._prefix_hits: dict = {}
        self._prefix_hit_clock = 0
        # live scheduler state: one shared cache (dense slab and/or paged
        # pool per kv_mode) + lane bookkeeping; the host mirrors
        # (cur/pos/tables) feed the per-tick decode call
        if self.kv_mode in ("dense", "parity"):
            self._cache = family.init_cache(config, lanes, max_len,
                                            device=dev, mesh=mesh)
            self._tick = DecodeTick(
                lambda cur, pos, _: family.forward_step(
                    config, self.params, cur, self._cache, pos,
                    mesh=mesh)[0],
                lanes, 0, dev, route, self.tracer)
        if self.kv_mode in ("paged", "parity"):
            self._pool = family.init_block_pool(
                config, self.pool_blocks + 1, self.kv_block, device=dev,
                mesh=mesh)
            self._bpool = BlockPool(self.pool_blocks)
            self._tables = np.zeros((lanes, self._bpl), np.int64)
            self._tick_p = DecodeTick(
                lambda cur, pos, tables: family.forward_step_paged(
                    config, self.params, cur, self._pool, tables, pos,
                    mesh=mesh)[0],
                lanes, self._bpl, dev, route, self.tracer)
        #: multi-model serving: an AdapterCatalog turns this engine into a
        #: multiplexer — requests carry a ``model=`` id and the adapter's
        #: weight pages allocate from the SAME refcounted pool as KV
        #: blocks. ``max_adapters`` caps the resident count (the
        #: ``max_prefixes`` analog)
        self._adapters = None
        if adapters is not None:
            from .adapters import AdapterResidency
            self._adapters = AdapterResidency(adapters, self._bpool,
                                              max_resident=max_adapters)
        #: monotonic residency generation: bumped whenever the prefix set
        #: or the resident-adapter set changes, so a router can cache
        #: residency snapshots
        self.residency_epoch = 0
        #: adapter weight pages cold-faulted in the current tick
        self.adapter_fault_pages_step = 0
        self._lane_state = [_Lane() for _ in range(lanes)]
        self._cur = np.zeros((lanes, 1), np.int64)
        self._pos = np.zeros((lanes,), np.int64)
        self._seed = seed
        self._rng = torch.Generator(device=dev).manual_seed(seed)
        self._queue: deque[Request] = deque()
        self._cv = threading.Condition()
        #: serializes the whole scheduler step (the shared cache and the
        #: lane bookkeeping): inline run() callers and the background
        #: loop can never tick concurrently
        self._sched_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    # -- the device steps ----------------------------------------------------
    #
    # Every device step runs through ``_dev``: under a mesh it is posted on
    # the step channel first, and the followers repeat it (``follow``).
    # Each ``_op_*`` takes host arguments only and works on this rank's
    # own weights and caches.

    def _dev(self, op: str, **args):
        """Run device step ``op`` here, posting it to the followers first
        (one lock holds the post and the run together, so every rank runs
        the steps in one order)."""
        with self._op_lock:
            if self._channel is not None:
                self._channel.post(op, args)
            out = self._run_op(op, args)
            if self.launcher is not None and self.launcher.failed.is_set():
                # a step its groups' abort ended: what it read is garbage
                raise RuntimeError("a tensor-parallel rank exited while "
                                   "serving")
            return out

    def _run_op(self, op: str, args: dict):
        return getattr(self, "_op_" + op)(**args)

    def follow(self) -> int:
        """A follower rank's loop: repeat rank 0's device steps until it
        stops (``serving.tp.follow``). Returns the steps run."""
        from .tp import follow
        return follow(self)

    def _op_noop(self) -> None:
        """Rank 0's heartbeat while idle."""

    def _op_decode(self, tick: str, buf, eager: bool = False):
        t = {"dense": getattr(self, "_tick", None),
             "paged": getattr(self, "_tick_p", None),
             "draft": getattr(self, "_d_tick", None)}[tick]
        return t.eager(buf) if eager else t.run(buf)

    def _forward_chunk(self, model: str, cache, tables, toks, pos0: int,
                       n: int):
        """One right-padded prefill bucket through ``forward_step`` (or
        ``forward_step_paged`` with ``tables``) against ``cache``: the
        real last token's logits. The valid mask marks the live cache
        region, as the JAX prefill's."""
        dev = self.device
        fam, cfg, params = ((self.family, self.config, self.params)
                            if model == "target"
                            else (self.dfam, self.dcfg, self.dparams))
        view = cache["k"].shape[2] if tables is None else \
            tables.shape[1] * self.kv_block
        valid = (torch.arange(view, device=dev) < pos0 + n)[None, :]
        toks_t = torch.as_tensor(toks, device=dev)
        if tables is None:
            return fam.forward_step(cfg, params, toks_t, cache, pos0,
                                    valid=valid, last_pos=n - 1,
                                    mesh=self.mesh)[0]
        return fam.forward_step_paged(cfg, params, toks_t, cache, tables,
                                      pos0, valid=valid, last_pos=n - 1,
                                      mesh=self.mesh)[0]

    def _op_prefill(self, model: str, kv: str, ref, toks, pos0: int,
                    n: int):
        """One prefill chunk of ``model`` ("target" or "draft"): into lane
        ``ref``'s rows of the dense cache (``kv="dense"``) or through the
        block-table row ``ref`` [1, blocks_per_row] of the pool
        (``kv="paged"``)."""
        tables = None
        if kv == "dense":
            src = self._cache if model == "target" else self._d_cache
            cache = {k: v[:, ref:ref + 1] for k, v in src.items()}
        else:
            cache = self._pool
            tables = torch.as_tensor(ref, device=self.device)
        return self._forward_chunk(model, cache, tables, toks, pos0, n)

    def _op_store_prefix(self, sid: int, toks, n: int) -> None:
        """Dense mode: prefill a prefix on a scratch single-lane cache
        sized to its bucket, kept as ``_stored[sid]`` (garbage beyond its
        length is causally invisible once loaded into a lane)."""
        scratch = self.family.init_cache(self.config, 1, toks.shape[1],
                                         device=self.device, mesh=self.mesh)
        self._forward_chunk("target", scratch, None, toks, 0, n)
        self._stored[sid] = scratch

    def _op_load_prefix(self, sid: int, lane: int) -> None:
        """Copy a stored prefix KV block into one lane's cache rows."""
        stored = self._stored[sid]
        for k, c in self._cache.items():
            s = stored[k]
            c[:, lane, :s.shape[2]].copy_(s[:, 0])

    def _op_prune(self, keep) -> None:
        """Drop the stored prefixes not in ``keep``."""
        self._stored = {k: v for k, v in self._stored.items() if k in keep}

    def _op_verify(self, kv: str, chunk, pos, tables=None):
        """The target's [lanes, k+1] pass at per-row positions (eager):
        all-position logits, against the dense cache or the pool."""
        dev = self.device
        chunk_t = torch.as_tensor(chunk, device=dev)
        pos_t = torch.as_tensor(pos, device=dev)
        if kv == "dense":
            return self.family.forward_step(
                self.config, self.params, chunk_t, self._cache, pos_t,
                all_logits=True, mesh=self.mesh)[0]
        return self.family.forward_step_paged(
            self.config, self.params, chunk_t, self._pool,
            torch.as_tensor(tables, device=dev), pos_t, all_logits=True,
            mesh=self.mesh)[0]

    def _op_recover(self) -> None:
        """Zero every cache in place and drop the captured graphs (a
        graph holds the caches' addresses; the next tick captures anew)."""
        for tick in self._ticks():
            tick.reset()
        caches = [getattr(self, n, None) for n in ("_cache", "_pool",
                                                  "_d_cache")]
        for cache in caches:
            for t in (cache or {}).values():
                t.zero_()

    def _op_embed(self, toks):
        """The final hidden states [b, s, d] of ``toks`` (the
        ``/v1/embeddings`` forward; the flash kernel on the card)."""
        out = self.family.forward_hidden(
            self.config, self.params, torch.as_tensor(toks,
                                                      device=self.device),
            mesh=self.mesh)
        return out[0] if isinstance(out, tuple) else out   # MoE: (x, aux)

    @torch.no_grad()
    def hidden_states(self, tokens):
        """``/v1/embeddings``' forward of ``tokens`` [b, s] (int) as a
        device step, so under a mesh every rank runs it in the order rank
        0's steps run: the final hidden states [b, s, d] on the device."""
        return self._dev("embed", toks=np.asarray(tokens, np.int64))

    def _decode(self, cur, pos):
        """Dense decode tick: logits [lanes, vocab] on the device."""
        return self._dev("decode", tick="dense", buf=self._tick.pack(cur, pos))

    def _decode_p(self, cur, pos, tables):
        """Paged decode tick: logits [lanes, vocab] on the device."""
        return self._dev("decode", tick="paged",
                         buf=self._tick_p.pack(cur, pos, tables))

    def _d_decode(self, cur, pos):
        """Draft decode tick over the draft's dense cache."""
        return self._dev("decode", tick="draft",
                         buf=self._d_tick.pack(cur, pos))

    def _ticks(self) -> list:
        return [t for t in (getattr(self, "_tick", None),
                            getattr(self, "_tick_p", None),
                            getattr(self, "_d_tick", None)) if t is not None]

    @property
    def tick_launches(self) -> dict:
        """Decode ticks run so far by route, over every tick of the
        engine (target dense and paged, draft)."""
        out = {"graph": 0, "eager": 0}
        for t in self._ticks():
            for route, n in t.launches.items():
                out[route] += n
        return out

    @torch.no_grad()
    def decode_tick(self, route: Optional[str] = None):
        """One target decode tick on the engine's current lane state,
        without advancing any lane: it rewrites the K/V the next real
        tick writes, at the same slots. Returns the logits [lanes, vocab]
        on the device (a graph's static output: read them before the next
        tick). ``route`` is ``"eager"`` or the engine's own route
        (``None``: :func:`decode_tick_route` of its device); the paged
        tick where the engine has one. For timing the tick, and holding
        the graph against the eager tick on one state."""
        with self._sched_lock:
            paged = self.kv_mode != "dense"
            tick = self._tick_p if paged else self._tick
            buf = (tick.pack(self._cur, self._pos, self._tables) if paged
                   else tick.pack(self._cur, self._pos))
            if route not in (None, "eager", tick.route):
                raise ValueError(f"route {route!r} does not run on "
                                 f"{self.device.type}")
            return self._dev("decode", tick="paged" if paged else "dense",
                             buf=buf, eager=route == "eager")

    # -- public API -------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, tokens: Sequence[int],
                        max_prefixes: Optional[int] = None,
                        pinned: bool = False, model: str = "") -> None:
        """Prefill a shared prompt prefix ONCE; later requests whose
        prompts start with it skip re-prefilling it. Greedy outputs are
        unchanged (the shared KV is what the full prefill would have
        written).

        Dense mode stashes a full KV copy that is written into each
        matching lane. Paged modes pin the prefix's FULL blocks in the
        pool instead: matching lanes point their block tables at them
        (refcounted copy-on-write sharing, no device copy at admission);
        the partial tail block is never shared and is re-prefilled per
        lane.

        At ``max_prefixes`` the LEAST-RECENTLY-HIT unpinned prefix is
        evicted (its pin decref'd — lanes still referencing the blocks
        keep them alive until they finish); only when every stored prefix
        is ``pinned`` does the cap raise. ``model`` scopes the entry
        ("" = base model)."""
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty prefix")
        plen = len(tokens)
        if plen >= self.max_len:
            raise ValueError(
                f"prefix {plen} exceeds cache capacity {self.max_len}")
        key = tuple(tokens)
        model = model or ""
        if max_prefixes is not None and \
                not any(p.key == key and p.model == model
                        for p in self._prefixes) and \
                len(self._prefixes) >= max_prefixes and \
                all(p.pinned for p in self._prefixes):
            # optimistic pre-check: a rejected registration must not first
            # burn a full device prefill (the authoritative check below
            # runs under the lock)
            raise ValueError(
                f"prefix limit {max_prefixes} reached and every stored "
                "prefix is pinned (each prefix pins a KV block in memory)")
        stored = None
        if self.kv_mode == "dense":
            stored = self._fill_prefix(tokens)
        with self._sched_lock:
            # dedup (re-registering replaces) + longest-first ordering so
            # the best match wins during admission; swap in a NEW list so
            # concurrent _match_prefix iterations never see a mid-sort view
            entries = [p for p in self._prefixes
                       if not (p.key == key and p.model == model)]
            # the cap is enforced here, under the lock: an idempotent
            # re-register (key already stored) is never rejected
            evicted: list = []
            if max_prefixes is not None:
                while len(entries) >= max_prefixes:
                    victims = [p for p in entries if not p.pinned]
                    if not victims:
                        # dense: drop the KV just stored for this prefix
                        self._prune_stored()
                        raise ValueError(
                            f"prefix limit {max_prefixes} reached and "
                            "every stored prefix is pinned (each prefix "
                            "pins a KV block in memory)")
                    victim = min(victims, key=lambda p: (
                        self._prefix_hits.get((p.model, p.key), 0),
                        p.model, p.key))
                    entries = [p for p in entries
                               if not (p.key == victim.key
                                       and p.model == victim.model)]
                    evicted.append(victim)
            blocks: tuple = ()
            if self.kv_mode != "dense":
                # release a replaced pin BEFORE allocating the new one: an
                # idempotent re-register never needs net-new blocks. The
                # entry list is swapped in first so a failed re-fill never
                # leaves a registered entry pointing at freed blocks
                for old in self._prefixes:
                    if old.key == key and old.model == model \
                            and old.blocks:
                        self._bpool.decref(old.blocks)
                for victim in evicted:
                    if victim.blocks:
                        self._bpool.decref(victim.blocks)
                self._prefixes = entries
                # KV at position p depends only on tokens <= p, so the
                # shareable full blocks need exactly the first
                # n_full*block tokens prefilled — the tail is per-lane
                n_full = plen // self.kv_block
                if n_full:
                    got = self._bpool.alloc(n_full)
                    if got is None:
                        raise ValueError(
                            f"KV pool exhausted: prefix needs {n_full} "
                            f"blocks, {self._bpool.free_count} free")
                    blocks = tuple(got)
                    try:
                        self._fill_prefix_blocks(
                            blocks, tokens[:n_full * self.kv_block])
                    except BaseException:
                        # `got` would stay at refcount 1 with no owner:
                        # rebuild pool + allocator + surviving pins, as
                        # after a failed inline step
                        self._recover_locked()
                        raise
            for victim in evicted:
                self._prefix_hits.pop((victim.model, victim.key), None)
            # seed the hit clock at registration: a never-yet-admitted
            # prefix ranks by registration recency, not a tie at 0
            self._record_prefix_hit((model, key))
            entries = entries + [_Prefix(key=key, plen=plen,
                                         stored=stored, blocks=blocks,
                                         pinned=bool(pinned),
                                         model=model)]
            entries.sort(key=lambda p: -p.plen)
            self._prefixes = entries
            self._prune_stored()
            self.residency_epoch += 1

    def _prune_stored(self) -> None:
        """Dense mode: drop the stored prefix KV no entry holds any more
        (caller holds ``_sched_lock``)."""
        if self.kv_mode == "dense":
            self._dev("prune", keep=sorted(p.stored for p in self._prefixes))

    def _chunked_prefill(self, target: dict, seq: list, start: int):
        """THE chunking rule, shared by every prefill path (dense lane,
        paged lane, prefix fill, draft): feed ``seq[start:]`` to the
        ``prefill`` device step on ``target`` (its ``model``, ``kv`` and
        ``ref``) in right-padded power-of-two chunks that fit the
        remaining cache space, so a padded chunk never runs past the
        cache end. Returns the last chunk's logits. validate() guarantees
        the fit."""
        logits = None
        pos0, remaining = start, list(seq[start:])
        while remaining:
            space = self.max_len - pos0
            bucket = min(_bucket(len(remaining)), _pow2_floor(space))
            n = min(len(remaining), bucket)
            chunk, remaining = remaining[:n], remaining[n:]
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :n] = chunk
            logits = self._dev("prefill", **target, toks=toks, pos0=pos0,
                               n=n)
            pos0 += n
        return logits

    def _fill_prefix(self, tokens: list, sid: Optional[int] = None) -> int:
        """Dense mode: prefill a prefix into its own stored KV (the
        ``store_prefix`` step), under a new id or over the stored ``sid``;
        returns the id it is stored under."""
        plen = len(tokens)
        bucket = min(_bucket(plen), self.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = tokens
        if sid is None:
            sid = next(self._stored_ids)
        self._dev("store_prefix", sid=sid, toks=toks, n=plen)
        return sid

    def _load_prefix(self, stored: int, lane: int) -> None:
        """Copy stored prefix KV ``stored`` into one lane's cache rows."""
        self._dev("load_prefix", sid=stored, lane=lane)

    def _fill_prefix_blocks(self, blocks: Sequence[int],
                            tokens: list) -> None:
        """Chunk-prefill ``tokens`` into ``blocks`` through a scratch
        table row (caller holds ``_sched_lock``)."""
        row = np.zeros((1, self._bpl), np.int64)
        row[0, :len(blocks)] = blocks
        self._chunked_prefill({"model": "target", "kv": "paged", "ref": row},
                              list(tokens), 0)

    def load_weights(self, params: dict) -> None:
        """Serve ``params`` from now on (a refreshed policy), prepared as
        at construction (quantized under ``quantize``) and copied into
        the tensors the engine holds: every decode tick's CUDA graph
        holds those tensors' addresses, so it replays on the new weights
        (a new tree would leave the graphs reading the old ones). Only an
        idle engine refreshes. Every registered prefix stays registered,
        with its pool blocks (or its dense store), its hit clock and the
        residency epoch as they were; its K/V is prefilled again in place
        under the new weights, as a registration would fill it now. That
        refill is no request's prefill: ``prefill_tokens_*`` do not count
        it. A tensor-parallel engine's followers repeat device steps only,
        so it refreshes by a restart."""
        if self._channel is not None:
            raise ValueError("a tensor-parallel engine cannot refresh its "
                             "weights in place: its followers hold theirs")
        with self._sched_lock:
            if self._active() or self._queue:
                raise RuntimeError("load_weights needs an idle engine: "
                                   "requests are in flight")
            load_into(self.params, init_mesh_serving(
                self.config, params, self.quantize, self.mesh, self.device))
            for p in self._prefixes:
                if self.kv_mode == "dense":
                    self._fill_prefix(list(p.key), sid=p.stored)
                elif p.blocks:
                    self._fill_prefix_blocks(
                        p.blocks, list(p.key[:len(p.blocks) * self.kv_block]))

    @property
    def prefix_count(self) -> int:
        return len(self._prefixes)

    def clear_prefixes(self) -> None:
        """Drop every stored prefix KV block (frees device memory /
        unpins pool blocks)."""
        with self._sched_lock:
            for p in self._prefixes:
                if p.blocks:
                    self._bpool.decref(p.blocks)
            self._prefixes = []
            self._prune_stored()
            self._prefix_hits = {}
            self.residency_epoch += 1

    def _record_prefix_hit(self, key: tuple) -> None:
        """Admission-time LRU bookkeeping (caller holds _sched_lock)."""
        self._prefix_hit_clock += 1
        self._prefix_hits[key] = self._prefix_hit_clock

    def _match_prefix(self, prompt: list, model: str = "",
                      record_hit: bool = True):
        """Dense-mode match: (stored KV, suffix start)."""
        for p in self._prefixes:
            if p.model == model and len(prompt) >= p.plen \
                    and tuple(prompt[:p.plen]) == p.key:
                if record_hit:
                    self._record_prefix_hit((p.model, p.key))
                # keep at least one suffix token so the prefill has a
                # position to read logits from (re-running the prefix's
                # last token overwrites its own slot with identical KV)
                return p.stored, min(p.plen, len(prompt) - 1)
        return None, 0

    def _match_prefix_blocks(self, prompt: list, model: str = "",
                             record_hit: bool = True):
        """Paged-mode match: (shareable block ids, suffix start). Shares
        only FULL blocks, clamped so at least one suffix token remains to
        prefill (start = n_shared * block <= len(prompt) - 1)."""
        for p in self._prefixes:
            if p.model == model and len(prompt) >= p.plen \
                    and tuple(prompt[:p.plen]) == p.key:
                if record_hit:
                    self._record_prefix_hit((p.model, p.key))
                n = min(len(p.blocks), (len(prompt) - 1) // self.kv_block)
                return list(p.blocks[:n]), n * self.kv_block
        return [], 0

    def prefix_residency(self, prompt: Sequence[int],
                         model: str = "") -> int:
        """Pool blocks a registered prefix would share with this prompt
        right now (0 = no resident prefix): a router's placement signal.
        Does NOT touch the LRU hit clock."""
        if self.kv_mode == "dense":
            return 0
        with self._sched_lock:
            shared, _ = self._match_prefix_blocks(list(prompt),
                                                  model=model or "",
                                                  record_hit=False)
        return len(shared)

    def has_prefix(self, tokens: Sequence[int], model: str = "") -> bool:
        """Whether exactly this (model, prefix) is registered."""
        key = tuple(tokens)
        model = model or ""
        with self._sched_lock:
            return any(p.key == key and p.model == model
                       for p in self._prefixes)

    def residency_snapshot(self) -> tuple:
        """One consistent ``(epoch, prefixes, resident_adapters,
        kv_block)`` view, where ``prefixes`` is the longest-first
        ``(model, key, n_blocks)`` list the match walks."""
        with self._sched_lock:
            return (self.residency_epoch,
                    tuple((p.model, p.key, len(p.blocks))
                          for p in self._prefixes),
                    (frozenset(self._adapters.resident_models())
                     if self._adapters is not None else frozenset()),
                    self.kv_block)

    # -- multi-model adapters ---------------------------------------------

    @property
    def multi_model(self) -> bool:
        return self._adapters is not None

    def load_adapter(self, model: str, pinned: bool = False) -> None:
        """Pin an adapter's weight pages resident ahead of traffic (the
        ``register_prefix`` analog for weights). At ``max_adapters`` the
        least-recently-hit unpinned adapter is evicted; an all-pinned
        catalog raises."""
        if self._adapters is None:
            raise ValueError("engine has no adapter catalog (pass "
                             "adapters= to enable multi-model serving)")
        with self._sched_lock:
            self._adapters.load(model, pinned=pinned)
            self.residency_epoch += 1

    def adapter_resident(self, model: str) -> bool:
        if self._adapters is None:
            return False
        with self._sched_lock:
            return self._adapters.is_resident(model)

    def adapter_status(self) -> dict:
        """Resident set + fault/eviction counters."""
        if self._adapters is None:
            return {}
        with self._sched_lock:
            return self._adapters.status()

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def health(self) -> dict:
        """An autoscaler's control inputs: free pool blocks, queue depth,
        lane occupancy, handoff and preemption counters — one consistent
        snapshot per lock."""
        with self._sched_lock:
            active = sum(1 for l in self._lane_state
                         if l.request is not None)
            parked = sum(1 for l in self._lane_state if l.parked)
            free = (self._bpool.free_count if self.kv_mode != "dense"
                    else None)
            adapters = None
            if self._adapters is not None:
                adapters = {
                    "resident_adapters": len(
                        self._adapters.resident_models()),
                    "adapter_pages": self._adapters.resident_pages(),
                    "adapter_faults": dict(self._adapters.faults),
                    "adapter_evictions": self._adapters.evictions,
                }
        out = {
            "queue_depth": self.queue_depth,
            "active_lanes": active,
            "parked_lanes": parked,
            "free_blocks": free,
            "lanes": self.lanes,
            "prefill_lanes": self.prefill_lanes,
            "handoffs": self.handoffs,
            "preempted": self.preempted,
        }
        if adapters is not None:
            # keys appear only on multi-model engines: single-model health
            # dicts stay as they were
            out.update(adapters)
        return out

    def validate(self, prompt: Sequence[int], max_new: int) -> None:
        """Raise ValueError if the request can never fit the cache —
        callers batching several submits should validate ALL of them
        first so a bad late request doesn't strand earlier ones."""
        plen = max(len(prompt), 1)
        if plen + max_new > self.max_len:
            raise ValueError(
                f"prompt {plen} + new {max_new} exceeds cache capacity "
                f"{self.max_len}")

    def submit(self, prompt: Sequence[int], max_new: int,
               logprobs: bool = False, temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               model: str = "") -> Request:
        """Enqueue one generation; returns a Request whose ``result()``
        blocks until finished. Thread-safe. ``temperature``/``top_k``/
        ``top_p`` override the engine's GenerateConfig for THIS request
        only (each lane samples with its own request's params). ``model``
        picks the adapter to decode under ("" / the catalog's base name =
        the base model), validated here in the caller's thread."""
        if self._channel is not None and not self._channel.leader:
            raise RuntimeError(
                f"rank {self._channel.rank} of a tensor-parallel engine "
                "follows rank 0: call follow()")
        self.validate(prompt, max_new)
        sampling = self.validate_sampling(temperature=temperature,
                                          top_k=top_k, top_p=top_p)
        model = self.validate_model(model)
        req = Request(prompt=list(prompt), max_new=max_new,
                      want_logprobs=logprobs, model=model, **sampling)
        if self.tracer.enabled:
            req.trace_id = self.tracer.new_trace_id()
            req._span_root = self.tracer.new_span_id()
            req._t_submit = req._t_queue = self.tracer.clock()
        if max_new <= 0:
            req._finish()          # nothing requested: empty output
            return req
        with self._cv:
            if self._stopped:
                raise RuntimeError("engine stopped")
            self._queue.append(req)
            self._cv.notify()
        return req

    def validate_model(self, model: Optional[str]) -> str:
        """Normalize + bounds-check a request's adapter id in the CALLER's
        thread (an unknown model 400s one request instead of reaching the
        scheduler loop). Returns "" for the base model."""
        if not model:
            return ""
        if self._adapters is None:
            raise ValueError(
                f"model {model!r} requested but this engine serves only "
                "its base model (no adapter catalog configured)")
        model = self._adapters.catalog.normalize(model)
        if model and model not in self._adapters.catalog:
            raise ValueError(f"unknown model {model!r}: not in the "
                             "adapter catalog")
        return model

    def validate_sampling(self, temperature=None, top_k=None,
                          top_p=None) -> dict:
        """Bounds-check per-request sampling overrides in the CALLER's
        thread (a bad value must 400 one request, never reach the
        scheduler loop, where a raise stops the engine and cancels every
        lane). Returns the normalized dict."""
        if temperature is not None:
            temperature = float(temperature)
            if not (0.0 <= temperature < 1e4):
                raise ValueError(f"temperature out of range: {temperature}")
        if top_k is not None:
            top_k = int(top_k)
            if not (0 <= top_k <= self.config.vocab_size):
                raise ValueError(
                    f"top_k out of range [0, {self.config.vocab_size}]: "
                    f"{top_k}")
        if top_p is not None:
            top_p = float(top_p)
            if not (0.0 < top_p <= 1.0):
                raise ValueError(f"top_p out of range (0, 1]: {top_p}")
        return {"temperature": temperature, "top_k": top_k, "top_p": top_p}

    def reseed(self, seed: int) -> None:
        """Rebase the sampling stream on ``seed``: identical submissions
        after an identical ``reseed`` sample identical token streams.
        Refused while the background loop runs (other clients share the
        stream)."""
        if self._thread is not None:
            raise ValueError(
                "cannot reseed a running engine (other clients share "
                "the sampling stream)")
        with self._sched_lock:
            self._rng = torch.Generator(device=self.device).manual_seed(seed)
            if self.spec_k:
                # the speculative accept rule draws from per-request host
                # rngs (seed + admission ordinal): rebase both
                self._seed = seed
                self._spec_admitted = 0

    def run(self, requests: Sequence[tuple],
            seed: Optional[int] = None) -> list:
        """requests: [(prompt_token_list, max_new_tokens), ...] in arrival
        order. Returns one generated-id list per request. Inline when no
        background loop is running; otherwise defers to it."""
        # validate everything up front: a bad late request must not strand
        # earlier ones in the queue
        for prompt, max_new in requests:
            self.validate(prompt, max_new)
        if seed is not None:
            self.reseed(seed)
        reqs = [self.submit(p, n) for p, n in requests]
        if self._thread is None:
            with self._sched_lock:
                try:
                    while self._step_once():
                        pass
                except BaseException:
                    # restore invariants and cancel in-flight requests so
                    # waiters unblock
                    self._recover_locked()
                    raise
        return [r.result() for r in reqs]

    def step(self) -> bool:
        """Run ONE inline scheduler tick: admit queue heads onto free
        lanes, then one decode round across all lanes. Returns True while
        there is work left. Mutually exclusive with the background loop
        (:meth:`start`); same abort-recovery contract as inline
        :meth:`run`."""
        if self._thread is not None:
            raise RuntimeError(
                "step() is an inline driver; stop() the background loop "
                "first")
        with self._sched_lock:
            try:
                return self._step_once()
            except BaseException:
                self._recover_locked()
                raise

    @torch.no_grad()
    def _recover_locked(self) -> None:
        """Restore the engine after a failed step: cancel every queued
        and in-flight request, reset the caches and the allocator, and
        re-prefill the registered prefixes. The JAX engine must rebuild
        its cache because donation consumed it; this one writes in place
        and keeps its tensors (a captured graph holds their addresses),
        zeroing them and dropping the graphs so the next tick captures
        anew. Caller holds ``_sched_lock``."""
        # the queue snapshot must hold _cv: submit() appends under _cv only
        with self._cv:
            abandoned = list(self._queue)
            self._queue.clear()
        for lane in self._lane_state:
            if lane.request is not None:
                abandoned.append(lane.request)
            lane.reset()
        for req in abandoned:
            req._finish(cancelled=True)
            self._trace_finish(req, status="error")
        self._dev("recover")
        if self.kv_mode in ("paged", "parity"):
            # rebuild the allocator, then re-pin + re-prefill every
            # registered prefix
            self._tables[:] = 0
            self._bpool = BlockPool(self.pool_blocks)
            entries = []
            for p in self._prefixes:
                blocks: tuple = ()
                if p.blocks:
                    # cannot fail: a fresh pool has at least as much room
                    # as when the prefix was first registered
                    blocks = tuple(self._bpool.alloc(len(p.blocks)))
                    self._fill_prefix_blocks(
                        blocks, list(p.key)[:len(blocks) * self.kv_block])
                entries.append(_Prefix(key=p.key, plen=p.plen,
                                       stored=p.stored, blocks=blocks,
                                       pinned=p.pinned, model=p.model))
            self._prefixes = entries
            if self._adapters is not None:
                # adapter pins lived in the old allocator too; re-pin them
                # into the fresh one (every lane incref died with its lane
                # above, so active counts restart)
                self._adapters.rebuild(self._bpool)
            self.residency_epoch += 1
        self._cur = np.zeros((self.lanes, 1), np.int64)
        self._pos = np.zeros((self.lanes,), np.int64)

    def start(self) -> "ContinuousBatchingEngine":
        """Run the scheduler on a background thread (HTTP serving mode).
        That thread then captures and replays the decode graphs. Under a
        mesh of more than one rank it posts a heartbeat while idle, every
        quarter of the group's timeout."""
        from .tp import TIMEOUT_S
        beat = (TIMEOUT_S / 4 if self._channel is not None
                and self._channel.world > 1 else None)

        def loop():
            while True:
                idle = False
                with self._cv:
                    while (not self._stopped and not self._queue
                           and not self._active()):
                        if not self._cv.wait(beat):
                            idle = True
                            break
                    if self._stopped:
                        return
                try:
                    if idle:
                        self._dev("noop")
                        continue
                    with self._sched_lock:
                        self._step_once()
                except Exception:  # noqa: BLE001 — a dead loop must not
                    # strand waiters: fail every request and stop accepting
                    logging.getLogger("kubedl_tpu_torch.serving").exception(
                        "batching scheduler failed; cancelling requests")
                    with self._cv:
                        self._stopped = True
                    self._cancel_all()
                    return

        self._thread = threading.Thread(target=loop, name="kubedl-batching",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the background loop; queued and in-flight requests are
        cancelled (their waiters unblock with a RuntimeError)."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._cancel_all()
        channel, self._channel = self._channel, None
        if channel is not None and channel.leader:
            # after a follower's exit the groups are aborted: nothing to post
            if self.launcher is None or not self.launcher.failed.is_set():
                try:
                    with self._op_lock:
                        channel.post("stop", {})
                except RuntimeError:
                    # a follower already gone: its watcher reports it
                    log.exception("could not post stop to the followers")
            channel.close()
        if self.launcher is not None:
            codes = self.launcher.close()
            self.launcher = None
            log.info("followers exited with codes %s", codes)

    def _cancel_all(self) -> None:
        with self._sched_lock:
            abandoned = list(self._queue)
            self._queue.clear()
            for i, lane in enumerate(self._lane_state):
                if lane.request is not None:
                    abandoned.append(lane.request)
                self._free_lane(i)
            for req in abandoned:
                req._finish(cancelled=True)
                # the root span must still land: failed requests are the
                # ones worth debugging
                self._trace_finish(req, status="error")

    def pool_stats(self) -> dict:
        """Pool occupancy + scheduler counters for /metrics. Dense mode
        reports only the mode (no pool exists). Takes the scheduler lock:
        allocator state mutates under it on the scheduler thread."""
        out = {"kv_mode": self.kv_mode, "peak_active": self.peak_active}
        if self.kv_mode == "dense":
            return out
        with self._sched_lock:
            bp = self._bpool
            out.update({
                "kv_block": self.kv_block,
                "blocks_total": bp.total,
                "blocks_free": bp.free_count,
                "blocks_used": bp.used_count,
                "blocks_shared": bp.shared_count,
                "blocks_pinned": sum(len(p.blocks)
                                     for p in self._prefixes),
                "block_allocs": bp.allocs,
                "preempted": self.preempted,
                "handoffs": self.handoffs,
                "prefill_tokens": self.prefill_tokens_total,
            })
            if self._adapters is not None:
                # multi-model only: single-model scrapes stay as they were
                out.update({
                    "adapter_pages": self._adapters.resident_pages(),
                    "adapter_peak_pages": self._adapters.peak_pages,
                    "adapter_faults": self._adapters.faults_total(),
                    "adapter_evictions": self._adapters.evictions,
                })
        return out

    # -- scheduler --------------------------------------------------------

    def _trace_finish(self, req: Request, status: str = "ok") -> None:
        """Record the request's decode span and its root span (the whole
        submit→finish window). No-op for untraced requests."""
        if not (self.tracer.enabled and req.trace_id and req._span_root):
            return
        now = self.tracer.clock()
        if req._t_decode:
            self.tracer.record(
                "request.decode", req._t_decode, now,
                trace_id=req.trace_id, parent_id=req._span_root,
                component="serving",
                attributes={"tokens": len(req.tokens)})
        self.tracer.record(
            "serving.request", req._t_submit, now,
            trace_id=req.trace_id, span_id=req._span_root,
            component="serving", status=status,
            attributes={"tokens": len(req.tokens),
                        "promptTokens": len(req.prompt),
                        "preemptions": req._preempts,
                        **({"model": req.model} if req.model else {}),
                        **({"error": req.error} if req.error else {})})
        req._span_root = ""   # finalized: never re-record this root

    def _active(self) -> bool:
        return any(l.request is not None for l in self._lane_state)

    # -- paged-pool bookkeeping (host side; caller holds _sched_lock) -----

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.kv_block)

    def _ensure_blocks(self, i: int, last_pos: int) -> bool:
        """Grow lane i's block table to cover a write at ``last_pos``.
        False when the pool is dry (caller preempts or waits)."""
        lane = self._lane_state[i]
        need = last_pos // self.kv_block + 1
        have = len(lane.blocks)
        if have >= need:
            return True
        got = self._bpool.alloc(need - have)
        if got is None:
            return False
        self._tables[i, have:need] = got
        lane.blocks.extend(got)
        return True

    def _free_lane(self, i: int) -> None:
        """Detach lane i's request and return its pool blocks (shared
        prefix blocks drop one refcount; private ones free). The lane's
        adapter weight-page share releases here too, and only here, so
        every finish/cancel/preempt path decrefs the adapter exactly
        once."""
        lane = self._lane_state[i]
        if lane.blocks:
            self._bpool.decref(lane.blocks)
            lane.blocks = []
            self._tables[i, :] = 0
        if lane.adapter_blocks:
            self._adapters.release(lane.adapter, lane.adapter_blocks)
            lane.adapter_blocks = []
        lane.adapter = ""
        lane.request = None
        lane.parked = False
        lane.parked_at = 0.0

    def _handoff(self, src: int, dst: int) -> None:
        """Move a freshly-prefilled request from prefill lane ``src`` to
        decode lane ``dst``: the block-table row, the cursor token, and
        the position move; the KV itself never does — the table entries
        reference the same shared-pool blocks. Caller holds
        ``_sched_lock``."""
        s, d = self._lane_state[src], self._lane_state[dst]
        req = s.request
        d.request, d.pos, d.remaining = req, s.pos, s.remaining
        d.blocks, s.blocks = s.blocks, []
        # the adapter refcount MOVES with the block-table row: the decode
        # lane inherits the prefill lane's weight-page share
        d.adapter, s.adapter = s.adapter, ""
        d.adapter_blocks, s.adapter_blocks = s.adapter_blocks, []
        d.parked = False
        self._tables[dst, :] = self._tables[src, :]
        self._tables[src, :] = 0
        self._cur[dst, 0] = self._cur[src, 0]
        self._pos[dst] = self._pos[src]
        s.request = None
        s.pos = 0
        s.remaining = 0
        s.parked = False
        self.handoffs += 1
        if self.tracer.enabled and req.trace_id:
            now = self.tracer.clock()
            self.tracer.record(
                "request.handoff", s.parked_at or now, now,
                trace_id=req.trace_id, parent_id=req._span_root,
                component="serving",
                attributes={"fromLane": src, "toLane": dst,
                            "blocks": len(d.blocks)})
            # decode starts on the decode lane, not at the prefill lane's
            # first-token emit
            req._t_decode = now
        s.parked_at = 0.0

    def _try_handoffs(self) -> None:
        """Hand each parked prefill lane's request to a free decode lane,
        FIFO over lane index. A cancelled request parked mid-handoff is
        freed here — its blocks decref exactly like a cancelled decode
        lane's."""
        for src in range(self.prefill_lanes):
            lane = self._lane_state[src]
            if not lane.parked:
                continue
            req = lane.request
            if req.cancel_requested:
                self._free_lane(src)
                req._finish()
                self._trace_finish(req)
                continue
            dst = next((j for j in range(self.prefill_lanes, self.lanes)
                        if self._lane_state[j].request is None), None)
            if dst is None:
                return           # every decode lane busy: wait parked
            self._handoff(src, dst)

    def _preempt_for_blocks(self) -> bool:
        """Pool ran dry mid-step: evict the lowest-progress active lane
        back to the queue HEAD (resumed later by re-prefilling prompt +
        generated-so-far). Returns False when nothing is evictable."""
        cands = [(len(l.request.tokens), i)
                 for i, l in enumerate(self._lane_state)
                 if l.request is not None]
        if not cands:
            return False
        _, victim = min(cands)
        req = self._lane_state[victim].request
        self._free_lane(victim)
        self.preempted += 1
        if self.tracer.enabled and req.trace_id:
            now = self.tracer.clock()
            if req._t_decode:
                self.tracer.record(
                    "request.decode", req._t_decode, now,
                    trace_id=req.trace_id, parent_id=req._span_root,
                    component="serving",
                    attributes={"tokens": len(req.tokens),
                                "preempted": True})
                req._t_decode = 0.0
            self.tracer.record(
                "request.preempted", now, now, trace_id=req.trace_id,
                parent_id=req._span_root, component="serving",
                attributes={"tokens": len(req.tokens)})
            req._t_queue = now
            req._preempts += 1
        with self._cv:
            self._queue.appendleft(req)
        return True

    def _grow_active(self, extra: int) -> None:
        """Ensure every active lane's table covers a write at
        ``pos + extra``, preempting lowest-progress lanes while the pool
        is dry. Parked lanes are skipped: they write nothing until their
        handoff lands."""
        for i, lane in enumerate(self._lane_state):
            while lane.request is not None and not lane.parked and \
                    not self._ensure_blocks(i, lane.pos + extra):
                if not self._preempt_for_blocks():
                    break

    def _assert_parity(self, dense_logits, paged_logits, what: str,
                       rows: Optional[list] = None) -> None:
        """Parity mode's contract: on every ACTIVE lane the paged path's
        logits pick the same tokens as the dense path's (and track them
        numerically). Dead-lane rows are garbage in both layouts."""
        act = rows if rows is not None else \
            [i for i, l in enumerate(self._lane_state)
             if l.request is not None]
        if not act:
            return
        ld = _host(dense_logits)[act]
        lp = _host(paged_logits)[act]
        if not np.array_equal(ld.argmax(-1), lp.argmax(-1)) or \
                not np.allclose(ld, lp, rtol=1e-4, atol=1e-5):
            raise AssertionError(
                f"KV parity violation in {what}: dense and paged logits "
                f"diverge (max abs diff {np.abs(ld - lp).max():.3e})")

    def _lane_sampling(self, req: Request):
        """(temperature, top_k, top_p) for a request — per-request
        overrides over the engine GenerateConfig."""
        gen = self.gen
        t = gen.temperature if req.temperature is None else req.temperature
        k_ = gen.top_k if req.top_k is None else req.top_k
        p_ = gen.top_p if req.top_p is None else req.top_p
        return t, k_, p_

    def _spec_round_k(self) -> int:
        """Draft lookahead this round: spec_k clamped so every ACTIVE
        lane's [k+1] verify chunk (and the draft backfill at pos+k) stays
        inside the cache."""
        space = min(self.max_len - 1 - l.pos
                    for l in self._lane_state if l.request is not None)
        return min(self.spec_k, space)

    def _spec_verify(self, chunk, pos):
        """The target's [lanes, k+1] pass at per-row positions (eager):
        all-position logits on the device."""
        if self.kv_mode == "dense":
            return self._dev("verify", kv="dense", chunk=chunk, pos=pos)
        logits_p = self._dev("verify", kv="paged", chunk=chunk, pos=pos,
                             tables=self._tables.copy())
        if self.kv_mode == "parity":
            logits = self._dev("verify", kv="dense", chunk=chunk, pos=pos)
            self._assert_parity(logits, logits_p, "spec_verify")
            return logits
        return logits_p

    def _spec_round(self, k: int) -> Optional[tuple]:
        """One speculative round for EVERY lane: k draft proposals each
        (k batched [lanes, 1] draft ticks), one [lanes, k+1] target
        verify, per-lane acceptance — greedy prefix-match for greedy
        lanes (output token-identical to the non-speculative engine), the
        ``spec_accept`` rule for sampled lanes. Rejected slots stay
        causally invisible until overwritten. With tracing on, returns
        the round's phases for :meth:`_trace_step`."""
        gen = self.gen
        lanes_n = self.lanes
        tracing = self.tracer.enabled
        if tracing:
            t_tick = self.tracer.clock()
            live, context = self._live_context()
        active = np.asarray([l.request is not None
                             for l in self._lane_state])
        # dead lanes still compute but their writes must stay in range:
        # park them at position 0 — those slots are fully rewritten by
        # the next admission's prefill
        pos = np.where(active, self._pos, 0).astype(np.int64)
        cur = self._cur.copy()
        sampled = [l.request is not None
                   and self._lane_sampling(l.request)[0] > 0.0
                   for l in self._lane_state]
        drafts = np.zeros((lanes_n, k), np.int64)
        dprobs = [[None] * k for _ in range(lanes_n)]
        dcur = cur.copy()
        for j in range(k):
            dl = _host(self._d_decode(dcur, pos + j))
            greedy_next = dl.argmax(-1)
            for i, lane in enumerate(self._lane_state):
                if sampled[i]:
                    t, tk, tp = self._lane_sampling(lane.request)
                    p = filtered_probs(dl[i], t, tk, tp)
                    drafts[i, j] = int(
                        lane.request._spec_rng.choice(len(p), p=p))
                    dprobs[i][j] = p
                else:
                    drafts[i, j] = int(greedy_next[i])
            dcur[:, 0] = drafts[:, j]
        chunk = np.concatenate([cur, drafts], axis=1)
        verified = self._spec_verify(chunk, pos)
        if tracing:
            t_ret = self.tracer.clock()
        tl = _host(verified)                            # [lanes, k+1, V]
        if tracing:
            t_host = self.tracer.clock()
        # draft backfill: the k-th proposal's KV never entered the draft
        # cache; one batched tick ingests it at pos+k for every lane —
        # lanes that accepted less overwrite that slot before it is ever
        # attendable
        self._d_decode(drafts[:, k - 1:k], pos + k)
        for i, lane in enumerate(self._lane_state):
            req = lane.request
            if req is None:
                continue
            if req.cancel_requested:
                self._free_lane(i)
                req._finish()
                self._trace_finish(req)
                continue
            if sampled[i]:
                t, tk, tp = self._lane_sampling(req)
                tpro = [filtered_probs(tl[i, j], t, tk, tp)
                        for j in range(k + 1)]
                accepted, nxt = spec_accept(drafts[i], dprobs[i], tpro,
                                            req._spec_rng)
            else:
                targets = tl[i].argmax(-1)          # [k+1]
                accepted = 0
                while accepted < k and \
                        drafts[i, accepted] == targets[accepted]:
                    accepted += 1
                nxt = int(targets[accepted])
            emitted = [int(x) for x in drafts[i, :accepted]] + [int(nxt)]
            lp_rows = None
            if req.want_logprobs:
                # full-softmax log p of each emitted token under the verify
                # logits of ITS slot
                row = tl[i, :len(emitted)]
                row = row - row.max(-1, keepdims=True)
                lp_all = row - np.log(np.exp(row).sum(-1, keepdims=True))
                lp_rows = [float(lp_all[j, emitted[j]])
                           for j in range(len(emitted))]
            finished = False
            pushed = 0
            for j, tok in enumerate(emitted):
                req._push(tok, lp_rows[j] if lp_rows else None)
                pushed += 1
                lane.pos += 1
                lane.remaining -= 1
                if (lane.remaining <= 0 or hit_stop(req.tokens, gen)
                        or lane.pos + 1 >= self.max_len):
                    finished = True
                    break
            # acceptance accounting clamped to tokens actually EMITTED: a
            # lane stopping mid-chunk counts only the drafts that reached
            # the client; past the bonus token all k drafts count
            acc_inc = min(pushed, accepted)
            prop_inc = k if pushed > accepted else pushed
            self.stats.proposed += prop_inc
            self.stats.accepted += acc_inc
            self.lane_stats[i].proposed += prop_inc
            self.lane_stats[i].accepted += acc_inc
            self._cur[i, 0] = req.tokens[-1]
            self._pos[i] = lane.pos
            if finished:
                self._free_lane(i)
                req._finish()
                self._trace_finish(req)
        return (t_tick, t_ret, t_host, None, live, context) if tracing \
            else None

    def _prefill_dense(self, lane_idx: int, seq: list, start: int):
        """Chunked dense-slab prefill of ``seq[start:]`` into one lane."""
        return self._chunked_prefill(
            {"model": "target", "kv": "dense", "ref": lane_idx}, seq, start)

    def _prefill_paged(self, lane_idx: int, seq: list, start: int):
        """Chunked paged prefill of ``seq[start:]`` through lane
        ``lane_idx``'s block table (grown by the caller)."""
        return self._chunked_prefill(
            {"model": "target", "kv": "paged",
             "ref": self._tables[lane_idx:lane_idx + 1].copy()}, seq, start)

    def _admit(self, lane_idx: int) -> bool:
        """Admit the queue head onto free lane ``lane_idx``. Returns False
        when admission must stop this tick: queue empty, or (paged modes)
        the head needs more free blocks than the pool has — FCFS, the head
        is never skipped. A head that can NEVER be admitted (pool too
        small after prefix pins, nothing running to preempt) is failed
        with a descriptive error instead of wedging the queue."""
        gen = self.gen
        with self._cv:
            while self._queue and self._queue[0].cancel_requested:
                # cancelled while queued: never pay the prefill
                r = self._queue.popleft()
                r._finish()
                self._trace_finish(r)
            if not self._queue:
                return False
            req = self._queue[0]
            shared, start_p = [], 0
            if self.kv_mode != "dense":
                if req.model and self._adapters is not None:
                    # the adapter must be resident BEFORE the request's
                    # first tick: a cold one faults its weight pages in
                    # through the pool here (counted per model), ahead of
                    # the KV watermark so the check below sees them taken
                    v0 = self._adapters.version
                    pages, faulted = self._adapters.ensure(req.model)
                    if self._adapters.version != v0:
                        # a fault-in or evictions on the way: the resident
                        # set moved
                        self.residency_epoch += 1
                    if faulted:
                        self.adapter_fault_pages_step += len(pages)
                    if pages is None:
                        if not self._active():
                            # nothing running will ever free pages: the
                            # adapter can never fit
                            self._queue.popleft()
                            spec = self._adapters.catalog.spec(req.model)
                            req.error = (
                                f"adapter {req.model} needs {spec.pages} "
                                f"weight pages but only "
                                f"{self._bpool.free_count} blocks are free "
                                f"and no unpinned adapter is evictable "
                                f"(pool {self.pool_blocks})")
                            req._finish(cancelled=True)
                            self._trace_finish(req, status="error")
                            return True
                        return False
                # admission watermark: the prompt's private blocks plus
                # headroom must be free, or the head waits
                seq = (req.prompt or [0]) + req.tokens
                shared, start_p = self._match_prefix_blocks(
                    seq, model=req.model)
                need = self._blocks_for(len(seq)) - len(shared)
                free = self._bpool.free_count
                if not self._active():
                    # nothing running: nothing will ever free blocks (only
                    # prefix pins hold them) — the request either fits its
                    # WHOLE generation now or never will
                    total = self._blocks_for(min(
                        len(seq) + req.max_new - len(req.tokens),
                        self.max_len)) - len(shared)
                    if total > free:
                        self._queue.popleft()
                        req.error = (
                            f"request needs {total} free KV blocks but "
                            f"only {free} are free (pool "
                            f"{self.pool_blocks}, "
                            f"{sum(len(p.blocks) for p in self._prefixes)}"
                            " pinned by prefixes)")
                        req._finish(cancelled=True)
                        self._trace_finish(req, status="error")
                        return True
                elif free < need + self.headroom_blocks:
                    return False
            self._queue.popleft()
        t_admit = (self.tracer.clock()
                   if self.tracer.enabled and req.trace_id else 0.0)
        # attach BEFORE the prefill work: a failure mid-prefill must leave
        # the request visible to _recover_locked
        lane = self._lane_state[lane_idx]
        lane.request = req
        self.admitted_step += 1
        if req.model and self._adapters is not None:
            # bind the lane to the (now resident) adapter: incref its
            # weight pages for the life of the lane. The residency gate
            # ran under the same _sched_lock hold, so nothing evicted it
            lane.adapter = req.model
            lane.adapter_blocks = self._adapters.attach(req.model)
        # resume-aware: a preempted request re-prefills prompt PLUS the
        # tokens it already streamed, then continues its budget
        prior = len(req.tokens)
        seq = (req.prompt or [0]) + req.tokens
        plen = len(seq)
        logits = None
        prefill_from = 0      # first position actually prefilled (traces)
        if self.kv_mode in ("dense", "parity"):
            if self.kv_mode == "dense":
                stored, start = self._match_prefix(seq, model=req.model)
                prefill_from = start
                if stored is not None:
                    self._load_prefix(stored, lane_idx)
            else:
                # parity's dense shadow prefills from 0: prefix KV lives
                # only in the pool there
                start = 0
            logits = self._prefill_dense(lane_idx, seq, start)
        if self.kv_mode in ("paged", "parity"):
            if shared:
                self._bpool.incref(shared)
                lane.blocks = list(shared)
                self._tables[lane_idx, :len(shared)] = shared
            # the admission gate reserved capacity under the same
            # scheduler lock, so this cannot fail
            self._ensure_blocks(lane_idx, plen - 1)
            prefill_from = start_p
            logits_p = self._prefill_paged(lane_idx, seq, start_p)
            if self.kv_mode == "parity":
                self._assert_parity(logits, logits_p, "prefill", rows=[0])
            else:
                logits = logits_p
        self.prefill_tokens_step += plen - prefill_from
        self.prefill_tokens_total += plen - prefill_from
        t, k_, p_ = self._lane_sampling(req)
        if t <= 0.0:
            first = int(sample_logits(logits, self._rng, 0.0, 0)[0])
        else:
            dev = self.device
            first = int(sample_logits_many(
                logits, self._rng, torch.tensor([t], device=dev),
                torch.tensor([k_], device=dev),
                torch.tensor([p_], device=dev))[0])
        req._push(first, float(token_logprobs(
            logits, torch.tensor([first], device=self.device))[0])
            if req.want_logprobs else None)
        lane.pos = plen
        lane.remaining = req.max_new - prior - 1
        self._cur[lane_idx, 0] = first
        self._pos[lane_idx] = plen
        if self.tracer.enabled and req.trace_id:
            now_t = self.tracer.clock()
            self.tracer.record(
                "request.queue", req._t_queue, t_admit,
                trace_id=req.trace_id, parent_id=req._span_root,
                component="serving",
                attributes={"resumed": prior > 0, "lane": lane_idx})
            self.tracer.record(
                "request.prefill", t_admit, now_t,
                trace_id=req.trace_id, parent_id=req._span_root,
                component="serving",
                attributes={"tokens": plen - prefill_from,
                            "lane": lane_idx,
                            "sharedBlocks": len(shared),
                            **({"model": req.model} if req.model
                               else {})})
            req._t_decode = now_t
        if lane.remaining <= 0 or hit_stop(req.tokens, gen):
            self._free_lane(lane_idx)    # finished in prefill
            req._finish()
            self._trace_finish(req)
        elif self.spec_k:
            # the draft prefills the FULL sequence into ITS lane (prefix KV
            # blocks are target-model state)
            self._chunked_prefill(
                {"model": "draft", "kv": "dense", "ref": lane_idx}, seq, 0)
            # per-request host rng drives the sampled accept rule; a
            # RESUMED request keeps its rng
            if req._spec_rng is None:
                req._spec_rng = np.random.default_rng(
                    self._seed + 1000003 * self._spec_admitted)
                self._spec_admitted += 1
        return True

    @torch.no_grad()
    def _step_once(self) -> bool:
        """Fill free lanes, run one decode tick (or a speculative round
        when a draft model is configured). Returns False once idle.

        Disaggregated mode (``prefill_lanes`` > 0): handoffs land first,
        admissions target prefill lanes only, and a just-prefilled request
        parks for handoff — so a long prompt's chunked prefill never
        occupies a decode lane."""
        gen = self.gen
        tracing = self.tracer.enabled
        t_step = self.tracer.clock() if tracing else 0.0
        self.prefill_tokens_step = 0
        self.admitted_step = 0
        self.adapter_fault_pages_step = 0
        stalled = False
        if self.prefill_lanes:
            self._try_handoffs()
            for i in range(self.prefill_lanes):
                lane = self._lane_state[i]
                while self._queue and lane.request is None:
                    if not self._admit(i):
                        # FCFS: the head waits on pool capacity — every
                        # other free lane would stall on it too
                        stalled = True
                        break
                    if lane.request is not None:
                        # prefilled, first token emitted: park for the
                        # block-table handoff (an immediately-free decode
                        # lane takes it now)
                        lane.parked = True
                        if self.tracer.enabled and lane.request.trace_id:
                            lane.parked_at = self.tracer.clock()
                        self._try_handoffs()
                if stalled or not self._queue:
                    break
        else:
            for i, lane in enumerate(self._lane_state):
                while self._queue and lane.request is None:
                    if not self._admit(i):
                        stalled = True
                        break
                if stalled or not self._queue:
                    break
        self.peak_active = max(self.peak_active, sum(
            1 for l in self._lane_state if l.request is not None))
        if not self._active():
            return bool(self._queue)
        if self.prefill_lanes and not any(
                l.request is not None and not l.parked
                for l in self._lane_state):
            # only parked work left: nothing may decode this tick (the
            # parked KV must not move before its handoff)
            return True
        if self.spec_k:
            k = self._spec_round_k()
            if k >= 1:
                if self.kv_mode != "dense":
                    # the verify chunk writes pos..pos+k; grow (and
                    # preempt if dry) BEFORE the device round
                    self._grow_active(k)
                    if not self._active():
                        return bool(self._queue)
                phases = self._spec_round(k)
                if phases is not None:
                    self._trace_step(t_step, *phases)
                return True
            # near the cache cap a verify chunk no longer fits: finish
            # with plain single-token ticks
        if self.kv_mode != "dense":
            self._grow_active(0)
            if not self._active():
                return bool(self._queue)
        if tracing:
            t_tick = self.tracer.clock()
            lanes, context = self._live_context()
        # one decode tick for every lane (dead lanes compute garbage).
        # Parked prefill lanes are masked to the garbage sink: their
        # tables hold LIVE blocks awaiting handoff
        parked_rows = ([i for i, l in enumerate(self._lane_state)
                        if l.parked] if self.prefill_lanes else [])
        pos_np = self._pos
        tbl_np = self._tables if self.kv_mode != "dense" else None
        if parked_rows:
            pos_np = self._pos.copy()
            pos_np[parked_rows] = 0
            tbl_np = self._tables.copy()
            tbl_np[parked_rows, :] = 0
        if self.kv_mode == "dense":
            logits = self._decode(self._cur, pos_np)
        elif self.kv_mode == "paged":
            logits = self._decode_p(self._cur, pos_np, tbl_np)
        else:
            logits = self._decode(self._cur, pos_np)
            logits_p = self._decode_p(self._cur, pos_np, tbl_np)
            self._assert_parity(logits, logits_p, "decode")
        if self.spec_k:
            # near-cap ticks keep the DRAFT cache in lockstep (it ingests
            # the same token at the same position the target just did)
            self._d_decode(self._cur, self._pos)
        if tracing:
            t_ret = self.tracer.clock()

        def lane_param(attr, default):
            return [getattr(l.request, attr)
                    if l.request is not None and
                    getattr(l.request, attr) is not None else default
                    for l in self._lane_state]

        temps = lane_param("temperature", gen.temperature)
        active_temps = [t for t, l in zip(temps, self._lane_state)
                        if l.request is not None]
        if all(t <= 0.0 for t in active_temps):
            # all-greedy tick (the default deployment): one argmax
            nxt_t = sample_logits(logits, self._rng, 0.0, 0)
        else:
            dev = self.device
            nxt_t = sample_logits_many(
                logits, self._rng, torch.tensor(temps, device=dev),
                torch.tensor(lane_param("top_k", gen.top_k), device=dev),
                torch.tensor(lane_param("top_p", gen.top_p), device=dev))
        nxt = nxt_t.cpu().numpy()
        lane_lps = None
        if any(l.request is not None and l.request.want_logprobs
               for l in self._lane_state):
            lane_lps = token_logprobs(logits, nxt_t).cpu().numpy()
        if tracing:
            t_host = self.tracer.clock()
        for i, lane in enumerate(self._lane_state):
            req = lane.request
            if req is None or lane.parked:
                continue                 # parked: awaiting handoff
            tok = int(nxt[i])
            req._push(tok, float(lane_lps[i]) if req.want_logprobs else None)
            lane.pos += 1
            lane.remaining -= 1
            self._cur[i, 0] = tok
            self._pos[i] = lane.pos
            if (req.cancel_requested or lane.remaining <= 0
                    or hit_stop(req.tokens, gen)
                    or lane.pos + 1 >= self.max_len):
                self._free_lane(i)   # lane freed for the next arrival
                req._finish()
                self._trace_finish(req)
        if tracing:
            self._trace_step(t_step, t_tick, t_ret, t_host,
                             self._tick if self.kv_mode == "dense"
                             else self._tick_p, lanes, context)
        return True

    def _live_context(self) -> tuple:
        """(live lanes that are not parked, the sum over them of the
        positions their next tick attends, the new one included)."""
        ctx = [lane.pos + 1 for lane in self._lane_state
               if lane.request is not None and not lane.parked]
        return len(ctx), sum(ctx)

    def _trace_step(self, t_step: float, t_tick: float, t_ret: float,
                    t_host: float, tick, lanes: int, context: int) -> None:
        """Record one decode step on the engine's trace (tracing on):
        ``engine.step`` from the step's start to now, the parent of
        ``engine.tick`` (packing the inputs to the tick's return) and
        ``engine.sample`` (to the sampled tokens on the host). ``tick``
        is the :class:`DecodeTick` that ran, which gives ``launch`` (its
        ordinal on its route) and ``launch_at``; None for a speculative
        round, whose tick is the draft ticks and the verify pass."""
        tracer, tid = self.tracer, self._trace_id
        step_id = tracer.new_span_id()
        self._steps_traced += 1
        attrs = {"lanes": lanes, "context": context}
        if tick is not None:
            attrs.update(launch=tick.launches[tick.route],
                         launch_at=tick.launch_at)
        tracer.record("engine.tick", t_tick, t_ret, trace_id=tid,
                      parent_id=step_id, component="serving",
                      attributes=attrs)
        tracer.record("engine.sample", t_ret, t_host, trace_id=tid,
                      parent_id=step_id, component="serving")
        tracer.record("engine.step", t_step, tracer.clock(), trace_id=tid,
                      span_id=step_id, component="serving",
                      attributes={"step": self._steps_traced,
                                  "admitted": self.admitted_step,
                                  "prefill_tokens": self.prefill_tokens_step})


def _host(logits) -> np.ndarray:
    """Device logits -> float32 numpy (one copy to the host)."""
    return logits.float().cpu().numpy()

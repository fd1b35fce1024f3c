"""Multi-model serving: LoRA adapter catalog + paged weight residency.

The port's own copy of ``kubedl_tpu/serving/adapters.py`` (framework-free,
so copied, never imported). A production fleet serves many fine-tuned
variants of one base model, not one model per replica. The scarce
resource is the replica's device memory, and the policy question is
which adapters stay resident where. This module answers it with the SAME
machinery the KV cache already uses:

* an :class:`AdapterCatalog` — the fleet-wide registry of adapters
  (pure specs: model id + how many pool pages its LoRA weights occupy);
* an :class:`AdapterResidency` per engine — adapter weight pages
  allocate from the engine's refcounted
  :class:`~kubedl_tpu_torch.serving.batching.BlockPool`, exactly like KV
  blocks: a load PINS the pages (refcount 1), every admitted request
  increfs them for the life of its lane, and an eviction decrefs only
  the pin — in-flight requests finish on the departing adapter and the
  pages return to the pool when the last lane drains (the
  ``register_prefix`` eviction contract, applied to weights).

Eviction follows the prefix cache's hardened rules verbatim: at
``max_resident`` the LEAST-RECENTLY-HIT unpinned adapter is evicted;
``pinned=`` adapters are exempt; only an all-pinned catalog still
rejects. The LoRA math itself lives in :mod:`kubedl_tpu_torch.ops.lora`
(``mm_lora``); residency is host-side accounting — greedy token
outputs are identical across adapters by construction, as in the JAX
package.

Everything here mutates under the owning engine's ``_sched_lock`` (the
engine calls in from admission / free / recover paths); the catalog
itself is immutable-after-setup shared state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class AdapterSpec:
    """One adapter's fleet-wide description (a pure value).

    ``pages`` is how many pool blocks the adapter's LoRA weights pin
    while resident — the HBM currency shared with KV blocks. ``rank``
    is the LoRA rank (``ops/lora.py``); it drives ``pages`` for real
    weights but is carried only for reporting here."""
    model: str
    pages: int = 1
    rank: int = 8

    def __post_init__(self):
        if not self.model:
            raise ValueError("adapter model id must be non-empty")
        if self.pages < 1:
            raise ValueError(
                f"adapter {self.model}: pages must be >= 1, got "
                f"{self.pages}")


class AdapterCatalog:
    """Fleet-wide adapter registry.

    One catalog is shared by every replica's engine (read-only after
    setup, like the base params); each engine keeps its OWN
    :class:`AdapterResidency` — which adapters are resident is a
    per-replica decision the router exploits (docs/multimodel.md
    "router homing")."""

    def __init__(self, base_model: str = "base"):
        #: the base model's id; requests carrying it (or no model at
        #: all) need no adapter — the pre-multi-model path, unchanged
        self.base_model = base_model
        self._specs: dict[str, AdapterSpec] = {}

    def register(self, spec: AdapterSpec) -> AdapterSpec:
        if spec.model == self.base_model:
            raise ValueError(
                f"{spec.model!r} is the base model, not an adapter")
        self._specs[spec.model] = spec
        return spec

    def spec(self, model: str) -> Optional[AdapterSpec]:
        return self._specs.get(model)

    def models(self) -> list:
        return sorted(self._specs)

    def normalize(self, model: Optional[str]) -> str:
        """Canonical model id: "" for the base model (however named)."""
        if not model or model == self.base_model:
            return ""
        return model

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, model: str) -> bool:
        return model in self._specs


@dataclass
class _Resident:
    """One adapter resident on one engine: its pinned pool pages and
    how many in-flight requests currently hold increfs on them."""
    spec: AdapterSpec
    pages: tuple = ()
    pinned: bool = False
    active: int = 0


class AdapterResidency:
    """Per-engine adapter residency over the engine's block pool.

    Every method is called with the engine's ``_sched_lock`` held (the
    same discipline as the prefix cache — admission, frees, and
    recovery already run under it), so there is no lock here."""

    def __init__(self, catalog: AdapterCatalog, pool,
                 max_resident: Optional[int] = None):
        self.catalog = catalog
        self._pool = pool
        #: resident-adapter count cap (None = bounded by the pool only);
        #: the multi-model analog of ``max_prefixes``
        self.max_resident = max_resident
        self._resident: dict[str, _Resident] = {}
        #: admission-time hit ordinals — the least-recently-hit order
        #: evictions follow (the ``register_prefix`` LRU, verbatim)
        self._hits: dict[str, int] = {}
        self._hit_clock = 0
        #: lifetime cold fault-ins per model (the router-quality signal
        #: kubedl_serving_adapter_faults_total exposes)
        self.faults: dict[str, int] = {}
        self.evictions = 0
        self.loads = 0
        #: bumped on EVERY residency change (load, fault-in, eviction,
        #: rebuild) — the engine mirrors it into ``residency_epoch`` so
        #: the router's cached snapshots invalidate precisely, even
        #: when an eviction happened without a successful fault
        self.version = 0
        #: most pool blocks ever pinned by adapter weights at once (the
        #: bench's HBM-budget number)
        self.peak_pages = 0

    # -- reads -------------------------------------------------------------

    def is_resident(self, model: str) -> bool:
        return model in self._resident

    def resident_models(self) -> list:
        return sorted(self._resident)

    def resident_pages(self) -> int:
        return sum(len(r.pages) for r in self._resident.values())

    def faults_total(self) -> int:
        return sum(self.faults.values())

    def active_of(self, model: str) -> int:
        r = self._resident.get(model)
        return r.active if r is not None else 0

    def status(self) -> dict:
        """Console/pool_stats snapshot (caller holds the engine lock)."""
        return {
            "resident": self.resident_models(),
            "pinned": sorted(m for m, r in self._resident.items()
                             if r.pinned),
            "pages": self.resident_pages(),
            "peak_pages": self.peak_pages,
            "active": {m: r.active for m, r in
                       sorted(self._resident.items()) if r.active},
            "faults": dict(sorted(self.faults.items())),
            "evictions": self.evictions,
            "loads": self.loads,
        }

    # -- residency mutations (engine lock held) ----------------------------

    def _record_hit(self, model: str) -> None:
        self._hit_clock += 1
        self._hits[model] = self._hit_clock

    def _evict_lru(self) -> bool:
        """Evict the least-recently-hit unpinned adapter: the PIN's
        refcount drops; lanes still decoding on it keep the pages alive
        until they finish (refcounts drain to zero — the prefix
        contract). False when every resident adapter is pinned."""
        victims = [m for m, r in self._resident.items() if not r.pinned]
        if not victims:
            return False
        victim = min(victims, key=lambda m: (self._hits.get(m, 0), m))
        ent = self._resident.pop(victim)
        if ent.pages:
            self._pool.decref(ent.pages)
        self._hits.pop(victim, None)
        self.evictions += 1
        self.version += 1
        return True

    def _make_room(self, pages_needed: int) -> Optional[list]:
        """Allocate ``pages_needed`` pin pages, evicting LRU unpinned
        adapters while the cap or the pool blocks the allocation.
        None when no legal eviction can make it fit (the caller
        decides: admission waits, an explicit load raises)."""
        while self.max_resident is not None and \
                len(self._resident) >= self.max_resident:
            if not self._evict_lru():
                raise ValueError(
                    f"adapter limit {self.max_resident} reached and "
                    "every resident adapter is pinned (each adapter "
                    "pins weight pages in HBM)")
        while True:
            got = self._pool.alloc(pages_needed)
            if got is not None:
                return got
            # pool dry: shed idle unpinned adapters (their pages free
            # immediately — nothing increfs an idle pin) until it fits
            if not self._evict_lru():
                return None

    def load(self, model: str, pinned: bool = False) -> None:
        """Explicit operator load (the ``register_prefix`` analog):
        pins the adapter's pages; idempotent re-load refreshes the
        pin flag and the hit clock without net-new pages."""
        spec = self.catalog.spec(model)
        if spec is None:
            raise ValueError(f"unknown adapter {model!r} (not in the "
                             "catalog)")
        ent = self._resident.get(model)
        if ent is not None:
            ent.pinned = bool(pinned)
            self._record_hit(model)
            return
        got = self._make_room(spec.pages)
        if got is None:
            raise ValueError(
                f"KV pool exhausted: adapter {model} needs {spec.pages} "
                f"weight pages, {self._pool.free_count} free")
        self._resident[model] = _Resident(spec=spec, pages=tuple(got),
                                          pinned=bool(pinned))
        self._record_hit(model)
        self.loads += 1
        self.version += 1
        self.peak_pages = max(self.peak_pages, self.resident_pages())

    def ensure(self, model: str):
        """Admission-side residency: ``(pages, faulted)`` with the
        adapter resident on return, or ``(None, False)`` when no legal
        eviction can make room (the admission gate treats that like a
        dry pool: the head waits). A cold adapter FAULTS IN here —
        counted per model — before the request's first tick."""
        ent = self._resident.get(model)
        if ent is not None:
            return ent.pages, False
        spec = self.catalog.spec(model)
        if spec is None:
            raise ValueError(f"unknown adapter {model!r} (not in the "
                             "catalog)")
        got = self._make_room(spec.pages)
        if got is None:
            return None, False
        self._resident[model] = _Resident(spec=spec, pages=tuple(got))
        # seed the hit clock at fault-in (the prefix cache's rule):
        # a just-faulted adapter must rank by fault recency, never tie
        # at 0 where churn could evict it before its request attaches
        self._record_hit(model)
        self.faults[model] = self.faults.get(model, 0) + 1
        self.loads += 1
        self.version += 1
        self.peak_pages = max(self.peak_pages, self.resident_pages())
        return self._resident[model].pages, True

    def attach(self, model: str) -> list:
        """Bind one admitted request to the resident adapter: incref
        the weight pages (the lane's share) and count it active. The
        caller stores the returned blocks on the lane and hands them
        back through :meth:`release` exactly once."""
        ent = self._resident[model]
        self._pool.incref(ent.pages)
        ent.active += 1
        self._record_hit(model)
        return list(ent.pages)

    def release(self, model: str, blocks) -> None:
        """Drop one request's share of the adapter pages (lane
        finished / cancelled / preempted). Safe after the adapter was
        evicted mid-flight: the blocks list is the lane's own incref,
        and the active count only tracks still-resident entries."""
        if blocks:
            self._pool.decref(blocks)
        ent = self._resident.get(model)
        if ent is not None and ent.active > 0:
            ent.active -= 1

    def rebuild(self, pool) -> None:
        """Re-pin every resident adapter into a FRESH pool after the
        engine recovered from a failed step (the ``_recover_locked``
        path: the old pool was donated into the dead computation, and
        every lane incref died with it — active counts restart at 0).
        Cannot fail: the fresh pool has at least as much room as when
        the adapters first loaded."""
        self._pool = pool
        for ent in self._resident.values():
            ent.pages = tuple(pool.alloc(len(ent.pages) or
                                         ent.spec.pages))
            ent.active = 0
        self.version += 1


__all__ = ["AdapterSpec", "AdapterCatalog", "AdapterResidency"]

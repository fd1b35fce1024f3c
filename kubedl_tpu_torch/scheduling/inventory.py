"""Slice inventory: TPU capacity and admitted-gang usage per node pool.

The scheduler's ground truth about the cluster, kept with the same index
discipline as the API server's read path (docs/control-plane-perf.md):
state is maintained *incrementally* from watch events — Node events move
pool capacity, PodGroup events move the held set — so a scheduling pass
never lists the world. A from-scratch :meth:`rescan` exists for two jobs:
the parity check that keeps the incremental bookkeeping honest (the
``KUBEDL_LIST_MODE=parity`` analog) and the periodic :meth:`resync` that
reconverges the inventory after dropped watch events (chaos / real
informer relists).

A **pool** is one ``(gke-accelerator, topology)`` node-pool shape, keyed
``"tpu-v5p-slice/2x2x4"``. Capacity is denominated in slices: each Node
carrying the GKE TPU labels contributes one host; ``hosts //
hosts_per_slice`` whole slices are schedulable (``tpu/topology.py`` owns
the host math). Usage is one slice per *admitted* PodGroup (the gang layer
already guarantees one PodGroup per slice). A pool with no Nodes and no
static capacity entry has **unknown** capacity and is treated as
unlimited — the scheduler then only enforces queue quota, which is what
lets the subsystem run against control planes that don't model Nodes.

Copied from ``kubedl_tpu/scheduling/inventory.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..tpu import topology
from .gang import is_gang_admitted

#: GKE node labels that identify a TPU node pool (tpu/placement renders
#: the same pair as pod nodeSelectors)
GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
#: GKE's spot/preemptible node marker — a pool whose nodes carry it is a
#: spot pool: cheaper in the placement score, evictable at any time (the
#: eviction rides the engine's slice-atomic failover, docs/failover.md)
GKE_SPOT_LABEL = "cloud.google.com/gke-spot"
#: operator-declared $/chip-hour on the Node (the static --pool-cost
#: config wins over labels when both are set)
COST_LABEL = "kubedl.io/cost-per-chip-hour"

_BY_GKE_ACCEL = {g.gke_accelerator: g for g in topology.GENERATIONS.values()}


class SchedulerParityError(AssertionError):
    """Incremental inventory disagrees with a from-scratch rescan — an
    inventory-maintenance bug (or genuinely lost watch events; chaos tests
    distinguish the two by whether a resync repairs it)."""


def pool_key(accelerator: str, topo: str) -> str:
    return f"{accelerator}/{topo}"


def hosts_per_slice(pool: str) -> int:
    """Hosts one slice of this pool occupies (1 when the pool shape is
    unknown — degrade to per-node slices rather than refusing to count)."""
    accel, _, topo = pool.partition("/")
    gen = _BY_GKE_ACCEL.get(accel)
    if gen is None or not topo:
        return 1
    try:
        return topology.parse_topology(gen.name, topo).num_hosts
    except (ValueError, KeyError):
        return 1


@dataclass(frozen=True)
class PoolEconomics:
    """Per-pool placement economics (docs/scheduling.md "Placement
    scoring"): $/chip-hour and the spot/preemptible class."""
    cost_per_chip_hour: float = 1.0
    spot: bool = False


def parse_pool_cost_spec(spec: str) -> dict:
    """``"tpu-v5p-slice/2x2x4=4.2,tpu-v5-lite-podslice/4x4=1.1:spot"`` →
    pool → PoolEconomics (``--pool-cost`` / KUBEDL_POOL_COST). The
    ``:spot`` suffix marks the preemptible pool class."""
    out: dict[str, PoolEconomics] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        pool, _, val = part.rpartition("=")
        if not pool:
            raise ValueError(f"pool cost entry {part!r} is not POOL=COST")
        cost, _, cls = val.partition(":")
        if cls not in ("", "spot"):
            raise ValueError(f"pool class {cls!r} is not 'spot'")
        out[pool] = PoolEconomics(cost_per_chip_hour=float(cost),
                                  spot=cls == "spot")
    return out


def parse_capacity_spec(spec: str) -> dict:
    """``"tpu-v5p-slice/2x2x4=4,tpu-v5e-lite-podslice/4x4=8"`` → static
    slice capacity per pool (``--slice-capacity`` / KUBEDL_SLICE_CAPACITY),
    for control planes that don't model Nodes."""
    out: dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        pool, _, n = part.rpartition("=")
        if not pool:
            raise ValueError(f"slice capacity entry {part!r} is not POOL=N")
        out[pool] = int(n)
    return out


@dataclass(frozen=True)
class HeldSlice:
    """One admitted PodGroup = one held slice."""
    namespace: str
    name: str
    pool: str
    queue: str
    job: str
    priority: int
    admitted_at: float  # creationTimestamp (FIFO/victim ordering)
    preempted: bool = False  # eviction in flight; still holds its slice
    #: elastic slice range of the owning gang (docs/elastic.md):
    #: 0 = fixed-width (the gang is not concurrency-elastic)
    min_slices: int = 0
    max_slices: int = 0


def _held_from_pg(pg: dict) -> Optional[HeldSlice]:
    if not is_gang_admitted(pg):
        return None
    ann = m.get_annotations(pg)
    pool = ann.get(c.ANNOTATION_SCHED_POOL, "")
    if not pool:
        return None  # non-TPU gang: holds no slice
    from .gang import is_gang_preempted

    def _int(key: str) -> int:
        try:
            return int(ann.get(key, "0") or 0)
        except ValueError:
            return 0

    return HeldSlice(
        namespace=m.namespace(pg), name=m.name(pg), pool=pool,
        queue=ann.get(c.ANNOTATION_SCHED_QUEUE, "") or "default",
        job=m.get_labels(pg).get(c.LABEL_GANG_JOB_NAME, m.name(pg)),
        priority=_int(c.ANNOTATION_SCHED_PRIORITY),
        admitted_at=m.parse_rfc3339(
            m.meta(pg).get("creationTimestamp")) or 0.0,
        preempted=is_gang_preempted(pg),
        min_slices=_int(c.ANNOTATION_SCHED_MIN_SLICES),
        max_slices=_int(c.ANNOTATION_SCHED_MAX_SLICES))


def _node_pool_of(node: dict) -> Optional[str]:
    lbl = m.get_labels(node)
    accel = lbl.get(GKE_ACCELERATOR_LABEL)
    topo = lbl.get(GKE_TOPOLOGY_LABEL)
    if not accel or not topo:
        return None
    return pool_key(accel, topo)


def _econ_from_labels(labels: dict) -> Optional[PoolEconomics]:
    """PoolEconomics from Node labels, or None when the node declares
    neither cost nor spot class (a malformed cost label degrades to the
    default rather than wedging node accounting)."""
    spot = str(labels.get(GKE_SPOT_LABEL, "")).lower() == "true"
    raw = labels.get(COST_LABEL)
    cost = 1.0
    if raw is not None:
        try:
            cost = float(raw)
        except (TypeError, ValueError):
            raw = None
    if raw is None and not spot:
        return None
    return PoolEconomics(cost_per_chip_hour=cost, spot=spot)


class SliceInventory:
    """Thread-safe incremental pool capacity + held-slice tracker."""

    def __init__(self, api=None, static_capacity: Optional[dict] = None,
                 economics: Optional[dict] = None):
        self._lock = threading.Lock()
        self.static_capacity = dict(static_capacity or {})
        #: static pool → PoolEconomics (--pool-cost); wins over Node labels
        self.static_economics = dict(economics or {})
        self._node_pool: dict[str, str] = {}    # node name -> pool
        self._hosts: dict[str, int] = {}        # pool -> live host count
        self._held: dict[tuple, HeldSlice] = {}  # (ns, pg-name) -> record
        #: economics learned from Node labels (kubedl.io/cost-per-chip-hour,
        #: cloud.google.com/gke-spot); last-observed node wins, resync
        #: rebuilds — cost is config-shaped, not high-churn state
        self._label_econ: dict[str, PoolEconomics] = {}
        #: ICI-domain assignment cache: (pool, capacity) -> layout, valid
        #: for one held-set generation (the assignment is a pure function
        #: of (held records, capacity) — see _domain_assignment)
        self._domain_gen = 0
        self._domain_cache: dict = {}
        self._api = api
        if api is not None:
            api.watch(self.observe)

    # -- incremental maintenance (watch-event fed) ------------------------

    def observe(self, event_type: str, obj: dict) -> None:
        kd = m.kind(obj)
        if kd == "Node":
            self._observe_node(event_type, obj)
        elif kd == "PodGroup":
            self._observe_pg(event_type, obj)

    def _observe_node(self, event_type: str, node: dict) -> None:
        name = m.name(node)
        pool = None if event_type == "DELETED" else _node_pool_of(node)
        with self._lock:
            old = self._node_pool.pop(name, None)
            if old is not None:
                left = self._hosts.get(old, 0) - 1
                if left > 0:
                    self._hosts[old] = left
                else:
                    self._hosts.pop(old, None)
            if pool is not None:
                self._node_pool[name] = pool
                self._hosts[pool] = self._hosts.get(pool, 0) + 1
                econ = _econ_from_labels(m.get_labels(node))
                if econ is not None:
                    self._label_econ[pool] = econ
            self._domain_gen += 1

    def _observe_pg(self, event_type: str, pg: dict) -> None:
        key = (m.namespace(pg), m.name(pg))
        rec = None if event_type == "DELETED" else _held_from_pg(pg)
        with self._lock:
            if rec is not None:
                self._held[key] = rec
            else:
                self._held.pop(key, None)
            self._domain_gen += 1

    def mark_admitted(self, pg: dict) -> None:
        """Synchronous update at admission time — correctness must not ride
        on the watch event making it back (it may be chaos-dropped)."""
        rec = _held_from_pg(pg)
        if rec is not None:
            with self._lock:
                self._held[(rec.namespace, rec.name)] = rec
                self._domain_gen += 1

    def mark_preempted(self, namespace: str, name: str) -> None:
        with self._lock:
            rec = self._held.get((namespace, name))
            if rec is not None and not rec.preempted:
                self._held[(namespace, name)] = replace(rec, preempted=True)

    # -- reads ------------------------------------------------------------

    def capacity_slices(self, pool: str) -> Optional[int]:
        """Whole slices this pool can host; None = unknown (unlimited)."""
        with self._lock:
            if pool in self.static_capacity:
                return int(self.static_capacity[pool])
            hosts = self._hosts.get(pool)
        if hosts is None:
            return None
        return hosts // hosts_per_slice(pool)

    def held_slices(self, pool: str) -> int:
        with self._lock:
            return sum(1 for h in self._held.values() if h.pool == pool)

    def set_static_capacity(self, pool: str,
                            slices: Optional[int]) -> None:
        """Adjust a pool's static slice capacity at runtime — the
        drained-pool / spot-dryness seam (docs/chaos.md): a spot pool
        whose capacity vanished mid-day is modeled as its static entry
        dropping to 0 and later recovering. ``None`` removes the static
        entry (back to Node-derived capacity). Invalidates the
        ICI-domain assignment cache like any capacity change."""
        with self._lock:
            if slices is None:
                self.static_capacity.pop(pool, None)
            else:
                self.static_capacity[pool] = int(slices)
            self._domain_gen += 1

    def free_slices(self, pool: str) -> Optional[int]:
        cap = self.capacity_slices(pool)
        if cap is None:
            return None
        return max(cap - self.held_slices(pool), 0)

    def overcommitted(self) -> dict:
        """``pool -> surplus`` for every pool whose LIVE held count (held
        minus evictions already in flight) exceeds its known capacity —
        the state a spot-dryness capacity drop leaves behind. The
        inventory is the authority here (docs/elastic.md): the
        scheduler's shrink pass consumes this to shed exactly the
        surplus, instead of an external sweep guessing at holders."""
        out: dict[str, int] = {}
        with self._lock:
            live: dict[str, int] = {}
            for h in self._held.values():
                if not h.preempted:
                    live[h.pool] = live.get(h.pool, 0) + 1
        for pool, n in live.items():
            cap = self.capacity_slices(pool)
            if cap is not None and n > cap:
                out[pool] = n - cap
        return out

    def held_records(self) -> list:
        with self._lock:
            return list(self._held.values())

    def held_by_queue(self) -> dict:
        out: dict[str, int] = {}
        for h in self.held_records():
            out[h.queue] = out.get(h.queue, 0) + 1
        return out

    def pools(self) -> set:
        with self._lock:
            return set(self.static_capacity) | set(self._hosts) \
                | {h.pool for h in self._held.values()}

    # -- economics (docs/scheduling.md "Placement scoring") ---------------

    def economics(self, pool: str) -> PoolEconomics:
        """The pool's $/chip-hour + spot class: static --pool-cost config
        first, then Node labels, else the neutral default (cost 1.0,
        on-demand)."""
        with self._lock:
            econ = self.static_economics.get(pool) \
                or self._label_econ.get(pool)
        return econ if econ is not None else PoolEconomics()

    def is_spot(self, pool: str) -> bool:
        return self.economics(pool).spot

    # -- ICI-domain accounting (derived, docs/scheduling.md) --------------
    #
    # A pool's slices are grouped into ICI domains (tpu/topology.py owns
    # the chips-per-domain math). The slice→domain assignment is a PURE
    # FUNCTION of (held records, capacity): gangs are packed best-fit in
    # admission order, so the incremental state and a from-scratch rescan
    # derive the identical occupancy by construction — there is no extra
    # incremental state to drift. Results are cached per held-set
    # generation; a pass touches each pool's assignment once.

    def _capacity_unlocked(self, pool: str) -> Optional[int]:
        if pool in self.static_capacity:
            return int(self.static_capacity[pool])
        hosts = self._hosts.get(pool)
        if hosts is None:
            return None
        return hosts // hosts_per_slice(pool)

    @staticmethod
    def _assign_groups(free: list, groups: list) -> dict:
        """Best-fit gang packing over per-domain free-slot counts (mutated
        in place): a gang goes whole into the fullest domain that still
        fits it, else spreads over the emptiest domains. Returns
        group key -> sorted list of domain indexes used."""
        placed: dict = {}
        for gkey, size in groups:
            used: set = set()
            fit = [i for i, f in enumerate(free) if f >= size]
            if fit:
                # tightest domain that fits (ties: lowest index) — keeps
                # big holes open for the next multi-slice gang
                i = min(fit, key=lambda j: (free[j], j))
                free[i] -= size
                used.add(i)
            else:
                left = size
                while left > 0:
                    avail = [i for i, f in enumerate(free) if f > 0]
                    if not avail:
                        # capacity shrank below held (drained pool):
                        # overflow into domain 0 rather than wedging
                        free[0] -= left
                        used.add(0)
                        break
                    i = max(avail, key=lambda j: (free[j], -j))
                    take = min(left, free[i])
                    free[i] -= take
                    left -= take
                    used.add(i)
            placed[gkey] = sorted(used)
        return placed

    def _domain_assignment(self, pool: str) -> Optional[dict]:
        """{"free": [slots/domain], "gangs": {(ns, job): [domains]},
        "per_domain": n} for a pool with known capacity and a known ICI
        shape; None otherwise. Caller must NOT hold the lock."""
        per = topology.pool_ici_slices(pool)
        with self._lock:
            cap = self._capacity_unlocked(pool)
            if per is None or cap is None or cap <= 0:
                return None
            key = (pool, cap, per)
            cached = self._domain_cache.get(key)
            if cached is not None and cached[0] == self._domain_gen:
                return cached[1]
            held = [h for h in self._held.values() if h.pool == pool]
            gen = self._domain_gen
        ndom = (cap + per - 1) // per
        free = [per] * (ndom - 1) + [cap - per * (ndom - 1)] if ndom \
            else []
        by_gang: dict = {}
        for h in held:
            gk = (h.namespace, h.job)
            by_gang.setdefault(gk, [h.admitted_at, 0])
            by_gang[gk][0] = min(by_gang[gk][0], h.admitted_at)
            by_gang[gk][1] += 1
        groups = sorted(((gk, n) for gk, (_at, n) in by_gang.items()),
                        key=lambda t: (by_gang[t[0]][0], t[0]))
        gangs = self._assign_groups(free, groups)
        out = {"free": free, "gangs": gangs, "per_domain": per}
        with self._lock:
            # keep only entries of the current generation (stale ones can
            # never be read again; capacity churn must not grow the cache)
            self._domain_cache = {k: v for k, v in
                                  self._domain_cache.items()
                                  if v[0] == self._domain_gen}
            self._domain_cache[key] = (gen, out)
        return out

    def domain_free_map(self, pool: str) -> Optional[list]:
        """Free slice slots per ICI domain (index order), or None when
        the pool has no domain math (unknown capacity/shape)."""
        asg = self._domain_assignment(pool)
        return None if asg is None else list(asg["free"])

    def domain_gangs(self, pool: str) -> Optional[dict]:
        """{(namespace, job): [domain indexes]} for every gang holding
        slices in ``pool``, or None when the pool has no domain math —
        the chaos campaign layer's targeting input (docs/chaos.md): a
        domain-wide outage preempts exactly the gangs the inventory's
        own per-domain accounting places there."""
        asg = self._domain_assignment(pool)
        if asg is None:
            return None
        return {gk: list(doms) for gk, doms in asg["gangs"].items()}

    def gang_domains(self, namespace: str, job: str,
                     pool: str) -> Optional[int]:
        """ICI domains a held gang spans (1 = packed), or None when the
        gang holds nothing there / the pool has no domain math."""
        asg = self._domain_assignment(pool)
        if asg is None:
            return None
        used = asg["gangs"].get((namespace, job))
        return len(used) if used else None

    def placement_spans(self, pool: str, demand: int) -> Optional[int]:
        """ICI domains a NEW gang of ``demand`` slices would span given
        the current occupancy — the scheduler's contention input. None
        when the pool has no domain math (penalty-neutral)."""
        if demand <= 1:
            return 1
        asg = self._domain_assignment(pool)
        if asg is None:
            return None
        free = list(asg["free"])
        placed = self._assign_groups(free, [(("", ""), demand)])
        return len(placed[("", "")])

    # -- rescan / parity / resync ----------------------------------------

    def _scan(self, api) -> tuple:
        """From-scratch (node_pool, held) maps — the ground truth the
        incremental state must match."""
        node_pool = {}
        for node in api.list("Node"):
            pool = _node_pool_of(node)
            if pool is not None:
                node_pool[m.name(node)] = pool
        held = {}
        for pg in api.list("PodGroup"):
            rec = _held_from_pg(pg)
            if rec is not None:
                held[(rec.namespace, rec.name)] = rec
        return node_pool, held

    def drift(self, api=None) -> dict:
        """Divergence between incremental state and a from-scratch scan;
        empty dict = converged (the parity-style full-rescan check)."""
        api = api or self._api
        node_pool, held = self._scan(api)
        with self._lock:
            out = {}
            if node_pool != self._node_pool:
                out["nodes"] = {"incremental": dict(self._node_pool),
                                "scan": node_pool}
            if held != self._held:
                out["held"] = {
                    "incremental": sorted(self._held),
                    "scan": sorted(held)}
            return out

    def check_parity(self, api=None) -> None:
        d = self.drift(api)
        if d:
            raise SchedulerParityError(
                f"slice inventory diverged from full rescan: {d}")

    def resync(self, api=None) -> bool:
        """Replace incremental state with a from-scratch scan; returns True
        when the scan found drift (lost watch events repaired)."""
        api = api or self._api
        node_pool, held = self._scan(api)
        label_econ: dict[str, PoolEconomics] = {}
        for node in api.list("Node"):
            pool = _node_pool_of(node)
            econ = _econ_from_labels(m.get_labels(node))
            if pool is not None and econ is not None:
                label_econ[pool] = econ
        with self._lock:
            drifted = node_pool != self._node_pool or held != self._held
            self._node_pool = node_pool
            hosts: dict[str, int] = {}
            for pool in node_pool.values():
                hosts[pool] = hosts.get(pool, 0) + 1
            self._hosts = hosts
            self._held = held
            self._label_econ = label_econ
            self._domain_gen += 1
        return drifted

"""Console data layer: api-server first, persistence fallback ("proxy").

The reference's default object storage for the console is ``proxy`` —
"first try read/write from api-server, and fall back to DB if not exists"
(``console/backend/pkg/routers/router.go:34-38``). This module is that
merge: live objects come from the in-memory API server through the typed
clientset; jobs that were GC'd from the api-server are filled in from the
persistence backend's records.

Copied from ``kubedl_tpu/console/proxy.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from ..api import common as c
from ..api.queue import DEFAULT_QUEUE, QueueSpec
from ..client.clientset import TRAINING_KINDS
from ..core import meta as m
from ..core.apiserver import APIServer
from ..scheduling.gang import GANG_POD_LABELS
from ..storage import dmo
from ..utils import quota
from ..storage.backends import (EventBackend, ObjectBackend, Query, _match,
                                _paginate)


def pod_resource_request(pod: dict) -> dict:
    """Effective resource request of one pod object — the ONE
    ``quota.pod_request`` rollup every cluster view shares (it used to be
    re-derived inline in three places)."""
    return quota.pod_request(pod.get("spec", {}) or {})


def pod_tpu_request(pod: dict) -> float:
    """TPU chips one pod requests (the per-pod slice-occupancy rollup)."""
    return pod_resource_request(pod).get(c.RESOURCE_TPU, 0)


class DataProxy:
    def __init__(self, api: APIServer,
                 object_backend: Optional[ObjectBackend] = None,
                 event_backend: Optional[EventBackend] = None,
                 job_kinds=TRAINING_KINDS, tracer=None, scheduler=None,
                 telemetry=None, journal=None, replication=None,
                 elastic: bool = False, serving_fleet=None,
                 serving_autoscaler=None, serving_router=None,
                 federation=None, rl=None, adapter_catalog=None):
        self.api = api
        self.object_backend = object_backend
        self.event_backend = event_backend
        self.job_kinds = tuple(job_kinds)
        #: the operator's span recorder (kubedl_tpu_torch.trace.Tracer); None
        #: or disabled = the /api/v1/trace endpoints answer 501
        self.tracer = tracer
        #: the live SliceScheduler (docs/scheduling.md); None = the
        #: /api/v1/explain endpoint answers 501
        self.scheduler = scheduler
        #: the FleetTelemetry bundle (docs/telemetry.md); None = the job
        #: detail carries no goodput field (disabled path byte-identical)
        self.telemetry = telemetry
        #: the control plane's WAL journal (docs/durability.md); None =
        #: the /api/v1/forensics and /api/v1/durability endpoints 501
        self.journal = journal
        #: the ReplicatedControlPlane (docs/replication.md); None = the
        #: /api/v1/replication endpoints 501
        self.replication = replication
        #: concurrency-elastic slices on (docs/elastic.md); False = the
        #: /api/v1/elastic endpoints answer 501
        self.elastic_enabled = bool(elastic)
        #: the live ServingFleet (+ optional autoscaler/router) when
        #: this process hosts serving replicas (docs/serving_fleet.md);
        #: None = the /api/v1/serving/fleet endpoint answers 501
        self.serving_fleet = serving_fleet
        self.serving_autoscaler = serving_autoscaler
        self.serving_router = serving_router
        #: the federation driver (docs/federation.md); None = the
        #: /api/v1/federation endpoints answer 501 (gate-off path
        #: byte-identical: this process hosts no global layer)
        self.federation = federation
        #: the hosted RLFlywheel driver (docs/rl.md); None = the
        #: /api/v1/rl endpoints answer 501 (gate off, or this process
        #: hosts no flywheel — same convention as serving_fleet)
        self.rl = rl
        #: the fleet-wide AdapterCatalog (docs/multimodel.md); None =
        #: the /api/v1/serving/models endpoint answers 501 (gate off,
        #: or this process hosts no multi-model fleet — same convention
        #: as serving_fleet)
        self.adapter_catalog = adapter_catalog

    # -- jobs -------------------------------------------------------------

    def list_jobs(self, query: Query) -> list:
        """Live jobs rendered as records, unioned with persisted records of
        jobs no longer in the api-server (matched by uid)."""
        kinds = [query.kind] if query.kind else self.job_kinds
        live: dict[str, dmo.JobRecord] = {}
        for kind in kinds:
            if kind not in self.job_kinds:
                continue
            for obj in self.api.list(kind):
                rec = dmo.job_to_record(obj)
                live[rec.job_id] = rec
        rows = [r for r in live.values() if _match(r, query)]
        if self.object_backend is not None:
            persisted = self.object_backend.list_jobs(
                Query(**{**query.__dict__, "page_num": 0, "page_size": 0}))
            rows.extend(r for r in persisted if r.job_id not in live)
        rows.sort(key=lambda r: r.gmt_created, reverse=True)
        return _paginate(rows, query)

    def get_job(self, kind: str, namespace: str, name: str) -> Optional[dict]:
        """The live CR when present, else a record-shaped stub."""
        obj = self.api.try_get(kind, namespace, name)
        if obj is not None:
            return obj
        if self.object_backend is not None:
            rec = self.object_backend.get_job(namespace, name)
            if rec is not None and (not kind or rec.kind == kind):
                return {"apiVersion": "training.kubedl.io/v1alpha1",
                        "kind": rec.kind,
                        "metadata": {"name": rec.name, "namespace": rec.namespace,
                                     "uid": rec.job_id,
                                     "creationTimestamp": rec.gmt_created},
                        "spec": {"resources": json.loads(rec.resources or "{}")},
                        "status": {"conditions": [{"type": rec.status,
                                                   "status": "True"}]},
                        "_persisted": True}
        return None

    def list_job_pods(self, kind: str, namespace: str, name: str) -> list:
        job = self.api.try_get(kind, namespace, name)
        if job is not None:
            uid = m.uid(job)
            if hasattr(self.api, "list_owned"):
                # ownerRef-UID index: O(job's pods), not O(namespace)
                pods = [p for p in self.api.list_owned("Pod", uid, namespace)
                        if m.is_controlled_by(p, job)]
            else:
                pods = [p for p in self.api.list("Pod", namespace)
                        if m.is_controlled_by(p, job)]
            if pods:
                return [dmo.pod_to_record(p) for p in pods]
        else:
            uid = ""
            if self.object_backend is not None:
                rec = self.object_backend.get_job(namespace, name)
                uid = rec.job_id if rec else ""
        if self.object_backend is not None and uid:
            return self.object_backend.list_pods(namespace, name, uid)
        return []

    def stop_job(self, kind: str, namespace: str, name: str) -> bool:
        """Stop = delete from api-server but keep (and mark) the record
        (reference StopJob semantics)."""
        obj = self.api.try_get(kind, namespace, name)
        if obj is None:
            return False
        self.api.delete(kind, namespace, name)
        if self.object_backend is not None:
            self.object_backend.stop_job(namespace, name, m.uid(obj))
        return True

    def job_statistics(self, query: Query) -> dict:
        """Reference GetJobStatistics: totals + per-status histogram."""
        rows = self.list_jobs(Query(**{**query.__dict__,
                                       "page_num": 0, "page_size": 0}))
        by_status: dict[str, int] = {}
        for r in rows:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        return {"total": len(rows), "byStatus": by_status,
                "statistics": [{"status": k, "count": v}
                               for k, v in sorted(by_status.items())]}

    # -- events / notebooks ----------------------------------------------

    def pod_log_lines(self, namespace: str, pod_name: str) -> list:
        """Real kubelet logs when the API substrate serves the log
        subresource (real-cluster mode); the pod's event stream otherwise
        (the standalone control plane has no kubelet)."""
        if hasattr(self.api, "pod_logs"):
            try:
                # multi-container pods require an explicit container; use
                # the first (the engine puts the main container first)
                container = None
                pod = self.api.try_get("Pod", namespace, pod_name)
                if pod is not None:
                    containers = m.get_in(pod, "spec", "containers",
                                          default=[]) or []
                    if len(containers) > 1:
                        container = containers[0].get("name")
                text = self.api.pod_logs(namespace, pod_name,
                                         container=container,
                                         tail_lines=1000)
                return text.splitlines()
            except Exception as e:  # noqa: BLE001 — degrade, but loudly:
                # a swallowed 403 (missing pods/log RBAC) must not read as
                # "this pod has no logs"
                logging.getLogger("kubedl_tpu_torch.console").warning(
                    "pod logs for %s/%s unavailable (%s: %s); serving "
                    "event stream instead", namespace, pod_name,
                    type(e).__name__, e)
        return [f"{e.last_timestamp} [{e.type}] {e.reason}: {e.message}"
                for e in self.list_events(namespace, pod_name)]

    def list_events(self, namespace: str, obj_name: str) -> list:
        if hasattr(self.api, "list_indexed"):
            # involvedObject-name index: O(object's events) per page load,
            # not a scan of every Event in the namespace
            evs = self.api.list_indexed("Event", "involved-name", obj_name,
                                        namespace=namespace)
        else:
            evs = [e for e in self.api.list("Event", namespace)
                   if e.get("involvedObject", {}).get("name") == obj_name]
        live = [dmo.event_to_record(e) for e in evs]
        if live:
            return sorted(live, key=lambda r: r.last_timestamp)
        if self.event_backend is not None:
            return self.event_backend.list_events(namespace, obj_name)
        return []

    def list_notebooks(self, query: Query) -> list:
        live: dict[str, dmo.NotebookRecord] = {}
        for obj in self.api.list("Notebook"):
            rec = dmo.notebook_to_record(obj)
            live[rec.notebook_id] = rec
        rows = [r for r in live.values()
                if _match(r, query, kind_field=False)]
        if self.object_backend is not None:
            rows.extend(
                r for r in self.object_backend.list_notebooks(
                    Query(**{**query.__dict__, "page_num": 0, "page_size": 0}))
                if r.notebook_id not in live)
        rows.sort(key=lambda r: r.gmt_created, reverse=True)
        return _paginate(rows, query)

    # -- cluster ----------------------------------------------------------

    def cluster_total(self) -> dict:
        """Reference getClusterTotal: summed allocatable of Nodes; on the
        standalone control plane, Node objects are optional so the TPU
        devices visible to the process stand in when none exist."""
        nodes = self.api.list("Node")
        total = {"cpu": 0.0, "memory": 0.0, "google.com/tpu": 0.0}
        for node in nodes:
            alloc = m.get_in(node, "status", "allocatable", default={}) or {}
            for key, val in alloc.items():
                total[key] = total.get(key, 0.0) + dmo.parse_quantity(val)
        return {"nodes": len(nodes), "total": total}

    def cluster_request(self, pod_phase: str) -> dict:
        """Summed requests of pods in the given phase (reference
        getClusterRequest)."""
        total: dict[str, float] = {}
        count = 0
        for pod in self.api.list("Pod"):
            phase = m.get_in(pod, "status", "phase", default="Pending")
            if pod_phase and phase != pod_phase:
                continue
            count += 1
            for key, val in pod_resource_request(pod).items():
                total[key] = total.get(key, 0) + val
        return {"pods": count, "request": total}

    def node_infos(self) -> list:
        out = []
        for node in self.api.list("Node"):
            out.append({
                "name": m.name(node),
                "allocatable": m.get_in(node, "status", "allocatable",
                                        default={}) or {},
                "labels": m.get_labels(node),
            })
        return out

    #: every gang plugin's pod->group membership label, derived from the
    #: plugin registry in scheduling/gang.py
    _GANG_POD_LABELS = GANG_POD_LABELS

    def cluster_occupancy(self) -> dict:
        """The TPU operator's day-one view (reference ClusterInfo depth,
        re-pointed at slice semantics): the gang/PodGroup table — which
        slices are gang-held, by whom, how many members are up, how long
        pending gangs have been waiting — plus per-node TPU chips in use
        vs allocatable."""
        now = self.api.now() if hasattr(self.api, "now") else None

        pods = self.api.list("Pod")
        gangs = []
        for pg in self.api.list("PodGroup"):
            ns, name = m.namespace(pg), m.name(pg)
            mm = int(m.get_in(pg, "spec", "minMember", default=0) or 0)
            members = [p for p in pods if m.namespace(p) == ns and any(
                m.get_labels(p).get(k) == name for k in self._GANG_POD_LABELS)]
            running = sum(1 for p in members if m.get_in(
                p, "status", "phase", default="Pending") == "Running")
            scheduled = sum(1 for p in members
                            if m.get_in(p, "spec", "nodeName"))
            tpu = sum(pod_tpu_request(p) for p in members)
            phase = "Running" if mm and running >= mm else "Pending"
            age = None
            if phase == "Pending" and now is not None:
                # age since the gang BECAME pending, not since it was
                # created: the newest not-yet-running member marks when
                # the wait (re)started — a gang that ran for hours and
                # lost one pod ages from the replacement pod, not from
                # job submission
                waiting = [m.parse_rfc3339(
                    m.meta(p).get("creationTimestamp"))
                    for p in members
                    if m.get_in(p, "status", "phase",
                                default="Pending") != "Running"]
                waiting = [w for w in waiting if w is not None]
                since = (max(waiting) if waiting else m.parse_rfc3339(
                    m.meta(pg).get("creationTimestamp")))
                if since is not None:
                    age = max(0.0, now - since)
            gangs.append({
                "namespace": ns, "name": name,
                "job": m.get_labels(pg).get(c.LABEL_GANG_JOB_NAME, ""),
                "minMember": mm, "members": len(members),
                "running": running, "scheduled": scheduled,
                "tpuChips": tpu, "phase": phase,
                "pendingSeconds": (round(age, 1)
                                   if age is not None else None),
            })
        gangs.sort(key=lambda g: (g["phase"] != "Pending",
                                  -(g["pendingSeconds"] or 0.0),
                                  g["name"]))

        nodes = []
        for node in self.api.list("Node"):
            nname = m.name(node)
            alloc = m.get_in(node, "status", "allocatable",
                             default={}) or {}
            chips = dmo.parse_quantity(alloc.get("google.com/tpu", 0))
            used = sum(
                pod_tpu_request(p)
                for p in pods
                if m.get_in(p, "spec", "nodeName") == nname
                and m.get_in(p, "status", "phase",
                             default="Pending") not in ("Succeeded",
                                                        "Failed"))
            labels = m.get_labels(node)
            nodes.append({
                "name": nname,
                "tpuAllocatable": chips, "tpuInUse": used,
                "tpuIdle": max(chips - used, 0),
                "accelerator": labels.get(
                    "cloud.google.com/gke-tpu-accelerator", ""),
                "topology": labels.get(
                    "cloud.google.com/gke-tpu-topology", ""),
            })
        nodes.sort(key=lambda n: n["name"])
        return {
            "gangs": gangs,
            "nodes": nodes,
            "totalChips": sum(n["tpuAllocatable"] for n in nodes),
            "chipsInUse": sum(n["tpuInUse"] for n in nodes),
            "pendingGangs": sum(1 for g in gangs
                                if g["phase"] == "Pending"),
        }

    # -- queues (slice scheduler, docs/scheduling.md) ---------------------

    def list_queues(self) -> list:
        """Per-queue quota + usage table: declared Queue objects (plus the
        implicit default and any queue PodGroups actually reference), with
        held/pending gang counts and the TPU chips the queue's pods request
        (the shared ``pod_tpu_request`` rollup)."""
        from ..scheduling.gang import is_gang_admitted
        rows: dict[str, dict] = {}

        def row(name: str, spec: Optional[QueueSpec] = None) -> dict:
            if name not in rows:
                spec = spec or QueueSpec(name=name)
                rows[name] = {
                    "name": name,
                    "quotaMin": spec.min,
                    "quotaMax": spec.max,
                    "priority": spec.priority,
                    "tenants": list(spec.tenants),
                    "heldSlices": 0,
                    "pendingPodGroups": 0,
                    "tpuChipsInUse": 0,
                }
            return rows[name]

        row(DEFAULT_QUEUE)
        for obj in self.api.list("Queue"):
            spec = QueueSpec.from_obj(obj)
            row(spec.name, spec)

        pg_queue: dict[tuple, str] = {}
        for pg in self.api.list("PodGroup"):
            ann = m.get_annotations(pg)
            qname = ann.get(c.ANNOTATION_SCHED_QUEUE, "") or DEFAULT_QUEUE
            pg_queue[(m.namespace(pg), m.name(pg))] = qname
            r = row(qname)
            if is_gang_admitted(pg):
                if ann.get(c.ANNOTATION_SCHED_POOL, ""):
                    r["heldSlices"] += 1
            else:
                r["pendingPodGroups"] += 1

        for pod in self.api.list("Pod"):
            if m.get_in(pod, "status", "phase",
                        default="Pending") in ("Succeeded", "Failed"):
                continue
            lbl = m.get_labels(pod)
            for key in self._GANG_POD_LABELS:
                gname = lbl.get(key)
                if gname:
                    qname = pg_queue.get((m.namespace(pod), gname))
                    if qname is not None:
                        row(qname)["tpuChipsInUse"] += pod_tpu_request(pod)
                    break
        return sorted(rows.values(), key=lambda r: r["name"])

    def queue_usage(self, name: str) -> Optional[dict]:
        for r in self.list_queues():
            if r["name"] == name:
                if self.placement_enabled:
                    # scored-placement detail (docs/scheduling.md
                    # "Placement scoring"): where this queue's slices
                    # actually sit, priced — only with the gate on, so
                    # the ungated response stays byte-identical
                    inv = self.scheduler.inventory
                    by_pool: dict[str, int] = {}
                    for h in inv.held_records():
                        if h.queue == name:
                            by_pool[h.pool] = by_pool.get(h.pool, 0) + 1
                    r["pools"] = {
                        pool: {
                            "heldSlices": n,
                            "costPerChipHour":
                                inv.economics(pool).cost_per_chip_hour,
                            "spot": inv.economics(pool).spot,
                        } for pool, n in sorted(by_pool.items())}
                return r
        return None

    # -- pools (placement scoring, docs/scheduling.md) --------------------

    @property
    def placement_enabled(self) -> bool:
        return (self.scheduler is not None
                and getattr(self.scheduler, "scorer", None) is not None)

    def pool_table(self) -> list:
        """Per-pool placement facts for ``/api/v1/pools``: capacity /
        held / free, $/chip-hour + spot class, the ICI-domain free map,
        the static throughput seed, and per-profile normalized
        throughput from the live ThroughputProfileStore."""
        from ..scheduling import scoring
        from ..tpu import topology
        inv = self.scheduler.inventory
        scorer = self.scheduler.scorer
        norm_by_pool: dict[str, dict] = {}
        store = scorer.profiles if scorer is not None else None
        if store is not None:
            for key in store.snapshot():
                for pool, v in store.normalized(key).items():
                    norm_by_pool.setdefault(pool, {})[key] = round(v, 4)
        rows = []
        for pool in sorted(inv.pools()):
            econ = inv.economics(pool)
            rows.append({
                "pool": pool,
                "capacitySlices": inv.capacity_slices(pool),
                "heldSlices": inv.held_slices(pool),
                "freeSlices": inv.free_slices(pool),
                "costPerChipHour": econ.cost_per_chip_hour,
                "spot": econ.spot,
                "slicesPerIciDomain": topology.pool_ici_slices(pool),
                "iciDomainFree": inv.domain_free_map(pool),
                "seedTokensPerSecond": round(scoring.seed_rate(pool), 4),
                "normalizedThroughput": norm_by_pool.get(pool, {}),
            })
        return rows

    # -- traces (docs/tracing.md) -----------------------------------------

    @property
    def tracing_enabled(self) -> bool:
        return self.tracer is not None and self.tracer.enabled

    def _job_trace_id(self, namespace: str, name: str) -> Optional[str]:
        """Resolve a job's trace id: from the live object when present
        (annotation / UID derivation), else by searching recorded spans
        for the ``job=ns/name`` attribute (the job may be TTL-deleted
        while its trace is still in the ring)."""
        from ..trace import job_trace_context
        for kind in self.job_kinds:
            obj = self.api.try_get(kind, namespace, name)
            if obj is not None:
                return job_trace_context(obj)[0]
        ids = self.tracer.find_trace_ids(job=f"{namespace}/{name}")
        return ids[0] if ids else None

    def job_trace(self, namespace: str, name: str) -> Optional[dict]:
        """Timeline + critical-path breakdown for one job's trace, or
        None when no spans exist (job unknown / tracing just enabled)."""
        from ..trace import trace_breakdown
        trace_id = self._job_trace_id(namespace, name)
        if trace_id is None:
            return None
        spans = self.tracer.spans(trace_id=trace_id)
        if not spans:
            return None
        out = trace_breakdown(spans, trace_id)
        out["job"] = f"{namespace}/{name}"
        return out

    def trace_spans(self, trace_id: str) -> list:
        """Raw spans of one trace (the serving request endpoint)."""
        return self.tracer.spans(trace_id=trace_id)

    def job_queue_wait(self, job: dict) -> Optional[float]:
        """Per-job queue wait in seconds for the job-detail view: the
        trace breakdown's Queuing total (closed stints) PLUS the live
        Queuing condition's age when the job is waiting right now — a
        re-queued-after-preemption job's current stint is an open phase
        with no span yet, so the two sources are disjoint and additive.
        None when neither exists (the aggregate picture stays on the
        PR 4 scheduler queue-wait histogram)."""
        closed = None
        if self.tracing_enabled:
            from ..trace import job_trace_context, trace_breakdown
            spans = self.tracer.spans(
                trace_id=job_trace_context(job)[0])
            if spans:
                closed = trace_breakdown(spans)["byPhase"].get("Queuing")
        live = None
        for cond in m.get_in(job, "status", "conditions",
                             default=[]) or []:
            if cond.get("type") == c.JOB_QUEUING \
                    and cond.get("status") == "True":
                since = m.parse_rfc3339(cond.get("lastTransitionTime"))
                if since is not None:
                    live = max(self.api.now() - since, 0.0)
        if closed is None and live is None:
            return None
        return round((closed or 0.0) + (live or 0.0), 3)

    # -- fleet telemetry (docs/telemetry.md) ------------------------------

    @property
    def telemetry_enabled(self) -> bool:
        return self.telemetry is not None

    def fleet_goodput(self) -> dict:
        """The GoodputAccountant's fleet rollup — the number
        BENCH_CLUSTER gates on, served live (docs/telemetry.md)."""
        return self.telemetry.goodput.summary()

    # -- SLO engine (docs/slo.md) -----------------------------------------

    @property
    def slo_enabled(self) -> bool:
        return (self.telemetry is not None
                and getattr(self.telemetry, "slo", None) is not None)

    def slo_list(self) -> list:
        """Every objective's live status (windows, budget, burn rates,
        alert state), name-sorted; invalid SLO objects appear with their
        parse error."""
        return self.telemetry.slo.statuses()

    def slo_status(self, name: str) -> Optional[dict]:
        return self.telemetry.slo.status(name)

    def job_goodput(self, job: dict) -> Optional[dict]:
        """Per-job goodput decomposition for the job-detail view, from
        the job's trace (live jobs show the decomposition so far). None
        when the job has no trace spans."""
        if not self.tracing_enabled:
            return None
        from ..telemetry import goodput_breakdown
        from ..trace import job_trace_context, trace_breakdown
        spans = self.tracer.spans(trace_id=job_trace_context(job)[0])
        if not spans:
            return None
        return goodput_breakdown(trace_breakdown(spans))

    # -- forensics (docs/forensics.md) ------------------------------------

    @property
    def forensics_enabled(self) -> bool:
        return self.journal is not None

    @property
    def incidents_enabled(self) -> bool:
        """The incident stream reads the SLO evaluator's logs — it
        needs telemetry with the SLO engine, not the journal."""
        return getattr(self.telemetry, "slo", None) is not None

    def _worldline(self):
        from ..forensics import WorldLine
        return WorldLine(self.journal.dir)

    def world_at(self, rv: int) -> dict:
        """The store reconstructed at resourceVersion ``rv`` (newest
        snapshot <= rv + WAL tail replay), summarized for the console:
        per-kind counts, keys, and the reconstruction provenance."""
        return self._worldline().world_summary(int(rv))

    def forensic_object_history(self, kind: str, namespace: str,
                                name: str) -> Optional[dict]:
        """Every retained spec/status commit of one object, with WAL
        timestamps; None when the journal holds no record of it."""
        history = self._worldline().object_history(kind, namespace, name)
        if not history:
            return None
        return {"kind": kind, "namespace": namespace, "name": name,
                "history": history}

    def incident_timeline(self) -> dict:
        """The live operator's incident stream: SLO fire/clear
        transitions merged into incidents, with whatever attribution
        sources exist (a production operator has no campaign, so
        incidents carry no fault links — the stream itself is the
        value: one ordered record instead of grepping Events)."""
        from ..forensics import IncidentTimeline
        tl = IncidentTimeline(epoch=0.0)
        slo = self.telemetry.slo
        # copied under the evaluator lock: this runs on a console
        # request thread while the operator thread appends
        alert_log, bad_samples = slo.attribution()
        tl.add_alert_log(alert_log, slo.specs())
        tl.add_bad_samples(bad_samples)
        return tl.build()

    def durability_status(self) -> dict:
        """The journal's operator-visible health: where the WAL lives,
        how the last recovery rebuilt the world (``recovered_from`` —
        which snapshot generation, how much tail was replayed, torn
        records tolerated), and the live append/snapshot counters."""
        j = self.journal
        return {
            "journalDir": j.dir,
            "snapshotEvery": j.snapshot_every,
            "fsyncEvery": j.fsync_every,
            "retainAll": j.retain_all,
            "appends": j.appends,
            "snapshotsWritten": j.snapshots_written,
            "snapshotGenerations": [rv for rv, _ in j.snapshots()],
            "recoveredFrom": dict(j.recovered_from),
        }

    # -- replication (docs/replication.md) --------------------------------

    @property
    def replication_enabled(self) -> bool:
        return self.replication is not None

    def replication_status(self) -> dict:
        """The replication group's live health: role, stream epoch,
        per-follower applied-rv lag, shipping volume, and — after a
        failover — the ``lastPromotion`` provenance (who was promoted,
        how much inherited WAL tail was replayed, how long the lease
        wait took), the replication analog of ``recoveredFrom``."""
        return self.replication.status()

    # -- federation (docs/federation.md) ----------------------------------

    @property
    def federation_enabled(self) -> bool:
        return self.federation is not None

    def federation_status(self) -> dict:
        """The global layer's live document: region liveness, routing
        spread, catalog prefix homes, cross-region shipping health, and
        standby state (docs/federation.md)."""
        return self.federation.status()

    def federation_topology(self) -> dict:
        """The static region topology the routing scores derive from:
        regions, pairwise latency/egress, and the grammar fingerprint
        the committed federation scorecard pins."""
        doc = self.federation.topology.describe()
        doc["fingerprint"] = self.federation.topology.fingerprint()
        return doc

    # -- RL flywheel (docs/rl.md) -----------------------------------------

    @property
    def rl_enabled(self) -> bool:
        return self.rl is not None

    def rl_job(self, namespace: str, name: str) -> Optional[dict]:
        """One RLJob's live flywheel document: policy version vs the
        serving fleet's visible versions, rollout throughput against the
        declared floor, publish/staleness counters, queue spills. None
        when the hosted flywheel drives a different job."""
        return self.rl.job_status(namespace, name)

    def job_elastic(self, namespace: str, name: str) -> Optional[dict]:
        """The job's live elastic state (docs/elastic.md): the recorded
        running slice set, per-slice gang states (active / leaving /
        pending), the declared min..max range, and where the 2-phase
        checkpoint protocol stands. None for unknown jobs."""
        from ..scheduling.gang import is_gang_admitted, is_gang_preempted
        job = None
        for kind in self.job_kinds:
            job = self.api.try_get(kind, namespace, name)
            if job is not None:
                break
        if job is None:
            return None
        ann = m.get_annotations(job)
        slices = []
        mn = mx = 0
        for pg in self.api.list("PodGroup", namespace,
                                selector={c.LABEL_GANG_JOB_NAME: name}):
            pg_ann = m.get_annotations(pg)
            try:
                mn = max(mn, int(pg_ann.get(
                    c.ANNOTATION_SCHED_MIN_SLICES, "0") or 0))
                mx = max(mx, int(pg_ann.get(
                    c.ANNOTATION_SCHED_MAX_SLICES, "0") or 0))
            except ValueError:
                pass
            state = "pending"
            if is_gang_admitted(pg):
                state = "leaving" if is_gang_preempted(pg) else "active"
            slices.append({"podGroup": m.name(pg), "state": state,
                           "pool": pg_ann.get(c.ANNOTATION_SCHED_POOL,
                                              "")})
        slices.sort(key=lambda s: s["podGroup"])
        return {
            "job": f"{namespace}/{name}",
            "minSlices": mn or None,
            "maxSlices": mx or None,
            "runningSlices": ann.get(c.ANNOTATION_ELASTIC_SLICES),
            "slices": slices,
            "activeSlices": sum(1 for s in slices
                                if s["state"] == "active"),
            "checkpointRequestedVersion": int(ann.get(
                c.ANNOTATION_CKPT_REQUESTED_VERSION, 0) or 0),
            "checkpointCompletedVersion": int(ann.get(
                c.ANNOTATION_CKPT_COMPLETED_VERSION, 0) or 0),
            "reconfigureRequestedAt": ann.get(
                c.ANNOTATION_ELASTIC_RECONFIGURE_AT),
        }

    def serving_fleet_status(self) -> dict:
        """The fleet snapshot (docs/serving_fleet.md): per-replica
        health, drain state, router placement counters, and the
        autoscaler's event log — everything the operator needs to
        answer "why did the fleet scale"."""
        out = self.serving_fleet.status()
        if self.serving_router is not None:
            out["router"] = self.serving_router.stats()
        if self.serving_autoscaler is not None:
            out["autoscaler"] = self.serving_autoscaler.status()
        return out

    @property
    def multi_model_enabled(self) -> bool:
        return (self.adapter_catalog is not None
                and self.serving_fleet is not None)

    def serving_models_status(self) -> dict:
        """The multi-model snapshot (docs/multimodel.md): the fleet-wide
        adapter catalog plus each replica's residency — which adapters
        are resident/pinned where, their pool pages, fault-in and
        eviction counts. The answer to "where does model X live and
        what is it costing"."""
        cat = self.adapter_catalog
        models = [{"model": m,
                   "pages": cat.spec(m).pages,
                   "rank": cat.spec(m).rank}
                  for m in cat.models()]
        replicas = []
        for rep in self.serving_fleet.replicas:
            status_fn = getattr(rep.engine, "adapter_status", None)
            st = status_fn() if status_fn is not None else None
            replicas.append({"replica": rep.name,
                             "draining": rep.draining,
                             "adapters": st})
        return {"baseModel": cat.base_model,
                "models": models,
                "replicas": replicas}

    def explain_pending(self, namespace: str, name: str) -> Optional[dict]:
        """The pending-job explainer verdict (requires the scheduler);
        falls back to a phase-shaped answer for jobs the scheduler has
        never seen (running pre-gate, terminal, unknown)."""
        from ..telemetry import explain_pending
        verdict = explain_pending(self.scheduler, namespace, name)
        if verdict is not None:
            return verdict
        for kind in self.job_kinds:
            job = self.api.try_get(kind, namespace, name)
            if job is not None:
                conds = m.get_in(job, "status", "conditions",
                                 default=[]) or []
                state = next((cd.get("type") for cd in reversed(conds)
                              if cd.get("status") == "True"), "Unknown")
                return {"job": f"{namespace}/{name}",
                        "verdict": "NotQueued", "state": state,
                        "message": "the slice scheduler holds no pending "
                                   "gang-set for this job"}
        return None

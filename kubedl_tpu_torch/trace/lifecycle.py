"""Job-lifecycle phase spans.

The engine drives one :class:`JobLifecycleTracer` per workload kind: at
each reconcile it reports the job's *current phase* and the tracer turns
phase changes into spans under the job's (UID-derived) root trace —

``Created → Queuing → Admitted → PodsCreated → Rendezvous → Running →
Succeeded | Failed``

with ``Restarting`` (slice failover / preemption teardown rounds) and a
re-entry into ``Queuing``/``PodsCreated`` whenever a round loops back.
Each phase span runs from the moment the phase was entered to the moment
the next one began, so the concatenation of a job's phase spans IS its
critical path (``trace.analysis.trace_breakdown`` rolls them up).

The tracer synthesizes the initial ``Created`` phase from the job's
creationTimestamp: the first observed transition (usually ``Queuing`` or
``PodsCreated``) closes it, so queue-side time before the operator's
first reconcile is attributed, not lost.

Copied from ``kubedl_tpu/trace/lifecycle.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from .tracer import Tracer, job_trace_context

#: canonical phase vocabulary (docs/tracing.md); Restarting may interleave
PHASES = ("Created", "Queuing", "Admitted", "PodsCreated", "Rendezvous",
          "Running", "Restarting", "Succeeded", "Failed")
TERMINAL_PHASES = ("Succeeded", "Failed")


class _JobTrace:
    __slots__ = ("trace_id", "root_id", "key", "kind", "phase", "since",
                 "root_start", "attributes")

    def __init__(self, trace_id, root_id, key, kind, root_start):
        self.trace_id = trace_id
        self.root_id = root_id
        self.key = key
        self.kind = kind
        self.phase: Optional[str] = None
        self.since = root_start
        self.root_start = root_start
        self.attributes: dict = {}


class JobLifecycleTracer:
    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._jobs: dict[str, _JobTrace] = {}

    def transition(self, job: dict, phase: str, now: float,
                   attributes: Optional[dict] = None,
                   created_at: Optional[float] = None) -> None:
        """Report the job's current phase. Idempotent per phase: only a
        *change* closes the previous phase span. Terminal phases close
        the root span and drop the job's tracker entry."""
        if not self.tracer.enabled:
            return
        md = job.get("metadata") or {}
        uid = md.get("uid") or f"{md.get('namespace')}/{md.get('name')}"
        rec = self._jobs.get(uid)
        if rec is None:
            if phase in TERMINAL_PHASES and uid not in self._jobs:
                # already finalized (idempotent terminal reconciles)
                return
            trace_id, root_id = job_trace_context(job)
            start = created_at if created_at is not None else now
            rec = self._jobs[uid] = _JobTrace(
                trace_id, root_id,
                f"{md.get('namespace', '')}/{md.get('name', '')}",
                job.get("kind", ""), min(start, now))
            if phase != "Created":
                # synthesize the Created phase the operator never saw a
                # reconcile for: creation -> this first transition
                self._close(rec, "Created", rec.root_start, now)
        if rec.phase == phase:
            if attributes:
                rec.attributes.update(attributes)
            return
        if rec.phase is not None:
            self._close(rec, rec.phase, rec.since, now)
        rec.phase, rec.since = phase, now
        rec.attributes = dict(attributes or {})
        if phase in TERMINAL_PHASES:
            # terminal phases are points; the root span closes with them
            self._close(rec, phase, now, now)
            self.tracer.record(
                f"job {rec.key}", rec.root_start, now,
                trace_id=rec.trace_id, span_id=rec.root_id,
                component="lifecycle",
                status="error" if phase == "Failed" else "ok",
                attributes={"job": rec.key, "kind": rec.kind,
                            "terminal": phase})
            del self._jobs[uid]

    def _close(self, rec: _JobTrace, phase: str, start: float,
               end: float) -> None:
        self.tracer.record(
            phase, start, end, trace_id=rec.trace_id,
            parent_id=rec.root_id, component="lifecycle",
            attributes={"phase": phase, "job": rec.key, "kind": rec.kind,
                        **rec.attributes})

    def forget(self, uid: str) -> None:
        """Drop tracker state for a deleted job (spans stay in the ring)."""
        self._jobs.pop(uid, None)

    def current_phase(self, uid: str) -> Optional[str]:
        rec = self._jobs.get(uid)
        return rec.phase if rec else None


def derive_phase(status, pods, replicas, st, meta) -> str:
    """Map a job's reconciled state onto the phase vocabulary.

    ``st``/``meta`` are the ``utils.status`` / ``core.meta`` modules
    (passed in to keep this module import-light). Terminal and condition
    states win; below them the pod census separates pod creation
    (``PodsCreated``: not every pod object exists yet) from the PJRT
    rendezvous window (``Rendezvous``: pods exist, not all running)."""
    if st.is_failed(status):
        return "Failed"
    if st.is_succeeded(status):
        return "Succeeded"
    # Queuing outranks Restarting: a preempted job re-enters its queue
    # with BOTH conditions true, and its wall-clock there is queue wait
    # (the Restarting span keeps the teardown + recreation windows; the
    # restartRound attribute keeps the round accounting)
    if st.is_queuing(status):
        return "Queuing"
    if st.is_restarting(status):
        return "Restarting"
    total = sum(int(rs.replicas or 1) for rs in (replicas or {}).values())
    live = [p for p in (pods or []) if not meta.is_deleting(p)]
    active = sum(rs.active for rs in status.replica_statuses.values())
    if total and active >= total:
        return "Running"
    if total and len(live) >= total:
        return "Rendezvous"
    if st.is_running(status):
        return "Running"
    return "PodsCreated"

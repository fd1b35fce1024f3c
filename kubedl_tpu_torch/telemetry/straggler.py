"""Straggler / slow-slice detection from cross-replica step-time skew.

arxiv 2011.03641: step-time skew across TPU replicas is the dominant
concurrency limiter — one slow slice gates every synchronous step of the
gang. The trainer's ``train.step`` spans carry ``replica`` and
``tokens`` attributes (docs/tracing.md), so the operator can watch the
skew without any in-band signal: group recent step spans per replica,
compare each replica's p50 step time against the median of the OTHER
replicas' p50s (leave-one-out — an all-replica median is dragged up by
the straggler itself and can never flag a 2-slice gang), and when one
replica exceeds ``skew_factor ×`` that median, stamp a ``SlowSlice``
condition on the owning job plus a warning Event (once per skew onset —
repeated scans while the skew persists are idempotent). When the skew
stops (fresh fast steps push the slow window out, or the spans age out
of the ring), the condition flips ``False`` and a normal Event records
the resolution.

Copied from ``kubedl_tpu/telemetry/straggler.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Optional

from ..core.apiserver import Conflict, NotFound, ServerError
from ..core.events import Recorder, TYPE_NORMAL, TYPE_WARNING
from ..core.meta import rfc3339
from ..utils.stats import percentile

log = logging.getLogger("kubedl_tpu_torch.telemetry")

#: job condition type (lives beside Queuing/Restarting in
#: ``status.conditions``; the engine's condition state machine keeps
#: unknown types untouched, so SlowSlice survives engine reconciles)
JOB_SLOW_SLICE = "SlowSlice"
REASON_SLOW_SLICE = "SlowSliceDetected"
REASON_SLOW_SLICE_RESOLVED = "SlowSliceResolved"


class StragglerDetector:
    """``scan()`` is the whole surface: read the tracer ring, compute
    per-gang skew, reconcile SlowSlice conditions. Read-only except for
    the condition/Event writes; safe to call at any cadence (the
    telemetry driver rate-limits it)."""

    def __init__(self, api, tracer, recorder: Optional[Recorder] = None,
                 metrics=None, job_kinds=(), skew_factor: float = 2.0,
                 min_samples: int = 4, window: int = 32):
        self.api = api
        self.tracer = tracer
        self.recorder = recorder or Recorder(api)
        self.metrics = metrics
        self.job_kinds = tuple(job_kinds)
        self.skew_factor = float(skew_factor)
        self.min_samples = int(min_samples)
        self.window = int(window)
        #: trace_id -> {"job": ns/name, "slow": replica, ...} while flagged
        self._active: dict[str, dict] = {}

    # ------------------------------------------------------------------

    def scan(self) -> list:
        """One detection pass; returns the verdicts (flagged + cleared)
        for observability/tests."""
        spans = self.tracer.spans()
        steps: dict[str, dict] = {}            # tid -> replica -> deque
        jobs: dict[str, str] = {}              # tid -> "ns/name"
        for s in spans:
            job = s.attributes.get("job")
            if job and s.trace_id not in jobs:
                jobs[s.trace_id] = job
            if s.component == "train" and s.name == "train.step" \
                    and "replica" in s.attributes:
                per = steps.setdefault(s.trace_id, {})
                dq = per.setdefault(str(s.attributes["replica"]),
                                    deque(maxlen=self.window))
                dq.append(s.duration)
        verdicts = []
        for tid, per in steps.items():
            ready = {r: list(d) for r, d in per.items()
                     if len(d) >= self.min_samples}
            slow = []
            if len(ready) >= 2:
                p50s = {r: percentile(d, 0.5)
                        for r, d in sorted(ready.items())}
                for r, v in sorted(p50s.items()):
                    # leave-one-out: compare each replica against the
                    # median of the OTHERS — an all-replica median is
                    # dragged up by the straggler itself (for a 2-slice
                    # gang the nearest-rank median IS the slow replica,
                    # making detection impossible)
                    med = percentile([x for rr, x in p50s.items()
                                      if rr != r], 0.5)
                    if med > 0 and v > self.skew_factor * med:
                        slow.append((r, v, med))
            job_key = jobs.get(tid, "")
            if slow:
                replica, p50, med = slow[0]
                verdicts.append(self._flag(tid, job_key, replica, p50, med))
            elif tid in self._active:
                # also clears a flagged trace whose evidence degraded
                # below the >=2-ready-replicas bar (ring eviction, job
                # wind-down) — a stale SlowSlice must not outlive its data
                verdicts.append(self._clear(tid))
        # traces that vanished from the ring entirely (job deleted /
        # spans evicted): the skew evidence is gone, clear the flag
        for tid in [t for t in self._active if t not in steps]:
            verdicts.append(self._clear(tid))
        if self.metrics is not None:
            self.metrics.slow_slice_active.set(len(self._active))
        return [v for v in verdicts if v is not None]

    # ------------------------------------------------------------------

    def _flag(self, tid: str, job_key: str, replica: str, p50: float,
              median: float) -> Optional[dict]:
        already = tid in self._active
        self._active[tid] = {"job": job_key, "replica": replica}
        if already:
            return None                     # idempotent while skew persists
        msg = (f"replica {replica} step p50 {p50:.3f}s exceeds the gang "
               f"median {median:.3f}s by more than {self.skew_factor:g}x")
        kind, obj = self._find_job(job_key)
        if obj is not None:
            self._write_condition(kind, obj, "True", REASON_SLOW_SLICE, msg)
            self.recorder.event(obj, TYPE_WARNING, REASON_SLOW_SLICE, msg)
            if self.metrics is not None:
                self.metrics.slow_slices.inc(kind=kind)
        return {"trace": tid, "job": job_key, "verdict": "SlowSlice",
                "replica": replica, "p50": p50, "median": median}

    def _clear(self, tid: str) -> Optional[dict]:
        rec = self._active.pop(tid, None)
        if rec is None:
            return None
        kind, obj = self._find_job(rec["job"])
        msg = f"replica {rec['replica']} step times back within range"
        if obj is not None:
            self._write_condition(kind, obj, "False",
                                  REASON_SLOW_SLICE_RESOLVED, msg)
            self.recorder.event(obj, TYPE_NORMAL,
                                REASON_SLOW_SLICE_RESOLVED, msg)
        return {"trace": tid, "job": rec["job"], "verdict": "Resolved",
                "replica": rec["replica"]}

    # ------------------------------------------------------------------

    def _find_job(self, job_key: str):
        if "/" not in (job_key or ""):
            return "", None
        ns, name = job_key.split("/", 1)
        for kind in self.job_kinds:
            obj = self.api.try_get(kind, ns, name)
            if obj is not None:
                return kind, obj
        return "", None

    def _write_condition(self, kind: str, obj: dict, status: str,
                         reason: str, message: str) -> None:
        ns, name = (obj.get("metadata") or {}).get("namespace", "default"), \
            (obj.get("metadata") or {}).get("name", "")
        for _ in range(8):
            fresh = self.api.try_get(kind, ns, name)
            if fresh is None:
                return
            conds = fresh.setdefault("status", {}).setdefault(
                "conditions", [])
            cur = next((cd for cd in conds
                        if cd.get("type") == JOB_SLOW_SLICE), None)
            if cur is not None and cur.get("status") == status:
                return                      # already in the wanted state
            ts = rfc3339(self.api.now())
            cond = {"type": JOB_SLOW_SLICE, "status": status,
                    "reason": reason, "message": message,
                    "lastUpdateTime": ts, "lastTransitionTime": ts}
            if cur is not None:
                conds[conds.index(cur)] = cond
            else:
                conds.append(cond)
            try:
                self.api.update_status(fresh)
                return
            except Conflict:
                continue
            except (NotFound, ServerError) as e:
                log.warning("SlowSlice condition write %s/%s failed: %s",
                            ns, name, e)
                return
        log.warning("SlowSlice condition write %s/%s kept conflicting",
                    ns, name)

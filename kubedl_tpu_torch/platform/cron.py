"""Cron engine: scheduled instantiation of arbitrary workloads.

Capability mirror of reference ``controllers/apps`` + ``apis/apps/v1alpha1``:
a Cron CR embeds any workload (a raw object in ``spec.template.workload``)
and stamps out a fresh copy per schedule fire, with standard cron semantics —
concurrency policy Allow/Forbid/Replace, suspend, absolute deadline, history
limit (``cron_controller.go:109-200``). Training jobs carrying
``runPolicy.cronPolicy`` self-convert into one of these (the engine's
``_reconcile_cron``), so this controller is what actually runs them.

Copied from ``kubedl_tpu/platform/cron.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..core.apiserver import (AlreadyExists, APIServer, Conflict, Invalid,
                              NotFound)
from ..core.manager import Reconciler, Request, Result
from ..utils import cronschedule
from ..utils import status as st

DEFAULT_HISTORY_LIMIT = 10
# misses beyond this emit a warning and only the latest fires
# (kubernetes cronjob "TooManyMissedTimes" analog)
MAX_MISSED = 100


_parse_ts = m.parse_rfc3339


class CronReconciler(Reconciler):
    kind = "Cron"

    def __init__(self, api: APIServer, recorder=None, workload_kinds=()):
        self.api = api
        self.recorder = recorder
        # completion of spawned workloads routes back via their Cron owner ref
        self.owns = tuple(workload_kinds)

    def reconcile(self, req: Request) -> Optional[Result]:
        cron = self.api.try_get(self.kind, req.namespace, req.name)
        if cron is None or m.is_deleting(cron):
            return None
        now = self.api.now()
        status = copy.deepcopy(cron.get("status", {}) or {})
        actives = self._live_actives(cron, status)
        self._fold_finished_into_history(cron, status, actives)

        spec = cron.get("spec", {}) or {}
        result = None
        if not self._gated(cron, spec, now):
            result = self._schedule_next(cron, spec, status, actives, now)

        if cron.get("status") != status:
            cron["status"] = status
            try:
                self.api.update_status(cron)
            except (Conflict, NotFound):
                return Result(requeue=True)
        return result

    # ------------------------------------------------------------------

    def _live_actives(self, cron: dict, status: dict) -> list:
        """Resolve status.active refs to live workload objects, dropping
        refs to deleted workloads (listActiveWorkloads analog)."""
        live = []
        refs = status.get("active", []) or []
        kept = []
        for ref in refs:
            obj = self.api.try_get(ref.get("kind", ""), m.namespace(cron),
                                   ref.get("name", ""))
            if obj is not None:
                live.append(obj)
                kept.append(ref)
        status["active"] = kept
        return live

    def _fold_finished_into_history(self, cron: dict, status: dict,
                                    actives: list) -> None:
        """Finished workloads leave the active list and enter bounded
        history (refreshCronHistory + trimFinishedWorkloadsFromActiveList)."""
        history = status.get("history", []) or []
        known = {(h.get("object", {}).get("kind"), h.get("object", {}).get("name"))
                 for h in history}
        still_active = []
        for wl in actives:
            phase, finished = _workload_phase(wl)
            if not finished:
                still_active.append(wl)
                continue
            key = (m.kind(wl), m.name(wl))
            if key not in known:
                history.append({
                    "object": {"kind": m.kind(wl), "name": m.name(wl),
                               "apiGroup": m.api_version(wl).split("/")[0]},
                    "status": phase,
                    "created": m.meta(wl).get("creationTimestamp"),
                    "finished": m.get_in(wl, "status", "completionTime"),
                })
        status["active"] = [
            ref for ref in status.get("active", [])
            if ref.get("name") in {m.name(w) for w in still_active}]
        limit = m.get_in(cron, "spec", "historyLimit",
                         default=DEFAULT_HISTORY_LIMIT)
        history.sort(key=lambda h: h.get("created") or "")
        if limit is not None and len(history) > limit:
            # drop the oldest beyond the limit, and their objects with them
            # (limit may be 0 = keep nothing, so slice by count kept)
            drop = len(history) - limit
            for h in history[:drop]:
                obj = h.get("object", {})
                try:
                    self.api.delete(obj.get("kind", ""), m.namespace(cron),
                                    obj.get("name", ""))
                except NotFound:
                    pass
            history = history[drop:]
        status["history"] = history
        actives[:] = still_active

    def _gated(self, cron: dict, spec: dict, now: float) -> bool:
        if spec.get("suspend"):
            return True
        deadline = _parse_ts(spec.get("deadline"))
        if deadline is not None and now > deadline:
            self._event(cron, "Normal", "Deadline",
                        "cron has reached deadline and stopped scheduling")
            return True
        return False

    def _schedule_next(self, cron: dict, spec: dict, status: dict,
                       actives: list, now: float) -> Optional[Result]:
        try:
            sched = cronschedule.parse(spec.get("schedule", ""))
            earliest = (_parse_ts(status.get("lastScheduleTime"))
                        or _parse_ts(m.meta(cron).get("creationTimestamp"))
                        or now)
            fire, missed = None, 0
            t = earliest
            while True:
                nxt = sched.next_after(t)
                if nxt > now:
                    break
                fire, t = nxt, nxt
                missed += 1
                if missed > MAX_MISSED:
                    # long outage: skip the backlog entirely and resync so
                    # the cron keeps living (kubernetes "TooManyMissedTimes")
                    self._event(cron, "Warning", "TooManyMissedTimes",
                                f"too many missed start times "
                                f"(> {MAX_MISSED}); skipping the backlog")
                    fire = None
                    status["lastScheduleTime"] = m.rfc3339(now)
                    break

            next_wake = sched.next_after(now) - now
        except cronschedule.InvalidSchedule as e:
            # user error (unparseable, or parseable-but-unsatisfiable like
            # "0 0 30 2 *"): warn and wait for a spec update, don't retry-loop
            self._event(cron, "Warning", "InvalidSchedule",
                        f"invalid schedule {spec.get('schedule')!r}: {e}")
            return None
        if fire is None:
            return Result(requeue_after=max(next_wake, 1.0))

        policy = spec.get("concurrencyPolicy") or c.CONCURRENCY_ALLOW
        if policy == c.CONCURRENCY_FORBID and actives:
            self._event(cron, "Normal", "AlreadyActive",
                        "not starting: prior execution still running and "
                        "concurrency policy is Forbid")
            status["lastScheduleTime"] = m.rfc3339(fire)
            return Result(requeue_after=max(next_wake, 1.0))
        if policy == c.CONCURRENCY_REPLACE:
            for wl in actives:
                try:
                    self.api.delete(m.kind(wl), m.namespace(wl), m.name(wl))
                except NotFound:
                    pass
            status["active"] = []

        created = self._spawn_workload(cron, spec, fire)
        if created is not None:
            status.setdefault("active", []).append({
                "apiVersion": m.api_version(created),
                "kind": m.kind(created),
                "namespace": m.namespace(created),
                "name": m.name(created),
                "uid": m.uid(created),
            })
        status["lastScheduleTime"] = m.rfc3339(fire)
        return Result(requeue_after=max(next_wake, 1.0))

    def _spawn_workload(self, cron: dict, spec: dict,
                        fire: float) -> Optional[dict]:
        template = m.get_in(spec, "template", "workload")
        if not template:
            self._event(cron, "Warning", "EmptyTemplate",
                        "cron has no spec.template.workload")
            return None
        wl = copy.deepcopy(template)
        wmeta = wl.setdefault("metadata", {})
        # unique per fire time (getDefaultJobName analog)
        wmeta["name"] = f"{m.name(cron)}-{int(fire)}"
        wmeta["namespace"] = m.namespace(cron)
        lbls = wmeta.setdefault("labels", {})
        lbls[c.LABEL_CRON_NAME] = m.name(cron)
        m.set_controller_ref(wl, cron)
        try:
            created = self.api.create(wl)
        except AlreadyExists:
            return None  # this fire already spawned (idempotent re-run)
        except Invalid as e:
            # template rejected by admission: surface it and move on —
            # retry-looping would hammer the api-server every backoff tick
            # with the same doomed create until the user edits the Cron
            self._event(cron, "Warning", "InvalidWorkloadTemplate", str(e))
            return None
        self._event(cron, "Normal", "SuccessfulCreate",
                    f"created {m.kind(wl)} {wmeta['name']}")
        return created

    def _event(self, cron, etype, reason, msg):
        if self.recorder is not None:
            self.recorder.event(cron, etype, reason, msg)


def _workload_phase(wl: dict) -> tuple:
    """(phase, finished) from the workload's condition state machine
    (cron_utils.go IsWorkloadFinished)."""
    from ..api.common import JobStatus
    status = JobStatus.from_dict(wl.get("status"))
    if st.is_succeeded(status):
        return c.JOB_SUCCEEDED, True
    if st.is_failed(status):
        return c.JOB_FAILED, True
    return c.JOB_RUNNING, False

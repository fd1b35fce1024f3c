"""Job-condition state machine.

Behavioral port of the reference's ``pkg/util/status.go:26-146``: a job's
``status.conditions`` list holds at most one condition per type; Running and
Restarting are mutually exclusive; reaching Failed freezes the machine;
reaching a terminal state flips Running to ``False``; ``lastTransitionTime``
only moves when the condition's status actually changes.

Copied from ``kubedl_tpu/utils/status.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..api import common as c
from ..api.common import JobCondition, JobStatus
from ..core.meta import rfc3339

REASON_JOB_CREATED = "JobCreated"
REASON_JOB_QUEUING = "JobQueuing"
REASON_JOB_SUCCEEDED = "JobSucceeded"
REASON_JOB_RUNNING = "JobRunning"
REASON_JOB_FAILED = "JobFailed"
REASON_JOB_RESTARTING = "JobRestarting"
REASON_JOB_EVICTED = "JobEvicted"
#: event reason stamped when every gang pod reports Running — the
#: timestamp that bounds PJRT rendezvous latency (docs/tracing.md)
REASON_RENDEZVOUS_READY = "RendezvousReady"


def get_condition(status: JobStatus, cond_type: str) -> Optional[JobCondition]:
    for cond in status.conditions:
        if cond.type == cond_type:
            return cond
    return None


def has_condition(status: JobStatus, cond_type: str) -> bool:
    return any(cd.type == cond_type and cd.status == "True" for cd in status.conditions)


def is_succeeded(status: JobStatus) -> bool:
    return has_condition(status, c.JOB_SUCCEEDED)


def is_failed(status: JobStatus) -> bool:
    return has_condition(status, c.JOB_FAILED)


def is_running(status: JobStatus) -> bool:
    return has_condition(status, c.JOB_RUNNING)


def is_created(status: JobStatus) -> bool:
    return has_condition(status, c.JOB_CREATED)


def is_restarting(status: JobStatus) -> bool:
    return has_condition(status, c.JOB_RESTARTING)


def is_queuing(status: JobStatus) -> bool:
    return has_condition(status, c.JOB_QUEUING)


def is_evicted(status: JobStatus) -> bool:
    cond = get_condition(status, c.JOB_FAILED)
    return bool(cond and cond.reason == REASON_JOB_EVICTED)


def is_finished(status: JobStatus) -> bool:
    return is_succeeded(status) or is_failed(status)


def update_job_conditions(status: JobStatus, cond_type: str, reason: str,
                          message: str, now: Optional[float] = None) -> None:
    ts = rfc3339(now)
    cond = JobCondition(type=cond_type, status="True", reason=reason,
                       message=message, last_update_time=ts,
                       last_transition_time=ts)
    _set_condition(status, cond)


def _set_condition(status: JobStatus, condition: JobCondition) -> None:
    if is_failed(status):  # Failed is a frozen terminal state
        return
    current = get_condition(status, condition.type)
    if current is not None and current.status == condition.status and current.reason == condition.reason:
        return
    if current is not None and current.status == condition.status:
        condition.last_transition_time = current.last_transition_time
    status.conditions = _filter_out(status.conditions, condition.type) + [condition]


def _filter_out(conditions: list, cond_type: str) -> list:
    out = []
    for cond in conditions:
        if cond_type == c.JOB_RESTARTING and cond.type == c.JOB_RUNNING:
            continue
        if cond_type == c.JOB_RUNNING and cond.type == c.JOB_RESTARTING:
            continue
        if cond.type == cond_type:
            continue
        if cond_type in (c.JOB_FAILED, c.JOB_SUCCEEDED) and cond.type == c.JOB_RUNNING:
            cond = JobCondition(**{**cond.__dict__, "status": "False"})
        # leaving the queue (running/restarting/terminal) ends Queuing
        if cond_type in (c.JOB_RUNNING, c.JOB_RESTARTING, c.JOB_FAILED,
                         c.JOB_SUCCEEDED) and cond.type == c.JOB_QUEUING \
                and cond.status == "True":
            cond = JobCondition(**{**cond.__dict__, "status": "False"})
        out.append(cond)
    return out

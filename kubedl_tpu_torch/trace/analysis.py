"""Critical-path analysis over one trace's spans.

:func:`trace_breakdown` rolls a job's lifecycle spans into the per-phase
latency table the console serves (``/api/v1/trace/{ns}/{job}``): where
did startup time go — queue wait vs pod creation vs PJRT rendezvous vs
run — plus restart-round accounting and orphan detection (a span whose
parent is missing from the trace means a component recorded against a
context nobody opened: an instrumentation bug, surfaced instead of
silently mis-rooted).

Copied from ``kubedl_tpu/trace/analysis.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Iterable, Optional

from .tracer import Span


def find_orphans(spans: Iterable[Span]) -> list:
    """Spans whose ``parent_id`` names no span in the set.

    One shared missing parent is exempt when no root (parentless) span
    exists yet: a *live* job's children all hang off the deterministic
    root that only gets recorded at terminal — that is the designed
    in-flight shape, not an orphan."""
    spans = list(spans)
    ids = {s.span_id for s in spans}
    has_root = any(s.parent_id is None for s in spans)
    missing = [s for s in spans
               if s.parent_id is not None and s.parent_id not in ids]
    if not has_root:
        implicit = {s.parent_id for s in missing}
        if len(implicit) == 1 and len(missing) == len(spans):
            return []
    return missing


def trace_breakdown(spans: Iterable[Span],
                    trace_id: Optional[str] = None,
                    dropped: int = 0) -> dict:
    """Per-phase critical path for one trace.

    Returns the chronologically ordered phase spans (``phases``), the
    aggregate seconds per phase name (``byPhase`` — restart rounds
    repeat phases, so e.g. two Queuing stints sum), the root span when
    recorded, non-lifecycle child spans (``events``: scheduler
    queue-wait, preemptions, reconciles attached to the trace), and the
    orphan list (must be empty for a healthy trace).

    ``dropped`` is the recorder's overflow counter
    (:attr:`~kubedl_tpu_torch.trace.Tracer.dropped`): when a long replay wraps
    the bounded ring buffer, parents of surviving spans may have been
    evicted — the breakdown stays well-formed, and a non-zero
    ``droppedSpans`` field tells the reader the listed orphans are
    attributable to eviction rather than an instrumentation bug."""
    spans = list(spans)
    if trace_id is None and spans:
        # infer from the first span AND filter by it: a recorder ring
        # holds many concurrent jobs' spans interleaved, and folding a
        # second trace's phases into the first's byPhase silently
        # corrupts the breakdown (goodput reads these numbers)
        trace_id = spans[0].trace_id
    spans = [s for s in spans if s.trace_id == trace_id]
    phases = sorted(
        (s for s in spans
         if s.component == "lifecycle" and "phase" in s.attributes),
        key=lambda s: (s.start, s.end))
    root = next((s for s in spans
                 if s.parent_id is None and s.component == "lifecycle"),
                None)
    by_phase: dict[str, float] = {}
    for s in phases:
        name = s.attributes["phase"]
        by_phase[name] = by_phase.get(name, 0.0) + s.duration
    events = [s for s in spans if s not in phases and s is not root]
    total = (root.duration if root is not None
             else (phases[-1].end - phases[0].start if phases else 0.0))
    return {
        "traceId": trace_id or "",
        "root": root.to_dict() if root is not None else None,
        "phases": [s.to_dict() for s in phases],
        "byPhase": {k: round(v, 9) for k, v in sorted(by_phase.items())},
        "events": [s.to_dict() for s in events],
        "totalSeconds": round(total, 9),
        "spanCount": len(spans),
        "orphans": [s.to_dict() for s in find_orphans(spans)],
        "droppedSpans": int(dropped),
    }


def restart_windows(phases: list) -> list:
    """``(start, end)`` of every ``Restarting`` phase span in a
    breakdown's ``phases`` list — the restart-round stream the incident
    timeline merges (docs/forensics.md). Kept beside
    :func:`restart_mttrs` so the forensics layer and the MTTR signal
    read the same spans, one derivation each."""
    return [(p["start"], p["end"]) for p in phases
            if p["name"] == "Restarting"]


def restart_mttrs(phases: list) -> list:
    """Trace-derived restart-MTTR samples from a breakdown's ``phases``
    list: for each outage (first ``Restarting`` phase span after a
    ``Running``), seconds until the next ``Running`` phase begins.
    Phases arrive chronologically from :func:`trace_breakdown`. Shared
    by the cluster replay's scorecard leg and the SLO engine's
    ``restart_mttr`` signal — one derivation, one number."""
    out = []
    outage_start = None
    for p in phases:
        if p["name"] == "Restarting" and outage_start is None:
            outage_start = p["start"]
        elif p["name"] == "Running" and outage_start is not None:
            out.append(p["start"] - outage_start)
            outage_start = None
    return out


def assert_well_formed(spans: Iterable[Span]) -> None:
    """Raise AssertionError when the trace has orphans or its phase
    spans are not monotonically ordered (each phase must start no
    earlier than the one before it) — the e2e acceptance contract."""
    spans = list(spans)
    orphans = find_orphans(spans)
    if orphans:
        raise AssertionError(
            f"{len(orphans)} orphan span(s): "
            f"{[(s.name, s.parent_id) for s in orphans]}")
    phases = sorted(
        (s for s in spans
         if s.component == "lifecycle" and "phase" in s.attributes),
        key=lambda s: (s.start, s.end))
    for prev, cur in zip(phases, phases[1:]):
        if cur.start < prev.start or cur.start < prev.end - 1e-9:
            raise AssertionError(
                f"phase spans out of order: {prev.name} "
                f"[{prev.start}, {prev.end}] then {cur.name} "
                f"[{cur.start}, {cur.end}]")

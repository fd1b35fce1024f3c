"""One time-ordered incident stream, with pages causally linked to faults.

The adversarial day produces four disjoint records of what happened: the
campaign's fault script (:class:`~kubedl_tpu_torch.chaos.campaign.Campaign`),
the SLO evaluator's alert transitions (``SLOEvaluator.alert_log``), the
chaos injector's preemption ledger, and the lifecycle traces' restart
rounds. An operator doing a postmortem today hand-correlates them. The
:class:`IncidentTimeline` merges them into one stream and then does the
correlation mechanically (docs/forensics.md "causal-linking rules"):

* **fault windows** — ``_start``/``_end`` primitive pairs become one
  window ``[start, end]``; instantaneous primitives (``domain_outage``,
  ``drain``, ``hot_loop``) are point windows at their action time.
* **incidents** — each alert ``fire`` opens an incident for its
  ``(slo, severity)``, the matching ``clear`` closes it.
* **links** — a page is linked to a fault by (strongest first):

  1. ``preempted-sample``: a bad sample inside the page's long burn
     window names a job (``labels.job``) that a campaign primitive
     preempted at or before the fire — the sample chain from the page
     back through the bleeding job to the fault that hit it.
  2. ``window-overlap``: the fault window intersects the page's burn
     window ``[fire - longSeconds, fire]``.
  3. ``lagged``: the fault window closed before the burn window opened
     but within ``lag_horizon_s`` of it — queued/delayed work surfaces
     its bad samples (retirement-time signals like ``queue_delay``)
     after the fault itself is over, so the effect trails the cause.

All times are sim-relative seconds (callers pass ``epoch`` — the sim
clock's ``t0`` — and absolute inputs are normalized), so the built
document is bit-for-bit deterministic for a fixed seed.

Copied from ``kubedl_tpu/forensics/timeline.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

#: primitives whose _start/_end pairs bound a window; everything else
#: is a point fault at its action time. ``region_down`` ends carry the
#: region param (like ``spot_dry_end`` names its pool), so two staggered
#: region outages pair by region instead of LIFO-swapping attribution.
_WINDOW_PRIMITIVES = ("spot_dry", "watch_storm", "slow_fsync",
                      "region_down")

#: how long a closed fault window keeps explaining later bad samples
#: (rule 3): retirement-time signals report a fault's damage when the
#: delayed job finally retires, long after the fault cleared
DEFAULT_LAG_HORIZON_S = 2.0 * 3600.0

#: point actions of one primitive spaced at most this far apart merge
#: into one fault window: a rolling drain is four spaced ``drain``
#: actions and a hot-looping controller is a 15s-interval ``hot_loop``
#: train — one correlated event each, not twenty separate links
POINT_COALESCE_GAP_S = 600.0


def _r(t: Optional[float], nd: int = 3) -> Optional[float]:
    return None if t is None else round(float(t), nd)


class IncidentTimeline:
    """Accumulates the four source streams, then :meth:`build`\\ s the
    merged document. Feed methods are independent — a live operator
    without a campaign feeds only alerts, and its incidents simply
    carry no fault links."""

    def __init__(self, epoch: float = 0.0,
                 lag_horizon_s: float = DEFAULT_LAG_HORIZON_S):
        #: absolute-time inputs (alert log, samples, restarts) are
        #: normalized to sim-relative seconds by subtracting this
        self.epoch = float(epoch)
        self.lag_horizon_s = float(lag_horizon_s)
        self._actions: list = []      # {"t", "primitive", "params"}
        self._windows: list = []      # {"primitive","start","end","params"}
        self._alerts: list = []       # normalized alert_log entries
        self._preemptions: list = []  # {"t", "job", "primitive"}
        self._restarts: list = []     # {"t", "end", "job"}
        self._bad_samples: list = []  # normalized evaluator bad samples
        self._alerting: dict = {}     # slo -> {severity: (short, long)}

    # -- feeds -------------------------------------------------------------

    def add_campaign(self, campaign) -> None:
        """Fold a compiled campaign's actions in; ``_start``/``_end``
        pairs are matched in time order per primitive (an unmatched
        ``_start`` window stays open to the end of time)."""
        open_starts: dict = {}
        for a in campaign.actions:
            self._actions.append({"t": _r(a.time_s),
                                  "primitive": a.primitive,
                                  "params": [list(p) for p in a.params]})
            base = None
            for w in _WINDOW_PRIMITIVES:
                if a.primitive == f"{w}_start":
                    open_starts.setdefault(w, []).append(a)
                    base = w
                    break
                if a.primitive == f"{w}_end":
                    stack = open_starts.get(w) or []
                    # pair with the newest start TARGETING THE SAME
                    # THING: spot_dry_end names its pool, and two
                    # overlapping pools' windows must not swap
                    # attribution. Ends without params (watch_storm)
                    # fall back to LIFO, matching the runner's stacks.
                    idx = None
                    end_params = dict(a.params)
                    if end_params:
                        for i in range(len(stack) - 1, -1, -1):
                            sp = dict(stack[i].params)
                            if all(sp.get(k) == v
                                   for k, v in end_params.items()):
                                idx = i
                                break
                    if idx is None and stack:
                        idx = len(stack) - 1
                    start = stack.pop(idx) if idx is not None else None
                    self._windows.append({
                        "primitive": w,
                        "start": _r(start.time_s if start else 0.0),
                        "end": _r(a.time_s),
                        "params": [list(p) for p in
                                   (start.params if start else a.params)],
                        "actions": 2,
                    })
                    base = w
                    break
            if base is None:
                prev = next((w for w in reversed(self._windows)
                             if w["primitive"] == a.primitive), None)
                if prev is not None and prev["end"] is not None \
                        and a.time_s - prev["end"] \
                        <= POINT_COALESCE_GAP_S:
                    # same-primitive action train: widen the window
                    prev["end"] = _r(a.time_s)
                    prev["actions"] = prev.get("actions", 1) + 1
                else:
                    self._windows.append({
                        "primitive": a.primitive,
                        "start": _r(a.time_s), "end": _r(a.time_s),
                        "params": [list(p) for p in a.params],
                        "actions": 1,
                    })
        for w, stack in sorted(open_starts.items()):
            for start in stack:       # never-closed window: open-ended
                self._windows.append({
                    "primitive": w, "start": _r(start.time_s),
                    "end": None,
                    "params": [list(p) for p in start.params],
                    "actions": 1,
                })
        self._windows.sort(key=lambda w: (w["start"], w["primitive"]))

    def add_alert_log(self, alert_log, specs: Optional[dict] = None) -> None:
        """Fold the evaluator's transition history in. ``specs`` maps
        slo name -> :class:`~kubedl_tpu_torch.api.slo.SLOSpec`, used to
        resolve each severity's burn-window widths for linking."""
        for a in alert_log:
            self._alerts.append({
                "t": _r(a["t"] - self.epoch),
                "slo": a["slo"], "severity": a["severity"],
                "event": a["event"],
                "shortBurn": _r(a.get("shortBurn"), 6),
                "longBurn": _r(a.get("longBurn"), 6),
            })
        for name, spec in (specs or {}).items():
            self._alerting[name] = {
                w.severity: (w.short_s, w.long_s)
                for w in spec.alerting}

    def add_preemptions(self, preemption_log) -> None:
        """``[{"t", "job", "primitive"}]`` — the campaign runner's
        per-gang eviction log (absolute times normalized)."""
        for p in preemption_log:
            self._preemptions.append({
                "t": _r(p["t"] - self.epoch),
                "job": p["job"], "primitive": p["primitive"]})

    def add_restarts(self, restart_windows) -> None:
        """``[(start, end, job)]`` restart rounds harvested from
        lifecycle traces (absolute times normalized)."""
        for start, end, job in restart_windows:
            self._restarts.append({
                "t": _r(start - self.epoch),
                "end": _r(end - self.epoch), "job": job})

    def add_bad_samples(self, samples) -> None:
        """The evaluator's bad-sample attribution log
        (``SLOEvaluator.bad_samples``): which sample burned which
        objective, carrying the sample's labels (``job`` when the
        feeder stamped one)."""
        for s in samples:
            self._bad_samples.append({
                "t": _r(s["t"] - self.epoch), "slo": s["slo"],
                "signal": s["signal"], "value": _r(s["value"]),
                "job": (s.get("labels") or {}).get("job", ""),
            })

    # -- linking -----------------------------------------------------------

    def _burn_window(self, slo: str, severity: str,
                     fired_at: float) -> tuple:
        pair = (self._alerting.get(slo) or {}).get(severity)
        long_s = pair[1] if pair else 3600.0
        return fired_at - long_s, fired_at

    def _link_page(self, slo: str, severity: str,
                   fired_at: float) -> list:
        lo, hi = self._burn_window(slo, severity, fired_at)
        links = []
        seen = set()

        def add(rule: str, window: dict, jobs=()):
            key = (window["primitive"], window["start"])
            if key in seen:
                for lk in links:
                    if (lk["primitive"], lk["windowStart"]) == key:
                        lk["evidenceJobs"] = sorted(
                            set(lk["evidenceJobs"]) | set(jobs))
                        return
            seen.add(key)
            links.append({
                "rule": rule, "primitive": window["primitive"],
                "windowStart": window["start"],
                "windowEnd": window["end"],
                "evidenceJobs": sorted(jobs),
            })

        # rule 1: bad samples in the burn window -> preempted jobs ->
        # the primitive that evicted them (strongest: a named chain)
        burned_jobs = {s["job"] for s in self._bad_samples
                       if s["slo"] == slo and s["job"]
                       and lo <= s["t"] <= hi}
        if burned_jobs:
            hits = [p for p in self._preemptions
                    if p["job"] in burned_jobs and p["t"] <= hi]
            # evidence sticks to the NEAREST PRECEDING window of the
            # evicting primitive — not to every train of it (a second
            # train hours later never touched this job). Nearest-
            # preceding rather than strict containment because the
            # eviction lands when the event loop executes the action,
            # which can trail the scripted window by a tick.
            jobs_by_window: dict = {}
            for p in hits:
                best = None
                for i, w in enumerate(self._windows):
                    if w["primitive"] == p["primitive"] \
                            and w["start"] <= p["t"] + 1e-3 \
                            and (best is None or w["start"]
                                 > self._windows[best]["start"]):
                        best = i
                if best is not None:
                    jobs_by_window.setdefault(best, set()).add(p["job"])
            for i, jobs in sorted(jobs_by_window.items()):
                w = self._windows[i]
                if w["start"] <= hi:
                    add("preempted-sample", w, jobs)
        # rule 2: fault window intersects the burn window
        for w in self._windows:
            end = hi if w["end"] is None else w["end"]
            if w["start"] <= hi and end >= lo:
                add("window-overlap", w)
        # rule 3: fault closed before the burn window opened, but the
        # effect (queued/delayed work retiring late) trails the cause
        for w in self._windows:
            end = w["end"]
            if end is not None and end < lo \
                    and end + self.lag_horizon_s >= lo:
                add("lagged", w)
        links.sort(key=lambda lk: (
            ("preempted-sample", "window-overlap",
             "lagged").index(lk["rule"]),
            lk["windowStart"], lk["primitive"]))
        return links

    # -- build -------------------------------------------------------------

    def build(self) -> dict:
        """The merged document: ``entries`` (time-ordered stream of
        fault / preemption / restart / alert records) and ``incidents``
        (one per alert onset, page severities carrying their causal
        fault links)."""
        entries = []
        for a in self._actions:
            entries.append({"t": a["t"], "type": "fault",
                            "primitive": a["primitive"],
                            "params": a["params"]})
        for p in self._preemptions:
            entries.append({"t": p["t"], "type": "preemption",
                            "job": p["job"],
                            "primitive": p["primitive"]})
        for r in self._restarts:
            entries.append({"t": r["t"], "type": "restart",
                            "job": r["job"],
                            "durationS": _r(r["end"] - r["t"])})
        for a in self._alerts:
            entries.append({"t": a["t"], "type": "alert",
                            "slo": a["slo"], "severity": a["severity"],
                            "event": a["event"],
                            "shortBurn": a["shortBurn"],
                            "longBurn": a["longBurn"]})
        entries.sort(key=lambda e: (e["t"], e["type"],
                                    e.get("slo", ""), e.get("job", ""),
                                    e.get("primitive", "")))

        incidents = []
        open_fires: dict = {}
        for a in self._alerts:
            key = (a["slo"], a["severity"])
            if a["event"] == "fire":
                inc = {
                    "slo": a["slo"], "severity": a["severity"],
                    "firedAt": a["t"], "clearedAt": None,
                    "durationS": None,
                    "shortBurn": a["shortBurn"],
                    "longBurn": a["longBurn"],
                    "links": (self._link_page(a["slo"], a["severity"],
                                              a["t"])
                              if a["severity"] == "page" else []),
                }
                lo, hi = self._burn_window(a["slo"], a["severity"],
                                           a["t"])
                inc["badSamplesInWindow"] = sum(
                    1 for s in self._bad_samples
                    if s["slo"] == a["slo"] and lo <= s["t"] <= hi)
                open_fires.setdefault(key, []).append(inc)
                incidents.append(inc)
            elif a["event"] == "clear":
                stack = open_fires.get(key) or []
                if stack:
                    inc = stack.pop(0)
                    inc["clearedAt"] = a["t"]
                    inc["durationS"] = _r(a["t"] - inc["firedAt"])
        incidents.sort(key=lambda i: (i["firedAt"], i["slo"],
                                      i["severity"]))
        pages = [i for i in incidents if i["severity"] == "page"]
        return {
            "entries": entries,
            "incidents": incidents,
            "summary": {
                "entries": len(entries),
                "faults": len(self._actions),
                "fault_windows": len(self._windows),
                "preemptions": len(self._preemptions),
                "restart_rounds": len(self._restarts),
                "bad_samples": len(self._bad_samples),
                "incidents": len(incidents),
                "pages": len(pages),
                "pages_linked": sum(1 for p in pages if p["links"]),
                "pages_unlinked": sum(1 for p in pages
                                      if not p["links"]),
                "links_total": sum(len(p["links"]) for p in pages),
                "unresolved_incidents": sum(
                    1 for i in incidents if i["clearedAt"] is None),
            },
        }

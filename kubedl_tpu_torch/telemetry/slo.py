"""The SLO engine: error budgets + multi-window multi-burn-rate alerts.

The judgment layer over the traces and metrics (docs/slo.md): operators declare
objectives as cluster-scoped :mod:`SLO <kubedl_tpu_torch.api.slo>` objects
("99% of serving requests see TTFT <= 30s over 30 days"); the evaluator
samples the named signal into per-SLO sliding windows, tracks how much
of the error budget the fleet has burned, and runs the Google-SRE
multi-window multi-burn-rate recipe: an alert pair fires only when the
burn rate over BOTH its short and long window reaches the pair's
threshold (the long window keeps one bad blip from paging, the short
window resets the alert quickly once the bleeding stops). Defaults: a
fast 5m/1h pair paging at 14.4x budget pace, a slow 6h/3d pair
ticketing at 1x.

Definitions (samples are good/bad against the objective's target)::

    bad_fraction(w)  = bad(w) / total(w)          over window w
    burn_rate(w)     = bad_fraction(w) / (1 - goal)
    budget_consumed  = burn_rate(compliance window)    # 1.0 = all spent
    compliance       = good(window) / total(window)

Alert lifecycle is idempotent like the straggler SlowSlice: one
``SLOBudgetBurn`` Event + a True ``SLOBurnRate`` condition per onset
(repeated evaluations while the burn persists write nothing), a
``SLOBudgetRecovered`` Event + a False condition when it clears.
``kubedl_slo_*`` metric families track budget remaining, live burn
rates, and alert onsets.

Signal transport is push: the retirement harvest feeds job signals
(``queue_delay``, ``restart_mttr``) from lifecycle traces, the request
span harvester feeds serving signals (``ttft``, ``queue``), and gauge /
registry-metric signals are sampled on each evaluation tick. Everything
runs on the injected clock — sim-clock replays produce bit-for-bit
identical verdicts.

Copied from ``kubedl_tpu/telemetry/slo.py`` (the port imports nothing of the
JAX package); the API error family comes from the port's ``core/kubeclient``.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import deque
from typing import Optional

from ..api.slo import SLO_KIND, SLOSpec
from ..core.kubeclient import ApiError, Conflict, NotFound, ServerError
from ..core.events import TYPE_NORMAL, TYPE_WARNING
from ..core.meta import rfc3339

log = logging.getLogger("kubedl_tpu_torch.telemetry")

#: condition type the evaluator maintains on the SLO object
SLO_BURN_RATE = "SLOBurnRate"
REASON_SLO_BURN = "SLOBudgetBurn"
REASON_SLO_RECOVERED = "SLOBudgetRecovered"


class _RateWindow:
    """A sliding good/bad rate window with O(1) aggregates and bounded
    memory: samples aggregate into time buckets of ``horizon/256``
    (floored at 1s), so a 30-day compliance window over a 50k-samples/
    day serving signal holds ~257 counters, not 1.5M tuples. Eviction
    granularity is one bucket — a sample may outlive the horizon by up
    to one bucket width, which is well inside the precision any
    burn-rate threshold carries."""

    __slots__ = ("horizon", "width", "buckets", "total", "bad")

    def __init__(self, horizon: float):
        self.horizon = float(horizon)
        self.width = max(self.horizon / 256.0, 1.0)
        self.buckets: deque = deque()     # [bucket_start, total, bad]
        self.total = 0
        self.bad = 0

    def add(self, t: float, bad: bool) -> None:
        start = math.floor(t / self.width) * self.width
        if self.buckets and self.buckets[-1][0] >= start:
            rec = self.buckets[-1]        # same (or late-arriving) bucket
        else:
            rec = [start, 0, 0]
            self.buckets.append(rec)
        rec[1] += 1
        self.total += 1
        if bad:
            rec[2] += 1
            self.bad += 1

    def prune(self, now: float) -> None:
        cutoff = now - self.horizon
        bq = self.buckets
        while bq and bq[0][0] + self.width <= cutoff:
            _, tot, bad = bq.popleft()
            self.total -= tot
            self.bad -= bad

    def bad_fraction(self) -> Optional[float]:
        return self.bad / self.total if self.total else None


class _SLOState:
    """One SLO's live window set + alert state."""

    __slots__ = ("spec", "windows", "firing", "fired")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        horizons = {spec.window_s}
        for w in spec.alerting:
            horizons.add(w.short_s)
            horizons.add(w.long_s)
        self.windows = {h: _RateWindow(h) for h in sorted(horizons)}
        self.firing: dict[str, bool] = {w.severity: False
                                        for w in spec.alerting}
        self.fired: dict[str, int] = {w.severity: 0
                                      for w in spec.alerting}

    def add(self, t: float, bad: bool) -> None:
        for w in self.windows.values():
            w.add(t, bad)

    def prune(self, now: float) -> None:
        for w in self.windows.values():
            w.prune(now)

    def burn_rate(self, horizon: float) -> Optional[float]:
        frac = self.windows[horizon].bad_fraction()
        return None if frac is None else frac / self.spec.budget


class RequestSpanHarvester:
    """Incremental serving-signal extraction from request spans.

    Feed it tracer snapshots; it yields ``(signal, value, t)`` samples:
    ``queue`` = each non-resumed ``request.queue`` span's duration,
    ``ttft`` = first queue-start to first ``request.prefill`` end per
    trace (the same derivation the serving replay and the console use).
    Spans already seen are skipped (dedup by span id; with ``prune``
    on — the long-lived-operator default — bookkeeping is pruned
    against the ring's oldest surviving span so the state stays
    bounded). A consumer that CLEARS the ring between feeds (the
    serving replay) must pass ``prune=False``: there the oldest
    surviving span says nothing about which requests are still
    in flight."""

    def __init__(self, prune: bool = True):
        self._prune = bool(prune)
        self._seen: dict[str, float] = {}    # span_id -> end
        self._qstart: dict[str, float] = {}  # trace_id -> first queue start
        self._done: dict[str, float] = {}    # trace_id -> ttft-emitted at
        #: prune=False bookkeeping: trace -> its _seen span ids, freed
        #: when the request's root span completes (without ring-age
        #: pruning the state would otherwise grow for the whole run)
        self._trace_spans: dict[str, list] = {}

    def feed(self, spans) -> list:
        """``(signal, value, t)`` samples (the public shape); a
        consumer that needs to attribute samples to requests (the
        multi-model replay's per-model SLO labels) uses
        :meth:`feed_traced` instead."""
        return [(sig, v, t) for sig, v, t, _ in self.feed_traced(spans)]

    def feed_traced(self, spans) -> list:
        """:meth:`feed` plus attribution: ``(signal, value, t,
        trace_id)`` — same dedup, same derivations, the trace id is
        the request's root id so a consumer holding a trace→model map
        can label samples per model (docs/multimodel.md)."""
        out = []
        for s in spans:
            if s.span_id in self._seen:
                continue
            if s.name == "request.queue":
                self._seen[s.span_id] = s.end
                if not self._prune:
                    self._trace_spans.setdefault(
                        s.trace_id, []).append(s.span_id)
                if s.attributes.get("resumed"):
                    continue
                out.append(("queue", s.duration, s.end, s.trace_id))
                if s.trace_id not in self._done:
                    self._qstart.setdefault(s.trace_id, s.start)
            elif s.name == "request.prefill":
                self._seen[s.span_id] = s.end
                if not self._prune:
                    self._trace_spans.setdefault(
                        s.trace_id, []).append(s.span_id)
                t0 = self._qstart.pop(s.trace_id, None)
                if t0 is not None and s.trace_id not in self._done:
                    self._done[s.trace_id] = s.end
                    out.append(("ttft", s.end - t0, s.end, s.trace_id))
            elif s.name == "serving.request" and not self._prune:
                # ring-clearing mode: the request is complete and its
                # spans can never be re-offered, so its bookkeeping is
                # dead — free it here (with prune on, the ring-age
                # sweep below owns cleanup instead; dropping _seen
                # entries early there would double-count spans still
                # in the ring)
                self._qstart.pop(s.trace_id, None)
                self._done.pop(s.trace_id, None)
                for sid in self._trace_spans.pop(s.trace_id, ()):
                    self._seen.pop(sid, None)
        # bound the dedup state: anything older than the ring's oldest
        # surviving span can never be offered again. _qstart rides the
        # same cutoff — a request whose queue span aged out of the ring
        # before its prefill landed loses its TTFT sample (bounded
        # memory beats perfect recall on a long-lived operator).
        if self._prune:
            oldest = min((s.start for s in spans), default=0.0)
            for d in (self._seen, self._done, self._qstart):
                for k in [k for k, t in d.items() if t < oldest]:
                    del d[k]
        return out


class SLOEvaluator:
    """Samples signals, burns budgets, drives the alert lifecycle.

    ``api=None`` runs the evaluator headless (the serving replay leg):
    specs are registered with :meth:`add`, windows and alerts still
    work, but no SLO objects are listed and no conditions/Events are
    written. With an api, :meth:`evaluate` re-lists SLO objects each
    pass (a spec edit resets that SLO's windows; a deleted SLO drops its
    state) and writes the condition + Events on alert transitions only —
    idempotent while an alert persists."""

    def __init__(self, api=None, clock=None, metrics=None, recorder=None,
                 goodput=None, registry=None, tracer=None,
                 evaluate_interval_s: float = 30.0):
        self.api = api
        self.clock = clock or (api.now if api is not None else None)
        self.metrics = metrics
        self.recorder = recorder
        #: GoodputAccountant feeding the ``fleet_goodput`` gauge signal
        self.goodput = goodput
        #: metrics Registry feeding ``metric:<family>`` signals
        self.registry = registry
        #: span recorder feeding serving ``ttft``/``queue`` signals
        self.tracer = tracer
        self.evaluate_interval_s = float(evaluate_interval_s)
        self._harvester = RequestSpanHarvester()
        self._states: dict[str, _SLOState] = {}
        self._invalid: dict[str, str] = {}   # name -> parse error
        self._next_eval = 0.0
        self._lock = threading.Lock()
        #: transition history: {"t", "slo", "severity", "event", "burn"}
        self.alert_log: list = []
        #: bad-sample attribution (docs/forensics.md): every EVENT
        #: sample that burned an objective's budget, with the labels the
        #: feeder stamped (``job`` from the retirement harvest) — the
        #: chain the incident timeline walks from a page back to the
        #: specific jobs whose samples drove the burn. Bounded so a
        #: long-lived operator can't grow it without limit.
        self.bad_samples: deque = deque(maxlen=65536)

    # -- spec registration -------------------------------------------------

    def add(self, spec_or_obj) -> SLOSpec:
        """Register one objective directly (headless mode / tests)."""
        spec = (spec_or_obj if isinstance(spec_or_obj, SLOSpec)
                else SLOSpec.from_obj(spec_or_obj))
        with self._lock:
            self._states[spec.name] = _SLOState(spec)
        return spec

    def _refresh_locked(self) -> list:
        """Sync states with the api's SLO objects (add/reset/drop).
        Returns the retired states (spec edited, turned invalid, or
        deleted) so the caller can close out their alert lifecycle — a
        dropped state must never strand a True condition or stale
        gauges."""
        if self.api is None:
            return []
        retired = []
        seen = set()
        for obj in self.api.list(SLO_KIND):
            name = (obj.get("metadata") or {}).get("name", "")
            seen.add(name)
            try:
                spec = SLOSpec.from_obj(obj)
            except ValueError as e:
                if self._invalid.get(name) != str(e):
                    log.warning("SLO %s is invalid, skipping: %s", name, e)
                    self._invalid[name] = str(e)
                dropped = self._states.pop(name, None)
                if dropped is not None:
                    retired.append(dropped)
                continue
            self._invalid.pop(name, None)
            cur = self._states.get(name)
            if cur is None or cur.spec != spec:
                if cur is not None:
                    retired.append(cur)
                self._states[name] = _SLOState(spec)
        for name in [n for n in self._states if n not in seen]:
            retired.append(self._states.pop(name))
        for name in [n for n in self._invalid if n not in seen]:
            del self._invalid[name]
        return retired

    # -- signal ingest -----------------------------------------------------

    def observe(self, signal: str, value: float, now: float,
                labels: Optional[dict] = None) -> None:
        """Fold one event sample into every matching objective's
        windows."""
        with self._lock:
            for st in self._states.values():
                if st.spec.kind == "event" and st.spec.base == signal \
                        and st.spec.matches(labels):
                    bad = not st.spec.good(value)
                    st.add(now, bad)
                    if bad:
                        self.bad_samples.append({
                            "t": now, "slo": st.spec.name,
                            "signal": signal, "value": value,
                            "labels": dict(labels or {})})

    def _sample_derived_locked(self, now: float) -> None:
        """Per-tick samples for gauge and registry-metric signals."""
        for st in self._states.values():
            spec = st.spec
            if spec.kind == "gauge":
                if self.goodput is not None and self.goodput.jobs > 0:
                    st.add(now, not spec.good(self.goodput.fleet_goodput()))
            elif spec.kind == "metric":
                value = self._read_metric(spec)
                if value is not None:
                    st.add(now, not spec.good(value))

    def _read_metric(self, spec: SLOSpec) -> Optional[float]:
        if self.registry is None:
            return None
        mt = self.registry.find(spec.base)
        if mt is None:
            return None
        labels = dict(spec.selector)
        if not set(labels) <= set(mt.label_names):
            # _Metric._key silently drops unknown label keys — reading
            # on would sample the WRONG (e.g. global) series while the
            # operator believes the objective is scoped; no sample is
            # the honest answer
            return None
        if hasattr(mt, "quantile"):              # histogram
            # `is None` check, not truthiness: an explicit p0 (the
            # declared minimum) must not silently read the p99
            q = 0.99 if spec.quantile is None else spec.quantile
            return mt.quantile(q, **labels)
        if hasattr(mt, "sample"):                # gauge / counter
            # None for a never-written series: a typo'd family or
            # selector must yield NO samples, not an always-0.0 signal
            # that silently burns (or banks) budget forever
            v = mt.sample(**labels)
            return None if v is None else float(v)
        return None

    # -- evaluation --------------------------------------------------------

    def maybe_evaluate(self, now: Optional[float] = None) -> Optional[list]:
        """Rate-limited :meth:`evaluate` (rides the reconcile stream via
        ``FleetTelemetry.maybe_scan``; one pass per interval runs)."""
        now = self.clock() if now is None else now
        if now < self._next_eval:
            return None
        self._next_eval = now + self.evaluate_interval_s
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> list:
        """One full pass: refresh objects, sample derived signals, prune
        windows, compute burn rates, drive alert transitions. Returns
        the per-SLO status dicts (what the console serves)."""
        now = self.clock() if now is None else now
        transitions = []
        with self._lock:
            retired = self._refresh_locked()
            if self.tracer is not None and self.tracer.enabled:
                for signal, value, t in self._harvester.feed(
                        self.tracer.spans()):
                    for st in self._states.values():
                        if st.spec.kind == "event" \
                                and st.spec.base == signal \
                                and st.spec.matches(None):
                            bad = not st.spec.good(value)
                            st.add(t, bad)
                            if bad:
                                self.bad_samples.append({
                                    "t": t, "slo": st.spec.name,
                                    "signal": signal, "value": value,
                                    "labels": {}})
            self._sample_derived_locked(now)
            statuses = []
            for name in sorted(self._states):
                st = self._states[name]
                st.prune(now)
                statuses.append(self._tick_locked(st, now, transitions))
        for st in retired:
            self._retire_state(st, now)
        for st, w, fired, status, short, long_ in transitions:
            self._emit_transition(st, w, fired, status, now, short,
                                  long_)
        return statuses

    def _retire_state(self, st: _SLOState, now: float) -> None:
        """Close out a dropped/reset state's alert lifecycle: remove its
        gauge series from the exposition and, if it was firing, clear
        the condition + emit the Recovered event (an edited objective
        that is still burning will re-fire as a fresh onset on the next
        pass; its gauges reappear on that pass too)."""
        spec = st.spec
        if self.metrics is not None:
            self.metrics.alerts_active.remove(slo=spec.name)
            self.metrics.budget_remaining.remove(slo=spec.name)
            for h in sorted(st.windows):
                if h != spec.window_s:
                    self.metrics.burn_rate.remove(slo=spec.name,
                                                  window=f"{h:g}s")
        firing = [sev for sev, f in sorted(st.firing.items()) if f]
        if not firing:
            return
        for sev in firing:
            self.alert_log.append({
                "t": now, "slo": spec.name, "severity": sev,
                "event": "clear", "shortBurn": None, "longBurn": None})
        if self.api is None:
            return
        obj = self.api.try_get(SLO_KIND, "default", spec.name)
        if obj is None:
            return                       # deleted: nothing to write on
        msg = "objective changed or removed; alert state reset"
        self._write_condition(spec.name, "False", REASON_SLO_RECOVERED,
                              msg)
        if self.recorder is not None:
            self.recorder.event(obj, TYPE_NORMAL, REASON_SLO_RECOVERED,
                                msg)

    def _tick_locked(self, st: _SLOState, now: float,
                     transitions: list) -> dict:
        spec = st.spec
        comp_win = st.windows[spec.window_s]
        bad_frac = comp_win.bad_fraction()
        consumed = None if bad_frac is None else bad_frac / spec.budget
        burn_rates = {}
        for h in sorted(st.windows):
            if h != spec.window_s:
                burn_rates[f"{h:g}s"] = st.burn_rate(h)
        alerts = {}
        for w in spec.alerting:
            short, long_ = st.burn_rate(w.short_s), st.burn_rate(w.long_s)
            firing = (short is not None and long_ is not None
                      and short >= w.burn and long_ >= w.burn)
            if firing != st.firing[w.severity]:
                st.firing[w.severity] = firing
                if firing:
                    st.fired[w.severity] += 1
                status = self._status_locked(st, now, consumed,
                                             burn_rates, alerts)
                transitions.append((st, w, firing, status,
                                    short, long_))
                self.alert_log.append({
                    "t": now, "slo": spec.name, "severity": w.severity,
                    "event": "fire" if firing else "clear",
                    "shortBurn": short, "longBurn": long_})
            alerts[w.severity] = {"firing": st.firing[w.severity],
                                  "fired": st.fired[w.severity]}
        status = self._status_locked(st, now, consumed, burn_rates, alerts)
        if self.metrics is not None:
            mt = self.metrics
            mt.budget_remaining.set(status["budgetRemaining"],
                                    slo=spec.name)
            for wname, rate in burn_rates.items():
                mt.burn_rate.set(rate or 0.0, slo=spec.name, window=wname)
            mt.alerts_active.set(
                sum(1 for a in alerts.values() if a["firing"]),
                slo=spec.name)
        return status

    def _status_locked(self, st: _SLOState, now: float, consumed,
                       burn_rates: dict, alerts: dict) -> dict:
        spec = st.spec
        comp_win = st.windows[spec.window_s]
        nd = 6
        return {
            "name": spec.name,
            "signal": spec.signal,
            "target": spec.target,
            "goal": spec.goal,
            "comparator": spec.comparator,
            "windowSeconds": spec.window_s,
            "selector": dict(spec.selector),
            "samples": comp_win.total,
            "goodSamples": comp_win.total - comp_win.bad,
            "compliance": (None if comp_win.total == 0 else
                           round(1.0 - comp_win.bad / comp_win.total, nd)),
            "budgetConsumed": (None if consumed is None
                               else round(consumed, nd)),
            "budgetRemaining": (1.0 if consumed is None
                                else round(1.0 - consumed, nd)),
            "burnRates": {k: (None if v is None else round(v, nd))
                          for k, v in burn_rates.items()},
            "alerts": {k: dict(v) for k, v in sorted(alerts.items())},
            "evaluatedAt": round(now, 3),
        }

    # -- alert transitions (condition + Event, idempotent per onset) -------

    def _emit_transition(self, st: _SLOState, w, fired: bool,
                         status: dict, now: float,
                         short: Optional[float],
                         long_: Optional[float]) -> None:
        spec = st.spec
        severity = w.severity
        consumed = status["budgetConsumed"]
        consumed = "n/a" if consumed is None else f"{consumed:.4f}"
        if fired:
            msg = (f"{severity}: error-budget burn over signal "
                   f"{spec.signal} (target {spec.target:g}) exceeds "
                   f"threshold; budget consumed {consumed}")
        else:
            msg = (f"{severity}: burn rate back under threshold; budget "
                   f"consumed {consumed}")
        if self.metrics is not None and fired:
            self.metrics.alerts.inc(slo=spec.name, severity=severity)
        if self.api is None:
            return
        obj = self.api.try_get(SLO_KIND, "default", spec.name)
        if obj is None:
            return
        # machine-parseable burn-window bounds (docs/forensics.md): the
        # incident timeline attributes pages from these annotations
        # without re-deriving windows from prose
        annotations = {
            "slo.kubedl.io/severity": severity,
            "slo.kubedl.io/signal": spec.signal,
            "slo.kubedl.io/short-window-seconds": f"{w.short_s:g}",
            "slo.kubedl.io/long-window-seconds": f"{w.long_s:g}",
            "slo.kubedl.io/short-window-start": rfc3339(now - w.short_s),
            "slo.kubedl.io/long-window-start": rfc3339(now - w.long_s),
            "slo.kubedl.io/burn-threshold": f"{w.burn:g}",
            "slo.kubedl.io/short-burn":
                "" if short is None else f"{short:.6f}",
            "slo.kubedl.io/long-burn":
                "" if long_ is None else f"{long_:.6f}",
            "slo.kubedl.io/budget-remaining":
                f"{status['budgetRemaining']:.6f}",
        }
        # the condition reflects the AGGREGATE state, not this one
        # transition: when the page pair clears while the ticket pair
        # still fires, the condition must stay True and say so — never
        # carry a "back under threshold" message mid-incident
        firing = sorted(sev for sev, f in st.firing.items() if f)
        if firing:
            cond_msg = (f"severities firing: {', '.join(firing)} over "
                        f"signal {spec.signal} (target {spec.target:g}); "
                        f"budget consumed {consumed}")
        else:
            cond_msg = (f"burn rate back under threshold; budget "
                        f"consumed {consumed}")
        self._write_condition(
            spec.name, "True" if firing else "False",
            REASON_SLO_BURN if firing else REASON_SLO_RECOVERED, cond_msg)
        if self.recorder is not None:
            self.recorder.event(
                obj, TYPE_WARNING if fired else TYPE_NORMAL,
                REASON_SLO_BURN if fired else REASON_SLO_RECOVERED, msg,
                annotations=annotations)

    def _write_condition(self, name: str, status: str, reason: str,
                         message: str) -> None:
        for _ in range(8):
            fresh = self.api.try_get(SLO_KIND, "default", name)
            if fresh is None:
                return
            conds = fresh.setdefault("status", {}).setdefault(
                "conditions", [])
            cur = next((cd for cd in conds
                        if cd.get("type") == SLO_BURN_RATE), None)
            if cur is not None and cur.get("status") == status \
                    and cur.get("message") == message:
                return
            ts = rfc3339(self.clock())
            cond = {"type": SLO_BURN_RATE, "status": status,
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
            except (NotFound, ServerError, ApiError) as e:
                log.warning("SLOBurnRate condition write %s failed: %s",
                            name, e)
                return
        log.warning("SLOBurnRate condition write %s kept conflicting", name)

    # -- reading -----------------------------------------------------------

    def specs(self) -> dict:
        """``{name: SLOSpec}`` of the registered objectives — the
        incident timeline resolves each severity's burn-window widths
        from here (docs/forensics.md)."""
        with self._lock:
            return {name: st.spec for name, st in self._states.items()}

    def attribution(self) -> tuple:
        """``(alert_log, bad_samples)`` copied under the evaluator lock.
        The console's incident timeline iterates these from its own
        request thread while the operator thread appends — iterating
        the live deque there would raise mid-mutation."""
        with self._lock:
            return list(self.alert_log), list(self.bad_samples)

    def status(self, name: str) -> Optional[dict]:
        """One SLO's live status (no evaluation side effects). An
        object that exists but failed spec parsing answers with its
        parse error — the drill-down must agree with the listing, not
        deny the object exists."""
        with self._lock:
            st = self._states.get(name)
            if st is None:
                if name in self._invalid:
                    return {"name": name, "invalid": self._invalid[name]}
                return None
            now = self.clock() if self.clock is not None else 0.0
            st.prune(now)
            comp = st.windows[st.spec.window_s]
            bad_frac = comp.bad_fraction()
            consumed = (None if bad_frac is None
                        else bad_frac / st.spec.budget)
            burn_rates = {f"{h:g}s": st.burn_rate(h)
                          for h in sorted(st.windows)
                          if h != st.spec.window_s}
            alerts = {w.severity: {"firing": st.firing[w.severity],
                                   "fired": st.fired[w.severity]}
                      for w in st.spec.alerting}
            return self._status_locked(st, now, consumed, burn_rates,
                                       alerts)

    def statuses(self) -> list:
        """Every registered SLO's status, name-sorted (the console
        list endpoint), plus invalid objects with their parse error."""
        with self._lock:
            names = sorted(self._states)
            invalid = dict(self._invalid)
        out = [self.status(n) for n in names]
        out = [s for s in out if s is not None]
        for name in sorted(invalid):
            out.append({"name": name, "invalid": invalid[name]})
        return out

    def summary(self, ndigits: int = 4) -> dict:
        """Deterministic per-objective rollup (the scorecard's ``slo``
        block): compliance + budget remaining + alert onset counts."""
        out = {}
        for s in self.statuses():
            if "invalid" in s:
                continue
            out[s["name"]] = {
                "signal": s["signal"],
                "target": s["target"],
                "goal": s["goal"],
                "samples": s["samples"],
                "compliance": (None if s["compliance"] is None
                               else round(s["compliance"], ndigits)),
                "budgetRemaining": round(s["budgetRemaining"], ndigits),
                "alertsFired": sum(a["fired"]
                                   for a in s["alerts"].values()),
            }
        return out

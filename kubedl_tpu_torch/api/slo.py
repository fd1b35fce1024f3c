"""SLO API object: a declared objective over an observed fleet signal.

PRs 5-7 gave the operator eyes (traces, the fleet scorecard, goodput
telemetry) but no judgment: nothing states what *good* looks like. This
cluster-scoped object is that statement — the input to the SLO engine
(:mod:`kubedl_tpu_torch.telemetry.slo`), which samples the named signal into
sliding windows, tracks the error budget, and drives Google-SRE-style
multi-window multi-burn-rate alerts (docs/slo.md):

    apiVersion: slo.kubedl.io/v1alpha1
    kind: SLO
    metadata: {name: serving-ttft}
    spec:
      signal: ttft_p99              # signal catalogue, docs/slo.md
      objective:
        target: 30.0                # a good sample is <= 30s (lte)
        # goal: 0.99                # implied by the _p99 suffix
      windowSeconds: 2592000        # 30d compliance window
      # selector: {queue: prod}    # JOB signals only (queue_delay /
      #                              restart_mttr carry queue+kind
      #                              labels; serving-span samples are
      #                              unlabelled — a selector there
      #                              matches nothing)
      # alerting:                   # burn-rate pairs; SRE defaults
      # - {severity: page, shortSeconds: 300, longSeconds: 3600,
      #    burn: 14.4}

Signal grammar (``parse_signal``):

* ``<base>_p<NN>`` — an event signal over per-occurrence samples
  (``ttft``, ``queue`` from serving request spans; ``queue_delay``,
  ``restart_mttr`` from job lifecycle traces). The percentile suffix IS
  the goal: ``ttft_p99`` + target 30 declares "99% of requests see
  TTFT <= 30s", so the error budget is the 1% of samples allowed above
  target.
* ``fleet_goodput`` — the goodput accountant's fleet ratio, sampled on
  every evaluation tick (comparator defaults to ``gte``).
* ``metric:<family>[:p<NN>]`` — any registry metric by name: histograms
  are read through :meth:`~kubedl_tpu_torch.metrics.registry
  .Histogram.quantile` (default p99), gauges through ``value()``; each
  evaluation tick contributes one in/out-of-compliance sample.

This module only shapes and validates the object; the window math lives
in :mod:`kubedl_tpu_torch.telemetry.slo`.

Copied from ``kubedl_tpu/api/slo.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

SLO_KIND = "SLO"
SLO_API_VERSION = "slo.kubedl.io/v1alpha1"

#: default compliance window: the SRE-conventional 30 days
DEFAULT_WINDOW_S = 30 * 86400.0

#: event-signal bases the built-in harvesters feed (docs/slo.md
#: catalogue). ``evac_restore`` / ``evac_lostwork`` are the federation
#: layer's evacuation signals (docs/federation.md): per-emigration
#: restore latency + work lost past the object-store checkpoint bank.
EVENT_SIGNALS = ("ttft", "queue", "queue_delay", "restart_mttr",
                 "evac_restore", "evac_lostwork")

#: the fleet-goodput gauge signal (GoodputAccountant.fleet_goodput)
SIGNAL_FLEET_GOODPUT = "fleet_goodput"

_PCT_RE = re.compile(r"^(?P<base>[a-z0-9_]+?)_p(?P<pct>\d{1,2}(?:\.\d+)?)$")


@dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate alert pair: fire when the error-budget
    burn rate over BOTH the short and the long window reaches ``burn``
    (the long window keeps one bad blip from paging; the short window
    makes the alert reset quickly once the bleeding stops)."""
    severity: str                 # "page" | "ticket" (free-form)
    short_s: float
    long_s: float
    burn: float                   # burn-rate threshold (1.0 = budget pace)

    def to_obj(self) -> dict:
        return {"severity": self.severity,
                "shortSeconds": self.short_s,
                "longSeconds": self.long_s,
                "burn": self.burn}

    @classmethod
    def from_obj(cls, d: dict) -> "BurnWindow":
        try:
            w = cls(severity=str(d.get("severity", "page")),
                    short_s=float(d["shortSeconds"]),
                    long_s=float(d["longSeconds"]),
                    burn=float(d["burn"]))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad alerting window {d!r}: {e}")
        if w.short_s <= 0 or w.long_s < w.short_s or w.burn <= 0:
            raise ValueError(
                f"alerting window needs 0 < shortSeconds <= longSeconds "
                f"and burn > 0, got {d!r}")
        return w


#: Google-SRE defaults for a 30d window (SRE workbook ch.5): the fast
#: pair pages at 14.4x (2% of the budget in one hour), the slow pair
#: tickets at budget pace
DEFAULT_ALERTING = (
    BurnWindow("page", 300.0, 3600.0, 14.4),
    BurnWindow("ticket", 6 * 3600.0, 3 * 86400.0, 1.0),
)


def parse_signal(signal: str) -> tuple:
    """``(kind, base, goal_from_name, quantile)`` for a signal string;
    raises ValueError for anything outside the grammar. ``kind`` is
    ``event`` (per-occurrence samples fed by harvesters), ``gauge``
    (fleet_goodput, sampled per evaluation tick) or ``metric`` (registry
    family by name, sampled per tick)."""
    signal = (signal or "").strip()
    if not signal:
        raise ValueError("spec.signal is required")
    if signal == SIGNAL_FLEET_GOODPUT:
        return "gauge", SIGNAL_FLEET_GOODPUT, None, None
    if signal.startswith("metric:"):
        rest = signal[len("metric:"):]
        name, _, q = rest.partition(":")
        if not name:
            raise ValueError(f"empty metric name in signal {signal!r}")
        quantile = 0.99
        if q:
            mt = re.fullmatch(r"p(\d{1,2}(?:\.\d+)?)", q)
            if not mt:
                raise ValueError(
                    f"bad metric quantile {q!r} in signal {signal!r} "
                    f"(want p50/p99/...)")
            quantile = float(mt.group(1)) / 100.0
        return "metric", name, None, quantile
    mt = _PCT_RE.match(signal)
    if mt and mt.group("base") in EVENT_SIGNALS:
        return ("event", mt.group("base"),
                float(mt.group("pct")) / 100.0, None)
    if signal in EVENT_SIGNALS:
        return "event", signal, None, None
    raise ValueError(
        f"unknown signal {signal!r}: want one of "
        f"{', '.join(s + '_pNN' for s in EVENT_SIGNALS)}, "
        f"{SIGNAL_FLEET_GOODPUT}, or metric:<family>[:pNN]")


@dataclass(frozen=True)
class SLOSpec:
    """Parsed, validated objective (the evaluator keys window state on
    spec equality, so a spec edit resets the windows)."""
    name: str
    signal: str                   # the raw spec string
    kind: str                     # event | gauge | metric
    base: str                     # routed signal key / metric family
    target: float
    goal: float                   # good-sample fraction, 0 < goal < 1
    comparator: str               # "lte" | "gte" (good-sample direction)
    window_s: float = DEFAULT_WINDOW_S
    selector: tuple = field(default_factory=tuple)  # sorted (k, v) pairs
    quantile: Optional[float] = None   # metric-histogram read point
    alerting: tuple = DEFAULT_ALERTING

    @property
    def budget(self) -> float:
        """The error budget as a sample fraction (1 - goal)."""
        return 1.0 - self.goal

    def good(self, value: float) -> bool:
        return (value <= self.target if self.comparator == "lte"
                else value >= self.target)

    def matches(self, labels: Optional[dict]) -> bool:
        """Selector-subset match against a sample's labels."""
        if not self.selector:
            return True
        labels = labels or {}
        return all(labels.get(k) == v for k, v in self.selector)

    @classmethod
    def from_obj(cls, obj: dict) -> "SLOSpec":
        md = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        kind, base, goal_from_name, quantile = parse_signal(
            spec.get("signal", ""))
        objective = spec.get("objective") or {}
        if "target" not in objective:
            raise ValueError("spec.objective.target is required")
        target = float(objective["target"])
        goal = objective.get("goal")
        goal = float(goal) if goal is not None else (
            goal_from_name if goal_from_name is not None else 0.99)
        if not 0.0 < goal < 1.0:
            raise ValueError(
                f"goal must be in (0, 1), got {goal} (a goal of 1.0 "
                f"leaves no error budget to burn)")
        comparator = objective.get("comparator") or (
            "gte" if kind == "gauge" else "lte")
        if comparator not in ("lte", "gte"):
            raise ValueError(f"comparator must be lte|gte, got "
                             f"{comparator!r}")
        ws = spec.get("windowSeconds")
        # `is None`, not truthiness: an explicit 0 (a templating bug)
        # must be REJECTED below, not silently become the 30d default
        window_s = DEFAULT_WINDOW_S if ws is None else float(ws)
        if window_s <= 0:
            raise ValueError("windowSeconds must be positive")
        selector = tuple(sorted(
            (str(k), str(v))
            for k, v in (spec.get("selector") or {}).items()))
        alerting = tuple(BurnWindow.from_obj(w)
                         for w in spec.get("alerting") or ())
        if not alerting:
            alerting = DEFAULT_ALERTING
        sevs = [w.severity for w in alerting]
        if len(set(sevs)) != len(sevs):
            # alert state is keyed by severity: two pairs sharing one
            # would clobber each other's firing flag and flap Events
            # every evaluation pass — name them page-fast/page-slow
            raise ValueError(
                f"alerting severities must be unique, got {sevs}")
        q = objective.get("quantile")
        if q is not None:
            quantile = float(q)
        if quantile is not None and not 0.0 <= quantile <= 1.0:
            # must fail HERE so the evaluator's invalid-object path
            # absorbs it — an unchecked quantile would crash every
            # evaluation pass (and with it every reconcile) later
            raise ValueError(
                f"objective.quantile must be in [0, 1], got {quantile}")
        return cls(name=md.get("name", ""), signal=spec.get("signal", ""),
                   kind=kind, base=base, target=target, goal=goal,
                   comparator=comparator, window_s=window_s,
                   selector=selector, quantile=quantile,
                   alerting=alerting)


def new_slo(name: str, signal: str, target: float, *,
            goal: Optional[float] = None,
            window_s: float = DEFAULT_WINDOW_S,
            selector: Optional[dict] = None,
            alerting=None, comparator: Optional[str] = None,
            uid: Optional[str] = None) -> dict:
    """Convenience constructor (tests, benches, the replay's default SLO
    set). ``uid`` pre-sets ``metadata.uid`` — the replay rig needs SLO
    creates to leave the api server's deterministic uid counter untouched
    so the job day's trace ids and backoff jitter stay byte-identical."""
    objective: dict = {"target": target}
    if goal is not None:
        objective["goal"] = goal
    if comparator is not None:
        objective["comparator"] = comparator
    spec: dict = {"signal": signal, "objective": objective,
                  "windowSeconds": window_s}
    if selector:
        spec["selector"] = dict(selector)
    if alerting:
        spec["alerting"] = [w.to_obj() if isinstance(w, BurnWindow) else w
                            for w in alerting]
    md: dict = {"name": name}
    if uid:
        md["uid"] = uid
    obj = {"apiVersion": SLO_API_VERSION, "kind": SLO_KIND,
           "metadata": md, "spec": spec}
    SLOSpec.from_obj(obj)            # validate eagerly — fail at authoring
    return obj

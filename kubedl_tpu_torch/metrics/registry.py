"""Metrics registry with Prometheus text exposition.

Copied from ``kubedl_tpu/metrics/registry.py`` (the port imports nothing
from the JAX package): ``Registry``, ``Counter``, ``Gauge`` and
``Histogram``, and ``PagedKVMetrics``: the part the predictor server's
``/metrics`` uses.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

_DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 20, 40, 60, 90, 120, 180, 300, 600)


class _Metric:
    def __init__(self, name: str, help_text: str, label_names: tuple):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        return tuple(str(labels.get(ln, "")) for ln in self.label_names)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names, buckets: Iterable[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels):
        with self._lock:
            k = self._key(labels)
            counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
            self._sums[k] = self._sums.get(k, 0.0) + value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def counter(self, name, help_text="", labels=()):
        mt = Counter(name, help_text, tuple(labels))
        with self._lock:
            self._metrics.append(mt)
        return mt

    def gauge(self, name, help_text="", labels=()):
        mt = Gauge(name, help_text, tuple(labels))
        with self._lock:
            self._metrics.append(mt)
        return mt

    def histogram(self, name, help_text="", labels=(), buckets=_DEFAULT_BUCKETS):
        mt = Histogram(name, help_text, tuple(labels), buckets)
        with self._lock:
            self._metrics.append(mt)
        return mt

    def expose(self) -> str:
        """Prometheus text exposition format. Snapshots each metric under
        its lock so a scrape never races a concurrent observe/inc/set."""
        out = []
        for mt in self._metrics:
            out.append(f"# HELP {mt.name} {mt.help}")
            out.append(f"# TYPE {mt.name} {mt.kind}")
            if isinstance(mt, Histogram):
                with mt._lock:
                    counts_snap = {k: list(v) for k, v in mt._counts.items()}
                    sums_snap = dict(mt._sums)
                for k, counts in counts_snap.items():
                    lbl = _fmt_labels(mt.label_names, k)
                    for i, b in enumerate(mt.buckets):
                        le = f'le="{b}"'
                        out.append(f"{mt.name}_bucket{_merge(lbl, le)} {counts[i]}")
                    inf = 'le="+Inf"'
                    out.append(f"{mt.name}_bucket{_merge(lbl, inf)} {counts[-1]}")
                    out.append(f"{mt.name}_sum{_wrap(lbl)} {sums_snap.get(k, 0.0)}")
                    out.append(f"{mt.name}_count{_wrap(lbl)} {counts[-1]}")
            else:
                with mt._lock:
                    values_snap = dict(mt._values)
                for k, v in values_snap.items():
                    out.append(f"{mt.name}{_wrap(_fmt_labels(mt.label_names, k))} {v}")
        return "\n".join(out) + "\n"


class PagedKVMetrics:
    """Paged KV-cache pool instrumentation for the serving predictor's
    ``/metrics``: pool occupancy (capacity planning), the shared-block
    ratio (how much memory prefix copy-on-write sharing is saving), and
    the preemption counter (a rising rate means the pool is undersized
    for the offered load). Refreshed from the engine's ``pool_stats()``
    snapshot on scrape."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.blocks_total = r.gauge(
            "kubedl_serving_kv_blocks_total",
            "Usable KV pool blocks (excludes the garbage sink)")
        self.blocks_free = r.gauge(
            "kubedl_serving_kv_blocks_free",
            "KV pool blocks currently unreferenced")
        self.blocks_pinned = r.gauge(
            "kubedl_serving_kv_blocks_pinned",
            "KV pool blocks pinned by registered prefixes")
        self.shared_ratio = r.gauge(
            "kubedl_serving_kv_shared_block_ratio",
            "Fraction of in-use KV blocks referenced by more than one "
            "holder (prefix sharing)")
        # a true Counter (not a gauge wearing the _total suffix):
        # rate()/increase() and reset detection need counter semantics,
        # so refresh() feeds it the delta since the last snapshot
        self.preemptions = r.counter(
            "kubedl_serving_kv_preemptions_total",
            "Lanes evicted back to the queue because the pool ran dry")
        self._preempt_seen = 0
        self.peak_active = r.gauge(
            "kubedl_serving_peak_active_lanes",
            "Peak simultaneously-active continuous-batching lanes")

    def refresh(self, stats: dict) -> None:
        """Push one ``ContinuousBatchingEngine.pool_stats()`` snapshot."""
        self.peak_active.set(stats.get("peak_active", 0))
        if "blocks_total" not in stats:
            return                       # dense mode: no pool
        self.blocks_total.set(stats["blocks_total"])
        self.blocks_free.set(stats["blocks_free"])
        self.blocks_pinned.set(stats["blocks_pinned"])
        used = stats["blocks_used"]
        self.shared_ratio.set(stats["blocks_shared"] / used if used else 0.0)
        delta = stats["preempted"] - self._preempt_seen
        if delta > 0:
            self.preemptions.inc(delta)
            self._preempt_seen = stats["preempted"]


def _escape_label(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition line is
    unparseable (label values are user-influenced — queue names, kinds)."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(names: tuple, values: tuple) -> str:
    return ",".join(f'{n}="{_escape_label(v)}"'
                    for n, v in zip(names, values) if v != "")


def _wrap(lbl: str) -> str:
    return f"{{{lbl}}}" if lbl else ""


def _merge(lbl: str, extra: str) -> str:
    return f"{{{lbl},{extra}}}" if lbl else f"{{{extra}}}"

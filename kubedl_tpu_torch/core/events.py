"""Event recorder: the observability backbone.

The analog of controller-runtime's ``Recorder`` used throughout the
reference (e.g. ``pkg/job_controller/job.go:197-207``): events are stored as
first-class ``Event`` objects in the API server so users (and the console)
can ``kubectl get events``-equivalently inspect job lifecycle decisions.

Copied from ``kubedl_tpu/core/events.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import itertools
import logging

from . import meta as m
from .apiserver import ApiError, APIServer

log = logging.getLogger("kubedl_tpu_torch.events")

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

_seq = itertools.count()


class Recorder:
    """Deduplicates repeat events via the ``count`` field (like the real
    event recorder) and owner-refs events to their involved object so
    cascading GC collects them with the job — both needed to keep the
    in-memory standalone control plane bounded."""

    def __init__(self, api: APIServer, component: str = "kubedl-tpu"):
        self.api = api
        self.component = component
        self._dedup: dict[tuple, str] = {}  # (uid, type, reason, message) -> name

    def event(self, obj: dict, event_type: str, reason: str, message: str,
              annotations: dict = None) -> None:
        """Record an event; best-effort like the real recorder — an
        apiserver hiccup (or injected chaos fault) writing an Event must
        never fail the reconcile that emitted it. ``annotations`` land
        on the Event's metadata — machine-parseable detail (the SLO
        engine's burn-window bounds, docs/forensics.md) that consumers
        read without parsing the prose message."""
        try:
            self._record(obj, event_type, reason, message, annotations)
        except ApiError as e:
            log.warning("dropping event %s/%s for %s: %s",
                        event_type, reason, m.key(obj), e)

    def _record(self, obj: dict, event_type: str, reason: str, message: str,
                annotations: dict = None) -> None:
        key = (m.uid(obj), event_type, reason, message)
        existing_name = self._dedup.get(key)
        if existing_name is not None:
            existing = self.api.try_get("Event", m.namespace(obj), existing_name)
            if existing is not None:
                existing["count"] = int(existing.get("count", 1)) + 1
                existing["lastTimestamp"] = m.rfc3339(self.api.now())
                if annotations:
                    md = existing.setdefault("metadata", {})
                    md["annotations"] = {**(md.get("annotations") or {}),
                                         **annotations}
                self.api.update(existing)
                return
            self._dedup.pop(key, None)
        ev = m.new_obj("v1", "Event",
                       f"{m.name(obj)}.{next(_seq):08x}", m.namespace(obj))
        if annotations:
            ev.setdefault("metadata", {})["annotations"] = dict(annotations)
        ev.update({
            "type": event_type,
            "reason": reason,
            "message": message,
            "involvedObject": {
                "apiVersion": m.api_version(obj),
                "kind": m.kind(obj),
                "namespace": m.namespace(obj),
                "name": m.name(obj),
                "uid": m.uid(obj),
            },
            "source": {"component": self.component},
            "firstTimestamp": m.rfc3339(self.api.now()),
            "lastTimestamp": m.rfc3339(self.api.now()),
            "count": 1,
        })
        if m.uid(obj):
            m.owner_references(ev).append(m.owner_ref(obj, controller=False))
        if len(self._dedup) > 10_000:  # bound the dedup index itself
            for k in list(self._dedup)[:5_000]:
                del self._dedup[k]
        self._dedup[key] = m.name(ev)
        self.api.create(ev)

    def events_for(self, obj: dict) -> list:
        """Events whose involvedObject is ``obj`` — an involved-uid index
        lookup on the in-memory server (O(events-for-obj)); a real-cluster
        api adapter without indexes falls back to the namespace scan."""
        if m.uid(obj) and hasattr(self.api, "list_indexed"):
            return self.api.list_indexed("Event", "involved-uid", m.uid(obj),
                                         namespace=m.namespace(obj))
        return [e for e in self.api.list("Event", m.namespace(obj))
                if e.get("involvedObject", {}).get("uid") == m.uid(obj)]

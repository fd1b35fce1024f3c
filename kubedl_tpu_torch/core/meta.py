"""Helpers over dict-shaped (JSON-shaped) Kubernetes API objects.

All API objects in kubedl-tpu — Pods, Services, and our CRDs alike — are
plain nested dicts shaped exactly like their JSON wire form. This module is
the vocabulary for reading/writing ``metadata``, owner references, and label
selectors, mirroring the roles of apimachinery's ``ObjectMeta`` helpers used
throughout the reference operator (e.g. controller refs set in
``pkg/job_controller/pod_control.go``, selector matching in
``pkg/job_controller/pod.go:532-554``).

Copied from ``kubedl_tpu/core/meta.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Iterable, Optional

Obj = dict  # alias for readability: a JSON-shaped API object

_ATOMIC = (str, int, float, bool, type(None))


def deep_copy(o):
    """Deep copy for JSON-shaped API objects (dict/list trees of scalars).

    ``copy.deepcopy`` pays memo bookkeeping and per-type dispatch a tree of
    plain dicts never needs; this is ~3-4x faster on a Pod-sized object.
    Aliased subtrees are duplicated rather than preserved (the JSON wire
    form cannot express aliasing); non-JSON leaves fall back to
    ``copy.deepcopy``.
    """
    t = o.__class__
    if t is dict:
        return {k: deep_copy(v) for k, v in o.items()}
    if t is list:
        return [deep_copy(v) for v in o]
    if t in _ATOMIC:
        return o
    import copy
    return copy.deepcopy(o)


def rfc3339(t: Optional[float] = None) -> str:
    """The one RFC3339 UTC timestamp formatter used across the package."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(time.time() if t is None else t))


def rfc3339_micro(t: Optional[float] = None) -> str:
    """Microsecond-precision RFC3339 — k8s ``metav1.MicroTime`` wire format
    (Lease acquire/renew times need sub-second resolution)."""
    from datetime import datetime, timezone
    dt = datetime.fromtimestamp(time.time() if t is None else t, timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def parse_rfc3339(ts) -> Optional[float]:
    """Inverse of :func:`rfc3339`, accepting the full RFC3339 surface
    (fractional seconds, ``Z`` or numeric offsets) — a timestamp written by
    another client must not silently parse to None and disable a deadline."""
    if not ts:
        return None
    from datetime import datetime, timezone
    try:
        dt = datetime.fromisoformat(str(ts).replace("Z", "+00:00"))
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def new_obj(api_version: str, kind: str, name: str, namespace: str = "default",
            labels: Optional[dict] = None, annotations: Optional[dict] = None,
            spec: Optional[dict] = None) -> Obj:
    obj: Obj = {
        "apiVersion": api_version,
        "kind": kind,
        "metadata": {
            "name": name,
            "namespace": namespace,
        },
    }
    if labels:
        obj["metadata"]["labels"] = dict(labels)
    if annotations:
        obj["metadata"]["annotations"] = dict(annotations)
    if spec is not None:
        obj["spec"] = spec
    return obj


def meta(obj: Obj) -> dict:
    return obj.setdefault("metadata", {})


def name(obj: Obj) -> str:
    return meta(obj).get("name", "")


def namespace(obj: Obj) -> str:
    return meta(obj).get("namespace", "default")


def uid(obj: Obj) -> str:
    return meta(obj).get("uid", "")


def kind(obj: Obj) -> str:
    return obj.get("kind", "")


def api_version(obj: Obj) -> str:
    return obj.get("apiVersion", "")


def key(obj: Obj) -> str:
    """namespace/name key, the workqueue key format."""
    return f"{namespace(obj)}/{name(obj)}"


def labels(obj: Obj) -> dict:
    return meta(obj).setdefault("labels", {})


def annotations(obj: Obj) -> dict:
    return meta(obj).setdefault("annotations", {})


def get_labels(obj: Obj) -> dict:
    """Non-mutating read of ``metadata.labels`` — unlike :func:`labels`
    this never inserts an empty dict, so it is safe on the API server's
    shared read snapshots (docs/control-plane-perf.md ownership rules)."""
    return (obj.get("metadata") or {}).get("labels") or {}


def get_annotations(obj: Obj) -> dict:
    """Non-mutating read of ``metadata.annotations`` (see get_labels)."""
    return (obj.get("metadata") or {}).get("annotations") or {}


def generation(obj: Obj) -> int:
    return int(meta(obj).get("generation", 0))


def resource_version(obj: Obj) -> int:
    return int(meta(obj).get("resourceVersion", 0))


def finalizers(obj: Obj) -> list:
    return meta(obj).setdefault("finalizers", [])


def deletion_timestamp(obj: Obj):
    return meta(obj).get("deletionTimestamp")


def is_deleting(obj: Obj) -> bool:
    return meta(obj).get("deletionTimestamp") is not None


def new_uid() -> str:
    return str(uuid.uuid4())


# ---------------------------------------------------------------------------
# Owner references
# ---------------------------------------------------------------------------

def owner_references(obj: Obj) -> list:
    return meta(obj).setdefault("ownerReferences", [])


def owner_ref(owner: Obj, controller: bool = True,
              block_owner_deletion: bool = True) -> dict:
    return {
        "apiVersion": api_version(owner),
        "kind": kind(owner),
        "name": name(owner),
        "uid": uid(owner),
        "controller": controller,
        "blockOwnerDeletion": block_owner_deletion,
    }


def set_controller_ref(obj: Obj, owner: Obj) -> None:
    """Make `owner` the managing controller of `obj` (one per object)."""
    refs = [r for r in owner_references(obj) if not r.get("controller")]
    refs.append(owner_ref(owner, controller=True))
    meta(obj)["ownerReferences"] = refs


def get_controller_ref(obj: Obj) -> Optional[dict]:
    # non-mutating read (unlike owner_references): safe on shared snapshots
    for r in (obj.get("metadata") or {}).get("ownerReferences") or []:
        if r.get("controller"):
            return r
    return None


def is_controlled_by(obj: Obj, owner: Obj) -> bool:
    ref = get_controller_ref(obj)
    return bool(ref and ref.get("uid") == uid(owner))


# ---------------------------------------------------------------------------
# Label selectors
# ---------------------------------------------------------------------------

def match_labels(obj_labels: dict, selector: dict) -> bool:
    """Selector = {matchLabels: {...}, matchExpressions: [...]} or a bare
    matchLabels mapping."""
    if selector is None:
        return True
    if "matchLabels" in selector or "matchExpressions" in selector:
        ml = selector.get("matchLabels", {})
    else:  # bare mapping is treated as matchLabels
        ml = selector
    for k, v in (ml or {}).items():
        if obj_labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions", []) or []:
        k = expr.get("key")
        op = expr.get("operator")
        vals = expr.get("values", []) or []
        has = k in obj_labels
        if op == "In" and (not has or obj_labels[k] not in vals):
            return False
        if op == "NotIn" and has and obj_labels[k] in vals:
            return False
        if op == "Exists" and not has:
            return False
        if op == "DoesNotExist" and has:
            return False
    return True


def select(objs: Iterable[Obj], selector: Optional[dict]) -> list:
    return [o for o in objs if match_labels(labels(o), selector or {})]


# ---------------------------------------------------------------------------
# Misc structural helpers
# ---------------------------------------------------------------------------

def get_in(obj: Any, *path, default=None):
    cur = obj
    for p in path:
        if isinstance(cur, dict):
            if p not in cur:
                return default
            cur = cur[p]
        elif isinstance(cur, list):
            if not isinstance(p, int) or p >= len(cur):
                return default
            cur = cur[p]
        else:
            return default
    return cur


def set_in(obj: dict, *path_and_value):
    *path, value = path_and_value
    cur = obj
    for p in path[:-1]:
        cur = cur.setdefault(p, {})
    cur[path[-1]] = value
